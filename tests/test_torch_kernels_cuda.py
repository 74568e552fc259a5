"""The Hopper paged-attention kernel against its plain PyTorch version,
on the card (``pytest -m cuda``): the reference test shapes in float32
(1e-4: the summation order differs) and bfloat16 (3e-2), poison pages,
zero-length rows, a strided per-layer pool view, a chunk that reaches
past the block table and one split along T.  Imports no JAX, so it runs
where only the port is installed; skipped without a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.kernels import ref as tref  # noqa: E402

CASES = {
    "decode_T1": dict(seed=0, B=3, T=1, H=4, Hkv=2, hd=32, n_pages=32,
                      ps=8, P=4, lens=[9, 1, 31]),
    "chunk_T8_causal": dict(seed=1, B=2, T=8, H=4, Hkv=4, hd=16,
                            n_pages=24, ps=8, P=3, lens=[8, 20]),
    "gqa_8_1": dict(seed=2, B=2, T=1, H=8, Hkv=1, hd=16, n_pages=16, ps=4,
                    P=4, lens=[5, 13]),
    "gqa_6_2": dict(seed=2, B=2, T=1, H=6, Hkv=2, hd=16, n_pages=16, ps=4,
                    P=4, lens=[5, 13]),
    "gqa_9_3": dict(seed=2, B=2, T=1, H=9, Hkv=3, hd=16, n_pages=16, ps=4,
                    P=4, lens=[5, 13]),
    "extent_7": dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8,
                     P=4, lens=[7]),
    "extent_8": dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8,
                     P=4, lens=[8]),
    "extent_9": dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8,
                     P=4, lens=[9]),
}


def _setup(seed, B, T, H, Hkv, hd, n_pages, ps, P, lens):
    """Numpy inputs, exactly as tests/test_kernels_paged.py draws them."""
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    kp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    vp = rng.normal(size=(n_pages, ps, Hkv, hd)).astype(np.float32)
    block = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    return q, kp, vp, block, np.asarray(lens, np.int32)


def _torch(*arrays, device="cpu"):
    return [torch.from_numpy(np.array(a)).to(device) for a in arrays]


def _poison(q, kp, vp, block, lens):
    """Redirect every out-of-extent block entry to a page FULL of 1e4."""
    poison = np.full((1,) + kp.shape[1:], 1e4, kp.dtype)
    ps, P = kp.shape[1], block.shape[1]
    used = lens[:, None] > np.arange(P) * ps
    block2 = np.where(used, block, kp.shape[0]).astype(np.int32)
    return (q, np.concatenate([kp, poison]), np.concatenate([vp, poison]),
            block2, lens)


def _pool_view(seed, n_pages=24, ps=4, L=3, Hkv=2, hd=16, li=1):
    rng = np.random.default_rng(seed)
    pk = rng.normal(size=(n_pages, ps, L, Hkv, hd)).astype(np.float32)
    pv = rng.normal(size=(n_pages, ps, L, Hkv, hd)).astype(np.float32)
    return pk, pv, li


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _kernel_vs_plain(inputs, device, dtype, atol, softcap=0.0):
    q, kp, vp, block, lens = _torch(*inputs, device=device)
    q, kp, vp = (t.to(dtype) for t in (q, kp, vp))
    before = pa_mod.launches
    out = pa_mod.paged_attention(q, kp, vp, block, lens, softcap=softcap)
    torch.cuda.synchronize()
    assert pa_mod.launches > before
    want = tref.paged_attention_ref(q, kp, vp, block, lens, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)
    return out


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(CASES))
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_kernel_matches_plain_on_card(cuda_device, name, dtype, atol):
    _kernel_vs_plain(_setup(**CASES[name]), cuda_device,
                     getattr(torch, dtype), atol)


@pytest.mark.cuda
def test_kernel_poison_and_zero_rows_on_card(cuda_device):
    inputs = _setup(4, B=2, T=1, H=4, Hkv=2, hd=16, n_pages=32, ps=4, P=8,
                    lens=[6, 10])
    a = _kernel_vs_plain(inputs, cuda_device, torch.float32, 1e-4)
    b = _kernel_vs_plain(_poison(*inputs), cuda_device, torch.float32, 1e-4)
    torch.testing.assert_close(a, b, atol=0, rtol=0)
    q, kp, vp, block, lens = _setup(5, B=2, T=1, H=2, Hkv=2, hd=16,
                                    n_pages=16, ps=4, P=4, lens=[0, 11])
    out = _kernel_vs_plain((q, kp, vp, block, lens), cuda_device,
                           torch.float32, 1e-4)
    assert torch.count_nonzero(out[0]) == 0


@pytest.mark.cuda
def test_kernel_strided_view_on_card(cuda_device):
    pk, pv, li = _pool_view(7)
    q, _, _, block, lens = _setup(8, B=3, T=4, H=6, Hkv=2, hd=16,
                                  n_pages=24, ps=4, P=5, lens=[4, 13, 20])
    tk, tv = _torch(pk, pv, device=cuda_device)
    tq, tb, tl = _torch(q, block, lens, device=cuda_device)
    out = pa_mod.paged_attention(tq, tk[:, :, li], tv[:, :, li], tb, tl)
    want = tref.paged_attention_ref(tq, tk[:, :, li], tv[:, :, li], tb, tl)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_kernel_padded_chunk_and_split_on_card(cuda_device):
    """cache_pos + T past the table (the page loop is bounded by P), and
    a chunk too long for one block's shared memory (split along T)."""
    _kernel_vs_plain(_setup(9, B=2, T=8, H=4, Hkv=2, hd=16, n_pages=16,
                            ps=4, P=3, lens=[14, 5]),
                     cuda_device, torch.float32, 1e-4)
    before = pa_mod.launches
    _kernel_vs_plain(_setup(10, B=2, T=48, H=8, Hkv=1, hd=128, n_pages=32,
                            ps=16, P=8, lens=[100, 60]),
                     cuda_device, torch.bfloat16, 3e-2)
    assert pa_mod.launches - before > 1
