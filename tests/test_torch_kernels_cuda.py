"""The Hopper paged-attention, flash-attention and NBB matmul kernels
against their plain PyTorch versions, on the card (``pytest -m cuda``).
Paged: the reference test shapes in float32 (1e-4: the summation order
differs) and bfloat16 (3e-2), poison pages, zero-length rows, a strided
per-layer pool view, a chunk that reaches past the block table and one
split along T; the split-KV decode and its combine (B=8, ps=16; the
ps=64 identity pages of a dense ring), the T=64 tensor-core chunk with
softcap, bit-identical repeats.  Flash: the cases of the JAX package's
flash tests, ragged T and S, a strided ring slice, rows that see no key,
the forward's log-sum-exp; paged attention's written-key bound
(``kv_lens``) at olmoe-1b-7b's shapes on all three routes, and its ring
bound (a sliding-window ring read with wrap-around) at gemma3-27b's
local-layer shapes on all three; the flash
backward kernel against
``ref.flash_attention_bwd_ref`` on every case with T <= S and at
smollm's training shape, bit-identical from call to call; and
``flash_attention_trainable``'s gradients (1e-4).  NBB matmul: the
reference test shapes and tolerances, one and 13 kernel K tiles, ragged
edges, refused operands; in bf16, each tile instance's ring at 1, S-1,
S+1 and 2S+1 K steps, ragged edges through TMA's zero fill,
bit-identical repeats.  Imports no JAX, so it runs where only the port
is installed; skipped without a card."""
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
    a chunk too long for one block's shared memory on the CUDA-core route
    (float32: split along T); in bf16 the same chunk is one tensor-core
    launch."""
    _kernel_vs_plain(_setup(9, B=2, T=8, H=4, Hkv=2, hd=16, n_pages=16,
                            ps=4, P=3, lens=[14, 5]),
                     cuda_device, torch.float32, 1e-4)
    long_chunk = _setup(10, B=2, T=48, H=8, Hkv=1, hd=128, n_pages=32,
                        ps=16, P=8, lens=[100, 60])
    before = (pa_mod.launches, pa_mod.simt_launches)
    _kernel_vs_plain(long_chunk, cuda_device, torch.float32, 1e-4)
    pieces = pa_mod.launches - before[0]
    assert pieces > 1 and pa_mod.simt_launches - before[1] == pieces
    before = (pa_mod.launches, pa_mod.simt_launches)
    _kernel_vs_plain(long_chunk, cuda_device, torch.bfloat16, 3e-2)
    assert (pa_mod.launches - before[0],
            pa_mod.simt_launches - before[1]) == (1, 0)


def _main_pool(seed, B, T, lens, ps=16, P=64, n_pages=512, H=9, Hkv=3,
               hd=64, L=3, li=1, device="cuda"):
    """A strided per-layer view of a [n_pages, ps, L, Hkv, hd] pool (the
    serving pool's layout), a block table of disjoint scattered pages and
    the given lengths, numpy-seeded; float32 tensors on ``device``."""
    rng = np.random.default_rng(seed)
    pk, pv = (rng.normal(size=(n_pages, ps, L, Hkv, hd)).astype(np.float32)
              for _ in range(2))
    q = rng.normal(size=(B, T, H, hd)).astype(np.float32)
    block = rng.permutation(n_pages)[:B * P].reshape(B, P).astype(np.int32)
    tq, tk, tv, tb, tl = _torch(q, pk, pv, block,
                                np.asarray(lens, np.int32), device=device)
    return tq, tk[:, :, li], tv[:, :, li], tb, tl


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_split_kv_decode_and_combine_on_card(cuda_device, dtype, atol):
    """The slot_paged decode shape (B=8, ps=16, P=64: 16 splits of 64
    keys): a lens=0 row, rows shorter than one split, a row that ends on
    a split's edge, the full table; one split launch and one combine."""
    lens = [0, 5, 63, 64, 65, 300, 545, 1024]
    q, kv, vv, block, ln = _main_pool(30, 8, 1, lens)
    dt = getattr(torch, dtype)
    q, kv, vv = q.to(dt), kv.to(dt), vv.to(dt)
    assert pa_mod.route(q, kv, vv) == "split"
    assert pa_mod.split_plan(8, 3, 64, 16) == (16, 64)
    before = (pa_mod.launches, pa_mod.combine_launches)
    out = pa_mod.paged_attention(q, kv, vv, block, ln)
    torch.cuda.synchronize()
    assert (pa_mod.launches, pa_mod.combine_launches) == (before[0] + 1,
                                                          before[1] + 1)
    want = tref.paged_attention_ref(q, kv, vv, block, ln)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)
    assert torch.count_nonzero(out[0]) == 0
    split = tref.paged_attention_split_ref(q, kv, vv, block, ln,
                                           split_keys=64)
    torch.testing.assert_close(out.float(), split.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
def test_split_kv_single_split_and_t_gt_1_on_card(cuda_device):
    """A table of 64 positions is one split (its combine merges one
    partial); T=4 decode rows (g*T = 12) with lens below T; softcap."""
    q, kv, vv, block, ln = _main_pool(31, 3, 4, [2, 0, 40], P=4,
                                      n_pages=32)
    assert pa_mod.route(q, kv, vv) == "split"
    assert pa_mod.split_plan(3, 3, 4, 16) == (1, 64)
    before = pa_mod.combine_launches
    out = pa_mod.paged_attention(q, kv, vv, block, ln, softcap=20.0)
    torch.cuda.synchronize()
    assert pa_mod.combine_launches == before + 1
    want = tref.paged_attention_ref(q, kv, vv, block, ln, softcap=20.0)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    assert torch.count_nonzero(out[1]) == 0
    assert torch.count_nonzero(out[0, :2]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_split_kv_identity_pages_on_card(cuda_device, dtype, atol):
    """The dense ring's decode read: a [4, 1024] ring viewed as 64-token
    identity pages (ps=64, P=16) of a strided layer slice."""
    rng = np.random.default_rng(32)
    B, size, Hkv, hd, ps = 4, 1024, 3, 64, 64
    dt = getattr(torch, dtype)
    ring_k, ring_v = (torch.from_numpy(rng.normal(
        size=(2, B, size, Hkv, hd)).astype(np.float32)).to(cuda_device,
                                                           dt)[1]
        for _ in range(2))
    kp = ring_k.view(B * size // ps, ps, Hkv, hd)
    vp = ring_v.view(B * size // ps, ps, Hkv, hd)
    block = torch.arange(B * size // ps, dtype=torch.int32,
                         device=cuda_device).view(B, size // ps)
    ln = torch.tensor([65, 300, 513, 1000], dtype=torch.int32,
                      device=cuda_device)
    q = torch.from_numpy(rng.normal(size=(B, 1, 9, hd)).astype(
        np.float32)).to(cuda_device, dt)
    assert pa_mod.route(q, kp, vp) == "split"
    assert pa_mod.split_plan(B, Hkv, size // ps, ps) == (16, 64)
    out = pa_mod.paged_attention(q, kp, vp, block, ln)
    want = tref.paged_attention_ref(q, kp, vp, block, ln)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunk_tensor_cores_on_card(cuda_device, softcap):
    """A T=64 bf16 chunk (g*T = 192 rows) on the tensor cores: causal to
    each row's lens, a row shorter than T, one past the table, softcap."""
    lens = [64, 300, 40, 1100]
    q, kv, vv, block, ln = _main_pool(33, 4, 64, lens)
    q, kv, vv = (t.to(torch.bfloat16) for t in (q, kv, vv))
    assert pa_mod.route(q, kv, vv) == "chunk_tc"
    before = (pa_mod.launches, pa_mod.combine_launches)
    out = pa_mod.paged_attention(q, kv, vv, block, ln, softcap=softcap)
    torch.cuda.synchronize()
    assert (pa_mod.launches, pa_mod.combine_launches) == (before[0] + 1,
                                                          before[1])
    want = tref.paged_attention_ref(q, kv, vv, block, ln, softcap=softcap)
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2,
                               rtol=3e-2)
    assert torch.count_nonzero(out[2, :24]) == 0      # q_pos < 0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64])
def test_paged_is_deterministic_on_card(cuda_device, T):
    """No atomics (split partials merged in split order): repeated calls
    are bit-identical."""
    q, kv, vv, block, ln = _main_pool(34, 8, T, [1, 70, 129, 300, 511, 512,
                                                 900, 1024])
    q, kv, vv = (t.to(torch.bfloat16) for t in (q, kv, vv))
    first = pa_mod.paged_attention(q, kv, vv, block, ln)
    for _ in range(3):
        assert torch.equal(first, pa_mod.paged_attention(q, kv, vv, block,
                                                         ln))


# olmoe-1b-7b's attention (16 query heads over 16 kv heads of 128: g = 1)
# on the slot_paged pool's pages (ps=16, P=64), cut to 2 layers.  Per T,
# (lens, kv_lens) per row: kv_lens 0 (an idle row), below lens (a dead
# row, a padded chunk tail, one past the table) and equal to lens.
OLMOE_POOL = dict(H=16, Hkv=16, hd=128, L=2)
KV_LENS_CASES = {
    1: ([1, 70, 129, 300, 511, 512, 900, 1024],
        [0, 69, 129, 0, 100, 512, 899, 1024]),
    64: ([64, 128, 300, 700, 1024, 1100, 64, 500],
         [0, 100, 300, 650, 1024, 1024, 10, 480]),
}


@pytest.mark.cuda
@pytest.mark.parametrize("T", sorted(KV_LENS_CASES))
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_kv_lens_at_olmoe_shapes_on_card(cuda_device, T, dtype, atol):
    """The written-key bound on every route at hd 128, g 1: the split-KV
    decode (8 splits of 128 keys + combine), the bf16 tensor-core chunk
    and the f32 CUDA-core chunk, against both plain versions; rows with
    kv_lens 0 are exact zeros, and kv_lens = lens changes no bit."""
    lens, kv = KV_LENS_CASES[T]
    dt = getattr(torch, dtype)
    q, kv_w, vv_w, block, ln = (
        t.to(dt) if t.is_floating_point() else t
        for t in _main_pool(40 + T, 8, T, lens, **OLMOE_POOL))
    kl = torch.tensor(kv, dtype=torch.int32, device=cuda_device)
    way = pa_mod.route(q, kv_w, vv_w)
    assert way == ("split" if T == 1 else
                   "chunk_tc" if dtype == "bfloat16" else "simt")
    if way == "split":
        assert pa_mod.split_plan(8, 16, 64, 16) == (8, 128)
    before = (pa_mod.launches, pa_mod.combine_launches)
    out = pa_mod.paged_attention(q, kv_w, vv_w, block, ln, kv_lens=kl)
    torch.cuda.synchronize()
    assert pa_mod.launches > before[0]
    assert pa_mod.combine_launches - before[1] == (way == "split")
    want = tref.paged_attention_ref(q, kv_w, vv_w, block, ln, kv_lens=kl)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)
    split = tref.paged_attention_split_ref(q, kv_w, vv_w, block, ln,
                                           split_keys=128, kv_lens=kl)
    torch.testing.assert_close(out.float(), split.float(), atol=atol,
                               rtol=atol)
    assert torch.count_nonzero(out[kl == 0]) == 0
    full = torch.maximum(ln, kl)
    assert torch.equal(
        pa_mod.paged_attention(q, kv_w, vv_w, block, ln, kv_lens=full),
        pa_mod.paged_attention(q, kv_w, vv_w, block, ln))


# gemma3-27b's local layers: a [4, 1024] ring of 16 kv heads of 128 (32
# query heads, g 2) read as 16 identity pages of 64 slots, with
# wrap-around.  Per T: (cache_pos, n_valid) per row, n = cp + n_valid the
# row's count: below the ring, at it, past it, and one short of two
# rings; n_valid None: no kv_lens (every token written).
RING = dict(B=4, size=1024, ps=64, Hkv=16, H=32, hd=128)
RING_CASES = {
    "decode": (1, [699, 1023, 1499, 2046], None),
    "decode_kv_lens": (1, [699, 1023, 1500, 2046], [1, 1, 0, 1]),
    "chunk": (64, [636, 960, 1436, 1983], None),
    "chunk_kv_lens": (64, [636, 1014, 1500, 2010], [64, 10, 0, 37]),
}


def _ring_setup(seed, T, cps, n_valid, dtype, device):
    r = RING
    g = torch.Generator(device=device).manual_seed(seed)
    n_pages = r["B"] * r["size"] // r["ps"]
    k, v = (torch.randn((n_pages, r["ps"], r["Hkv"], r["hd"]), generator=g,
                        device=device).to(dtype) for _ in range(2))
    q = torch.randn((r["B"], T, r["H"], r["hd"]), generator=g,
                    device=device).to(dtype)
    block = torch.arange(n_pages, dtype=torch.int32,
                         device=device).view(r["B"], -1)
    cp = torch.tensor(cps, dtype=torch.int32, device=device)
    kv = None if n_valid is None else cp + torch.tensor(
        n_valid, dtype=torch.int32, device=device)
    return q, k, v, block, cp + T, kv


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(RING_CASES))
@pytest.mark.parametrize("window", [1024, 200])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 3e-2)])
def test_ring_bound_on_card(cuda_device, name, window, dtype, atol):
    """The ring bound on every route (split + combine at T=1, the bf16
    tensor-core chunk and the f32 CUDA-core chunk, split along T, at
    T=64) at gemma's local-layer shapes, against both plain versions;
    queries that see no key are exact zeros; two calls bit-identical."""
    T, cps, n_valid = RING_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v, block, lens, kv = _ring_setup(80 + T, T, cps, n_valid, dt,
                                           cuda_device)
    kw = dict(kv_lens=kv, ring=RING["size"], window=window)
    way = pa_mod.route(q, k, v)
    assert way == ("split" if T == 1 else
                   "chunk_tc" if dtype == "bfloat16" else "simt")
    before = pa_mod.ring_launches
    out = pa_mod.paged_attention(q, k, v, block, lens, **kw)
    again = pa_mod.paged_attention(q, k, v, block, lens, **kw)
    torch.cuda.synchronize()
    assert pa_mod.ring_launches > before
    assert torch.equal(out, again)
    want = tref.paged_attention_ref(q, k, v, block, lens, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)
    split_keys = pa_mod.split_plan(RING["B"], RING["Hkv"], block.shape[1],
                                   RING["ps"])[1]
    split = tref.paged_attention_split_ref(q, k, v, block, lens, split_keys,
                                           **kw)
    torch.testing.assert_close(out.float(), split.float(), atol=atol,
                               rtol=atol)
    empty = want.float().abs().amax((2, 3)) == 0
    assert torch.count_nonzero(out[empty]) == 0


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_ring_bound_unwrapped_is_the_plain_bound_on_card(cuda_device, T,
                                                         dtype):
    """Over rows that never wrapped, ring = P * ps with window 0 changes
    no bit of any route's output."""
    q, k, v, block, _, _ = _ring_setup(90, T, [0] * 4, None,
                                       getattr(torch, dtype), cuda_device)
    n = torch.tensor([64, 700, 1000, 1024], dtype=torch.int32,
                     device=cuda_device)
    lens = n - torch.tensor([T, 5 if T > 1 else 1, 0, T], dtype=torch.int32,
                            device=cuda_device) + T
    plain = pa_mod.paged_attention(q, k, v, block, lens, kv_lens=n)
    ringed = pa_mod.paged_attention(q, k, v, block, lens, kv_lens=n,
                                    ring=RING["size"])
    torch.cuda.synchronize()
    assert torch.equal(plain, ringed)


# ---------------------------------------------------------------------------
# Flash attention: the cases of tests/test_kernels.py and
# tests/test_kernels_decode.py, ragged T and S, and a strided ring slice.
# ---------------------------------------------------------------------------
from repro_torch.kernels import flash_attention as fa_mod  # noqa: E402

FLASH_CASES = {
    # name: (B, T, S, H, Hkv, hd, kwargs)
    "mha_128": (1, 128, 128, 4, 4, 64, {}),
    "gqa_suffix": (2, 128, 256, 8, 2, 64, {}),
    "hd128": (1, 256, 256, 6, 3, 128, {}),
    "window_128": (1, 512, 512, 4, 4, 64, dict(window=128)),
    "window_512": (1, 512, 512, 4, 4, 64, dict(window=512)),
    "softcap_50": (1, 128, 128, 2, 2, 64, dict(softcap=50.0)),
    "noncausal": (1, 128, 256, 4, 4, 64, dict(causal=False)),
    "decode_512": (2, 1, 512, 8, 2, 64, {}),
    "decode_window_256": (1, 1, 1024, 4, 4, 64, dict(window=256)),
    "gqa_16_1": (1, 128, 128, 16, 1, 64, {}),
    "gqa_12_4": (1, 128, 128, 12, 4, 64, {}),
    "gqa_9_3": (1, 128, 128, 9, 3, 64, {}),
    "ragged_37_101": (2, 37, 101, 9, 3, 64, {}),
    "ragged_window": (1, 45, 77, 6, 2, 32, dict(window=20, softcap=30.0)),
    "ragged_noncausal": (1, 3, 70, 4, 1, 16, dict(causal=False)),
}


def _flash_inputs(seed, B, T, S, H, Hkv, hd):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, T, H, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32),
            rng.normal(size=(B, S, Hkv, hd)).astype(np.float32))


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CASES))
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_flash_matches_plain_on_card(cuda_device, name, dtype, atol):
    B, T, S, H, Hkv, hd, kw = FLASH_CASES[name]
    q, k, v = (t.to(getattr(torch, dtype)) for t in _torch(
        *_flash_inputs(len(name), B, T, S, H, Hkv, hd), device=cuda_device))
    before = fa_mod.launches
    out = fa_mod.flash_attention(q, k, v, **kw)
    torch.cuda.synchronize()
    assert fa_mod.launches == before + 1
    want = tref.flash_attention_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)


# Larger grids with masking at every edge: ragged T and S with a window
# and a softcap, non-causal at head_dim 32, and the training shape, each
# with the log-sum-exp the trainable forward keeps.
FLASH_LARGE_CASES = {
    "large_window_softcap": (8, 500, 520, 16, 4, 64,
                             dict(window=90, softcap=30.0)),
    "large_noncausal_hd32": (16, 200, 200, 12, 4, 32, dict(causal=False)),
    "large_training": (4, 1024, 1024, 9, 3, 64, {}),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_LARGE_CASES))
def test_flash_large_grids_on_card(cuda_device, name):
    B, T, S, H, Hkv, hd, kw = FLASH_LARGE_CASES[name]
    q, k, v = (t.to(torch.bfloat16) for t in _torch(
        *_flash_inputs(len(name), B, T, S, H, Hkv, hd), device=cuda_device))
    out, lse = fa_mod.flash_attention_fwd(q, k, v, **kw)
    want, want_lse = tref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2,
                               rtol=3e-2)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_strided_ring_slice_on_card(cuda_device):
    """The dense path's read: a prefix ``ring[li][:, :S]`` of a stacked
    [L, B, size, Hkv, hd] cache, strided over the batch, read in place."""
    rng = np.random.default_rng(11)
    ring = rng.normal(size=(2, 3, 96, 3, 64)).astype(np.float32)
    q = rng.normal(size=(3, 1, 9, 64)).astype(np.float32)
    tr, tq = _torch(ring, q, device=cuda_device)
    k, v = tr[1][:, :53], tr[0][:, :53]
    assert not k.is_contiguous()
    out = fa_mod.flash_attention(tq, k, v)
    want = tref.flash_attention_ref(tq, k, v)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
def test_flash_rows_without_keys_are_zero_on_card(cuda_device):
    """Causal with S < T: the first T - S queries see no key and return
    exact zeros (the TPU kernel's l == 0 -> 1 step); the rest match."""
    q, k, v = _torch(*_flash_inputs(12, 1, 10, 6, 4, 2, 16),
                     device=cuda_device)
    out = fa_mod.flash_attention(q, k, v)
    assert torch.count_nonzero(out[:, :4]) == 0
    want = tref.flash_attention_ref(q[:, 4:], k, v)
    torch.testing.assert_close(out[:, 4:], want, atol=1e-4, rtol=1e-4)


# ---------------------------------------------------------------------------
# NBB matmul: tests/test_kernels.py's shapes and tolerances, then the
# kernel's own K tiles (32 of K each): one tile, an odd count (13), and
# ragged M/N/K edges.
# ---------------------------------------------------------------------------
from repro_torch.kernels import nbb_matmul as nbb_mod  # noqa: E402

NBB_CASES = {
    # name: (M, K, N, blocks, float32 (atol, rtol))
    "k_pipeline_4": (256, 512, 256, (128, 128, 128), (5e-4, 1e-3)),
    "single_k_step": (128, 128, 128, (128, 128, 128), (5e-4, 1e-3)),
    "bm256": (512, 1024, 256, (256, 256, 256), (5e-4, 1e-3)),
    "odd_k_depth": (128, 384, 128, (128, 128, 128), (2e-5, 2e-5)),
    "one_kernel_tile": (128, 32, 128, (256, 256, 512), (2e-5, 2e-5)),
    "odd_kernel_tiles": (128, 416, 128, (256, 256, 512), (2e-5, 2e-5)),
    "ragged": (100, 40, 72, (256, 256, 512), (2e-5, 2e-5)),
}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NBB_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_nbb_matmul_matches_plain_on_card(cuda_device, name, dtype):
    M, K, N, (bm, bn, bk), f32_tol = NBB_CASES[name]
    atol, rtol = f32_tol if dtype == "float32" else (3e-2, 3e-2)
    rng = np.random.default_rng(len(name))
    a, b = (t.to(getattr(torch, dtype)) for t in _torch(
        rng.normal(size=(M, K)).astype(np.float32),
        rng.normal(size=(K, N)).astype(np.float32), device=cuda_device))
    before = nbb_mod.launches
    out = nbb_mod.nbb_matmul(a, b, bm=bm, bn=bn, bk=bk)
    torch.cuda.synchronize()
    assert nbb_mod.launches == before + 1
    want = tref.matmul_ref(a, b)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=rtol)


def _nbb_bf16(M, K, N, seed, device):
    rng = np.random.default_rng(seed)
    return (t.to(torch.bfloat16) for t in _torch(
        rng.normal(size=(M, K)).astype(np.float32),
        rng.normal(size=(K, N)).astype(np.float32), device=device))


# name: (M, N, instance); K runs over 1, S-1, S+1 and 2S+1 K steps of the
# instance's S-slot ring, so each slot's phase parity is met in more
# than one round and the last round is partial.
NBB_RINGS = {"tile_64": (128, 128, 1), "tile_128": (1408, 1536, 2)}


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(NBB_RINGS))
@pytest.mark.parametrize("rounds", ["1", "S-1", "S+1", "2S+1"])
def test_nbb_bf16_ring_depths_on_card(cuda_device, name, rounds):
    M, N, inst = NBB_RINGS[name]
    S = nbb_mod.SLOTS[inst]
    steps = {"1": 1, "S-1": S - 1, "S+1": S + 1, "2S+1": 2 * S + 1}[rounds]
    K = steps * nbb_mod.TILE[inst][2]
    assert nbb_mod.instance_for(torch.bfloat16, M, N) == inst
    a, b = _nbb_bf16(M, K, N, steps + inst, cuda_device)
    out = nbb_mod.nbb_matmul(a, b, bm=M, bn=N, bk=K)
    torch.testing.assert_close(out.float(), tref.matmul_ref(a, b).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N,inst", [
    (100, 40, 72, 1),         # one ragged K step, ragged M and N
    (130, 200, 72, 1),        # three full K steps and 8 more
    (1500, 200, 1544, 2),     # 12 x 13 blocks, every edge ragged
])
def test_nbb_bf16_ragged_edges_on_card(cuda_device, M, K, N, inst):
    """TMA's out-of-bounds zero fill takes the ragged edges: rows past M,
    columns past N and K steps past K read as zeros."""
    assert nbb_mod.instance_for(torch.bfloat16, M, N) == inst
    a, b = _nbb_bf16(M, K, N, M + K, cuda_device)
    out = nbb_mod.nbb_matmul(a, b, bm=M, bn=N, bk=K)
    torch.testing.assert_close(out.float(), tref.matmul_ref(a, b).float(),
                               atol=3e-2, rtol=3e-2)


@pytest.mark.cuda
@pytest.mark.parametrize("M,K,N", [(512, 1024, 512), (1408, 704, 1536)])
def test_nbb_bf16_is_deterministic_on_card(cuda_device, M, K, N):
    """No split over K: repeated calls are bit-identical."""
    a, b = _nbb_bf16(M, K, N, 7, cuda_device)
    first = nbb_mod.nbb_matmul(a, b, bm=M, bn=N, bk=K)
    for _ in range(3):
        assert torch.equal(first, nbb_mod.nbb_matmul(a, b, bm=M, bn=N,
                                                     bk=K))


@pytest.mark.cuda
def test_nbb_matmul_refuses_what_the_copy_engine_cannot_take(cuda_device):
    a = torch.zeros((64, 64), device=cuda_device)
    with pytest.raises(ValueError, match="contiguous"):
        nbb_mod.nbb_matmul(a, a.t())
    with pytest.raises(ValueError, match="16-byte"):
        nbb_mod.nbb_matmul(torch.zeros((64, 6), device=cuda_device),
                           torch.zeros((6, 64), device=cuda_device))


# ---------------------------------------------------------------------------
# The forward's log-sum-exp and the flash backward kernel.
# ---------------------------------------------------------------------------
BWD_CASES = sorted(n for n, c in FLASH_CASES.items() if c[1] <= c[2])


def _bwd_inputs(name, B, T, S, H, Hkv, hd, dtype, device):
    q, k, v = (t.to(dtype) for t in _torch(
        *_flash_inputs(len(name) + 50, B, T, S, H, Hkv, hd), device=device))
    rng = np.random.default_rng(len(name) + 51)
    dout = _torch(rng.normal(size=(B, T, H, hd)).astype(np.float32),
                  device=device)[0].to(dtype)
    return q, k, v, dout


# bf16 gradients, element by element: atol + rtol |want|, as chip_smoke.py
# phase 2d holds them (the readings they were set from are in PERF.md).
BF16_GRAD_TOL = (2e-2, 1e-2)


def _bf16_grad_close(got, want):
    """bf16 gradients: the kernel rounds P and dS to bf16 (8 significant
    bits, 2^-9 relative) before its products and the results to bf16,
    where the plain version keeps f32.  A gradient's size falls with the
    count of keys its row sees (or rows that see its key), so each element
    is held to its own |want| (rtol, 2.5 bf16 steps) above a floor for
    entries near zero (atol, about one bf16 step of the first rows'
    entries): a late row or key missing a 64 x 64 tile, which moves by
    0.1-0.45 at the training shape, fails."""
    atol, rtol = BF16_GRAD_TOL
    torch.testing.assert_close(got.float(), want.float(), atol=atol,
                               rtol=rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["gqa_9_3", "ragged_window", "noncausal",
                                  "decode_512"])
@pytest.mark.parametrize("dtype,atol", [("float32", 1e-4),
                                        ("bfloat16", 3e-2)])
def test_flash_lse_on_card(cuda_device, name, dtype, atol):
    B, T, S, H, Hkv, hd, kw = FLASH_CASES[name]
    q, k, v = (t.to(getattr(torch, dtype)) for t in _torch(
        *_flash_inputs(len(name), B, T, S, H, Hkv, hd), device=cuda_device))
    out, lse = fa_mod.flash_attention_fwd(q, k, v, **kw)
    want_out, want_lse = tref.flash_attention_fwd_ref(q, k, v, **kw)
    torch.testing.assert_close(out.float(), want_out.float(), atol=atol,
                               rtol=atol)
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)


@pytest.mark.cuda
@pytest.mark.parametrize("name", BWD_CASES)
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_matches_plain_on_card(cuda_device, name, dtype):
    """The kernel and the plain backward on the same residuals (the plain
    forward's out and lse), so only the backward is compared."""
    B, T, S, H, Hkv, hd, kw = FLASH_CASES[name]
    q, k, v, dout = _bwd_inputs(name, B, T, S, H, Hkv, hd,
                                getattr(torch, dtype), cuda_device)
    out, lse = tref.flash_attention_fwd_ref(q, k, v, **kw)
    before = fa_mod.bwd_launches
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fa_mod.bwd_launches == before + 1
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    for a, b in zip(got, want):
        assert a.dtype == b.dtype and a.shape == b.shape
        if dtype == "float32":
            torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
        else:
            _bf16_grad_close(a, b)


@pytest.mark.cuda
def test_flash_bwd_training_shape_on_card(cuda_device):
    """smollm's training shape: B=4, T=S=1024, 9/3 heads, bf16."""
    q, k, v, dout = _bwd_inputs("training", 4, 1024, 1024, 9, 3, 64,
                                torch.bfloat16, cuda_device)
    out, lse = fa_mod.flash_attention_fwd(q, k, v)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout)
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout)
    for a, b in zip(got, want):
        _bf16_grad_close(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_is_deterministic_on_card(cuda_device, dtype):
    """Two passes, no atomics: repeated calls are bit-identical."""
    q, k, v, dout = _bwd_inputs("repeat", 2, 256, 256, 9, 3, 64,
                                getattr(torch, dtype), cuda_device)
    out, lse = fa_mod.flash_attention_fwd(q, k, v, window=100)
    first = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout, window=100)
    for _ in range(3):
        again = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout,
                                           window=100)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
def test_flash_route_on_card(cuda_device):
    """bf16 at head_dim 64 takes the tensor-core instance; an unaligned
    row stride or float32 takes the CUDA-core one, which alone counts in
    ``simt_launches``, and both agree with the plain version."""
    q, k, v = (t.to(torch.bfloat16) for t in _torch(
        *_flash_inputs(5, 1, 64, 64, 4, 2, 64), device=cuda_device))
    assert fa_mod.tensor_core_route(q, k, v)
    assert not fa_mod.tensor_core_route(q.float(), k.float(), v.float())
    wide = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16,
                       device=cuda_device)
    wide[..., :64] = k
    k_odd = wide[..., :64]                      # row stride 68: not 16-byte
    assert not fa_mod.tensor_core_route(q, k_odd, v)
    before = fa_mod.simt_launches
    fast = fa_mod.flash_attention(q, k, v)
    assert fa_mod.simt_launches == before
    out = fa_mod.flash_attention(q, k_odd, v)
    assert fa_mod.simt_launches == before + 1
    want = tref.flash_attention_ref(q, k, v)
    for got in (fast, out):
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)


# ---------------------------------------------------------------------------
# flash_attention_trainable: the forward and backward kernels, against
# autograd through the plain version.
# ---------------------------------------------------------------------------
@pytest.mark.cuda
@pytest.mark.parametrize("B,T,H,Hkv,hd,kw", [
    (1, 128, 2, 2, 64, {}),                          # test_kernels.py:86
    (2, 96, 9, 3, 64, dict(window=40, softcap=30.0)),
])
def test_flash_trainable_grads_on_card(cuda_device, B, T, H, Hkv, hd, kw):
    q, k, v = _torch(*_flash_inputs(13, B, T, T, H, Hkv, hd),
                     device=cuda_device)
    gout = torch.randn((B, T, H, hd), device=cuda_device)
    results, launched = [], []
    for fn in (fa_mod.flash_attention_trainable, tref.flash_attention_ref):
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = (fa_mod.launches, fa_mod.bwd_launches)
        out = fn(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, gout)
        launched.append((fa_mod.launches - before[0],
                         fa_mod.bwd_launches - before[1]))
        results.append((out.detach(),) + tuple(grads))
    # One forward and one backward launch; the plain version launches none.
    assert launched == [(1, 1), (0, 0)]
    for a, b in zip(*results):
        torch.testing.assert_close(a, b, atol=1e-4, rtol=1e-4)
