"""The Hopper paged-attention, flash-attention and NBB matmul kernels
against their plain PyTorch versions, on the card (``pytest -m cuda``).
Paged: the reference test shapes in float32 (1e-4: the summation order
differs) and bfloat16 (3e-2), poison pages, zero-length rows, a strided
per-layer pool view, a chunk that reaches past the block table and one
split along T; the bf16 split-KV decode merged in its launch (B=8,
ps=16; the ps=64 identity pages of a dense ring), the T=64 wgmma chunk
with softcap, bit-identical repeats, at the smollm, olmoe and gemma-ring
shapes a batch row bit-identical alone and in a batch of 8 on both
routes, two streams' arrival counters apart and a call leaving them at
0, NaN-poisoned pages past each row's key end never read, rows with no
key exact zeros, and head dims 16/32/64/80/128 with and without a
softcap.  Flash: the cases of the JAX package's
flash tests, ragged T and S, a strided ring slice, rows that see no key,
the forward's log-sum-exp, the non-causal route at the cross and encoder
shapes of llama-3.2-vision-11b and whisper-tiny; the forward's split and
``wgmma`` routes at the served and trained shapes over ring slices (the
wave's decode, the cross decodes and chunk, the encoder, training at
head_dim 64 and 80, the B=1 prefills, an hd 128 prefill under a 1024
window), each bit-identical twice and batch row by batch row, each bound
rejecting a dropped key tile, rows without keys exactly 0 on both, the
split route's counters per stream; paged attention's written-key bound
(``kv_lens``) at olmoe-1b-7b's shapes on all three routes, and its ring
bound (a sliding-window ring read with wrap-around) at gemma3-27b's
local-layer shapes on all three; the head_dim 80 instances (flash's
forward, the paged split and chunk) at zamba2-2.7b's shared attention,
each bound rejecting the output with its last key tile dropped; the flash
backward kernel against
``ref.flash_attention_bwd_ref`` on every case with T <= S, at
smollm's training shape, at zamba2-2.7b's head_dim 80 (32/32 heads at
its training shape; 32/8 ragged with window + softcap) and whisper-tiny's
non-causal cross read (T=448, S=1500), each of the last three with a
dropped tile its bound must reject, bit-identical from call to call at
head dims 64, 80 and 128, with no per-head f32 partial allocated at g =
3, and with a broadcast cotangent; and
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
    """The slot_paged decode shape (B=8, ps=16, P=64: 8 runs of 128
    keys): a lens=0 row, rows shorter than one run, a row that ends on a
    run's edge, the full table; bf16 on the split route, one launch with
    its merge (the name is the test's from when a combine launch
    followed), f32 on the CUDA-core route."""
    lens = [0, 5, 63, 64, 65, 300, 545, 1024]
    q, kv, vv, block, ln = _main_pool(30, 8, 1, lens)
    dt = getattr(torch, dtype)
    q, kv, vv = q.to(dt), kv.to(dt), vv.to(dt)
    split_route = dtype == "bfloat16"
    assert pa_mod.plan(q, kv, vv, block) == (
        ("split", (128, 8)) if split_route else ("simt", None))
    before = (pa_mod.launches, pa_mod.split_launches)
    out = pa_mod.paged_attention(q, kv, vv, block, ln)
    torch.cuda.synchronize()
    assert (pa_mod.launches, pa_mod.split_launches) == (
        before[0] + 1, before[1] + split_route)
    want = tref.paged_attention_ref(q, kv, vv, block, ln)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)
    assert torch.count_nonzero(out[0]) == 0
    split = tref.paged_attention_split_ref(q, kv, vv, block, ln,
                                           split_keys=128)
    torch.testing.assert_close(out.float(), split.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
def test_split_kv_single_split_and_t_gt_1_on_card(cuda_device):
    """A table of 64 positions is one run (its rows written directly, no
    partial); T=4 decode rows (g*T = 12) with lens below T; softcap: f32
    on the CUDA-core route within 1e-4, bf16 on the split route within
    3e-2."""
    q, kv, vv, block, ln = _main_pool(31, 3, 4, [2, 0, 40], P=4,
                                      n_pages=32)
    assert pa_mod.route(q, kv, vv) == "simt"
    out = pa_mod.paged_attention(q, kv, vv, block, ln, softcap=20.0)
    want = tref.paged_attention_ref(q, kv, vv, block, ln, softcap=20.0)
    torch.testing.assert_close(out, want, atol=1e-4, rtol=1e-4)
    q, kv, vv = (t.to(torch.bfloat16) for t in (q, kv, vv))
    assert pa_mod.plan(q, kv, vv, block) == ("split", (64, 1))
    before = pa_mod.split_launches
    out = pa_mod.paged_attention(q, kv, vv, block, ln, softcap=20.0)
    torch.cuda.synchronize()
    assert pa_mod.split_launches == before + 1
    want = tref.paged_attention_ref(q, kv, vv, block, ln, softcap=20.0)
    torch.testing.assert_close(out.float(), want.float(), atol=3e-2,
                               rtol=3e-2)
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
    assert pa_mod.plan(q, kp, vp, block) == (
        ("split", (128, 8)) if dtype == "bfloat16" else ("simt", None))
    out = pa_mod.paged_attention(q, kp, vp, block, ln)
    want = tref.paged_attention_ref(q, kp, vp, block, ln)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("softcap", [0.0, 30.0])
def test_chunk_tensor_cores_on_card(cuda_device, softcap):
    """A T=64 bf16 chunk (g*T = 192 rows, 3 warpgroups of one block per
    kv head) on wgmma: causal to each row's lens, a row shorter than T,
    one past the table, softcap."""
    lens = [64, 300, 40, 1100]
    q, kv, vv, block, ln = _main_pool(33, 4, 64, lens)
    q, kv, vv = (t.to(torch.bfloat16) for t in (q, kv, vv))
    assert pa_mod.plan(q, kv, vv, block) == ("wgmma", (512, 2))
    before = (pa_mod.launches, pa_mod.split_launches)
    out = pa_mod.paged_attention(q, kv, vv, block, ln, softcap=softcap)
    torch.cuda.synchronize()
    assert (pa_mod.launches, pa_mod.split_launches) == (before[0] + 1,
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
    """The written-key bound on every route at hd 128, g 1: the bf16
    split-KV decode (8 runs of 128 keys, merged in the launch) and wgmma
    chunk (2 runs of 512), and f32 on the CUDA-core route, against both
    plain versions; rows with kv_lens 0 are exact zeros, and kv_lens =
    lens changes no bit."""
    lens, kv = KV_LENS_CASES[T]
    dt = getattr(torch, dtype)
    q, kv_w, vv_w, block, ln = (
        t.to(dt) if t.is_floating_point() else t
        for t in _main_pool(40 + T, 8, T, lens, **OLMOE_POOL))
    kl = torch.tensor(kv, dtype=torch.int32, device=cuda_device)
    way, runs = pa_mod.plan(q, kv_w, vv_w, block)
    assert (way, runs) == (("simt", None) if dtype == "float32" else
                           ("split", (128, 8)) if T == 1 else
                           ("wgmma", (512, 2)))
    before = (pa_mod.launches, pa_mod.split_launches)
    out = pa_mod.paged_attention(q, kv_w, vv_w, block, ln, kv_lens=kl)
    torch.cuda.synchronize()
    assert pa_mod.launches > before[0]
    assert pa_mod.split_launches - before[1] == (way == "split")
    want = tref.paged_attention_ref(q, kv_w, vv_w, block, ln, kv_lens=kl)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)
    split = tref.paged_attention_split_ref(
        q, kv_w, vv_w, block, ln, split_keys=runs[0] if runs else 128,
        kv_lens=kl)
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
    """The ring bound on every route (in bf16 the split decode at T=1 and
    the wgmma chunk at T=64, in f32 the CUDA-core route, split along T at
    T=64) at gemma's local-layer shapes, against both plain versions;
    queries that see no key are exact zeros; two calls bit-identical."""
    T, cps, n_valid = RING_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v, block, lens, kv = _ring_setup(80 + T, T, cps, n_valid, dt,
                                           cuda_device)
    kw = dict(kv_lens=kv, ring=RING["size"], window=window)
    way, runs = pa_mod.plan(q, k, v, block, RING["size"], window)
    assert way == ("simt" if dtype == "float32" else
                   "split" if T == 1 else "wgmma")
    before = pa_mod.ring_launches
    out = pa_mod.paged_attention(q, k, v, block, lens, **kw)
    again = pa_mod.paged_attention(q, k, v, block, lens, **kw)
    torch.cuda.synchronize()
    assert pa_mod.ring_launches > before
    assert torch.equal(out, again)
    want = tref.paged_attention_ref(q, k, v, block, lens, **kw)
    torch.testing.assert_close(out.float(), want.float(), atol=atol,
                               rtol=atol)
    split_keys = pa_mod.split_plan(T, block.shape[1] * RING["ps"],
                                   RING["size"], window, T > 1)[0]
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


# The tensor-core routes at the served shapes: (H, Hkv, hd, ps, P, ring,
# window) of smollm's slot_paged pool, olmoe's and gemma3-27b's local
# ring (identity pages of 64 slots), qwen3-14b's (g 5) and arctic-480b's
# (g 7) pools at hd 128 and stablelm-3b's at hd 80 over real pages, and
# per T the rows' lens: a lens=0 row, rows shorter than one run, on a
# run's edge, long ones.
ROUTE_SHAPES = {
    "smollm": (9, 3, 64, 16, 64, 0, 0),
    "olmoe": (16, 16, 128, 16, 64, 0, 0),
    "gemma_ring": (32, 16, 128, 64, 16, 1024, 1024),
    "qwen3": (40, 8, 128, 16, 64, 0, 0),
    "arctic": (56, 8, 128, 16, 64, 0, 0),
    "stablelm": (32, 32, 80, 16, 64, 0, 0),
}
ROUTE_LENS = {1: [0, 5, 63, 64, 65, 300, 545, 1024],
              64: [64, 40, 0, 300, 512, 576, 1024, 1100]}


def _poisoned_pool(seed, B, T, H, Hkv, hd, ps, P, ring, lens, device):
    """bf16 q and a strided layer view of a [n_pages, ps, 2, Hkv, hd] pool
    whose slots that hold no key of their row (past its key end, or a
    ring's slots not yet written) are NaN; rows on disjoint scattered
    pages (identity pages for a ring); lens as given (a ring's count n =
    lens)."""
    g = torch.Generator(device=device).manual_seed(seed)
    n_pages = B * P + 4
    pool = torch.randn((2, n_pages, ps, 2, Hkv, hd), generator=g,
                       device=device).to(torch.bfloat16)
    q = torch.randn((B, T, H, hd), generator=g,
                    device=device).to(torch.bfloat16)
    if ring:
        block = torch.arange(B * P, dtype=torch.int32,
                             device=device).view(B, P)
    else:
        block = torch.randperm(n_pages, generator=g, device=device)[
            :B * P].reshape(B, P).to(torch.int32)
    held = torch.zeros((n_pages, ps), dtype=torch.bool, device=device)
    for b, n in enumerate(lens):
        keys = (torch.arange(max(0, n - ring), n, device=device) if ring
                else torch.arange(min(n, P * ps), device=device))
        slots = keys % ring if ring else keys
        held[block[b].long()[slots // ps], slots % ps] = True
    layer = pool[:, :, :, 1]                   # a view: writes reach pool
    layer[:, ~held] = float("nan")
    ln = torch.tensor(lens, dtype=torch.int32, device=device)
    return q, pool[0, :, :, 1], pool[1, :, :, 1], block, ln


@pytest.mark.cuda
@pytest.mark.parametrize("T", sorted(ROUTE_LENS))
@pytest.mark.parametrize("shape", sorted(ROUTE_SHAPES))
def test_paged_batch_rows_alone_on_card(cuda_device, shape, T):
    """At every served shape of ``ROUTE_SHAPES``, on the split route
    (T=1) and the wgmma route (T=64): each batch row's output bit-equal
    to the row alone (the plan never reads the batch), within 3e-2 of the
    plain version, NaN in every slot past a row's keys never read, a row
    with no key (or a query before position 0) exact zeros, and the
    arrival counters back at 0."""
    H, Hkv, hd, ps, P, ring, window = ROUTE_SHAPES[shape]
    lens = ROUTE_LENS[T]
    if ring:                                   # counts past the ring
        lens = [n + 700 if n > 100 else n for n in lens]
    q, k, v, block, ln = _poisoned_pool(60, 8, T, H, Hkv, hd, ps, P, ring,
                                        lens, cuda_device)
    kw = dict(ring=ring, window=window, kv_lens=ln if ring else None)
    way = pa_mod.plan(q, k, v, block, ring, window)[0]
    assert way == ("split" if T == 1 else "wgmma")
    out = pa_mod.paged_attention(q, k, v, block, ln, **kw)
    torch.cuda.synchronize()
    assert not torch.isnan(out).any()
    for b in range(8):
        one = dict(kw, kv_lens=None if kw["kv_lens"] is None
                   else ln[b:b + 1])
        alone = pa_mod.paged_attention(q[b:b + 1], k, v, block[b:b + 1],
                                       ln[b:b + 1], **one)
        assert torch.equal(alone, out[b:b + 1]), b
    clean = [torch.nan_to_num(t) for t in (k, v)]
    want = tref.paged_attention_ref(q, *clean, block, ln, **kw).float()
    torch.testing.assert_close(out.float(), want, atol=3e-2, rtol=3e-2)
    empty = want.abs().amax((2, 3)) == 0               # [B, T]
    assert empty.any() and torch.count_nonzero(out[empty]) == 0
    assert all(int(c.abs().sum()) == 0 for c in fa_mod._COUNTERS.values())


@pytest.mark.cuda
@pytest.mark.parametrize("T", [1, 64])
def test_paged_split_counters_are_per_stream(cuda_device, T):
    """The arrival counters of both tensor-core routes belong to a
    (device, stream): the same call on two streams, one after the other,
    uses two counter arrays, each left at 0, and gives the same bits."""
    q, k, v, block, ln = _poisoned_pool(61, 8, T, 16, 16, 128, 16, 64, 0,
                                        ROUTE_LENS[T], cuda_device)
    outs = []
    streams = (torch.cuda.Stream(), torch.cuda.Stream())
    for stream in streams:
        with torch.cuda.stream(stream):
            outs.append(pa_mod.paged_attention(q, k, v, block, ln))
        stream.synchronize()
    assert torch.equal(outs[0], outs[1])
    mine = [fa_mod._COUNTERS[(q.device.index, st.cuda_stream)]
            for st in streams]
    assert mine[0].data_ptr() != mine[1].data_ptr()
    assert all(int(c.abs().sum()) == 0 for c in mine)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("hd", [16, 32, 64, 80, 128])
@pytest.mark.parametrize("T", [1, 64])
def test_paged_routes_at_head_dims_on_card(cuda_device, T, hd, cap):
    """Every head dim of the split (T=1) and wgmma (T=64) instances, with
    and without a softcap, 9/3 heads over a strided pool view: within
    3e-2 of the plain version, NaN past each row's keys never read, rows
    with no key exact zeros, two calls bit-identical."""
    _paged_routes_check(cuda_device, T, hd, cap, 9, 3, 62 + hd)


@pytest.mark.cuda
@pytest.mark.parametrize("cap", [0.0, 30.0])
@pytest.mark.parametrize("T", [1, 64])
def test_paged_routes_at_gqa_10_2_on_card(cuda_device, T, cap):
    """The same at 10/2 heads of 128: a group of 5 (qwen3-14b's), whose
    T=64 chunk is 5 tiles of 64 rows over 3 blocks of 2 warpgroups, the
    last with one, and whose decode fills 5 of the split tile's 16
    rows."""
    _paged_routes_check(cuda_device, T, 128, cap, 10, 2, 75)


def _paged_routes_check(cuda_device, T, hd, cap, H, Hkv, seed):
    q, k, v, block, ln = _poisoned_pool(seed, 8, T, H, Hkv, hd, 16, 64, 0,
                                        ROUTE_LENS[T], cuda_device)
    assert pa_mod.route(q, k, v) == ("split" if T == 1 else "wgmma")
    out = pa_mod.paged_attention(q, k, v, block, ln, softcap=cap)
    again = pa_mod.paged_attention(q, k, v, block, ln, softcap=cap)
    torch.cuda.synchronize()
    assert torch.equal(out, again) and not torch.isnan(out).any()
    want = tref.paged_attention_ref(q, *(torch.nan_to_num(t) for t in (k, v)),
                                    block, ln, softcap=cap).float()
    torch.testing.assert_close(out.float(), want, atol=3e-2, rtol=3e-2)
    empty = want.abs().amax((2, 3)) == 0
    assert torch.count_nonzero(out[empty]) == 0


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
    "gqa_40_8": (1, 256, 256, 40, 8, 128, {}),
    "gqa_40_8_decode": (4, 1, 513, 40, 8, 128, {}),
    "gqa_56_8": (1, 256, 256, 56, 8, 128, {}),
    "gqa_56_8_decode": (4, 1, 513, 56, 8, 128, {}),
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
    "large_training_hd80": (4, 1024, 1024, 32, 32, 80, {}),
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


# The non-causal route at the cross-attention families' shapes: llama-
# 3.2-vision-11b's cross layers (32/8 heads of 128, 1600 image tokens) at
# a decode step and a 64-token chunk, whisper-tiny's encoder (6/6 heads
# of 64, 1500 frames; ragged against every tile) and its SMOKE decoder's
# cross read with more queries than frames (head_dim 8: CUDA cores).
FLASH_CROSS_CASES = {
    "llama_cross_decode": (4, 1, 1600, 32, 8, 128),
    "llama_cross_chunk": (4, 64, 1600, 32, 8, 128),
    "whisper_encoder": (2, 1500, 1500, 6, 6, 64),
    "whisper_cross_decode": (4, 1, 1500, 6, 6, 64),
    "whisper_smoke_t_gt_s": (1, 40, 24, 4, 4, 8),
}


def _noncausal_bound(dtype, atol, want):
    """f32: ``atol``.  bf16: ``atol`` of the output's own scale; these
    outputs are means over many keys, so an absolute 3e-2 would be as
    large as a typical value and pass a wrong kernel."""
    return atol if dtype == "float32" else atol * want.abs().max().item()


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FLASH_CROSS_CASES))
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 3e-2)])
def test_flash_noncausal_cross_shapes_on_card(cuda_device, name, dtype,
                                              atol):
    B, T, S, H, Hkv, hd = FLASH_CROSS_CASES[name]
    q, k, v = (t.to(getattr(torch, dtype)) for t in _torch(
        *_flash_inputs(len(name), B, T, S, H, Hkv, hd), device=cuda_device))
    before = (fa_mod.launches, fa_mod.noncausal_launches)
    out = fa_mod.flash_attention(q, k, v, causal=False)
    torch.cuda.synchronize()
    assert (fa_mod.launches, fa_mod.noncausal_launches) == (
        before[0] + 1, before[1] + 1)
    want = tref.flash_attention_ref(q, k, v, causal=False).float()
    err = (out.float() - want).abs().max().item()
    assert err <= _noncausal_bound(dtype, atol, want), err


# Faults planted in what the kernel reads, each of which the bound above
# must reject: K/V of the other superblock of a stacked cross cache, the
# last 64-key tile dropped (the ragged one at S=1500), the 1/sqrt(hd)
# scale dropped.
PLANTED = ("other_superblock", "last_key_tile", "no_scale")


@pytest.mark.cuda
@pytest.mark.parametrize("fault", PLANTED)
@pytest.mark.parametrize("name", ["llama_cross_decode", "llama_cross_chunk",
                                  "whisper_encoder"])
@pytest.mark.parametrize("dtype,atol", [("float32", 2e-5),
                                        ("bfloat16", 3e-2)])
def test_flash_noncausal_bound_rejects_planted_faults(cuda_device, name,
                                                      fault, dtype, atol):
    B, T, S, H, Hkv, hd = FLASH_CROSS_CASES[name]
    rng = np.random.default_rng(len(name))
    q, kv = (t.to(getattr(torch, dtype)) for t in _torch(
        rng.normal(size=(B, T, H, hd)).astype(np.float32),
        rng.normal(size=(2, 2, B, S, Hkv, hd)).astype(np.float32),
        device=cuda_device))
    k, v = kv[0][1], kv[1][1]
    want = tref.flash_attention_ref(q, k, v, causal=False).float()
    bound = _noncausal_bound(dtype, atol, want)
    ok = fa_mod.flash_attention(q, k, v, causal=False)
    assert (ok.float() - want).abs().max().item() <= bound
    cut = S - (S % 64 or 64)
    bad = {"other_superblock": lambda: fa_mod.flash_attention(
               q, kv[0][0], kv[1][0], causal=False),
           "last_key_tile": lambda: fa_mod.flash_attention(
               q, k[:, :cut], v[:, :cut], causal=False),
           "no_scale": lambda: fa_mod.flash_attention(
               q * hd ** 0.5, k, v, causal=False)}[fault]()
    assert (bad.float() - want).abs().max().item() > bound


@pytest.mark.cuda
def test_flash_noncausal_stacked_cross_cache_on_card(cuda_device):
    """A superblock's slice ``cross[s]`` of a stacked [nsb, B, S, Hkv, hd]
    bf16 cross cache takes the tensor-core route in place, with the same
    result as a contiguous copy."""
    rng = np.random.default_rng(13)
    cache = rng.normal(size=(2, 2, 3, 200, 2, 64)).astype(np.float32)
    q = rng.normal(size=(3, 5, 8, 64)).astype(np.float32)
    tc, tq = _torch(cache, q, device=cuda_device)
    tc, tq = tc.to(torch.bfloat16), tq.to(torch.bfloat16)
    k, v = tc[0][1], tc[1][1]
    assert fa_mod.tensor_core_route(tq, k, v)
    before = fa_mod.simt_launches
    out = fa_mod.flash_attention(tq, k, v, causal=False)
    assert fa_mod.simt_launches == before
    again = fa_mod.flash_attention(tq, k.contiguous(), v.contiguous(),
                                   causal=False)
    assert torch.equal(out, again)
    want = tref.flash_attention_ref(tq, k, v, causal=False).float()
    err = (out.float() - want).abs().max().item()
    assert err <= _noncausal_bound("bfloat16", 3e-2, want), err


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


# The backward at zamba2-2.7b's shared attention (head_dim 80) and at
# whisper-tiny's non-causal reads as they train: (B, T, S, H, Hkv, hd,
# kwargs, dropped tile (query rows, keys), every key of it visible to
# every row of it).
BWD_TRAIN_CASES = {
    "zamba_g1": (4, 1024, 1024, 32, 32, 80, {},
                 (slice(960, 1024), slice(448, 512))),
    "zamba_g4_ragged_window_softcap": (
        2, 96, 96, 32, 8, 80, dict(window=40, softcap=30.0),
        (slice(64, 96), slice(56, 65))),
    "whisper_cross": (4, 448, 1500, 6, 6, 64, dict(causal=False),
                      (slice(384, 448), slice(704, 768))),
}
# Non-causal gradients are sums over 448-1500 rows or keys of
# probabilities near 1/1500 (about 0.01-0.1), so bf16 holds them to 3e-2
# x max |plain| (as the non-causal forward), not to BF16_GRAD_TOL's
# absolute floor, which a missing tile would pass.
F32_GRAD_TOL = dict(atol=2e-5, rtol=2e-5)


def _grad_bound(dtype, kw, want):
    """(atol, rtol) of one gradient of a BWD_TRAIN_CASES case."""
    if dtype == "float32":
        return F32_GRAD_TOL["atol"], F32_GRAD_TOL["rtol"]
    if not kw.get("causal", True):
        return 3e-2 * want.float().abs().max().item(), 0.0
    return BF16_GRAD_TOL


def _within(got, want, atol, rtol) -> bool:
    return bool(((got.float() - want.float()).abs()
                 <= atol + rtol * want.float().abs()).all())


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(BWD_TRAIN_CASES))
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_training_cases_on_card(cuda_device, name, dtype):
    """The kernel against the plain backward on the plain forward's
    residuals (bf16 on the tensor cores, zamba's g = 1 and g = 4 alike;
    f32 on the CUDA cores within 2e-5);
    each bound must reject the kernel's gradients with the case's tile
    left out."""
    B, T, S, H, Hkv, hd, kw, (rows, keys) = BWD_TRAIN_CASES[name]
    dt = getattr(torch, dtype)
    q, k, v, dout = _bwd_inputs(name, B, T, S, H, Hkv, hd, dt, cuda_device)
    out, lse = tref.flash_attention_fwd_ref(q, k, v, **kw)
    before = (fa_mod.bwd_launches, fa_mod.simt_launches)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert fa_mod.bwd_launches == before[0] + 1
    assert fa_mod.simt_launches == before[1] + (dtype == "float32")
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse, dout, **kw)
    lost = tref.flash_attention_bwd_ref(
        q[:, rows], k[:, keys], v[:, keys], out[:, rows], lse[:, :, rows],
        dout[:, rows], causal=False, softcap=kw.get("softcap", 0.0))
    for a, b, part, where in zip(got, want, lost, (rows, keys, keys)):
        assert a.dtype == b.dtype and a.shape == b.shape
        atol, rtol = _grad_bound(dtype, kw, b)
        assert _within(a, b, atol, rtol), (
            f"max err {(a.float() - b.float()).abs().max().item()}")
        bad = a.float().clone()
        bad[:, where] -= part.float()
        assert not _within(bad, b, atol, rtol)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,H,Hkv", [(64, 9, 3), (80, 32, 32), (128, 8, 2)])
@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_flash_bwd_is_deterministic_on_card(cuda_device, dtype, hd, H, Hkv):
    """Two passes, no atomics, the g query heads of a kv head summed in
    one fixed order: repeated calls are bit-identical (smollm's 9/3 heads
    of 64, zamba2's 32/32 of 80, g = 4 at 128)."""
    q, k, v, dout = _bwd_inputs("repeat", 2, 256, 256, H, Hkv, hd,
                                getattr(torch, dtype), cuda_device)
    out, lse = fa_mod.flash_attention_fwd(q, k, v, window=100)
    first = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout, window=100)
    for _ in range(3):
        again = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout,
                                           window=100)
        for a, b in zip(first, again):
            assert torch.equal(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("hd,H,Hkv", [(64, 9, 3), (80, 32, 32)])
def test_flash_bwd_batch_rows_match_alone_on_card(cuda_device, hd, H, Hkv):
    """The order of every f32 sum depends on the shape of one batch row
    and g, not on the batch: a row's bf16 gradients from a batch of 4 are
    bit-identical to the same row's computed alone (a data-parallel
    rank's local batch against the full one)."""
    q, k, v, dout = _bwd_inputs("rows", 4, 1024, 1024, H, Hkv, hd,
                                torch.bfloat16, cuda_device)
    out, lse = fa_mod.flash_attention_fwd(q, k, v)
    whole = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout)
    for b in (0, 3):
        one = [x[b:b + 1].contiguous() for x in (q, k, v, out)]
        alone = fa_mod.flash_attention_bwd(
            *one, lse[b:b + 1].contiguous(), dout[b:b + 1].contiguous())
        for a, w in zip(alone, whole):
            assert torch.equal(a[0], w[b])


@pytest.mark.cuda
def test_flash_bwd_allocates_no_per_head_partial(cuda_device):
    """At g = 3 the tensor-core backward sums the query heads of a kv head
    in registers: one call allocates dq, dk, dv and the rows' lse and D
    (2 x 64-row tiles of f32 per head), nowhere near the [2, B, S, H, hd]
    f32 partial (18.9 MB at B=4, S=1024, 9 heads of 64) of the design
    before."""
    B, T, H, Hkv, hd = 4, 1024, 9, 3, 64
    q, k, v, dout = _bwd_inputs("partial", B, T, T, H, Hkv, hd,
                                torch.bfloat16, cuda_device)
    out, lse = fa_mod.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    base = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    grads = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    grown = torch.cuda.max_memory_allocated() - base
    outputs = sum(t.numel() * t.element_size() for t in grads)
    stats = B * H * -(-T // 64) * 2 * 64 * 4
    partial = 2 * B * T * H * hd * 4
    assert grown <= outputs + stats + 2 * 512 * 4, (grown, outputs, stats)
    assert grown < partial


@pytest.mark.cuda
def test_flash_bwd_broadcast_dout_on_card(cuda_device):
    """A broadcast cotangent (an ``expand``ed tensor, zero strides over
    heads and tokens), which a TMA tensor map cannot describe, is copied
    by the wrapper and gives the plain version's gradients."""
    B, T, H, Hkv, hd = 2, 96, 6, 2, 64
    q, k, v, _ = _bwd_inputs("broadcast", B, T, T, H, Hkv, hd,
                             torch.bfloat16, cuda_device)
    row = torch.randn((B, 1, 1, hd), device=cuda_device).to(torch.bfloat16)
    dout = row.expand(B, T, H, hd)
    assert dout.stride(1) == dout.stride(2) == 0
    out, lse = tref.flash_attention_fwd_ref(q, k, v)
    got = fa_mod.flash_attention_bwd(q, k, v, out, lse, dout)
    torch.cuda.synchronize()
    want = tref.flash_attention_bwd_ref(q, k, v, out, lse,
                                        dout.contiguous())
    for a, b in zip(got, want):
        _bf16_grad_close(a, b)


@pytest.mark.cuda
def test_flash_route_on_card(cuda_device):
    """bf16 at head_dim 64 takes the split route for a one-token read and
    the ``wgmma`` route for a prefill; an unaligned row stride or float32
    takes the CUDA-core instance, which alone counts in
    ``simt_launches`` (the split route in ``split_launches``), and all
    agree with the plain version."""
    q, k, v = (t.to(torch.bfloat16) for t in _torch(
        *_flash_inputs(5, 1, 64, 64, 4, 2, 64), device=cuda_device))
    assert fa_mod.tensor_core_route(q, k, v)
    assert not fa_mod.tensor_core_route(q.float(), k.float(), v.float())
    wide = torch.zeros((1, 64, 2, 68), dtype=torch.bfloat16,
                       device=cuda_device)
    wide[..., :64] = k
    k_odd = wide[..., :64]                      # row stride 68: not 16-byte
    assert not fa_mod.tensor_core_route(q, k_odd, v)
    counts = lambda: (fa_mod.simt_launches,  # noqa: E731
                      fa_mod.split_launches)
    before = counts()
    fast = fa_mod.flash_attention(q, k, v)
    one = fa_mod.flash_attention(q[:, -1:], k, v)
    assert counts() == (before[0], before[1] + 1)
    out = fa_mod.flash_attention(q, k_odd, v)
    assert counts() == (before[0] + 1, before[1] + 1)
    want = tref.flash_attention_ref(q, k, v)
    for got in (fast, out):
        torch.testing.assert_close(got.float(), want.float(), atol=3e-2,
                                   rtol=3e-2)
    torch.testing.assert_close(one.float(), want[:, -1:].float(), atol=3e-2,
                               rtol=3e-2)


# The forward's two bf16 routes at the served and trained shapes, K/V
# read in place from [B, S + 64] rings: (B, T, S, H, Hkv, hd, kwargs,
# route).  The wave's decode (9/3 heads over a ring of 513), llama-
# vision's and whisper's cross decodes (split); llama-vision's cross
# chunk, whisper's encoder, the training shapes at head_dim 64 and 80,
# the B=1 prefills of the dense path and zamba2's, a gemma-style hd 128
# prefill under a 1024-token window (wgmma).
NC = dict(causal=False)
FWD_ROUTE_CASES = {
    "wave_decode": (4, 1, 513, 9, 3, 64, {}, "split"),
    "llama_cross_decode": (4, 1, 1600, 32, 8, 128, NC, "split"),
    "whisper_cross_decode": (4, 1, 1500, 6, 6, 64, NC, "split"),
    "llama_cross_chunk": (4, 64, 1600, 32, 8, 128, NC, "wgmma"),
    "whisper_encoder": (4, 1500, 1500, 6, 6, 64, NC, "wgmma"),
    "training_hd64": (4, 1024, 1024, 9, 3, 64, {}, "wgmma"),
    "training_hd80": (4, 1024, 1024, 32, 32, 80, {}, "wgmma"),
    "prefill_64": (1, 64, 64, 9, 3, 64, {}, "wgmma"),
    "prefill_256": (1, 256, 256, 9, 3, 64, {}, "wgmma"),
    "prefill_512": (1, 512, 512, 9, 3, 64, {}, "wgmma"),
    "prefill_hd80_256": (1, 256, 256, 32, 32, 80, {}, "wgmma"),
    "gemma_window_hd128": (1, 1500, 1500, 32, 16, 128, dict(window=1024),
                           "wgmma"),
}


def _ring_operands(name, B, T, S, H, Hkv, hd, device):
    """bf16 q and K/V slices ``ring[:, :S]`` of [B, S + 64] rings."""
    g = torch.Generator(device=device).manual_seed(len(name))
    q = torch.randn((B, T, H, hd), generator=g, device=device)
    rk, rv = (torch.randn((B, S + 64, Hkv, hd), generator=g, device=device)
              for _ in range(2))
    return (q.to(torch.bfloat16), rk.to(torch.bfloat16)[:, :S],
            rv.to(torch.bfloat16)[:, :S])


def _fwd_bound(T, kw, want):
    """bf16: 3e-2 where an output is a mean over many keys (a one-token
    read, a non-causal read), of the output's own scale (max |plain|);
    3e-2 absolute for causal prefills, whose early rows read few keys."""
    mean = T == 1 or not kw.get("causal", True)
    return 3e-2 * (want.abs().max().item() if mean else 1.0)


def _tile_dropped(q, k, v, kw):
    """The kernel's output with a key tile left out: the last one (the
    ragged one where S is no multiple of 64) for a one-token or
    non-causal read; each 64-query tile's diagonal one for a causal T=S
    prefill (the first tile then sees no key)."""
    T, S = q.shape[1], k.shape[1]
    if T == 1 or not kw.get("causal", True):
        cut = S - (S % 64 or 64)
        return fa_mod.flash_attention(q, k[:, :cut], v[:, :cut], **kw)
    w = kw.get("window", 0)
    out = [torch.zeros_like(q[:, :64])]
    for t0 in range(64, T, 64):
        lo = max(0, t0 + 64 - w) if w else 0   # the tile's last row's edge
        out.append(fa_mod.flash_attention(
            q[:, t0:t0 + 64], k[:, lo:t0], v[:, lo:t0], causal=False,
            softcap=kw.get("softcap", 0.0)))
    return torch.cat(out, 1)


@pytest.mark.cuda
@pytest.mark.parametrize("name", sorted(FWD_ROUTE_CASES))
def test_flash_forward_routes_on_card(cuda_device, name):
    """Each shape takes its route (one launch; ``split_launches`` counts
    the split route, ``simt_launches`` none), matches the plain version
    (out within :func:`_fwd_bound`, lse 1e-4) and, on the split route,
    the plain split form at the wrapper's own plan; two calls are
    bit-identical, the first and last batch rows alone bit-identical to
    the same rows in the batch; the bound rejects the output with a key
    tile dropped."""
    B, T, S, H, Hkv, hd, kw, route = FWD_ROUTE_CASES[name]
    q, k, v = _ring_operands(name, B, T, S, H, Hkv, hd, cuda_device)
    assert B == 1 or not k.is_contiguous()
    way, plan = fa_mod.forward_route(T, S, H, Hkv, hd, q.dtype,
                                     fa_mod.tensor_core_route(q, k, v),
                                     kw.get("window", 0))
    assert way == route
    before = (fa_mod.launches, fa_mod.split_launches, fa_mod.simt_launches)
    out, lse = fa_mod.flash_attention_fwd(q, k, v, **kw)
    torch.cuda.synchronize()
    assert (fa_mod.launches - before[0], fa_mod.split_launches - before[1],
            fa_mod.simt_launches - before[2]) == (1, int(way == "split"), 0)
    want, want_lse = tref.flash_attention_fwd_ref(q, k, v, **kw)
    want = want.float()
    bound = _fwd_bound(T, kw, want)
    assert (out.float() - want).abs().max().item() <= bound
    torch.testing.assert_close(lse, want_lse, atol=1e-4, rtol=1e-4)
    if way == "split":
        split_out, split_lse = tref.flash_attention_split_ref(
            q, k, v, plan[1], **kw)
        assert (out.float() - split_out.float()).abs().max().item() <= bound
        torch.testing.assert_close(lse, split_lse, atol=1e-4, rtol=1e-4)
    assert torch.equal(out, fa_mod.flash_attention(q, k, v, **kw))
    for b in {0, B - 1} if B > 1 else ():
        alone = fa_mod.flash_attention(q[b:b + 1], k[b:b + 1], v[b:b + 1],
                                       **kw)
        assert torch.equal(alone[0], out[b])
    bad = _tile_dropped(q, k, v, kw)
    assert (bad.float() - want).abs().max().item() > bound


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S,H,Hkv,hd,route", [
    (2, 4, 2, 4, 2, 64, "split"),        # 8 rows; queries 0, 1 see no key
    (2, 100, 40, 9, 3, 80, "wgmma"),     # queries 0 .. 59 see no key
])
def test_flash_rows_without_keys_on_routes(cuda_device, B, T, S, H, Hkv, hd,
                                           route):
    """Causal with S < T on each bf16 route: the first T - S queries see
    no key and get exact zeros and lse -1e30 (the split route's merge and
    the wgmma route's l == 0 step); the rest match the plain version."""
    q, k, v = _ring_operands("nokey", B, T, S, H, Hkv, hd, cuda_device)
    way, _ = fa_mod.forward_route(T, S, H, Hkv, hd, q.dtype, True)
    assert way == route
    out, lse = fa_mod.flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert torch.count_nonzero(out[:, :T - S]) == 0
    assert (lse[:, :, :T - S] == -1e30).all()
    want, want_lse = tref.flash_attention_fwd_ref(q[:, T - S:], k, v)
    torch.testing.assert_close(out[:, T - S:].float(), want.float(),
                               atol=3e-2, rtol=3e-2)
    torch.testing.assert_close(lse[:, :, T - S:], want_lse, atol=1e-4,
                               rtol=1e-4)


@pytest.mark.cuda
def test_flash_split_counters_are_per_stream(cuda_device):
    """The split route's arrival counters belong to a (device, stream):
    the same call on two streams, one after the other, uses two counter
    arrays, each left at 0, and gives the same bits."""
    q, k, v = _ring_operands("streams", 4, 1, 1600, 32, 8, 128, cuda_device)
    outs = []
    for stream in (torch.cuda.Stream(), torch.cuda.Stream()):
        with torch.cuda.stream(stream):
            outs.append(fa_mod.flash_attention(q, k, v, causal=False))
        stream.synchronize()
    assert torch.equal(outs[0], outs[1])
    mine = [c for (dev, _), c in fa_mod._COUNTERS.items()
            if dev == q.device.index]
    assert len(mine) >= 2 and all(int(c.abs().sum()) == 0 for c in mine)


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


# ---------------------------------------------------------------------------
# head_dim 80 (zamba2-2.7b's shared attention, 32/32 heads): the flash
# forward's and the paged kernel's tensor-core instances.
# ---------------------------------------------------------------------------
def _hd80_ring(B, device, seed):
    g = torch.Generator(device=device).manual_seed(seed)
    return tuple(torch.randn((B, 1024, 32, 80), generator=g, device=device)
                 for _ in range(2))


@pytest.mark.cuda
@pytest.mark.parametrize("B,T,S", [(1, 64, 64), (1, 257, 257),
                                   (4, 1, 513)])
def test_flash_hd80_on_card(cuda_device, B, T, S):
    """bf16 at hd 80 takes a tensor-core route (the split route at T=1,
    ``flash_fwd_wgmma<80>`` otherwise; no CUDA-core launch),
    bit-identical twice, within 3e-2 (3e-2 x max |plain| for the T=1
    read, a mean over 513 keys) of the plain version over a ring slice;
    the bound rejects the output with the last key tile dropped.  f32
    takes the CUDA-core instance, within 2e-5."""
    rk, rv = _hd80_ring(B, cuda_device, seed=T)
    g = torch.Generator(device=cuda_device).manual_seed(S)
    q = torch.randn((B, T, 32, 80), generator=g, device=cuda_device)
    for dtype in (torch.bfloat16, torch.float32):
        qd, k, v = q.to(dtype), rk.to(dtype)[:, :S], rv.to(dtype)[:, :S]
        assert fa_mod.tensor_core_route(qd, k, v) == (dtype == torch.bfloat16)
        before = fa_mod.simt_launches
        out = fa_mod.flash_attention(qd, k, v)
        want = tref.flash_attention_ref(qd, k, v).float()
        if dtype == torch.float32:
            assert fa_mod.simt_launches == before + 1
            torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
            continue
        assert fa_mod.simt_launches == before
        assert torch.equal(out, fa_mod.flash_attention(qd, k, v))
        bound = 3e-2 * (want.abs().max().item() if T == 1 else 1.0)
        assert (out.float() - want).abs().max().item() <= bound
        cut = (S - (S % 64 or 64)) if T == 1 else 0
        if T == 1:
            bad = fa_mod.flash_attention(qd, k[:, :cut], v[:, :cut])
        else:   # every query tile without its diagonal key tile
            bad = torch.cat([torch.zeros_like(qd[:, :64])] + [
                fa_mod.flash_attention(qd[:, t0:t0 + 64], k[:, :t0],
                                       v[:, :t0], causal=False)
                for t0 in range(64, T, 64)], 1)
        assert (bad.float() - want).abs().max().item() > bound


@pytest.mark.cuda
@pytest.mark.parametrize("T,lens", [(1, [0, 1, 63, 64]),
                                    (1, [700, 64, 1000, 129]),
                                    (64, [64, 300, 700, 1024])])
def test_paged_hd80_on_card(cuda_device, T, lens):
    """The paged kernel at hd 80 over a [4, 1024] ring viewed as 64-token
    identity pages: bf16 on the split route (T=1) or ``paged_chunk<80>``
    (T=64), no CUDA-core launch, bit-identical twice, within 3e-2 of the
    plain version (and of the plain split-KV version at T=1), zeros for a
    lens=0 row; ``kv_lens`` one tile short of each row's keys (the last
    key tile dropped) breaks the bound.  f32 within 2e-5."""
    B, ps, P = 4, 64, 16
    rk, rv = _hd80_ring(B, cuda_device, seed=20 + T)
    block = torch.arange(B * P, dtype=torch.int32,
                         device=cuda_device).view(B, P)
    ln = torch.tensor(lens, dtype=torch.int32, device=cuda_device)
    short = torch.clamp((ln - 1) // 64 * 64, min=0).to(torch.int32)
    g = torch.Generator(device=cuda_device).manual_seed(30 + T)
    q = torch.randn((B, T, 32, 80), generator=g, device=cuda_device)
    for dtype in (torch.bfloat16, torch.float32):
        qd = q.to(dtype)
        kp = rk.to(dtype).view(B * P, ps, 32, 80)
        vp = rv.to(dtype).view(B * P, ps, 32, 80)
        way = pa_mod.route(qd, kp, vp)
        before = pa_mod.simt_launches
        out = pa_mod.paged_attention(qd, kp, vp, block, ln)
        want = tref.paged_attention_ref(qd, kp, vp, block, ln).float()
        assert torch.count_nonzero(out[ln <= 0]) == 0
        if dtype == torch.float32:
            assert way == "simt"
            torch.testing.assert_close(out, want, atol=2e-5, rtol=0)
            continue
        assert way == ("split" if T == 1 else "wgmma")
        assert pa_mod.simt_launches == before
        assert torch.equal(out, pa_mod.paged_attention(qd, kp, vp, block,
                                                       ln))
        assert (out.float() - want).abs().max().item() <= 3e-2
        if T == 1:
            keys = pa_mod.plan(qd, kp, vp, block)[1][0]
            want2 = tref.paged_attention_split_ref(qd, kp, vp, block, ln,
                                                   keys).float()
            assert (out.float() - want2).abs().max().item() <= 3e-2
        bad = pa_mod.paged_attention(qd, kp, vp, block, ln, kv_lens=short)
        assert (bad.float() - want).abs().max().item() > 3e-2


@pytest.mark.cuda
def test_hd80_is_a_forward_instance_only(cuda_device):
    """hd 80 has a tensor-core instance in the forward and, since the
    recurrent families train, in the backward too (the name is the
    test's from when it had none): neither counts a CUDA-core launch,
    and the gradients match the plain version's."""
    assert 80 in fa_mod.TC_HEAD_DIMS
    g = torch.Generator(device=cuda_device).manual_seed(7)
    q, k, v = (torch.randn((1, 64, 2, 80), generator=g,
                           device=cuda_device).to(torch.bfloat16)
               for _ in range(3))
    leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
    before = fa_mod.simt_launches
    out = fa_mod.flash_attention_trainable(*leaves)
    assert fa_mod.simt_launches == before            # forward: tensor cores
    grads = torch.autograd.grad(out.float().sum(), leaves)
    assert fa_mod.simt_launches == before            # backward: tensor cores
    ref_leaves = [t.clone().float().requires_grad_(True) for t in (q, k, v)]
    ref_grads = torch.autograd.grad(
        tref.flash_attention_ref(*ref_leaves).sum(), ref_leaves)
    for a, b in zip(grads, ref_grads):
        torch.testing.assert_close(a.float(), b, atol=2e-2, rtol=1e-2)


@pytest.mark.cuda
def test_shared_memory_fits_the_card(cuda_device):
    """The card's counterpart of ``test_kernels_decode.py::
    test_production_tile_fits_vmem``: in each kernel library, every built
    instance's static shared memory plus the dynamic bytes its launches
    ask for at most fits the card's opt-in limit a block, and the dynamic
    bytes are those the wrapper computes from its tile constants."""
    from repro_torch.kernels import ops
    optin = torch.cuda.get_device_properties(
        cuda_device).shared_memory_per_block_optin
    for lib, (rows, want) in ops.shared_memory().items():
        assert {name: dyn for name, _, dyn in rows} == want, lib
        assert all(st + dyn <= optin for _, st, dyn in rows), (lib, rows)
