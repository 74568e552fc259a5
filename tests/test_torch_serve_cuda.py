"""The page pool's preemption and snapshot halves on the card, read back
through the Hopper paged-attention kernel (``pytest -m cuda``): a
sequence swapped out to the host and swapped back in onto DIFFERENT
physical pages gives the kernel bit-identical output for its row — the
T=1 split-KV decode and the T=64 tensor-core chunk — and leaves the sink
page untouched; a pool imaged by ``snapshot_state`` and rebuilt by
``restore_state`` in a fresh pool does the same.  And olmoe-1b-7b's
SMOKE config served under slot_paged, and llama-3.2-vision-11b's and
whisper-tiny's (image- or frame-conditioned prefill + decode, and
``slot_chunked``), give the CPU's greedy tokens, as do zamba2-2.7b's
and rwkv6-1.6b's under ``slot_fused``; zamba's shared attention at
head_dim 80 in bf16 is served with no CUDA-core launch.
Imports no JAX; skipped without a card."""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.kernels import paged_attention as pa_mod  # noqa: E402
from repro_torch.serve.kv_cache import OK, PagedKVPool  # noqa: E402

# The slot_paged main path's page geometry (smollm-135m: 3 kv heads of
# 64, 16-token pages, a 64-page table), cut to 4 layers.
PS, L, HKV, HD, H, P = 16, 4, 3, 64, 9, 64


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _pool(device, dtype, n_pages=96, seed=0):
    """A pool with every page (and the sink) full of seeded values and
    one sequence of 300 written tokens (19 pages) admitted."""
    pool = PagedKVPool(n_pages, PS, L, HKV, HD, dtype=dtype, device=device)
    g = torch.Generator(device=device).manual_seed(seed)
    pool.store_k.copy_(torch.randn(pool.store_k.shape, generator=g,
                                   device=device).to(dtype))
    pool.store_v.copy_(torch.randn(pool.store_v.shape, generator=g,
                                   device=device).to(dtype))
    assert pool.try_admit(1, 300) == OK
    pool.note_tokens(1, 300)
    return pool


def _attend(pool, seq_id, T, li=2, seed=1):
    """The kernel's output for ``seq_id``'s row (padded to B=8 with
    zero-length rows), layer ``li``, T queries ending at token 300."""
    dev = pool.store_k.device
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((8, T, H, HD), generator=g, device=dev).to(pool.k.dtype)
    block = torch.zeros((8, P), dtype=torch.int32, device=dev)
    pages = pool.table(seq_id).pages
    assert all(p >= 0 for p in pages)
    block[0, :len(pages)] = torch.tensor(pages, dtype=torch.int32)
    lens = torch.zeros((8,), dtype=torch.int32, device=dev)
    lens[0] = 300
    before = pa_mod.launches
    out = pa_mod.paged_attention(q, pool.store_k[:, :, li],
                                 pool.store_v[:, :, li], block, lens)
    torch.cuda.synchronize()
    assert pa_mod.launches == before + 1
    return out[0].clone()


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("T", [1, 64])
def test_swap_out_in_to_new_pages_is_bit_identical_on_card(cuda_device,
                                                           dtype, T):
    pool = _pool(cuda_device, dtype)
    sink = (pool.store_k[-1].clone(), pool.store_v[-1].clone())
    old_pages = list(pool.table(1).pages)
    want = _attend(pool, 1, T)
    img = pool.swap_out_preempt(1, 300)
    assert img.rows == list(range(19)) and img.k.shape[0] == 19
    assert pool.swap_out_bytes == 19 * pool.page_nbytes
    # The freed pages are scribbled over (their old bytes are gone) and
    # another sequence claims pages, so the swap-in lands elsewhere.
    freed = torch.tensor(old_pages, device=cuda_device)
    pool.k[freed] = 0
    pool.v[freed] = 0
    assert pool.try_admit(2, 100) == OK
    assert pool.swap_in_preempt(1, img) == OK
    new_pages = pool.table(1).pages
    assert not set(new_pages) & set(old_pages)
    got = _attend(pool, 1, T)
    assert torch.equal(got, want)
    assert torch.equal(pool.store_k[-1], sink[0])
    assert torch.equal(pool.store_v[-1], sink[1])
    assert pool.kv_copy_bytes == pool.swap_in_bytes + pool.swap_out_bytes


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_snapshot_restore_is_bit_identical_on_card(cuda_device, dtype):
    pool = _pool(cuda_device, dtype)
    want = [_attend(pool, 1, T) for T in (1, 64)]
    state = pool.snapshot_state()
    if dtype == torch.bfloat16:
        assert state["k"].dtype == np.int16     # bf16 travels as its bits
    other = _pool(cuda_device, dtype, seed=7)   # other bytes everywhere
    sink = (other.store_k[-1].clone(), other.store_v[-1].clone())
    other.restore_state(state)
    assert other.table(1).pages == pool.table(1).pages
    got = [_attend(other, 1, T) for T in (1, 64)]
    assert all(torch.equal(a, b) for a, b in zip(got, want))
    assert torch.equal(other.store_k[-1], sink[0])
    assert torch.equal(other.store_v[-1], sink[1])


def _serve_tokens(model, params, device, scheduler="slot_paged"):
    """``scheduler`` over ``WORK`` with a small pool; token lists in
    submission order."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(model, params, max_batch=2, max_len=48, n_clients=1,
                      pool_pages=64, page_size=4, chunk_tokens=4, k_max=4,
                      scheduler=scheduler, device=device)
    rng = np.random.default_rng(5)
    work = [(rng.integers(0, model.cfg.vocab_size, n), m)
            for n, m in ((5, 3), (9, 12), (3, 8), (14, 2), (6, 10), (4, 5))]
    rids = [eng.submit(0, p, max_tokens=m).req_id for p, m in work]
    while eng.stats["served"] + eng.stats["rejected"] < len(work):
        eng.step()
    assert eng.fault_report()["tick_failures"] == 0
    got = {}
    for _ in work:
        r = eng.get_response(0, timeout_s=30)
        assert r, "response timed out"
        got[r.req_id] = list(map(int, r.tokens_out))
    return [got[r] for r in rids]


@pytest.mark.cuda
def test_olmoe_smoke_slot_paged_tokens_equal_the_cpu_on_card(cuda_device):
    """olmoe-1b-7b's SMOKE config (8 experts, top-4) at float32, weights
    x3 so streams vary: the card's greedy tokens under slot_paged, where
    expert capacity binds behind idle rows, equal the CPU's; every paged
    pass in float32 takes the CUDA-core route (the tensor-core routes
    are bf16: no TF32)."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config("olmoe-1b-7b"),
                              dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))

    def scaled(tree, dev):
        if isinstance(tree, dict):
            return {k: scaled(v, dev) for k, v in tree.items()}
        return (tree * 3 if tree.dim() >= 2 else tree).to(dev)

    want = _serve_tokens(cpu, scaled(params, "cpu"), "cpu")
    before = (pa_mod.launches, pa_mod.simt_launches)
    got = _serve_tokens(build_model(cfg, device=cuda_device),
                        scaled(params, cuda_device), cuda_device)
    assert got == want
    assert pa_mod.launches > before[0]
    assert (pa_mod.simt_launches - before[1]
            == pa_mod.launches - before[0])


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama-3.2-vision-11b", "whisper-tiny"])
def test_cross_smoke_tokens_equal_the_cpu_on_card(cuda_device, arch):
    """The cross-attention families' SMOKE configs at float32, weights
    x3: ``prefill`` with an image or frame source + 4 decode steps, and a
    ``slot_chunked`` served run, give the CPU's greedy tokens; the cross
    reads (and whisper's encoder) go through flash's non-causal route."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    n_src = (cfg.encoder.num_frames if cfg.encoder is not None
             else cfg.num_image_tokens)
    g = torch.Generator().manual_seed(1)
    tokens = torch.randint(0, cfg.vocab_size, (2, 13), generator=g)
    src = torch.randn((2, n_src, cfg.d_model), generator=g)

    def scaled(tree, dev):
        if isinstance(tree, dict):
            return {k: scaled(v, dev) for k, v in tree.items()}
        return (tree * 3 if tree.dim() >= 2 else tree).to(dev)

    def decode(model, dev):
        p = scaled(params, dev)
        with torch.no_grad():
            tok, caches = model.prefill(p, tokens.to(dev), 32,
                                        extras=src.to(dev))
            out = [tok.tolist()]
            for i in range(4):
                pos = torch.full((2,), 13 + i, dtype=torch.int32,
                                 device=dev)
                tok, caches = model.decode_step(p, caches, tok[:, None],
                                                pos)
                out.append(tok.tolist())
        return out

    card = build_model(cfg, device=cuda_device)
    before = fa_mod.noncausal_launches
    assert decode(card, cuda_device) == decode(cpu, "cpu")
    n_cross = (cfg.num_layers if cfg.encoder is not None
               else cfg.num_layers // cfg.cross_attn_every)
    n_enc = cfg.encoder.num_layers if cfg.encoder is not None else 0
    assert fa_mod.noncausal_launches - before == n_enc + 5 * n_cross
    want = _serve_tokens(cpu, scaled(params, "cpu"), "cpu", "slot_chunked")
    got = _serve_tokens(card, scaled(params, cuda_device), cuda_device,
                        "slot_chunked")
    assert got == want


def _scaled3(tree, dev):
    if isinstance(tree, dict):
        return {k: _scaled3(v, dev) for k, v in tree.items()}
    return (tree * 3 if tree.dim() >= 2 else tree).to(dev)


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["zamba2-2.7b", "rwkv6-1.6b"])
def test_recurrent_smoke_slot_fused_tokens_equal_the_cpu_on_card(
        cuda_device, arch):
    """The recurrent families' SMOKE configs at float32, weights x3 so
    streams vary: the card's greedy tokens under slot_fused (the scan in
    every prefill and decode step; zamba's shared block on flash and the
    paged kernel) equal the CPU's."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu = build_model(cfg, device="cpu")
    params = cpu.init(torch.Generator().manual_seed(0))
    want = _serve_tokens(cpu, _scaled3(params, "cpu"), "cpu", "slot_fused")
    before = (fa_mod.launches, pa_mod.launches)
    got = _serve_tokens(build_model(cfg, device=cuda_device),
                        _scaled3(params, cuda_device), cuda_device,
                        "slot_fused")
    assert got == want
    attn = (fa_mod.launches - before[0], pa_mod.launches - before[1])
    assert (min(attn) > 0) == (arch == "zamba2-2.7b") and (
        max(attn) > 0) == (arch == "zamba2-2.7b")


@pytest.mark.cuda
def test_zamba_hd80_is_served_on_the_tensor_cores(cuda_device):
    """zamba's SMOKE stack widened to the full config's attention heads
    (32/32 of 80) in bf16: a slot_fused run launches flash (prefills) and
    the paged kernel (decode) on the card, none of either on a CUDA-core
    instance, and every token in range."""
    import dataclasses

    from repro_torch.configs import get_smoke_config
    from repro_torch.kernels import flash_attention as fa_mod
    from repro_torch.models.model import build_model
    cfg = dataclasses.replace(get_smoke_config("zamba2-2.7b"), d_model=64,
                              num_heads=32, num_kv_heads=32, head_dim=80,
                              dtype="bfloat16")
    model = build_model(cfg, device=cuda_device)
    params = model.init(torch.Generator(device=cuda_device).manual_seed(0))
    before = (fa_mod.launches, fa_mod.simt_launches, pa_mod.launches,
              pa_mod.simt_launches)
    toks = _serve_tokens(model, params, cuda_device, "slot_fused")
    after = (fa_mod.launches, fa_mod.simt_launches, pa_mod.launches,
             pa_mod.simt_launches)
    assert after[0] > before[0] and after[2] > before[2]
    assert after[1] == before[1] and after[3] == before[3]
    assert all(0 <= t < cfg.vocab_size for s in toks for t in s)
