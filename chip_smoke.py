#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card and the CUDA toolkit (``nvcc``).  Phases,
each of which fails the run hard:

1. device report: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, and the build of every kernel from ``src/repro_torch``;
2. each kernel against its plain PyTorch version on the card, at the
   reference test shapes and at the main path's shapes (a strided
   per-layer view of a [512, 16, 30, 3, 64] pool);
3. the main path at full width: ``smollm-135m`` (random weights from a
   seed) served by the ``slot_paged`` engine to 4 client sessions x 4
   requests, every stream complete and exactly-once, the kernel launched
   30 times per model forward;
4. CPU/CUDA parity: the SMOKE config at float32, same weights on both
   devices, identical greedy tokens;
5. kernel timing at the main path's shapes (CUDA events), beside its
   bound, the plain version and a labelled gather + SDPA yardstick.

Prints one JSON line of kernel results, then the device line
``{"ok": true, "device": {...}}`` last.  Exits non-zero, printing no
result, without a card or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import statistics
import subprocess
import sys
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM peaks (NVIDIA data sheet, dense): memory rate, bf16 / f32 math.
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bfloat16": 989e12, "float32": 67e12}
MAIN = dict(n_pages=512, ps=16, L=30, Hkv=3, hd=64, B=8, H=9, P=64,
            chunk=64)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def timed(fn, reps: int = 5, inner: int = 50) -> float:
    """Median ms per call over ``reps`` CUDA-event windows of ``inner``
    calls, after a warm-up."""
    import torch
    for _ in range(5):
        fn(0)
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for i in range(inner):
            fn(i)
        b.record()
        b.synchronize()
        samples.append(a.elapsed_time(b) / inner)
    return statistics.median(samples)


# ---------------------------------------------------------------------------
# Phase 1: device report and kernel build
# ---------------------------------------------------------------------------
def phase_build():
    import torch
    from repro_torch.kernels import paged_attention as pa
    builders = {"paged_attention": pa.build}
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(builders)) as ex:   # one nvcc per source
        libs = dict(zip(builders, ex.map(lambda f: f(), builders.values())))
    dt = time.monotonic() - t0
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"kernel build: {dt:.1f} s ({', '.join(libs)})")
    for name, lib in libs.items():
        log = Path(lib).with_suffix(".log")
        for line in log.read_text().splitlines():
            if "registers" in line or "spill" in line:
                print(f"  {name}: {line.strip()}")


# ---------------------------------------------------------------------------
# Phase 2: kernel vs plain version on the card
# ---------------------------------------------------------------------------
REF_CASES = [
    dict(seed=0, B=3, T=1, H=4, Hkv=2, hd=32, n_pages=32, ps=8, P=4,
         lens=[9, 1, 31]),
    dict(seed=1, B=2, T=8, H=4, Hkv=4, hd=16, n_pages=24, ps=8, P=3,
         lens=[8, 20]),
    dict(seed=2, B=2, T=1, H=8, Hkv=1, hd=16, n_pages=16, ps=4, P=4,
         lens=[5, 13]),
    dict(seed=2, B=2, T=1, H=6, Hkv=2, hd=16, n_pages=16, ps=4, P=4,
         lens=[5, 13]),
    dict(seed=2, B=2, T=1, H=9, Hkv=3, hd=16, n_pages=16, ps=4, P=4,
         lens=[5, 13]),
    dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8, P=4,
         lens=[7]),
    dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8, P=4,
         lens=[8]),
    dict(seed=3, B=1, T=1, H=2, Hkv=2, hd=16, n_pages=8, ps=8, P=4,
         lens=[9]),
    dict(seed=5, B=2, T=1, H=2, Hkv=2, hd=16, n_pages=16, ps=4, P=4,
         lens=[0, 11]),
]
TOLS = {"float32": 1e-4, "bfloat16": 3e-2}


def ref_case(torch, c):
    import numpy as np
    rng = np.random.default_rng(c["seed"])
    q = rng.normal(size=(c["B"], c["T"], c["H"], c["hd"]))
    kv = (c["n_pages"], c["ps"], c["Hkv"], c["hd"])
    k, v = rng.normal(size=kv), rng.normal(size=kv)
    block = rng.permutation(c["n_pages"])[:c["B"] * c["P"]].reshape(
        c["B"], c["P"])
    f = lambda a, dt: torch.tensor(a, dtype=dt, device="cuda")  # noqa: E731
    return (f(q, torch.float32), f(k, torch.float32), f(v, torch.float32),
            f(block, torch.int32), f(np.asarray(c["lens"]), torch.int32))


def main_path_inputs(torch, T: int, seed: int):
    """A bf16 pool of the main path's shape, a block table of disjoint
    scattered pages and lengths like the served traffic's (bucketed
    prompts of 64..512 tokens plus up to 32 generated)."""
    m = MAIN
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (m["n_pages"], m["ps"], m["L"], m["Hkv"], m["hd"])
    pk = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    pv = torch.randn(shape, generator=g, device="cuda").to(torch.bfloat16)
    block = torch.randperm(m["n_pages"], generator=g, device="cuda")[
        :m["B"] * m["P"]].reshape(m["B"], m["P"]).to(torch.int32)
    if T == 1:
        lens = torch.randint(65, 545, (m["B"],), generator=g, device="cuda")
    else:
        lens = (torch.randint(0, 8, (m["B"],), generator=g, device="cuda")
                * T + T)
    q = torch.randn((m["B"], T, m["H"], m["hd"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    return q, pk, pv, block, lens.to(torch.int32)


def phase_compare():
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    for c in REF_CASES:
        base = ref_case(torch, c)
        for dt_name, tol in TOLS.items():
            dt = getattr(torch, dt_name)
            q, k, v = (t.to(dt) for t in base[:3])
            out = pa.paged_attention(q, k, v, base[3], base[4])
            torch.cuda.synchronize()
            want = ref.paged_attention_ref(q, k, v, base[3], base[4])
            err = (out.float() - want.float()).abs().max().item()
            check(err <= tol, f"reference case {c} {dt_name}: err {err}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
            # Poison: every block entry at or past a row's extent points at
            # a page full of 1e4; the output must not move by a bit.
            ps, P = k.shape[1], base[3].shape[1]
            used = (base[4][:, None].long()
                    > torch.arange(P, device="cuda")[None, :] * ps)
            block2 = torch.where(used, base[3], k.shape[0]).to(torch.int32)
            poison = torch.full((1,) + tuple(k.shape[1:]), 1e4, dtype=dt,
                                device="cuda")
            out2 = pa.paged_attention(q, torch.cat([k, poison]),
                                      torch.cat([v, poison]), block2,
                                      base[4])
            torch.cuda.synchronize()
            check(torch.equal(out, out2), f"poison pages leaked: {c}")
    main_err = 0.0
    for T in (1, MAIN["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, seed=T)
        for li in (0, MAIN["L"] - 1):
            kview, vview = pk[:, :, li], pv[:, :, li]
            check(not kview.is_contiguous(), "layer view is contiguous")
            for dt_name, tol in TOLS.items():
                dt = getattr(torch, dt_name)
                args = (q.to(dt), kview.to(dt), vview.to(dt)) \
                    if dt_name == "float32" else (q, kview, vview)
                out = pa.paged_attention(*args, block, lens)
                torch.cuda.synchronize()
                want = ref.paged_attention_ref(*args, block, lens)
                err = (out.float() - want.float()).abs().max().item()
                check(err <= tol, f"main shape T={T} layer {li} "
                                  f"{dt_name}: err {err}")
                if dt_name == "bfloat16":
                    main_err = max(main_err, err)
    print(f"kernel vs plain: reference cases (and their poison-page "
          f"variants, bit-identical) max err f32 "
          f"{worst['float32']:.3g} (tol 1e-4), bf16 "
          f"{worst['bfloat16']:.3g} (tol 3e-2); main-path shapes bf16 "
          f"max err {main_err:.3g}")
    return main_err


# ---------------------------------------------------------------------------
# Phase 3: the main path at full width
# ---------------------------------------------------------------------------
def phase_serve():
    import numpy as np
    import torch
    from repro_torch.configs import get_config
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = get_config("smollm-135m")
    model = build_model(cfg)                          # cuda by default
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    forwards = [0]
    fwd = model.forward

    def counted_forward(*a, **kw):
        forwards[0] += 1
        return fwd(*a, **kw)

    model.forward = counted_forward
    n_clients, per_client, max_tokens = 4, 4, 32
    eng = ServeEngine(model, params, max_batch=8, max_len=1024,
                      n_clients=n_clients, pool_pages=512, page_size=16,
                      chunk_tokens=64, k_max=8)
    kv_mb = 2 * eng.pool.store_k.numel() * eng.pool.store_k.element_size()
    rng = np.random.default_rng(1234)
    system = rng.integers(0, cfg.vocab_size, 240)
    prompts = {}
    for c in range(n_clients):
        for r in range(per_client):
            if r % 2 == 0:
                prompts[c, r] = rng.integers(0, cfg.vocab_size,
                                             int(rng.integers(40, 481)))
            else:
                prompts[c, r] = np.concatenate(
                    [system, rng.integers(0, cfg.vocab_size, 16)])
    results, errors = {}, []

    def client(c: int) -> None:
        try:
            with eng.connect(c) as session:
                hs = [session.submit_i(prompts[c, r], max_tokens=max_tokens)
                      for r in range(per_client)]
                for r, h in enumerate(hs):
                    results[c, r] = (list(h.tokens(timeout_s=600)),
                                     h.response)
        except Exception as exc:        # noqa: BLE001 — reported below
            errors.append(repr(exc))

    pa.launches = 0
    forwards[0] = 0
    thread = eng.start()
    t0 = time.monotonic()
    clients = [threading.Thread(target=client, args=(c,))
               for c in range(n_clients)]
    for t in clients:
        t.start()
    for t in clients:
        t.join(timeout=900)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches, n_fwd = pa.launches, forwards[0]
    eng.stop()
    thread.join(timeout=30)
    check(not any(t.is_alive() for t in clients), "a client hung")
    check(not errors, f"client errors: {errors}")
    check(eng.dead is None, f"engine died: {eng.dead}")
    n_req = n_clients * per_client
    check(len(results) == n_req and eng.stats["served"] == n_req,
          f"served {eng.stats['served']} of {n_req}")
    ttft, n_tok = [], 0
    for (c, r), (stream, resp) in sorted(results.items()):
        out = list(map(int, resp.tokens_out))
        check(len(out) == max_tokens, f"request {c}/{r}: {len(out)} tokens")
        check(all(0 <= t < cfg.vocab_size for t in out),
              f"request {c}/{r}: token out of range")
        check(sorted(p for p, _ in stream) == list(range(max_tokens)),
              f"request {c}/{r}: stream not exactly-once")
        check([t for _, t in sorted(stream)] == out,
              f"request {c}/{r}: stream disagrees with tokens_out")
        ttft.append(resp.first_token_t - resp.submit_t)
        n_tok += len(out)
    check(n_fwd > 0 and launches == cfg.num_layers * n_fwd,
          f"paged_attention launches {launches} != "
          f"{cfg.num_layers} x {n_fwd} forwards")
    check(eng.stats["prefix_hits"] > 0, "the shared prefix never hit")
    print(f"main path: smollm-135m (30 layers, d=576, 9/3 heads, vocab "
          f"49152, bf16) slot_paged, pool {kv_mb / 1e6:.0f} MB of K/V; "
          f"{n_req} requests served in {dt:.2f} s, {n_tok / dt:.1f} tok/s, "
          f"TTFT p50 {1e3 * statistics.median(ttft):.0f} ms, prefix_hits "
          f"{eng.stats['prefix_hits']}, prefill_tokens_saved "
          f"{eng.stats['prefill_tokens_saved']}, host_syncs "
          f"{eng.stats['host_syncs']}, decode_steps "
          f"{eng.stats['decode_steps']}, forwards {n_fwd} "
          f"({1e3 * dt / n_fwd:.1f} ms of wall time each), "
          f"paged_attention launches {launches}")
    return launches, model, params


# ---------------------------------------------------------------------------
# Phase 3b: where one dispatch's time goes
# ---------------------------------------------------------------------------
def phase_split(model, params):
    """Wall time of one K=8 decode block and of one T=64 prefill chunk
    at the main path's shapes (B=8, lengths 65..512), against the device
    time the profiler attributes to them: the device's busy and idle
    shares, and the paged-attention kernel's part."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    m, vocab = MAIN, model.cfg.vocab_size
    B, P, C = m["B"], m["P"], m["chunk"]
    g = torch.Generator(device="cuda").manual_seed(3)
    shape = (m["n_pages"] + 1, m["ps"], m["L"], m["Hkv"], m["hd"])
    caches = {
        "pages_k": torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16),
        "pages_v": torch.randn(shape, generator=g, device="cuda").to(
            torch.bfloat16),
        "block": torch.randperm(m["n_pages"], generator=g, device="cuda")[
            :B * P].reshape(B, P).to(torch.int32)}
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(65, 513, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    chunk = torch.randint(0, vocab, (B, C), generator=g, device="cuda").to(
        torch.int32)
    start = (torch.randint(0, 7, (B,), generator=g, device="cuda")
             * C).to(torch.int32)
    nval = torch.full((B,), C, **i32)
    cases = (
        ("decode block K=8", 8, lambda: model.decode_loop(
            params, caches, cur, pos, rem, eos, k=8, max_len=1024)),
        ("prefill chunk T=64", 1, lambda: model.prefill_chunk_into(
            params, caches, chunk, start, nval)))

    def dev_us(e):
        return getattr(e, "self_device_time_total",
                       getattr(e, "self_cuda_time_total", 0))

    for name, steps, fn in cases:
        with torch.no_grad():
            fn()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(3):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / 3 * 1e3
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                fn()
                torch.cuda.synchronize()
        ev = prof.key_averages()
        busy = sum(dev_us(e) for e in ev) / 1e3
        attn = sum(dev_us(e) for e in ev if "paged_attention" in e.key) / 1e3
        top = sorted(ev, key=dev_us, reverse=True)[:5]
        if busy == 0:
            print(f"time split, {name}: wall {wall:.2f} ms; device time "
                  "not measured (the profiler saw no device activity)")
            continue
        print(f"time split, {name}: wall {wall:.2f} ms "
              f"({wall / steps:.2f} ms per forward), device busy "
              f"{busy:.3f} ms (idle share {1 - busy / wall:.3f}), "
              f"paged_attention {attn:.3f} ms; top device ops: "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms"
                          for e in top))


# ---------------------------------------------------------------------------
# Phase 4: CPU/CUDA parity at float32
# ---------------------------------------------------------------------------
def phase_parity():
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              dtype="float32")
    cpu_model = build_model(cfg, device="cpu")
    params = cpu_model.init(torch.Generator().manual_seed(7))

    def to(tree, dev):
        if isinstance(tree, dict):
            return {k: to(v, dev) for k, v in tree.items()}
        return tree.to(dev)

    lengths = [12, 2, 7, 2, 1, 9, 24, 3]
    seqs = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        eng = ServeEngine(model, to(params, dev), max_batch=2, max_len=64,
                          n_clients=1, pool_pages=64, page_size=4,
                          chunk_tokens=4, device=dev)
        for i, n in enumerate(lengths):
            check(eng.submit(0, (np.arange(5) + 3 * i) % cfg.vocab_size,
                             max_tokens=n) is not None, "intake full")
        while eng.stats["served"] + eng.stats["rejected"] < len(lengths):
            eng.step()
        check(eng.stats["rejected"] == 0, f"{dev}: requests rejected")
        got = {}
        for _ in lengths:
            r = eng.get_response(0, timeout_s=30)
            check(bool(r), "parity response timed out")
            got[r.req_id] = list(map(int, r.tokens_out))
        seqs[dev] = [got[k] for k in sorted(got)]
    check(seqs["cpu"] == seqs["cuda"], "CPU and CUDA greedy tokens differ")
    print(f"cpu/cuda parity: {sum(map(len, seqs['cuda']))} greedy tokens "
          f"identical (SMOKE, float32)")


# ---------------------------------------------------------------------------
# Phase 5: kernel timing at the main path's shapes
# ---------------------------------------------------------------------------
def work(q, block, lens, hkv: int, itemsize: int):
    """(bytes, flops) the function needs on these inputs: q, out, the
    block table and lens once each, and the K/V of every position below
    each row's length once per kv head; two hd-long dot products per
    (query head, visible key)."""
    B, T, H, hd = q.shape
    lens_l = [int(x) for x in lens.tolist()]
    kv_bytes = sum(lens_l) * hkv * hd * 2 * itemsize
    nbytes = (2 * q.numel() * itemsize + kv_bytes + block.numel() * 4
              + len(lens_l) * 4)
    visible = sum(max(0, min(n, n - T + t + 1)) for n in lens_l
                  for t in range(T))
    return nbytes, 4 * hd * H * visible


def phase_timing(launches: int, max_err: float):
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    m = MAIN
    rows = []
    for T in (1, m["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, seed=100 + T)
        # Cycle the 30 layer views so a call finds its K/V out of L2, as
        # the served model does (the 30 layers' K/V exceed the 50 MB L2).
        views = [(pk[:, :, li], pv[:, :, li]) for li in range(m["L"])]
        kern = lambda i: pa.paged_attention(q, *views[i % m["L"]],  # noqa
                                            block, lens)
        plain = lambda i: ref.paged_attention_ref(q, *views[i % m["L"]],  # noqa
                                                  block, lens)
        S = m["P"] * m["ps"]

        def gather(i):
            k, v = views[i % m["L"]]
            blk = block.long()
            return (k[blk].reshape(m["B"], S, m["Hkv"], m["hd"]),
                    v[blk].reshape(m["B"], S, m["Hkv"], m["hd"]))

        kg, vg = gather(0)
        q_pos = (lens.long()[:, None] - T
                 + torch.arange(T, device="cuda")[None, :])
        mask = (torch.arange(S, device="cuda")[None, None, :]
                <= q_pos[:, :, None])[:, None]            # [B,1,T,S]
        g = m["H"] // m["Hkv"]
        qt, kt, vt = (x.transpose(1, 2) for x in (
            q, kg.repeat_interleave(g, dim=2), vg.repeat_interleave(g, dim=2)))
        sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, kt, vt, attn_mask=mask)
        before = pa.launches
        t_kern = timed(kern)
        t_plain = timed(plain, inner=10)
        t_gather = timed(gather, inner=10)
        t_sdpa = timed(sdpa, inner=10)
        pa.launches = before                # timing launches are not counted
        nbytes, flops = work(q, block, lens, m["Hkv"], 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        bound = max(t_bytes, t_ops)
        print(f"paged_attention T={T} (B=8, H=9, Hkv=3, hd=64, ps=16, bf16, "
              f"strided layer view): kernel {t_kern:.4f} ms, bound "
              f"{bound:.5f} ms ({'bytes' if t_bytes >= t_ops else 'operations'}"
              f": {nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), plain "
              f"{t_plain:.4f} ms; yardstick (not used by the port): gather "
              f"{t_gather:.4f} ms + SDPA on gathered K/V {t_sdpa:.4f} ms")
        rows.append((T, t_kern, t_plain, bound,
                     "bytes" if t_bytes >= t_ops else "operations"))
    T, t_kern, t_plain, bound, by = rows[0]          # decode: the hot shape
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:152",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip smoke: torch is not installed", file=sys.stderr)
        return 2
    if not torch.cuda.is_available():
        print("chip smoke: no CUDA device", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch" / "kernels" / "csrc").is_dir():
        print(f"chip smoke: no port sources under {SRC}", file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    phase_build()
    max_err = phase_compare()
    launches, model, params = phase_serve()
    phase_split(model, params)
    del model, params
    phase_parity()
    kernel = phase_timing(launches, max_err)
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": [kernel]}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
