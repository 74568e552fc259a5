#!/usr/bin/env python3
"""Chip smoke test of the PyTorch/CUDA port: ``python3 chip_smoke.py``.

Needs one NVIDIA Hopper card and the CUDA toolkit (``nvcc``).  Phases,
each of which fails the run hard:

1. device report: ``nvidia-smi`` name and power limit, torch and CUDA
   versions, and the build of every kernel from ``src/repro_torch`` (one
   ``nvcc`` per source, all started together), with the count of
   tensor-core instructions (HMMA/HGMMA in ``cuobjdump -sass``) in each
   kernel: every bf16 tensor-core kernel (flash, the paged chunk kernel)
   must have some, every NBB ``wgmma`` instance HGMMA, every float32
   (CUDA-core) one none;
2. each kernel against its plain PyTorch version on the card: paged
   attention at the reference test shapes and the paged main path's (a
   strided per-layer view of a [512, 16, 30, 3, 64] pool), then its
   split-KV decode (with a lens=0 row and rows shorter than one split)
   and tensor-core T=64 chunk (with softcap), each twice, bit-identical,
   then both at olmoe-1b-7b's shapes (hd 128, 16 kv heads, g 1) without
   and with the written-key bound ``kv_lens`` (rows of 0, below and equal
   to lens) against both plain versions; then the ring bound (a
   sliding-window ring read with wrap-around) on every route (split +
   combine and simt in f32, split + combine and the tensor-core chunk in
   bf16) at gemma3-27b's local-layer shapes (B=4, ring 1024 as 16 pages of
   64, 16 kv heads of 128, g 2, rows at n = 700/1024/1500/2047, T=1 and
   T=64, with and without ``kv_lens``, windows 1024 and 200) against both
   plain versions (f32 2e-5, bf16 3e-2), queries with no key exactly 0,
   and ring = P * ps over unwrapped rows bit-identical to no ring;
   flash
   attention at the reference test shapes, ragged T and S, and the dense
   main path's (B=1 causal prefills of 64/256/512 tokens over a ring
   slice, a T=1 decode at S=513 over a strided B=4 ring slice); and the
   dense decode read — the paged kernel over a [4, 1024] ring viewed as
   identity pages — against both plain versions; (2c) the NBB matmul at
   the reference test shapes in f32 and bf16, the f32 instance's one and
   13 K tiles, each bf16 instance's ring at 1, S-1, S+1 and 2S+1 K steps,
   ragged edges and the kernel benchmark's 512 x 1024 x 512 bf16, each
   twice, bit-identical, then one call through ``ops.nbb_matmul`` at that
   shape as its entry point's run; (2d) ``flash_attention_trainable`` (the flash
   forward and backward kernels): its output against the plain version
   and its gradients against ``ref.flash_attention_bwd_ref``, element by
   element, at the reference test's f32 case, a window + softcap GQA case
   in f32 and bf16, a bf16 window + softcap case over 16 key tiles and
   smollm's bf16 training shape, where the gradient bound must also
   reject the kernel's gradients with one 64 x 64 tile left out;
3. the paged main path at full width: ``smollm-135m`` (random weights
   from a seed) served by the ``slot_paged`` engine to 4 client sessions
   x 4 requests, every stream complete and exactly-once, the paged kernel
   launched 30 times per model forward and its split-KV combine 30 times
   per one-token decode forward; then where one dispatch's time
   goes.  In every served and trained run, every flash launch takes the
   tensor-core instance (none the CUDA-core one);
4. the dense main path at full width: the same 16 requests under
   ``slot_fused`` (flash launches = 30 x prefills, paged launches and
   combines = 30 x decode steps), then 4 requests each under
   ``slot_chunked`` and ``wave``; then where a prefill's and a decode
   block's time goes;
3c-3e. the robustness paths of ``slot_paged`` at full width (30 layers,
   d=576, bf16, seed-0 weights; ``max_len=1024``, 16-token pages,
   ``chunk_tokens=64``, ``k_max=8``), each run driven inline, every kernel
   counter zeroed before it and read after it (paged launches = 30 x
   forwards, combines = 30 x one-token forwards, no flash, no CUDA-core
   route); every served run of phases 3-5 without a fault plan must end
   with 0 watchdog catches and 0 failed requests in ``fault_report()``,
   so a device error cannot hide behind the watchdog: (3c) overload —
   2 priority classes, preemption, WFQ, 8 slots over 128 pages (47 MB of
   K/V), two low-class clients sending 4 requests each (400-480 prompt
   tokens, 64 new, one outstanding at a time), then, once both decode,
   two high-class clients 4 requests each at once (40-120 tokens, 32
   new): at least one preemption, every parked sequence resumed and
   finished, swap bytes whole pages, no negative page in any dispatched
   block table, each preempted request's stream byte-identical to the
   same request served alone, TTFT p50 per class printed; (3d) faults —
   ``FaultPlan.sweep(8, seed=0)`` over the eight sites this path probes,
   4 requests a plan, ``tick_retries=1``: no wedge, every failure an
   injected one (the watchdog's catches equal the raising faults fired),
   survivors byte-identical to the run with no fault; (3e) recovery —
   snapshots every 2 ticks, the engine abandoned at its second, middle
   and next-to-last tick and restored in a fresh engine from the newest
   snapshot plus the journal: every stream byte-identical to the
   uninterrupted run, snapshot bytes and restore times printed;
3f. the MoE family at full width: ``olmoe-1b-7b`` (16 layers, d=2048,
   16/16 heads of 128, 64 experts top-8, vocab 50304, bf16, seed-0
   weights) under ``slot_paged`` (``max_batch=8``, 512 pages,
   ``chunk_tokens=64``, ``k_max=8``) on the same 16 requests: every
   stream complete and exactly-once, paged launches = 16 x forwards,
   combines = 16 x one-token forwards, no CUDA-core route, no watchdog
   catch; then where a decode block's and a chunk's time goes;
3g. the local:global family at full width: ``gemma3-27b`` (62 layers: 10
   superblocks of 5 local layers with a 1024-token window and 1 global,
   then 2 local; d=5376, 32/16 heads of 128, vocab 262144, bf16, seed-0
   weights drawn on the card a layer at a time, 54.0 GB; no cut), after
   olmoe's weights are freed: ``slot_chunked`` (``max_batch=4``,
   ``max_len=4096``, ``chunk_tokens=64``, ``k_max=8``) on 4 requests, two
   with prompts of 1100 and 1500 tokens so every local ring wraps in
   prefill and in decode, two of 480 and 40, 32 new tokens each: every
   stream complete and exactly-once, paged launches = 62 x forwards, ring
   launches = 52 x forwards, combines = 62 x one-token forwards, no
   CUDA-core route, no watchdog catch; ``slot_fused`` on 2 requests (1100
   and 300 tokens): flash on the 10 global layers of the wrapped prefill
   and all 62 of the other, the ring bound on its 52 local layers and on
   every decode step's; then where a decode block's and a chunk's time
   goes (rows past the window), and the peak device memory;
5. CPU/CUDA parity: the SMOKE configs at float32, same weights on both
   devices, identical greedy tokens: smollm under ``slot_paged``,
   ``slot_fused`` and ``wave``, olmoe (weights x3) under ``slot_paged``
   and ``slot_fused``, gemma (weights x3) under ``slot_chunked`` and
   ``slot_fused`` with prompts of up to 30 tokens past its window of 8;
6. kernel timing at the main paths' shapes (CUDA events around windows
   enqueued behind a device-side spin, so they time the card's work and
   not the host's launch rate; paged: slot_paged's T=1 decode and T=64
   chunk, slot_fused's dense-ring decode, olmoe's T=1 and T=64 with
   ``kv_lens``; the ring bound at gemma's T=1 and T=64), beside each
   kernel's bound,
   its plain version and the one PyTorch call that computes the same
   function
   where there is one (``scaled_dot_product_attention`` forward, backward,
   and forward + backward for the trainable flash; ``torch.matmul`` for
   the NBB matmul, a gather into position order + masked SDPA for the
   ring bound: yardsticks the port never calls);
7. training at full width: ``smollm-135m`` through
   ``repro_torch.launch.train`` (batch 4 x 1024 tokens, remat "nothing",
   20 steps, 2 producer threads, async checkpoints every 10), the flash
   forward launched exactly 60 times a step (30 layers, forward and remat
   recompute) and the flash backward 30 times, the loss falling; a resume
   from its checkpoint for 5 more steps; where one step's time goes;
   CPU/CUDA parity of 3 SMOKE steps' losses at float32;
8. the interleaving checker on the host, over the port's core: every
   scenario explored at its budget capped at 1500 executions (each
   verdict must be the scenario's ``expect``), the six schedules of
   ``tests/schedules/`` replayed, and the functional bit set on a CUDA
   tensor against ``HostBitset``.

Phase 7 runs before the timing of phase 6, which reports its launch
count; the paged row's launches add phases 3c-3g's to phase 3's, and the
ring row's are 3g's launches under the ring bound.  Every
kernel counter is set to 0 just before a served or trained run (or the
NBB matmul's entry-point call) and read just after it; launches made to
compare or time a kernel (or to serve a request alone for comparison)
are not counted.  Prints one
JSON line of kernel results, then the device line ``{"ok": true,
"device": {...}}`` last.  Exits non-zero, printing no result, without a
card or outside a checkout of the repository.
"""
from __future__ import annotations

import dataclasses
import json
import math
import os
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
# olmoe-1b-7b's slot_paged path (phase 3f): the same pool geometry at hd
# 128 with one query head per kv head.
OLMOE = dict(MAIN, L=16, Hkv=16, hd=128, H=16)
# The dense main path (slot_fused): a [4, 1024] ring per layer, B=1
# prefills of bucketed prompts, B=4 decode.
DENSE = dict(L=30, B=4, size=1024, Hkv=3, hd=64, H=9, prefill=(64, 256, 512),
             decode_S=513)


def _to_device(tree, dev):
    """A nested dict of tensors, moved to ``dev``."""
    if isinstance(tree, dict):
        return {k: _to_device(v, dev) for k, v in tree.items()}
    return tree.to(dev)


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise RuntimeError(f"chip smoke failed: {msg}")


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


_SPIN = {}


def spin(ms: float) -> None:
    """Hold the current stream for about ``ms`` ms (``torch.cuda._sleep``,
    its cycles per ms measured once)."""
    import torch
    if "cycles_per_ms" not in _SPIN:
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        torch.cuda._sleep(10 ** 7)
        b.record()
        b.synchronize()
        _SPIN["cycles_per_ms"] = 10 ** 7 / a.elapsed_time(b)
    torch.cuda._sleep(int(ms * _SPIN["cycles_per_ms"]))


def timed(fn, reps: int = 5, inner: int = 50) -> float:
    """Median device ms per call over ``reps`` CUDA-event windows of
    ``inner`` calls, after a warm-up.  Each window is enqueued behind a
    device-side spin longer than the host takes to enqueue it, so the
    events time the card's work, not the host's launch rate."""
    import torch
    for _ in range(5):
        fn(0)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for i in range(inner):
        fn(i)
    host_ms = (time.perf_counter() - t0) * 1e3
    torch.cuda.synchronize()
    samples = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        spin(2 * host_ms + 1)
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
def cuobjdump() -> str:
    """The CUDA toolkit's ``cuobjdump``, or the copy Triton ships."""
    import shutil
    found = shutil.which("cuobjdump")
    if found:
        return found
    candidates = [Path("/usr/local/cuda/bin/cuobjdump")]
    try:
        import triton
        candidates.append(Path(triton.__file__).parent / "backends" / "nvidia"
                          / "bin" / "cuobjdump")
    except ImportError:
        pass
    for c in candidates:
        if c.exists():
            return str(c)
    raise RuntimeError("chip smoke failed: no cuobjdump to read the SASS")


def tensor_core_counts(lib, opcodes=("HMMA", "HGMMA")) -> dict:
    """{kernel function: count of ``opcodes`` instructions} in ``lib``."""
    out = subprocess.run([cuobjdump(), "-sass", str(lib)], capture_output=True,
                         text=True, timeout=300, check=True).stdout
    counts, fn = {}, None
    for line in out.splitlines():
        if "Function :" in line:
            fn = line.split("Function :")[1].strip()
            counts[fn] = 0
        elif fn is not None and any(op in line for op in opcodes):
            counts[fn] += 1
    return counts


def phase_build():
    import torch
    from repro_torch.kernels import (build, flash_attention, nbb_matmul,
                                     paged_attention)
    sources = {"paged_attention": paged_attention.SOURCE,
               "flash_attention": flash_attention.SOURCE,
               "flash_attention_bwd": flash_attention.BWD_SOURCE,
               "nbb_matmul": nbb_matmul.SOURCE}
    t0 = time.monotonic()
    with ThreadPoolExecutor(len(sources)) as ex:    # one nvcc per source
        libs = dict(zip(sources, ex.map(build.build, sources.values())))
    dt = time.monotonic() - t0
    print(f"torch {torch.__version__}  cuda {torch.version.cuda}  "
          f"device {torch.cuda.get_device_name(0)}")
    print(f"kernel build: {dt:.1f} s ({', '.join(libs)})")
    for name, lib in libs.items():
        kernel = name
        for line in Path(lib).with_suffix(".log").read_text().splitlines():
            if "Compiling entry function" in line:
                kernel = demangle(line.split("'")[1])
            elif "registers" in line or "spill" in line:
                print(f"  {kernel}: {line.split(':', 1)[-1].strip()}")
    # Tensor-core instructions in the SASS: each bf16 tensor-core instance
    # must issue them (the flash kernels' flash_*_tc<hd>, the paged chunk
    # kernel paged_chunk_tc<hd>; the NBB matmul's nbb_wgmma_kernel<...>
    # HGMMA, wgmma), each float32 instance none (flash_*_simt<T>,
    # paged_split<float, hd>, paged_simt<float>, nbb_simt_kernel): no TF32.
    rules = {  # source: (tensor-core needle, least count, f32 needles, least)
        "flash_attention": ("_tcI", 4, ("_simtI",), 2),
        "flash_attention_bwd": ("_tcI", 4, ("_simtI",), 2),
        "paged_attention": ("paged_chunk_tcI", 4,
                            ("paged_splitIf", "paged_simtIf"), 5),
        "nbb_matmul": ("nbb_wgmma_kernelI", 2, ("nbb_simt_kernel",), 1)}
    for name, (tc_needle, n_tc, f32_needles, n_f32) in rules.items():
        counts = tensor_core_counts(libs[name])
        tc = {f: n for f, n in counts.items() if tc_needle in f}
        f32 = {f: n for f, n in counts.items()
               if any(x in f for x in f32_needles)}
        check(len(tc) >= n_tc and all(n > 0 for n in tc.values()),
              f"{name}: a tensor-core kernel without HMMA/HGMMA: {tc}")
        check(len(f32) >= n_f32 and not any(f32.values()),
              f"{name}: a float32 kernel with HMMA/HGMMA: {f32}")
        if name == "nbb_matmul":
            hgmma = tensor_core_counts(libs[name], ("HGMMA",))
            check(all(hgmma[f] > 0 for f in tc),
                  f"nbb_matmul: a wgmma instance without HGMMA: {hgmma}")
        print(f"  {name} SASS tensor-core instructions (HMMA/HGMMA): "
              + ", ".join(sorted(f"{demangle(f)} {n}"
                                 for f, n in counts.items())))


def demangle(mangled: str) -> str:
    """``flash_fwd_tc<64>`` for a kernel's mangled name (``c++filt``)."""
    full = subprocess.run(["c++filt", mangled], capture_output=True,
                          text=True, check=True).stdout
    return full.replace("(anonymous namespace)::", "").split("(")[0] \
        .removeprefix("void ")


# ---------------------------------------------------------------------------
# Phase 2: each kernel vs its plain version on the card
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


def main_path_inputs(torch, T: int, seed: int, m=MAIN):
    """A bf16 pool of the main path's shape (``m``: MAIN or OLMOE), a
    block table of disjoint scattered pages and lengths like the served
    traffic's (bucketed prompts of 64..512 tokens plus up to 32
    generated)."""
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
    split_err = phase_compare_split()
    olmoe_err = phase_compare_olmoe()
    print(f"kernel vs plain: reference cases (and their poison-page "
          f"variants, bit-identical) max err f32 "
          f"{worst['float32']:.3g} (tol 1e-4), bf16 "
          f"{worst['bfloat16']:.3g} (tol 3e-2); main-path shapes bf16 "
          f"max err {main_err:.3g}")
    return max(main_err, split_err, olmoe_err)


# (label, B, T, lens, softcap): the split-KV decode at the paged main
# path's table (B=8, ps=16, P=64: 16 splits of 64 keys) with a lens=0
# row, rows shorter than one split and one that ends on a split's edge;
# the T=64 tensor-core chunk with a row shorter than T, one past the
# table, and softcap.
SPLIT_CASES = [
    ("split decode", 8, 1, [0, 5, 63, 64, 65, 300, 545, 1024], 0.0),
    ("split decode softcap", 8, 1, [1, 17, 128, 129, 700, 64, 1000, 2],
     30.0),
    ("tensor-core chunk T=64", 4, 64, [64, 300, 40, 1100], 0.0),
    ("tensor-core chunk T=64 softcap", 4, 64, [64, 300, 40, 1100], 30.0),
]


def phase_compare_split():
    """The redesigned routes at the paged main path's shapes (a strided
    layer view of the bf16 pool): each against the plain version (and the
    split decode against the plain split-KV version, which merges the
    splits as the kernel does), its route and launch counts, and two calls
    bit-identical.  Returns the max bf16 error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    m = MAIN
    _, pk, pv, block, _ = main_path_inputs(torch, 1, seed=40)
    kview, vview = pk[:, :, 3], pv[:, :, 3]
    g = torch.Generator(device="cuda").manual_seed(41)
    worst, lines = 0.0, []
    for label, B, T, lens, cap in SPLIT_CASES:
        q = torch.randn((B, T, m["H"], m["hd"]), generator=g,
                        device="cuda").to(torch.bfloat16)
        ln = torch.tensor(lens, dtype=torch.int32, device="cuda")
        blk = block[:B]
        way = pa.route(q, kview, vview)
        check(way == ("split" if T == 1 else "chunk_tc"),
              f"{label}: route {way}")
        before = (pa.launches, pa.combine_launches)
        out = pa.paged_attention(q, kview, vview, blk, ln, softcap=cap)
        again = pa.paged_attention(q, kview, vview, blk, ln, softcap=cap)
        torch.cuda.synchronize()
        combines = 2 if way == "split" else 0
        check((pa.launches - before[0], pa.combine_launches - before[1])
              == (2, combines), f"{label}: launches")
        check(torch.equal(out, again), f"{label}: two calls differ")
        want = ref.paged_attention_ref(q, kview, vview, blk, ln, softcap=cap)
        err = (out.float() - want.float()).abs().max().item()
        if way == "split":
            split_keys = pa.split_plan(B, m["Hkv"], m["P"], m["ps"])[1]
            want2 = ref.paged_attention_split_ref(q, kview, vview, blk, ln,
                                                  split_keys, softcap=cap)
            err = max(err, (out.float() - want2.float()).abs().max().item())
        check(err <= TOLS["bfloat16"], f"{label}: err {err}")
        check(torch.count_nonzero(out[ln <= 0]) == 0,
              f"{label}: a lens=0 row is not zero")
        worst = max(worst, err)
        lines.append(f"{label} ({way}, B={B}, lens {lens}) {err:.3g}")
    print("redesigned paged routes vs plain (bf16, tol 3e-2; two calls "
          "bit-identical): " + "; ".join(lines))
    return worst


# olmoe's kv_lens per row (B=8) beside lens, per T: 0 (an idle slot),
# below lens (a dead decode row, a padded chunk tail) and equal to lens.
OLMOE_KV_LENS = {1: lambda lens: [0, 0] + [max(0, n - 1) for n in lens[2:5]]
                 + lens[5:],
                 64: lambda lens: [0, 0] + [n - 20 for n in lens[2:5]]
                 + lens[5:]}


def phase_compare_olmoe():
    """The paged kernel at olmoe-1b-7b's main-path shapes (hd 128, 16 kv
    heads, g 1; strided layer views of a [512, 16, 16, 16, 128] bf16
    pool): the T=1 split-KV decode (8 splits of 128 keys + combine) and
    the T=64 tensor-core chunk, without and with ``kv_lens`` (rows of 0,
    below and equal to lens), against both plain versions; zero rows
    exact, two calls bit-identical, kv_lens = lens bit-identical to no
    kv_lens.  Returns the max bf16 error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    m = OLMOE
    worst, lines = 0.0, []
    for T in (1, m["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, 50 + T, m)
        kview, vview = pk[:, :, 5], pv[:, :, 5]
        way = pa.route(q, kview, vview)
        check(way == ("split" if T == 1 else "chunk_tc"),
              f"olmoe T={T}: route {way}")
        if way == "split":
            plan = pa.split_plan(m["B"], m["Hkv"], m["P"], m["ps"])
            check(plan[0] > 1, f"olmoe T=1: split plan {plan} does not "
                               "split")
        kl = torch.tensor(OLMOE_KV_LENS[T](lens.tolist()), dtype=torch.int32,
                          device="cuda")
        for kv_lens in (None, kl):
            before = (pa.launches, pa.combine_launches, pa.simt_launches)
            out = pa.paged_attention(q, kview, vview, block, lens,
                                     kv_lens=kv_lens)
            again = pa.paged_attention(q, kview, vview, block, lens,
                                       kv_lens=kv_lens)
            torch.cuda.synchronize()
            split = way == "split"
            check((pa.launches - before[0], pa.combine_launches - before[1],
                   pa.simt_launches - before[2]) == (2, 2 * split, 0),
                  f"olmoe T={T}: launches")
            check(torch.equal(out, again), f"olmoe T={T}: two calls differ")
            want = ref.paged_attention_ref(q, kview, vview, block, lens,
                                           kv_lens=kv_lens)
            want2 = ref.paged_attention_split_ref(
                q, kview, vview, block, lens,
                pa.split_plan(m["B"], m["Hkv"], m["P"], m["ps"])[1],
                kv_lens=kv_lens)
            err = max((out.float() - w.float()).abs().max().item()
                      for w in (want, want2))
            check(err <= TOLS["bfloat16"], f"olmoe T={T} kv_lens "
                                           f"{kv_lens is not None}: err {err}")
            if kv_lens is not None:
                check(torch.count_nonzero(out[kv_lens == 0]) == 0,
                      f"olmoe T={T}: a kv_lens=0 row is not zero")
            worst = max(worst, err)
            lines.append(f"T={T} ({way}) kv_lens "
                         f"{'-' if kv_lens is None else kv_lens.tolist()} "
                         f"{err:.3g}")
        same = pa.paged_attention(q, kview, vview, block, lens,
                                  kv_lens=torch.maximum(lens, kl))
        check(torch.equal(same, pa.paged_attention(q, kview, vview, block,
                                                   lens)),
              f"olmoe T={T}: kv_lens = lens changed the output")
    print("paged at olmoe-1b-7b's shapes (hd 128, Hkv 16, g 1) vs both "
          "plain versions (bf16, tol 3e-2; two calls bit-identical): "
          + "; ".join(lines))
    return worst


# gemma3-27b's local layers (phase 3g): a [4, 1024] ring per layer of 16
# kv heads of 128, 32 query heads (g 2), read as 16 identity pages of 64
# slots, window 1024.
GEMMA = dict(B=4, size=1024, ps=64, Hkv=16, H=32, hd=128, window=1024,
             chunk=64)
# Row counts n (keys written once the dispatch's writes land): below the
# ring, at it, past it and one short of two rings.
GEMMA_N = [700, 1024, 1500, 2047]
# (label, T, n_valid per row or None): T=1 decode; T=64 chunks; with
# kv_lens (a write mask) rows that wrote all, part or none of the chunk,
# and a dead decode row.
RING_CASES = [
    ("decode", 1, None),
    ("decode kv_lens", 1, [1, 0, 1, 0]),
    ("chunk", 64, None),
    ("chunk kv_lens", 64, [64, 10, 0, 37]),
]


def gemma_ring(torch, seed: int, dt=None):
    """K and V of one gemma local layer's [4, 1024, 16, 128] ring (bf16
    by default), viewed as 64 identity pages of 64 slots, and its block
    table."""
    d = GEMMA
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (d["B"] * d["size"] // d["ps"], d["ps"], d["Hkv"], d["hd"])
    k, v = (torch.randn(shape, generator=g, device="cuda").to(
        dt or torch.bfloat16) for _ in range(2))
    block = torch.arange(shape[0], dtype=torch.int32, device="cuda").view(
        d["B"], d["size"] // d["ps"])
    return k, v, block


def ring_inputs(torch, T: int, n_valid, seed: int, dt):
    """(q, lens, kv_lens or None) of a ring read at GEMMA_N: lens = cp +
    T; with n_valid, kv_lens = cp + n_valid = n."""
    d = GEMMA
    g = torch.Generator(device="cuda").manual_seed(seed)
    q = torch.randn((d["B"], T, d["H"], d["hd"]), generator=g,
                    device="cuda").to(dt)
    n = torch.tensor(GEMMA_N, dtype=torch.int32, device="cuda")
    if n_valid is None:
        return q, n, None
    cp = n - torch.tensor(n_valid, dtype=torch.int32, device="cuda")
    return q, (cp + T).to(torch.int32), n


def phase_compare_ring():
    """The ring bound (a sliding-window ring read with wrap-around) on
    every route at gemma3-27b's local-layer shapes: T=1 (split + combine,
    f32 and bf16), T=64 (``chunk_tc`` in bf16, ``simt`` in f32), with and
    without ``kv_lens``, window 1024 and a window of 200 inside it; each
    against both plain versions, queries that see no key exactly 0, two
    calls bit-identical; and ring = P * ps with window 0 over rows that
    never wrapped bit-identical to the call without the new arguments.
    Returns the max bf16 error."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    d = GEMMA
    tols = {"float32": 2e-5, "bfloat16": 3e-2}
    worst, lines = {}, []
    for dt_name, tol in tols.items():
        dt = getattr(torch, dt_name)
        k, v, block = gemma_ring(torch, 60, dt)
        for label, T, n_valid in RING_CASES:
            for window in (d["window"], 200):
                if window != d["window"] and dt_name == "float32":
                    continue
                q, lens, kv_lens = ring_inputs(torch, T, n_valid, 61 + T, dt)
                kw = dict(kv_lens=kv_lens, ring=d["size"], window=window)
                way = pa.route(q, k, v)
                want_way = ("split" if T == 1 else
                            "chunk_tc" if dt_name == "bfloat16" else "simt")
                check(way == want_way, f"ring {label} {dt_name}: route {way}")
                before = (pa.launches, pa.combine_launches,
                          pa.simt_launches, pa.ring_launches)
                out = pa.paged_attention(q, k, v, block, lens, **kw)
                again = pa.paged_attention(q, k, v, block, lens, **kw)
                torch.cuda.synchronize()
                # simt splits a long chunk along T: several passes a call.
                n = pa.launches - before[0]
                check(n >= 2 and (pa.combine_launches - before[1],
                                  pa.simt_launches - before[2],
                                  pa.ring_launches - before[3])
                      == (n * (way == "split"), n * (way == "simt"), n),
                      f"ring {label} {dt_name}: launches")
                check(torch.equal(out, again),
                      f"ring {label} {dt_name}: two calls differ")
                split_keys = pa.split_plan(d["B"], d["Hkv"],
                                           block.shape[1], d["ps"])[1]
                wants = (ref.paged_attention_ref(q, k, v, block, lens, **kw),
                         ref.paged_attention_split_ref(
                             q, k, v, block, lens, split_keys, **kw))
                err = max((out.float() - w.float()).abs().max().item()
                          for w in wants)
                check(err <= tol, f"ring {label} window {window} {dt_name}: "
                                  f"err {err}")
                empty = wants[0].float().abs().amax((2, 3)) == 0   # [B, T]
                check(torch.count_nonzero(out[empty]) == 0,
                      f"ring {label} {dt_name}: a query with no key is "
                      "not zero")
                worst[dt_name] = max(worst.get(dt_name, 0.0), err)
                lines.append(f"{label} T={T} window {window} {dt_name} "
                             f"({way}) {err:.3g}")
        # Rows that never wrapped: the ring bound at ring = P * ps, window
        # 0, is the bound without it, bit for bit.
        for T, n_valid in ((1, [1, 1, 0, 1]), (64, [64, 5, 0, 64])):
            q, _, _ = ring_inputs(torch, T, None, 70 + T, dt)
            n = torch.tensor([64, 700, 1000, 1024], dtype=torch.int32,
                             device="cuda")
            cp = n - torch.tensor(n_valid, dtype=torch.int32, device="cuda")
            lens = (cp + T).to(torch.int32)
            plain = pa.paged_attention(q, k, v, block, lens, kv_lens=n)
            ringed = pa.paged_attention(q, k, v, block, lens, kv_lens=n,
                                        ring=d["size"])
            torch.cuda.synchronize()
            check(torch.equal(plain, ringed), f"ring = P * ps, T={T} "
                                              f"{dt_name}: not bit-identical")
    print("paged ring bound at gemma3-27b's local shapes (B=4, ring 1024 = "
          "16 pages of 64, Hkv 16, H 32, hd 128; n " + str(GEMMA_N)
          + ") vs both plain versions (tol f32 2e-5, bf16 3e-2; two calls "
          "bit-identical; ring = P * ps on unwrapped rows bit-identical to "
          "no ring): " + "; ".join(lines))
    return worst["bfloat16"]


# (B, T, S, H, Hkv, hd, kwargs): tests/test_kernels.py and
# tests/test_kernels_decode.py, then ragged T and S.
FLASH_CASES = [
    (1, 128, 128, 4, 4, 64, {}),
    (2, 128, 256, 8, 2, 64, {}),
    (1, 256, 256, 6, 3, 128, {}),
    (1, 512, 512, 4, 4, 64, {"window": 128}),
    (1, 1, 1024, 4, 4, 64, {"window": 256}),
    (1, 512, 512, 4, 4, 64, {"window": 512}),
    (1, 128, 128, 2, 2, 64, {"softcap": 50.0}),
    (1, 128, 256, 4, 4, 64, {"causal": False}),
    (2, 1, 512, 8, 2, 64, {}),
    (1, 128, 128, 16, 1, 64, {}),
    (1, 128, 128, 12, 4, 64, {}),
    (1, 128, 128, 9, 3, 64, {}),
    (2, 37, 101, 9, 3, 64, {}),
    (1, 45, 77, 6, 2, 32, {"window": 20, "softcap": 30.0}),
    (1, 3, 70, 4, 1, 16, {"causal": False}),
]


def dense_ring(torch, B: int, seed: int):
    """bf16 K and V rings of the dense main path: [L, B, 1024, Hkv, hd]."""
    d = DENSE
    g = torch.Generator(device="cuda").manual_seed(seed)
    shape = (d["L"], B, d["size"], d["Hkv"], d["hd"])
    return tuple(torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for _ in range(2))


def phase_compare_flash():
    """Flash kernel vs plain: reference and ragged cases in f32 (TF32
    off) and bf16, then the dense main path's shapes in bf16 over ring
    slices read in place.  Returns the main-path bf16 max error."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    worst = {}
    g = torch.Generator(device="cuda").manual_seed(21)
    for B, T, S, H, Hkv, hd, kw in FLASH_CASES:
        q = torch.randn((B, T, H, hd), generator=g, device="cuda")
        k = torch.randn((B, S, Hkv, hd), generator=g, device="cuda")
        v = torch.randn((B, S, Hkv, hd), generator=g, device="cuda")
        for dt_name, tol in TOLS.items():
            dt = getattr(torch, dt_name)
            args = (q.to(dt), k.to(dt), v.to(dt))
            out = fa.flash_attention(*args, **kw)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(*args, **kw)
            err = (out.float() - want.float()).abs().max().item()
            check(err <= tol, f"flash case {(B, T, S, H, Hkv, hd, kw)} "
                              f"{dt_name}: err {err}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    d = DENSE
    main_err = 0.0
    rk1, rv1 = dense_ring(torch, 1, seed=22)
    rk4, rv4 = dense_ring(torch, d["B"], seed=23)
    shapes = [(rk1, rv1, T, T) for T in d["prefill"]]
    shapes.append((rk4, rv4, 1, d["decode_S"]))
    for rk, rv, T, S in shapes:
        B = rk.shape[1]
        q = torch.randn((B, T, d["H"], d["hd"]), generator=g,
                        device="cuda").to(torch.bfloat16)
        for li in (0, d["L"] - 1):
            k, v = rk[li][:, :S], rv[li][:, :S]
            check(B == 1 or not k.is_contiguous(), "ring slice contiguous")
            out = fa.flash_attention(q, k, v)
            torch.cuda.synchronize()
            want = ref.flash_attention_ref(q, k, v)
            err = (out.float() - want.float()).abs().max().item()
            check(err <= TOLS["bfloat16"],
                  f"flash main shape B={B} T={T} S={S}: err {err}")
            main_err = max(main_err, err)
    print(f"flash vs plain: {len(FLASH_CASES)} reference/ragged cases max "
          f"err f32 {worst['float32']:.3g} (tol 1e-4), bf16 "
          f"{worst['bfloat16']:.3g} (tol 3e-2); dense main-path shapes "
          f"(B=1 T=S in {d['prefill']}, B=4 T=1 S={d['decode_S']}, bf16, "
          f"ring slices) max err {main_err:.3g}")
    return main_err


def phase_compare_dense_decode():
    """The dense decode read: the paged kernel over a [4, 1024] ring
    viewed as identity-mapped 64-token pages with per-row lengths, held
    against the paged plain version and, row by row, against flash's
    plain version over the ring prefix (the same function)."""
    import torch
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    from repro_torch.models.layers import ring_page_size
    d = DENSE
    B, size = d["B"], d["size"]
    ps = ring_page_size(size)
    P = size // ps
    rk, rv = dense_ring(torch, B, seed=24)
    block = torch.arange(B * P, dtype=torch.int32,
                         device="cuda").view(B, P)
    lens = torch.tensor([65, 300, 513, 1000], dtype=torch.int32,
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(25)
    q = torch.randn((B, 1, d["H"], d["hd"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    worst = {}
    for li in (0, d["L"] - 1):
        kp = rk[li].view(B * P, ps, d["Hkv"], d["hd"])
        vp = rv[li].view(B * P, ps, d["Hkv"], d["hd"])
        for dt_name, tol in TOLS.items():
            dt = getattr(torch, dt_name)
            args = (q.to(dt), kp.to(dt), vp.to(dt))
            out = pa.paged_attention(*args, block, lens)
            torch.cuda.synchronize()
            want = ref.paged_attention_ref(*args, block, lens)
            err = (out.float() - want.float()).abs().max().item()
            for b in range(B):
                n = int(lens[b])
                row = ref.flash_attention_ref(
                    args[0][b:b + 1], rk[li][b:b + 1, :n].to(dt),
                    rv[li][b:b + 1, :n].to(dt))
                err = max(err, (out[b:b + 1].float()
                                - row.float()).abs().max().item())
            check(err <= tol, f"dense decode layer {li} {dt_name}: err "
                              f"{err}")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    print(f"dense decode (paged kernel over identity pages, B=4, lens "
          f"{lens.tolist()}, ps={ps}): max err f32 {worst['float32']:.3g}, "
          f"bf16 {worst['bfloat16']:.3g} vs both plain versions")


# (M, K, N, blocks, dtypes, (atol, rtol)): tests/test_kernels.py's shapes
# and tolerances; the f32 instance's own K tiles (32 each): one tile and
# 13 of them (odd: the last slot's phase parity differs from the
# first's); each bf16 instance's ring (K steps of 64, S slots: 4 for the
# 64 x 64 tile, 3 for the 128 x 128 one) at 1, S-1, S+1 and 2S+1 steps,
# so every slot's parity is met in more than one round and the last round
# is partial; ragged M/N/K edges (TMA's zero fill in bf16); and
# bench_kernels.py's shape.
NBB_F32 = (5e-4, 1e-3)
NBB_EXACT = (2e-5, 2e-5)
NBB_BF16 = (3e-2, 3e-2)
NBB_CASES = [
    (256, 512, 256, (128, 128, 128), ("float32", "bfloat16"), None),
    (128, 128, 128, (128, 128, 128), ("float32", "bfloat16"), None),
    (512, 1024, 256, (256, 256, 256), ("float32", "bfloat16"), None),
    (128, 384, 128, (128, 128, 128), ("float32",), NBB_EXACT),
    (128, 32, 128, (256, 256, 512), ("float32", "bfloat16"), NBB_EXACT),
    (128, 416, 128, (256, 256, 512), ("float32", "bfloat16"), NBB_EXACT),
    (100, 40, 72, (256, 256, 512), ("float32", "bfloat16"), NBB_EXACT),
    (128, 64, 128, (128, 128, 64), ("bfloat16",), None),
    (128, 192, 128, (128, 128, 192), ("bfloat16",), None),
    (128, 320, 128, (128, 128, 320), ("bfloat16",), None),
    (128, 576, 128, (128, 128, 576), ("bfloat16",), None),
    (1408, 64, 1536, (1408, 1536, 64), ("bfloat16",), None),
    (1408, 128, 1536, (1408, 1536, 128), ("bfloat16",), None),
    (1408, 256, 1536, (1408, 1536, 256), ("bfloat16",), None),
    (1408, 448, 1536, (1408, 1536, 448), ("bfloat16",), None),
    (1500, 200, 1544, (1500, 1544, 200), ("float32", "bfloat16"), None),
    (512, 1024, 512, (256, 256, 512), ("bfloat16",), None),
]
NBB_BENCH = (512, 1024, 512)      # bench_kernels.py:95-98, bf16


def phase_compare_nbb():
    """2c: the NBB matmul kernel vs ``ref.matmul_ref`` (TF32 off), then
    its entry point's run: one ``ops.nbb_matmul`` call at the benchmark's
    shape and blocks with the counter set to 0 just before.  Returns
    (max abs err over every case, entry-point launches)."""
    import torch
    from repro_torch.kernels import nbb_matmul as nbb
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    check(nbb.TILE == ((64, 64, 32), (64, 64, 64), (128, 128, 64))
          and nbb.SLOTS == (2, 4, 3),
          f"kernel tiles {nbb.TILE} / slots {nbb.SLOTS}: the cases assume "
          "(64, 64, 32) x 2, (64, 64, 64) x 4 and (128, 128, 64) x 3")
    used = set()
    g = torch.Generator(device="cuda").manual_seed(31)

    def err_within(out, want, atol, rtol):
        """(max abs err, every element within atol + rtol * |want|)."""
        diff = (out.float() - want.float()).abs()
        return diff.max().item(), bool(
            (diff <= atol + rtol * want.float().abs()).all())

    worst = {}
    for M, K, N, (bm, bn, bk), dtypes, tol in NBB_CASES:
        a = torch.randn((M, K), generator=g, device="cuda")
        b = torch.randn((K, N), generator=g, device="cuda")
        for dt_name in dtypes:
            dt = getattr(torch, dt_name)
            atol, rtol = tol if tol and dt_name == "float32" else (
                NBB_F32 if dt_name == "float32" else NBB_BF16)
            before = nbb.launches
            out = nbb.nbb_matmul(a.to(dt), b.to(dt), bm=bm, bn=bn, bk=bk)
            again = nbb.nbb_matmul(a.to(dt), b.to(dt), bm=bm, bn=bn, bk=bk)
            torch.cuda.synchronize()
            check(nbb.launches == before + 2, "nbb_matmul did not launch")
            check(torch.equal(out, again), f"nbb case {(M, K, N)} "
                                           f"{dt_name}: two calls differ")
            used.add(nbb.instance_for(dt, M, N))
            err, ok = err_within(out, ref.matmul_ref(a.to(dt), b.to(dt)),
                                 atol, rtol)
            check(ok, f"nbb case {(M, K, N)} {dt_name}: max err {err} "
                      f"(atol {atol}, rtol {rtol})")
            worst[dt_name] = max(worst.get(dt_name, 0.0), err)
    check(used == {0, 1, 2}, f"cases ran instances {used}, not all three")
    try:
        nbb.nbb_matmul(a, b.t())
        check(False, "a transposed operand was not refused")
    except ValueError:
        pass
    M, K, N = NBB_BENCH
    a = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
    b = torch.randn((K, N), generator=g, device="cuda").to(torch.bfloat16)
    nbb.launches = 0
    out = ops.nbb_matmul(a, b, bm=256, bn=256, bk=512)
    torch.cuda.synchronize()
    launches = nbb.launches
    check(launches == 1, f"ops.nbb_matmul launched {launches} times")
    err, ok = err_within(out, ref.matmul_ref(a, b), *NBB_BF16)
    check(ok, f"ops.nbb_matmul at {NBB_BENCH}: err {err}")
    print(f"nbb_matmul vs plain: {sum(len(c[4]) for c in NBB_CASES)} cases "
          f"(test shapes; f32 K of 1 and 13 tiles of 32; bf16 rings of 4 "
          f"and 3 slots at 1, S-1, S+1, 2S+1 K steps of 64; ragged 100 x "
          f"40 x 72 and 1500 x 200 x 1544; {M} x {K} x {N} bf16; each "
          f"twice, bit-identical) max err f32 "
          f"{worst['float32']:.3g} (atol 2e-5 or 5e-4 as the reference), "
          f"bf16 {worst['bfloat16']:.3g} (3e-2); entry point "
          f"ops.nbb_matmul {M} x {K} x {N} bf16: {launches} launch, err "
          f"{err:.3g}")
    return max(worst.values()), launches


# B, T, H, Hkv, hd, kwargs, dtype: tests/test_kernels.py:86-104's case and
# the window + softcap GQA case of the card tests in f32; that case again
# in bf16 (96 rows: a ragged second tile), a bf16 window + softcap case
# over 16 key tiles, and smollm's training shape (batch 4 x 1024 tokens,
# 9 / 3 heads) in bf16.  Every element of the output and of each gradient
# must lie within atol + rtol |want| (TRAINABLE_TOL).  f32: the
# reference's 1e-4.  bf16 gradients: rtol 1e-2 (2.5 bf16 steps) of the
# element's own |want|, above atol 2e-2, about one bf16 step (1/64) of
# the first rows' entries (|want| 2-8): there the bf16 rounding of out,
# P and dS moves entries near zero by up to 0.0146 (PERF.md gives the
# readings).  At the training shape the gradient bound must also reject
# the kernel's own gradients with one 64 x 64 tile of late rows x middle
# keys left out (that moves them by 0.26-0.30).
TRAIN_ATTN = dict(B=4, T=1024, H=9, Hkv=3, hd=64)
TRAINABLE_CASES = [
    (1, 128, 2, 2, 64, {}, "float32"),
    (2, 96, 9, 3, 64, {"window": 40, "softcap": 30.0}, "float32"),
    (2, 96, 9, 3, 64, {"window": 40, "softcap": 30.0}, "bfloat16"),
    (1, 1024, 9, 3, 64, {"window": 300, "softcap": 30.0}, "bfloat16"),
    (4, 1024, 9, 3, 64, {}, "bfloat16"),
]
# {dtype: {"out" or "grad": (atol, rtol)}}
TRAINABLE_TOL = {"float32": {"out": (1e-4, 0.0), "grad": (1e-4, 1e-4)},
                 "bfloat16": {"out": (5e-3, 1e-2), "grad": (2e-2, 1e-2)}}


def within(got, want, tol):
    """(max abs err, every element within atol + rtol |want|, the least
    atol that would pass at this rtol)."""
    atol, rtol = tol
    diff = (got.float() - want.float()).abs()
    slack = diff - rtol * want.float().abs()
    return diff.max().item(), bool((slack <= atol).all()), slack.max().item()


def dropped_tile(q, k, v, out, lse, dout, rows: slice, keys: slice):
    """What the gradients lose when a kernel leaves out the tile of query
    ``rows`` x ``keys``, every key visible to every row: the plain
    backward on that tile alone, with the whole rows' out and lse, gives
    (dq of ``rows``, dk and dv of ``keys``)."""
    from repro_torch.kernels import ref
    return ref.flash_attention_bwd_ref(
        q[:, rows], k[:, keys], v[:, keys], out[:, rows], lse[:, :, rows],
        dout[:, rows], causal=False)


def phase_compare_trainable():
    """2d: ``flash_attention_trainable`` on the card, forward and backward
    kernels (one launch of each per call), against the plain versions:
    its output against ``ref.flash_attention_fwd_ref``'s, and its
    gradients against ``ref.flash_attention_bwd_ref`` on the plain
    forward's residuals.  Returns the max abs errors at the training
    shape: (output, gradients)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    torch.backends.cuda.matmul.allow_tf32 = False
    g = torch.Generator(device="cuda").manual_seed(41)
    train = (TRAIN_ATTN["B"], TRAIN_ATTN["T"], {})
    out_err = grad_err = 0.0
    for B, T, H, Hkv, hd, kw, dt_name in TRAINABLE_CASES:
        dt, tol = getattr(torch, dt_name), TRAINABLE_TOL[dt_name]
        q, k, v = (torch.randn(shape, generator=g, device="cuda").to(dt)
                   for shape in ((B, T, H, hd), (B, T, Hkv, hd),
                                 (B, T, Hkv, hd)))
        gout = torch.randn((B, T, H, hd), generator=g, device="cuda").to(dt)
        leaves = [t.clone().requires_grad_(True) for t in (q, k, v)]
        before = (fa.launches, fa.bwd_launches)
        out = ops.flash_attention_trainable(*leaves, **kw)
        grads = torch.autograd.grad(out, leaves, gout)
        torch.cuda.synchronize()
        label = f"trainable {(B, T, H, Hkv, hd, kw)} {dt_name}"
        check((fa.launches - before[0], fa.bwd_launches - before[1])
              == (1, 1), f"{label}: not one forward and one backward launch")
        want_out, lse = ref.flash_attention_fwd_ref(q, k, v, **kw)
        want = ref.flash_attention_bwd_ref(q, k, v, want_out, lse, gout, **kw)
        at_train = dt_name == "bfloat16" and (B, T, kw) == train
        errs, failed = [], []
        for name, a, b in zip(("out", "dq", "dk", "dv"),
                              (out.detach(),) + grads, (want_out,) + want):
            atol, rtol = tol["out" if name == "out" else "grad"]
            err, ok, least = within(a, b, (atol, rtol))
            if not ok:
                failed.append(f"{name}: max err {err} beyond atol {atol} + "
                              f"rtol {rtol} |want| (needs atol {least:.3g})")
            errs.append(f"{name} {err:.3g} (max|want| "
                        f"{b.float().abs().max().item():.3g}; atol {atol} "
                        f"rtol {rtol}: least atol at that rtol {least:.3g})")
            if at_train and name == "out":
                out_err = err
            elif at_train:
                grad_err = max(grad_err, err)
        if at_train:
            rows, keys = slice(T - 64, T), slice(T // 2 - 64, T // 2)
            lost = dropped_tile(q, k, v, want_out, lse, gout, rows, keys)
            caught = []
            for name, a, b, part, where in zip(("dq", "dk", "dv"), grads,
                                               want, lost, (rows, keys, keys)):
                bad = a.float().clone()
                bad[:, where] -= part.float()
                err, ok, least = within(bad, b, tol["grad"])
                if ok:
                    failed.append(f"the bound passes {name} with one 64 x 64 "
                                  f"tile left out (max err {err})")
                caught.append(f"{name} {err:.3g} (least atol {least:.3g})")
            errs.append(f"rows {T - 64}-{T - 1} x keys {T // 2 - 64}-"
                        f"{T // 2 - 1} left out: max err "
                        + ", ".join(caught))
        print(f"flash_attention_trainable (forward + backward kernels) vs "
              f"plain, B={B} T={T} H={H} Hkv={Hkv} hd={hd} {kw} {dt_name}: "
              + "; ".join(errs))
        check(not failed, f"{label}: " + "; ".join(failed))
    return out_err, grad_err


# ---------------------------------------------------------------------------
# Phases 3 and 4: the paged and dense main paths at full width
# ---------------------------------------------------------------------------
def full_width_model(arch: str = "smollm-135m"):
    """``arch`` at full width on the card, random weights from seed 0,
    with a count of model forwards: [all, one-token decode forwards]."""
    import torch
    from repro_torch.configs import get_config
    from repro_torch.models.model import build_model
    cfg = get_config(arch)
    model = build_model(cfg)                          # cuda by default
    params = model.init(torch.Generator(device="cuda").manual_seed(0))
    forwards = [0, 0]
    fwd = model.forward

    def counted_forward(params, tokens, *a, **kw):
        forwards[0] += 1
        forwards[1] += tokens.shape[1] == 1
        return fwd(params, tokens, *a, **kw)

    model.forward = counted_forward
    return model, params, forwards


def main_workload(vocab: int):
    """4 clients x 4 requests: even requests a random prompt of 40-480
    tokens, odd ones a shared 240-token system prompt + 16 user tokens."""
    import numpy as np
    rng = np.random.default_rng(1234)
    system = rng.integers(0, vocab, 240)
    prompts = {}
    for c in range(4):
        for r in range(4):
            if r % 2 == 0:
                prompts[c, r] = rng.integers(0, vocab,
                                             int(rng.integers(40, 481)))
            else:
                prompts[c, r] = np.concatenate(
                    [system, rng.integers(0, vocab, 16)])
    return prompts


def serve_run(eng, prompts, max_tokens: int, forwards, smi: str,
              label: str):
    """Serve ``prompts`` ({(client, r): tokens}) with one thread per
    client session, every kernel counter set to 0 just before and read
    just after.  Checks every stream, that every flash launch took the
    tensor-core instance and no paged launch the CUDA-core route; returns
    (launches {kernel: n}, model forwards, wall s, tok/s, TTFT p50 ms)."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    vocab = eng.model.cfg.vocab_size
    clients = sorted({c for c, _ in prompts})
    results, errors = {}, []

    def client(c: int) -> None:
        try:
            with eng.connect(c) as session:
                rs = sorted(r for cc, r in prompts if cc == c)
                hs = [session.submit_i(prompts[c, r], max_tokens=max_tokens)
                      for r in rs]
                for r, h in zip(rs, hs):
                    results[c, r] = (list(h.tokens(timeout_s=600)),
                                     h.response)
        except Exception as exc:        # noqa: BLE001 — reported below
            errors.append(repr(exc))

    fa.launches = fa.simt_launches = 0
    pa.launches = pa.combine_launches = pa.simt_launches = 0
    pa.ring_launches = 0
    forwards[0] = forwards[1] = 0
    thread = eng.start()
    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=900)
    torch.cuda.synchronize()
    dt = time.monotonic() - t0
    launches = {"flash_attention": fa.launches,
                "paged_attention": pa.launches,
                "paged_combine": pa.combine_launches,
                "paged_ring": pa.ring_launches}
    simt = fa.simt_launches
    paged_simt = pa.simt_launches
    n_fwd = forwards[0]
    eng.stop()
    thread.join(timeout=30)
    check(not any(t.is_alive() for t in threads), f"{label}: a client hung")
    check(not errors, f"{label}: client errors: {errors}")
    check(eng.dead is None, f"{label}: engine died: {eng.dead}")
    fr = eng.fault_report()
    check(fr["tick_failures"] == 0 and fr["requests_failed"] == 0,
          f"{label}: the tick watchdog caught {fr['tick_failures']} "
          f"exceptions, {fr['requests_failed']} requests failed")
    check(simt == 0, f"{label}: {simt} flash launches took the CUDA-core "
                     "instance, not the tensor-core one")
    check(paged_simt == 0, f"{label}: {paged_simt} paged launches took the "
                           "CUDA-core route, not split-KV or tensor-core")
    n_req = len(prompts)
    check(len(results) == n_req and eng.stats["served"] == n_req,
          f"{label}: served {eng.stats['served']} of {n_req}")
    ttft, n_tok = [], 0
    for (c, r), (stream, resp) in sorted(results.items()):
        out = list(map(int, resp.tokens_out))
        check(len(out) == max_tokens,
              f"{label} request {c}/{r}: {len(out)} tokens")
        check(all(0 <= t < vocab for t in out),
              f"{label} request {c}/{r}: token out of range")
        check(sorted(p for p, _ in stream) == list(range(max_tokens)),
              f"{label} request {c}/{r}: stream not exactly-once")
        check([t for _, t in sorted(stream)] == out,
              f"{label} request {c}/{r}: stream disagrees with tokens_out")
        ttft.append(resp.first_token_t - resp.submit_t)
        n_tok += len(out)
    ttft_ms = 1e3 * statistics.median(ttft)
    print(f"{label}: {n_req} requests served in {dt:.2f} s, "
          f"{n_tok / dt:.1f} tok/s, TTFT p50 {ttft_ms:.0f} ms, forwards "
          f"{n_fwd} ({1e3 * dt / max(n_fwd, 1):.1f} ms of wall time each), "
          f"launches flash_attention {launches['flash_attention']} "
          f"paged_attention {launches['paged_attention']} (combine "
          f"{launches['paged_combine']}) [{smi}]")
    print(f"  {label} stats: {eng.stats}")
    return launches, n_fwd, dt, n_tok / dt, ttft_ms


def phase_serve(model, params, forwards, smi: str):
    """The paged main path: ``slot_paged``, 16 requests, 32 tokens each;
    the paged kernel launched 30 times per forward, flash never."""
    from repro_torch.serve.engine import ServeEngine
    cfg = model.cfg
    eng = ServeEngine(model, params, max_batch=8, max_len=1024,
                      n_clients=4, pool_pages=512, page_size=16,
                      scheduler="slot_paged", chunk_tokens=64, k_max=8)
    kv_mb = 2 * eng.pool.store_k.numel() * eng.pool.store_k.element_size()
    print(f"paged main path: smollm-135m (30 layers, d=576, 9/3 heads, "
          f"vocab 49152, bf16) slot_paged, pool {kv_mb / 1e6:.0f} MB of K/V")
    launches, n_fwd, *_ = serve_run(eng, main_workload(cfg.vocab_size), 32,
                                    forwards, smi, "slot_paged")
    check(n_fwd > 0 and launches["paged_attention"]
          == cfg.num_layers * n_fwd,
          f"paged_attention launches {launches['paged_attention']} != "
          f"{cfg.num_layers} x {n_fwd} forwards")
    check(launches["flash_attention"] == 0, "slot_paged launched flash")
    # Each decode forward's 30 passes take the split route and one
    # combine each; the T=64 chunks none.
    check(forwards[1] > 0 and launches["paged_combine"]
          == cfg.num_layers * forwards[1],
          f"paged combine launches {launches['paged_combine']} != "
          f"{cfg.num_layers} x {forwards[1]} decode forwards")
    check(eng.stats["prefix_hits"] > 0, "the shared prefix never hit")
    print(f"  prefix_hits {eng.stats['prefix_hits']}, "
          f"prefill_tokens_saved {eng.stats['prefill_tokens_saved']}")
    return launches["paged_attention"]


def phase_serve_olmoe(smi: str):
    """3f: ``olmoe-1b-7b`` at full width (16 layers, d=2048, 16/16 heads
    of 128, 64 experts top-8, vocab 50304, bf16, seed-0 weights) under
    ``slot_paged`` on the main workload's 16 requests: every stream
    complete and exactly-once, paged launches = 16 x forwards, combines =
    16 x one-token forwards, no flash, no CUDA-core route, no watchdog
    catch; then where a decode block's and a chunk's time goes.  Returns
    the paged launches."""
    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    t0 = time.monotonic()
    model, params, forwards = full_width_model("olmoe-1b-7b")
    torch.cuda.synchronize()
    cfg = model.cfg
    # ModelConfig.param_count leaves out the 2 L + 1 norm vectors.
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    want = cfg.param_count() + (2 * cfg.num_layers + 1) * cfg.d_model
    check(n_params == want, f"olmoe params {n_params} != {want}")
    eng = ServeEngine(model, params, max_batch=8, max_len=1024,
                      n_clients=4, pool_pages=512, page_size=16,
                      scheduler="slot_paged", chunk_tokens=64, k_max=8)
    kv_mb = 2 * eng.pool.store_k.numel() * eng.pool.store_k.element_size()
    print(f"olmoe main path: olmoe-1b-7b ({cfg.num_layers} layers, "
          f"d={cfg.d_model}, {cfg.num_heads}/{cfg.num_kv_heads} heads of "
          f"{cfg.head_dim_}, {cfg.moe.num_experts} experts top-"
          f"{cfg.moe.top_k}, vocab {cfg.vocab_size}, bf16, {n_params} "
          f"params drawn in {time.monotonic() - t0:.1f} s) slot_paged, pool "
          f"{kv_mb / 1e6:.0f} MB of K/V, device memory "
          f"{torch.cuda.memory_allocated() / 1e9:.2f} GB")
    launches, n_fwd, *_ = serve_run(eng, main_workload(cfg.vocab_size), 32,
                                    forwards, smi, "olmoe slot_paged")
    L = cfg.num_layers
    check(n_fwd > 0 and launches["paged_attention"] == L * n_fwd,
          f"olmoe: paged launches {launches['paged_attention']} != {L} x "
          f"{n_fwd} forwards")
    check(forwards[1] > 0 and launches["paged_combine"] == L * forwards[1],
          f"olmoe: combine launches {launches['paged_combine']} != {L} x "
          f"{forwards[1]} decode forwards")
    check(launches["flash_attention"] == 0, "olmoe slot_paged launched "
                                            "flash")
    print(f"  olmoe: forwards {n_fwd} ({forwards[1]} one-token), "
          f"prefix_hits {eng.stats['prefix_hits']}, peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")
    del eng
    phase_split(model, params, smi, m=OLMOE)
    return launches["paged_attention"]


# gemma3-27b at full width (3g).  max_len 4096, not 2048: a prompt of
# 1100-1500 tokens is bucketed to 2048 positions, and 2048 + 32 new
# tokens would fail the engine's oversize check at max_len 2048.  The
# dense schedulers still account each admitted sequence's bucketed
# prompt and budget in the page pool (as the reference's do): 320 pages
# of 16 cover the 4800 tokens of 3g's four requests (2.6 GB).
GEMMA_SERVE = dict(max_batch=4, max_len=4096, chunk_tokens=64, k_max=8,
                   pool_pages=320, page_size=16)


def gemma_workload(vocab: int, lengths):
    """One request per client: a random prompt of each length."""
    import numpy as np
    rng = np.random.default_rng(4321)
    return {(c, 0): rng.integers(0, vocab, n)
            for c, n in enumerate(lengths)}


def phase_serve_gemma(smi: str):
    """3g: ``gemma3-27b`` at full width (62 layers: 10 superblocks of 5
    local layers with a 1024-token window and one global layer, then 2
    local; d=5376, 32/16 heads of 128, vocab 262144, bf16, seed-0 weights
    drawn on the card a layer at a time; no cut).  ``slot_chunked`` (its
    launcher's fallback: not pageable) serves 4 requests, two with
    prompts of 1100-1500 tokens so every local ring wraps in prefill and
    decode, two of 40-480: every stream complete and exactly-once, paged
    launches = 62 x forwards, combines = 62 x one-token forwards, no
    CUDA-core route, no watchdog catch.  ``slot_fused`` serves 2
    requests, one prompt past 1024: flash carries the unwrapped prefill
    layers, the paged ring bound the wrapped ones.  Then where a decode
    block's and a chunk's time goes, and the peak device memory.
    Returns (paged launches, of them under the ring bound)."""
    import gc

    import torch
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.train import tree
    gc.collect()
    torch.cuda.empty_cache()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.monotonic()
    model, params, forwards = full_width_model("gemma3-27b")
    torch.cuda.synchronize()
    cfg = model.cfg
    per, nsb, tail = model._gemma_plan()
    check((per, nsb, tail) == (5, 10, 2), f"gemma plan {(per, nsb, tail)}")
    n_params = sum(t.numel() for t in tree.flatten(params)[0])
    L, d, hd = cfg.num_layers, cfg.d_model, cfg.head_dim_
    want = cfg.param_count() + (2 * L + 1) * d + 2 * L * hd   # norms
    check(n_params == want, f"gemma params {n_params} != {want}")
    weights_gb = torch.cuda.memory_allocated() / 1e9
    print(f"gemma main path: gemma3-27b ({L} layers = {nsb} x ({per} local "
          f"+ 1 global) + {tail} local, window {cfg.sliding_window}, "
          f"d={d}, {cfg.num_heads}/{cfg.num_kv_heads} heads of {hd}, vocab "
          f"{cfg.vocab_size}, bf16; {n_params} params drawn in "
          f"{time.monotonic() - t0:.1f} s, {weights_gb:.2f} GB on the card; "
          f"{before / 1e9:.2f} GB held before) [{smi}]")
    long_short = gemma_workload(cfg.vocab_size, (1100, 480, 1500, 40))
    G = L - L // (per + 1)                  # windowed (local) layers
    paged_launches = ring_launches = 0
    for sched, work in (("slot_chunked", long_short),
                        ("slot_fused", gemma_workload(cfg.vocab_size,
                                                      (1100, 300)))):
        eng = ServeEngine(model, params, n_clients=len(work),
                          scheduler=sched, **GEMMA_SERVE)
        check(eng.dense_cache_bytes() == 2 * GEMMA_SERVE["max_batch"]
              * cfg.num_kv_heads * hd * 2
              * (G * cfg.sliding_window + (L - G) * GEMMA_SERVE["max_len"]),
              f"gemma {sched}: dense_cache_bytes {eng.dense_cache_bytes()}")
        torch.cuda.reset_peak_memory_stats()
        launches, n_fwd, *_ = serve_run(eng, work, 32, forwards, smi,
                                        f"gemma {sched}")
        st = eng.stats
        pl, fl = launches["paged_attention"], launches["flash_attention"]
        check(launches["paged_combine"] == L * forwards[1]
              and forwards[1] > 0,
              f"gemma {sched}: combines {launches['paged_combine']} != {L} "
              f"x {forwards[1]} one-token forwards")
        rl = launches["paged_ring"]
        ring_launches += rl
        if sched == "slot_chunked":
            check(fl == 0 and n_fwd > 0 and pl == L * n_fwd
                  and rl == G * n_fwd,
                  f"gemma slot_chunked: paged launches {pl} != {L} x "
                  f"{n_fwd} forwards, or ring launches {rl} != {G} x "
                  f"{n_fwd} (flash {fl})")
        else:
            # A prefill bucketed past the window wraps the local rings:
            # those layers read through the ring bound, the global ones
            # through flash; an unwrapped prefill is flash throughout.
            wrapped = sum(eng._bucket(len(p)) > cfg.sliding_window
                          for p in work.values())
            check(st["prefills"] == len(work) and wrapped == 1
                  and fl == L * st["prefills"] - G * wrapped
                  and pl == G * wrapped + L * st["decode_steps"]
                  and rl == G * (wrapped + st["decode_steps"]),
                  f"gemma slot_fused: flash {fl}, paged {pl}, prefills "
                  f"{st['prefills']}, decode steps {st['decode_steps']}")
        paged_launches += pl
        print(f"  gemma {sched}: forwards {n_fwd} ({forwards[1]} one-token), "
              f"ring launches {rl}, "
              f"dense cache {eng.dense_cache_bytes() / 1e9:.2f} GB, peak "
              f"device memory {torch.cuda.max_memory_allocated() / 1e9:.2f} "
              f"GB")
        del eng
        gc.collect()        # the engine's sessions hold it in a cycle
        torch.cuda.empty_cache()
    phase_split_gemma(model, params, smi)
    return paged_launches, ring_launches


def phase_split_gemma(model, params, smi: str):
    """gemma3-27b's dense rings (slot_chunked): one K=8 decode block and
    one T=64 chunk at B=4, every row past the window (positions
    1100-2000), so every local layer reads its ring with wrap-around."""
    import torch
    vocab, B, C = model.cfg.vocab_size, GEMMA_SERVE["max_batch"], 64
    g = torch.Generator(device="cuda").manual_seed(6)
    caches = model.init_cache(B, GEMMA_SERVE["max_len"])
    for t in _leaves(caches):
        t.copy_(torch.randn(t.shape, generator=g, device="cuda"))
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(1100, 2001, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    chunk = torch.randint(0, vocab, (B, C), generator=g, device="cuda").to(
        torch.int32)
    nval = torch.full((B,), C, **i32)
    torch.cuda.reset_peak_memory_stats()
    profile_split((
        ("gemma3-27b slot_chunked decode block K=8 B=4", 8,
         lambda: model.decode_loop(params, caches, cur, pos, rem, eos, k=8,
                                   max_len=GEMMA_SERVE["max_len"])),
        ("gemma3-27b slot_chunked prefill chunk T=64 B=4", 1,
         lambda: model.prefill_chunk_into(params, caches, chunk, pos,
                                          nval))), smi)
    print(f"  gemma time split: peak device memory "
          f"{torch.cuda.max_memory_allocated() / 1e9:.2f} GB")


def _leaves(tree):
    if isinstance(tree, dict):
        return [t for v in tree.values() for t in _leaves(v)]
    return [tree]


def phase_serve_dense(model, params, forwards, smi: str):
    """The dense main path: ``slot_fused`` on the same 16 requests (flash
    launches = 30 x prefills, paged = 30 x decode steps), then 4 requests
    each under ``slot_chunked`` (paged only) and ``wave`` (flash only).
    Returns the slot_fused run's launches."""
    from repro_torch.serve.engine import ServeEngine
    L = model.cfg.num_layers
    prompts = main_workload(model.cfg.vocab_size)
    few = {k: p for k, p in prompts.items() if k[0] < 2 and k[1] < 2}
    kw = dict(max_batch=4, max_len=1024, page_size=16, pool_pages=256,
              k_max=8)
    fused_launches = None
    for sched, work, extra in (("slot_fused", prompts, {}),
                               ("slot_chunked", few, {"chunk_tokens": 64}),
                               ("wave", few, {})):
        eng = ServeEngine(model, params, n_clients=4, scheduler=sched,
                          **kw, **extra)
        launches, n_fwd, *_ = serve_run(eng, work, 32, forwards, smi, sched)
        st = eng.stats
        fl, pl = launches["flash_attention"], launches["paged_attention"]
        # Every one-token decode forward ends its 30 paged (split-route)
        # passes in a combine; chunks and flash prefills have none, nor
        # the wave's flash decode.
        want_combine = 0 if sched == "wave" else L * forwards[1]
        check(launches["paged_combine"] == want_combine
              and (pl == 0 or forwards[1] > 0),
              f"{sched}: paged combine launches "
              f"{launches['paged_combine']} != {want_combine} ({L} x "
              f"{forwards[1]} decode forwards)")
        if sched == "slot_fused":
            check(fl == L * st["prefills"] and st["prefills"] == len(work),
                  f"slot_fused: flash launches {fl} != {L} x "
                  f"{st['prefills']} prefills")
            check(pl > 0 and pl == L * st["decode_steps"]
                  and n_fwd == st["prefills"] + st["decode_steps"],
                  f"slot_fused: paged launches {pl} != {L} x "
                  f"{st['decode_steps']} decode steps")
            fused_launches = launches
        elif sched == "slot_chunked":
            check(fl == 0 and pl == L * n_fwd and pl > 0,
                  f"slot_chunked: launches {launches}, forwards {n_fwd}")
        else:
            check(pl == 0 and fl == L * n_fwd
                  and n_fwd == st["prefills"] + st["decode_steps"],
                  f"wave: launches {launches}, forwards {n_fwd}")
        del eng
    return fused_launches


# ---------------------------------------------------------------------------
# Phases 3b and 4b: where one dispatch's time goes
# ---------------------------------------------------------------------------
def profile_split(cases, smi: str):
    """For each (name, model forwards, fn): wall time of one call after a
    warm-up (mean of 3), against the device time the profiler attributes
    to it — the device's busy and idle shares (device-side rows only:
    ``kernel_rows``), each kernel's part, and the top device ops."""
    import torch
    from torch.profiler import ProfilerActivity, profile

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
        rows = kernel_rows(prof)
        busy = sum(dev_us(e) for e in rows) / 1e3
        every_row = sum(dev_us(e) for e in prof.key_averages()) / 1e3
        if busy == 0:
            print(f"time split, {name}: wall {wall:.2f} ms; device time "
                  f"not measured (the profiler saw no device activity) "
                  f"[{smi}]")
            continue
        check(not any("flash_" in e.key and "_simt" in e.key for e in rows),
              f"time split, {name}: a CUDA-core flash kernel ran")
        check(not any("paged_simt" in e.key for e in rows),
              f"time split, {name}: the CUDA-core paged kernel ran")
        kern = {k: sum(dev_us(e) for e in rows if needle in e.key) / 1e3
                for k, needle in (("flash_attention", "flash_fwd_tc"),
                                  ("paged_attention", "paged_"))}
        top = sorted(rows, key=dev_us, reverse=True)[:5]
        ranges = range_ms(prof)
        print(f"time split, {name}: wall {wall:.2f} ms "
              f"({wall / steps:.2f} ms per forward), device busy "
              f"{busy:.3f} ms (idle share {1 - busy / wall:.3f}; every "
              f"profiler row summed: {every_row:.3f} ms), "
              f"flash_attention {kern['flash_attention']:.3f} ms, "
              f"paged_attention {kern['paged_attention']:.3f} ms"
              + "".join(f", range {k} {v:.3f} ms"
                        for k, v in sorted(ranges.items()) if v)
              + "; top device ops: "
              + "; ".join(f"{e.key[:48]} {dev_us(e) / 1e3:.3f} ms"
                          for e in top) + f" [{smi}]")


def phase_split(model, params, smi: str, m=MAIN):
    """The paged path: one K=8 decode block and one T=64 prefill chunk at
    its shapes (``m``; B=8, lengths 65..512)."""
    import torch
    vocab = model.cfg.vocab_size
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
    name = model.cfg.name
    profile_split((
        (f"{name} slot_paged decode block K=8", 8,
         lambda: model.decode_loop(params, caches, cur, pos, rem, eos, k=8,
                                   max_len=1024)),
        (f"{name} slot_paged prefill chunk T=64", 1,
         lambda: model.prefill_chunk_into(params, caches, chunk, start,
                                          nval))), smi)


def phase_split_dense(model, params, smi: str):
    """The dense path (slot_fused): one B=1 monolithic prefill of 256 and
    of 512 tokens (flash), and one K=8 decode block at B=4 over a dense
    [4, 1024] ring with lengths 65..512 (paged kernel over identity
    pages)."""
    import torch
    d, vocab = DENSE, model.cfg.vocab_size
    B = d["B"]
    g = torch.Generator(device="cuda").manual_seed(4)
    rk, rv = dense_ring(torch, B, seed=5)
    caches = {"k": rk, "v": rv}
    i32 = dict(dtype=torch.int32, device="cuda")
    pos = torch.randint(65, 513, (B,), generator=g, device="cuda").to(
        torch.int32)
    cur = torch.randint(0, vocab, (B,), generator=g, device="cuda").to(
        torch.int32)
    rem, eos = torch.full((B,), 1000, **i32), torch.full((B,), -1, **i32)
    prompts = {T: torch.randint(0, vocab, (1, T), generator=g,
                                device="cuda").to(torch.int32)
               for T in (256, 512)}
    profile_split((
        ("slot_fused prefill B=1 T=256", 1, lambda: model.prefill(
            params, prompts[256], d["size"])),
        ("slot_fused prefill B=1 T=512", 1, lambda: model.prefill(
            params, prompts[512], d["size"])),
        ("slot_fused decode block K=8 B=4", 8, lambda: model.decode_loop(
            params, caches, cur, pos, rem, eos, k=8, max_len=d["size"]))),
        smi)


# ---------------------------------------------------------------------------
# Phases 3c-3e: the robustness paths of slot_paged at full width
# ---------------------------------------------------------------------------
# smollm-135m's slot_paged geometry for the three robustness runs; the
# overload run's pool of 128 pages (47 MB of K/V) is what forces
# preemption.
ROBUST = dict(max_len=1024, page_size=16, chunk_tokens=64, k_max=8)
RAISING_SITES = ("engine.dispatch", "engine.sync", "transport.stall")
FAULT_SITES = ("engine.dispatch", "engine.sync", "pool.page_write",
               "pool.claim", "pool.extend", "transport.recv",
               "transport.send_burst", "transport.stall")


def zero_counts(forwards):
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    fa.launches = fa.simt_launches = 0
    pa.launches = pa.combine_launches = pa.simt_launches = 0
    forwards[0] = forwards[1] = 0


def read_counts(forwards, label: str, L: int):
    """The launches since ``zero_counts``; checks that the paged kernel
    ran 30 times per forward (one combine per layer of each one-token
    decode forward), flash never, and no CUDA-core route."""
    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import paged_attention as pa
    torch.cuda.synchronize()
    got = dict(paged=pa.launches, combine=pa.combine_launches,
               flash=fa.launches, simt=pa.simt_launches + fa.simt_launches,
               forwards=forwards[0], decode_forwards=forwards[1])
    check(got["forwards"] > 0 and got["paged"] == L * got["forwards"],
          f"{label}: paged launches {got['paged']} != {L} x "
          f"{got['forwards']} forwards")
    check(got["combine"] == L * got["decode_forwards"],
          f"{label}: combine launches {got['combine']} != {L} x "
          f"{got['decode_forwards']} decode forwards")
    check(got["flash"] == 0 and got["simt"] == 0,
          f"{label}: flash launches {got['flash']}, CUDA-core launches "
          f"{got['simt']}")
    return got


def drive_inline(eng, handles, label: str, max_ticks: int = 2000,
                 on_tick=None) -> int:
    """Tick ``eng`` on this thread until every handle is terminal; the
    tick budget is the no-wedge check.  ``on_tick(ticks)`` may submit
    more work (it returns the handles to add)."""
    ticks = 0
    while not all(h.test() for h in handles):
        ticks += 1
        check(ticks < max_ticks, f"{label}: wedged after {ticks} ticks "
              f"({sum(h.test() for h in handles)}/{len(handles)} done)")
        eng.tick()
        if on_tick is not None:
            handles.extend(on_tick(ticks))
    return ticks


def clean_run(eng, label: str) -> None:
    """A run with no fault plan: the watchdog caught nothing and no
    request failed (a real device error cannot hide behind the
    watchdog), the pool drained and its copy ledger balances."""
    fr = eng.fault_report()
    check(fr["tick_failures"] == 0 and fr["requests_failed"] == 0
          and fr["dead"] is None and fr["faults_injected"] == 0,
          f"{label}: fault report {fr}")
    pool = eng.pool
    if eng.prefix_cache is not None:
        eng.prefix_cache.clear()
    check(pool.n_seqs() == 0 and pool.used_pages() == 0,
          f"{label}: pool not drained: {pool.stats()}")
    check(pool.kv_copy_bytes == pool.cow_copy_bytes + pool.swap_in_bytes
          + pool.swap_out_bytes, f"{label}: copy ledger {pool.stats()}")


def tokens_of(h):
    return list(map(int, h.response.tokens_out))


def serve_alone(model, params, prompt, max_tokens: int):
    """One request on a fresh slot_paged engine, no policy: the stream
    a preempted, failed-around or restored request must reproduce."""
    from repro_torch.serve.engine import ServeEngine
    eng = ServeEngine(model, params, max_batch=8, n_clients=1,
                      pool_pages=128, scheduler="slot_paged", **ROBUST)
    h = eng.connect(0).submit_i(prompt, max_tokens=max_tokens)
    drive_inline(eng, [h], "served alone")
    check(h.response.fsm.state.endswith("COMPLETED"),
          f"served alone: {h.response.fsm.state}")
    clean_run(eng, "served alone")
    return tokens_of(h)


def phase_overload(model, params, forwards, smi: str):
    """Overload control with page-swap preemption: 2 priority classes,
    preemption and WFQ, 8 slots over a 128-page pool.  Two low-class
    clients each send 4 requests (400-480 prompt tokens, 64 new), one
    outstanding at a time; once both hold a decoding slot, two
    high-class clients each send 4 requests at once (40-120 prompt
    tokens, 32 new).  Returns the paged launches."""
    import numpy as np
    from repro_torch.serve.engine import ServeEngine
    from repro_torch.serve.overload import OverloadPolicy
    L, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng = np.random.default_rng(2024)
    low = {c: [rng.integers(0, vocab, int(rng.integers(400, 481)))
               for _ in range(4)] for c in (0, 1)}
    high = {c: [rng.integers(0, vocab, int(rng.integers(40, 121)))
                for _ in range(4)] for c in (2, 3)}
    policy = OverloadPolicy(n_classes=2, preemption=True, wfq=True)
    # No prefix cache: its references would keep a parked sequence's
    # prompt pages resident (shared pages never move), and the burst
    # would find the pool full with no victim left to swap.
    eng = ServeEngine(model, params, max_batch=8, n_clients=4,
                      pool_pages=128, scheduler="slot_paged",
                      prefix_cache=False, overload=policy, **ROBUST)
    page_b = eng.pool.page_nbytes
    kv_mb = eng.pool.n_pages * page_b
    print(f"overload: slot_paged, 2 classes, preemption, WFQ, max_batch 8, "
          f"pool 128 pages ({kv_mb / 1e6:.0f} MB of K/V, {page_b} B a "
          f"page), no prefix cache")
    sess = [eng.connect(c) for c in range(4)]
    parked_ids, tables = set(), []
    orig_bt = eng._block_table

    def recording_block_table():
        bt = orig_bt()
        tables.append(int(bt.min()))
        parked_ids.update(p.req.req_id for p in eng._parked)
        return bt
    eng._block_table = recording_block_table
    sent = {c: 0 for c in (0, 1)}
    handles, prompts_of = [], {}
    lows = {}

    def send_low(c):
        h = sess[c].submit_i(low[c][sent[c]], max_tokens=64, priority=1)
        prompts_of[h.req_id] = (low[c][sent[c]], 64)
        lows[c] = h
        sent[c] += 1
        return h
    highs_sent = [False]

    def on_tick(ticks):
        new = []
        for c in (0, 1):
            if lows[c].test() and sent[c] < 4:
                new.append(send_low(c))
        if (not highs_sent[0] and all(
                s.request is not None and s.generated > 0
                and s.request.client_id in (0, 1)
                for s in eng.slots[:2])):
            highs_sent[0] = True
            for c in (2, 3):
                for p in high[c]:
                    h = sess[c].submit_i(p, max_tokens=32, priority=0)
                    prompts_of[h.req_id] = (p, 32)
                    new.append(h)
        return new

    zero_counts(forwards)
    t0 = time.monotonic()
    handles = [send_low(0), send_low(1)]
    ticks = drive_inline(eng, handles, "overload", on_tick=on_tick)
    dt = time.monotonic() - t0
    got = read_counts(forwards, "overload", L)
    st = eng.stats
    check(highs_sent[0] and len(handles) == 16, "overload: the high-class "
          f"burst never came ({len(handles)} requests)")
    check(all(h.response.fsm.state.endswith("COMPLETED") for h in handles),
          "overload: not every request completed: "
          + str([h.response.fsm.state for h in handles]))
    check(st["preemptions"] >= 1, "overload: no preemption")
    check(st["resumes"] == st["preemptions"] and not eng._parked,
          f"overload: {st['resumes']} resumes of {st['preemptions']} "
          "preemptions")
    check(st["swap_out_bytes"] > 0 and st["swap_out_bytes"] % page_b == 0
          and st["swap_in_bytes"] % page_b == 0,
          f"overload: swap bytes {st['swap_out_bytes']} / "
          f"{st['swap_in_bytes']} not whole pages of {page_b} B")
    check(min(tables) >= 0, "overload: a dispatched block table held a "
          "negative page")
    clean_run(eng, "overload")
    ttft = eng.class_ttft()
    print(f"overload: 16 requests in {ticks} ticks, {dt:.2f} s; "
          f"preemptions {st['preemptions']}, resumes {st['resumes']}, "
          f"swap out {st['swap_out_bytes']} B ({st['swap_out_bytes'] // page_b}"
          f" pages), swap in {st['swap_in_bytes']} B, host_syncs "
          f"{st['host_syncs']}, {len(tables)} dispatched block tables, none "
          f"negative; TTFT p50 high {ttft[0]['p50_ms']:.0f} ms (n="
          f"{ttft[0]['n']}), low {ttft[1]['p50_ms']:.0f} ms (n="
          f"{ttft[1]['n']}); launches paged {got['paged']} (combine "
          f"{got['combine']}) over {got['forwards']} forwards [{smi}]")
    by_id = {h.req_id: h for h in handles}
    for rid in sorted(parked_ids):
        prompt, n = prompts_of[rid]
        check(tokens_of(by_id[rid]) == serve_alone(model, params, prompt, n),
              f"overload: preempted request {rid}'s stream differs from "
              "the same request served alone")
    print(f"overload: {len(parked_ids)} preempted requests' streams "
          "byte-identical to each served alone")
    return got["paged"]


def phase_faults(model, params, forwards, smi: str):
    """``FaultPlan.sweep(8, seed=0)`` over the sites the engine probes on
    this path, each plan a run of 4 requests with ``tick_retries=1``:
    every request ends in tokens or a typed terminal, nothing wedges,
    every failure is an injected fault, and the survivors' streams equal
    the run with no fault.  Returns the paged launches of all 9 runs."""
    import numpy as np
    from repro_torch.core.faults import FaultPlan
    from repro_torch.serve.engine import FailedStatus, ServeEngine
    L, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng = np.random.default_rng(77)
    prompts = [rng.integers(0, vocab, int(rng.integers(40, 201)))
               for _ in range(4)]

    def run(plan):
        eng = ServeEngine(model, params, max_batch=4, n_clients=2,
                          pool_pages=128, scheduler="slot_paged",
                          fault_plan=plan, tick_retries=1, **ROBUST)
        sess = [eng.connect(c) for c in range(2)]
        hs = [sess[i % 2].submit_i(p, max_tokens=24)
              for i, p in enumerate(prompts)]
        drive_inline(eng, hs, f"faults {plan}")
        return eng, hs

    total = 0
    zero_counts(forwards)
    ref_eng, ref_h = run(None)
    total += read_counts(forwards, "faults (no plan)", L)["paged"]
    clean_run(ref_eng, "faults (no plan)")
    ref = [tokens_of(h) for h in ref_h]
    check(all(len(t) == 24 for t in ref), "faults: the no-fault run")
    lines = []
    for plan in FaultPlan.sweep(8, seed=0, sites=FAULT_SITES):
        zero_counts(forwards)
        eng, hs = run(plan)
        total += read_counts(forwards, f"faults {plan.name}", L)["paged"]
        fr = eng.fault_report()
        check(eng.dead is None, f"faults {plan.name}: engine died")
        raised = sum(s in RAISING_SITES for s in plan.fired)
        check(fr["tick_failures"] == raised,
              f"faults {plan.name}: the watchdog caught "
              f"{fr['tick_failures']} exceptions, {raised} injected "
              f"({plan.fired})")
        refused = sum(s in ("pool.claim", "pool.extend")
                      for s in plan.fired)
        survived = 0
        for h, want in zip(hs, ref):
            r = h.response
            if r.fsm.state.endswith("COMPLETED"):
                check(tokens_of(h) == want,
                      f"faults {plan.name}: a survivor's stream differs")
                survived += 1
            elif isinstance(r.status, FailedStatus):
                check("injected fault" in r.status.reason
                      or "poisoned page write" in r.status.reason,
                      f"faults {plan.name}: failure not injected: "
                      f"{r.status.reason}")
            else:
                check(r.fsm.state.endswith("CANCELLED") and refused > 0,
                      f"faults {plan.name}: {r.fsm.state} with no "
                      "injected refusal")
        pool = eng.pool
        eng.prefix_cache.clear()
        check(pool.n_seqs() == 0
              and pool.used_pages() == len(pool.quarantined),
              f"faults {plan.name}: pool not drained")
        lines.append(f"{plan.name} fired {plan.fired}: {survived}/4 "
                     f"survived, {fr['requests_failed']} failed, "
                     f"{eng.stats['rejected']} rejected, "
                     f"{fr['tick_failures']} watchdog catches")
    print("faults: 8 plans x 4 requests, every survivor byte-identical to "
          "the no-fault run, every failure injected:\n  "
          + "\n  ".join(lines) + f"\n  paged launches {total} [{smi}]")
    return total


def phase_recovery(model, params, forwards, smi: str):
    """Crash recovery: snapshots every 2 ticks; the engine is abandoned
    at its second tick, its middle one and the one before last, and a
    fresh engine in this process restores from the newest snapshot plus
    the journal and finishes — every stream byte-identical to the
    uninterrupted run.  Returns the paged launches of the 4 runs."""
    import shutil

    import numpy as np
    from repro_torch.serve.engine import ServeEngine
    L, vocab = model.cfg.num_layers, model.cfg.vocab_size
    rng = np.random.default_rng(99)
    prompts = [rng.integers(0, vocab, int(rng.integers(150, 451)))
               for _ in range(4)]
    root = ROOT / "build" / "chip_smoke_snapshots"
    shutil.rmtree(root, ignore_errors=True)

    def make(d):
        return ServeEngine(model, params, max_batch=4, n_clients=2,
                           pool_pages=128, scheduler="slot_paged",
                           snapshot_dir=str(d), snapshot_every=2, **ROBUST)

    def run(d, kill=None):
        eng = make(d)
        sess = [eng.connect(c) for c in range(2)]
        hs = [sess[i % 2].submit_i(p, max_tokens=48)
              for i, p in enumerate(prompts)]
        ticks, info = 0, {}
        while not all(h.test() for h in hs):
            ticks += 1
            check(ticks < 2000, "recovery: wedged")
            eng.tick()
            if ticks == kill:
                for s in sess:
                    s.pump()
                fr = eng.fault_report()
                check(fr["tick_failures"] == 0,
                      f"recovery: fault report {fr}")
                info["snapshot_bytes"] = eng.stats["snapshot_bytes"]
                del eng                 # abandoned: no final snapshot
                eng = make(d)
                t0 = time.perf_counter()
                report = eng.restore_latest()
                info["restore_s"] = time.perf_counter() - t0
                check(report is not None and report["failed"] == 0,
                      f"recovery: restore at tick {kill}: {report}")
                info["report"] = report
                sess = [eng.connect(c, resume=s)
                        for c, s in enumerate(sess)]
        clean_run(eng, f"recovery kill@{kill}")
        return [tokens_of(h) for h in hs], ticks, info, eng

    total = 0
    zero_counts(forwards)
    ref, ticks, _, eng = run(root / "ref")
    total += read_counts(forwards, "recovery (uninterrupted)", L)["paged"]
    snaps, snap_b = eng.stats["snapshots"], eng.stats["snapshot_bytes"]
    check(all(len(t) == 48 for t in ref) and ticks >= 6,
          f"recovery: the uninterrupted run ({ticks} ticks)")
    lines = []
    for kill in sorted({2, ticks // 2, ticks - 1}):
        zero_counts(forwards)
        got, _, info, eng = run(root / f"kill{kill}", kill)
        total += read_counts(forwards, f"recovery kill@{kill}", L)["paged"]
        check(got == ref, f"recovery: kill at tick {kill}: streams differ "
                          "from the uninterrupted run")
        rep = info["report"]
        lines.append(f"kill@{kill}: restored {os.path.basename(rep['path'])}"
                     f" ({info['snapshot_bytes']} B) in "
                     f"{1e3 * info['restore_s']:.1f} ms, resumed "
                     f"{rep['resumed']}, replayed {rep['replayed']}")
    shutil.rmtree(root, ignore_errors=True)
    print(f"recovery: 4 requests, {ticks} ticks, {snaps} snapshots "
          f"(last {snap_b} B); every restored stream byte-identical to "
          "the uninterrupted run:\n  " + "\n  ".join(lines)
          + f"\n  paged launches {total} [{smi}]")
    return total


# ---------------------------------------------------------------------------
# Phase 5: CPU/CUDA parity at float32
# ---------------------------------------------------------------------------
def _scaled(tree, scale: float):
    """Every weight matrix (rank >= 2) times ``scale``, as the parity
    tests' ``smoke_pair(scale=)`` does."""
    if isinstance(tree, dict):
        return {k: _scaled(v, scale) for k, v in tree.items()}
    return tree * scale if tree.dim() >= 2 else tree


def phase_parity():
    """The SMOKE configs at float32, same weights on both devices: greedy
    tokens identical on the CPU and the card; smollm under slot_paged,
    slot_fused and wave, olmoe (weights x3, so its streams vary and its
    expert capacity binds behind idle rows) under slot_paged and
    slot_fused; gemma (weights x3) under slot_chunked and slot_fused
    with prompts of up to 30 tokens and 16-token chunks, so its 8-slot
    local rings wrap in prefill, in chunks and in decode."""
    for arch, scheds, scale in (
            ("smollm-135m", ("slot_paged", "slot_fused", "wave"), 1.0),
            ("olmoe-1b-7b", ("slot_paged", "slot_fused"), 3.0)):
        parity(arch, scheds, scale)
    parity("gemma3-27b", ("slot_chunked", "slot_fused"), 3.0,
           prompt_extra=(0, 12, 23), chunk_tokens=16)


def parity(arch: str, scheds, scale: float, prompt_extra=(0,),
           chunk_tokens: int = 4):
    import numpy as np
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine
    cfg = dataclasses.replace(get_smoke_config(arch), dtype="float32")
    cpu_model = build_model(cfg, device="cpu")
    params = _scaled(cpu_model.init(torch.Generator().manual_seed(7)), scale)

    lengths = [12, 2, 7, 2, 1, 9, 24, 3]
    for sched in scheds:
        seqs = {}
        for dev in ("cpu", "cuda"):
            model = build_model(cfg, device=dev)
            eng = ServeEngine(model, _to_device(params, dev), max_batch=2,
                              max_len=64, n_clients=1, pool_pages=64,
                              page_size=4, chunk_tokens=chunk_tokens,
                              scheduler=sched, device=dev)
            for i, n in enumerate(lengths):
                plen = 5 + i % 3 + prompt_extra[i % len(prompt_extra)]
                check(eng.submit(0, (np.arange(plen) + 3 * i)
                                 % cfg.vocab_size, max_tokens=n)
                      is not None, "intake full")
            while (eng.stats["served"] + eng.stats["rejected"]
                   < len(lengths)):
                eng.step()
            check(eng.stats["rejected"] == 0
                  and eng.fault_report()["tick_failures"] == 0,
                  f"{sched} {dev}: requests rejected or a tick failed")
            got = {}
            for _ in lengths:
                r = eng.get_response(0, timeout_s=30)
                check(bool(r), f"{sched}: parity response timed out")
                got[r.req_id] = list(map(int, r.tokens_out))
            seqs[dev] = [got[k] for k in sorted(got)]
        check(seqs["cpu"] == seqs["cuda"],
              f"{arch} {sched}: CPU and CUDA greedy tokens differ")
        print(f"cpu/cuda parity, {arch} {sched}: "
              f"{sum(map(len, seqs['cuda']))} greedy tokens identical "
              f"(SMOKE, float32, weights x{scale:g})")


# ---------------------------------------------------------------------------
# Phase 8: the interleaving checker on the card machine's host
# ---------------------------------------------------------------------------
CHECK_BUDGET = 1500     # benchmarks/bench_check.py --quick


def phase_checker():
    """The port's checker over the port's core: every scenario explored
    at its own budget (at most 1500 executions, as bench_check's quick
    mode), one line each; a verdict other than the scenario's ``expect``
    fails.  The six schedules of ``tests/schedules/`` replayed in place,
    each failing exactly when it expects a violation.  Then the
    functional bit set on a CUDA tensor against ``HostBitset`` for a
    fixed claim/release sequence."""
    from repro_torch.checker import scenarios
    from repro_torch.core import bitset
    from repro_torch.core import interleave as il
    t0 = time.monotonic()
    for name, scen in scenarios.SCENARIOS.items():
        budget = min(scen.explore_budget, CHECK_BUDGET)
        r = scenarios.explore_scenario(name, max_executions=budget)
        verdict = "pass" if r.ok else "violation"
        cx = r.counterexample
        print(f"  checker {name}: expect {scen.expect}, got {verdict} "
              f"({r.executions} executions, {r.distinct_states} distinct "
              f"states, exhausted {r.exhausted}"
              + ("" if cx is None else f", {cx.error_type} at schedule "
                 f"{list(cx.schedule)}") + ")")
        check(verdict == scen.expect, f"checker {name}: {verdict}, expected "
                                      f"{scen.expect}")
    corpus = sorted((ROOT / "tests" / "schedules").glob("*.json"))
    check(len(corpus) == 6, f"schedule corpus: {len(corpus)} files")
    for path in corpus:
        rec = il.load_schedule(str(path))
        scen = scenarios.get(rec["scenario"])
        res = il.run_schedule(scen.make_world, rec["schedule"],
                              max_steps=scen.max_steps, strict=False)
        check(res.failed == (rec["expect"] == "violation"),
              f"schedule {path.name}: failed={res.failed}, expected "
              f"{rec['expect']} ({res.error!r})")
    print(f"checker: {len(scenarios.SCENARIOS)} scenarios as expected, "
          f"{len(corpus)} schedules replayed as recorded "
          f"({time.monotonic() - t0:.1f} s on the host)")
    host, bits = bitset.HostBitset(40), bitset.init(40, device="cuda")
    ops = [None] * 42 + [3, 33, None, None, 0, None]   # None: claim
    for op in ops:
        if op is None:
            bits, slot = bitset.claim_first_free(bits, 40)
            want = host.try_claim(owner=object())
            check(int(slot) == (-1 if want is None else want),
                  f"bitset claim: cuda {int(slot)}, host {want}")
        else:
            bits = bitset.release(bits, op)
            host.release(op)
            check(not bool(bitset.is_claimed(bits, op)), "bitset release")
        check(int(bitset.count(bits)) == host.count(), "bitset count")
    check(bits.is_cuda, "bitset words left the card")
    print(f"bitset: {len(ops)} claims and releases on a CUDA tensor equal "
          f"HostBitset's (slots, -1 when full, counts)")


# ---------------------------------------------------------------------------
# Phase 6: kernel timing at the main paths' shapes
# ---------------------------------------------------------------------------
def work(q, block, lens, hkv: int, itemsize: int, kv_lens=None):
    """(bytes, flops) the function needs on these inputs: q, out, the
    block table, lens and kv_lens once each, and the K/V of every
    position below each row's key end (min(lens, kv_lens); the timed
    inputs stay inside the table) once per kv head; two hd-long dot
    products per (query head, visible key)."""
    B, T, H, hd = q.shape
    lens_l = [int(x) for x in lens.tolist()]
    kv_l = (lens_l if kv_lens is None
            else [int(x) for x in kv_lens.tolist()])
    ends = [max(0, min(n, k)) for n, k in zip(lens_l, kv_l)]
    kv_bytes = sum(ends) * hkv * hd * 2 * itemsize
    nbytes = (2 * q.numel() * itemsize + kv_bytes + block.numel() * 4
              + len(lens_l) * 4 * (1 if kv_lens is None else 2))
    visible = sum(max(0, min(e, n - T + t + 1)) for n, e in zip(lens_l, ends)
                  for t in range(T))
    return nbytes, 4 * hd * H * visible


def paged_timing_row(label: str, q, views, block, lens, smi: str,
                     kv_lens=None):
    """Device ms of the paged kernel (cycling ``views``, one layer's K/V
    each, so a call finds its K/V out of L2 as the served model does),
    its bound, its plain version, and the gather + SDPA yardstick on the
    same inputs (``kv_lens`` as the served path passes it); printed, and
    returned as (ms, plain, bound, by)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    B, T, H, hd = q.shape
    ps, Hkv = views[0][0].shape[1], views[0][0].shape[2]
    P = block.shape[1]
    S, n = P * ps, len(views)
    kern = lambda i: pa.paged_attention(  # noqa: E731
        q, *views[i % n], block, lens, kv_lens=kv_lens)
    plain = lambda i: ref.paged_attention_ref(  # noqa: E731
        q, *views[i % n], block, lens, kv_lens=kv_lens)

    def gather(i):
        k, v = views[i % n]
        blk = block.long()
        return (k[blk].reshape(B, S, Hkv, hd), v[blk].reshape(B, S, Hkv, hd))

    kg, vg = gather(0)
    q_pos = lens.long()[:, None] - T + torch.arange(T, device="cuda")[None]
    kv_pos = torch.arange(S, device="cuda")[None, None, :]
    mask = kv_pos <= q_pos[:, :, None]
    if kv_lens is not None:
        mask &= kv_pos < kv_lens.long()[:, None, None]
    mask = mask[:, None]                                 # [B,1,T,S]
    g = H // Hkv
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, kg.repeat_interleave(g, dim=2), vg.repeat_interleave(g, dim=2)))
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask)
    before = (pa.launches, pa.combine_launches)
    t_kern = timed(kern)
    t_plain = timed(plain, inner=10)
    t_gather = timed(gather, inner=10)
    t_sdpa = timed(sdpa, inner=10)
    pa.launches, pa.combine_launches = before   # timing is not counted
    nbytes, flops = work(q, block, lens, Hkv, 2, kv_lens)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    way = pa.route(q, *views[0])
    plan = (f", {pa.split_plan(B, Hkv, P, ps)[0]} splits + combine"
            if way == "split" else "")
    kv = "" if kv_lens is None else f", kv_lens {kv_lens.tolist()}"
    print(f"paged_attention {label} (H={H}, Hkv={Hkv}, hd={hd}, ps={ps}, "
          f"P={P}, bf16, lens {lens.tolist()}{kv}; route {way}{plan}): "
          f"kernel "
          f"{t_kern:.4f} ms, bound {bound:.5f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.3f} GFLOP), plain "
          f"{t_plain:.4f} ms; yardstick (not used by the port): gather "
          f"{t_gather:.4f} ms + SDPA on gathered K/V {t_sdpa:.4f} ms "
          f"[{smi}]")
    return t_kern, t_plain, bound, by


def phase_timing_paged(launches: int, max_err: float, smi: str):
    """The paged kernel at the main paths' shapes: slot_paged's T=1
    decode and T=64 chunk (B=8 over the strided layer views of the pool)
    and slot_fused's decode read (B=4 over the [4, 1024] ring as 64-token
    identity pages, lens 65/300/513/1000), then olmoe-1b-7b's T=1 and
    T=64 (hd 128, 16 kv heads, g 1, with kv_lens).  The kernel JSON row
    carries smollm's T=1 decode, the hot shape."""
    import torch
    from repro_torch.models.layers import ring_page_size
    m, d = MAIN, DENSE
    rows = {}
    for T in (1, m["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, seed=100 + T)
        views = [(pk[:, :, li], pv[:, :, li]) for li in range(m["L"])]
        rows[T] = paged_timing_row(f"T={T} B={m['B']}", q, views, block,
                                   lens, smi)
    B, size = d["B"], d["size"]
    ps = ring_page_size(size)
    rk, rv = dense_ring(torch, B, seed=102)
    views = [(rk[li].view(B * size // ps, ps, d["Hkv"], d["hd"]),
              rv[li].view(B * size // ps, ps, d["Hkv"], d["hd"]))
             for li in range(d["L"])]
    block = torch.arange(B * size // ps, dtype=torch.int32,
                         device="cuda").view(B, size // ps)
    lens = torch.tensor([65, 300, 513, 1000], dtype=torch.int32,
                        device="cuda")
    g = torch.Generator(device="cuda").manual_seed(103)
    q = torch.randn((B, 1, d["H"], d["hd"]), generator=g,
                    device="cuda").to(torch.bfloat16)
    paged_timing_row(f"dense-ring decode T=1 B={B}", q, views, block, lens,
                     smi)
    # olmoe-1b-7b's slot_paged shapes, with kv_lens = lens as every row of
    # a served batch that writes passes it.
    m = OLMOE
    for T in (1, m["chunk"]):
        q, pk, pv, block, lens = main_path_inputs(torch, T, 110 + T, m)
        views = [(pk[:, :, li], pv[:, :, li]) for li in range(m["L"])]
        paged_timing_row(f"olmoe T={T} B={m['B']}", q, views, block, lens,
                         smi, kv_lens=lens.clone())
        del q, pk, pv, views
    t_kern, t_plain, bound, by = rows[1]
    return {"name": "paged_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:152",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": None}


def ring_work(q, block, lens, kv_lens, ring: int, window: int, hkv: int,
              itemsize: int):
    """(bytes, flops) a ring read needs on these inputs: q, out, the
    block table, lens and kv_lens once each, and the K/V of the row's
    keys (the positions [max(0, n - ring), n) it still holds, n =
    kv_lens or lens) once per kv head; two hd-long dot products per
    (query head, visible key), query q seeing the positions in [max(lo,
    q - window + 1), min(q, n - 1)]."""
    B, T, H, hd = q.shape
    lens_l = [int(x) for x in lens.tolist()]
    n_l = lens_l if kv_lens is None else [int(x) for x in kv_lens.tolist()]
    held = [min(n, ring) for n in n_l]
    nbytes = (2 * q.numel() * itemsize + sum(held) * hkv * hd * 2 * itemsize
              + block.numel() * 4 + B * 4 * (1 if kv_lens is None else 2))
    visible = 0
    for ln, n in zip(lens_l, n_l):
        lo = max(0, n - ring)
        for t in range(T):
            qp = ln - T + t
            first = max(lo, qp - window + 1) if window else lo
            visible += max(0, min(qp, n - 1) - first + 1)
    return nbytes, 4 * hd * H * visible


def ring_timing_row(label: str, q, views, block, lens, kv_lens, smi: str):
    """Device ms of the paged kernel under the ring bound at gemma's
    local-layer shapes (cycling ``views``, one layer's ring each), its
    bound, its plain version, and the yardstick the port never calls: a
    gather of the ring into position order plus masked SDPA.  Returns
    (ms, plain, bound, by, gather + SDPA ms)."""
    import torch.nn.functional as F
    from repro_torch.kernels import paged_attention as pa
    from repro_torch.kernels import ref
    d = GEMMA
    B, T, H, hd = q.shape
    ring, window, Hkv, n = d["size"], d["window"], d["Hkv"], len(views)
    kw = dict(kv_lens=kv_lens, ring=ring, window=window)
    kern = lambda i: pa.paged_attention(  # noqa: E731
        q, *views[i % n], block, lens, **kw)
    plain = lambda i: ref.paged_attention_ref(  # noqa: E731
        q, *views[i % n], block, lens, **kw)
    gather = lambda i: ref._ring_keys(  # noqa: E731
        q, *views[i % n], block, lens, kv_lens, ring, window)
    kg, vg, mask = gather(0)
    g = H // Hkv
    qt, kt, vt = (x.transpose(1, 2) for x in (
        q, kg.repeat_interleave(g, dim=2), vg.repeat_interleave(g, dim=2)))
    sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
        qt, kt, vt, attn_mask=mask[:, None])
    before = (pa.launches, pa.combine_launches, pa.ring_launches)
    t_kern = timed(kern)
    t_plain = timed(plain, inner=10)
    t_gather = timed(gather, inner=10)
    t_sdpa = timed(sdpa, inner=10)
    pa.launches, pa.combine_launches, pa.ring_launches = before
    nbytes, flops = ring_work(q, block, lens, kv_lens, ring, window, Hkv, 2)
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    way = pa.route(q, *views[0])
    kv = "" if kv_lens is None else f", kv_lens {kv_lens.tolist()}"
    print(f"paged_attention ring bound {label} (ring {ring}, window "
          f"{window}, H={H}, Hkv={Hkv}, hd={hd}, ps={d['ps']}, bf16, lens "
          f"{lens.tolist()}{kv}; route {way}): kernel {t_kern:.4f} ms, "
          f"bound {bound:.5f} ms ({by}: {nbytes / 1e6:.2f} MB, "
          f"{flops / 1e9:.3f} GFLOP), plain {t_plain:.4f} ms; yardstick "
          f"(not used by the port): gather into position order "
          f"{t_gather:.4f} ms + masked SDPA {t_sdpa:.4f} ms [{smi}]")
    return t_kern, t_plain, bound, by, t_gather + t_sdpa


def phase_timing_ring(launches: int, max_err: float, smi: str):
    """The ring bound at gemma3-27b's local-layer shapes: the T=1 decode
    (the dense decode loop passes no kv_lens) and the T=64 chunk (kv_lens
    = lens, as a chunk's write mask gives), B=4, rows at n = 700, 1024,
    1500 and 2047, over 8 layers' rings.  The JSON row carries T=1."""
    import torch
    rows = {}
    for T, with_kv in ((1, False), (GEMMA["chunk"], True)):
        views = [gemma_ring(torch, 200 + i)[:2] for i in range(8)]
        block = gemma_ring(torch, 0)[2]
        q, lens, _ = ring_inputs(torch, T, None, 210 + T, torch.bfloat16)
        rows[T] = ring_timing_row(f"T={T} B={GEMMA['B']}", q, views, block,
                                  lens, lens.clone() if with_kv else None,
                                  smi)
        del views
    t_kern, t_plain, bound, by, lib = rows[1]
    return {"name": "paged_attention_ring", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/paged_attention.cu",
            "replaces": "src/repro/kernels/paged_attention.py:152",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": lib}


def flash_work(B: int, T: int, S: int, H: int, Hkv: int, hd: int,
               itemsize: int):
    """(bytes, flops) causal flash needs on these inputs: q, k, v read
    once and out written once; two hd-long dot products per (query head,
    visible key), a query t seeing keys 0 .. t + S - T."""
    nbytes = (2 * B * T * H * hd + 2 * B * S * Hkv * hd) * itemsize
    visible = B * sum(min(S, t + S - T + 1) for t in range(T))
    return nbytes, 4 * hd * H * visible


def phase_timing_flash(launches: int, max_err: float, smi: str):
    """Flash at the dense main path's shapes: B=1 causal prefills (T=S)
    and the wave's B=4 one-token decode at S=513, bf16, over ring slices
    (the 30 layers' slices are cycled, as the served model reads them);
    then the training shape (B=4, T=S=1024) as training runs it, with the
    log-sum-exp (``flash_attention_fwd``).  The yardstick is one
    ``scaled_dot_product_attention`` call on the same inputs (GQA, causal
    at T == S); the port never calls it."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    d = DENSE
    g = torch.Generator(device="cuda").manual_seed(200)
    rows = {}
    tr = TRAIN_ATTN
    shapes = ([(1, T, T) for T in d["prefill"]] + [(d["B"], 1, d["decode_S"])]
              + [(tr["B"], tr["T"], tr["T"])])
    for B, T, S in shapes:
        rk, rv = dense_ring(torch, B, seed=201 + T)
        views = [(rk[li][:, :S], rv[li][:, :S]) for li in range(d["L"])]
        q = torch.randn((B, T, d["H"], d["hd"]), generator=g,
                        device="cuda").to(torch.bfloat16)
        tviews = [(k.transpose(1, 2), v.transpose(1, 2)) for k, v in views]
        qt = q.transpose(1, 2)
        kern = lambda i: fa.flash_attention(q, *views[i % d["L"]])  # noqa
        if T == tr["T"]:
            kern = lambda i: fa.flash_attention_fwd(  # noqa: E731
                q, *views[i % d["L"]])
        plain = lambda i: ref.flash_attention_ref(  # noqa: E731
            q, *views[i % d["L"]])
        sdpa = lambda i: F.scaled_dot_product_attention(  # noqa: E731
            qt, *tviews[i % d["L"]], is_causal=T > 1, enable_gqa=True)
        before = fa.launches
        t_kern = timed(kern)
        t_plain = timed(plain, inner=10)
        t_sdpa = timed(sdpa, inner=10)
        fa.launches = before                # timing launches are not counted
        nbytes, flops = flash_work(B, T, S, d["H"], d["Hkv"], d["hd"], 2)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        bound = max(t_bytes, t_ops)
        what = ("training shape, with lse" if T == tr["T"]
                else "ring slice")
        print(f"flash_attention B={B} T={T} S={S} (H=9, Hkv=3, hd=64, "
              f"causal, bf16, {what}): kernel {t_kern:.4f} ms "
              f"({flops / t_kern / 1e9:.1f} TFLOP/s), bound "
              f"{bound:.5f} ms ({by}: {nbytes / 1e6:.3f} MB, "
              f"{flops / 1e9:.4f} GFLOP), plain {t_plain:.4f} ms, library "
              f"(SDPA, not used by the port) {t_sdpa:.4f} ms [{smi}]")
        rows[T] = (t_kern, t_plain, bound, by, t_sdpa)
    t_kern, t_plain, bound, by, t_sdpa = rows[256]   # the commonest bucket
    return {"name": "flash_attention", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention.cu",
            "replaces": "src/repro/kernels/flash_attention.py:137",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_sdpa}

NBB_TIMING = ((512, 1024, 512), (4096, 4096, 4096))


def phase_timing_nbb(launches: int, max_err: float, smi: str):
    """The NBB matmul in bf16 at the benchmark's shape and at 4096^3,
    beside its bound (FLOPs at the bf16 tensor-core peak, or a, b and c
    moved once), its plain version and one ``torch.matmul`` (cuBLAS, a
    yardstick the port never calls)."""
    import torch
    from repro_torch.kernels import nbb_matmul as nbb
    from repro_torch.kernels import ref
    g = torch.Generator(device="cuda").manual_seed(300)
    rows = {}
    for M, K, N in NBB_TIMING:
        a = torch.randn((M, K), generator=g, device="cuda").to(torch.bfloat16)
        b = torch.randn((K, N), generator=g, device="cuda").to(torch.bfloat16)
        inner = 50 if M * N * K < 1e9 else 5
        before = nbb.launches
        t_kern = timed(lambda i: nbb.nbb_matmul(a, b), inner=inner)
        t_plain = timed(lambda i: ref.matmul_ref(a, b), inner=inner)
        t_lib = timed(lambda i: torch.matmul(a, b), inner=inner)
        nbb.launches = before               # timing launches are not counted
        flops = 2 * M * N * K
        nbytes = (M * K + K * N + M * N) * 2
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
        by = "bytes" if t_bytes >= t_ops else "operations"
        bound = max(t_bytes, t_ops)
        inst = nbb.instance_for(torch.bfloat16, M, N)
        print(f"nbb_matmul {M} x {K} x {N} bf16 (instance {inst}: tile "
              f"{nbb.TILE[inst]}, {nbb.SLOTS[inst]} slots): kernel "
              f"{t_kern:.4f} ms "
              f"({flops / t_kern / 1e9:.1f} TFLOP/s), bound {bound:.5f} ms "
              f"({by}: {nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), "
              f"plain {t_plain:.4f} ms, library (torch.matmul, not used by "
              f"the port) {t_lib:.4f} ms [{smi}]")
        rows[M] = (t_kern, t_plain, bound, by, t_lib)
    t_kern, t_plain, bound, by, t_lib = rows[NBB_BENCH[0]]
    return {"name": "nbb_matmul", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/nbb_matmul.cu",
            "replaces": "src/repro/kernels/nbb_matmul.py:96",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_lib}


def phase_timing_trainable(launches: int, max_err: float, smi: str):
    """``flash_attention_trainable`` forward + backward at the training
    shape (B=4, T=S=1024, H=9, Hkv=3, hd=64, causal, bf16), beside its
    bound (a flash backward's five products and the forward's two, or
    q, k, v, dout read and out, dq, dk, dv written once), autograd through
    the plain version, and ``scaled_dot_product_attention`` forward +
    backward (a yardstick the port never calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ops, ref
    B, T, H, Hkv, hd = (TRAIN_ATTN[k] for k in ("B", "T", "H", "Hkv", "hd"))
    g = torch.Generator(device="cuda").manual_seed(400)
    q, k, v = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16).requires_grad_(True) for shape in (
        (B, T, H, hd), (B, T, Hkv, hd), (B, T, Hkv, hd)))
    gout = torch.randn((B, T, H, hd), generator=g, device="cuda").to(
        torch.bfloat16)
    qt, kt, vt = (x.detach().transpose(1, 2).requires_grad_(True)
                  for x in (q, k, v))

    def fwd_bwd(fn, leaves, cot):
        return lambda i: torch.autograd.grad(fn(*leaves), leaves, cot)

    before = (fa.launches, fa.bwd_launches)
    t_kern = timed(fwd_bwd(ops.flash_attention_trainable, (q, k, v), gout),
                   inner=10)
    t_plain = timed(fwd_bwd(ref.flash_attention_ref, (q, k, v), gout),
                    inner=10)
    t_sdpa = timed(fwd_bwd(lambda a, b, c: F.scaled_dot_product_attention(
        a, b, c, is_causal=True, enable_gqa=True), (qt, kt, vt),
        gout.transpose(1, 2)), inner=10)
    fa.launches, fa.bwd_launches = before   # timing launches are not counted
    _, fwd_flops = flash_work(B, T, T, H, Hkv, hd, 2)
    flops = fwd_flops * 14 // 4             # + dS, dP, dQ, dK, dV products
    nbytes = 2 * (2 * B * T * H * hd + 2 * B * T * Hkv * hd) * 2
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    print(f"flash_attention_trainable forward + backward B={B} T=S={T} "
          f"(H={H}, Hkv={Hkv}, hd={hd}, causal, bf16): forward + backward "
          f"kernels {t_kern:.4f} ms, bound {bound:.5f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), plain "
          f"{t_plain:.4f} ms, library (SDPA forward + backward, not used by "
          f"the port) {t_sdpa:.4f} ms [{smi}]")
    return {"name": "flash_attention_trainable", "route": "cuda",
            "source": "src/repro_torch/kernels/flash_attention.py",
            "replaces": "src/repro/kernels/flash_attention.py:164",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_sdpa}


def phase_timing_flash_bwd(launches: int, max_err: float, smi: str):
    """The flash backward kernel alone at the training shape, on the
    forward kernel's residuals, beside its bound (five products per
    visible (query, key) pair, or q, k, v, out, dout and lse read and dq,
    dk, dv written once), the plain backward
    (``ref.flash_attention_bwd_ref``) and SDPA's backward alone (its
    forward run once, outside the timing; a yardstick the port never
    calls)."""
    import torch
    import torch.nn.functional as F
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import ref
    B, T, H, Hkv, hd = (TRAIN_ATTN[k] for k in ("B", "T", "H", "Hkv", "hd"))
    g = torch.Generator(device="cuda").manual_seed(500)
    q, k, v, dout = (torch.randn(shape, generator=g, device="cuda").to(
        torch.bfloat16) for shape in ((B, T, H, hd), (B, T, Hkv, hd),
                                      (B, T, Hkv, hd), (B, T, H, hd)))
    before = (fa.launches, fa.bwd_launches)
    out, lse = fa.flash_attention_fwd(q, k, v)
    t_kern = timed(lambda i: fa.flash_attention_bwd(q, k, v, out, lse, dout),
                   inner=20)
    t_plain = timed(lambda i: ref.flash_attention_bwd_ref(
        q, k, v, out, lse, dout), inner=5)
    qt, kt, vt = (x.transpose(1, 2).requires_grad_(True) for x in (q, k, v))
    o = F.scaled_dot_product_attention(qt, kt, vt, is_causal=True,
                                       enable_gqa=True)
    t_sdpa = timed(lambda i: torch.autograd.grad(
        o, (qt, kt, vt), dout.transpose(1, 2), retain_graph=True), inner=20)
    fa.launches, fa.bwd_launches = before   # timing launches are not counted
    _, fwd_flops = flash_work(B, T, T, H, Hkv, hd, 2)
    flops = fwd_flops * 5 // 2              # S, dP, dV, dK, dQ products
    nbytes = (4 * B * T * H * hd + 4 * B * T * Hkv * hd) * 2 + B * H * T * 4
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / PEAK_FLOPS["bfloat16"] * 1e3
    by = "bytes" if t_bytes >= t_ops else "operations"
    bound = max(t_bytes, t_ops)
    print(f"flash_attention_bwd B={B} T=S={T} (H={H}, Hkv={Hkv}, hd={hd}, "
          f"causal, bf16): kernel (dQ pass + dK/dV pass) {t_kern:.4f} ms "
          f"({flops / t_kern / 1e9:.1f} TFLOP/s), bound {bound:.5f} ms ({by}: "
          f"{nbytes / 1e6:.2f} MB, {flops / 1e9:.2f} GFLOP), plain "
          f"{t_plain:.4f} ms, library (SDPA backward, not used by the port) "
          f"{t_sdpa:.4f} ms [{smi}]")
    return {"name": "flash_attention_bwd", "route": "cuda",
            "source": "src/repro_torch/kernels/csrc/flash_attention_bwd.cu",
            "replaces": "src/repro/kernels/flash_attention.py:182",
            "launches": launches, "max_abs_err": max_err, "ms": t_kern,
            "plain_ms": t_plain, "bound_ms": bound, "bound_by": by,
            "library_ms": t_sdpa}


# ---------------------------------------------------------------------------
# Phase 7: training at full width
# ---------------------------------------------------------------------------
TRAIN = dict(steps=20, resume_steps=5, ckpt_every=10)


# The port's profiler ranges (``torch.profiler.record_function``): the
# flash backward, the optimizer, the fill of paged rows that see no key,
# and the expert mixture.
RANGES = ("flash_attention_trainable.backward", "adamw.update",
          "attention.fill_unseen", "moe.block")


def range_ms(prof) -> dict:
    """Device ms of the kernels that ran inside each of ``RANGES``'s
    spans on the device timeline (the range's device-side annotation),
    summed over calls.  ``key_averages`` reports a range's span itself,
    idle gaps between its kernels included (merged with its host-side
    subtree under one key), and a host-side subtree misses kernels
    launched outside an aten op (the flash backward's, through ctypes on
    the autograd thread), so neither is used."""
    from torch.autograd import DeviceType
    dev = [e for e in prof.events() if e.device_type == DeviceType.CUDA]
    kernels = [(e.time_range.start, e.time_range.end) for e in dev
               if e.name not in RANGES]
    out = {}
    for e in dev:
        if e.name in RANGES:
            a, b = e.time_range.start, e.time_range.end
            out[e.name] = out.get(e.name, 0.0) + sum(
                k1 - k0 for k0, k1 in kernels if a <= k0 < b) / 1e3
    return out


def kernel_rows(prof):
    """The profiler's device-side rows (kernels, copies, memsets): each
    device op once.  The host-side rows carry the same device time again
    under the op that launched it, so summing every row counts it twice;
    user ranges are left out too."""
    from torch.autograd import DeviceType
    return [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and e.key not in RANGES]


def phase_train(smi: str):
    """Full-width ``smollm-135m`` through the training launcher, then a
    resume from its checkpoint.  Returns the 20-step run's flash forward
    and backward launches."""
    import shutil

    import torch
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.launch import train as launcher
    from repro_torch.train import checkpoint as ckpt_lib
    ckpt_dir = ROOT / "build" / "chip_smoke_train"
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    B, T = TRAIN_ATTN["B"], TRAIN_ATTN["T"]
    args = ["--arch", "smollm-135m", "--batch", str(B), "--seq", str(T),
            "--remat", "nothing", "--ckpt-every", str(TRAIN["ckpt_every"]),
            "--ckpt-dir", str(ckpt_dir), "--lr", "1e-3",
            "--warmup-steps", "2", "--log-every", "1"]
    print(f"training: smollm-135m (30 layers, d=576, 9/3 heads, vocab "
          f"49152, bf16, random weights from seed 0), batch {B} x {T}, "
          f"remat nothing, {TRAIN['steps']} steps, async checkpoint every "
          f"{TRAIN['ckpt_every']}")
    torch.cuda.reset_peak_memory_stats()
    fa.launches = fa.bwd_launches = fa.simt_launches = 0
    t0 = time.monotonic()
    tr = launcher.main(args + ["--steps", str(TRAIN["steps"])])
    torch.cuda.synchronize()
    wall = time.monotonic() - t0
    launches, bwd_launches = fa.launches, fa.bwd_launches
    L = tr.model.cfg.num_layers
    hist = tr.history
    losses = [h["loss"] for h in hist]
    check(len(hist) == TRAIN["steps"] and all(map(math.isfinite, losses)),
          f"training losses: {losses}")
    check(launches == 2 * L * TRAIN["steps"],
          f"flash launches {launches} != 2 x {L} x {TRAIN['steps']} steps")
    check(bwd_launches == L * TRAIN["steps"],
          f"flash backward launches {bwd_launches} != {L} x "
          f"{TRAIN['steps']} steps")
    check(fa.simt_launches == 0, f"{fa.simt_launches} flash launches took "
          "the CUDA-core instance, not the tensor-core one")
    check(losses[-1] < losses[0], f"loss did not fall: {losses}")
    saved = tr.ckpt.saved_steps
    check(ckpt_lib.latest_step(ckpt_dir) == TRAIN["steps"]
          and TRAIN["steps"] in saved, f"checkpoints saved: {saved}")
    dts = sorted(h["dt_s"] for h in hist[1:])
    step_s = statistics.median(dts)
    print(f"training: {TRAIN['steps']} steps in {wall:.1f} s; step (median "
          f"of steps 2-{TRAIN['steps']}) {1e3 * step_s:.1f} ms "
          f"({1e3 * dts[0]:.1f}-{1e3 * dts[-1]:.1f}), {B * T / step_s:.0f} "
          f"tokens/s; step 1 {1e3 * hist[0]['dt_s']:.0f} ms; loss "
          f"{losses[0]:.4f} -> {losses[-1]:.4f}; checkpoints saved at steps "
          f"{sorted(set(saved))}; "
          f"flash launches {launches} (= 2 x {L} layers x {TRAIN['steps']} "
          f"steps), flash backward launches {bwd_launches} (= {L} x "
          f"{TRAIN['steps']}); peak device memory "
          f"{torch.cuda.max_memory_allocated() / 2**30:.2f} GiB [{smi}]")
    del tr
    fa.launches = fa.bwd_launches = fa.simt_launches = 0
    tr2 = launcher.main(args + ["--steps", str(TRAIN["resume_steps"]),
                                "--resume"])
    torch.cuda.synchronize()
    total = TRAIN["steps"] + TRAIN["resume_steps"]
    losses2 = [h["loss"] for h in tr2.history]
    check(tr2.step == total and all(map(math.isfinite, losses2))
          and ckpt_lib.latest_step(ckpt_dir) == total,
          f"resume: step {tr2.step}, losses {losses2}")
    check(fa.launches == 2 * L * TRAIN["resume_steps"]
          and fa.bwd_launches == L * TRAIN["resume_steps"]
          and fa.simt_launches == 0,
          f"resume: flash launches {fa.launches}, backward "
          f"{fa.bwd_launches}, CUDA-core {fa.simt_launches}")
    print(f"resume from step {TRAIN['steps']}: {TRAIN['resume_steps']} more "
          f"steps to {tr2.step}, loss {losses2[0]:.4f} -> {losses2[-1]:.4f}, "
          f"flash launches {fa.launches}, backward {fa.bwd_launches}")
    phase_train_split(tr2.model, tr2.opt, tr2.params, tr2.opt_state, smi)
    del tr2
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    return launches, bwd_launches


def phase_train_split(model, opt, params, opt_state, smi: str):
    """Where one training step's device time goes: the flash forward
    kernel, the flash backward kernels (and everything under the
    backward's profiler range), cuBLAS matrix products, the optimizer,
    and the device's idle share of the step's wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.train.train_step import make_train_step
    step = make_train_step(model, opt)
    B, T = TRAIN_ATTN["B"], TRAIN_ATTN["T"]
    batch = {k: torch.as_tensor(v).to(model.device) for k, v in synth_batch(
        0, 0, 999, B, T, model.cfg.vocab_size).items()}

    def run():
        out = step(params, opt_state, batch)
        torch.cuda.synchronize()
        return out

    run()
    t0 = time.perf_counter()
    for _ in range(3):
        run()
    wall = (time.perf_counter() - t0) / 3 * 1e3
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        run()
    rows = kernel_rows(prof)
    busy = sum(e.self_device_time_total for e in rows) / 1e3
    if busy == 0:
        print(f"training step split: wall {wall:.1f} ms; device time not "
              f"measured (the profiler saw no device activity) [{smi}]")
        return
    ranges = range_ms(prof)

    def part(*needles):
        return sum(e.self_device_time_total for e in rows
                   if any(n in e.key for n in needles)) / 1e3

    check(not any("flash_" in e.key and "_simt" in e.key for e in rows),
          "training step split: a CUDA-core flash kernel ran")
    flash = part("flash_fwd_tc")
    flash_bwd = part("flash_bwd_dq_tc", "flash_bwd_dkdv_tc",
                     "flash_bwd_sum_heads")
    mm = part("gemm", "nvjet", "xmma", "cutlass")
    top = sorted(rows, key=lambda e: e.self_device_time_total,
                 reverse=True)[:6]
    print(f"training step split (batch {B} x {T}, remat nothing): wall "
          f"{wall:.1f} ms, device busy {busy:.1f} ms (idle share "
          f"{1 - busy / wall:.3f}); flash forward kernel {flash:.1f} ms "
          f"(60 launches); flash backward kernels {flash_bwd:.1f} ms (30 "
          f"launches of the dQ and dK/dV passes; the backward's range "
          f"{ranges.get('flash_attention_trainable.backward', 0):.1f} ms); "
          f"cuBLAS matrix products {mm:.1f} ms; optimizer "
          f"{ranges.get('adamw.update', 0):.1f} ms; top device ops: "
          + "; ".join(f"{e.key[:48]} {e.self_device_time_total / 1e3:.2f} ms"
                      for e in top) + f" [{smi}]")


def phase_train_parity():
    """CPU/CUDA parity of training: the SMOKE config at float32, the same
    weights and batches on both devices, 3 steps' losses within 1e-4
    relative."""
    import torch
    from repro_torch.configs import get_smoke_config
    from repro_torch.data.pipeline import synth_batch
    from repro_torch.models.model import build_model
    from repro_torch.train.optimizer import AdamW, OptConfig
    from repro_torch.train.train_step import make_train_step
    cfg = dataclasses.replace(get_smoke_config("smollm-135m"),
                              dtype="float32")
    params = build_model(cfg, device="cpu").init(
        torch.Generator().manual_seed(9))
    opt = AdamW(OptConfig(lr=1e-3, warmup_steps=2, total_steps=10))
    losses = {}
    for dev in ("cpu", "cuda"):
        model = build_model(cfg, device=dev)
        step = make_train_step(model, opt)
        p = _to_device(params, dev)
        state = opt.init(p)
        losses[dev] = []
        for s in range(3):
            batch = {k: torch.as_tensor(v).to(dev) for k, v in synth_batch(
                0, 0, s, 2, 64, cfg.vocab_size).items()}
            p, state, metrics = step(p, state, batch)
            losses[dev].append(float(metrics["loss"]))
    rel = max(abs(a - b) / abs(b) for a, b in zip(losses["cuda"],
                                                  losses["cpu"]))
    check(rel <= 1e-4, f"train parity: cpu {losses['cpu']} cuda "
                       f"{losses['cuda']}")
    print(f"cpu/cuda training parity (SMOKE, float32, 3 steps): losses "
          f"{[round(x, 6) for x in losses['cuda']]}, max relative diff "
          f"{rel:.3g} (tol 1e-4)")


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
    t0 = time.monotonic()
    smi = nvidia_smi_line()
    print(f"nvidia-smi: {smi}")
    phase_build()
    paged_err = phase_compare()
    ring_err = phase_compare_ring()
    flash_err = phase_compare_flash()
    phase_compare_dense_decode()
    nbb_err, nbb_launches = phase_compare_nbb()
    trainable_out_err, trainable_grad_err = phase_compare_trainable()
    model, params, forwards = full_width_model()
    paged_launches = phase_serve(model, params, forwards, smi)
    phase_split(model, params, smi)
    fused = phase_serve_dense(model, params, forwards, smi)
    phase_split_dense(model, params, smi)
    paged_launches += phase_overload(model, params, forwards, smi)
    paged_launches += phase_faults(model, params, forwards, smi)
    paged_launches += phase_recovery(model, params, forwards, smi)
    del model, params
    paged_launches += phase_serve_olmoe(smi)
    gemma_paged, ring_launches = phase_serve_gemma(smi)
    paged_launches += gemma_paged
    phase_parity()
    train_launches, train_bwd_launches = phase_train(smi)
    phase_train_parity()
    phase_checker()
    kernels = [phase_timing_paged(paged_launches, paged_err, smi),
               phase_timing_ring(ring_launches, ring_err, smi),
               phase_timing_flash(fused["flash_attention"], flash_err, smi),
               phase_timing_trainable(
                   train_launches,
                   max(trainable_out_err, trainable_grad_err), smi),
               phase_timing_flash_bwd(train_bwd_launches,
                                      trainable_grad_err, smi),
               phase_timing_nbb(nbb_launches, nbb_err, smi)]
    print(f"chip smoke: {time.monotonic() - t0:.1f} s")
    print(f"nvidia-smi: {smi}")
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
