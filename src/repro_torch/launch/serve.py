"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Starts the port's lock-free ServeEngine on the card (or ``--device cpu``)
under ``--scheduler`` (the JAX launcher's choices and defaults:
``slot_chunked`` for chunkable models, else ``slot_fused``) and drives it
with synthetic client threads over the streaming session API: each client
owns a Session, submits through non-blocking ``submit_i`` handles, and
consumes tokens as they are produced via ``RequestHandle.tokens()``
(whole responses under ``wave``).  Per-client results travel back to the
main thread over private SPSC rings.  Prints throughput, completion
latency, TTFT, the engine's stats, the KV memory report and how many
times the flash- and paged-attention kernels were launched.  Weights are
random, drawn from ``--seed`` with the port's own initializer.

The robustness flags are the JAX launcher's: ``--priorities``,
``--preemption`` (``slot_paged`` only), ``--wfq`` and ``--slo-ms`` install
an overload policy (per-class TTFT and the preemption counters are
printed); ``--lease-s`` and ``--tick-retries`` arm leases and the tick
watchdog; ``--snapshot-dir``/``--snapshot-every`` arm crash recovery
(``slot_paged`` only; SIGINT/SIGTERM snapshot before exiting) and
``--restore`` restores a snapshot file or the newest valid snapshot of a
directory before serving.
"""
from __future__ import annotations

import argparse
import os
import signal
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import nbb
from repro_torch.core.host_queue import SpscQueue
from repro_torch.kernels import flash_attention as fa_kernel
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.models.model import build_model
from repro_torch.serve.engine import SCHEDULERS, ServeEngine
from repro_torch.serve.overload import (PRIORITY_HIGH, PRIORITY_LOW,
                                        PRIORITY_NORMAL, OverloadPolicy)


def _pct(sorted_vals, q: float) -> float:
    if not sorted_vals:
        return float("nan")
    return sorted_vals[min(int(len(sorted_vals) * q), len(sorted_vals) - 1)]


def main(argv=None) -> ServeEngine:
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="smollm-135m", choices=list_archs())
    ap.add_argument("--smoke", action="store_true")
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--clients", type=int, default=3)
    ap.add_argument("--requests-per-client", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--max-tokens", type=int, default=8)
    ap.add_argument("--max-batch", type=int, default=None,
                    help="decode slots (default 8 for slot_paged — paged "
                         "residency is length-proportional, so slots are "
                         "cheap — else 4)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--scheduler", default=None, choices=list(SCHEDULERS),
                    help="slot_paged = chunked admission + fused decode "
                         "over the page pool (falls back to slot_chunked/"
                         "slot_fused for non-pageable archs); "
                         "slot_chunked = chunked zero-copy admission into "
                         "the dense ring (default; falls back to "
                         "slot_fused for recurrent-state archs); "
                         "slot_fused = monolithic prefill + fused K-step "
                         "decode; slot = per-token decode; wave = "
                         "batch-level baseline")
    ap.add_argument("--k-max", type=int, default=8,
                    help="max fused decode steps per block (slot_fused/"
                         "slot_chunked/slot_paged)")
    ap.add_argument("--chunk-tokens", type=int, default=16,
                    help="prompt tokens streamed per dispatch "
                         "(slot_chunked/slot_paged)")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the shared-prefix page cache "
                         "(slot_paged): every prompt prefills cold")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="tokens of a common system prompt prepended to "
                         "every request (exercises the prefix cache)")
    ap.add_argument("--priorities", action="store_true",
                    help="enable overload control: requests carry a "
                         "priority class (~20%% high / 60%% normal / 20%% "
                         "low) and intake serves classes strictly with "
                         "aging")
    ap.add_argument("--preemption", action="store_true",
                    help="let a high-priority arrival preempt a running "
                         "low-priority slot by swapping its private KV "
                         "pages to host (slot_paged only; implies "
                         "--priorities)")
    ap.add_argument("--wfq", action="store_true",
                    help="weighted-fair queuing across clients inside "
                         "each priority class (implies --priorities)")
    ap.add_argument("--slo-ms", type=float, default=None,
                    help="admission SLO: shed any request that waited "
                         "longer than this in the intake before binding "
                         "(implies --priorities)")
    ap.add_argument("--lease-s", type=float, default=None,
                    help="per-session lease: a client silent (no pump, "
                         "no submit) longer than this is presumed dead — "
                         "its in-flight requests fail with a typed "
                         "terminal and its slots/pages/rings are "
                         "reclaimed")
    ap.add_argument("--tick-retries", type=int, default=1,
                    help="whole-tick retries the watchdog grants a "
                         "transient dispatch fault before failing the "
                         "bound slots")
    ap.add_argument("--snapshot-dir", default=None,
                    help="arm crash recovery (slot_paged only): "
                         "crash-consistent engine snapshots + a "
                         "write-ahead intake journal land here; "
                         "SIGINT/SIGTERM snapshot before exiting")
    ap.add_argument("--snapshot-every", type=int, default=None,
                    help="periodic snapshot cadence in engine ticks "
                         "(default: only at shutdown/crash)")
    ap.add_argument("--restore", default=None, metavar="PATH",
                    help="restore before serving: a snapshot file, or a "
                         "snapshot directory (newest valid snapshot + "
                         "journal replay); prints the restore report")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    # Drawn on the model's device: a full-width MoE's experts (13 GB for
    # olmoe-1b-7b) would take minutes from a CPU generator.
    params = model.init(
        torch.Generator(device=model.device).manual_seed(args.seed))
    scheduler = args.scheduler
    if scheduler is None:
        # Chunked admission needs position-indexed caches; recurrent
        # archs keep the fused monolithic-prefill default.
        scheduler = "slot_chunked" if model.chunkable else "slot_fused"
    if scheduler == "slot_paged" and not model.pageable:
        fallback = "slot_chunked" if model.chunkable else "slot_fused"
        print(f"{cfg.name}: not pageable, falling back to {fallback}")
        scheduler = fallback
    max_batch = args.max_batch or (8 if scheduler == "slot_paged" else 4)
    page_size = 16
    if scheduler == "slot_paged":
        # The pool IS the device KV store: size it to the dense batch
        # cache's position budget (max_batch * max_len) so the kv-memory
        # report compares equal allocations.
        pool_pages = (max_batch * args.max_len + page_size - 1) // page_size
    else:
        # The dense schedulers use the pool for admission accounting only.
        pool_pages = max(256, args.clients * 16)
    overload = None
    if (args.priorities or args.preemption or args.wfq
            or args.slo_ms is not None):
        preemption = args.preemption
        if preemption and scheduler != "slot_paged":
            # Page-swap preemption needs the page pool as the KV store.
            print(f"{scheduler}: no page pool, disabling --preemption")
            preemption = False
        overload = OverloadPolicy(
            priorities=True, preemption=preemption, wfq=args.wfq,
            slo_s=None if args.slo_ms is None else args.slo_ms / 1e3)
    snapshot_dir = args.snapshot_dir
    if args.restore is not None and snapshot_dir is None:
        # --restore implies a snapshot home: the directory the snapshot
        # lives in (so the journal opens alongside it).
        snapshot_dir = (args.restore if os.path.isdir(args.restore)
                        else os.path.dirname(args.restore) or ".")
    if snapshot_dir is not None and scheduler != "slot_paged":
        print(f"{scheduler}: crash recovery: slot_paged only, disabling "
              "snapshots")
        snapshot_dir = None
    eng = ServeEngine(model, params, max_batch=max_batch,
                      max_len=args.max_len, n_clients=args.clients,
                      pool_pages=pool_pages, page_size=page_size,
                      scheduler=scheduler, k_max=args.k_max,
                      chunk_tokens=min(args.chunk_tokens, args.max_len),
                      prefix_cache=not args.no_prefix_cache,
                      overload=overload, lease_s=args.lease_s,
                      tick_retries=args.tick_retries,
                      snapshot_dir=snapshot_dir,
                      snapshot_every=args.snapshot_every,
                      device=args.device)
    if args.restore is not None and snapshot_dir is not None:
        report = (eng.restore_latest() if os.path.isdir(args.restore)
                  else eng.restore(args.restore))
        if report is None:
            print(f"restore: no usable snapshot under {args.restore}, "
                  f"starting empty")
        else:
            print(f"restore: resumed {report['resumed']} requests, "
                  f"replayed {report['replayed']}, "
                  f"redelivered {report['redelivered']} terminals, "
                  f"failed {report['failed']} "
                  f"(from {report.get('path', args.restore)})")
    # Graceful shutdown: SIGINT/SIGTERM stop the serve loop, whose exit
    # path snapshots the final consistent state — the handler only sets
    # flags (signal-safe).  Previous handlers are restored on the way out.
    prev_handlers = {}

    def _graceful(signum, frame):
        eng.request_snapshot()
        eng.stop()

    if snapshot_dir is not None:
        for sig in (signal.SIGINT, signal.SIGTERM):
            try:
                prev_handlers[sig] = signal.signal(sig, _graceful)
            except ValueError:
                pass                    # not the main thread: skip
    fa_kernel.launches = pa_kernel.launches = 0
    eng_thread = eng.start()

    # One private SPSC result ring per client (client thread produces,
    # main thread drains after join).
    results = [SpscQueue(args.requests_per_client + 1)
               for _ in range(args.clients)]
    shared = (np.arange(args.shared_prefix_len) * 7 + 3) % cfg.vocab_size

    def client(c: int) -> None:
        rng = np.random.default_rng(args.seed * 1000 + c)
        with eng.connect(c) as session:
            for _ in range(args.requests_per_client):
                prompt = np.concatenate([
                    shared,
                    rng.integers(0, cfg.vocab_size, args.prompt_len)])
                pri = None
                if overload is not None:
                    u = rng.random()
                    pri = (PRIORITY_HIGH if u < 0.2
                           else PRIORITY_NORMAL if u < 0.8 else PRIORITY_LOW)
                handle = session.submit_i(prompt, max_tokens=args.max_tokens,
                                          priority=pri)
                n_stream = sum(1 for _ in handle.tokens(timeout_s=300))
                r = handle.response
                assert r is not None and n_stream == len(r.tokens_out)
                # Rejected/cancelled requests never produced a first
                # token; report their ttft as completion time.
                ttft_t = r.first_token_t or r.done_t
                status = results[c].send((r.done_t - r.submit_t,
                                          ttft_t - r.submit_t,
                                          len(r.tokens_out)))
                assert status == nbb.OK     # sized to fit every result

    t0 = time.monotonic()
    threads = [threading.Thread(target=client, args=(c,))
               for c in range(args.clients)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    dt = time.monotonic() - t0
    eng.stop()
    eng_thread.join(timeout=10)
    for sig, h in prev_handlers.items():
        signal.signal(sig, h)
    if snapshot_dir is not None:
        print(f"crash recovery: {eng.stats['snapshots']} snapshots "
              f"({eng.stats['snapshot_bytes'] / 1024:.0f} KiB last), "
              f"{eng.stats['restores']} restores, "
              f"{eng.stats['replayed_requests']} replayed -> "
              f"{snapshot_dir}")

    lat, ttft, toks = [], [], 0
    for ring in results:
        for total_s, ttft_s, n_tok in ring.drain():
            lat.append(total_s * 1e3)
            ttft.append(ttft_s * 1e3)
            toks += n_tok
    lat.sort()
    ttft.sort()
    n = args.clients * args.requests_per_client
    where = (torch.cuda.get_device_name(0) if eng.device.type == "cuda"
             else "cpu")
    print(f"device: {where}  scheduler: {scheduler}  "
          f"max_batch: {max_batch}")
    print(f"served {eng.stats['served']} requests in {dt:.2f}s "
          f"({n / dt:.1f} req/s, {toks / dt:.1f} tok/s)")
    print(f"latency ms: p50 {_pct(lat, 0.5):.0f} p95 {_pct(lat, 0.95):.0f}")
    print(f"ttft ms:    p50 {_pct(ttft, 0.5):.0f} p95 {_pct(ttft, 0.95):.0f}")
    print(f"engine stats: {eng.stats}")
    print(f"kernel launches: flash_attention {fa_kernel.launches}  "
          f"paged_attention {pa_kernel.launches}")
    if args.lease_s is not None or eng.faults is not None:
        fr = eng.fault_report()
        print(f"robustness: faults injected {fr['faults_injected']}  "
              f"requests failed {fr['requests_failed']}  "
              f"leases reaped {fr['leases_reaped']}  "
              f"pages quarantined {fr['pages_quarantined']}  "
              f"tick failures {fr['tick_failures']}  "
              f"dead: {fr['dead'] or 'no'}")
    pstats = eng.pool.stats()
    if scheduler != "wave":
        syncs_tok = eng.stats["host_syncs"] / max(toks, 1)
        print(f"slot occupancy: {eng.occupancy():.2f}  "
              f"host syncs/token: {syncs_tok:.2f}  "
              f"admission stall steps: "
              f"{eng.stats['admission_stall_steps']}  "
              f"oversize rejects: {len(eng.oversize_log)}  kv pool: {pstats}")
    # KV-memory report: paged holds peak-resident page bytes and copies
    # nothing; the dense schedulers hold the full batch cache and pay
    # admission copies.
    dense_b = eng.dense_cache_bytes()
    resident = (pstats["kv_resident_bytes_peak"]
                if scheduler == "slot_paged" else dense_b)
    print(f"kv memory: resident {resident / 1024:.0f} KiB "
          f"(dense batch cache would be {dense_b / 1024:.0f} KiB, "
          f"{resident / max(dense_b, 1):.2f}x)  "
          f"kv copy traffic: {pstats['kv_copy_bytes'] / 1024:.0f} KiB")
    if overload is not None:
        names = {PRIORITY_HIGH: "high", PRIORITY_NORMAL: "normal",
                 PRIORITY_LOW: "low"}
        for cls, c in sorted(eng.class_ttft().items()):
            print(f"ttft[{names.get(cls, cls)}]: "
                  f"p50 {c['p50_ms']:.0f} p99 {c['p99_ms']:.0f} ms "
                  f"(n={c['n']})")
        print(f"overload: preemptions {eng.stats['preemptions']}  "
              f"resumes {eng.stats['resumes']}  "
              f"shed {eng.stats['shed_requests']}  "
              f"swap out {eng.stats['swap_out_bytes'] / 1024:.0f} KiB  "
              f"swap in {eng.stats['swap_in_bytes'] / 1024:.0f} KiB")
    if eng.prefix_cache is not None:
        cstats = eng.prefix_cache.stats()
        looked = cstats["hits"] + cstats["misses"]
        rate = cstats["hits"] / looked if looked else 0.0
        print(f"prefix cache: hit rate {rate:.2f} "
              f"({cstats['hits']}/{looked} lookups)  "
              f"prefill tokens saved {eng.stats['prefill_tokens_saved']}  "
              f"entries {cstats['entries']} "
              f"(evictions {cstats['evictions']})  "
              f"cow copies {pstats['cow_copy_bytes'] / 1024:.0f} KiB")
    return eng


if __name__ == "__main__":
    main()
