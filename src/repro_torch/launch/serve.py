"""Serving launcher: ``python -m repro_torch.launch.serve --arch <id> [...]``.

Starts the port's lock-free ``slot_paged`` ServeEngine on the card (or
``--device cpu``) and drives it with synthetic client threads over the
streaming session API: each client owns a Session, submits through
non-blocking ``submit_i`` handles, and consumes tokens as they are
produced via ``RequestHandle.tokens()``.  Per-client results travel back
to the main thread over private SPSC rings.  Prints throughput,
completion latency, TTFT, the engine's stats and how many times the
paged-attention kernel was launched.  Weights are random, drawn from
``--seed`` with the port's own initializer.
"""
from __future__ import annotations

import argparse
import threading
import time

import numpy as np
import torch

from repro_torch.configs import get_config, get_smoke_config, list_archs
from repro_torch.core import nbb
from repro_torch.core.host_queue import SpscQueue
from repro_torch.kernels import paged_attention as pa_kernel
from repro_torch.models.model import build_model
from repro_torch.serve.engine import ServeEngine


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
    ap.add_argument("--max-batch", type=int, default=8,
                    help="decode slots (paged residency is length-"
                         "proportional, so slots are cheap)")
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--k-max", type=int, default=8,
                    help="max fused decode steps per block")
    ap.add_argument("--chunk-tokens", type=int, default=16,
                    help="prompt tokens streamed per dispatch")
    ap.add_argument("--no-prefix-cache", action="store_true",
                    help="disable the shared-prefix page cache: every "
                         "prompt prefills cold")
    ap.add_argument("--shared-prefix-len", type=int, default=0,
                    help="tokens of a common system prompt prepended to "
                         "every request (exercises the prefix cache)")
    args = ap.parse_args(argv)

    cfg = get_smoke_config(args.arch) if args.smoke else get_config(args.arch)
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator().manual_seed(args.seed))
    page_size = 16
    # The pool IS the device KV store: size it to the dense batch cache's
    # position budget (max_batch * max_len) so the kv-memory report
    # compares equal allocations.
    pool_pages = (args.max_batch * args.max_len + page_size - 1) // page_size
    eng = ServeEngine(model, params, max_batch=args.max_batch,
                      max_len=args.max_len, n_clients=args.clients,
                      pool_pages=pool_pages, page_size=page_size,
                      k_max=args.k_max,
                      chunk_tokens=min(args.chunk_tokens, args.max_len),
                      prefix_cache=not args.no_prefix_cache,
                      device=args.device)
    pa_kernel.launches = 0
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
                handle = session.submit_i(prompt, max_tokens=args.max_tokens)
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
    print(f"device: {where}")
    print(f"served {eng.stats['served']} requests in {dt:.2f}s "
          f"({n / dt:.1f} req/s, {toks / dt:.1f} tok/s)")
    print(f"latency ms: p50 {_pct(lat, 0.5):.0f} p95 {_pct(lat, 0.95):.0f}")
    print(f"ttft ms:    p50 {_pct(ttft, 0.5):.0f} p95 {_pct(ttft, 0.95):.0f}")
    print(f"engine stats: {eng.stats}")
    print(f"paged_attention kernel launches: {pa_kernel.launches}")
    pstats = eng.pool.stats()
    syncs_tok = eng.stats["host_syncs"] / max(toks, 1)
    print(f"slot occupancy: {eng.occupancy():.2f}  "
          f"host syncs/token: {syncs_tok:.2f}  "
          f"oversize rejects: {len(eng.oversize_log)}  kv pool: {pstats}")
    dense_b = eng.dense_cache_bytes()
    resident = pstats["kv_resident_bytes_peak"]
    print(f"kv memory: resident {resident / 1024:.0f} KiB "
          f"(dense batch cache would be {dense_b / 1024:.0f} KiB, "
          f"{resident / max(dense_b, 1):.2f}x)  "
          f"kv copy traffic: {pstats['kv_copy_bytes'] / 1024:.0f} KiB")
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
