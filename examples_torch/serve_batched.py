"""Serve a small model with batched, *streamed* concurrent requests.

Demonstrates the handle-based session API end to end: three client
threads connect sessions to the lock-free engine, submit through
non-blocking ``submit_i`` handles, and consume tokens via
``RequestHandle.tokens()`` while the packet-mode slot batcher (the
default ``slot_fused`` scheduler) is still decoding other sequences —
tokens are produced in fused K-step blocks on the device and arrive on
the client's stream ring as bursts, but the iterator surface is
unchanged.  One request is cancelled mid-decode to show the CAS
cancellation path freeing its KV pages without stopping the batcher.

    PYTHONPATH=src python examples_torch/serve_batched.py
    PYTHONPATH=src python examples_torch/serve_batched.py --device cpu

Runs on the card unless ``--device cpu``.  On a fast device all 48
tokens of the cancelled request may be decoded before the cancel lands:
the CAS then finds it completed, and that is its one terminal state.
"""
import argparse
import sys
import threading
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro_torch.configs import get_smoke_config  # noqa: E402
from repro_torch.models.model import build_model  # noqa: E402
from repro_torch.serve.engine import ServeEngine  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default="cuda",
                    help="cuda (default) or cpu; no silent fallback")
    args = ap.parse_args(argv)

    cfg = get_smoke_config("smollm-135m")
    model = build_model(cfg, device=args.device)
    params = model.init(torch.Generator(model.device).manual_seed(0))
    eng = ServeEngine(model, params, max_batch=4, max_len=64,
                      n_clients=3, pool_pages=256,   # slot_fused default
                      device=args.device)
    eng_thread = eng.start()
    streams = []                 # (response, [(pos, token), ...])

    def client(c: int) -> None:
        rng = np.random.default_rng(c)
        # Context-managed: leaving the block cancels anything in flight
        # and marks the session closed (idempotent), so a client thread
        # that dies early cannot strand engine-side state.
        with eng.connect(c) as session:
            for i in range(2):
                prompt = rng.integers(0, cfg.vocab_size, 8)
                handle = session.submit_i(prompt, max_tokens=8)
                got = []
                for pos, tok in handle.tokens(timeout_s=300):
                    got.append((pos, tok))   # delivered as decoded
                r = handle.response
                print(f"client {c} req {r.req_id}: streamed {len(got)} "
                      f"tokens ({r.fsm.state.split('_')[-1]}), "
                      f"ttft {1e3 * (r.first_token_t - r.submit_t):.0f}ms")
                streams.append((r, got))

    threads = [threading.Thread(target=client, args=(c,)) for c in range(3)]
    for t in threads:
        t.start()

    # A fourth stream on client 0's session thread would break the
    # one-consumer rule, so cancel from the main thread instead: cancel()
    # is thread-safe (a single CAS) while the stream surface is not.
    session = eng.connect(2)
    for t in threads:
        t.join()
    # Every stream, checked here so a failure ends the run: each output
    # position delivered exactly once, in order, and equal to the
    # terminal's tokens.
    assert len(streams) == 6, f"{len(streams)} of 6 streams finished"
    for r, got in streams:
        assert [p for p, _ in got] == list(range(len(r.tokens_out)))
        assert [t for _, t in got] == list(map(int, r.tokens_out))
    handle = session.submit_i(np.arange(8) % cfg.vocab_size, max_tokens=48)
    time.sleep(0.05)                       # let a few decode steps run
    handle.cancel()
    r = handle.wait(timeout_s=30)
    if not r:                              # typed, falsy TimeoutStatus
        print(f"cancel demo timed out waiting for the terminal: {r}")
    else:
        print(f"cancel mid-decode -> {r.fsm.state.split('_')[-1]} after "
              f"{len(r.tokens_out)}/48 tokens; kv pool free again: "
              f"{eng.pool.free_pages() == eng.pool.n_pages}")

    eng.stop()
    eng_thread.join(timeout=10)
    print(f"engine stats: {eng.stats}")
    print(f"slot occupancy: {eng.occupancy():.2f}")
    return {"engine": eng, "streams": streams, "cancelled": r}


if __name__ == "__main__":
    main()
