"""Serving driver: a closed loop of clients against ``ServeEngine`` on
``slot_paged``, one thread owning every session and the engine's ticks.

Set-up draws the weights from the seed, builds the engine and runs the
closed loop until ``warm_requests`` requests have completed, which fills every
slot and uses every shape the window will.  The window then runs for
``--seconds``; a client times its request from its ``submit_i`` call to
its receipt of the first and of each later token.  After the window the
engine is freed and the reference checks a sample of the requests that
finished in it (``lib/serve_check.py``)."""
from __future__ import annotations

import time
from typing import Dict, List

import numpy as np

from bench.lib import serve_check, spec, weights
from bench.lib.record import Recorder
from bench.lib.stats import (device_info, free_device_memory, pct,
                             start_profiler, stop_profiler, warm_profiler)
from bench.lib.traffic import ServeTraffic, bucket


class Client:
    """One session and its request in flight."""

    def __init__(self, session):
        self.session = session
        self.handle = None

    def submit(self, req, now_fn):
        self.req = req
        self.submit_t = now_fn()
        self.handle = self.session.submit_i(req.prompt, req.max_tokens)
        self.got: Dict[int, int] = {}
        self.times: List[float] = []


class Loop:
    """The closed loop: every free client submits at once."""

    def __init__(self, engine, traffic: ServeTraffic, n_clients: int):
        self.engine, self.traffic = engine, traffic
        self.clients = [Client(engine.connect(c)) for c in range(n_clients)]
        self.done: List[dict] = []
        self.submitting = True

    def poll(self) -> None:
        for c in self.clients:
            h = c.handle
            if h is None:
                continue
            h.test()
            now = time.monotonic()
            while h._tokens:
                pos, tok = h._tokens.popleft()
                if pos not in c.got:
                    c.got[pos] = tok
                    c.times.append(now)
            if h.done:
                final = h.response
                out = final.tokens_out if final is not None else None
                for p in range(0 if out is None else len(out)):
                    if p not in c.got:
                        c.got[p] = int(out[p])
                        c.times.append(now)
                toks = [c.got[p] for p in sorted(c.got)]
                ok = (h.status is None and len(toks) == c.req.max_tokens)
                self.done.append(dict(
                    req_id=h.req_id, prompt=c.req.prompt, tokens=toks,
                    submit_t=c.submit_t, times=c.times, ok=ok, done_t=now))
                c.handle = None

    def fill(self) -> None:
        if not self.submitting:
            return
        for c in self.clients:
            if c.handle is None:
                c.submit(self.traffic.take(), time.monotonic)

    def in_flight(self) -> List[Client]:
        return [c for c in self.clients if c.handle is not None]


def window_metrics(loop: Loop, t_start: float, t_end: float, seconds: float):
    """(e2e metrics, attempted, failed, requests finished in the window)."""
    ttft, tpot, tokens = [], [], 0
    fin, attempted, failed = [], 0, 0
    everyone = loop.done + [dict(submit_t=c.submit_t, times=c.times,
                                 ok=True, done_t=None)
                            for c in loop.in_flight()]
    for r in everyone:
        times = r["times"]
        tokens += sum(1 for t in times if t_start <= t < t_end)
        active = (r["submit_t"] < t_end
                  and (r["done_t"] is None or r["done_t"] >= t_start))
        if active:
            attempted += 1
            if r["done_t"] is not None and not r["ok"]:
                failed += 1
        if times and t_start <= times[0] < t_end:
            ttft.append((times[0] - r["submit_t"]) * 1e3)
        if (r["done_t"] is not None and t_start <= r["done_t"] < t_end
                and r["ok"]):
            fin.append(r)
            if len(times) > 1:
                tpot.append((times[-1] - times[0]) / (len(times) - 1) * 1e3)
    e2e = {"output_tokens_per_s": (tokens / seconds, "tokens/s"),
           "ttft_p95_ms": (pct(ttft, 95), "ms"),
           "tpot_p95_ms": (pct(tpot, 95), "ms")}
    return e2e, attempted, failed, fin


def sample(fin: List[dict], seed: int, n: int) -> List[dict]:
    """The request with the most served tokens, and ``n - 1`` more drawn
    from the seed."""
    if not fin:
        return []
    longest = max(range(len(fin)), key=lambda i: len(fin[i]["tokens"]))
    rest = [i for i in range(len(fin)) if i != longest]
    rng = np.random.default_rng([seed, 7])
    pick = rng.choice(len(rest), size=min(n - 1, len(rest)), replace=False)
    return [fin[longest]] + [fin[rest[i]] for i in sorted(pick)]


def run(ctx) -> dict:
    import torch
    from repro_torch.models import moe as moe_mod
    from repro_torch.models.model import build_model
    from repro_torch.serve.engine import ServeEngine

    wl = ctx.workload
    eng = dict(wl["engine"], **(wl.get("smoke", {}).get("engine", {})
                                if ctx.smoke else {}))
    n_clients = eng.pop("clients")
    warm = (wl.get("smoke", {}).get("warm_requests", wl["warm_requests"])
            if ctx.smoke else wl["warm_requests"])
    check = dict(wl["check"], **(wl.get("smoke", {}).get("check", {})
                                 if ctx.smoke else {}))
    sizes, dev = ctx.sizes, ctx.device
    traffic = ServeTraffic(ctx.traffic, ctx.seed, sizes["vocab_size"])
    ref = spec.reference(ctx.config["reference"])
    if dev != "cpu":
        torch.cuda.reset_peak_memory_stats()
    W = weights.draw(ref.layout(sizes), ctx.seed, dev)
    model = build_model(ctx.cfg, device=dev)
    max_len = bucket(traffic.max_prompt) + traffic.max_output
    ps = eng.pop("page_size")
    pages = eng["max_batch"] * max_len // ps + eng.pop("spare_pages")
    engine = ServeEngine(model, W, max_len=max_len, n_clients=n_clients,
                         pool_pages=pages, page_size=ps,
                         scheduler="slot_paged", prefix_cache=True,
                         stream_depth=4 * traffic.max_output + 64,
                         device=dev, **eng)
    rec = Recorder(engine, moe_mod, sizes["num_layers"])
    if ctx.fault == "alter_token":
        plant_altered_token(engine)
    loop = Loop(engine, traffic, n_clients)

    def step():
        engine.tick()
        loop.poll()
        loop.fill()

    try:
        while len(loop.done) < warm:
            step()
        if ctx.trace:
            warm_profiler(dev)
        if dev != "cpu":
            torch.cuda.synchronize()
        stats0 = dict(engine.stats)
        done0 = len(loop.done)
        d0 = len(rec.dispatches)
        t_start = time.monotonic()
        setup_s = t_start - ctx.t0
        t_end = t_start + ctx.seconds
        prof, traced = None, None
        tr = wl.get("trace", {})
        t_prof0 = t_start + tr.get("start_frac", 0.3) * ctx.seconds
        t_prof1 = t_prof0 + tr.get("seconds", 3.0)
        # A SMOKE run on a loaded CPU (the tests) runs on until it has
        # something to check.
        least = wl.get("smoke", {}).get("min_finished", 0) if ctx.smoke \
            else 0
        while True:
            now = time.monotonic()
            if now >= t_end and len(loop.done) - done0 >= least:
                t_end = max(t_end, now)
                break
            if ctx.trace and prof is None and now >= t_prof0 and \
                    traced is None:
                prof = start_profiler(dev)
                traced = {"t0": now, "d0": len(rec.dispatches),
                          "r0": len(rec.routes)}
            if prof is not None and now >= t_prof1:
                traced.update(t1=stop_profiler(prof, dev),
                              d1=len(rec.dispatches), r1=len(rec.routes),
                              prof=prof)
                prof = None
            step()
        if prof is not None:
            traced.update(t1=stop_profiler(prof, dev),
                          d1=len(rec.dispatches), r1=len(rec.routes),
                          prof=prof)
        if dev != "cpu":
            torch.cuda.synchronize()
        t_close = time.monotonic()
        stats1 = dict(engine.stats)
        d1 = len(rec.dispatches)
    finally:
        rec.close()
    peak = torch.cuda.max_memory_allocated() if dev != "cpu" else 0
    e2e, attempted, failed, fin = window_metrics(
        loop, t_start, t_end, t_end - t_start)
    e2e["setup_s"] = (setup_s, "s")
    layer_ctx = None
    if ctx.trace and traced is not None:
        layer_ctx = serve_layer_ctx(ctx, rec, traced, stats0, stats1,
                                    rec.dispatches[d0:d1], t_close - t_start,
                                    loop, t_start, t_end, eng)
    # The program's state goes before the reference runs.
    for c in loop.clients:
        c.session = c.handle = None
    engine.pool = engine.prefix_cache = engine._sessions = None
    del engine, loop.engine, model
    free_device_memory()
    picked = sample(fin, ctx.seed, check["requests"])
    tol = check["limits"]["router_gap_max"]
    readings = serve_check.check(ref, W, sizes, rec, picked, tol, ps)
    judged = readings
    if ctx.control:
        from bench.reference.common import FakeFp8
        judged = serve_check.check(ref, W, sizes, rec, picked, tol, ps,
                                   quant=FakeFp8())
    checks = {k: (judged.get(k, float("inf")), lim)
              for k, lim in check["limits"].items()}
    enough = judged.get("tokens", 0) >= check.get("min_tokens", 1)
    checks["tokens_checked"] = (judged.get("tokens", 0),
                                check.get("min_tokens", 1))
    correct = enough and all(v <= lim for k, (v, lim) in checks.items()
                             if k != "tokens_checked")
    summary = layer_ctx["summary"] if layer_ctx else None
    extra = ({"busy_s": summary.busy_s, "window_s": summary.window_s}
             if summary is not None else {})
    from bench.lib.harness import power_limit
    return {"correct": correct, "attempted": attempted, "failed": failed,
            "e2e": e2e, "device": device_info(dev, 1, peak, extra),
            "checks": checks, "layer_ctx": layer_ctx,
            "breakdown": summary.breakdown() if summary else None,
            "power": power_limit() if dev != "cpu" else "",
            "readings": readings, "control": judged if ctx.control else None}


def serve_layer_ctx(ctx, rec, traced, stats0, stats1, window_disp,
                    window_s, loop, t_start, t_end, eng) -> dict:
    """What the per-layer metric readers of a served cell read."""
    from bench.lib import trace
    summary = trace.summarize(traced["prof"], traced["t1"] - traced["t0"])
    firsts = {}
    for d in window_disp:
        if d["chunk"] is None:
            continue
        for b in np.nonzero(d["nval"] > 0)[0]:
            firsts.setdefault(int(d["slots"][b]), int(d["start"][b]))
    reqs = {r["req_id"]: (len(r["prompt"]), r["times"]) for r in loop.done}
    reqs.update({c.handle.req_id: (len(c.req.prompt), c.times)
                 for c in loop.in_flight()})
    computed = keys = out_tokens = 0
    for rid, first in firsts.items():
        if rid not in reqs:
            continue
        n = reqs[rid][0]
        adopted = max(0, first - (bucket(n) - n))
        computed += n - adopted
        keys += (n * (n + 1) - adopted * (adopted + 1)) // 2
    for n, times in reqs.values():
        for j, t in enumerate(times):
            if t_start <= t < t_end:
                out_tokens += 1
                keys += n + j + 1
    return dict(summary=summary, sizes=ctx.sizes, max_batch=eng["max_batch"],
                routes_traced=[r.cpu().numpy() for r in
                               rec.routes[traced["r0"]:traced["r1"]]],
                dispatches_traced=rec.dispatches[traced["d0"]:traced["d1"]],
                stats0=stats0, stats1=stats1, window_s=window_s,
                traced_s=traced["t1"] - traced["t0"],
                computed_prompt_tokens=computed, attended_keys=keys,
                output_tokens=out_tokens)


def plant_altered_token(engine) -> None:
    """A planted fault for the tests: every fifth harvested token is
    replaced by its neighbour id where it is produced."""
    orig = engine._harvest_block

    def harvest(active, blk, k, t0, t1, joined=()):
        blk = blk.copy()
        sel = blk[:, ::5] >= 0
        blk[:, ::5] = np.where(sel, (blk[:, ::5] + 1) %
                               engine.model.cfg.vocab_size, blk[:, ::5])
        return orig(active, blk, k, t0, t1, joined=joined)

    engine._harvest_block = harvest
