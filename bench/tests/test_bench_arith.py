"""The yardstick's arithmetic on synthetic inputs: trace reduction, the
kernels' and the expert layer's work, and the metric readers."""
import numpy as np
import pytest

from bench.lib import peaks, spec, trace, work


def test_merge_ranges_and_gaps():
    assert trace.merge([(5, 7), (0, 2), (1, 3), (6, 9)]) == [(0, 3), (5, 9)]
    kernels = [("a", 0, 10), ("b", 20, 30), ("c", 25, 40)]
    ann = [("moe.block", 0, 21), ("moe.block", 24, 50)]
    r = trace.range_seconds(ann, kernels)
    assert r["moe.block"] == pytest.approx((10 + 10 + 15) / 1e6)
    busy = trace.merge((a, b) for _, a, b in kernels)
    gaps = trace.idle_gaps(busy, 0, 60, [("sync", 9, 22), ("host", 0, 60)])
    assert gaps == {"sync": pytest.approx(10e-6),
                    "host": pytest.approx(20e-6)}


def test_paged_work_counts_each_visible_key():
    B, T, H, hd, hkv = 2, 3, 4, 8, 2
    lens, kv = np.array([5, 9]), np.array([4, 9])
    nbytes, flops = work.paged_work(B, T, H, hd, hkv, 6, lens, kv)
    visible = 0
    for n, e in zip(lens, kv):
        for t in range(T):
            visible += sum(1 for key in range(e) if key <= n - T + t)
    assert flops == 4 * hd * H * visible
    assert nbytes == (2 * B * T * H * hd * 2 + (4 + 9) * hkv * hd * 2 * 2
                      + 6 * 4 + B * 8)


def test_fifo_keep_matches_a_plain_count():
    rng = np.random.default_rng(0)
    eids = rng.integers(0, 4, (9, 2))
    eids[:, 1] = (eids[:, 0] + 1 + rng.integers(0, 3, 9)) % 4
    C = work.capacity(9, 2, 1.25, 4)
    keep = work.fifo_keep(eids, 4, C)
    seen = {}
    for i, e in enumerate(eids.reshape(-1)):
        assert keep.reshape(-1)[i] == (seen.get(e, 0) < C)
        seen[e] = seen.get(e, 0) + 1
    nb, fl = work.moe_work(eids, 16, 32, 4, C)
    hit = len(set(eids[keep].tolist()))
    assert fl == 2 * 9 * 16 * 4 + keep.sum() * 6 * 16 * 32
    assert nb == (16 * 4 + hit * 3 * 16 * 32 + 2 * 9 * 16) * 2


class _Summary:
    def __init__(self, busy, window, ranges=None, ops=None):
        self.busy_s, self.window_s = busy, window
        self.ranges, self.ops = ranges or {}, ops or {}

    def op_seconds(self, needle):
        return sum(v for k, v in self.ops.items() if needle in k)


def test_serve_metric_readers():
    sizes = dict(num_layers=2, d_model=16, num_heads=4, num_kv_heads=2,
                 head_dim=4, d_ff=32, vocab_size=64, num_experts=4, top_k=2,
                 d_ff_expert=32, capacity_factor=1.25, dense_residual=True)
    eids = np.array([[0, 1], [1, 2], [0, 3], [2, 3]], np.uint8)
    d = dict(chunk=None, k=2, bt=np.zeros((2, 3), np.int32),
             pos=np.array([5, 9]), blk=np.array([[1, 2], [3, -1]]),
             start=np.zeros(2), nval=np.zeros(2))
    ctx = dict(summary=_Summary(0.5, 2.0, {"moe.block": 1e-3},
                                {"paged_split<128>": 1e-4}),
               sizes=sizes, max_batch=2, routes_traced=[eids],
               dispatches_traced=[d], traced_s=0.2, window_s=10.0,
               stats0={"decode_steps": 0, "slot_busy_steps": 0},
               stats1={"decode_steps": 10, "slot_busy_steps": 15},
               computed_prompt_tokens=60,
               attended_keys=1000, output_tokens=40)
    got = {n: spec.metric(n).read(ctx) for n in spec.metric_names()
           if spec.metric(n).DRIVER == "serve"}
    assert got["slot_occupancy"] == pytest.approx(75.0)
    assert got["device_idle_share.serve"] == pytest.approx(75.0)
    assert got["decode_forward_ms"] == pytest.approx(100.0)
    C = work.capacity(4, 2, 1.25, 4)
    need = peaks.roofline_s(*work.moe_work(eids.astype(int), 16, 32, 4, C))
    assert got["moe_roofline"] == pytest.approx(100 * need / 1e-3)
    calls = [(1, np.array([6, 10]), np.array([6, 10])),
             (1, np.array([7, 11]), np.array([7, 10]))]
    need = sum(2 * peaks.roofline_s(*work.paged_work(2, T, 4, 4, 2, 6, a, b))
               for T, a, b in calls)
    assert got["paged_attn_roofline"] == pytest.approx(100 * need / 1e-4)
    assert 0 < got["mfu.serve"] < 100


def test_readers_of_an_empty_trace_return_nothing():
    ctx = dict(summary=_Summary(0.0, 1.0), sizes={}, max_batch=2,
               routes_traced=[], dispatches_traced=[], traced_s=0.0,
               stats0={"decode_steps": 0, "slot_busy_steps": 0},
               stats1={"decode_steps": 0, "slot_busy_steps": 0})
    for n in ("moe_roofline", "paged_attn_roofline", "slot_occupancy",
              "decode_forward_ms"):
        assert spec.metric(n).read(ctx) is None
