"""Reduction of a ``torch.profiler`` trace to device seconds: busy time
(the union of the device operations' intervals), each profiler range's
device time (the kernels that start inside the range's device-side
annotation, as ``chip_smoke.py``'s ``range_ms`` takes it), the device
operations that took most time, and the idle gaps labelled by what the
host was doing.  A frozen copy: later program changes cannot move it."""
from __future__ import annotations

import bisect
import itertools
from typing import Dict, Iterable, List, Tuple

# The program's record_function ranges: device-side annotations, not
# device work, so they are never counted as operations.
RANGES = ("flash_attention_trainable.backward", "adamw.update",
          "attention.fill_unseen", "moe.block", "mamba.ssd", "rwkv.wkv")


class Summary:
    """What a traced slice says, in seconds: ``busy_s``, ``window_s``,
    ``ranges`` {range: device s}, ``ops`` {device op: s}, ``gaps``
    {host activity: idle s}, and ``kernels`` [(name, start, end)] in
    microseconds on the trace's clock."""

    def __init__(self, busy_s, window_s, ranges, ops, gaps, kernels):
        self.busy_s, self.window_s = busy_s, window_s
        self.ranges, self.ops, self.gaps = ranges, ops, gaps
        self.kernels = kernels

    def op_seconds(self, needle: str) -> float:
        """Device seconds of the operations whose name holds ``needle``."""
        return sum(s for name, s in self.ops.items() if needle in name)

    def breakdown(self, n: int = 10) -> dict:
        top = sorted(self.ops.items(), key=lambda kv: -kv[1])[:n]
        gaps = sorted(self.gaps.items(), key=lambda kv: -kv[1])[:n]
        return {"device_ops": [[k, v] for k, v in top],
                "idle_gaps": [[k, v] for k, v in gaps]}


def merge(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of ``intervals`` as sorted, disjoint intervals."""
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def range_seconds(annotations, kernels) -> Dict[str, float]:
    """{range name: device s of the kernels starting inside its
    annotations}; ``annotations`` and ``kernels`` are (name, start, end)
    in microseconds."""
    ks = sorted((a, b) for _, a, b in kernels)
    starts = [a for a, _ in ks]
    total = [0.0, *itertools.accumulate(b - a for a, b in ks)]
    out: Dict[str, float] = {}
    for name, a, b in annotations:
        i, j = bisect.bisect_left(starts, a), bisect.bisect_left(starts, b)
        out[name] = out.get(name, 0.0) + (total[j] - total[i]) / 1e6
    return out


def idle_gaps(busy: List[Tuple[float, float]], lo: float, hi: float,
              host: List[Tuple[str, float, float]], labelled: int = 200
              ) -> Dict[str, float]:
    """{label: idle s}: the gaps between busy intervals in [lo, hi].  The
    ``labelled`` longest gaps are each labelled by the shortest host
    event that covers their midpoint ("host: none" where none does); the
    rest are summed under "shorter gaps"."""
    host = sorted(host, key=lambda h: h[1])
    starts = [h[1] for h in host]
    edges = [lo] + [x for iv in busy for x in iv] + [hi]
    gaps = [(max(a, lo), min(b, hi)) for a, b in zip(edges[0::2], edges[1::2])]
    gaps = sorted((g for g in gaps if g[1] > g[0]), key=lambda g: g[0] - g[1])
    out: Dict[str, float] = {}
    for i, (a, b) in enumerate(gaps):
        label = "shorter gaps"
        if i < labelled:
            mid, best = (a + b) / 2, None
            for name, s, e in host[:bisect.bisect_right(starts, mid)]:
                if e >= mid and (best is None or e - s < best[1]):
                    best = (name, e - s)
            label = best[0] if best else "host: none"
        out[label] = out.get(label, 0.0) + (b - a) / 1e6
    return out


def summarize(prof, window_s: float, ranges=RANGES,
              gap_host_events: int = 200000) -> Summary:
    """Reduce ``prof`` (a stopped ``torch.profiler.profile``) over a
    slice that lasted ``window_s`` seconds on the host's clock."""
    from torch.autograd import DeviceType
    names = set(ranges)
    kernels, annotations, host = [], [], []
    for e in prof.events():
        tr = e.time_range
        if e.device_type == DeviceType.CUDA:
            if e.name in names or getattr(e, "is_user_annotation", False):
                annotations.append((e.name, tr.start, tr.end))
            else:
                kernels.append((e.name, tr.start, tr.end))
        elif len(host) < gap_host_events:
            host.append((e.name, tr.start, tr.end))
    busy = merge((a, b) for _, a, b in kernels)
    busy_s = sum(b - a for a, b in busy) / 1e6
    ops: Dict[str, float] = {}
    for name, a, b in kernels:
        ops[name] = ops.get(name, 0.0) + (b - a) / 1e6
    if kernels or host:
        lo = min([a for _, a, _ in kernels] + [a for _, a, _ in host])
        hi = max(lo + window_s * 1e6,
                 max([b for _, _, b in kernels] + [lo]))
        gaps = idle_gaps(busy, lo, hi, host)
    else:
        gaps = {}
    return Summary(busy_s, window_s, range_seconds(annotations, kernels),
                   ops, gaps, kernels)
