"""Small numeric helpers of the harness."""
from __future__ import annotations

from typing import Sequence

import numpy as np


def pct(values: Sequence[float], q: float) -> float:
    """The q-th percentile (linear interpolation between order
    statistics); NaN of an empty list."""
    return float(np.percentile(np.asarray(values, float), q)) \
        if len(values) else float("nan")


def device_info(device: str, chips: int, peak: int, extra=None) -> dict:
    import torch
    if device == "cpu":
        info = {"platform": "cpu", "kind": "cpu", "count": chips,
                "memory_peak_bytes": 0}
    else:
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                "count": chips, "memory_peak_bytes": int(peak)}
    info.update(extra or {})
    return info


def free_device_memory() -> None:
    import gc

    import torch
    gc.collect()
    if torch.cuda.is_available():
        torch.cuda.synchronize()
        torch.cuda.empty_cache()


def start_profiler(dev):
    """A ``torch.profiler`` trace of the host and (on the card) the
    device, started now."""
    from torch.profiler import ProfilerActivity, profile
    acts = [ProfilerActivity.CPU]
    if dev != "cpu":
        acts.append(ProfilerActivity.CUDA)
    prof = profile(activities=acts)
    prof.__enter__()
    return prof


def stop_profiler(prof, dev) -> float:
    """Stops the trace once the device has finished; returns the host
    time at which it had (the profiler's own stop is not in the slice)."""
    import time

    import torch
    if dev != "cpu":
        torch.cuda.synchronize()
    t1 = time.monotonic()
    prof.__exit__(None, None, None)
    return t1


def warm_profiler(dev) -> None:
    """One short trace in set-up: the profiler's first start (CUPTI's
    set-up) took seconds on the card, inside the traced slice."""
    import torch
    prof = start_profiler(dev)
    torch.ones(8, device=dev).sum().item()
    stop_profiler(prof, dev)
