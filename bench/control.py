"""The check's two readings for a cell, on the card at the cell's own
size: for each seed, one run of the program with a short window, the
numbers its check compares (the lower readings) and the same numbers
for the control, the plain reference computed in float8 e4m3 operands
in the program's place (the upper readings); with ``--fault``, a run
with that fault planted under the timed path instead.

    python bench/control.py --workload <cell> --seeds 1,2,3 \\
        --seconds 10 [--fault alter_token]

Prints one JSON line a seed, then a summary line: the largest program
reading and the smallest control (or fault) reading of each number."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench.lib import harness  # noqa: E402
from bench.lib.stats import free_device_memory  # noqa: E402


def readings(cell: str, seeds, seconds: float, fault=None,
             device: str = "cuda", smoke: bool = False) -> dict:
    """{"program": [readings a seed], "other": [control or fault readings a
    seed], "correct_other": [bool a seed]}."""
    out = {"program": [], "other": [], "correct_other": []}
    for seed in seeds:
        ctx = harness.context(cell, seed, seconds, False, device=device,
                              smoke=smoke, t0=time.monotonic(), fault=fault,
                              control=fault is None)
        drv = harness.spec.driver(ctx.workload["driver"])
        res = drv.run(ctx)
        other = res["control"] if fault is None else res["readings"]
        del res["layer_ctx"]
        free_device_memory()
        out["program"].append(res["readings"])
        out["other"].append(other)
        out["correct_other"].append(bool(res["correct"]))
        print(json.dumps({"seed": seed, "fault": fault,
                          "program": res["readings"], "other": other,
                          "correct": res["correct"]}), flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__)
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--fault", default=None)
    args = ap.parse_args(argv)
    harness.setup_env(str(ROOT))
    seeds = [int(s) for s in args.seeds.split(",")]
    got = readings(args.workload, seeds, args.seconds, args.fault)
    keys = [k for k, v in got["program"][0].items()
            if isinstance(v, float)]
    print(json.dumps({
        "lower": {k: max(r[k] for r in got["program"]) for k in keys},
        "upper": {k: min(r.get(k, float("inf")) for r in got["other"])
                  for k in keys},
        "other_correct": got["correct_other"]}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
