"""Run one cell of the benchmark and print its result as one JSON line.

    python bench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1>

Run from the root of a checkout on a machine with the card(s) the cell
asks for; the program is ``src/repro_torch`` of the same checkout."""
import time

T0 = time.monotonic()

import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
sys.path[:0] = [str(ROOT / "src"), str(ROOT)]

from bench.lib import harness  # noqa: E402

if __name__ == "__main__":
    harness.setup_env(str(ROOT))
    sys.exit(harness.main(t0=T0))
