"""The benchmark of the PyTorch and CUDA port (``repro_torch``).

``python bench/run.py --workload <cell> --seed <n> --seconds <s> --trace
<0|1>`` runs one cell of ``BENCHMARK.json`` and prints one JSON line.
Everything a cell needs is found by name: ``configs/<config>.json`` (the
sizes as run, with the plain reference in ``reference/``),
``workloads/<cell>.json`` (the driver and its parameters),
``traffic/<mix>.json`` (the parameters of the one traffic generator,
``lib/traffic.py``) and ``metrics/<metric>.py`` (one reader a per-layer
metric).  The yardstick (traffic, trace reduction, peaks, operation and
byte counts, references, comparisons) lives here and imports nothing of
the program.
"""
