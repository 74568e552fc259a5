"""Deterministic concurrency checking for the lock-free core.

The JAX package's checker (``repro.checker``), pointed at the port's own
core modules: each scenario drives ``repro_torch.core``.  Layers:

* :mod:`repro_torch.core.interleave` — the schedule-controlled
  VirtualScheduler, bounded-DFS explorer, seeded fuzzer and schedule
  minimizer (lives in ``core`` so every primitive can host its yield
  points without an import cycle).
* :mod:`repro_torch.checker.lin` — Wing & Gong linearizability checking over
  recorded histories.
* :mod:`repro_torch.checker.specs` — pure sequential specifications of
  ring/queue/allocator/FSM semantics.
* :mod:`repro_torch.checker.detectors` — torn-read / happens-before detection
  over yield traces (the NBB epoch protocol's Safety property).
* :mod:`repro_torch.checker.scenarios` — the scenario registry: bounded casts
  of tasks + invariants, explored exhaustively by the tests and by
  ``chip_smoke.py``'s checker phase.
"""
from repro_torch.checker import detectors, lin, scenarios, specs  # noqa: F401
from repro_torch.checker.lin import (  # noqa: F401
    MISSING, LinearizabilityViolation, OpRecord, Recorder,
    assert_linearizable, check_history,
)
from repro_torch.checker.detectors import (  # noqa: F401
    TornRead, TornReadDetected, assert_no_torn_reads, find_torn_reads,
)
from repro_torch.checker.scenarios import (  # noqa: F401
    SCENARIOS, explore_scenario, fuzz_scenario, replay,
)
