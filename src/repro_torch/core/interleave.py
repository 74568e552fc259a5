"""Deterministic interleaving control: schedule-driven model checking.

The paper's claim is that *packaging* lock-free algorithms removes
concurrency defects from application code — which makes the package
itself the single point where a defect would be catastrophic, and the
repo's real-thread stress tests cannot reproduce a failure they
provoke, let alone enumerate the interleavings they missed.  This
module makes every interleaving of the lock-free core a first-class,
replayable object:

  * A :class:`VirtualScheduler` runs N logical tasks — ordinary Python
    callables exercising the REAL primitives (``HostNBB``,
    ``MpscQueue``, ``StateCell``, ``RefCountArray``, ``HostBitset``,
    ``OpHandle`` ...) — under cooperative control.  Each task is a real
    thread, but exactly ONE runs at any moment: at every instrumented
    shared-memory access the running task parks and the scheduler picks
    who advances next.  Between yield points execution is atomic, which
    matches CPython's bytecode-atomicity memory model (the model the
    host primitives are written against).
  * Yield points are threaded through the primitives via the
    module-level hook ``_active`` — the same style and the same
    zero-overhead-unarmed guarantee as ``core/faults.py`` sites: the
    unarmed fast path is one ``is None`` check per site, the hook fires
    zero times, and no scheduler machinery is ever constructed.
  * :func:`explore` is a bounded-DFS stateless model checker: it
    re-executes a scenario along every schedule prefix, branching at
    each step over the enabled tasks, with state-fingerprint pruning
    (two executions reaching the same (structure state, task program
    counters) have identical futures, so one subtree suffices).
  * :func:`fuzz` is a seeded random-schedule explorer for scenarios too
    large to enumerate; a failure is automatically shrunk by
    :func:`minimize` (truncation + ddmin over the choice list) and is
    reproducible from ``(seed, run)`` alone — the printed repro line is
    the whole bug report.
  * Schedules serialize to JSON (:func:`save_schedule` /
    :func:`load_schedule`) so minimized counterexamples live in
    ``tests/schedules/`` as a tier-1 replay corpus.

The linearizability checker, sequential specs and the torn-read
detector that consume the traces produced here live in
the interleaving checker (this module stays dependency-free so every core
primitive may import it).
"""
from __future__ import annotations

import dataclasses
import json
import random
import threading
from typing import Any, Callable, Dict, List, Optional, Sequence, Tuple

# ---------------------------------------------------------------------------
# The module-level hook.  Unarmed (`None`) the instrumented sites cost one
# attribute load + `is None` check and nothing else; armed, it is the
# VirtualScheduler currently running and every site parks the calling task.
# ---------------------------------------------------------------------------
_active: Optional["VirtualScheduler"] = None

#: Total yield points taken by armed schedulers (diagnostics; bench_check
#: asserts this stays put across an unarmed hot-path run: zero added ops).
ARMED_HITS = 0


def yield_point(site: str, info: Any = None) -> None:
    """Cold-path convenience hook (hot paths inline the ``_active`` check)."""
    a = _active
    if a is not None:
        a.yield_point(site, info)


class SchedulerAbort(BaseException):
    """Unwinds a task when the scheduler aborts an execution (max_steps,
    or teardown).  BaseException so scenario code cannot swallow it."""


class LivelockError(RuntimeError):
    """An execution exceeded max_steps — under a fair bounded scenario
    this means some task spins without progress."""


class ReplayDivergence(RuntimeError):
    """A replayed schedule chose a task that is not enabled — the
    scenario changed shape since the schedule was recorded."""


# ---------------------------------------------------------------------------
# Tasks and the scheduler.
# ---------------------------------------------------------------------------
class _Task:
    __slots__ = ("tid", "name", "fn", "go", "parked", "thread",
                 "finished", "error", "grants", "site", "info")

    def __init__(self, tid: int, name: str, fn: Callable[[], None]):
        self.tid = tid
        self.name = name
        self.fn = fn
        self.go = threading.Event()
        self.parked = threading.Event()
        self.thread: Optional[threading.Thread] = None
        self.finished = False
        self.error: Optional[BaseException] = None
        self.grants = 0           # times scheduled (the task's "pc" proxy)
        self.site: Optional[str] = None   # site parked at (None = at gate)
        self.info: Any = None


@dataclasses.dataclass
class World:
    """One fresh instance of a scenario: tasks plus optional observers.

    ``tasks``       — list of (name, zero-arg callable) run under control.
    ``fingerprint`` — () -> hashable snapshot of ALL shared state the
                      tasks touch (ring counters+slots, refcounts, FSM
                      state, recorded history...).  Enables DFS pruning;
                      omit it and exploration is purely schedule-tree.
                      Caveat: task-local state not reflected here makes
                      pruning unsound — scenarios route results through
                      a recorded history for exactly this reason.
    ``check``       — () -> None post-run invariant (runs disarmed, in
                      the main thread); raise AssertionError to fail.
    ``history``     — opaque payload for checkers (the checker reads
                      recorded op histories through it).
    ``trace``       — filled in by the scheduler before ``check`` runs:
                      the (tid, site, info) yield trace of the execution,
                      so checks can run trace detectors (torn reads).
    """

    tasks: List[Tuple[str, Callable[[], None]]]
    fingerprint: Optional[Callable[[], Any]] = None
    check: Optional[Callable[[], None]] = None
    history: Any = None
    trace: Optional[List[Tuple[int, str, Any]]] = None


@dataclasses.dataclass
class RunResult:
    schedule: Tuple[int, ...]           # task chosen at each step
    enabled: List[Tuple[int, ...]]      # enabled task ids at each step
    fingerprints: List[Any]             # state fp BEFORE each step (or None)
    trace: List[Tuple[int, str, Any]]   # (tid, site, info) per yield point
    error: Optional[BaseException]
    livelocked: bool
    task_names: Tuple[str, ...]

    @property
    def failed(self) -> bool:
        return self.error is not None or self.livelocked


class VirtualScheduler:
    """Runs one World's tasks under cooperative, deterministic control.

    Exactly one task thread runs between two scheduler decisions; the
    handshake is a pair of Events per task (``go`` grants, ``parked``
    returns control at the next yield point or at task completion).
    Determinism therefore needs no cooperation from the GIL: the trace
    is a pure function of the chooser's decisions.
    """

    def __init__(self, world: World, step_timeout_s: float = 30.0):
        self.world = world
        self.tasks = [_Task(i, name, fn)
                      for i, (name, fn) in enumerate(world.tasks)]
        self._by_ident: Dict[int, _Task] = {}
        self._aborting = False
        self._step_timeout_s = step_timeout_s
        self.trace: List[Tuple[int, str, Any]] = []

    # -- called from task threads (via the module hook) ---------------------
    def yield_point(self, site: str, info: Any = None) -> None:
        t = self._by_ident.get(threading.get_ident())
        if t is None:
            return                      # not a controlled task: no-op
        global ARMED_HITS
        ARMED_HITS += 1
        if self._aborting:
            raise SchedulerAbort()
        t.site, t.info = site, info
        self.trace.append((t.tid, site, info))
        t.parked.set()                  # hand control back ...
        t.go.wait()                     # ... and wait to be rescheduled
        t.go.clear()
        if self._aborting:
            raise SchedulerAbort()

    def _task_body(self, t: _Task) -> None:
        t.go.wait()                     # initial gate: wait for first grant
        t.go.clear()
        try:
            if not self._aborting:
                t.fn()
        except SchedulerAbort:
            pass
        except BaseException as e:      # noqa: BLE001 — surfaced as result
            t.error = e
        finally:
            t.finished = True
            t.parked.set()

    # -- main-thread driver --------------------------------------------------
    def run(self, chooser: Callable[[int, Tuple[int, ...], List], int],
            max_steps: int = 2000) -> RunResult:
        global _active
        if _active is not None:
            raise RuntimeError("a VirtualScheduler is already armed")
        schedule: List[int] = []
        enabled_log: List[Tuple[int, ...]] = []
        fps: List[Any] = []
        error: Optional[BaseException] = None
        livelocked = False
        _active = self
        try:
            for t in self.tasks:
                t.thread = threading.Thread(
                    target=self._task_body, args=(t,),
                    name=f"vsched-{t.name}", daemon=True)
                t.thread.start()
                # ident is set by start(); the task blocks at its gate
                # until first granted, so registering here is race-free.
                self._by_ident[t.thread.ident] = t

            step = 0
            while True:
                live = [t for t in self.tasks if not t.finished]
                if not live:
                    break
                if any(t.error for t in self.tasks):
                    break
                if step >= max_steps:
                    livelocked = True
                    break
                enabled = tuple(t.tid for t in live)
                fps.append(self._fingerprint())
                choice = chooser(step, enabled, self.trace)
                if choice not in enabled:
                    raise ReplayDivergence(
                        f"step {step}: chose task {choice}, "
                        f"enabled={enabled}")
                schedule.append(choice)
                enabled_log.append(enabled)
                self._grant(self.tasks[choice])
                step += 1
            error = next((t.error for t in self.tasks if t.error), None)
        finally:
            self._teardown()
            _active = None
        self.world.trace = list(self.trace)
        if error is None and not livelocked and self.world.check is not None:
            try:
                self.world.check()
            except BaseException as e:  # noqa: BLE001 — surfaced as result
                error = e
        return RunResult(schedule=tuple(schedule), enabled=enabled_log,
                         fingerprints=fps, trace=self.trace, error=error,
                         livelocked=livelocked,
                         task_names=tuple(t.name for t in self.tasks))

    def _grant(self, t: _Task) -> None:
        t.parked.clear()
        t.grants += 1
        t.go.set()
        if not t.parked.wait(self._step_timeout_s):
            self._aborting = True
            raise RuntimeError(
                f"task {t.name!r} did not yield within "
                f"{self._step_timeout_s}s — blocking call inside a "
                f"controlled task?")

    def _fingerprint(self) -> Any:
        if self.world.fingerprint is None:
            return None
        pcs = tuple((t.tid, t.grants, t.site, t.finished)
                    for t in self.tasks)
        return (pcs, self.world.fingerprint())

    def _teardown(self) -> None:
        """Drive every unfinished task to completion via SchedulerAbort."""
        self._aborting = True
        for t in self.tasks:
            if t.thread is None:
                continue
            while not t.finished:
                t.parked.clear()
                t.go.set()
                if not t.parked.wait(self._step_timeout_s):
                    break               # leave the daemon thread behind
            t.thread.join(timeout=1.0)


# ---------------------------------------------------------------------------
# Choosers.
# ---------------------------------------------------------------------------
class ReplayChooser:
    """Replay a recorded schedule, then continue first-enabled.

    ``strict=False`` (the minimizer's mode) skips recorded choices that
    are no longer enabled instead of raising, so deleting steps from a
    schedule still yields a meaningful run."""

    def __init__(self, schedule: Sequence[int], strict: bool = True):
        self.schedule = list(schedule)
        self.strict = strict
        self._i = 0

    def __call__(self, step: int, enabled: Tuple[int, ...], trace) -> int:
        while self._i < len(self.schedule):
            c = self.schedule[self._i]
            self._i += 1
            if c in enabled:
                return c
            if self.strict:
                raise ReplayDivergence(
                    f"recorded task {c} not enabled at step {step} "
                    f"(enabled={enabled})")
        return enabled[0]


class RandomChooser:
    """Seeded uniform choice over enabled tasks (the fuzz schedule)."""

    def __init__(self, rng: random.Random):
        self.rng = rng

    def __call__(self, step: int, enabled: Tuple[int, ...], trace) -> int:
        return self.rng.choice(enabled)


def run_schedule(make_world: Callable[[], World],
                 schedule: Sequence[int] = (),
                 max_steps: int = 2000, strict: bool = True,
                 ) -> RunResult:
    """One execution: forced ``schedule`` prefix, then first-enabled."""
    world = make_world()
    sched = VirtualScheduler(world)
    return sched.run(ReplayChooser(schedule, strict=strict),
                     max_steps=max_steps)


# ---------------------------------------------------------------------------
# Bounded-DFS exhaustive exploration with state-fingerprint pruning.
# ---------------------------------------------------------------------------
@dataclasses.dataclass
class Counterexample:
    schedule: Tuple[int, ...]
    error: str
    error_type: str
    task_names: Tuple[str, ...]
    trace_sites: Tuple[str, ...]
    seed: Optional[int] = None          # set by fuzz(): replay from seed
    run: Optional[int] = None

    def repro(self, scenario: str = "<scenario>") -> str:
        """The printed one-line reproduction recipe."""
        if self.seed is not None:
            return (f"replay: interleave.replay_seed({scenario!r}, "
                    f"seed={self.seed}, run={self.run})  "
                    f"# minimized schedule: {list(self.schedule)}")
        return (f"replay: interleave.run_schedule({scenario!r}, "
                f"schedule={list(self.schedule)})")


@dataclasses.dataclass
class ExploreResult:
    executions: int
    distinct_states: int
    exhausted: bool                     # full tree covered within budget
    counterexample: Optional[Counterexample]
    max_trace_len: int = 0

    @property
    def ok(self) -> bool:
        return self.counterexample is None


def _as_counterexample(res: RunResult) -> Counterexample:
    err = res.error if res.error is not None else LivelockError(
        "execution exceeded max_steps")
    return Counterexample(
        schedule=res.schedule, error=repr(err),
        error_type=type(err).__name__, task_names=res.task_names,
        trace_sites=tuple(s for _, s, _ in res.trace))


def explore(make_world: Callable[[], World], *,
            max_executions: int = 20000, max_steps: int = 2000,
            prune: bool = True) -> ExploreResult:
    """Exhaustive bounded DFS over all interleavings of a scenario.

    Re-executes from scratch per schedule prefix (stateless model
    checking — thread state cannot be forked), branching at every step
    over every enabled task.  With ``prune`` and a World fingerprint,
    a state already branched from is never branched again: two runs
    reaching identical (task pcs, shared state) have identical futures.
    ``exhausted`` is True iff the (pruned) tree was fully covered.
    """
    stack: List[Tuple[int, ...]] = [()]
    branched: set = set()
    distinct: set = set()
    executions = 0
    max_trace = 0
    while stack:
        if executions >= max_executions:
            return ExploreResult(executions, len(distinct), False, None,
                                 max_trace)
        prefix = stack.pop()
        res = run_schedule(make_world, prefix, max_steps=max_steps)
        executions += 1
        max_trace = max(max_trace, len(res.schedule))
        if res.failed:
            return ExploreResult(executions, len(distinct), False,
                                 _as_counterexample(res), max_trace)
        # Branch over the suffix beyond the forced prefix (reversed so
        # the DFS pops low task ids first — deterministic order).
        for i in range(len(res.schedule) - 1, len(prefix) - 1, -1):
            alts = [a for a in res.enabled[i] if a != res.schedule[i]]
            if not alts:
                continue
            fp = res.fingerprints[i]
            if prune and fp is not None:
                if fp in branched:
                    continue
                branched.add(fp)
            for a in alts:
                stack.append(res.schedule[:i] + (a,))
        for fp in res.fingerprints:
            if fp is not None:
                distinct.add(fp)
    return ExploreResult(executions, len(distinct), True, None, max_trace)


# ---------------------------------------------------------------------------
# Seeded random-schedule fuzzing + automatic minimization.
# ---------------------------------------------------------------------------
def _run_seed(make_world: Callable[[], World], seed: int, run: int,
              max_steps: int) -> RunResult:
    rng = random.Random(seed * 1000003 + run)
    world = make_world()
    return VirtualScheduler(world).run(RandomChooser(rng),
                                       max_steps=max_steps)


@dataclasses.dataclass
class FuzzResult:
    runs: int
    counterexample: Optional[Counterexample]
    seed: int

    @property
    def ok(self) -> bool:
        return self.counterexample is None


def fuzz(make_world: Callable[[], World], *, seed: int = 0,
         runs: int = 200, max_steps: int = 2000,
         shrink: bool = True) -> FuzzResult:
    """Random schedules from a seed; first failure is minimized and is
    reproducible from ``(seed, run)`` alone (:func:`replay_seed`)."""
    for k in range(runs):
        res = _run_seed(make_world, seed, k, max_steps)
        if res.failed:
            schedule = res.schedule
            if shrink:
                schedule = minimize(make_world, res, max_steps=max_steps)
            cx = _as_counterexample(
                dataclasses.replace(res, schedule=tuple(schedule)))
            cx.seed, cx.run = seed, k
            return FuzzResult(runs=k + 1, counterexample=cx, seed=seed)
    return FuzzResult(runs=runs, counterexample=None, seed=seed)


def replay_seed(make_world: Callable[[], World], seed: int, run: int,
                max_steps: int = 2000) -> RunResult:
    """Re-run exactly the fuzz execution ``(seed, run)``."""
    return _run_seed(make_world, seed, run, max_steps)


def _same_failure(res: RunResult, ref: RunResult) -> bool:
    if not res.failed:
        return False
    if res.livelocked and ref.livelocked:
        return True
    if res.error is None or ref.error is None:
        return False
    return type(res.error) is type(ref.error)


def minimize(make_world: Callable[[], World], failing: RunResult,
             max_steps: int = 2000) -> Tuple[int, ...]:
    """Delta-debug a failing schedule: truncate the suffix (the default
    first-enabled continuation is deterministic), then ddmin chunk
    deletion, then pointwise deletion.  Replay is tolerant (a deleted
    step's choice may no longer be enabled), so every candidate is a
    meaningful run.  Returns the shortest schedule still reproducing
    the same failure type."""
    def fails(candidate: Sequence[int]) -> bool:
        res = run_schedule(make_world, candidate, max_steps=max_steps,
                           strict=False)
        return _same_failure(res, failing)

    best = list(failing.schedule)
    # Phase 1: binary-search the shortest failing prefix.
    lo, hi = 0, len(best)
    while lo < hi:
        mid = (lo + hi) // 2
        if fails(best[:mid]):
            hi = mid
        else:
            lo = mid + 1
    best = best[:hi]
    # Phase 2: ddmin — remove halving chunks while the failure persists.
    chunk = max(1, len(best) // 2)
    while chunk >= 1:
        i = 0
        while i < len(best):
            candidate = best[:i] + best[i + chunk:]
            if fails(candidate):
                best = candidate
            else:
                i += chunk
        chunk //= 2
    return tuple(best)


# ---------------------------------------------------------------------------
# Schedule (de)serialization — the tests/schedules/ replay corpus format.
# ---------------------------------------------------------------------------
def save_schedule(path, *, scenario: str, schedule: Sequence[int],
                  expect: str, note: str = "",
                  seed: Optional[int] = None) -> None:
    rec = {"scenario": scenario, "schedule": list(schedule),
           "expect": expect, "note": note}
    if seed is not None:
        rec["seed"] = seed
    with open(path, "w") as f:
        json.dump(rec, f, indent=1)
        f.write("\n")


def load_schedule(path) -> dict:
    with open(path) as f:
        rec = json.load(f)
    if rec.get("expect") not in ("pass", "violation"):
        raise ValueError(f"{path}: expect must be 'pass' or 'violation'")
    return rec
