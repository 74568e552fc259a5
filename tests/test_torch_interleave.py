"""Port counterpart of ``tests/test_interleave.py``: the port's
VirtualScheduler (DESIGN.md §15): deterministic replay, bounded-DFS
exploration, seeded fuzzing + minimization, and the zero-overhead-
unarmed guarantee of the yield-point hook.

The worlds here are deliberately tiny and self-contained (a shared
counter with an explicit load/store race) so they test the *scheduler*,
not the lock-free primitives.  Each world is built against either
package's scheduler, and every exploration, fuzz run and minimization
is held to the reference's: verdict, executions, distinct states,
exhaustion and the counterexample's schedule.
"""
import functools
import json

import pytest

pytest.importorskip("torch")

from repro.core import interleave as jil  # noqa: E402
from repro_torch.core import interleave as il  # noqa: E402
from repro_torch.core.nbb import HostNBB  # noqa: E402


def _summary(res):
    cx = res.counterexample
    return (res.ok, res.executions, res.distinct_states, res.exhausted,
            None if cx is None else (tuple(cx.schedule), cx.error_type))


def make_race_world(il=il) -> il.World:
    """Two tasks each do a non-atomic read-modify-write of a shared
    counter — the textbook lost update.  ``check`` demands both bumps
    landed, so any schedule interleaving the load/store windows fails."""
    box = {"v": 0}

    def bump() -> None:
        il.yield_point("load", None)
        v = box["v"]
        il.yield_point("store", None)
        box["v"] = v + 1

    return il.World(
        tasks=[("a", bump), ("b", bump)],
        fingerprint=lambda: box["v"],
        check=lambda: (_ for _ in ()).throw(
            AssertionError(f"lost update: v={box['v']}"))
        if box["v"] != 2 else None,
    )


def make_safe_world(il=il) -> il.World:
    """Same shape, but each bump is atomic (single yield before the
    whole RMW) — no interleaving can lose an update."""
    box = {"v": 0}

    def bump() -> None:
        il.yield_point("rmw", None)
        box["v"] += 1

    def check() -> None:
        assert box["v"] == 2

    return il.World(tasks=[("a", bump), ("b", bump)],
                    fingerprint=lambda: box["v"], check=check)


# ---------------------------------------------------------------------------
# Determinism + replay.
# ---------------------------------------------------------------------------
def test_same_schedule_same_run():
    r1 = il.run_schedule(make_race_world, [0, 1, 0, 1], strict=False)
    r2 = il.run_schedule(make_race_world, [0, 1, 0, 1], strict=False)
    assert r1.schedule == r2.schedule
    assert r1.trace == r2.trace
    assert r1.fingerprints == r2.fingerprints
    ref = jil.run_schedule(functools.partial(make_race_world, jil),
                           [0, 1, 0, 1], strict=False)
    assert (r1.schedule, r1.trace, r1.fingerprints, r1.failed) == (
        ref.schedule, ref.trace, ref.fingerprints, ref.failed)


def test_sequential_schedules_pass():
    # Run a fully before b (and vice versa): no lost update.  Three
    # grants finish a task: gate->load park, load->store park, store.
    for sched in ([0, 0, 0, 1, 1, 1], [1, 1, 1, 0, 0, 0]):
        res = il.run_schedule(make_race_world, sched)
        assert not res.failed, res.error


def test_interleaved_schedule_loses_update():
    # a loads, b loads (both see 0), both store 1.
    res = il.run_schedule(make_race_world, [0, 1, 0, 1], strict=False)
    assert res.failed
    assert isinstance(res.error, AssertionError)


def test_strict_replay_divergence():
    # Task 7 never exists.
    with pytest.raises(il.ReplayDivergence):
        il.run_schedule(make_race_world, [7], strict=True)


def test_tolerant_replay_skips_disabled():
    res = il.run_schedule(make_race_world, [0, 0, 0, 0, 0, 0, 1, 1],
                          strict=False)
    # The extra 0s after task a finished are skipped, not fatal.
    assert not res.failed


def test_trace_is_exposed_to_check():
    seen = {}

    def make():
        w = make_safe_world()
        inner = w.check

        def check():
            seen["trace"] = list(w.trace)
            inner()
        w.check = check
        return w

    res = il.run_schedule(make, [])
    assert not res.failed
    assert seen["trace"] == res.trace
    assert all(site == "rmw" for _, site, _ in seen["trace"])


# ---------------------------------------------------------------------------
# Exhaustive bounded DFS.
# ---------------------------------------------------------------------------
def test_explore_finds_lost_update():
    res = il.explore(make_race_world, max_executions=200)
    assert _summary(res) == _summary(jil.explore(
        functools.partial(make_race_world, jil), max_executions=200))
    assert not res.ok
    cx = res.counterexample
    assert cx.error_type == "AssertionError"
    # The counterexample replays from its schedule alone.
    rerun = il.run_schedule(make_race_world, cx.schedule, strict=False)
    assert rerun.failed


def test_explore_exhausts_safe_world():
    res = il.explore(make_safe_world, max_executions=200)
    assert _summary(res) == _summary(jil.explore(
        functools.partial(make_safe_world, jil), max_executions=200))
    assert res.ok
    assert res.exhausted
    assert res.executions >= 2          # both first-choice branches


def test_explore_pruning_reduces_executions():
    pruned = il.explore(make_safe_world, max_executions=500, prune=True)
    full = il.explore(make_safe_world, max_executions=500, prune=False)
    assert pruned.ok and full.ok
    assert pruned.executions <= full.executions
    ref = functools.partial(make_safe_world, jil)
    assert (_summary(pruned), _summary(full)) == (
        _summary(jil.explore(ref, max_executions=500, prune=True)),
        _summary(jil.explore(ref, max_executions=500, prune=False)))


def test_explore_budget_reported_not_exhausted():
    res = il.explore(make_race_world, max_executions=1)
    if res.ok:                           # did not stumble on the bug yet
        assert not res.exhausted


# ---------------------------------------------------------------------------
# Fuzzing: seed reproducibility + minimization.
# ---------------------------------------------------------------------------
def test_fuzz_finds_and_minimizes():
    res = il.fuzz(make_race_world, seed=7, runs=200)
    assert not res.ok
    cx = res.counterexample
    want = jil.fuzz(functools.partial(make_race_world, jil), seed=7,
                    runs=200).counterexample
    assert (cx.seed, cx.run, list(cx.schedule), cx.error_type) == (
        want.seed, want.run, list(want.schedule), want.error_type)
    # Reproducible from (seed, run) alone — the printed repro recipe.
    rerun = il.replay_seed(make_race_world, cx.seed, cx.run)
    assert rerun.failed
    assert type(rerun.error).__name__ == cx.error_type
    # And from the minimized schedule alone.
    replay = il.run_schedule(make_race_world, cx.schedule, strict=False)
    assert replay.failed
    # Minimal lost-update interleaving: two loads before any store.
    assert len(cx.schedule) <= 4
    assert "replay:" in cx.repro("race")


def test_fuzz_clean_world_ok():
    res = il.fuzz(make_safe_world, seed=3, runs=50)
    assert res.ok
    assert res.runs == 50


def test_minimize_is_idempotent():
    failing = il.run_schedule(make_race_world, [0, 1, 0, 1], strict=False)
    m1 = il.minimize(make_race_world, failing)
    import dataclasses
    m2 = il.minimize(make_race_world,
                     dataclasses.replace(failing, schedule=m1))
    assert len(m2) <= len(m1) <= 4
    ref = functools.partial(make_race_world, jil)
    assert list(m1) == list(jil.minimize(ref, jil.run_schedule(
        ref, [0, 1, 0, 1], strict=False)))


# ---------------------------------------------------------------------------
# Livelock detection.
# ---------------------------------------------------------------------------
def test_livelock_flagged():
    def make():
        def spin() -> None:
            while True:
                il.yield_point("spin", None)

        return il.World(tasks=[("s", spin)])

    res = il.run_schedule(make, [], max_steps=50)
    assert res.livelocked and res.failed


# ---------------------------------------------------------------------------
# Zero-overhead unarmed: the hook must not fire outside a scheduler.
# ---------------------------------------------------------------------------
def test_unarmed_hot_path_zero_hits():
    assert il._active is None
    before = il.ARMED_HITS
    ring = HostNBB(8)
    for i in range(1000):
        ring.insert_item(i)
        ring.read_item()
    assert il.ARMED_HITS == before
    assert il._active is None


def test_armed_hits_counted():
    before = il.ARMED_HITS
    res = il.run_schedule(make_safe_world, [])
    assert not res.failed
    assert il.ARMED_HITS - before == len(res.trace) > 0
    assert il._active is None            # disarmed after the run


# ---------------------------------------------------------------------------
# Schedule corpus serialization.
# ---------------------------------------------------------------------------
def test_schedule_roundtrip(tmp_path):
    p = tmp_path / "s.json"
    il.save_schedule(p, scenario="race", schedule=[0, 1, 0, 1],
                     expect="violation", note="lost update", seed=7)
    rec = il.load_schedule(p)
    assert rec["scenario"] == "race"
    assert rec["schedule"] == [0, 1, 0, 1]
    assert rec["expect"] == "violation"
    assert rec["seed"] == 7


def test_schedule_expect_validated(tmp_path):
    p = tmp_path / "bad.json"
    p.write_text(json.dumps({"scenario": "x", "schedule": [],
                             "expect": "maybe"}))
    with pytest.raises(ValueError):
        il.load_schedule(p)
