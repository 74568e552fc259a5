"""The port's interleaving checker (``repro_torch.checker``) against the
JAX package's (``repro.checker``): counterparts of
``test_linearizability.py``, ``test_checker_faults.py`` and
``test_schedule_corpus.py``.

Every registered scenario is explored in both packages at the budget of
``benchmarks/bench_check.py``'s quick mode (its own budget, at most 1500
executions): the verdict, the executions, the distinct states, whether
the tree was exhausted and the convicting schedule must be equal, and
the verdict must be the scenario's ``expect``.  The ``tests/schedules/``
corpus is read in place and replayed in both."""
import glob
import os

import pytest

pytest.importorskip("torch")

from repro.checker import scenarios as jscenarios  # noqa: E402
from repro.core import interleave as jil  # noqa: E402
from repro_torch.checker import lin, scenarios, specs  # noqa: E402
from repro_torch.checker.lin import (MISSING, OpRecord, Recorder,  # noqa: E402
                                     ops_from_history)
from repro_torch.core import faults, states  # noqa: E402
from repro_torch.core import interleave as il  # noqa: E402

CORPUS = sorted(glob.glob(os.path.join(os.path.dirname(__file__),
                                       "schedules", "*.json")))
QUICK_BUDGET = 1500


def _summary(r):
    cx = r.counterexample
    return (r.ok, r.executions, r.distinct_states, r.exhausted,
            None if cx is None else (tuple(cx.schedule), cx.error_type))


def test_same_scenarios_registered():
    assert list(scenarios.SCENARIOS) == list(jscenarios.SCENARIOS)
    for name, scen in scenarios.SCENARIOS.items():
        ref = jscenarios.SCENARIOS[name]
        assert (scen.expect, scen.structure, scen.explore_budget,
                scen.max_steps) == (ref.expect, ref.structure,
                                    ref.explore_budget, ref.max_steps)


@pytest.mark.parametrize("name", sorted(jscenarios.SCENARIOS))
def test_scenario_matches_reference(name):
    scen = scenarios.get(name)
    budget = min(scen.explore_budget, QUICK_BUDGET)
    got = scenarios.explore_scenario(name, max_executions=budget)
    want = jscenarios.explore_scenario(name, max_executions=budget)
    assert _summary(got) == _summary(want)
    assert got.ok == (scen.expect == "pass"), (
        f"{name}: {got.counterexample and got.counterexample.error}")


@pytest.mark.parametrize("name", ["spsc_scalar", "statecell_compaction",
                                  "torn_span_recovery",
                                  "mpsc_dead_producer"])
def test_fuzz_matches_reference(name):
    got = scenarios.fuzz_scenario(name, seed=1, runs=20)
    want = jscenarios.fuzz_scenario(name, seed=1, runs=20)
    assert got.ok and want.ok
    assert got.runs == want.runs


def test_corpus_exists():
    assert len(CORPUS) == 6, CORPUS


@pytest.mark.parametrize("path", CORPUS,
                         ids=[os.path.basename(p) for p in CORPUS])
def test_corpus_replays_as_in_reference(path):
    rec = il.load_schedule(path)
    assert rec == jil.load_schedule(path)
    scen, jscen = scenarios.get(rec["scenario"]), jscenarios.get(
        rec["scenario"])
    res = il.run_schedule(scen.make_world, rec["schedule"],
                          max_steps=scen.max_steps, strict=False)
    ref = jil.run_schedule(jscen.make_world, rec["schedule"],
                           max_steps=jscen.max_steps, strict=False)
    assert res.failed == (rec["expect"] == "violation"), (
        f"{path}: {res.error!r}; note: {rec.get('note', '')}")
    assert res.failed == ref.failed
    assert type(res.error).__name__ == type(ref.error).__name__
    assert [s for _, s, _ in res.trace] == [s for _, s, _ in ref.trace]


# ---------------------------------------------------------------------------
# Wing & Gong units and the sequential specs' strength decisions
# ---------------------------------------------------------------------------
def test_sequential_history_linearizable():
    ops = ops_from_history([
        ("p", "send", (1,), "OK"),
        ("c", "recv", (), ("OK", 1)),
        ("c", "recv", (), ("EMPTY", None)),
    ])
    res = lin.check_history(ops, specs.SpscRingSpec(2))
    assert res.ok and res.linearization == (0, 1, 2)


def test_overlapping_ops_reordered_and_future_rejected():
    legal = [OpRecord(op="recv", args=(), result=("OK", 5), inv=0, res=3,
                      task="c"),
             OpRecord(op="send", args=(5,), result="OK", inv=1, res=2,
                      task="p")]
    assert lin.check_history(legal, specs.SpscRingSpec(2)).ok
    future = [OpRecord(op="recv", args=(), result=("OK", 5), inv=0, res=1,
                       task="c"),
              OpRecord(op="send", args=(5,), result="OK", inv=2, res=3,
                       task="p")]
    res = lin.check_history(future, specs.SpscRingSpec(2))
    assert not res.ok and "NOT linearizable" in res.explain()


def test_pending_op_may_take_effect_or_dangle():
    send = OpRecord(op="send", args=(9,), result=MISSING, inv=0, res=None,
                    task="p")
    for result in (("OK", 9), ("EMPTY", None)):
        ops = [send, OpRecord(op="recv", args=(), result=result, inv=1,
                              res=2, task="c")]
        assert lin.check_history(ops, specs.SpscRingSpec(2)).ok


def test_fsm_cas_strictness():
    spec = specs.FsmSpec(states.OP_TRANSITIONS, states.OP_PENDING)
    both_win = ops_from_history([
        ("a", "cas", (states.OP_PENDING, states.OP_COMPLETED), True),
        ("b", "cas", (states.OP_PENDING, states.OP_CANCELLED), True),
    ])
    assert not lin.check_history(both_win, spec).ok
    one_wins = ops_from_history([
        ("a", "cas", (states.OP_PENDING, states.OP_COMPLETED), True),
        ("b", "cas", (states.OP_PENDING, states.OP_CANCELLED), False),
        ("r", "read", (), states.OP_COMPLETED),
    ])
    assert lin.check_history(one_wins, spec).ok
    must_win = ops_from_history([
        ("a", "cas", (states.OP_PENDING, states.OP_COMPLETED), False)])
    assert not lin.check_history(must_win, spec).ok


def test_recorder_roundtrip_and_budget_guard():
    rec = Recorder()
    a = rec.invoke("t", "send", 1)
    b = rec.invoke("u", "recv")
    rec.respond(b, ("OK", 1))
    rec.respond(a, "OK")
    ops = rec.ops()
    assert [o.op for o in ops] == ["send", "recv"]
    assert ops[0].inv < ops[1].inv < ops[1].res < ops[0].res
    pending = rec.invoke("t", "send", 2)
    assert rec.ops()[pending].result == MISSING
    many = ops_from_history([("t", "send", (i,), "OK") for i in range(12)])
    with pytest.raises(RuntimeError, match="exceeded"):
        lin.check_history(many, specs.SpscRingSpec(64), max_states=4)


def test_weak_refusals_and_partial_bursts():
    refusal = ops_from_history([("t", "try_claim", (), None)])
    assert lin.check_history(refusal, specs.BitsetSpec(2)).ok
    assert lin.check_history(refusal, specs.RefCountSpec(2)).ok
    spec = specs.SpscRingSpec(3)
    assert lin.check_history(ops_from_history([
        ("p", "send_burst", ((0, 1),), ("FULL", 1)),
        ("c", "drain", (4,), (0,))]), spec).ok
    assert not lin.check_history(ops_from_history([
        ("p", "send_burst", ((0, 1),), ("FULL", 1)),
        ("c", "drain", (4,), (0, 1))]), spec).ok
    assert not lin.check_history(ops_from_history([
        ("p", "send_burst", ((0, 1, 2),), ("OK", 3))]),
        specs.SpscRingSpec(2)).ok


# ---------------------------------------------------------------------------
# The fault paths under the scheduler
# ---------------------------------------------------------------------------
def test_recovery_path_reachable():
    sched = [0] * 40 + [2] * 20 + [1] * 20
    res = il.run_schedule(scenarios.get("torn_span_recovery").make_world,
                          sched, max_steps=600, strict=False)
    assert not res.failed, res.error
    assert "reaper.resend" in [s for _, s, _ in res.trace]


def test_injected_fault_is_not_swallowed_by_scheduler():
    from repro_torch.core.nbb import HostNBB
    from repro_torch.core.transport import FaultyTransport

    def make():
        plan = faults.FaultPlan(
            [faults.FaultRule(site="transport.stall", nth=1)], name="s")
        ft = FaultyTransport(HostNBB(4), plan, name="t")
        return il.World(tasks=[("p", lambda: ft.send_burst([1, 2]))])

    res = il.run_schedule(make, [], max_steps=200)
    assert res.failed and isinstance(res.error, faults.InjectedFault)
