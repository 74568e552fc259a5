"""Port counterpart of ``tests/test_linearizability.py``:
linearizability validation of the port's lock-free core (DESIGN.md §15).

Three layers:

* Wing & Gong checker units over hand-built histories — the checker
  must accept classic legal overlaps and reject classic illegal ones
  independent of any scheduler.
* Sequential-spec units — the documented spec-strength decisions
  (strict SPSC/FSM, weak scan refusals, weak partial bursts).
* Exhaustive scenario exploration at tier-1 budgets — every interleaving
  of the bounded casts over HostNBB, MpscQueue, HostBitset,
  RefCountArray, StateCell, OpHandle and PriorityTransport is
  linearizable; the two deliberately broken scenarios are convicted.
  Each exploration is held to the reference's at the same budget:
  verdict, executions, distinct states, exhaustion and the convicting
  schedule.
"""
import pytest

pytest.importorskip("torch")

from repro.checker import lin as jlin  # noqa: E402
from repro.checker import scenarios as jscenarios  # noqa: E402
from repro.checker import specs as jspecs  # noqa: E402
from repro_torch.checker import lin, scenarios, specs  # noqa: E402
from repro_torch.checker.lin import (MISSING, OpRecord,  # noqa: E402
                                     Recorder, ops_from_history)
from repro_torch.core import states  # noqa: E402


def _summary(r):
    cx = r.counterexample
    return (r.ok, r.executions, r.distinct_states, r.exhausted,
            None if cx is None else (tuple(cx.schedule), cx.error_type))


def _explore(name, **kw):
    """The port's exploration of ``name``, held to the reference's."""
    r = scenarios.explore_scenario(name, **kw)
    assert _summary(r) == _summary(jscenarios.explore_scenario(name, **kw))
    return r


# ---------------------------------------------------------------------------
# Wing & Gong units on hand histories.
# ---------------------------------------------------------------------------
def test_sequential_history_linearizable():
    ops = ops_from_history([
        ("p", "send", (1,), "OK"),
        ("c", "recv", (), ("OK", 1)),
        ("c", "recv", (), ("EMPTY", None)),
    ])
    res = lin.check_history(ops, specs.SpscRingSpec(2))
    assert res.ok
    assert res.linearization == (0, 1, 2)
    ref = jlin.check_history(jlin.ops_from_history([
        ("p", "send", (1,), "OK"),
        ("c", "recv", (), ("OK", 1)),
        ("c", "recv", (), ("EMPTY", None)),
    ]), jspecs.SpscRingSpec(2))
    assert (ref.ok, ref.linearization) == (res.ok, res.linearization)


def test_overlapping_ops_reordered():
    # recv overlaps send and returns its item: legal — linearize send
    # first even though recv was invoked earlier.
    ops = [
        OpRecord(op="recv", args=(), result=("OK", 5), inv=0, res=3,
                 task="c"),
        OpRecord(op="send", args=(5,), result="OK", inv=1, res=2,
                 task="p"),
    ]
    assert lin.check_history(ops, specs.SpscRingSpec(2)).ok


def test_value_from_the_future_rejected():
    # recv COMPLETED before send was invoked: no legal order.
    ops = [
        OpRecord(op="recv", args=(), result=("OK", 5), inv=0, res=1,
                 task="c"),
        OpRecord(op="send", args=(5,), result="OK", inv=2, res=3,
                 task="p"),
    ]
    res = lin.check_history(ops, specs.SpscRingSpec(2))
    assert not res.ok
    assert "NOT linearizable" in res.explain()


def test_pending_op_may_take_effect_or_dangle():
    # A send with no response (task died) may still explain a recv...
    ops = [
        OpRecord(op="send", args=(9,), result=MISSING, inv=0, res=None,
                 task="p"),
        OpRecord(op="recv", args=(), result=("OK", 9), inv=1, res=2,
                 task="c"),
    ]
    assert lin.check_history(ops, specs.SpscRingSpec(2)).ok
    # ... or dangle forever without invalidating an EMPTY.
    ops2 = [
        OpRecord(op="send", args=(9,), result=MISSING, inv=0, res=None,
                 task="p"),
        OpRecord(op="recv", args=(), result=("EMPTY", None), inv=1,
                 res=2, task="c"),
    ]
    assert lin.check_history(ops2, specs.SpscRingSpec(2)).ok


def test_strict_empty_refusal_rejected_when_full():
    ops = ops_from_history([
        ("p", "send", (1,), "OK"),
        ("c", "recv", (), ("EMPTY", None)),
    ])
    assert not lin.check_history(ops, specs.SpscRingSpec(2)).ok


def test_fsm_cas_strictness():
    spec = specs.FsmSpec(states.OP_TRANSITIONS, states.OP_PENDING)
    # Two racing CAS: exactly one may win.
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
    # A CAS linearized in its expected state MUST win: sequential
    # cas(PENDING->COMPLETED)=False on a fresh cell is illegal.
    must_win = ops_from_history([
        ("a", "cas", (states.OP_PENDING, states.OP_COMPLETED), False),
    ])
    assert not lin.check_history(must_win, spec).ok


def test_recorder_roundtrip():
    rec = Recorder()
    a = rec.invoke("t", "send", 1)
    b = rec.invoke("u", "recv")
    rec.respond(b, ("OK", 1))
    rec.respond(a, "OK")
    ops = rec.ops()
    assert [o.op for o in ops] == ["send", "recv"]
    assert ops[0].inv < ops[1].inv < ops[1].res < ops[0].res
    pending = rec.invoke("t", "send", 2)
    assert rec.ops()[pending].res is None
    assert rec.ops()[pending].result == MISSING


def test_search_budget_guard():
    ops = ops_from_history(
        [("t", "send", (i,), "OK") for i in range(12)])
    with pytest.raises(RuntimeError, match="exceeded"):
        lin.check_history(ops, specs.SpscRingSpec(64), max_states=4)


# ---------------------------------------------------------------------------
# Spec-strength decisions.
# ---------------------------------------------------------------------------
def test_weak_scan_refusal_admitted():
    # try_claim -> None with free slots: weak refusal, linearizable.
    ops = ops_from_history([("t", "try_claim", (), None)])
    assert lin.check_history(ops, specs.BitsetSpec(2)).ok
    assert lin.check_history(
        ops_from_history([("t", "try_claim", (), None)]),
        specs.RefCountSpec(2)).ok


def test_weak_partial_burst_admitted():
    # (FULL, 1) for a 2-item burst into an EMPTY 3-slot ring: admitted
    # (the occupancy snapshot predates a drain; see specs docstring) —
    # but the accepted prefix must still surface.
    spec = specs.SpscRingSpec(3)
    ok = ops_from_history([
        ("p", "send_burst", ((0, 1),), ("FULL", 1)),
        ("c", "drain", (4,), (0,)),
    ])
    assert lin.check_history(ok, spec).ok
    bad = ops_from_history([
        ("p", "send_burst", ((0, 1),), ("FULL", 1)),
        ("c", "drain", (4,), (0, 1)),    # item 1 was never accepted
    ])
    assert not lin.check_history(bad, spec).ok


def test_strict_full_acceptance_and_refusal():
    spec = specs.SpscRingSpec(2)
    # OK must mean ALL items landed.
    assert not lin.check_history(ops_from_history([
        ("p", "send_burst", ((0, 1, 2),), ("OK", 3)),
    ]), spec).ok
    # (FULL, 0) only in a truly full ring.
    assert not lin.check_history(ops_from_history([
        ("p", "send_burst", ((0,),), ("FULL", 0)),
    ]), spec).ok


# ---------------------------------------------------------------------------
# Exhaustive model checking of the real primitives (tier-1 budgets).
# The exhausted=True scenarios are full proofs over their bounded casts.
# ---------------------------------------------------------------------------
EXHAUSTIVE = ["spsc_scalar", "spsc_burst", "bitset_hammer",
              "statecell_cas", "statecell_compaction", "ophandle_cancel",
              "priority_scan"]


@pytest.mark.parametrize("name", EXHAUSTIVE)
def test_scenario_exhaustive(name):
    r = _explore(name)
    assert r.ok, (f"{name}: {r.counterexample.error}\n"
                  f"repro schedule: {list(r.counterexample.schedule)}")
    assert r.exhausted, f"{name}: budget too small for exhaustion"


@pytest.mark.parametrize("name,budget", [
    ("mpsc_fanin", 1500),
    ("refcount_claim", 1500),
    ("refcount_share", 1500),
])
def test_scenario_bounded(name, budget):
    # Too large to exhaust in tier-1; full budgets run in bench_check.
    r = _explore(name, max_executions=budget)
    assert r.ok, (f"{name}: {r.counterexample.error}\n"
                  f"repro schedule: {list(r.counterexample.schedule)}")


def test_legacy_statecell_convicted():
    r = _explore("legacy_statecell_compaction")
    assert not r.ok
    assert r.counterexample.error_type == "LinearizabilityViolation"


def test_broken_ring_convicted():
    r = _explore("broken_ring")
    assert not r.ok
    assert r.counterexample.error_type == "TornReadDetected"


def test_fuzz_smoke_on_scenarios():
    for name in ("spsc_scalar", "statecell_compaction"):
        f = scenarios.fuzz_scenario(name, seed=0, runs=25)
        assert f.ok, f"{name}: {f.counterexample.error}"
        assert f.runs == jscenarios.fuzz_scenario(name, seed=0, runs=25).runs
