"""Port counterpart of ``tests/test_ophandle.py``: property tests of the
port's OpHandle CAS FSM (PENDING -> COMPLETED|CANCELLED).

The two properties the streaming session API leans on:

  1. *Exactly one terminal state* — any interleaving of concurrent
     ``cancel()`` calls and completion polls lands the handle in exactly
     one of COMPLETED/CANCELLED, and the winner count is exactly one.
  2. *Never double-free* — a resource released on the terminal
     transition (the serving engine's KV slot) is released exactly once
     no matter how the race resolves.

The races run on the port alone.  Each sequential op sequence (the
hypothesis one included) also runs on the reference's OpHandle, and the
trajectory of states, the winners and the result must be the same.
"""
import threading

import pytest

pytest.importorskip("torch")

try:  # optional dev dependency; property tests skip without it
    from hypothesis import given, settings, strategies as st
except ImportError:
    given = settings = st = None

from repro.core.host_queue import SpscQueue as RefSpscQueue  # noqa: E402
from repro.core.transport import OpHandle as RefOpHandle  # noqa: E402
from repro_torch.core import nbb, states  # noqa: E402
from repro_torch.core.host_queue import SpscQueue  # noqa: E402
from repro_torch.core.transport import OpHandle  # noqa: E402


def _run_ops(queue_cls, handle_cls, ops):
    """A poll/cancel/feed sequence on one receive handle -> (the state
    after each op, completions, cancel wins, result, late result)."""
    q = queue_cls(4)
    h = handle_cls(q.try_recv, "prop")
    seen, completions, cancel_wins = [h.state], 0, 0
    for op in ops:
        if op == "feed":
            q.send("v")
        elif op == "poll":
            completions += bool(h.test())
        else:
            cancel_wins += bool(h.cancel())
        seen.append(h.state)
    return seen, completions, cancel_wins, h.result, h.late_result


def _spin_barrier(n):
    return threading.Barrier(n, timeout=10)


# ---------------------------------------------------------------------------
# Deterministic single-thread sequences.
# ---------------------------------------------------------------------------
def test_terminal_states_are_absorbing():
    c = states.op_cell()
    assert c.cas(states.OP_PENDING, states.OP_COMPLETED) is True
    assert c.cas(states.OP_PENDING, states.OP_CANCELLED) is False
    assert c.state == states.OP_COMPLETED
    with pytest.raises(states.IllegalTransition):
        c.cas(states.OP_COMPLETED, states.OP_PENDING)


def test_cancel_then_complete_never_completes():
    q = SpscQueue(2)
    h = OpHandle(q.try_recv, "t")
    assert h.cancel()
    q.send("x")
    for _ in range(3):
        assert h.test() is False
    assert h.state == states.OP_CANCELLED and h.result is None
    ops = ["cancel", "feed", "poll", "poll", "poll"]
    assert _run_ops(SpscQueue, OpHandle, ops) == _run_ops(
        RefSpscQueue, RefOpHandle, ops)


# ---------------------------------------------------------------------------
# Threaded races: exactly one terminal state, exactly one winner.
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("n_cancellers", [1, 2, 4])
def test_concurrent_cancel_vs_completion_single_winner(n_cancellers):
    for _round in range(100):
        q = SpscQueue(2)
        q.send("payload")
        h = OpHandle(q.try_recv, "race")
        barrier = _spin_barrier(n_cancellers + 1)
        cancel_wins = []

        def canceller():
            barrier.wait()
            if h.cancel():
                cancel_wins.append(1)

        def poller():
            barrier.wait()
            h.test()

        ts = ([threading.Thread(target=canceller)
               for _ in range(n_cancellers)]
              + [threading.Thread(target=poller)])
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        # exactly one terminal state ...
        assert h.state in (states.OP_COMPLETED, states.OP_CANCELLED)
        # ... and exactly one winner across both sides of the race
        assert len(cancel_wins) == (0 if h.completed else 1)
        # the payload is never lost: completed -> result, cancelled with
        # the pop already committed -> parked in late_result
        if h.completed:
            assert h.result == "payload"
        elif h.attempted_ok:
            assert h.late_result == "payload"
        else:
            assert q.drain() == ["payload"]


def test_concurrent_cancel_vs_completion_never_double_frees():
    """Model the serving engine's KV release: the resource owner frees on
    whichever terminal transition *it* observes won, exactly once."""
    for _round in range(100):
        frees = []
        q = SpscQueue(2)
        q.send("tok")
        h = OpHandle(q.try_recv, "kv")
        barrier = _spin_barrier(2)

        def server():
            barrier.wait()
            # the single resource owner: exactly one free per terminal
            if h.test():
                frees.append("completed")
            elif h.cancelled:
                frees.append("cancelled")
            else:                       # still pending: poll to terminal
                while not h.test() and not h.cancelled:
                    pass
                frees.append("completed" if h.completed else "cancelled")

        def client():
            barrier.wait()
            h.cancel()

        ts = [threading.Thread(target=server), threading.Thread(target=client)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert len(frees) == 1, frees
        assert frees[0] == ("completed" if h.completed else "cancelled")


# ---------------------------------------------------------------------------
# Hypothesis: randomized interleavings of poll/cancel micro-ops.
# ---------------------------------------------------------------------------
if st is not None:

    @settings(max_examples=200, deadline=None)
    @given(ops=st.lists(st.sampled_from(["poll", "cancel", "feed"]),
                        min_size=1, max_size=24))
    def test_any_op_sequence_lands_in_at_most_one_terminal(ops):
        """Arbitrary sequential interleaving (the linearized form of any
        concurrent schedule): at most one terminal state, transitions
        never go terminal -> anything, results consistent with the FSM,
        and every step as the reference's handle takes it."""
        got = _run_ops(SpscQueue, OpHandle, ops)
        assert got == _run_ops(RefSpscQueue, RefOpHandle, ops)
        seen_states, completions, cancel_wins, result, _ = got
        # terminal states are absorbing along the whole trajectory
        for a, b in zip(seen_states, seen_states[1:]):
            if a != states.OP_PENDING:
                assert b == a
        assert cancel_wins <= 1
        if seen_states[-1] == states.OP_COMPLETED:
            assert cancel_wins == 0 and result == "v"
        if seen_states[-1] == states.OP_CANCELLED:
            assert completions == 0 and cancel_wins == 1

    @settings(max_examples=100, deadline=None)
    @given(seed=st.integers(min_value=0, max_value=2**32 - 1),
           n_cancellers=st.integers(min_value=1, max_value=3))
    def test_threaded_race_property(seed, n_cancellers):
        """Same exactly-one-terminal/never-double-free property under real
        threads, with hypothesis choosing the contention shape."""
        q = SpscQueue(2)
        q.send(seed)
        h = OpHandle(q.try_recv, "prop-race")
        barrier = _spin_barrier(n_cancellers + 1)
        frees = []

        def canceller():
            barrier.wait()
            h.cancel()

        def owner():
            barrier.wait()
            while not h.test() and not h.cancelled:
                pass
            frees.append(h.state)       # the one release point

        ts = ([threading.Thread(target=canceller)
               for _ in range(n_cancellers)]
              + [threading.Thread(target=owner)])
        for t in ts:
            t.start()
        for t in ts:
            t.join(10)
        assert len(frees) == 1
        assert frees[0] in (states.OP_COMPLETED, states.OP_CANCELLED)
        assert frees[0] == h.state
        if h.completed:
            assert h.result == seed
        elif not h.attempted_ok:
            assert q.drain() == [seed]  # payload not consumed

else:  # pragma: no cover - exercised only without hypothesis installed

    @pytest.mark.skip(reason="hypothesis not installed")
    def test_any_op_sequence_lands_in_at_most_one_terminal():
        pass


# ---------------------------------------------------------------------------
# The OK statuses stay Table-1 compatible through the handle layer.
# ---------------------------------------------------------------------------
def test_last_status_reports_table1_codes():
    q = SpscQueue(1)
    h = OpHandle(lambda: (q.send("x"), None), "s")
    assert h.test() is True
    h2 = OpHandle(lambda: (q.send("y"), None), "s2")
    assert h2.test() is False
    assert h2.last_status == nbb.BUFFER_FULL
    h3 = OpHandle(q.try_recv, "r")
    assert h3.test() is True and h3.result == "x"
    h4 = OpHandle(q.try_recv, "r2")
    assert h4.test() is False
    assert h4.last_status == nbb.BUFFER_EMPTY
