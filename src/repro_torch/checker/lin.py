"""Linearizability checking (Wing & Gong DFS) over recorded histories.

A scenario run under :mod:`repro_torch.core.interleave` records each structure
operation as an *invocation* / *response* event pair in a
:class:`Recorder`.  Because exactly one task runs between yield points,
appending an event is atomic and the global event order is the real-time
order of the execution: operation A precedes operation B iff A's
response event lands before B's invocation event.

:func:`check_history` then searches for a *linearization* — a total
order of the operations, consistent with that real-time order, that a
pure sequential specification (:mod:`repro_torch.checker.specs`) accepts with
the observed results.  The search is the classic Wing & Gong DFS: at
each step any not-yet-linearized operation whose invocation precedes
every pending response is a candidate; the spec is asked what results
it could produce in the current abstract state; matching results
advance the state, and the (linearized-set, state) pairs are memoized
so an abstract state reached twice is explored once.

Incomplete operations (an invocation with no response — a task that
died mid-call, e.g. under fault injection) may either take effect with
any result, or never take effect at all; the DFS explores both.
"""
from __future__ import annotations

import dataclasses
from typing import Any, Iterable, List, Optional, Tuple

#: Result sentinel: "the caller never observed a result — accept any".
MISSING = ("__missing__",)


@dataclasses.dataclass(frozen=True)
class OpRecord:
    op: str
    args: Tuple[Any, ...]
    result: Any                 # MISSING when pending / unobserved
    inv: int                    # invocation event index
    res: Optional[int]          # response event index; None = pending
    task: str = ""


class Recorder:
    """Append-only invocation/response event log for one execution.

    Usage inside a scenario task::

        opid = rec.invoke("p0", "send", item)
        status = ring.insert_item(item)        # yield points fire inside
        rec.respond(opid, specs.status_class(status))

    ``events`` is deliberately part of every scenario's fingerprint:
    routing task-local results through it is what keeps DFS
    state-pruning sound (two executions only share a future if they
    also recorded the same history so far).
    """

    def __init__(self) -> None:
        self.events: List[Tuple[str, int, Any, Any]] = []
        self._next = 0

    def invoke(self, task: str, op: str, *args: Any) -> int:
        opid = self._next
        self._next += 1
        self.events.append(("inv", opid, (task, op, args), None))
        return opid

    def respond(self, opid: int, result: Any) -> None:
        self.events.append(("res", opid, None, result))

    def fingerprint(self) -> Tuple:
        return tuple(self.events)

    def ops(self) -> List[OpRecord]:
        inv: dict = {}
        res: dict = {}
        for i, (kind, opid, meta, result) in enumerate(self.events):
            if kind == "inv":
                inv[opid] = (i, meta)
            else:
                res[opid] = (i, result)
        out = []
        for opid in sorted(inv):
            i, (task, op, args) = inv[opid]
            if opid in res:
                j, result = res[opid]
            else:
                j, result = None, MISSING
            out.append(OpRecord(op=op, args=tuple(args), result=result,
                                inv=i, res=j, task=task))
        return out


@dataclasses.dataclass
class LinResult:
    ok: bool
    linearization: Optional[Tuple[int, ...]]   # op indices in linear order
    states_explored: int
    ops: List[OpRecord]

    def explain(self) -> str:
        if self.ok:
            order = " -> ".join(
                f"{self.ops[k].task}:{self.ops[k].op}{self.ops[k].args}"
                f"={self.ops[k].result}"
                for k in (self.linearization or ()))
            return f"linearizable: {order or '(empty history)'}"
        lines = ["NOT linearizable; history:"]
        for k, o in enumerate(self.ops):
            end = "pending" if o.res is None else str(o.res)
            lines.append(f"  [{k}] {o.task}: {o.op}{o.args} = {o.result!r} "
                         f"(inv {o.inv}, res {end})")
        return "\n".join(lines)


class LinearizabilityViolation(AssertionError):
    """Raised by scenario checks when no linearization exists."""


def _results_match(spec_result: Any, actual: Any) -> bool:
    return actual == MISSING or spec_result == actual


def check_history(ops: List[OpRecord], spec: Any,
                  max_states: int = 500_000) -> LinResult:
    """Wing & Gong DFS.  ``spec`` provides ``init() -> state`` and
    ``apply(state, op, args) -> iterable[(state', result)]`` with
    hashable states.  Raises ``RuntimeError`` past ``max_states`` so a
    spec bug cannot hang the suite."""
    n = len(ops)
    completed_mask = 0
    for k, o in enumerate(ops):
        if o.res is not None:
            completed_mask |= 1 << k
    seen: set = set()
    explored = 0
    path: List[int] = []

    def dfs(mask: int, state: Any) -> bool:
        nonlocal explored
        if mask & completed_mask == completed_mask:
            return True                 # pending ops may dangle forever
        key = (mask, state)
        if key in seen:
            return False
        seen.add(key)
        explored += 1
        if explored > max_states:
            raise RuntimeError(
                f"linearizability search exceeded {max_states} states")
        min_res = min((o.res for k, o in enumerate(ops)
                       if not (mask >> k) & 1 and o.res is not None),
                      default=None)
        for k, o in enumerate(ops):
            if (mask >> k) & 1:
                continue
            # Real-time order: o may only linearize next if it was
            # invoked before the earliest outstanding response.
            if min_res is not None and o.inv > min_res:
                continue
            for state2, result in spec.apply(state, o.op, o.args):
                if not _results_match(result, o.result):
                    continue
                path.append(k)
                if dfs(mask | (1 << k), state2):
                    return True
                path.pop()
        return False

    ok = dfs(0, spec.init())
    return LinResult(ok=ok, linearization=tuple(path) if ok else None,
                     states_explored=explored, ops=ops)


def assert_linearizable(recorder: Recorder, spec: Any,
                        label: str = "") -> LinResult:
    """Check and raise :class:`LinearizabilityViolation` on failure —
    the form scenario ``check`` hooks use."""
    result = check_history(recorder.ops(), spec)
    if not result.ok:
        raise LinearizabilityViolation(
            f"{label or spec.__class__.__name__}: {result.explain()}")
    return result


def ops_from_history(history: Iterable[Tuple]) -> List[OpRecord]:
    """Build OpRecords from raw (task, op, args, result) tuples recorded
    sequentially — each op is a point event (inv immediately followed by
    res).  Convenience for testing specs against known-sequential runs."""
    out = []
    for i, (task, op, args, result) in enumerate(history):
        out.append(OpRecord(op=op, args=tuple(args), result=result,
                            inv=2 * i, res=2 * i + 1, task=task))
    return out
