"""Per-device accounting of FLOPs, bytes and collective traffic
(``src/repro/launch/hlo_analysis.py``).

The JAX module parses a compiled program's HLO text.  PyTorch runs
eagerly, so the port counts the program as it is dispatched: an
:class:`Accountant` is a dispatch mode that sits *below* DTensor (it
declines DTensor operands, so DTensor runs first and hands it the local
shards), and so sees exactly the operations and collectives one device
runs, at their local shapes.  A loop's trip count is exact: every
iteration dispatches.  Under ``FakeTensorMode`` nothing is computed, which
is how the dry-run plans a 256-rank step on one CPU.  A planning
accountant (``planning=True``, the dry-run's) counts a loop written with
:func:`scan` as the JAX module counts a ``while`` loop: one iteration's
account times the trip count (``_while_trip_count`` there).

Accounting rules (per device):
  * flops       — matrix products, convolutions and fused attention, by
                  ``torch.utils.flop_counter``'s formulas (the JAX module
                  counts dot and convolution ops).
  * bytes       — operands plus results of every operation that touches
                  memory (views and aliases are free): eager PyTorch
                  writes each result to memory.  ``bytes_min`` counts
                  elementwise operations by their result alone, the
                  perfect-fusion floor.  An operation that returns no
                  tensor and is no collective is a metadata query (a
                  fake tensor's ``prim.device``, ``aten.sym_*``,
                  ``aten.is_*``) and touches no memory, unless its
                  result depends on the data (``_local_scalar_dense``,
                  ``equal``): that reads its operands.  So an account on
                  fake tensors equals the one on real tensors.
  * collectives — result bytes per operation, by the JAX module's five
                  kinds; a point-to-point receive is a collective-permute.
  * memory      — live bytes of the results still referenced, and their
                  peak (``track_memory=True``).
"""
from __future__ import annotations

import contextlib
import dataclasses
import weakref
from typing import Any, Callable, Dict, List, Optional, Tuple

import torch
from torch._subclasses.fake_tensor import FakeTensorMode
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils.flop_counter import flop_registry

COLLECTIVE_KINDS = ("all-gather", "all-reduce", "reduce-scatter",
                    "all-to-all", "collective-permute")

# Collective operations by (namespace, name) -> kind.  The functional
# collectives return their result; the in-place c10d ones write their
# first argument.
_FUNCTIONAL = {
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "all_reduce": "all-reduce",
    "all_reduce_coalesced": "all-reduce",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "all_to_all_single": "all-to-all",
}
_INPLACE = {
    "allreduce_": "all-reduce",
    "allreduce_coalesced_": "all-reduce",
    "_allgather_base_": "all-gather",
    "allgather_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_": "reduce-scatter",
    "alltoall_base_": "all-to-all",
    "alltoall_": "all-to-all",
    "recv_": "collective-permute",
    "recv_any_source_": "collective-permute",
}


def _tensors(x) -> List[torch.Tensor]:
    if isinstance(x, torch.Tensor):
        return [x]
    if isinstance(x, (list, tuple)):
        return [t for v in x for t in _tensors(v)]
    if isinstance(x, dict):
        return [t for v in x.values() for t in _tensors(v)]
    return []


def _nbytes(ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


@dataclasses.dataclass
class Account:
    flops: float = 0.0
    bytes: float = 0.0       # every operation's operands and results
    bytes_min: float = 0.0   # elementwise operations by their result only
    collective_bytes: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})
    collective_counts: Dict[str, float] = dataclasses.field(
        default_factory=lambda: {k: 0.0 for k in COLLECTIVE_KINDS})


@dataclasses.dataclass
class Op:
    """One dispatched operation: its name, result bytes and FLOPs."""
    kind: str
    result_bytes: int
    flops: float


def _collective_kind(func) -> Optional[Tuple[str, bool]]:
    """(kind, in place) of a collective operation, else None."""
    ns, name = func.namespace, func._schema.name.split("::")[-1]
    if ns in ("_c10d_functional", "_c10d_functional_autograd") \
            and name in _FUNCTIONAL:
        return _FUNCTIONAL[name], False
    if ns == "c10d" and name in _INPLACE:
        return _INPLACE[name], True
    return None


def _aliases(func) -> bool:
    """Whether the operation's results alias its inputs (views and
    in-place writes allocate nothing)."""
    return any(r.alias_info is not None for r in func._schema.returns)


_FREE_NAMES = {"detach", "alias", "lift_fresh", "_wrap_tensor_autograd",
               "wait_tensor"}


class _Extra:
    """The live bytes that a planned loop's other trips hold for one
    tensor that outlives its iteration (``trips - 1`` copies of it), until
    the tensor dies or :meth:`release` gives them back."""

    def __init__(self, acc: "Accountant", unit: int, trips: int):
        self.acc, self.unit, self.left = acc, unit, unit * trips
        acc._grow(self.left)

    def release(self, trips: Optional[int] = None) -> None:
        k = self.left if trips is None else min(trips * self.unit, self.left)
        self.left -= k
        self.acc.live_bytes -= k


@dataclasses.dataclass
class _Trip:
    """One :meth:`Accountant.trips` scope: (weak reference, bytes) of the
    tensors it allocated, and its peak of live bytes."""
    peak: int
    fresh: List[Tuple[Any, int]] = dataclasses.field(default_factory=list)


class Accountant(TorchDispatchMode):
    """Counts what one device runs while active (see the module
    docstring).  ``record=True`` keeps an :class:`Op` per operation;
    ``track_memory=True`` follows live result bytes and their peak;
    ``planning=True`` counts each :func:`scan` as one step times its trip
    count."""

    def __init__(self, record: bool = False, track_memory: bool = False,
                 planning: bool = False):
        super().__init__()
        self.account = Account()
        self.ops: Optional[List[Op]] = [] if record else None
        self.track_memory = track_memory
        self.planning = planning
        self.live_bytes = 0
        self.peak_bytes = 0
        self._scale = 1       # trips counted for each dispatch (trips())
        self._trip = None     # the innermost trips() scope

    def _release(self, n: int) -> None:
        self.live_bytes -= n

    def _grow(self, n: int) -> None:
        self.live_bytes += n
        self.peak_bytes = max(self.peak_bytes, self.live_bytes)

    @contextlib.contextmanager
    def trips(self, n: int):
        """Counts every operation dispatched inside as ``n`` (a loop's
        trip count, the reference's ``known_trip_count``).  Yields a
        :class:`_Trip` (what the iteration allocated, its live peak) for
        :meth:`_outlive`."""
        scale, outer = self._scale, self._trip
        trip = _Trip(self.live_bytes)
        self._scale, self._trip = scale * n, trip
        try:
            yield trip
        finally:
            self._scale, self._trip = scale, outer
            if outer is not None:
                outer.fresh += trip.fresh
                outer.peak = max(outer.peak, trip.peak)

    def _outlive(self, trip: "_Trip", n: int, keep=(), freed: int = 0,
                owner: Optional[torch.Tensor] = None
                ) -> List[Tuple[Any, _Extra]]:
        """The tensors that ``trip`` allocated and that are still alive
        (but ``keep``) outlive their iteration: each is live ``n`` times
        over, as the loop's ``n`` iterations would each leave one, until
        it dies (or ``owner`` does).  The loop's last iteration peaks
        with the others' leftovers live, less ``freed`` bytes that each
        earlier one gave back.  Returns (weak reference, :class:`_Extra`)
        pairs."""
        if not self.track_memory or n <= 1:
            return []
        kept = {id(t) for t in keep if t is not None}
        alive = [(r, b) for r, b in trip.fresh
                 if r() is not None and id(r()) not in kept]
        left = sum(b for _, b in alive) - freed
        self.peak_bytes = max(self.peak_bytes,
                              trip.peak + (n - 1) * max(left, 0))
        out = []
        for ref, b in alive:
            extra = _Extra(self, b, n - 1)
            weakref.finalize(ref() if owner is None else owner,
                             extra.release)
            out.append((ref, extra))
        return out

    def __enter__(self):
        # The fake-tensor modes active now are the caller's (the
        # dry-run's); one that appears later is DTensor's sharding
        # propagation running an op on fake inputs to learn its output's
        # shape, which no device runs.
        self._own_fakes = {id(m) for m in _get_current_dispatch_mode_stack()
                           if isinstance(m, FakeTensorMode)}
        return super().__enter__()

    def _propagating(self) -> bool:
        return any(isinstance(m, FakeTensorMode)
                   and id(m) not in self._own_fakes
                   for m in _get_current_dispatch_mode_stack())

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented        # let DTensor hand us local shards
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        if self._propagating():
            return out
        acc, s = self.account, self._scale
        name = func._schema.name.split("::")[-1]
        coll = _collective_kind(func)
        results = _tensors(out)
        flops = 0.0
        if coll is not None:
            kind, inplace = coll
            b = _nbytes(_tensors(args[0] if inplace else out))
            acc.collective_bytes[kind] += s * b
            acc.collective_counts[kind] += s
            acc.bytes += s * b
            acc.bytes_min += s * b
        elif func.overloadpacket in flop_registry:
            flops = float(flop_registry[func.overloadpacket](
                *args, **kwargs, out_val=out))
            acc.flops += s * flops
        if coll is None and not results:
            # A metadata query, unless the result is read from the data.
            if torch.Tag.data_dependent_output in func.tags:
                ins = _nbytes(_tensors(args)) + _nbytes(_tensors(kwargs))
                acc.bytes += s * ins
                acc.bytes_min += s * ins
        elif coll is None and not func.is_view and name not in _FREE_NAMES:
            outs = _nbytes(results)
            ins = _nbytes(_tensors(args)) + _nbytes(_tensors(kwargs))
            acc.bytes += s * (ins + outs)
            pointwise = torch.Tag.pointwise in func.tags
            acc.bytes_min += s * (outs if pointwise else ins + outs)
        if self.track_memory and not _aliases(func) \
                and name not in _FREE_NAMES:
            for t in results:
                n = t.numel() * t.element_size()
                self.live_bytes += n
                weakref.finalize(t, self._release, n)
                if self._trip is not None:
                    self._trip.fresh.append((weakref.ref(t), n))
            if self._scale:               # trips(0) runs nothing
                self.peak_bytes = max(self.peak_bytes, self.live_bytes)
            if self._trip is not None and self._scale:
                self._trip.peak = max(self._trip.peak, self.live_bytes)
        if self.ops is not None:
            self.ops.append(Op(str(func), _nbytes(results), flops))
        return out


def analyze(fn: Callable, *args, **kwargs) -> Account:
    """The per-device :class:`Account` of one call ``fn(*args,
    **kwargs)``."""
    with Accountant() as a:
        fn(*args, **kwargs)
    return a.account


def trace(fn: Callable, *args, **kwargs
          ) -> Tuple[Dict[str, List[Op]], str]:
    """(operations by program, entry): the operations one call dispatches,
    under the entry's name (the counterpart of ``parse_hlo``'s
    computations and ENTRY)."""
    entry = getattr(fn, "__qualname__", None) or repr(fn)
    with Accountant(record=True) as a:
        fn(*args, **kwargs)
    return {entry: a.ops}, entry


def _planner() -> Optional[Accountant]:
    """The innermost active :class:`Accountant` if it plans, else None."""
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, Accountant):
            return m if m.planning else None
    return None


def _drop(extras, tensors) -> None:
    """The loop's copies of ``tensors`` (or of their bases) are gone,
    stacked or summed: gives back their other trips' bytes, and the
    bytes of the one that stays referenced until the scan returns."""
    ids = {id(b) for t in tensors if t is not None
           for b in (t, t._base) if b is not None}
    for ref, extra in extras:
        t = ref()
        if id(t) in ids:
            extra.release()
            _uncount(extra.acc, t)


def _uncount(acc: Accountant, t: torch.Tensor) -> None:
    """Takes ``t``'s bytes (its base's, for a view) out of the live count
    for as long as it lives: a tensor that the plan holds and the loop
    would not."""
    if acc.track_memory:
        b = t if t._base is None else t._base
        weakref.finalize(b, _Extra(acc, -_nbytes([b]), 1).release)


def scan(step: Callable, carry: torch.Tensor, xs, consts=(), dim: int = 1
         ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``carry, y_t = step(carry, *x_t, *consts)`` for t over dim ``dim``
    of every tensor of ``xs``; returns the last carry and the y_t stacked
    on ``dim`` (``lax.scan``).

    The steps' operands come from one ``unbind`` of each tensor made
    before the loop, so the backward stacks each tensor's T gradients
    once; indexing ``x[:, t]`` in the loop would build a full-length
    gradient a step, quadratic in T.  Every step must dispatch the same
    operations at the same shapes.  Under a planning :class:`Accountant`
    one step is dispatched and counted T times, its backward too, as the
    reference counts a ``while`` body by its trip count; anywhere else
    this is the plain loop over ``range(T)``."""
    n = xs[0].shape[dim]
    acc = _planner()
    if acc is None:
        slices = [x.unbind(dim) for x in xs]
        ys = []
        for t in range(n):
            carry, y = step(carry, *(x[t] for x in slices), *consts)
            ys.append(y)
        return carry, torch.stack(ys, dim)
    tensors = (carry, *xs, *consts)
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return _PlannedScan.apply(acc, step, dim, len(xs), *tensors)
    # One select is one unbind's view: both free, and T views of a 32k
    # scan would cost the plan a tensor object each.
    with acc.trips(n) as trip:
        carry, y = step(carry, *(x.select(dim, 0) for x in xs), *consts)
    extras = acc._outlive(trip, n, keep=(carry,))
    ys = torch.stack([y] * n, dim)        # T operands, as the loop's
    _drop(extras, (y,))
    return carry, ys


def _stack_grads(acc: Accountant, grads, dim: int):
    """The ``unbind``'s backward over a scan's T step gradients (``grads``,
    one a step): a step that gave none gets an expanded scalar zero, as
    ``unbind_backward`` makes it."""
    like = next((g for g in grads if g is not None), None)
    if like is None:
        return None
    missing = sum(g is None for g in grads)
    if missing:
        with acc.trips(missing):
            zero = torch.zeros((), dtype=like.dtype,
                               device=like.device).expand(like.shape)
        grads = [zero if g is None else g for g in grads]
    return torch.stack(grads, dim)


class _PlannedScan(torch.autograd.Function):
    """A planned :func:`scan` under autograd.  The forward dispatches one
    step, counted T times.  The backward runs one step's backward for
    each class of the loop's step backwards, counted as many times as the
    class has steps: the last step (a carry gradient comes in only if the
    final carry is used), the middle ones, and the first (a carry
    gradient goes out only if the initial carry needs one).  Each tensor
    of ``xs`` gets one stack of T gradients (the ``unbind``'s backward)
    and each of ``consts`` T - 1 accumulations, as in the loop's graph.

    Live bytes follow the loop's: T copies of what a step leaves (what
    its graph keeps saved, and its output until the stack), freed one
    step's worth at a time by the backward.  Each class runs on the
    step's graph built again and counted zero times
    (:meth:`Accountant.trips` of 0), so that the engine frees its saved
    tensors as it goes, as it does the loop's.  A step saved under
    someone else's hooks (a checkpoint's) keeps what those hooks keep."""

    @staticmethod
    def forward(ctx, acc, step, dim, n_xs, carry, *tensors):
        xs, consts = tensors[:n_xs], tensors[n_xs:]
        n = xs[0].shape[dim]
        ctx.set_materialize_grads(False)

        def leaf(t, like):
            return t.detach().requires_grad_(like.requires_grad)

        c_in = carry.detach().requires_grad_(n > 1 or carry.requires_grad)
        x_in = [leaf(x.select(dim, 0), x) for x in xs]
        k_in = [leaf(k, k) for k in consts]
        # Which tensors the step's graph keeps: those its saved-tensor
        # hooks (the caller's, or none) hand back as they are.
        owner = {id(a): b for a, b in zip((c_in, *x_in, *k_in),
                                          (carry, *tensors))}
        outer = torch._C._autograd._top_saved_tensors_default_hooks(False)
        kept, kept_ids = {}, set()

        def pack(t):
            p = t if outer is None else outer[0](t)
            if p is t:
                for b in (t, t._base):
                    if b is not None:
                        kept_ids.add(id(b))
                        if id(b) in owner:
                            kept[id(b)] = owner[id(b)]
            return p

        def unpack(p):
            return p if outer is None else outer[1](p)

        with torch.enable_grad(), acc.trips(n) as trip, \
                torch.autograd.graph.saved_tensors_hooks(pack, unpack):
            c_out, y = step(c_in, *x_in, *k_in)
        # What the graph keeps, and the output until the stack, outlive
        # the step: the loop leaves T of each.  The other steps' saved
        # tensors live as long as the graph (the backward frees them a
        # step at a time).
        out_ids = {id(b) for b in (y, y._base) if b is not None}
        if id(c_in) in kept_ids:
            # A step keeps its incoming carry: the loop keeps every
            # step's outgoing one.
            kept_ids |= {id(b) for b in (c_out, c_out._base)
                         if b is not None}
        trip.fresh = [(r, b) for r, b in trip.fresh
                      if id(r()) in kept_ids or id(r()) in out_ids]
        extras = acc._outlive(trip, n, owner=c_in)
        ys = torch.stack([y] * n, dim)
        _drop(extras, (y,))
        ctx.acc, ctx.step, ctx.n, ctx.dim = acc, step, n, dim
        ctx.carry_grad = carry.requires_grad
        ctx.leaves = (c_in, x_in, k_in)
        # The graph's nodes keep its saved tensors, not its outputs.
        ctx.nodes = (c_out.grad_fn, y.grad_fn)
        ctx.kept = list(kept.values())
        owner.clear()                     # the graph holds pack()
        kept.clear()
        ctx.extras = [e for r, e in extras if id(r()) not in out_ids]
        # The carry returned shares the last step's: it holds that tensor
        # (whose bytes the accountant follows) for as long as it lives.
        carry_out = c_out.detach()
        carry_out._scan_carry = c_out
        return carry_out, ys

    @staticmethod
    def backward(ctx, g_carry, g_ys):
        acc, n, dim = ctx.acc, ctx.n, ctx.dim
        c_in, x_in, k_in = ctx.leaves
        g_y = None if g_ys is None else g_ys.select(dim, 0)
        want_x = [i for i, x in enumerate(x_in) if x.requires_grad]
        want_k = [i for i, k in enumerate(k_in) if k.requires_grad]
        # (steps, a carry gradient comes in, one goes out), last first.
        classes = [(1, g_carry is not None, n > 1 or ctx.carry_grad)]
        if n > 2:
            classes.append((n - 2, True, True))
        if n > 1:
            classes.append((1, True, ctx.carry_grad))
        gx = {i: [] for i in want_x}
        gk = {i: None for i in want_k}
        g_c, extras = g_carry, []
        for count, gets, gives in classes:
            unit = sum(e.unit for e in ctx.extras if e.left)
            # The class's first step: the forward's graph (the last step's)
            # goes, or one trip of the others' saved tensors, and the
            # step's graph is built again in its place.
            if ctx.nodes is not None:
                ctx.nodes = None
            else:
                for e in ctx.extras:
                    e.release(1)
            with torch.enable_grad(), acc.trips(0):
                c_out, y = ctx.step(c_in, *x_in, *k_in)
            # The loop's engine frees the incoming carry gradient once
            # summed into the step's; the rebuilt step's output and carry
            # are the loop's (freed, or the caller's); here the roots and
            # seeds stay referenced until the class is done.
            for t in [c_out, y] + ([g_c] if gets and g_c is not None
                                   else []):
                _uncount(acc, t)
            outs, g_outs = [], []
            if g_y is not None:
                outs, g_outs = [y], [g_y]
            if gets and g_c is not None:
                outs.append(c_out)
                g_outs.append(g_c)
            del c_out, y
            ins = ([c_in] if gives else []) + [x_in[i] for i in want_x] \
                + [k_in[i] for i in want_k]
            grads, ran = [None] * len(ins), bool(outs)
            if ran:
                with acc.trips(count) as trip:
                    grads = list(torch.autograd.grad(
                        outs, ins, g_outs, allow_unused=True))
            del outs, g_outs
            g_c = grads.pop(0) if gives else None
            g_xs, g_ks = grads[:len(want_x)], grads[len(want_x):]
            # The class's other steps free what they saved; the xs'
            # gradients wait for the unbind's stack, the carry's passes
            # on and the consts' are summed.
            for e in ctx.extras:
                e.release(count - 1)
            if ran:
                extras += acc._outlive(trip, count, keep=(g_c, *g_ks),
                                      freed=unit)
            for i, g in zip(want_x, g_xs):
                gx[i] += [g] * count
            for i, g in zip(want_k, g_ks):
                gk[i] = g if gk[i] is None else gk[i]
        ctx.kept = ctx.extras = None
        out_x = [None] * len(x_in)
        for i in want_x:
            out_x[i] = _stack_grads(acc, gx[i], dim)
        _drop(extras, [g for i in want_x for g in gx[i]])
        out_k = [None] * len(k_in)
        for i in want_k:
            out_k[i] = gk[i]
            if gk[i] is not None and n > 1:
                with acc.trips(n - 1):    # the loop's T - 1 accumulations
                    out_k[i] = gk[i] + gk[i]
        return (None, None, None, None, g_c if ctx.carry_grad else None,
                *out_x, *out_k)
