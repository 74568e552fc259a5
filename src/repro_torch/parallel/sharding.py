"""Logical-axis sharding rules on ``DeviceMesh``/DTensor
(``src/repro/parallel/sharding.py``).

Models annotate activations and parameters with *logical* axis names
("batch", "embed", "mlp", ...).  A rules table maps logical names to mesh
axes; the table and the mesh are installed with :func:`axis_rules` around
the step.  Outside any rules context every annotation is a no-op, so the
same model code runs unsharded on one device and sharded over a mesh.

A spec is a :class:`PartitionSpec`: one entry per tensor dimension,
``None`` (replicated), a mesh axis name, or a tuple of names (the
dimension split over several mesh axes, major first).
:func:`placements_for` turns a spec into DTensor placements, one per mesh
dimension.  :func:`shard` redistributes a DTensor to its logical spec (the
counterpart of ``with_sharding_constraint``); :func:`shard_map_compat`
runs a function on local shards (``shard_map``), which is how the kernels,
the expert-parallel MoE and the pipeline see plain tensors under a mesh.
"""
from __future__ import annotations

import contextlib
from typing import Any, Callable, Dict, Optional, Sequence, Tuple, Union

import torch

from repro_torch.train import tree

MeshAxes = Union[None, str, Tuple[str, ...]]

# Default rules for the production meshes (16x16 and 2x16x16).
# "batch" spreads over pod+data; "model"-parallel dims over the model axis.
DEFAULT_RULES: Dict[str, MeshAxes] = {
    "batch": ("pod", "data"),
    "seq": None,                # sequence kept local by default
    "seq_model": "model",       # context-parallel sequence (long ctx / big attn)
    "embed": None,
    "heads": "model",
    "kv_heads": "model",
    "head_dim": None,
    "qkv": "model",             # flattened attention projection dim
    "mlp": "model",
    "vocab": "model",
    "expert": "model",
    "expert_mlp": None,
    "expert_data": "data",      # FSDP-style extra shard for expert weights
    "cache_seq": "model",       # decode KV cache: shard seq over model
    "cache_kv_heads": None,
    "conv_kernel": None,
    "state": None,
    "layers": None,
}


class PartitionSpec(tuple):
    """Per-dimension mesh axes of one tensor: ``PartitionSpec("data",
    None)``; a tuple entry shards one dimension over several axes (a
    one-axis tuple is that axis, as ``jax.sharding.PartitionSpec`` has
    it)."""

    def __new__(cls, *entries: MeshAxes):
        return super().__new__(cls, tuple(
            e[0] if isinstance(e, tuple) and len(e) == 1 else e
            for e in entries))

    def __repr__(self):
        return f"P{tuple.__repr__(self)}"


P = PartitionSpec


def mesh_axis_names(mesh) -> Tuple[str, ...]:
    """The axis names of a ``DeviceMesh`` or of an :class:`AbstractMesh`."""
    return tuple(mesh.mesh_dim_names)


def mesh_axis_size(mesh, name: str) -> int:
    return mesh.size(mesh_axis_names(mesh).index(name))


class _Ctx:
    """The installed (mesh, rules): process-wide, not per thread, since
    the autograd engine runs a CUDA backward (and the remat recompute
    inside it) on a device thread of its own."""

    def __init__(self):
        self.mesh = None
        self.rules: Optional[Dict[str, MeshAxes]] = None


_ctx = _Ctx()


def current_mesh():
    """The mesh installed by :func:`axis_rules`, or None."""
    return _ctx.mesh


@contextlib.contextmanager
def axis_rules(mesh, rules: Optional[Dict[str, MeshAxes]] = None):
    """Install (mesh, rules) for :func:`shard`/:func:`spec_for`.  Rules
    naming an axis the mesh lacks (``"pod"`` on the single-pod mesh) drop
    it, so one table serves both meshes."""
    merged = dict(DEFAULT_RULES)
    if rules:
        merged.update(rules)
    have = set(mesh_axis_names(mesh))

    def _filter(v: MeshAxes) -> MeshAxes:
        if v is None:
            return None
        if isinstance(v, str):
            return v if v in have else None
        kept = tuple(a for a in v if a in have)
        return kept if kept else None

    merged = {k: _filter(v) for k, v in merged.items()}
    prev = (_ctx.mesh, _ctx.rules)
    _ctx.mesh, _ctx.rules = mesh, merged
    try:
        yield
    finally:
        _ctx.mesh, _ctx.rules = prev


def active() -> bool:
    return _ctx.mesh is not None


def spec_for(names: Sequence[Optional[str]]) -> PartitionSpec:
    """Logical axis names -> spec under the active rules.  A mesh axis
    appears at most once in a spec: later dimensions lose it."""
    assert _ctx.rules is not None
    entries = []
    used = set()
    for n in names:
        v = _ctx.rules.get(n) if n is not None else None
        if isinstance(v, str):
            v = (v,) if v not in used else None
        elif isinstance(v, tuple):
            v = tuple(a for a in v if a not in used) or None
        if v is not None:
            used.update(v)
            entries.append(v if len(v) > 1 else v[0])
        else:
            entries.append(None)
    return PartitionSpec(*entries)


def placements_for(spec: Union[PartitionSpec, Sequence[Optional[str]]],
                   mesh=None) -> tuple:
    """A spec (or logical names, through :func:`spec_for`) -> DTensor
    placements, one per mesh dimension: ``Shard(d)`` where tensor
    dimension ``d`` names that mesh axis, else ``Replicate()``.  A tuple
    entry such as ``("pod", "data")`` gives ``Shard(d)`` on each of
    those mesh dimensions, split major first as the mesh orders them."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = _ctx.mesh if mesh is None else mesh
    if not isinstance(spec, PartitionSpec):
        spec = spec_for(spec)
    names = mesh_axis_names(mesh)
    out = []
    for ax in names:
        dims = [i for i, e in enumerate(spec)
                if e == ax or (isinstance(e, tuple) and ax in e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    for e in spec:
        if isinstance(e, tuple) and [a for a in names if a in e] != list(e):
            raise ValueError(f"spec entry {e} is not in the mesh's axis "
                             f"order {names}")
    return tuple(out)


def local_shape(shape: Sequence[int], spec: PartitionSpec, mesh) -> tuple:
    """The largest local shard's shape (rank 0's, as ``torch.chunk``
    splits an uneven dimension) of a tensor of ``shape`` under ``spec``."""
    out = list(shape)
    for i, e in enumerate(spec):
        for ax in ((e,) if isinstance(e, str) else (e or ())):
            n = mesh_axis_size(mesh, ax)
            out[i] = -(-out[i] // n)
    return tuple(out)


def is_dtensor(x: Any) -> bool:
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def shard(x: torch.Tensor, *names: Optional[str]) -> torch.Tensor:
    """Constrain ``x`` to its logical axes: a DTensor is redistributed to
    the spec's placements.  A no-op outside a rules context and on plain
    tensors (the local shards inside :func:`shard_map_compat`)."""
    if not active() or not is_dtensor(x):
        return x
    if len(names) != x.dim():
        raise ValueError(f"shard(): {len(names)} names for rank-{x.dim()} "
                         f"tensor")
    want = placements_for(names, x.device_mesh)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def grad_like(x: torch.Tensor) -> torch.Tensor:
    """``x`` unchanged, its gradient redistributed to ``x``'s placements
    (the cotangent of a ``with_sharding_constraint`` carries the
    constraint's sharding).  A no-op on plain tensors."""
    if not is_dtensor(x):
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local(), x.device_mesh, x.placements,
                              run_check=False, shape=x.shape,
                              stride=x.stride())


class Axes:
    """Logical axes metadata for one parameter (a tree *leaf*)."""

    __slots__ = ("names",)

    def __init__(self, *names: Optional[str]):
        self.names = tuple(names)

    def prepend(self, name: Optional[str]) -> "Axes":
        return Axes(name, *self.names)

    def __repr__(self):
        return f"Axes{self.names}"

    def __eq__(self, other):
        return isinstance(other, Axes) and self.names == other.names

    def __hash__(self):
        return hash(self.names)


def _is_axes(x) -> bool:
    return isinstance(x, Axes)


def map_axes(fn: Callable[[Axes], Any], axes_tree: Any) -> Any:
    leaves, spec = tree.flatten(axes_tree, _is_axes)
    return tree.unflatten(spec, [fn(a) for a in leaves])


class NamedSharding:
    """A spec on a mesh (``jax.sharding.NamedSharding``): ``spec`` for
    comparison and shard shapes, ``placements`` for DTensor."""

    __slots__ = ("mesh", "spec")

    def __init__(self, mesh, spec: PartitionSpec):
        self.mesh, self.spec = mesh, spec

    @property
    def placements(self) -> tuple:
        return placements_for(self.spec, self.mesh)

    def __repr__(self):
        return f"NamedSharding({self.spec!r})"


def sharding_for(names: Sequence[Optional[str]]) -> NamedSharding:
    return NamedSharding(_ctx.mesh, spec_for(names))


def specs_tree(axes_tree):
    """A tree of Axes -> the tree of specs under the active rules."""
    return map_axes(lambda a: spec_for(a.names), axes_tree)


def shardings_tree(axes_tree):
    """A tree of Axes -> the tree of :class:`NamedSharding` on the active
    mesh."""
    return map_axes(lambda a: sharding_for(a.names), axes_tree)


def distribute(x: torch.Tensor, sharding: NamedSharding) -> torch.Tensor:
    """A full tensor (the same on every rank) -> its DTensor under
    ``sharding``: each rank keeps its own shard, with no communication."""
    spec = sharding.spec
    local = to_local(x, sharding.mesh, spec)
    return from_local(local, sharding.mesh, spec, shape=x.shape)


def full(x: Any) -> Any:
    """A DTensor's full value as a plain tensor (others unchanged)."""
    return x.full_tensor() if is_dtensor(x) else x


# ---------------------------------------------------------------------------
# Local shards (the counterpart of shard_map)
# ---------------------------------------------------------------------------
def to_local(x: torch.Tensor, mesh, spec: PartitionSpec,
             summed_axes: Sequence[str] = ()) -> torch.Tensor:
    """This rank's shard of ``x`` under ``spec``: a DTensor is
    redistributed there first; a plain tensor is taken as the full
    (replicated) value and cut locally, with no communication.  Over
    ``summed_axes`` where ``x`` is replicated, the local gradients are
    partial sums (each rank's share of the work), so the backward adds
    them up."""
    from torch.distributed.tensor import DTensor, Partial, Replicate
    want = placements_for(spec, mesh)
    if not isinstance(x, DTensor):
        x = DTensor.from_local(x, mesh, [Replicate()] * mesh.ndim,
                               run_check=False)
    if tuple(x.placements) != want:
        x = x.redistribute(mesh, want)
    names = mesh_axis_names(mesh)
    grads = [Partial() if p.is_replicate() and names[i] in summed_axes
             else p for i, p in enumerate(want)]
    return x.to_local(grad_placements=grads)


class _ScaleGrad(torch.autograd.Function):
    """Identity forward; the gradient times ``scale``."""

    @staticmethod
    def forward(ctx, x, scale):
        ctx.scale = scale
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g * ctx.scale, None


class _Psum(torch.autograd.Function):
    """All-reduce (sum) over a process group; its transpose is the same
    all-reduce of the gradients (``psum``)."""

    @staticmethod
    def forward(ctx, x, group):
        import torch.distributed._functional_collectives as funcol
        ctx.group = group
        return funcol.wait_tensor(funcol.all_reduce(x, "sum", group))

    @staticmethod
    def backward(ctx, g):
        import torch.distributed._functional_collectives as funcol
        return funcol.wait_tensor(funcol.all_reduce(
            g.contiguous(), "sum", ctx.group)), None


def psum(x: torch.Tensor, mesh, axis: str) -> torch.Tensor:
    """``jax.lax.psum`` over one mesh axis, inside
    :func:`shard_map_compat` (``collective_axes`` must name ``axis``)."""
    return _Psum.apply(x, mesh.get_group(axis))


def from_local(x: torch.Tensor, mesh, spec: PartitionSpec,
               shape: Optional[Sequence[int]] = None) -> torch.Tensor:
    """The DTensor whose shard on this rank is ``x``; ``shape`` gives the
    global shape where a dimension is split unevenly."""
    from torch.distributed.tensor import DTensor
    pl = placements_for(spec, mesh)
    if shape is None:
        return DTensor.from_local(x, mesh, pl, run_check=False)
    return DTensor.from_local(x, mesh, pl, run_check=False,
                              shape=torch.Size(shape),
                              stride=_contiguous_stride(shape))


def _contiguous_stride(shape: Sequence[int]) -> tuple:
    st, acc = [], 1
    for n in reversed(list(shape)):
        st.append(acc)
        acc *= n
    return tuple(reversed(st))


def shard_map_compat(f, *, mesh, in_specs, out_specs,
                     collective_axes: Sequence[str] = ()):
    """``shard_map``: ``f`` runs on this rank's shards of its arguments
    (each a tensor or a tree of tensors, one spec per argument, applied
    to every leaf) and its outputs are this rank's shards of the results
    (one spec per output, or one spec for a single output).  Collectives
    inside ``f`` use ``mesh.get_group(axis)`` (:func:`psum`).  The
    results are DTensors when an argument was one, else plain full
    tensors (the shards gathered), so plain callers get plain values.

    Gradients follow ``shard_map``'s transpose.  Over an axis in
    ``collective_axes`` (those ``f`` communicates over), a replicated
    result's gradient is divided among the ranks and a replicated
    argument's gradient is the sum of the ranks' shares.  Over any other
    axis every rank computes the same thing, and gradients stay
    replicated."""
    names = mesh_axis_names(mesh)

    def run(*args):
        dt = any(is_dtensor(a) for a in tree.flatten(args)[0])
        local = [tree.map_leaves(
            lambda a, s=s: to_local(a, mesh, s, collective_axes), arg)
            if arg is not None else None
            for arg, s in zip(args, in_specs)]
        out = f(*local)

        def back(o, s):
            pl = placements_for(s, mesh)
            n = 1
            for i, p in enumerate(pl):
                if p.is_replicate() and names[i] in collective_axes:
                    n *= mesh.size(i)
            if n > 1:
                o = _ScaleGrad.apply(o, 1.0 / n)
            o = from_local(o, mesh, s)
            return o if dt else o.full_tensor()

        if isinstance(out_specs, PartitionSpec):
            return back(out, out_specs)
        return tuple(back(o, s) for o, s in zip(out, out_specs))

    return run


def dividing(name: str, n: int, mesh) -> MeshAxes:
    """The rules' mesh axes for logical ``name`` when they split ``n``
    evenly, else None (no rules: None)."""
    e = spec_for((name,))[0] if active() else None
    size = 1
    for a in ((e,) if isinstance(e, str) else (e or ())):
        size *= mesh_axis_size(mesh, a)
    return e if n % size == 0 else None


def batch_entry(n: int, mesh) -> MeshAxes:
    """The rules' "batch" axes when they divide ``n`` rows, else None."""
    return dividing("batch", n, mesh)


def on_local_rows(fn, *args, **kw):
    """``fn(*args, **kw)`` on this rank's batch rows when an argument is
    a DTensor: the 4-d arguments (batch first) split over the batch axes,
    the others replicated, and each result batch first.  For computations
    independent across the batch that DTensor cannot propagate (the
    chunked recurrences).  Plain tensors go straight through."""
    if not any(is_dtensor(a) for a in args):
        return fn(*args, **kw)
    x = next(a for a in args if is_dtensor(a))
    mesh = x.device_mesh
    b = batch_entry(x.shape[0], mesh)

    def spec(a):
        if a is None:
            return None
        return P(*([b] + [None] * (a.dim() - 1) if a.dim() == 4
                   else [None] * a.dim()))

    out_spec = P(b, None, None, None)
    return shard_map_compat(lambda *a: fn(*a, **kw), mesh=mesh,
                            in_specs=tuple(spec(a) for a in args),
                            out_specs=(out_spec, out_spec))(*args)
