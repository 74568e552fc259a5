"""Flatten and rebuild nested dicts, tuples and lists of tensors.

The port's parameters and optimizer state are plain trees, as the JAX
package's pytrees are.  Dict keys are taken in sorted order, as
``jax.tree.flatten`` takes them, so leaf ``i`` of a tree is the same leaf
in both packages.
"""
from __future__ import annotations

from typing import Any, Callable, List, Optional, Tuple

Spec = Tuple[str, Any]


def flatten(tree: Any, is_leaf: Optional[Callable[[Any], bool]] = None
            ) -> Tuple[List[Any], Spec]:
    """-> (leaves in order, the spec :func:`unflatten` rebuilds from).
    ``is_leaf`` stops the walk at a matching subtree."""
    leaves: List[Any] = []

    def walk(t):
        if is_leaf is not None and is_leaf(t):
            leaves.append(t)
            return ("leaf", None)
        if isinstance(t, dict):
            return ("dict", [(k, walk(t[k])) for k in sorted(t)])
        if isinstance(t, (tuple, list)):
            return (type(t).__name__, [walk(x) for x in t])
        leaves.append(t)
        return ("leaf", None)

    return leaves, walk(tree)


def unflatten(spec: Spec, leaves: List[Any]) -> Any:
    it = iter(leaves)

    def build(s):
        kind, body = s
        if kind == "leaf":
            return next(it)
        if kind == "dict":
            return {k: build(v) for k, v in body}
        items = [build(v) for v in body]
        return tuple(items) if kind == "tuple" else items

    return build(spec)


def map_leaves(fn: Callable[..., Any], tree: Any, *rest: Any) -> Any:
    """``fn`` over the leaves of ``tree`` and the same-shaped ``rest``."""
    leaves, spec = flatten(tree)
    others = [flatten(t)[0] for t in rest]
    return unflatten(spec, [fn(*xs) for xs in zip(leaves, *others)])
