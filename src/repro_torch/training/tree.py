"""Nested params as trees: dicts, lists and tuples of tensors, walked in the
reference's (``jax.tree``) order — dict keys sorted, sequences in order, a
NamedTuple's fields in order — so leaf-order sums and checkpoint keys match
the reference's."""
from __future__ import annotations

from typing import Any, Iterator, List, Tuple


def _children(tree) -> List[Tuple[str, Any]]:
    """(path segment, child) pairs of one node; [] for a leaf. A NamedTuple
    field's segment is ``.name`` (the reference's key for it)."""
    if isinstance(tree, dict):
        return [(str(k), tree[k]) for k in sorted(tree)]
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [("." + f, getattr(tree, f)) for f in tree._fields]
    if isinstance(tree, (list, tuple)):
        return [(str(i), v) for i, v in enumerate(tree)]
    return []


def _is_node(tree) -> bool:
    return isinstance(tree, (dict, list, tuple))


def leaves_with_paths(tree, path: Tuple[str, ...] = ()) -> Iterator[
        Tuple[Tuple[str, ...], Any]]:
    if not _is_node(tree):
        yield path, tree
        return
    for seg, child in _children(tree):
        yield from leaves_with_paths(child, path + (seg,))


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def unflatten(like, values):
    """``like``'s structure with its leaves replaced, in ``leaves`` order,
    by ``values``."""
    it = iter(values)

    def build(t):
        if not _is_node(t):
            return next(it)
        if isinstance(t, dict):
            built = {k: build(t[k]) for k in sorted(t)}
            return {k: built[k] for k in t}       # the caller's key order
        if hasattr(t, "_fields"):
            return type(t)(*(build(getattr(t, f)) for f in t._fields))
        return type(t)(build(v) for v in t)

    out = build(like)
    if next(it, None) is not None:
        raise ValueError("more values than leaves")
    return out
