"""Nested-dict trees of tensors: the port's form of the reference's
pytrees (parameters, adapters, optimizer state).

Leaves are visited in sorted-key order, the order ``jax.tree.leaves``
gives a dict, so a flat list of leaves (gradients from
``torch.autograd.grad``, say) maps back onto its tree one for one.
"""

from __future__ import annotations

from typing import Any, Callable, Dict, Iterator, List, Tuple

Tree = Dict[str, Any]


def tree_map(fn: Callable, tree, *rest):
    """fn applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in sorted(tree)}
    return fn(tree, *rest)


def tree_leaves(tree) -> List[Any]:
    if isinstance(tree, dict):
        return [leaf for k in sorted(tree) for leaf in tree_leaves(tree[k])]
    return [tree]


def tree_leaves_with_path(tree, prefix: Tuple[str, ...] = ()
                          ) -> Iterator[Tuple[Tuple[str, ...], Any]]:
    """(key path, leaf) in leaf order; a path joined with "/" is the
    reference's leaf path (``jax.tree_util.tree_flatten_with_path``)."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from tree_leaves_with_path(tree[k], prefix + (str(k),))
    else:
        yield prefix, tree


def tree_map_with_path(fn: Callable, tree, prefix: Tuple[str, ...] = ()):
    """fn(key path, leaf) applied leaf by leaf."""
    if isinstance(tree, dict):
        return {k: tree_map_with_path(fn, tree[k], prefix + (str(k),))
                for k in sorted(tree)}
    return fn(prefix, tree)


def tree_unflatten(like, leaves) -> Any:
    """The tree of `like`'s structure holding `leaves` in leaf order."""
    it = iter(leaves)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more leaves than the tree holds")
    return out
