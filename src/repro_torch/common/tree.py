"""Nested dicts (and lists / tuples) of tensors as trees, in the order
``jax.tree`` flattens them: dict keys sorted at every level."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple


def leaves_with_paths(tree, prefix: Tuple = ()) -> List[Tuple[Tuple, Any]]:
    """(key path, leaf) of every leaf; a path holds dict keys and sequence
    indices."""
    if isinstance(tree, dict):
        return [item for k in sorted(tree)
                for item in leaves_with_paths(tree[k], (*prefix, k))]
    if isinstance(tree, (list, tuple)):
        return [item for i, v in enumerate(tree)
                for item in leaves_with_paths(v, (*prefix, i))]
    return [(prefix, tree)]


def leaves(tree) -> List[Any]:
    return [leaf for _, leaf in leaves_with_paths(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest``, which share its structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def prune(tree, paths):
    """``tree`` (nested dicts) without the leaves at ``paths`` (key
    paths) and without the dicts that leaves nothing in; ``tree`` itself
    where ``paths`` is empty."""
    if not paths:
        return tree
    return _prune(tree, (), frozenset(paths))


def _prune(node, prefix, paths):
    out = {}
    for k, v in node.items():
        path = (*prefix, k)
        if path in paths:
            continue
        if isinstance(v, dict):
            v = _prune(v, path, paths)
            if not v:
                continue
        out[k] = v
    return out


def unflatten(template, values: List[Any]):
    """``template``'s structure with its leaves replaced, in
    ``leaves_with_paths`` order, by ``values``."""
    it = iter(values)
    order = {path: next(it) for path, _ in leaves_with_paths(template)}
    return _build(template, (), order)


def _build(node, prefix, order):
    # module level, not a closure: a recursive closure is a reference
    # cycle, which would keep ``order``'s tensors alive until the cyclic
    # garbage collector ran
    if isinstance(node, dict):
        return {k: _build(node[k], (*prefix, k), order) for k in node}
    if isinstance(node, (list, tuple)):
        return type(node)(_build(v, (*prefix, i), order)
                          for i, v in enumerate(node))
    return order[prefix]
