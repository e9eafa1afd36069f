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


def unflatten(template, values: List[Any]):
    """``template``'s structure with its leaves replaced, in
    ``leaves_with_paths`` order, by ``values``."""
    it = iter(values)
    order = {path: next(it) for path, _ in leaves_with_paths(template)}

    def build(node, prefix):
        if isinstance(node, dict):
            return {k: build(node[k], (*prefix, k)) for k in node}
        if isinstance(node, (list, tuple)):
            return type(node)(build(v, (*prefix, i))
                              for i, v in enumerate(node))
        return order[prefix]
    return build(template, ())
