"""Nested dict/list/tuple trees of tensors (the port's params, optimizer
state and batches), walked in the reference's pytree order: dict keys
sorted, lists and tuples in order. ``None`` is an empty subtree."""
from __future__ import annotations

from typing import Any, Callable, Iterator, List, Tuple


def leaves(tree) -> List[Any]:
    """The leaves in pytree order."""
    return [leaf for _, leaf in items(tree)]


def items(tree, prefix: Tuple = ()) -> Iterator[Tuple[Tuple, Any]]:
    """(path, leaf) in pytree order; a path holds dict keys and list or
    tuple indices."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from items(tree[k], prefix + (k,))
    elif isinstance(tree, (list, tuple)):
        for i, v in enumerate(tree):
            yield from items(v, prefix + (i,))
    elif tree is not None:
        yield prefix, tree


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of ``tree`` and the matching leaves of
    ``rest`` (same structure), in a tree of ``tree``'s structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if isinstance(tree, (list, tuple)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    if tree is None:
        return None
    return fn(tree, *rest)


def tree_unflatten(like, values):
    """A tree of ``like``'s structure holding ``values`` (a sequence in
    pytree order, as ``leaves(like)`` gives them)."""
    it = iter(values)

    def build(tree):
        if isinstance(tree, dict):
            out = {k: build(tree[k]) for k in sorted(tree)}
            return {k: out[k] for k in tree}
        if isinstance(tree, (list, tuple)):
            return type(tree)(build(v) for v in tree)
        return None if tree is None else next(it)
    return build(like)
