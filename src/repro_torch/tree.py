"""Trees of tensors: nested dicts, tuples, lists and NamedTuples with
tensor leaves, as the reference's pytrees of parameters, optimizer states
and trajectories.  ``()`` and ``None`` are empty nodes.  Dicts keep their
insertion order, so two trees built the same way line up leaf for leaf.
"""

from __future__ import annotations

from typing import Any, Callable, Iterator

Tree = Any


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def leaves(tree: Tree) -> list:
    """The leaves in order."""
    return list(_iter(tree))


def _iter(tree: Tree) -> Iterator:
    if tree is None:
        return
    if isinstance(tree, dict):
        for v in tree.values():
            yield from _iter(v)
    elif isinstance(tree, (tuple, list)):
        for v in tree:
            yield from _iter(v)
    else:
        yield tree


def tree_map(fn: Callable, tree: Tree, *rest: Tree) -> Tree:
    """``fn`` over the leaves of ``tree`` and, leaf for leaf, of ``rest``,
    which have ``tree``'s structure."""
    if tree is None:
        return None
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    if _is_namedtuple(tree):
        return type(tree)(*(tree_map(fn, v, *(r[i] for r in rest))
                             for i, v in enumerate(tree)))
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, v, *(r[i] for r in rest))
                          for i, v in enumerate(tree))
    return fn(tree, *rest)


def unflatten(like: Tree, values: list) -> Tree:
    """A tree of ``like``'s structure holding ``values`` as its leaves."""
    it = iter(values)
    out = tree_map(lambda _: next(it), like)
    if next(it, None) is not None:
        raise ValueError("more values than the tree has leaves")
    return out
