"""Nested dict / tuple trees of tensors, walked as the reference's
``jax.tree_util`` walks them.

The port's parameter, optimizer and checkpoint trees are plain dicts and
tuples (lists) whose leaves are tensors, numpy arrays or scalars.  Dict
keys are visited in sorted order, as JAX flattens a dict, so a leaf's
position, its path key (``"blocks/0/attn/wq/w"``: dict keys and sequence
indices joined by ``/``) and the order of a sum over leaves are the
reference's.
"""
from __future__ import annotations

from typing import Callable, Iterator, Tuple


def leaves_with_path(tree, prefix: Tuple = ()) -> Iterator[tuple]:
    """(path, leaf) pairs in the reference's flatten order; a path is the
    tuple of dict keys and sequence indices leading to the leaf."""
    if isinstance(tree, dict):
        for k in sorted(tree):
            yield from leaves_with_path(tree[k], prefix + (k,))
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from leaves_with_path(v, prefix + (i,))
    else:
        yield prefix, tree


def leaves(tree) -> list:
    return [leaf for _, leaf in leaves_with_path(tree)]


def path_key(path) -> str:
    """The checkpoint key of a leaf path: its parts joined by ``/``."""
    return "/".join(str(p) for p in path)


def map_with_path(fn: Callable, tree, prefix: Tuple = ()):
    """``fn(path, leaf)`` applied leaf by leaf, keeping the structure."""
    if isinstance(tree, dict):
        return {k: map_with_path(fn, v, prefix + (k,))
                for k, v in tree.items()}
    if isinstance(tree, (tuple, list)):
        return type(tree)(map_with_path(fn, v, prefix + (i,))
                          for i, v in enumerate(tree))
    return fn(prefix, tree)


def tree_map(fn: Callable, tree, *rest):
    """``fn`` applied leaf by leaf over trees of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, tree[k], *(r[k] for r in rest))
                for k in tree}
    if isinstance(tree, (tuple, list)):
        return type(tree)(tree_map(fn, *vs) for vs in zip(tree, *rest))
    return fn(tree, *rest)
