"""Pytrees of tensors: nested NamedTuples, tuples, lists and dicts, with
the leaf order and key paths of ``jax.tree_util`` (fields and items in
order, dict keys sorted, ``None`` an empty subtree), so that the port's
checkpoints name their leaves as the reference's do."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

import torch

# one path entry: ("attr", field name) | ("idx", position) | ("key", dict key)
PathEntry = Tuple[str, Any]


def _children(tree):
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return [(("attr", f), v) for f, v in zip(tree._fields, tree)]
    if isinstance(tree, (tuple, list)):
        return [(("idx", i), v) for i, v in enumerate(tree)]
    if isinstance(tree, dict):
        return [(("key", k), tree[k]) for k in sorted(tree)]
    return None


def map_with_path(fn: Callable, tree, path: Tuple[PathEntry, ...] = ()):
    """The tree with every leaf replaced by ``fn(path, leaf)``."""
    if tree is None:
        return None
    kids = _children(tree)
    if kids is None:
        return fn(path, tree)
    out = [map_with_path(fn, v, path + (k,)) for k, v in kids]
    if isinstance(tree, dict):
        return {k[1]: v for (k, _), v in zip(kids, out)}
    if hasattr(tree, "_fields"):
        return type(tree)(*out)
    return type(tree)(out)


def flatten_with_path(tree) -> List[Tuple[Tuple[PathEntry, ...], Any]]:
    """``[(path, leaf), ...]`` in the reference's leaf order."""
    leaves: list = []
    map_with_path(lambda p, leaf: leaves.append((p, leaf)), tree)
    return leaves


def keystr(path: Tuple[PathEntry, ...]) -> str:
    """A path as ``jax.tree_util.keystr`` writes it, e.g. ``.ins.u[0]``."""
    return "".join(f".{v}" if kind == "attr" else
                   f"[{v}]" if kind == "idx" else f"[{v!r}]"
                   for kind, v in path)


def leaves(tree) -> list:
    """The leaves in the reference's order."""
    return [leaf for _, leaf in flatten_with_path(tree)]


def tree_map(fn: Callable, tree, *rest):
    """``jax.tree_util.tree_map``: ``fn`` over the matching leaves of
    ``tree`` and of each tree of ``rest`` (same structure)."""
    others = [leaves(r) for r in rest]
    n = len(leaves(tree))
    if any(len(o) != n for o in others):
        raise ValueError("tree_map: trees of different structure")
    its = [iter(o) for o in others]
    return map_with_path(lambda _, leaf: fn(leaf, *(next(i) for i in its)),
                         tree)


def ravel(tree):
    """``jax.flatten_util.ravel_pytree``: the leaves as one flat vector,
    and the function that rebuilds the tree from such a vector."""
    ls = leaves(tree)
    flat = torch.cat([leaf.reshape(-1) for leaf in ls])
    sizes = [leaf.numel() for leaf in ls]

    def unravel(v):
        parts = iter(torch.split(v, sizes))
        return map_with_path(
            lambda _, leaf: next(parts).reshape(leaf.shape), tree)

    return flat, unravel
