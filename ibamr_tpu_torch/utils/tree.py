"""Pytrees of tensors: nested NamedTuples, tuples, lists and dicts, with
the leaf order and key paths of ``jax.tree_util`` (fields and items in
order, dict keys sorted, ``None`` an empty subtree), so that the port's
checkpoints name their leaves as the reference's do."""

from __future__ import annotations

from typing import Any, Callable, List, Tuple

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
