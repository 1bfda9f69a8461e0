"""Discrete norms over grid fields (port of ``ibamr_tpu/ops/norms.py``):
volume-weighted L1/L2/max norms and inner products, the global
reductions under every Krylov residual. On block-resident leaves
(``parallel.spmd.Blocks``) each inner product is per-block partial sums
combined on the mesh's first device in coordinate order."""

from __future__ import annotations

from typing import Any, Sequence

import torch

from ibamr_tpu_torch.parallel.spmd import Blocks, dots
from ibamr_tpu_torch.utils.tree import leaves, tree_map


def tree_dot(a: Any, b: Any) -> torch.Tensor:
    """Unweighted inner product over matching pytrees (0.0 for empty
    trees)."""
    sums = leaves(tree_map(lambda x, y: torch.sum(x * y), a, b))
    if not sums:
        return torch.tensor(0.0)
    s = sums[0]
    for x in sums[1:]:
        s = s + x
    return s


def tree_dots(pairs: Sequence[Any]) -> torch.Tensor:
    """K inner products as one reduction per leaf: a (K,) vector whose
    row k is ``tree_dot(*pairs[k])``."""
    pairs = list(pairs)
    if not pairs:
        return torch.zeros((0,))
    first = leaves(pairs[0][0])
    if first and isinstance(first[0], Blocks):
        return _blocks_tree_dots(pairs)
    prods = [leaves(tree_map(torch.mul, a, b)) for a, b in pairs]
    per_leaf = [torch.stack(xs).reshape(len(pairs), -1).sum(dim=1)
                for xs in zip(*prods)]
    if not per_leaf:
        return torch.zeros((len(pairs),))
    s = per_leaf[0]
    for x in per_leaf[1:]:
        s = s + x
    return s


def _blocks_tree_dots(pairs) -> torch.Tensor:
    """:func:`tree_dots` of block-resident leaves: per leaf, each shard's
    K partial dots, combined over the shards in coordinate order
    (``parallel.spmd.dots``), then summed over the leaves."""
    lp = [(leaves(a), leaves(b)) for a, b in pairs]
    per_leaf = [dots([(la[j], lb[j]) for la, lb in lp])
                for j in range(len(lp[0][0]))]
    s = per_leaf[0]
    for x in per_leaf[1:]:
        s = s + x
    return s


def l1_norm(f: torch.Tensor, cell_volume: float = 1.0) -> torch.Tensor:
    return torch.sum(torch.abs(f)) * cell_volume


def l2_norm(f: torch.Tensor, cell_volume: float = 1.0) -> torch.Tensor:
    return torch.sqrt(torch.sum(torch.square(f)) * cell_volume)


def max_norm(f: torch.Tensor) -> torch.Tensor:
    return torch.max(torch.abs(f))


def vel_l2_norm(u: Sequence[torch.Tensor],
                cell_volume: float = 1.0) -> torch.Tensor:
    s = torch.sum(torch.square(u[0]))
    for c in u[1:]:
        s = s + torch.sum(torch.square(c))
    return torch.sqrt(s * cell_volume)


def vel_max_norm(u: Sequence[torch.Tensor]) -> torch.Tensor:
    m = torch.max(torch.abs(u[0]))
    for c in u[1:]:
        m = torch.maximum(m, torch.max(torch.abs(c)))
    return m


def dot(a, b, cell_volume: float = 1.0) -> torch.Tensor:
    """Volume-weighted inner product of two fields or two velocity
    tuples."""
    return tree_dot(a, b) * cell_volume
