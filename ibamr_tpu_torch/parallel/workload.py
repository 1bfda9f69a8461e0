"""Workload-balanced partitioning (S3): the Lagrangian cost model (the
port's own copy of ``ibamr_tpu/parallel/workload.py``, host numpy).

Reference parity: ``IBStrategy::updateWorkloadEstimates`` +
``LoadBalancer`` (SURVEY.md §2.3 S3, §3.4) — the reference adds a
marker-count weight to each cell so the box partitioner equalizes
Eulerian + Lagrangian cost per rank.

As in the reference, the grid is split in EQUAL blocks (the sharded
steps of ``parallel/mesh.py``), so the balancing levers are these:

1. **Mesh-axis selection.** For a P-device mesh there are several ways
   to factor P over the grid axes (8 = 8x1 = 4x2 = 2x4 = 1x8 ...);
   clustered structures (a shell mid-domain, a falling drop) produce
   very different per-shard marker maxima under each. ``choose_mesh``
   evaluates the cost model over the candidate factorizations against
   the actual marker histogram and returns the best — the partitioner
   decision, made once per regrid cadence on the host (cheap: a few
   histograms over N integers).
2. **Capacity sizing.** The sharded transfer engine
   (:class:`~ibamr_tpu_torch.parallel.lagrangian.ShardedInteraction`) uses
   fixed per-shard pools; ``recommended_capacity`` sizes them from the
   measured histogram (instead of the uniform N/P * slack guess) so the
   fast path holds exactly when the cost model says it can.
3. **Rebalance cadence.** ``needs_rebalance`` is the host-side check
   (the analog of the reference's regrid-triggered load balancing):
   markers drifted enough that the current capacity would overflow, or
   a different factorization now wins by more than ``hysteresis``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple, Optional, Sequence, Tuple

import numpy as np

from ibamr_tpu_torch.grid import StaggeredGrid

__all__ = ["shard_marker_counts", "workload_estimate", "choose_mesh",
           "recommended_capacity", "needs_rebalance", "WorkloadReport",
           "box_costs", "lpt_assign"]


def _factorizations(P: int, naxes: int) -> List[Tuple[int, ...]]:
    """All ordered factorizations of P into ``naxes`` factors."""
    if naxes == 1:
        return [(P,)]
    out = []
    for f in range(1, P + 1):
        if P % f == 0:
            for rest in _factorizations(P // f, naxes - 1):
                out.append((f,) + rest)
    return out


def shard_marker_counts(X: np.ndarray, grid: StaggeredGrid,
                        sizes: Sequence[int],
                        mask: Optional[np.ndarray] = None) -> np.ndarray:
    """Markers owned by each shard of a ``sizes`` block partition
    (same owner math as ShardedInteraction.buckets), shape ``sizes``."""
    X = np.asarray(X)
    sizes = tuple(int(s) for s in sizes)
    for d, p in enumerate(sizes):
        if grid.n[d] % p != 0:
            raise ValueError(
                f"sizes[{d}]={p} does not divide grid axis "
                f"{grid.n[d]} — not a GSPMD partition")
    if mask is not None:
        X = X[np.asarray(mask) != 0]
    idx = []
    for d, p in enumerate(sizes):
        nloc = grid.n[d] // p
        c = np.floor((X[:, d] - grid.x_lo[d]) / grid.dx[d]).astype(int)
        c = np.mod(c, grid.n[d])
        idx.append(np.clip(c // nloc, 0, p - 1))
    flat = np.zeros(int(np.prod(sizes)), dtype=np.int64)
    lin = idx[0]
    for d in range(1, len(sizes)):
        lin = lin * sizes[d] + idx[d]
    np.add.at(flat, lin, 1)
    return flat.reshape(sizes)


class WorkloadReport(NamedTuple):
    sizes: Tuple[int, ...]       # chosen mesh factorization
    cost_per_shard: np.ndarray   # estimated cost per shard
    imbalance: float             # max/mean cost ratio
    max_markers: int             # largest per-shard marker count
    capacity: int                # recommended per-shard pool capacity


def workload_estimate(counts: np.ndarray, grid: StaggeredGrid,
                      w_marker: float = 4.0) -> np.ndarray:
    """Per-shard cost: local grid cells + w_marker * local markers.
    ``w_marker`` is the relative cost of one marker's spread+interp
    stencils vs one grid cell's stencil updates (the reference's
    default workload weight is O(1); delta-kernel transfers touch
    s^dim cells per marker, so the default leans higher)."""
    cells = np.prod(grid.n) / counts.size
    return cells + w_marker * counts.astype(np.float64)


def recommended_capacity(counts: np.ndarray, slack: float = 1.5,
                         quantum: int = 8) -> int:
    """Per-shard pool capacity covering the measured maximum with
    headroom, rounded up to the allocation quantum."""
    peak = int(counts.max()) if counts.size else 0
    return int(math.ceil(max(peak, 1) * slack / quantum) * quantum)


def choose_mesh(X: np.ndarray, grid: StaggeredGrid, n_devices: int,
                max_axes: int = 2, w_marker: float = 4.0,
                min_block: Optional[int] = None,
                mask: Optional[np.ndarray] = None) -> WorkloadReport:
    """Evaluate every mesh factorization of ``n_devices`` over at most
    ``max_axes`` leading grid axes against the marker histogram; return
    the factorization minimizing the maximum per-shard cost. Ties keep
    the earliest candidate — fewer sharded axes first (mean cost is
    factorization-invariant, so equal max cost implies equal
    imbalance). ``min_block`` rejects factorizations whose local blocks
    are thinner than the transfer halo."""
    best: Optional[WorkloadReport] = None
    naxes = min(max_axes, grid.dim)
    for k in range(1, naxes + 1):
        for sizes in _factorizations(n_devices, k):
            ok = True
            for d, p in enumerate(sizes):
                if grid.n[d] % p != 0:
                    ok = False
                    break
                if min_block is not None and grid.n[d] // p < min_block:
                    ok = False
                    break
            if not ok:
                continue
            counts = shard_marker_counts(X, grid, sizes, mask=mask)
            cost = workload_estimate(counts, grid, w_marker=w_marker)
            rep = WorkloadReport(
                sizes=sizes,
                cost_per_shard=cost,
                imbalance=float(cost.max() / cost.mean()),
                max_markers=int(counts.max()),
                capacity=recommended_capacity(counts))
            if best is None or cost.max() < best.cost_per_shard.max() \
                    - 1e-9:
                best = rep
    if best is None:
        raise ValueError(
            f"no valid factorization of {n_devices} devices for grid "
            f"{grid.n} (min_block={min_block})")
    return best


def box_costs(lo: np.ndarray, box_shape: Sequence[int],
              grid: StaggeredGrid, ratio: int = 2,
              X: Optional[np.ndarray] = None,
              w_marker: float = 4.0) -> np.ndarray:
    """Per-window workload of a K-box fine level: fine cells +
    ``w_marker`` x markers inside each window (the same cost model as
    :func:`workload_estimate`, per box instead of per shard — the
    SAMRAI ``LoadBalancer`` weights patches exactly this way before
    bin-packing them onto ranks [U])."""
    lo = np.asarray(lo)
    K = lo.shape[0]
    cells = float(np.prod([s * ratio for s in box_shape]))
    costs = np.full(K, cells, dtype=np.float64)
    if X is not None and len(X):
        Xi = np.asarray(X)
        for k in range(K):
            inside = np.ones(len(Xi), dtype=bool)
            for d in range(grid.dim):
                x0 = grid.x_lo[d] + lo[k, d] * grid.dx[d]
                x1 = x0 + box_shape[d] * grid.dx[d]
                inside &= (Xi[:, d] >= x0) & (Xi[:, d] < x1)
            costs[k] += w_marker * int(inside.sum())
    return costs


def lpt_assign(costs: np.ndarray, n_devices: int
               ) -> Tuple[np.ndarray, np.ndarray]:
    """Greedy LPT (longest-processing-time) bin-packing: sort items by
    descending cost, always assign to the least-loaded device — the
    classic 4/3-approximation the reference's greedy
    ``LoadBalancer::loadBalanceBoxLevel`` uses [U]. Returns
    (device_of_item (K,), per-device load (n_devices,))."""
    costs = np.asarray(costs, dtype=np.float64)
    order = np.argsort(-costs)
    load = np.zeros(n_devices, dtype=np.float64)
    device = np.zeros(costs.size, dtype=np.int64)
    for k in order:
        d = int(np.argmin(load))
        device[k] = d
        load[d] += costs[k]
    return device, load


def needs_rebalance(X: np.ndarray, grid: StaggeredGrid,
                    sizes: Sequence[int], capacity: int,
                    n_devices: Optional[int] = None,
                    hysteresis: float = 1.3,
                    mask: Optional[np.ndarray] = None,
                    min_block: Optional[int] = None,
                    max_axes: int = 2, w_marker: float = 4.0) -> bool:
    """Host-side regrid-cadence check: True when the current partition
    would overflow its pools, or another factorization beats the
    current maximum cost by more than ``hysteresis``. Pass the SAME
    ``w_marker``/``max_axes`` used when the current partition was
    chosen, so both sides of the comparison share one cost model."""
    counts = shard_marker_counts(X, grid, sizes, mask=mask)
    if int(counts.max()) > capacity:
        return True
    if n_devices is None:
        n_devices = int(np.prod(tuple(sizes)))
    cur_cost = workload_estimate(counts, grid, w_marker=w_marker).max()
    best = choose_mesh(X, grid, n_devices, max_axes=max_axes,
                       w_marker=w_marker, mask=mask,
                       min_block=min_block)
    return bool(cur_cost > hysteresis * best.cost_per_shard.max())
