"""Lagrangian force generation: springs, beams and target points (port
of ``ibamr_tpu/ops/forces.py``):

  springs: F_i += k (|X_j - X_i| - L0) (X_j - X_i)/|X_j - X_i|  (+ reaction)
  beams:   F -= c D^4 X  via curvature D = X_prev - 2 X_mid + X_next - C0
  targets: F_i += kappa (X0_i - X_i) - eta U_i

Specs are structure-of-arrays index lists. Every family's contribution
accumulates through a static (N, K) gather table built once, when the
specs are built (:func:`make_force_specs`): row i lists the positions in
the concatenated contribution list that act on marker i, padded with the
index of an explicit zero row. The force assembly is then gathers and a
sum over K, with no scatter.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch


class SpringSpecs(NamedTuple):
    """M springs between marker indices idx0[m] -- idx1[m]."""
    idx0: torch.Tensor          # (M,) int64
    idx1: torch.Tensor          # (M,) int64
    stiffness: torch.Tensor     # (M,)
    rest_length: torch.Tensor   # (M,)
    enabled: torch.Tensor       # (M,) 0/1 mask (padding support)


class BeamSpecs(NamedTuple):
    """M bending elements (prev, mid, next) with rigidity and rest
    curvature."""
    prev: torch.Tensor            # (M,) int64
    mid: torch.Tensor             # (M,) int64
    nxt: torch.Tensor             # (M,) int64
    rigidity: torch.Tensor        # (M,)
    rest_curvature: torch.Tensor  # (M, dim)
    enabled: torch.Tensor         # (M,)


class TargetSpecs(NamedTuple):
    """M tether points anchoring marker idx[m] to X_target[m]."""
    idx: torch.Tensor          # (M,) int64
    stiffness: torch.Tensor    # (M,)
    damping: torch.Tensor      # (M,)
    X_target: torch.Tensor     # (M, dim)
    enabled: torch.Tensor      # (M,)


class ForceSpecs(NamedTuple):
    springs: Optional[SpringSpecs] = None
    beams: Optional[BeamSpecs] = None
    targets: Optional[TargetSpecs] = None
    # (N, K) int64 gather table into the concatenated contributions
    # (springs idx0, idx1, then beams prev, mid, nxt, then targets idx);
    # entry M is the zero pad row. None when there are no specs.
    gather: Optional[torch.Tensor] = None


def make_springs(idx0, idx1, stiffness, rest_length, dtype=torch.float32,
                 device="cuda") -> SpringSpecs:
    idx0 = torch.as_tensor(np.asarray(idx0), dtype=torch.int64,
                           device=device)
    return SpringSpecs(
        idx0=idx0,
        idx1=torch.as_tensor(np.asarray(idx1), dtype=torch.int64,
                             device=device),
        stiffness=torch.as_tensor(np.asarray(stiffness), dtype=dtype,
                                  device=device),
        rest_length=torch.as_tensor(np.asarray(rest_length), dtype=dtype,
                                    device=device),
        enabled=torch.ones(idx0.shape, dtype=dtype, device=device))


def make_beams(prev, mid, nxt, rigidity, rest_curvature=None, dim=2,
               dtype=torch.float32, device="cuda") -> BeamSpecs:
    prev = torch.as_tensor(np.asarray(prev), dtype=torch.int64,
                           device=device)
    if rest_curvature is None:
        rest_curvature = np.zeros((prev.shape[0], dim))
    return BeamSpecs(
        prev=prev,
        mid=torch.as_tensor(np.asarray(mid), dtype=torch.int64,
                            device=device),
        nxt=torch.as_tensor(np.asarray(nxt), dtype=torch.int64,
                            device=device),
        rigidity=torch.as_tensor(np.asarray(rigidity), dtype=dtype,
                                 device=device),
        rest_curvature=torch.as_tensor(np.asarray(rest_curvature),
                                       dtype=dtype, device=device),
        enabled=torch.ones(prev.shape, dtype=dtype, device=device))


def make_targets(idx, stiffness, X_target, damping=None,
                 dtype=torch.float32, device="cuda") -> TargetSpecs:
    idx = torch.as_tensor(np.asarray(idx), dtype=torch.int64, device=device)
    if damping is None:
        damping = np.zeros(idx.shape)
    return TargetSpecs(
        idx=idx,
        stiffness=torch.as_tensor(np.asarray(stiffness), dtype=dtype,
                                  device=device),
        damping=torch.as_tensor(np.asarray(damping), dtype=dtype,
                                device=device),
        X_target=torch.as_tensor(np.asarray(X_target), dtype=dtype,
                                 device=device),
        enabled=torch.ones(idx.shape, dtype=dtype, device=device))


def spring_energy(X: torch.Tensor, s: SpringSpecs) -> torch.Tensor:
    d = X[s.idx1] - X[s.idx0]
    length = torch.sqrt(torch.sum(d * d, dim=-1))
    return 0.5 * torch.sum(
        s.enabled * s.stiffness * (length - s.rest_length) ** 2)


def _index_arrays(springs: Optional[SpringSpecs],
                  beams: Optional[BeamSpecs],
                  targets: Optional[TargetSpecs] = None):
    out = []
    if springs is not None:
        out += [springs.idx0, springs.idx1]
    if beams is not None:
        out += [beams.prev, beams.mid, beams.nxt]
    if targets is not None:
        out += [targets.idx]
    return out


def _gather_table(index_arrays, N: int) -> np.ndarray:
    """Host-side assembly plan: a stable argsort of the concatenated
    scatter indices, then row i of the (N, K) table holds, in increasing
    order, the positions contributing to marker i, padded with M."""
    ids = np.concatenate([a.reshape(-1).cpu().numpy()
                          for a in index_arrays])
    M = ids.shape[0]
    perm = np.argsort(ids, kind="stable")
    sorted_ids = ids[perm]
    counts = np.bincount(ids, minlength=N)
    K = int(counts.max()) if M else 0
    starts = np.concatenate([[0], np.cumsum(counts)])
    gather = np.full((N, max(K, 1)), M, dtype=np.int64)
    rank = np.arange(M, dtype=np.int64) - starts[sorted_ids]
    gather[sorted_ids, rank] = perm
    return gather


def make_force_specs(springs: Optional[SpringSpecs] = None,
                     beams: Optional[BeamSpecs] = None,
                     targets: Optional[TargetSpecs] = None,
                     num_markers: int = 0) -> ForceSpecs:
    """Force specs with their (N, K) gather table, built once here."""
    idx = _index_arrays(springs, beams, targets)
    gather = None
    if idx:
        gather = torch.as_tensor(_gather_table(idx, int(num_markers)),
                                 device=idx[0].device)
    return ForceSpecs(springs=springs, beams=beams, targets=targets,
                      gather=gather)


def compute_lagrangian_force(X: torch.Tensor, U: torch.Tensor,
                             specs: ForceSpecs) -> torch.Tensor:
    """Assemble F(X, U) over all marker nodes -> (N, dim)."""
    vals = []
    if specs.springs is not None:
        s = specs.springs
        d = X[s.idx1] - X[s.idx0]                        # (M, dim)
        length = torch.sqrt(torch.sum(d * d, dim=-1))    # (M,)
        safe = torch.where(length > 0, length, torch.ones_like(length))
        tension = s.enabled * s.stiffness * (length - s.rest_length)
        fvec = (tension / safe)[:, None] * d             # force on idx0
        vals += [fvec, -fvec]
    if specs.beams is not None:
        b = specs.beams
        D = X[b.prev] - 2.0 * X[b.mid] + X[b.nxt] - b.rest_curvature
        cD = (b.enabled * b.rigidity)[:, None] * D
        vals += [-cD, 2.0 * cD, -cD]
    if specs.targets is not None:
        tgt = specs.targets
        disp = tgt.X_target - X[tgt.idx]
        vals += [(tgt.enabled * tgt.stiffness)[:, None] * disp
                 - (tgt.enabled * tgt.damping)[:, None] * U[tgt.idx]]
    if not vals:
        return torch.zeros_like(X)
    # explicit zero row at index M: the pad target of the gather table
    vals.append(torch.zeros_like(X[:1]))
    allv = torch.cat(vals, dim=0)
    N, K = specs.gather.shape
    return torch.sum(allv[specs.gather.reshape(-1)].reshape(N, K, -1),
                     dim=1)
