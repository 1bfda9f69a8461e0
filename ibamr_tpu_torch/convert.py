"""Carry objects of the JAX reference over to the port, so that both sides
compute from the same inputs. Every leaf goes through ``np.asarray``;
this module imports neither JAX nor ``ibamr_tpu`` and works on any
objects with the reference's field names. Like every entry point of the
port, each converter places its tensors on ``cuda`` unless it is passed
``device="cpu"``, and raises without a GPU.
"""

from __future__ import annotations

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.integrators.ib import IBState
from ibamr_tpu_torch.integrators.ins import INSState
from ibamr_tpu_torch.ops import forces
from ibamr_tpu_torch.ops.interaction_fast import Buckets
from ibamr_tpu_torch.ops.interaction_packed import PackedBuckets


def tensor(a, device="cuda", dtype=None) -> torch.Tensor:
    """One array-like leaf as a tensor (a copy, never a view)."""
    return torch.tensor(np.array(a), dtype=dtype,
                        device=resolve_device(device))


def ins_state(s, device="cuda") -> INSState:
    """An ``INSState``'s leaves (u, p, n_prev, t, k)."""
    return INSState(u=tuple(tensor(c, device) for c in s.u),
                    p=tensor(s.p, device),
                    n_prev=tuple(tensor(c, device) for c in s.n_prev),
                    t=tensor(s.t, device),
                    k=tensor(s.k, device, torch.int32))


def ib_state(s, device="cuda") -> IBState:
    """An ``IBState``'s leaves (ins, X, U, mask)."""
    return IBState(ins=ins_state(s.ins, device), X=tensor(s.X, device),
                   U=tensor(s.U, device), mask=tensor(s.mask, device))


def force_specs(specs, num_markers: int,
                device="cuda") -> forces.ForceSpecs:
    """A ``ForceSpecs`` with springs, beams and/or targets, with the
    port's gather table for ``num_markers``."""
    idx = dict(dtype=torch.int64, device=device)
    springs = beams = targets = None
    if specs.springs is not None:
        s = specs.springs
        springs = forces.SpringSpecs(
            idx0=tensor(s.idx0, **idx), idx1=tensor(s.idx1, **idx),
            stiffness=tensor(s.stiffness, device),
            rest_length=tensor(s.rest_length, device),
            enabled=tensor(s.enabled, device))
    if specs.beams is not None:
        b = specs.beams
        beams = forces.BeamSpecs(
            prev=tensor(b.prev, **idx), mid=tensor(b.mid, **idx),
            nxt=tensor(b.nxt, **idx), rigidity=tensor(b.rigidity, device),
            rest_curvature=tensor(b.rest_curvature, device),
            enabled=tensor(b.enabled, device))
    if getattr(specs, "targets", None) is not None:
        t = specs.targets
        targets = forces.TargetSpecs(
            idx=tensor(t.idx, **idx), stiffness=tensor(t.stiffness, device),
            damping=tensor(t.damping, device),
            X_target=tensor(t.X_target, device),
            enabled=tensor(t.enabled, device))
    return forces.make_force_specs(springs, beams, targets,
                                   num_markers=num_markers)


def buckets(b, device="cuda") -> Buckets:
    """A per-tile ``Buckets`` layout; integer fields keep int32 and the
    two overflow flags become host bools. The reference keeps no per-tile
    count: ``counts`` is its occupancy, read off ``slot_of_marker``."""
    i32 = dict(dtype=torch.int32, device=device)
    B, cap = np.shape(b.wb)
    slot = np.asarray(b.slot_of_marker)
    counts = np.bincount(slot[slot < B * cap] // cap, minlength=B)
    return Buckets(
        Xb=tensor(b.Xb, device), wb=tensor(b.wb, device),
        slot_of_marker=tensor(b.slot_of_marker, **i32),
        w_overflow=tensor(b.w_overflow, device),
        o_idx=tensor(b.o_idx, **i32), o_w=tensor(b.o_w, device),
        any_overflow=bool(np.asarray(b.any_overflow)),
        exceeded=bool(np.asarray(b.exceeded)),
        x0=tuple(tensor(x, **i32) for x in b.x0),
        counts=tensor(counts, **i32))


def packed_buckets(b, device="cuda") -> PackedBuckets:
    """A ``PackedBuckets`` layout, converted as :func:`buckets` plus its
    chunk-to-tile map."""
    fields = buckets(b, device)._asdict()
    del fields["counts"]
    return PackedBuckets(**fields,
                         tile_of_chunk=tensor(b.tile_of_chunk, device,
                                              torch.int32))
