"""Carry objects of the JAX reference over to the port, so that both sides
compute from the same inputs. Every leaf goes through ``np.asarray``;
this module imports neither JAX nor ``ibamr_tpu`` and works on any
objects with the reference's field names. Like every entry point of the
port, each converter places its tensors on ``cuda`` unless it is passed
``device="cpu"``, and raises without a GPU; the FE meshes stay host
arrays, as in both packages.
"""

from __future__ import annotations

import numpy as np
import torch

from ibamr_tpu_torch.amr import FineBox
from ibamr_tpu_torch.amr_dynamic import AMRState
from ibamr_tpu_torch.amr_ins import TwoLevelIBState, TwoLevelINSState
from ibamr_tpu_torch.amr_ins_multilevel import (MultiLevelIBState,
                                                MultiLevelINSState)
from ibamr_tpu_torch.amr_multibox import MultiBoxState
from ibamr_tpu_torch.amr_multilevel import LevelSpec
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.fe.fem import FEAssembly
from ibamr_tpu_torch.fe.mesh import FEMesh
from ibamr_tpu_torch.fe.surface import SurfaceMesh
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.adv_diff import AdvDiffState
from ibamr_tpu_torch.integrators.cib import RigidBodies
from ibamr_tpu_torch.integrators.constraint_ib import ConstraintIBState
from ibamr_tpu_torch.integrators.ib import IBState
from ibamr_tpu_torch.integrators.ib_open import IBOpenState
from ibamr_tpu_torch.integrators.gib import GIBState
from ibamr_tpu_torch.integrators.imp import IMPState
from ibamr_tpu_torch.integrators.penalty_ib import PenaltyIBState
from ibamr_tpu_torch.instruments import MeterSpecs
from ibamr_tpu_torch.ops.rods import RodSpecs
from ibamr_tpu_torch.integrators.ins import INSState
from ibamr_tpu_torch.integrators.ins_collocated import CollocatedINSState
from ibamr_tpu_torch.integrators.ins_vc import VCConsState, VCINSState
from ibamr_tpu_torch.integrators.ins_open import OpenINSState
from ibamr_tpu_torch.ops import forces
from ibamr_tpu_torch.ops.interaction_fast import Buckets
from ibamr_tpu_torch.ops.interaction_packed import PackedBuckets
from ibamr_tpu_torch.ops.interaction_packed3 import PackedBuckets3
from ibamr_tpu_torch.physics.brinkman import RigidBodyState
from ibamr_tpu_torch.physics.turbulence import KOmegaState


def tensor(a, device="cuda", dtype=None) -> torch.Tensor:
    """One array-like leaf as a tensor (a copy, never a view)."""
    return torch.tensor(np.array(a), dtype=dtype,
                        device=resolve_device(device))


def ins_state(s, device="cuda") -> INSState:
    """An ``INSState``'s leaves (u, p, n_prev, t, k); the periodic and the
    walled (``wall_axes``) integrators share the state. A lane-stacked
    fleet state (a leading lane axis on every leaf, ``utils/lanes.py``)
    carries over the same way."""
    return INSState(u=tuple(tensor(c, device) for c in s.u),
                    p=tensor(s.p, device),
                    n_prev=tuple(tensor(c, device) for c in s.n_prev),
                    t=tensor(s.t, device),
                    k=tensor(s.k, device, torch.int32))


def ib_state(s, device="cuda") -> IBState:
    """An ``IBState``'s leaves (ins, X, U, mask), lane-stacked or not."""
    return IBState(ins=ins_state(s.ins, device), X=tensor(s.X, device),
                   U=tensor(s.U, device), mask=tensor(s.mask, device))


def open_ins_state(s, device="cuda") -> OpenINSState:
    """An ``OpenINSState``'s leaves (the face-complete u, p, t)."""
    return OpenINSState(u=tuple(tensor(c, device) for c in s.u),
                        p=tensor(s.p, device), t=tensor(s.t, device))


def ib_open_state(s, device="cuda") -> IBOpenState:
    """An ``IBOpenState``'s leaves (fluid, X, U, mask, F_net)."""
    return IBOpenState(fluid=open_ins_state(s.fluid, device),
                       X=tensor(s.X, device), U=tensor(s.U, device),
                       mask=tensor(s.mask, device),
                       F_net=tensor(s.F_net, device))


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


def packed_buckets3(b, device="cuda") -> PackedBuckets3:
    """A fully blocked ``PackedBuckets3`` layout, converted as
    :func:`packed_buckets` (a tile origin per axis)."""
    return PackedBuckets3(**packed_buckets(b, device)._asdict())


def fe_mesh(m) -> FEMesh:
    """An ``FEMesh`` (host arrays: nodes, connectivity, element type)."""
    return FEMesh(nodes=np.array(m.nodes), elems=np.array(m.elems),
                  elem_type=str(m.elem_type))


def surface_mesh(m) -> SurfaceMesh:
    """A ``SurfaceMesh`` (host arrays: nodes, connectivity, type)."""
    return SurfaceMesh(nodes=np.array(m.nodes), elems=np.array(m.elems),
                       elem_type=str(m.elem_type))


def fe_assembly(a, device="cuda") -> FEAssembly:
    """An ``FEAssembly``'s tables (connectivity as int64)."""
    return FEAssembly(elems=tensor(a.elems, device, torch.int64),
                      shape=tensor(a.shape, device),
                      dNdX=tensor(a.dNdX, device), wdV=tensor(a.wdV, device),
                      lumped_mass=tensor(a.lumped_mass, device),
                      n_nodes=int(a.n_nodes), dim=int(a.dim))


def rigid_bodies(b, device="cuda") -> RigidBodies:
    """A ``RigidBodies`` (body ids as int64)."""
    return RigidBodies(body_id=tensor(b.body_id, device, torch.int64),
                       n_bodies=int(b.n_bodies))


def constraint_ib_state(s, device="cuda") -> ConstraintIBState:
    """A ``ConstraintIBState``'s leaves (ins, X, U_body)."""
    return ConstraintIBState(ins=ins_state(s.ins, device),
                             X=tensor(s.X, device),
                             U_body=tensor(s.U_body, device))


def adv_diff_state(s, device="cuda") -> AdvDiffState:
    """An ``AdvDiffState``'s leaves (Q, n_prev, t, k)."""
    return AdvDiffState(Q=tuple(tensor(c, device) for c in s.Q),
                        n_prev=tuple(tensor(c, device) for c in s.n_prev),
                        t=tensor(s.t, device),
                        k=tensor(s.k, device, torch.int32))


def amr_state(s, device="cuda") -> AMRState:
    """An ``AMRState``'s leaves (Qc, Qf, the int32 window origin lo)."""
    return AMRState(Qc=tensor(s.Qc, device), Qf=tensor(s.Qf, device),
                    lo=tensor(s.lo, device, torch.int32))


def two_level_ins_state(s, device="cuda") -> TwoLevelINSState:
    """A ``TwoLevelINSState``'s leaves (uc, uf, t, k)."""
    return TwoLevelINSState(uc=tuple(tensor(c, device) for c in s.uc),
                            uf=tuple(tensor(c, device) for c in s.uf),
                            t=tensor(s.t, device),
                            k=tensor(s.k, device, torch.int32))


def two_level_ib_state(s, device="cuda") -> TwoLevelIBState:
    """A ``TwoLevelIBState``'s leaves (fluid, X, U, mask)."""
    return TwoLevelIBState(fluid=two_level_ins_state(s.fluid, device),
                           X=tensor(s.X, device), U=tensor(s.U, device),
                           mask=tensor(s.mask, device))


def fine_box(b) -> FineBox:
    """A ``FineBox`` (static host geometry: no device)."""
    return FineBox(lo=tuple(int(v) for v in b.lo),
                   shape=tuple(int(v) for v in b.shape), ratio=int(b.ratio))


def grid(g) -> StaggeredGrid:
    """A ``StaggeredGrid`` (static host geometry: no device)."""
    return StaggeredGrid(n=tuple(int(v) for v in g.n),
                         x_lo=tuple(float(v) for v in g.x_lo),
                         x_up=tuple(float(v) for v in g.x_up))


def level_specs(levels) -> list:
    """A ``build_hierarchy`` list of ``LevelSpec`` (static host geometry:
    no device)."""
    return [LevelSpec(box=None if spec.box is None else fine_box(spec.box),
                      grid=grid(spec.grid)) for spec in levels]


def multilevel_ins_state(s, device="cuda") -> MultiLevelINSState:
    """A ``MultiLevelINSState``'s leaves (the per-level MAC fields us, t,
    k)."""
    return MultiLevelINSState(
        us=tuple(tuple(tensor(c, device) for c in u) for u in s.us),
        t=tensor(s.t, device), k=tensor(s.k, device, torch.int32))


def multilevel_ib_state(s, device="cuda") -> MultiLevelIBState:
    """A ``MultiLevelIBState``'s leaves (fluid, X, U, mask)."""
    return MultiLevelIBState(fluid=multilevel_ins_state(s.fluid, device),
                             X=tensor(s.X, device), U=tensor(s.U, device),
                             mask=tensor(s.mask, device))


def multibox_state(s, device="cuda") -> MultiBoxState:
    """A ``MultiBoxState``'s leaves (Qc, the window pool Qf, the (K, dim)
    int32 origins lo)."""
    return MultiBoxState(Qc=tensor(s.Qc, device), Qf=tensor(s.Qf, device),
                         lo=tensor(s.lo, device, torch.int32))


def imp_state(s, device="cuda") -> IMPState:
    """An ``IMPState``'s leaves (ins, X, the deformation gradients F,
    mask)."""
    return IMPState(ins=ins_state(s.ins, device), X=tensor(s.X, device),
                    F=tensor(s.F, device), mask=tensor(s.mask, device))


def gib_state(s, device="cuda") -> GIBState:
    """A ``GIBState``'s leaves (ins, X, the director triads D)."""
    return GIBState(ins=ins_state(s.ins, device), X=tensor(s.X, device),
                    D=tensor(s.D, device))


def rod_specs(r, device="cuda") -> RodSpecs:
    """``RodSpecs`` (int64 edge indices, the moduli, ds, enabled)."""
    return RodSpecs(idx0=tensor(r.idx0, device, torch.int64),
                    idx1=tensor(r.idx1, device, torch.int64),
                    b=tensor(r.b, device), kappa=tensor(r.kappa, device),
                    s=tensor(r.s, device), ds=tensor(r.ds, device),
                    enabled=tensor(r.enabled, device))


def penalty_ib_state(s, device="cuda") -> PenaltyIBState:
    """A ``PenaltyIBState``'s leaves (ib, the mass points Y and their
    velocities V)."""
    return PenaltyIBState(ib=ib_state(s.ib, device), Y=tensor(s.Y, device),
                          V=tensor(s.V, device))


def meter_specs(m, device="cuda") -> MeterSpecs:
    """``MeterSpecs`` (int64 padded indices, valid, seg)."""
    return MeterSpecs(idx=tensor(m.idx, device, torch.int64),
                      valid=tensor(m.valid, device),
                      seg=tensor(m.seg, device))


def vc_ins_state(s, device="cuda") -> VCINSState:
    """A ``VCINSState``'s leaves (u, p, phi, n_prev, t; k as a host
    int)."""
    return VCINSState(u=tuple(tensor(c, device) for c in s.u),
                      p=tensor(s.p, device), phi=tensor(s.phi, device),
                      n_prev=tuple(tensor(c, device) for c in s.n_prev),
                      t=tensor(s.t, device), k=int(np.asarray(s.k)))


def vc_cons_state(s, device="cuda") -> VCConsState:
    """A ``VCConsState``'s leaves (u, p, phi, rho, t; k as a host int)."""
    return VCConsState(u=tuple(tensor(c, device) for c in s.u),
                       p=tensor(s.p, device), phi=tensor(s.phi, device),
                       rho=tensor(s.rho, device), t=tensor(s.t, device),
                       k=int(np.asarray(s.k)))


def collocated_ins_state(s, device="cuda") -> CollocatedINSState:
    """A ``CollocatedINSState``'s leaves (u, p, n_prev, t; k as a host
    int)."""
    return CollocatedINSState(
        u=tuple(tensor(c, device) for c in s.u), p=tensor(s.p, device),
        n_prev=tuple(tensor(c, device) for c in s.n_prev),
        t=tensor(s.t, device), k=int(np.asarray(s.k)))


def komega_state(s, device="cuda") -> KOmegaState:
    """A ``KOmegaState``'s leaves (k, omega)."""
    return KOmegaState(k=tensor(s.k, device), omega=tensor(s.omega, device))


def rigid_body_state(s, device="cuda") -> RigidBodyState:
    """A Brinkman ``RigidBodyState``'s leaves (center, U, theta, omega)."""
    return RigidBodyState(center=tensor(s.center, device),
                          U=tensor(s.U, device),
                          theta=tensor(s.theta, device),
                          omega=tensor(s.omega, device))


def conformation(C, device="cuda") -> torch.Tensor:
    """An Oldroyd-B conformation field (..., nc)."""
    return tensor(C, device)
