"""Codim-1 FE structures: membranes and shells (port of
``ibamr_tpu/fe/surface.py``, the IBFESurfaceMethod half of IBFE).

EDGE2 curves in 2D and TRI3 facets in 3D carry in-plane membrane
elasticity evaluated from the surface deformation: with current
tangents ``t_i = sum_a dN_a/dxi_i x_a``, ``C_ij = t_i . t_j`` and the
reference metric ``G``, the mixed strain is ``M = G^{-1} C`` (identity
under rigid motion) and the total energy ``E(x) = sum_e sum_q wdA_eq
W_s(M_eq)``; the nodal force is ``-dE/dx`` by autograd, as in
:mod:`ibamr_tpu_torch.fe.fem`. The reference tables are host NumPy.

``neo_hookean_membrane``: W_s = mu/2 (tr M - rdim - ln det M)
+ kappa/2 (sqrt(det M) - 1)^2.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.fe.fem import det, hrz_lumped_mass, neg_grad, trace


class SurfaceMesh(NamedTuple):
    """Codim-1 mesh: EDGE2 (2D ambient) or TRI3 facets (3D ambient)."""
    nodes: np.ndarray      # (n_nodes, dim)
    elems: np.ndarray      # (E, nen): nen=2 (EDGE2) or 3 (TRI3)
    elem_type: str         # "EDGE2" | "TRI3S"

    @property
    def dim(self) -> int:
        return self.nodes.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]


def _surf_shape_table(elem_type: str):
    if elem_type == "EDGE2":
        g = 1.0 / math.sqrt(3.0)
        qp = np.array([[(1.0 - g) / 2.0], [(1.0 + g) / 2.0]])
        qw = np.array([0.5, 0.5])
        N = np.stack([1.0 - qp[:, 0], qp[:, 0]], axis=1)
        dN = np.broadcast_to(np.array([[-1.0], [1.0]]),
                             (2, 2, 1)).copy()
    elif elem_type == "TRI3S":
        qp = np.array([[1 / 6, 1 / 6], [2 / 3, 1 / 6], [1 / 6, 2 / 3]])
        qw = np.array([1 / 6, 1 / 6, 1 / 6])
        N = np.stack([1.0 - qp[:, 0] - qp[:, 1], qp[:, 0], qp[:, 1]],
                     axis=1)
        dN = np.broadcast_to(
            np.array([[-1.0, -1.0], [1.0, 0.0], [0.0, 1.0]]),
            (3, 3, 2)).copy()
    else:
        raise ValueError(f"unknown surface element {elem_type!r}")
    return N, dN, qw


class SurfaceAssembly(NamedTuple):
    elems: torch.Tensor       # (E, nen) int64
    shape: torch.Tensor       # (nq, nen)
    dN: torch.Tensor          # (nq, nen, rdim) parametric gradients
    Ginv: torch.Tensor        # (E, nq, rdim, rdim) reference metric inverse
    wdA: torch.Tensor         # (E, nq) reference area measure * weight
    lumped_mass: torch.Tensor  # (n_nodes,) HRZ-lumped surface mass
    n_nodes: int
    dim: int                  # ambient dimension
    rdim: int                 # reference (surface) dimension


def build_surface_assembly(mesh: SurfaceMesh, dtype=torch.float32,
                           device="cuda") -> SurfaceAssembly:
    N, dN, qw = _surf_shape_table(mesh.elem_type)
    rdim = dN.shape[2]
    Xe = mesh.nodes[mesh.elems]                      # (E, nen, dim)
    T = np.einsum("qar,eai->eqir", dN, Xe)           # (E, nq, dim, rdim)
    G = np.einsum("eqir,eqis->eqrs", T, T)           # reference metric
    wdA = np.sqrt(np.abs(np.linalg.det(G))) * qw[None, :]
    Ginv = np.linalg.inv(G)
    mass = hrz_lumped_mass(mesh.elems, N, wdA, mesh.n_nodes)
    dev = resolve_device(device)
    kw = dict(dtype=dtype, device=dev)
    return SurfaceAssembly(
        elems=torch.as_tensor(np.asarray(mesh.elems), dtype=torch.int64,
                              device=dev),
        shape=torch.as_tensor(N, **kw), dN=torch.as_tensor(dN, **kw),
        Ginv=torch.as_tensor(Ginv, **kw), wdA=torch.as_tensor(wdA, **kw),
        lumped_mass=torch.as_tensor(mass, **kw),
        n_nodes=mesh.n_nodes, dim=mesh.dim, rdim=rdim)


def surface_strain(asm: SurfaceAssembly, x: torch.Tensor) -> torch.Tensor:
    """Mixed Cauchy--Green strain M = G_ref^{-1} C(x) at every surface
    quadrature point -> (E, nq, rdim, rdim); M == I under rigid motion."""
    T = torch.einsum("qar,eai->eqir", asm.dN, x[asm.elems])
    C = torch.einsum("eqir,eqis->eqrs", T, T)
    return torch.einsum("eqrt,eqts->eqrs", asm.Ginv, C)


def _det_trace(M: torch.Tensor):
    if M.shape[-1] > 1:
        return det(M), trace(M)
    return M[..., 0, 0], M[..., 0, 0]


def neo_hookean_membrane(mu: float, kappa: float) -> Callable:
    """W_s(M) = mu/2 (tr M - rdim - ln det M) + kappa/2 (J_s - 1)^2,
    J_s = sqrt(det M) (relative area/length change)."""
    def W(M):
        rdim = M.shape[-1]
        detM, trM = _det_trace(M)
        Js = torch.sqrt(torch.clamp_min(detM, 1e-12))
        return (0.5 * mu * (trM - rdim
                            - torch.log(torch.clamp_min(detM, 1e-12)))
                + 0.5 * kappa * (Js - 1.0) ** 2)
    return W


def membrane_energy(asm: SurfaceAssembly, W: Callable, x: torch.Tensor):
    return torch.sum(W(surface_strain(asm, x)) * asm.wdA)


def membrane_forces(asm: SurfaceAssembly, W: Callable,
                    x: torch.Tensor) -> torch.Tensor:
    """Weak-form nodal membrane force -dE/dx -> (n_nodes, dim)."""
    return neg_grad(lambda xx: membrane_energy(asm, W, xx), x)


def surface_quad_positions(asm: SurfaceAssembly,
                           x: torch.Tensor) -> torch.Tensor:
    xq = torch.einsum("qa,eai->eqi", asm.shape, x[asm.elems])
    return xq.reshape(-1, asm.dim)


def current_area(asm: SurfaceAssembly, x: torch.Tensor) -> torch.Tensor:
    """Deformed surface measure (perimeter in 2D, area in 3D)."""
    detM, _ = _det_trace(surface_strain(asm, x))
    return torch.sum(torch.sqrt(torch.clamp_min(detM, 0.0)) * asm.wdA)


# -- mesh builders -----------------------------------------------------------

def surface_mesh_from_fe(mesh) -> SurfaceMesh:
    """Adopt a codim-1 :class:`~ibamr_tpu_torch.fe.mesh.FEMesh` — e.g. a
    Gmsh-loaded TRI3 shell embedded in 3D (``read_gmsh`` keeps all
    three coordinate columns for such meshes) or an EDGE2 curve — as a
    :class:`SurfaceMesh` for the codim-1 IBFE machinery. Higher-order
    surface families (TRI6) are adopted by their corner nodes."""
    et, nodes, elems = mesh.elem_type, mesh.nodes, mesh.elems
    if et in ("TRI3", "TRI6") and nodes.shape[1] == 3:
        corners, out_type = elems[:, :3], "TRI3S"
    elif et == "EDGE2" and nodes.shape[1] == 2:
        corners, out_type = elems[:, :2], "EDGE2"
    else:
        raise ValueError(
            f"not a codim-1 configuration: {et} with "
            f"{nodes.shape[1]}-column nodes (need TRI3/TRI6 in 3D or "
            "EDGE2 in 2D)")
    # corner-only adoption can orphan nodes (TRI6 midsides): drop and
    # remap densely so no inert markers ride along in the IB coupling
    used = np.unique(corners)
    remap = -np.ones(nodes.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    return SurfaceMesh(nodes=np.asarray(nodes[used], dtype=float),
                       elems=np.asarray(remap[corners],
                                        dtype=np.int64),
                       elem_type=out_type)


def ring_mesh(center=(0.5, 0.5), radius: float = 0.25, n: int = 64,
              aspect: float = 1.0) -> SurfaceMesh:
    """Closed EDGE2 ring (optionally elliptic: semi-axes r*aspect, r)."""
    th = 2.0 * np.pi * np.arange(n) / n
    nodes = np.stack([center[0] + radius * aspect * np.cos(th),
                      center[1] + radius * np.sin(th)], axis=1)
    elems = np.stack([np.arange(n), (np.arange(n) + 1) % n], axis=1)
    return SurfaceMesh(nodes=nodes, elems=elems.astype(np.int64),
                       elem_type="EDGE2")


def sphere_surface_mesh(center=(0.5, 0.5, 0.5), radius: float = 0.25,
                        n_subdiv: int = 2) -> SurfaceMesh:
    """Geodesic TRI3 sphere: subdivided octahedron projected to the
    sphere (watertight, near-uniform facets)."""
    verts = np.array([[1, 0, 0], [-1, 0, 0], [0, 1, 0],
                      [0, -1, 0], [0, 0, 1], [0, 0, -1]], dtype=float)
    faces = [(0, 2, 4), (2, 1, 4), (1, 3, 4), (3, 0, 4),
             (2, 0, 5), (1, 2, 5), (3, 1, 5), (0, 3, 5)]
    verts = [v for v in verts]
    for _ in range(n_subdiv):
        new_faces = []
        midcache = {}

        def mid(i, j):
            key = (min(i, j), max(i, j))
            if key not in midcache:
                m = verts[i] + verts[j]
                m = m / np.linalg.norm(m)
                midcache[key] = len(verts)
                verts.append(m)
            return midcache[key]

        for (a, b, c) in faces:
            ab, bc, ca = mid(a, b), mid(b, c), mid(c, a)
            new_faces += [(a, ab, ca), (b, bc, ab), (c, ca, bc),
                          (ab, bc, ca)]
        faces = new_faces
    nodes = np.asarray(verts) * radius + np.asarray(center)
    return SurfaceMesh(nodes=nodes,
                       elems=np.asarray(faces, dtype=np.int64),
                       elem_type="TRI3S")
