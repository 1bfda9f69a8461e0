"""Kirchhoff rod mechanics: director frames, discrete strains, forces and
torques (port of ``ibamr_tpu/ops/rods.py``; Lim, Ferent, Wang and
Peskin's generalized IB rods).

Edge e between nodes i and i+1 with rest spacing ds:
  edge frame   D^e = the sqrt-rotation midpoint of D_i and D_{i+1};
  curvature and twist (cyclic)  Omega_1 = (dD2/ds) . D3^e,
     Omega_2 = (dD3/ds) . D1^e,  Omega_3 = (dD1/ds) . D2^e;
  stretch and shear  Gamma = (D^e)^T (X_{i+1} - X_i)/ds - e3;
  energy  E = sum_e ds [1/2 b_k (Omega_k - kappa_k)^2 + 1/2 s_k Gamma_k^2].

Force and torque are gradients of the discrete energy (PyTorch autograd):
F_i = -dE/dX_i and N_i = -sum_rows d_row x dE/dd_row (the rotational
gradient), so they are consistent with the energy by construction.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.device import resolve_device


class RodSpecs(NamedTuple):
    """M rod edges between consecutive node indices idx0[m] -> idx1[m]:
    b (M, 3) bending/twist moduli, kappa (M, 3) intrinsic curvature and
    twist, s (M, 3) shear/stretch moduli, ds (M,) rest spacing, enabled
    (M,) 0/1."""
    idx0: torch.Tensor
    idx1: torch.Tensor
    b: torch.Tensor
    kappa: torch.Tensor
    s: torch.Tensor
    ds: torch.Tensor
    enabled: torch.Tensor


def make_rods(idx0, idx1, b, kappa, s, ds, dtype=torch.float32,
              device="cuda") -> RodSpecs:
    dev = resolve_device(device)
    idx0 = torch.as_tensor(np.asarray(idx0), dtype=torch.int64, device=dev)
    M = idx0.shape[0]

    def arr3(v):
        v = torch.as_tensor(np.asarray(v), dtype=dtype, device=dev)
        return v.expand(M, 3).clone() if v.ndim <= 1 else v

    return RodSpecs(
        idx0=idx0,
        idx1=torch.as_tensor(np.asarray(idx1), dtype=torch.int64,
                             device=dev),
        b=arr3(b), kappa=arr3(kappa), s=arr3(s),
        ds=torch.as_tensor(np.asarray(ds), dtype=dtype,
                           device=dev).expand(M).clone(),
        enabled=torch.ones((M,), dtype=dtype, device=dev))


def _quat_from_rot(R: torch.Tensor) -> torch.Tensor:
    """Unit quaternion (w, x, y, z) of rotations by less than pi (always
    so for adjacent rod frames); smooth at the identity."""
    tr = R[..., 0, 0] + R[..., 1, 1] + R[..., 2, 2]
    w = 0.5 * torch.sqrt(torch.clamp(1.0 + tr, min=1e-12))
    s = 1.0 / (4.0 * w)
    return torch.stack([
        w,
        (R[..., 2, 1] - R[..., 1, 2]) * s,
        (R[..., 0, 2] - R[..., 2, 0]) * s,
        (R[..., 1, 0] - R[..., 0, 1]) * s], dim=-1)


def _rot_from_quat(q: torch.Tensor) -> torch.Tensor:
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                     2 * (x * z + w * y)], dim=-1),
        torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                     2 * (y * z - w * x)], dim=-1),
        torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                     1 - 2 * (x * x + y * y)], dim=-1)], dim=-2)


def edge_frames(D: torch.Tensor, specs: RodSpecs) -> torch.Tensor:
    """The sqrt-rotation midpoint frame of every edge,
    D^e = sqrt(D_b D_a^T) D_a -> (M, 3, 3); the quaternion square root is
    normalize(q + identity)."""
    Da = D[specs.idx0]
    Db = D[specs.idx1]
    # rows are directors: the rotation taking frame a to frame b is
    # R = sum_k d_b,k d_a,k^T
    R = torch.einsum("mki,mkj->mij", Db, Da)
    q = _quat_from_rot(R)
    qh = q + torch.tensor([1.0, 0.0, 0.0, 0.0], dtype=q.dtype,
                          device=q.device)
    qh = qh / torch.linalg.vector_norm(qh, dim=-1, keepdim=True)
    return torch.einsum("mij,mkj->mki", _rot_from_quat(qh), Da)


def rod_strains(X: torch.Tensor, D: torch.Tensor,
                specs: RodSpecs) -> Tuple[torch.Tensor, torch.Tensor]:
    """(Omega, Gamma) per edge -> ((M, 3), (M, 3))."""
    De = edge_frames(D, specs)
    Da = D[specs.idx0]
    Db = D[specs.idx1]
    dDds = (Db - Da) / specs.ds[:, None, None]
    # cyclic: Omega_k = (dD_{k+1}/ds) . D_{k+2}^e
    Om = torch.stack([
        torch.einsum("mi,mi->m", dDds[:, 1], De[:, 2]),
        torch.einsum("mi,mi->m", dDds[:, 2], De[:, 0]),
        torch.einsum("mi,mi->m", dDds[:, 0], De[:, 1])], dim=-1)
    t = (X[specs.idx1] - X[specs.idx0]) / specs.ds[:, None]
    Gam = torch.einsum("mki,mi->mk", De, t)
    Gam = Gam - torch.tensor([0.0, 0.0, 1.0], dtype=Gam.dtype,
                             device=Gam.device)
    return Om, Gam


def rod_energy(X: torch.Tensor, D: torch.Tensor,
               specs: RodSpecs) -> torch.Tensor:
    """Total elastic energy of the rod network."""
    Om, Gam = rod_strains(X, D, specs)
    e_bend = 0.5 * torch.sum(specs.b * (Om - specs.kappa) ** 2, dim=-1)
    e_shear = 0.5 * torch.sum(specs.s * Gam ** 2, dim=-1)
    return torch.sum(specs.enabled * specs.ds * (e_bend + e_shear))


def rod_force_torque(X: torch.Tensor, D: torch.Tensor, specs: RodSpecs
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Nodal forces (n, 3) and torques (n, 3): minus the gradients of the
    discrete energy (autograd on detached leaves, so callers under
    ``torch.no_grad`` get them too), the torque by the rotational
    gradient N_i = -sum_rows d_row x dE/dd_row."""
    with torch.enable_grad():
        Xl = X.detach().requires_grad_(True)
        Dl = D.detach().requires_grad_(True)
        gX, gD = torch.autograd.grad(rod_energy(Xl, Dl, specs), (Xl, Dl))
    return -gX, -torch.sum(torch.linalg.cross(D, gD, dim=-1), dim=1)


def rodrigues(w: torch.Tensor) -> torch.Tensor:
    """Rotation matrices exp([w]_x) of rotation vectors w (..., 3), with
    the Taylor series below an angle of 1e-8 (safe under autograd)."""
    theta = torch.linalg.vector_norm(w, dim=-1, keepdim=True)
    small = theta < 1e-8
    th = torch.where(small, torch.ones_like(theta), theta)
    a = torch.where(small, 1.0 - theta ** 2 / 6.0, torch.sin(th) / th)
    b = torch.where(small, 0.5 - theta ** 2 / 24.0,
                    (1.0 - torch.cos(th)) / th ** 2)
    wx, wy, wz = w[..., 0], w[..., 1], w[..., 2]
    zeros = torch.zeros_like(wx)
    K = torch.stack([
        torch.stack([zeros, -wz, wy], dim=-1),
        torch.stack([wz, zeros, -wx], dim=-1),
        torch.stack([-wy, wx, zeros], dim=-1)], dim=-2)
    eye = torch.eye(3, dtype=w.dtype, device=w.device)
    return (eye + a[..., None] * K
            + b[..., None] * torch.einsum("...ij,...jk->...ik", K, K))


def rotate_frames(D: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Director triads rotated by rotation vectors w: rows d_k ->
    R(w) d_k."""
    return torch.einsum("...ij,...kj->...ki", rodrigues(w), D)


def straight_rod(n: int, length: float, origin=(0.0, 0.0, 0.0),
                 axis=(0.0, 0.0, 1.0), dtype=torch.float32, device="cuda"
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(X, D) of a straight rod with D3 along the axis."""
    a = np.asarray(axis, dtype=np.float64)
    a = a / np.linalg.norm(a)
    t = np.linspace(0.0, length, n)
    X = np.asarray(origin)[None, :] + t[:, None] * a[None, :]
    tmp = np.array([1.0, 0.0, 0.0])
    if abs(np.dot(tmp, a)) > 0.9:
        tmp = np.array([0.0, 1.0, 0.0])
    d1 = np.cross(tmp, a)
    d1 = d1 / np.linalg.norm(d1)
    d2 = np.cross(a, d1)
    D = np.broadcast_to(np.stack([d1, d2, a], axis=0), (n, 3, 3))
    dev = resolve_device(device)
    return (torch.as_tensor(X, dtype=dtype, device=dev),
            torch.as_tensor(D.copy(), dtype=dtype, device=dev))
