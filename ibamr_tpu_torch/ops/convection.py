"""Convective operator N(u) on the MAC grid (port of
``ibamr_tpu/ops/convection.py``).

Conservative form ``N(u)_d = sum_e d/dx_e (u_e u_d)`` at ``u_d``'s own
faces. Two paths, as in the reference:

- :func:`convective_rate`: the fully periodic roll form, centered or
  donor-cell upwind face values;
- :func:`convective_rate_bc`: the ghost-padded form for every scheme
  (centered, upwind, PPM, CUI) and no-slip walls on any subset of axes,
  with moving tangential walls (lids). Wall storage follows
  ``integrators/ins_walls.py``: the wall-normal component pins slot 0
  along its own axis to the lo wall face, so its ghosts are odd
  reflections about the wall node; tangential components are
  cell-centered along the wall axis, and their ghosts reflect about the
  wall plane (``ghost = 2 V_wall - interior``).
"""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.ops import stencils

Vel = Tuple[torch.Tensor, ...]

# ghost depth of the padded path: PPM face states reach 3 cells out
_G = 3
# reach of N(u) at a face along any axis, per scheme: the ghost width a
# block of the block-resident sharded step needs (parallel/spmd.py's
# halo_apply); CUI's far neighbours reach 2 cells, PPM's limited slopes 3
GHOST_WIDTH = {"centered": 1, "upwind": 1, "cui": 2, "ppm": 3}


def _avg_m(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Backward 2-point average: value at i-1/2 from i-1, i."""
    return 0.5 * (f + torch.roll(f, 1, axis))


def _avg_p(f: torch.Tensor, axis: int) -> torch.Tensor:
    """Forward 2-point average: value at i+1/2 from i, i+1."""
    return 0.5 * (f + torch.roll(f, -1, axis))


def _upwind_m(f: torch.Tensor, vel: torch.Tensor, axis: int) -> torch.Tensor:
    """Donor-cell value at i-1/2 given the advecting velocity there."""
    return torch.where(vel >= 0, torch.roll(f, 1, axis), f)


def _upwind_p(f: torch.Tensor, vel: torch.Tensor, axis: int) -> torch.Tensor:
    """Donor-cell value at i+1/2 given the advecting velocity there."""
    return torch.where(vel >= 0, f, torch.roll(f, -1, axis))


def _cui_face(U: torch.Tensor, C: torch.Tensor,
              D: torch.Tensor) -> torch.Tensor:
    """CUI face value from (far-upwind, upwind, downwind) cell states:
    cubic upwind interpolation limited by the convection-boundedness
    criterion in normalized-variable form (``3 phi`` on (0, 1/6],
    ``3/4 phi + 3/8`` up to 5/6, 1 on [5/6, 1), donor cell outside
    (0, 1))."""
    den = D - U
    nz = torch.abs(den) > 0.0
    ph = (C - U) / torch.where(nz, den, torch.ones_like(den))
    f_hat = torch.where(
        ph < 1.0 / 6.0, 3.0 * ph,
        torch.where(ph <= 5.0 / 6.0, 0.75 * ph + 0.375,
                    torch.ones_like(ph)))
    f_hat = torch.where((ph > 0.0) & (ph < 1.0), f_hat, ph)
    return torch.where(nz, U + f_hat * den, C)


def advective_face_value(Qm: torch.Tensor, Qp: torch.Tensor,
                         vel: torch.Tensor, scheme: str,
                         Qmm: Optional[torch.Tensor] = None,
                         Qpp: Optional[torch.Tensor] = None
                         ) -> torch.Tensor:
    """Face value of an advected scalar from its two neighbor cells (Qm
    below the face, Qp above) and the face-normal velocity; ``"cui"``
    also needs the far neighbors Qmm (below Qm) and Qpp (above Qp)."""
    if scheme == "centered":
        return 0.5 * (Qm + Qp)
    if scheme == "upwind":
        return torch.where(vel > 0, Qm, Qp)
    if scheme == "cui":
        if Qmm is None or Qpp is None:
            raise ValueError("cui needs the far-neighbor states Qmm/Qpp")
        up = _cui_face(Qmm, Qm, Qp)
        dn = _cui_face(Qpp, Qp, Qm)
        return torch.where(vel > 0, up,
                           torch.where(vel < 0, dn, 0.5 * (up + dn)))
    raise ValueError(f"unknown convective scheme {scheme!r}")


def convective_rate(u: Vel, dx: Sequence[float],
                    scheme: str = "centered") -> Vel:
    """N(u)_d = sum_e d/dx_e(u_e u_d), each component at its own faces."""
    if scheme not in ("centered", "upwind"):
        raise ValueError(f"unknown convective scheme {scheme!r}")
    dim = len(u)
    out = []
    for d in range(dim):
        acc = torch.zeros_like(u[d])
        for e in range(dim):
            if e == d:
                # flux at cell centers along d
                adv = _avg_p(u[d], d)
                q = _upwind_p(u[d], adv, d) if scheme == "upwind" else adv
                flux = adv * q
                acc = acc + (flux - torch.roll(flux, 1, d)) / dx[d]
            else:
                # flux at the d-e edges: u_e averaged along d, u_d
                # averaged (or upwinded) along e
                adv = _avg_m(u[e], d)
                q = (_upwind_m(u[d], adv, e) if scheme == "upwind"
                     else _avg_m(u[d], e))
                flux = adv * q
                acc = acc + (torch.roll(flux, -1, e) - flux) / dx[e]
        out.append(acc)
    return tuple(out)


# -- ghost-padded path: walls, PPM and CUI -----------------------------------------

_take = stencils.axis_slice


def _pad_wrap(a: torch.Tensor, axis: int, g: int) -> torch.Tensor:
    n = a.shape[axis]
    return torch.cat([_take(a, axis, n - g, n), a, _take(a, axis, 0, g)],
                     dim=axis)


def _pad_cell_wall(a: torch.Tensor, axis: int, g: int, v_lo: float = 0.0,
                   v_hi: float = 0.0) -> torch.Tensor:
    """Ghosts of data at cell centers along a wall axis: odd reflection
    about the wall plane through the Dirichlet value
    (``ghost[-1-k] = 2 v_lo - a[k]``)."""
    n = a.shape[axis]
    lo = 2.0 * v_lo - torch.flip(_take(a, axis, 0, g), (axis,))
    hi = 2.0 * v_hi - torch.flip(_take(a, axis, n - g, n), (axis,))
    return torch.cat([lo, a, hi], dim=axis)


def _pad_face_pinned_wall(a: torch.Tensor, axis: int,
                          g: int) -> torch.Tensor:
    """Ghosts of data at faces along its own wall axis (pinned storage):
    odd reflection about the wall nodes, ``a[-k] = -a[k]``, ``a[n] = 0``,
    ``a[n+k] = -a[n-k]``."""
    n = a.shape[axis]
    lo = -torch.flip(_take(a, axis, 1, g + 1), (axis,))
    zero = torch.zeros_like(_take(a, axis, 0, 1))
    hi = torch.cat(
        [zero, -torch.flip(_take(a, axis, n - (g - 1), n), (axis,))],
        dim=axis)
    return torch.cat([lo, a, hi], dim=axis)


def _sh(ap: torch.Tensor, axis: int, s: int, n: int,
        g: int) -> torch.Tensor:
    """Shifted view of a g-padded array: the value at index i+s, i in
    [0, n)."""
    return _take(ap, axis, g + s, g + s + n)


def _ppm_states(ap: torch.Tensor, axis: int, n: int, g: int):
    """CW84 limited parabola edge states over the extended cell range
    [-1, n] (length n+2 along ``axis``): returns (aL, aR), the
    monotonized lower/upper-face states of each 1D cell."""
    def ext(s):
        return _take(ap, axis, g - 1 + s, g + 1 + s + n)

    a, am, ap1 = ext(0), ext(-1), ext(1)
    am2, ap2 = ext(-2), ext(2)

    def mc_slope(c, m, p):
        d = 0.5 * (p - m)
        mono = (p - c) * (c - m) > 0.0
        lim = torch.minimum(torch.abs(d), 2.0 * torch.minimum(
            torch.abs(p - c), torch.abs(c - m)))
        return torch.where(mono, torch.sign(d) * lim, torch.zeros_like(d))

    s0 = mc_slope(a, am, ap1)
    sm = mc_slope(am, am2, a)
    sp = mc_slope(ap1, a, ap2)
    # 4th-order face interpolants with the limited-slope correction
    fL = am + 0.5 * (a - am) - (1.0 / 6.0) * (s0 - sm)
    fR = a + 0.5 * (ap1 - a) - (1.0 / 6.0) * (sp - s0)
    # monotonize the parabola
    local_ext = (fR - a) * (a - fL) <= 0.0
    aL = torch.where(local_ext, a, fL)
    aR = torch.where(local_ext, a, fR)
    diff = aR - aL
    q6 = diff * (a - 0.5 * (aL + aR))
    d2 = diff * diff / 6.0
    aL = torch.where(q6 > d2, 3.0 * a - 2.0 * aR, aL)
    aR = torch.where(q6 < -d2, 3.0 * a - 2.0 * aL, aR)
    return aL, aR


def _face_value_padded(ap: torch.Tensor, adv: torch.Tensor, axis: int,
                       n: int, g: int, scheme: str,
                       shift: int) -> torch.Tensor:
    """Advected value at the 1D faces ``i + shift - 1/2`` from the
    g-padded cell data ``ap`` and the face-normal velocity ``adv``."""
    qm = _sh(ap, axis, shift - 1, n, g)
    qp = _sh(ap, axis, shift, n, g)
    if scheme == "centered":
        return 0.5 * (qm + qp)
    if scheme == "upwind":
        return torch.where(adv >= 0.0, qm, qp)
    if scheme == "ppm":
        aL, aR = _ppm_states(ap, axis, n, g)
        up = _take(aR, axis, shift, shift + n)
        dn = _take(aL, axis, shift + 1, shift + 1 + n)
        return torch.where(adv > 0.0, up,
                           torch.where(adv < 0.0, dn, 0.5 * (up + dn)))
    if scheme == "cui":
        qmm = _sh(ap, axis, shift - 2, n, g)
        qpp = _sh(ap, axis, shift + 1, n, g)
        up = _cui_face(qmm, qm, qp)
        dn = _cui_face(qpp, qp, qm)
        return torch.where(adv > 0.0, up,
                           torch.where(adv < 0.0, dn, 0.5 * (up + dn)))
    raise ValueError(f"unknown convective scheme {scheme!r}")


def _pin_wall_faces(a: torch.Tensor, axis: int) -> torch.Tensor:
    a = a.clone()
    idx = [slice(None)] * a.ndim
    idx[axis] = slice(0, 1)
    a[tuple(idx)] = 0.0
    return a


def convective_rate_bc(
        u: Vel, dx: Sequence[float], scheme: str = "ppm",
        wall_axes: Optional[Sequence[bool]] = None,
        wall_tangential: Optional[Dict[Tuple[int, int, int], float]] = None,
) -> Vel:
    """N(u)_d = sum_e d/dx_e(u_e u_d) with BC-aware ghost fills.

    ``wall_axes[e]`` puts no-slip walls on both sides of axis e; the
    other axes are periodic. ``wall_tangential[(d, e, side)]`` is the
    tangential velocity of component d on the side (0 = lo, 1 = hi) wall
    of axis e (a moving lid); unset entries are 0. The wall-normal output
    faces (pinned slots) are zeroed."""
    dim = len(u)
    if wall_axes is None:
        wall_axes = (False,) * dim
    tang = wall_tangential or {}
    g = _G
    out = []
    for d in range(dim):
        acc = torch.zeros_like(u[d])
        n_d = u[d].shape
        for e in range(dim):
            n_e = n_d[e]
            if e == d:
                # 1D cells = the faces of u_d along d; fluxes at cell
                # centers (the 1D upper faces, shift=1)
                ud_p = (_pad_face_pinned_wall(u[d], d, g) if wall_axes[d]
                        else _pad_wrap(u[d], d, g))
                adv = 0.5 * (_sh(ud_p, d, 0, n_e, g)
                             + _sh(ud_p, d, 1, n_e, g))
                q = _face_value_padded(ud_p, adv, d, n_e, g, scheme,
                                       shift=1)
                flux = adv * q
                acc = acc + (flux - torch.roll(flux, 1, d)) / dx[d]
            else:
                # fluxes at the d-e edges: the advecting u_e averaged
                # along d (its wall value on axis d is its tangential
                # datum there), the advected u_d along e
                if wall_axes[d]:
                    ue_p = _pad_cell_wall(u[e], d, 1,
                                          v_lo=tang.get((e, d, 0), 0.0),
                                          v_hi=tang.get((e, d, 1), 0.0))
                else:
                    ue_p = _pad_wrap(u[e], d, 1)
                adv = 0.5 * (_sh(ue_p, d, -1, n_d[d], 1)
                             + _sh(ue_p, d, 0, n_d[d], 1))
                if wall_axes[e]:
                    ud_p = _pad_cell_wall(u[d], e, g,
                                          v_lo=tang.get((d, e, 0), 0.0),
                                          v_hi=tang.get((d, e, 1), 0.0))
                else:
                    ud_p = _pad_wrap(u[d], e, g)
                q = _face_value_padded(ud_p, adv, e, n_e, g, scheme,
                                       shift=0)
                flux = adv * q
                acc = acc + (torch.roll(flux, -1, e) - flux) / dx[e]
        if wall_axes[d]:
            acc = _pin_wall_faces(acc, d)
        out.append(acc)
    return tuple(out)
