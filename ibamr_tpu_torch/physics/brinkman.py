"""Brinkman penalization: porous and rigid obstacles as a volume penalty
(port of ``ibamr_tpu/physics/brinkman.py``).

A body is an indicator chi on the fluid grid with permeability eta;
inside it the momentum equation gains -(chi/eta)(u - u_b). The penalty
is a pointwise diagonal implicit split step

    u  <-  (u + (dt chi/eta) u_b) / (1 + dt chi/eta),

then one extra projection restores div u = 0. Free bodies advance by
Newton-Euler with the hydrodynamic force measured as the momentum the
penalty removes from the fluid. Bodies are analytic signed-distance
functions evaluated at the body's current center and orientation.
"""

from __future__ import annotations

import math
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.physics.level_set import heaviside

Vel = Tuple[torch.Tensor, ...]


def face_coords(grid: StaggeredGrid, d: int, dtype=torch.float32,
                device="cuda") -> Tuple[torch.Tensor, ...]:
    """Broadcastable coordinates of component-d face centers."""
    return grid.face_centers(d, dtype, resolve_device(device))


class RigidBodyState(NamedTuple):
    """Dynamic state of one penalized rigid body."""
    center: torch.Tensor   # (dim,)
    U: torch.Tensor        # (dim,) translational velocity
    theta: torch.Tensor    # scalar orientation (2D); 0 if unused
    omega: torch.Tensor    # scalar angular velocity (2D); 0 if unused


class BrinkmanBody:
    """One penalized body: an analytic SDF (negative inside) evaluated in
    the BODY frame, plus permeability and, for free bodies, inertia.
    ``sdf(x_body) -> phi`` gets coordinates translated (and in 2D
    rotated) into the body frame."""

    def __init__(self, sdf: Callable[[Sequence[torch.Tensor]], torch.Tensor],
                 eta: float = 1e-3, smear_cells: float = 1.0,
                 density: Optional[float] = None,
                 volume: Optional[float] = None,
                 moment: Optional[float] = None):
        self.sdf = sdf
        self.eta = float(eta)
        self.smear_cells = float(smear_cells)
        self.density = density      # None -> prescribed-motion body
        self.volume = volume
        self.moment = moment

    def chi(self, grid: StaggeredGrid, d: int,
            st: RigidBodyState) -> torch.Tensor:
        """Indicator (smoothed Heaviside of -sdf) on the d-faces."""
        xs = face_coords(grid, d, st.center.dtype, st.center.device)
        xb = [x - st.center[a] for a, x in enumerate(xs)]
        if grid.dim == 2:
            c, s = torch.cos(-st.theta), torch.sin(-st.theta)
            xb = [c * xb[0] - s * xb[1], s * xb[0] + c * xb[1]]
        phi = self.sdf(xb)
        eps = self.smear_cells * max(grid.dx)
        return 1.0 - heaviside(phi, eps)

    def body_velocity(self, grid: StaggeredGrid, d: int,
                      st: RigidBodyState) -> torch.Tensor:
        """Rigid velocity of the body material at the d-faces."""
        xs = face_coords(grid, d, st.center.dtype, st.center.device)
        v = torch.full_like(xs[0], 0.0) + st.U[d]
        if grid.dim == 2:
            r = (xs[0] - st.center[0], xs[1] - st.center[1])
            v = v + (-st.omega * r[1] if d == 0 else st.omega * r[0])
        return v


def penalize(u: Vel, grid: StaggeredGrid, dt: float,
             bodies: Sequence[BrinkmanBody],
             states: Sequence[RigidBodyState]) -> Tuple[Vel, list]:
    """Diagonal implicit penalty update; returns the new velocity and,
    per body, the momentum and angular impulse the fluid LOST to it
    (the force and torque on the body are +impulse/dt)."""
    dim = grid.dim
    unew = list(u)
    impulses = []
    vol = math.prod(grid.dx)
    for body, st in zip(bodies, states):
        dP = []
        torque_impulse = torch.zeros((), dtype=u[0].dtype,
                                     device=u[0].device)
        for d in range(dim):
            chi = body.chi(grid, d, st)
            ub = body.body_velocity(grid, d, st)
            a = dt * chi / body.eta
            before = unew[d]
            after = (before + a * ub) / (1.0 + a)
            unew[d] = after
            dP.append(torch.sum(before - after) * vol)
            if dim == 2:
                xs = face_coords(grid, d, st.center.dtype, st.center.device)
                r = (xs[0] - st.center[0], xs[1] - st.center[1])
                arm = -r[1] if d == 0 else r[0]
                torque_impulse = torque_impulse + torch.sum(
                    arm * (before - after)) * vol
        impulses.append((torch.stack(dP), torque_impulse))
    return tuple(unew), impulses


class BrinkmanPenalization:
    """Penalization bound to one INS integrator: wraps its step with the
    penalty and a re-projection, and advances FREE bodies by
    Newton-Euler from the measured penalty impulse (prescribed bodies,
    ``density=None``, keep their U and omega):

        m dV/dt = F_hydro + (m - m_displaced) g,
        I domega/dt = T_hydro.
    """

    def __init__(self, ins, bodies: Sequence[BrinkmanBody],
                 gravity: Optional[Sequence[float]] = None):
        self.ins = ins
        self.bodies = list(bodies)
        self.gravity = (None if gravity is None
                        else torch.as_tensor(gravity, dtype=ins.dtype,
                                             device=ins.device))

    def step(self, ins_state, body_states: Sequence[RigidBodyState],
             dt: float, f: Optional[Vel] = None):
        """One coupled step: INS advance -> implicit penalty ->
        re-projection -> Newton-Euler body update."""
        g = self.ins.grid
        st1 = self.ins.step(ins_state, dt, f=f)
        u_pen, impulses = penalize(st1.u, g, dt, self.bodies, body_states)
        # restore incompressibility (the pointwise clamp injects
        # divergence near the body surface)
        u_div0, _ = self.ins.project(u_pen, g.dx)
        st1 = st1._replace(u=u_div0)

        new_states = []
        rho_f = float(self.ins.rho)
        for body, bst, (dP, dL) in zip(self.bodies, body_states, impulses):
            if body.density is None:
                new_states.append(bst._replace(
                    center=bst.center + dt * bst.U,
                    theta=bst.theta + dt * bst.omega))
                continue
            m_body = body.density * body.volume
            m_disp = rho_f * body.volume
            F = rho_f * dP / dt
            U_new = bst.U + dt / m_body * F
            if self.gravity is not None:
                U_new = U_new + dt * (m_body - m_disp) / m_body \
                    * self.gravity
            if body.moment is not None:
                om_new = bst.omega + rho_f * dL / body.moment
            else:
                om_new = bst.omega
            new_states.append(RigidBodyState(
                center=bst.center + dt * U_new, U=U_new,
                theta=bst.theta + dt * om_new, omega=om_new))
        return st1, new_states, impulses


def make_cylinder_sdf(radius: float):
    """SDF of a circle (2D disc, 3D sphere) of the given radius about the
    body origin."""
    def sdf(xb):
        r2 = sum(x * x for x in xb)
        return torch.sqrt(r2) - radius
    return sdf


def make_box_sdf(half_widths: Sequence[float]):
    """SDF of an axis-aligned box with the given half-widths."""
    hw = tuple(float(h) for h in half_widths)

    def sdf(xb):
        q = [torch.abs(x) - h for x, h in zip(xb, hw)]
        outside = torch.sqrt(sum(torch.clamp(c, min=0.0) ** 2 for c in q))
        m = q[0]
        for c in q[1:]:
            m = torch.maximum(m, c)
        inside = torch.clamp(m, max=0.0)
        return outside + inside
    return sdf
