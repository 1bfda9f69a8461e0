"""IBFE: the immersed finite-element structure method (port of
``ibamr_tpu/integrators/ibfe.py``).

The Lagrangian structure is a finite-element solid (``IBFEMethod``) or
membrane (``IBFESurfaceMethod``): internal forces come from the
hyperelastic weak form, and the coupling spreads and interpolates with
the marker IB method's delta kernels. Coupling schemes:

- ``"nodal"``: spread the weak-form nodal forces from the nodes and
  interpolate velocity at the nodes;
- ``"unified"``: split each nodal force over the element quadrature
  points with per-node-normalized positive shares and spread from the
  quadrature points; interpolate at the quadrature points and average
  back to the nodes. ``transfer_level`` > 0 uses a denser transfer rule.

Both conserve the total force exactly. The strategies expose the
surface ``IBMethod`` does (``prepare`` / ``compute_force`` /
``spread_force`` / ``interpolate_velocity``), so the explicit and open
IB integrators drive them unchanged. ``fast=`` takes a transfer engine:
its quadrature or node clouds are ordinary marker clouds to the engine,
so in 3D the FE coupling runs on the hand kernels of
``ops/cuda_interaction.py``, and in 2D on the torch-op engines (``mxu``,
``packed``, ``packed3``).
"""

from __future__ import annotations

from typing import Callable, Optional, Tuple

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.fe.fem import (FEAssembly, _node_qp_weights,
                                    build_assembly, build_transfer_assembly,
                                    deformation_gradients, det,
                                    distribute_to_quads, elastic_energy,
                                    nodal_average_from_quads, nodal_forces,
                                    quad_positions)
from ibamr_tpu_torch.fe.mesh import FEMesh
from ibamr_tpu_torch.fe.surface import (SurfaceMesh, build_surface_assembly,
                                        current_area, membrane_energy,
                                        membrane_forces,
                                        surface_quad_positions)
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ib import check_fast_grid
from ibamr_tpu_torch.ops import interaction

Vel = Tuple[torch.Tensor, ...]


def _check_fast_engine(fast, kernel) -> None:
    """The engine bakes in its kernel at construction; a mismatch with
    the method's kernel would transfer with the wrong delta."""
    if fast is None:
        return
    if getattr(fast, "kernel", kernel) != kernel:
        raise ValueError(f"fast engine kernel {fast.kernel!r} != method "
                         f"kernel {kernel!r}")


class _FECoupling:
    """The transfers shared by the volume and surface strategies, over
    the transfer tables ``self._tasm`` with quad-point positions
    ``self._quads(X)`` and quad weights ``self._tw``."""

    def prepare(self, X: torch.Tensor, mask: torch.Tensor):
        """Per-position transfer context for the engine: bucket the
        nodal cloud, or the quad cloud it determines, once per position
        and reuse it across the step's spread and interp calls."""
        if self.fast is None:
            return None
        if self.coupling == "nodal":
            return self.fast.buckets(X, mask)
        return self.fast.buckets(self._quads(X))

    def interpolate_velocity(self, u: Vel, grid: StaggeredGrid,
                             X: torch.Tensor, mask: torch.Tensor,
                             ctx=None) -> torch.Tensor:
        if self.fast is not None:
            check_fast_grid(self.fast, grid)
        if self.coupling == "nodal":
            if self.fast is not None:
                return self.fast.interpolate_vel(u, X, weights=mask, b=ctx)
            return interaction.interpolate_vel(u, grid, X,
                                               kernel=self.kernel,
                                               weights=mask)
        xq = self._quads(X)
        if self.fast is not None:
            Uq = self.fast.interpolate_vel(u, xq, b=ctx)
        else:
            Uq = interaction.interpolate_vel(u, grid, xq, kernel=self.kernel)
        t = self._tasm
        out = nodal_average_from_quads(t.elems, t.shape, self._tw, t.n_nodes,
                                       Uq, ww_den=self._wwden)
        # inactive slots interpolate to zero, as on the nodal path
        return out * mask[:, None]

    def spread_force(self, F: torch.Tensor, grid: StaggeredGrid,
                     X: torch.Tensor, mask: torch.Tensor, ctx=None) -> Vel:
        if self.fast is not None:
            check_fast_grid(self.fast, grid)
        if self.coupling == "nodal":
            if self.fast is not None:
                return self.fast.spread_vel(F, X, weights=mask, b=ctx)
            return interaction.spread_vel(F, grid, X, kernel=self.kernel,
                                          weights=mask)
        t = self._tasm
        Fq = distribute_to_quads(t.elems, t.shape, self._tw, t.n_nodes,
                                 F * mask[:, None], ww_den=self._wwden)
        xq = self._quads(X)
        if self.fast is not None:
            return self.fast.spread_vel(Fq, xq, b=ctx)
        return interaction.spread_vel(Fq, grid, xq, kernel=self.kernel)

    def _damped(self, F, X, U, t):
        if self.damping:
            F = F - self.damping * U
        if self.body_force is not None:
            F = F + self.body_force(X, t)
        return F


class IBFEMethod(_FECoupling):
    """FE-solid strategy for the explicit IB integrators. The coupled
    state's ``X`` is the (n_nodes, dim) tensor of current nodal
    positions; the reference tables live in ``self.asm`` (stiffness rule)
    and ``self.tasm`` (transfer rule)."""

    def __init__(self, mesh: FEMesh, W: Callable, kernel="IB_4",
                 coupling: str = "unified", damping: float = 0.0,
                 body_force: Optional[Callable] = None,
                 dtype=torch.float32, fast=None, transfer_level: int = 0,
                 device="cuda"):
        if coupling not in ("nodal", "unified"):
            raise ValueError(f"unknown IBFE coupling scheme {coupling!r}")
        _check_fast_engine(fast, kernel)
        device = resolve_device(device)
        self.fast = fast
        self.mesh = mesh
        self.asm: FEAssembly = build_assembly(mesh, dtype=dtype,
                                              device=device)
        self.W = W
        self.kernel = kernel
        self.coupling = coupling
        self.damping = damping
        self.body_force = body_force  # optional (x, t) -> nodal force
        self.transfer_level = int(transfer_level)
        if self.transfer_level > 0 and coupling == "nodal":
            raise ValueError(
                "transfer_level applies to the 'unified' "
                "(quadrature-point) coupling only; nodal coupling "
                "transfers at the nodes and has no quadrature rule "
                "to densify")
        self.tasm: FEAssembly = (
            self.asm if self.transfer_level <= 0
            else build_transfer_assembly(mesh, self.transfer_level,
                                         dtype=dtype, device=device))
        self._tasm, self._tw = self.tasm, self.tasm.wdV
        # static node<->quad transfer weights, hoisted out of the steps
        self._wwden = _node_qp_weights(self.tasm.elems, self.tasm.shape,
                                       self.tasm.wdV, self.tasm.n_nodes)

    def _quads(self, X):
        return quad_positions(self.tasm, X)

    def compute_force(self, X: torch.Tensor, U: torch.Tensor,
                      t) -> torch.Tensor:
        return self._damped(nodal_forces(self.asm, self.W, X), X, U, t)

    def energy(self, X: torch.Tensor) -> torch.Tensor:
        return elastic_energy(self.asm, self.W, X)

    def current_volume(self, X: torch.Tensor) -> torch.Tensor:
        """Deformed measure: sum_e sum_q |det FF| wdV."""
        FF = deformation_gradients(self.asm, X)
        return torch.sum(torch.abs(det(FF)) * self.asm.wdV)


class IBFESurfaceMethod(_FECoupling):
    """Codim-1 FE strategy: membranes and shells carry the in-plane
    elasticity of ``fe/surface.py`` and couple at the surface quadrature
    points with area weights (or nodally)."""

    def __init__(self, mesh: SurfaceMesh, W: Callable, kernel="IB_4",
                 coupling: str = "unified", damping: float = 0.0,
                 body_force: Optional[Callable] = None,
                 dtype=torch.float32, fast=None, device="cuda"):
        if coupling not in ("nodal", "unified"):
            raise ValueError(f"unknown IBFE coupling scheme {coupling!r}")
        if not isinstance(mesh, SurfaceMesh):
            raise TypeError("IBFESurfaceMethod takes a SurfaceMesh")
        _check_fast_engine(fast, kernel)
        self.fast = fast
        self.mesh = mesh
        self.asm = build_surface_assembly(mesh, dtype=dtype, device=device)
        self.W = W
        self.kernel = kernel
        self.coupling = coupling
        self.damping = damping
        self.body_force = body_force
        self._tasm, self._tw = self.asm, self.asm.wdA
        self._wwden = _node_qp_weights(self.asm.elems, self.asm.shape,
                                       self.asm.wdA, self.asm.n_nodes)

    def _quads(self, X):
        return surface_quad_positions(self.asm, X)

    def compute_force(self, X: torch.Tensor, U: torch.Tensor,
                      t) -> torch.Tensor:
        return self._damped(membrane_forces(self.asm, self.W, X), X, U, t)

    def energy(self, X: torch.Tensor) -> torch.Tensor:
        return membrane_energy(self.asm, self.W, X)

    def current_area(self, X: torch.Tensor) -> torch.Tensor:
        return current_area(self.asm, X)


class DirectForcingKinematics:
    """Prescribed kinematics on top of any FE strategy: a stiff
    penalty/damping pair

        F_df = kappa (X_target(t) - X) - eta (U - U_target(t))

    added to the wrapped strategy's elastic force; every other call
    delegates."""

    def __init__(self, base, target_fn: Callable, kappa: float,
                 eta: float = 0.0, target_vel_fn: Optional[Callable] = None):
        self.base = base
        self.target_fn = target_fn
        self.target_vel_fn = target_vel_fn
        self.kappa = float(kappa)
        self.eta = float(eta)

    def compute_force(self, X: torch.Tensor, U: torch.Tensor,
                      t) -> torch.Tensor:
        F = self.base.compute_force(X, U, t)
        F = F + self.kappa * (self.target_fn(t) - X)
        if self.eta:
            Ut = (self.target_vel_fn(t) if self.target_vel_fn is not None
                  else torch.zeros_like(U))
            F = F - self.eta * (U - Ut)
        # a user target easily promotes the dtype; keep the state's
        return F.to(X.dtype)

    def interpolate_velocity(self, *a, **kw):
        return self.base.interpolate_velocity(*a, **kw)

    def spread_force(self, *a, **kw):
        return self.base.spread_force(*a, **kw)

    def __getattr__(self, name):
        return getattr(self.base, name)
