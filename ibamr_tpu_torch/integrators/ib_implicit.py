"""Implicit IB coupling for stiff structures at large dt (port of
``ibamr_tpu/integrators/ib_implicit.py``).

The unknown is the marker configuration X^{n+1} alone: the fluid solve is
folded into the residual of the midpoint rule,

    R(X^{n+1}) = X^{n+1} - X^n - dt J(X^mid) u^mid,
    X^mid = (X^n + X^{n+1})/2,  u^mid = (u^n + u^{n+1})/2,
    u^{n+1} = INS_step(u^n, f = S(X^mid) F(X^mid, U^mid)),

(backward Euler at X^{n+1}, u^{n+1}) and solved by
``solvers.krylov.newton_krylov`` with exact Jacobian-vector products
through spread -> fluid solve -> interp and FGMRES inner solves. The
Newton loop reads its residual norm to the host once an iteration; the
products follow the primal's iterations, so they take the primal's
iteration counts, as ``jax.linearize`` of the reference's loops does.

- On the periodic grid (``IBImplicitIntegrator``) a product differentiates
  the whole residual with autograd (``krylov.linearize_by_vjp``, the
  transpose of its vector-Jacobian product); the periodic fluid step
  replays no CUDA graph, so autograd sees every operation.
- On the two-level hierarchy (``TwoLevelIBImplicit``) the predictor and
  the projection's correction are differentiated so, and the composite
  projection's FGMRES by its own tangent iteration
  (``krylov.fgmres_flat_jvp``): its operator and preconditioner are
  linear, so the tangents go through the same CUDA-graph replays as the
  primal, which stays bitwise the plain solve's.

The transfer engines that launch hand CUDA kernels (``pallas``,
``pallas_packed``, the hybrid engines) have no derivative and raise
``NotImplementedError``, as the reference's ``pallas_call`` refuses a
JVP; the ``scatter`` and ``packed`` engines run.
"""

from __future__ import annotations

import torch

from ibamr_tpu_torch.amr_ins import (TwoLevelIBINS, TwoLevelIBState,
                                     TwoLevelINSState, advance_with_regrids,
                                     regrid_two_level_ib)
from ibamr_tpu_torch.integrators.ib import (IBExplicitIntegrator, IBMethod,
                                            IBState)
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.ops.cuda_interaction import (HybridKernelInteraction,
                                                  _KernelEngine)
from ibamr_tpu_torch.solvers.escalation import record_solve_stats
from ibamr_tpu_torch.solvers.krylov import (fgmres_flat_jvp,
                                            linearize_by_vjp, newton_krylov)
from ibamr_tpu_torch.utils.tree import ravel


def refuse_kernel_engines(ib) -> None:
    """Raise for a transfer engine that launches hand CUDA kernels: they
    have no derivative."""
    fast = getattr(ib, "fast", None)
    if isinstance(fast, (_KernelEngine, HybridKernelInteraction)):
        name = getattr(ib, "engine_name", None) or type(fast).__name__
        raise NotImplementedError(
            f"the implicit IB step differentiates the transfers, and the "
            f"{name!r} engine launches hand CUDA kernels, which have no "
            "derivative (the reference's pallas_call refuses a JVP "
            "likewise); use 'scatter' or a torch-op engine ('packed', "
            "'mxu', 'packed3' or their bf16 twins)")


def _check_scheme(scheme: str) -> None:
    if scheme not in ("midpoint", "backward_euler"):
        raise ValueError(f"unknown implicit IB scheme {scheme!r}")


class IBImplicitIntegrator:
    """Implicit-midpoint (or backward-Euler) IB coupling with the
    construction surface of ``IBExplicitIntegrator`` plus the
    Newton-Krylov knobs. ``last_solve_stats`` holds the last step's
    Newton iteration count."""

    def __init__(self, ins: INSStaggeredIntegrator, ib: IBMethod,
                 scheme: str = "midpoint", newton_tol: float = 1e-6,
                 newton_maxiter: int = 8, inner_m: int = 16,
                 inner_restarts: int = 2, inner_tol: float = 1e-3):
        _check_scheme(scheme)
        self.ins = ins
        self.ib = ib
        # midpoint: 2nd order, A-stable; backward Euler: 1st order,
        # L-stable (the robust choice at extreme stiffness)
        self.scheme = scheme
        self.newton_tol = float(newton_tol)
        self.newton_maxiter = int(newton_maxiter)
        self.inner_m = int(inner_m)
        self.inner_restarts = int(inner_restarts)
        self.inner_tol = float(inner_tol)
        self.last_solve_stats = None

    def initialize(self, X0, ins_state=None, mask=None) -> IBState:
        return IBExplicitIntegrator(self.ins, self.ib).initialize(
            X0, ins_state=ins_state, mask=mask)

    def _newton(self, residual, X_pred, jvp=None):
        """Newton-Krylov on the residual (``jvp``: its Jacobian products,
        else autograd's through the residual)."""
        sol = newton_krylov(residual, X_pred, tol=self.newton_tol,
                            maxiter=self.newton_maxiter, inner_m=self.inner_m,
                            inner_restarts=self.inner_restarts,
                            inner_tol=self.inner_tol, jvp=jvp)
        record_solve_stats(self, sol, solver="newton_krylov")
        return sol.x

    def step(self, state: IBState, dt: float) -> IBState:
        refuse_kernel_engines(self.ib)
        grid = self.ins.grid
        ib = self.ib
        u_n = state.ins.u
        X_n = state.X
        mask = state.mask
        mid = self.scheme == "midpoint"
        t_c = state.ins.t + (0.5 * dt if mid else dt)

        def fluid_and_U(X_new):
            """u^{n+1} and the marker velocity for a trial configuration
            (one residual evaluation)."""
            X_c = 0.5 * (X_n + X_new) if mid else X_new
            U_est = (X_new - X_n) / dt
            F_c = ib.compute_force(X_c, U_est, t_c)
            f_eul = ib.spread_force(F_c, grid, X_c, mask)
            ins_new = self.ins.step(state.ins, dt, f=f_eul)
            u_c = (tuple(0.5 * (a + b) for a, b in zip(u_n, ins_new.u))
                   if mid else ins_new.u)
            return ins_new, ib.interpolate_velocity(u_c, grid, X_c, mask)

        def residual(X_new):
            return X_new - X_n - dt * fluid_and_U(X_new)[1]

        # the explicit forward-Euler predictor as the initial guess
        X_pred = X_n + dt * ib.interpolate_velocity(u_n, grid, X_n, mask)
        X_new = self._newton(residual, X_pred)
        ins_new, U_mid = fluid_and_U(X_new)
        return IBState(ins=ins_new, X=X_new, U=U_mid, mask=mask)


def advance_ib_implicit(integ: IBImplicitIntegrator, state: IBState,
                        dt: float, num_steps: int) -> IBState:
    for _ in range(num_steps):
        state = integ.step(state, dt)
    return state


class TwoLevelIBImplicit(IBImplicitIntegrator):
    """Implicit IB coupling on the composite two-level hierarchy: one
    residual evaluation folds the whole composite step (spread at fine
    resolution, the force restricted to the coarse level, the two-level
    predictor and the composite FGMRES projection) into the Newton-Krylov
    residual, and the Jacobian products differentiate through the
    projection's iterations (module docstring). The structure stays inside
    the fine window with delta-support clearance, as in
    ``TwoLevelIBINS``."""

    def __init__(self, grid, box, ib, rho: float = 1.0, mu: float = 0.01,
                 convective: bool = True, proj_tol: float = 1e-8,
                 proj_m: int = 16, proj_restarts: int = 2,
                 scheme: str = "midpoint", newton_tol: float = 1e-6,
                 newton_maxiter: int = 8, inner_m: int = 12,
                 inner_restarts: int = 2, inner_tol: float = 1e-3,
                 device="cuda", _expl=None):
        _check_scheme(scheme)
        # the explicit composite integrator supplies the core step and the
        # fine-resolution transfers (``_expl``: the one a regrid rebuilt)
        self._expl = _expl if _expl is not None else TwoLevelIBINS(
            grid, box, ib, rho=rho, mu=mu, convective=convective,
            proj_tol=proj_tol, proj_m=proj_m, proj_restarts=proj_restarts,
            device=device)
        self.device = self._expl.device
        self.grid = grid
        self.box = box
        self.ib = ib
        self.scheme = scheme
        self.newton_tol = float(newton_tol)
        self.newton_maxiter = int(newton_maxiter)
        self.inner_m = int(inner_m)
        self.inner_restarts = int(inner_restarts)
        self.inner_tol = float(inner_tol)
        self.last_solve_stats = None

    def initialize(self, X0, uc=None) -> TwoLevelIBState:
        return self._expl.initialize(X0, uc=uc)

    def step(self, state: TwoLevelIBState, dt: float) -> TwoLevelIBState:
        refuse_kernel_engines(self.ib)
        expl = self._expl
        core, proj = expl.core, expl.core.proj
        fluid = state.fluid
        X_n = state.X
        mask = state.mask
        mid = self.scheme == "midpoint"
        t_c = fluid.t + (0.5 * dt if mid else dt)

        def coupled(X_new):
            X_c = 0.5 * (X_n + X_new) if mid else X_new
            # one transfer context per configuration, shared by the
            # spread and the interp
            ctx = self.ib.prepare(X_c, mask) \
                if hasattr(self.ib, "prepare") else None
            return X_c, ctx

        def predict(X_new):
            """The two-level predictor with the spread force of a trial
            configuration (the step before its projection)."""
            X_c, ctx = coupled(X_new)
            F_c = self.ib.compute_force(X_c, (X_new - X_n) / dt, t_c)
            f_c, f_f = expl._spread_two_level(F_c, X_c, mask, ctx=ctx)
            return core.predict(fluid, dt, f_c=f_c, f_f=f_f)

        def finish(X_new, ustar, phi):
            """The projection's correction with the solution ``phi`` and
            the marker velocity."""
            X_c, ctx = coupled(X_new)
            uc_new, uf_new, _, _ = proj.correct(*ustar, phi)
            u_c = (tuple(0.5 * (a + b) for a, b in zip(fluid.uf, uf_new))
                   if mid else uf_new)
            return uc_new, uf_new, expl._interp(u_c, X_c, mask, ctx=ctx)

        def fluid_and_U(X_new):
            ustar = predict(X_new)
            uc_new, uf_new, U_c = finish(X_new, ustar,
                                         proj.solve(proj.rhs(*ustar)))
            return TwoLevelINSState(uc=uc_new, uf=uf_new, t=fluid.t + dt,
                                    k=fluid.k + 1), U_c

        def residual(X_new):
            return X_new - X_n - dt * fluid_and_U(X_new)[1]

        unravel_u = ravel((fluid.uc, fluid.uf))[1]

        def jvp(X_new, V):
            """The residual's Jacobian-vector product: the predictor and
            the correction by ``linearize_by_vjp``, the projection's FGMRES
            by its tangent iteration over the (linear, graphed on the card)
            composite operator and preconditioner."""
            nx = X_new.numel()
            s, ds = linearize_by_vjp(
                lambda x: ravel(predict(x.reshape(X_n.shape)))[0],
                X_new.reshape(-1), V.reshape(-1))
            rhs = proj.rhs(*unravel_u(s))
            rflat, unravel_r = ravel(rhs)
            sol, dphi = fgmres_flat_jvp(
                *proj.flat_ops(rhs), rflat,
                ravel(proj.rhs(*unravel_u(ds)))[0], m=proj.m, tol=proj.tol,
                restarts=proj.restarts)
            ns = s.numel()

            def G(z):
                Xz = z[:nx].reshape(X_n.shape)
                U = finish(Xz, unravel_u(z[nx:nx + ns]),
                           unravel_r(z[nx + ns:]))[2]
                return (Xz - X_n - dt * U).reshape(-1)

            _, dR = linearize_by_vjp(
                G, torch.cat([X_new.reshape(-1), s, sol.x]),
                torch.cat([V.reshape(-1), ds, dphi]))
            return dR.reshape(X_n.shape)

        X_pred = X_n + dt * expl._interp(fluid.uf, X_n, mask)
        X_new = self._newton(residual, X_pred, jvp=jvp)
        fluid_new, U_mid = fluid_and_U(X_new)
        return TwoLevelIBState(fluid=fluid_new, X=X_new, U=U_mid, mask=mask)


def advance_two_level_ib_implicit(integ: TwoLevelIBImplicit,
                                  state: TwoLevelIBState, dt: float,
                                  num_steps: int) -> TwoLevelIBState:
    for _ in range(num_steps):
        state = integ.step(state, dt)
    return state


def regrid_two_level_ib_implicit(integ: TwoLevelIBImplicit,
                                 state: TwoLevelIBState,
                                 move_threshold: int = 2):
    """Moving-window regrid of the implicit composite integrator: the
    state moves through ``amr_ins.regrid_two_level_ib``, and the implicit
    wrapper is rebuilt around the new explicit core. An unchanged window
    returns (integ, state) as they are."""
    expl2, state2 = regrid_two_level_ib(integ._expl, state,
                                        move_threshold=move_threshold)
    if expl2 is integ._expl:
        return integ, state
    core = expl2.core
    integ2 = TwoLevelIBImplicit(
        integ.grid, expl2.box, integ.ib, rho=core.rho, mu=core.mu,
        convective=core.convective, proj_tol=core.proj.tol,
        proj_m=core.proj.m, proj_restarts=core.proj.restarts,
        scheme=integ.scheme, newton_tol=integ.newton_tol,
        newton_maxiter=integ.newton_maxiter, inner_m=integ.inner_m,
        inner_restarts=integ.inner_restarts, inner_tol=integ.inner_tol,
        device=integ.device, _expl=expl2)
    return integ2, state2


def advance_two_level_ib_implicit_regridding(integ: TwoLevelIBImplicit,
                                             state: TwoLevelIBState,
                                             dt: float, num_steps: int,
                                             regrid_interval: int = 20,
                                             on_chunk=None):
    """The implicit composite advance with the fine window tracking the
    structure: chunks of ``regrid_interval`` implicit steps with host-side
    marker-tagged regrids between them."""
    return advance_with_regrids(
        integ, state, dt, num_steps, regrid_interval,
        advance_two_level_ib_implicit, regrid_two_level_ib_implicit,
        on_chunk=on_chunk)
