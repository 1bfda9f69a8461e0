"""Port parity of ``solvers/stokes.py``: the coupled operator, the
projection preconditioner and the right-hand side against ibamr_tpu to
roundoff; the FGMRES solve with the reference's restart count and
solution (1e-10 relative); the cases of ``tests/test_stokes.py`` run on
the port; and on an all-periodic box the spectral saddle solve against
the Krylov solve. f64 on the CPU unless noted."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.solvers import stokes as js
from ibamr_tpu_torch.solvers import stokes as ts
from ibamr_tpu_torch.solvers.escalation import SolverBreakdown


def _pair(n, dx, bcs, **kw):
    """The reference's and the port's solver for ``bcs = (jax BC, port
    BC)``."""
    return (js.StaggeredStokesSolver(n, dx, bcs[0], **kw),
            ts.StaggeredStokesSolver(n, dx, bcs[1], device="cpu", **kw))


def _random_state(solver, seed, lib):
    rng = np.random.default_rng(seed)
    u = [rng.standard_normal(s) for s in solver.shapes]
    p = rng.standard_normal(solver.n)
    conv = jnp.asarray if lib == "jax" else torch.tensor
    return tuple(map(conv, u)), conv(p)


def _close(ref, got, rtol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= rtol * max(np.max(np.abs(ref)),
                                                   1e-300)


def _close_x(ref, got, rtol):
    for a, b in zip(ref[0] + (ref[1],), got[0] + (got[1],)):
        _close(a, b, rtol)


CHANNEL = (js.channel_bc(2), ts.channel_bc(2))
CAVITY = (js.cavity_bc(2), ts.cavity_bc(2))
PERIODIC_Y = tuple(m.StokesBC(axes=((m.VelocitySide(m.INFLOW),
                                     m.VelocitySide(m.OPEN)), None))
                   for m in (js, ts))


@pytest.mark.parametrize("bcs", [CHANNEL, CAVITY, PERIODIC_Y])
def test_operator_preconditioner_and_rhs_match_reference(bcs):
    jsv, tsv = _pair((12, 8), (1.0 / 12, 0.6 / 8), bcs, alpha=40.0, mu=0.05)
    x = _random_state(jsv, 1, "jax")
    y = _random_state(tsv, 1, "torch")
    _close_x(jsv.operator(x), tsv.operator(y), 1e-13)
    _close_x(jsv.precondition(x), tsv.precondition(y), 1e-13)
    _close_x(jsv.operator(x, alpha=7.0), tsv.operator(y, alpha=7.0), 1e-13)
    prof = np.linspace(0.0, 1.0, 8)[None, :]
    jr = jsv.make_rhs(f_u=x[0], f_p=x[1],
                      bdry={(0, 0, 0): jnp.asarray(prof), (1, 0, 0): 0.3,
                            (0, 1, 1): 1.0, (1, 0, 1): -0.5})
    tr = tsv.make_rhs(f_u=y[0], f_p=y[1],
                      bdry={(0, 0, 0): torch.tensor(prof), (1, 0, 0): 0.3,
                            (0, 1, 1): 1.0, (1, 0, 1): -0.5})
    _close_x(jr, tr, 1e-14)


@pytest.mark.parametrize("bcs,alpha", [(CHANNEL, 1.0), (CAVITY, 0.0),
                                       (PERIODIC_Y, 1.0)])
def test_solve_matches_reference(bcs, alpha):
    """The exact-inverse cases of the reference suite: the same restart
    count, solutions within 1e-10 relative of the reference's and within
    the reference suite's bounds of the manufactured fields."""
    n = (16, 12)
    jsv, tsv = _pair(n, (1.0 / 16, 1.0 / 12), bcs, alpha=alpha,
                     mu=0.05 if alpha else 1.0, tol=1e-11)
    x = _random_state(jsv, 2, "jax")
    y = _random_state(tsv, 2, "torch")
    if alpha == 0.0:
        x = (x[0], x[1] - jnp.mean(x[1]))
        y = (y[0], y[1] - torch.mean(y[1]))
    jsol = jsv.solve(jsv.operator(x))
    tsol = tsv.solve(tsv.operator(y))
    assert bool(tsol.converged) and tsol.iters == int(jsol.iters)
    assert tsv.last_solve_stats["iters"] == tsol.iters
    _close_x((jsol.u, jsol.p), (tsol.u, tsol.p), 1e-10)
    for a, b in zip(tsol.u, y[0]):
        assert float(torch.max(torch.abs(a - b))) < 1e-7
    assert float(torch.max(torch.abs(tsol.p - y[1]))) < 1e-6


def test_lid_driven_cavity_corner_rows():
    n = 16
    solver = ts.StaggeredStokesSolver((n, n), (1.0 / n, 1.0 / n),
                                      ts.cavity_bc(2), alpha=0.0, mu=1.0,
                                      tol=1e-10, device="cpu")
    rhs = solver.make_rhs(bdry={(0, 1, 1): 1.0})
    ru = rhs[0][0].numpy()
    assert np.all(ru[0, :] == 0.0) and np.all(ru[-1, :] == 0.0)
    sol = solver.solve(rhs)
    assert bool(sol.converged)
    un, vn = sol.u[0].numpy(), sol.u[1].numpy()
    assert np.max(np.abs(un[0, :])) < 1e-12
    assert np.max(np.abs(un[-1, :])) < 1e-12
    assert np.max(np.abs(un)) > 0.05 and np.max(np.abs(vn)) > 0.01
    assert float(torch.max(torch.abs(solver.divergence(sol.u)))) < 1e-8


@pytest.mark.slow
def test_f32_convergence_regression():
    nx, ny = 32, 16
    y = (np.arange(ny) + 0.5) / ny
    profile = torch.tensor(4.0 * y * (1.0 - y), dtype=torch.float32)
    solver = ts.StaggeredStokesSolver((nx, ny), (2.0 / nx, 1.0 / ny),
                                      ts.channel_bc(2), alpha=200.0,
                                      mu=0.05, tol=1e-5,
                                      dtype=torch.float32, device="cpu")
    rhs = solver.make_rhs(bdry={(0, 0, 0): profile[None, :],
                                (1, 0, 0): 0.0})
    assert rhs[0][0].dtype == torch.float32
    sol = solver.solve(rhs)
    assert float(sol.resnorm) < 1e-2
    assert float(torch.max(torch.abs(sol.u[0]))) > 0.5


def test_periodic_spectral_solve_against_krylov_and_reference():
    """All-periodic box: the one-pass spectral solve equals the FGMRES +
    multigrid solve of the same operator (to the Krylov tolerance) and the
    reference's spectral solve (to FFT roundoff)."""
    bc = ts.StokesBC(axes=(None, None))
    n, dx = (16, 12), (1.0 / 16, 1.0 / 12)
    spec = ts.StaggeredStokesSolver(n, dx, bc, alpha=30.0, mu=0.1,
                                    tol=1e-11, device="cpu")
    kry = ts.StaggeredStokesSolver(n, dx, bc, alpha=30.0, mu=0.1,
                                   tol=1e-11, device="cpu")
    kry.spectral = None
    assert spec.spectral is not None
    y = _random_state(spec, 5, "torch")
    rhs = spec.make_rhs(f_u=y[0], f_p=y[1])
    a, b = spec.solve(rhs), kry.solve(rhs)
    assert a.iters == 0 and bool(a.converged) and bool(b.converged)
    assert spec.last_solve_stats["solver"] == "spectral"
    _close_x((b.u, b.p - torch.mean(b.p)), (a.u, a.p - torch.mean(a.p)),
             1e-8)
    jsv = js.StaggeredStokesSolver(n, dx, js.StokesBC(axes=(None, None)),
                                   alpha=30.0, mu=0.1, tol=1e-11)
    x = _random_state(jsv, 5, "jax")
    ja = jsv.solve(jsv.make_rhs(f_u=x[0], f_p=x[1]))
    _close_x((ja.u, ja.p), (a.u, a.p), 1e-12)
    assert abs(float(a.resnorm) - float(ja.resnorm)) < 1e-9


def test_solve_escalated_walks_the_chain():
    n = (12, 8)
    solver = ts.StaggeredStokesSolver(n, (1.0 / 12, 1.0 / 8),
                                      ts.channel_bc(2), alpha=1.0, mu=0.05,
                                      tol=1e-9, m=2, restarts=1,
                                      device="cpu")
    y = _random_state(solver, 6, "torch")
    rhs = solver.operator(y)
    seen = []
    with pytest.raises(SolverBreakdown) as err:
        solver.solve_escalated(rhs, on_incident=seen.append, step=3)
    assert [a["level"] for a in err.value.attempts] == \
        ["base", "restarts_x4", "deep_x4_inner_x2"]
    assert seen[0]["event"] == "solver_breakdown" and err.value.step == 3
    solver.tol = 1e-3
    sol = solver.solve_escalated(rhs, on_incident=seen.append)
    assert bool(sol.converged)


@pytest.mark.slow
def test_poiseuille_channel():
    nx, ny = 48, 32
    L, H, U, mu = 1.5, 1.0, 1.0, 0.7
    dx, dy = L / nx, H / ny
    solver = ts.StaggeredStokesSolver((nx, ny), (dx, dy), ts.channel_bc(2),
                                      alpha=0.0, mu=mu, tol=1e-11, m=60,
                                      restarts=20, device="cpu")
    y = (np.arange(ny) + 0.5) * dy
    profile = 4.0 * U * y * (H - y) / H ** 2
    sol = solver.solve(solver.make_rhs(
        bdry={(0, 0, 0): torch.tensor(profile)[None, :], (1, 0, 0): 0.0}))
    assert bool(sol.converged)
    un = sol.u[0].numpy()
    fluxes = un.sum(axis=1) * dy
    assert np.max(np.abs(fluxes - fluxes[0])) < 1e-8
    assert np.max(np.abs(un[nx // 2, :] - profile)) < 10.0 * dy ** 2
    assert float(torch.max(torch.abs(solver.divergence(sol.u)))) < 1e-8
