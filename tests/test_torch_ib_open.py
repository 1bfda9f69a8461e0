"""Port parity of ``integrators/ib_open.py`` (a target-point IB cylinder
in an inflow/outflow channel, the transfers on the scatter oracle) and of
``IBMethod``'s custom ``force_fn``, against ibamr_tpu at f64 on the CPU:
marker positions within 1e-9 relative, the net spread force ``F_net``
equal to roundoff, the FGMRES restarts equal."""

import inspect

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.integrators import ib as jib
from ibamr_tpu.integrators import ib_open as jbo
from ibamr_tpu.integrators import ins_open as jo
from ibamr_tpu.ops.forces import ForceSpecs as JSpecs
from ibamr_tpu.solvers import stokes as js
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.integrators import ib as tib
from ibamr_tpu_torch.integrators import ib_open as tbo
from ibamr_tpu_torch.integrators import ins_open as to
from ibamr_tpu_torch.ops.forces import ForceSpecs as TSpecs
from ibamr_tpu_torch.solvers import stokes as ts


def _pair(n, n_markers, center=(0.7, 0.5), radius=0.15,
          op="stabilized_ppm"):
    dx = (2.0 / n[0], 1.0 / n[1])
    kw = dict(mu=0.02, dt=0.004, tol=1e-11, convective_op_type=op)
    ji = jo.INSOpenIntegrator(n, dx, js.channel_bc(2), bdry={(0, 0, 0): 1.0},
                              **kw)
    ti = to.INSOpenIntegrator(n, dx, ts.channel_bc(2), bdry={(0, 0, 0): 1.0},
                              device="cpu", **kw)
    ji.solver.record_stats = True
    th = 2.0 * np.pi * np.arange(n_markers) / n_markers
    X0 = np.stack([center[0] + radius * np.cos(th),
                   center[1] + radius * np.sin(th)], axis=1)
    jX0, tX0 = jnp.asarray(X0), torch.tensor(X0)
    jm = jib.IBMethod(JSpecs(), kernel="IB_4",
                      force_fn=lambda X, U, t: -50.0 * (X - jX0) - 1.0 * U)
    tm = tib.IBMethod(TSpecs(), kernel="IB_4",
                      force_fn=lambda X, U, t: -50.0 * (X - tX0) - 1.0 * U)
    ja = jbo.IBOpenIntegrator(ji, jm, x_lo=(0.0, 0.0))
    ta = tbo.IBOpenIntegrator(ti, tm, x_lo=(0.0, 0.0))
    return ja, ta, X0


def _run(ja, ta, X0, steps):
    jstep = jax.jit(ja.step)
    jst, tst = ja.initialize(jnp.asarray(X0)), ta.initialize(X0)
    jr, tr = [], []
    for _ in range(steps):
        jst = jstep(jst)
        jax.block_until_ready(jst.X)
        jr.append(ja.ins.solver.last_solve_stats["iters"])
        tst = ta.step(tst)
        tr.append(ta.ins.solver.last_solve_stats["iters"])
    return jst, tst, jr, tr


def _check(jst, tst, jr, tr):
    assert tr == jr
    X = np.asarray(jst.X)
    assert np.max(np.abs(tst.X.numpy() - X)) <= 1e-9 * np.max(np.abs(X))
    F = np.asarray(jst.F_net)
    assert np.max(np.abs(tst.F_net.numpy() - F)) <= 1e-10 * np.max(np.abs(F))
    for a, b in zip(jst.fluid.u, tst.fluid.u):
        a = np.asarray(a)
        assert np.max(np.abs(b.numpy() - a)) <= 1e-8 * np.max(np.abs(a))


def test_short_cylinder_run_matches_reference():
    ja, ta, X0 = _pair((16, 8), 8, center=(0.8, 0.5), radius=0.15,
                       op="upwind")
    jst, tst, jr, tr = _run(ja, ta, X0, 3)
    _check(jst, tst, jr, tr)
    assert torch.equal(ta.body_force_on_fluid(tst), tst.F_net)
    assert ta.cfl_dt(tst) == pytest.approx(ja.cfl_dt(jst), rel=1e-10)
    # carried across, the state steps on as the reference's does
    jst2 = jax.jit(ja.step)(jst)
    tst2 = ta.step(convert.ib_open_state(jst, device="cpu"))
    X = np.asarray(jst2.X)
    assert np.max(np.abs(tst2.X.numpy() - X)) <= 1e-9 * np.max(np.abs(X))


@pytest.mark.slow
def test_cylinder_32x16_16_markers_10_steps():
    ja, ta, X0 = _pair((32, 16), 16)
    jst, tst, jr, tr = _run(ja, ta, X0, 10)
    _check(jst, tst, jr, tr)


def test_ibmethod_takes_force_fn_in_the_reference_position():
    """``IBMethod(specs, kernel, force_fn, fast)``, as the reference:
    a custom force replaces the specs' force, and a 2D periodic membrane
    with it steps as the reference's does."""
    names = list(inspect.signature(tib.IBMethod).parameters)
    assert names == list(inspect.signature(jib.IBMethod).parameters) == \
        ["specs", "kernel", "force_fn", "fast"]
    from ibamr_tpu.grid import StaggeredGrid as JG
    from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JI
    from ibamr_tpu_torch.grid import StaggeredGrid as TG
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TI

    box = dict(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    th = 2 * np.pi * np.arange(24) / 24
    X0 = np.stack([0.5 + 0.2 * np.cos(th), 0.5 + 0.15 * np.sin(th)], 1)
    c = np.array([0.5, 0.5])

    def force(lib):
        cc = lib(c)
        return lambda X, U, t: -3.0 * (X - cc) * (1.0 + t)

    jint = jib.IBExplicitIntegrator(
        JI(JG(**box), mu=0.05, dtype=jnp.float64),
        jib.IBMethod(JSpecs(), "IB_4", force(jnp.asarray)))
    tint = tib.IBExplicitIntegrator(
        TI(TG(**box), mu=0.05, dtype=torch.float64, device="cpu"),
        tib.IBMethod(TSpecs(), "IB_4", force(torch.tensor)))
    jst = jint.initialize(jnp.asarray(X0))
    tst = tint.initialize(X0)
    for _ in range(5):
        jst = jax.jit(jint.step, static_argnums=1)(jst, 1e-3)
        tst = tint.step(tst, 1e-3)
    X = np.asarray(jst.X)
    assert np.max(np.abs(tst.X.numpy() - X)) <= 1e-12 * np.max(np.abs(X))
    np.testing.assert_allclose(tint.total_marker_force(tst).numpy(),
                               np.asarray(jint.total_marker_force(jst)),
                               rtol=0, atol=1e-11)
