"""Port parity of ``integrators/ins_open.py`` (inflow/outflow Navier-
Stokes on the coupled FGMRES + multigrid saddle solve) against
ibamr_tpu at f64 on the CPU: the advection operators to roundoff, and
channel runs with the same FGMRES restarts in every step and the fields
within 1e-8 relative (the solves stop at ``tol = 1e-11``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.integrators import ins_open as jo
from ibamr_tpu.solvers import stokes as js
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.integrators import ins_open as to
from ibamr_tpu_torch.solvers import stokes as ts


def _pair(n, op, tol=1e-11, bc="channel"):
    H = 1.0
    dx = (2.0 / n[0], H / n[1])
    y = (np.arange(n[1]) + 0.5) * dx[1]
    prof = 4.0 * y * (H - y) / H ** 2
    kw = dict(mu=0.05, dt=0.005, tol=tol, convective_op_type=op)
    if bc == "channel":
        jb, tb = js.channel_bc(2), ts.channel_bc(2)
        jd = {(0, 0, 0): jnp.asarray(prof)[None, :], (1, 0, 0): 0.0}
        td = {(0, 0, 0): torch.tensor(prof)[None, :], (1, 0, 0): 0.0}
    else:                       # periodic along the flow, walls across
        jb = js.StokesBC(axes=(None, (js.VelocitySide(), js.VelocitySide())))
        tb = ts.StokesBC(axes=(None, (ts.VelocitySide(), ts.VelocitySide())))
        jd = {(0, 1, 1): 1.0}
        td = {(0, 1, 1): 1.0}
    ji = jo.INSOpenIntegrator(n, dx, jb, bdry=jd, **kw)
    ti = to.INSOpenIntegrator(n, dx, tb, bdry=td, device="cpu", **kw)
    ji.solver.record_stats = True
    return ji, ti


def _close(ref, got, rtol):
    ref = np.asarray(ref)
    assert got.shape == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) <= rtol * max(
        np.max(np.abs(ref)), 1e-300)


def _run(ji, ti, steps):
    jstep = jax.jit(ji.step)
    js_, ts_ = ji.initialize(), ti.initialize()
    jr, tr = [], []
    for _ in range(steps):
        js_ = jstep(js_)
        jax.block_until_ready(js_.u[0])
        jr.append(ji.solver.last_solve_stats["iters"])
        ts_ = ti.step(ts_)
        tr.append(ti.solver.last_solve_stats["iters"])
    return js_, ts_, jr, tr


@pytest.mark.parametrize("op", ["upwind", "stabilized_ppm"])
@pytest.mark.parametrize("bc", ["channel", "periodic_x"])
def test_advection_matches_reference(op, bc):
    ji, ti = _pair((12, 8), op, bc=bc)
    rng = np.random.default_rng(1)
    u = [rng.standard_normal(s) for s in ti.solver.shapes]
    jadv = ji._advect_stabilized if op != "upwind" else ji._advect
    tadv = ti._advect_stabilized if op != "upwind" else ti._advect
    for a, b in zip(jadv(tuple(map(jnp.asarray, u))),
                    tadv(tuple(map(torch.tensor, u)))):
        _close(a, b, 1e-13)
    for a, b in zip(ji._to_cells(tuple(map(jnp.asarray, u))),
                    ti._to_cells(tuple(map(torch.tensor, u)))):
        _close(a, b, 1e-15)


@pytest.mark.parametrize("op", ["upwind", "stabilized_ppm"])
def test_short_channel_matches_reference(op):
    ji, ti = _pair((16, 8), op)
    js_, ts_, jr, tr = _run(ji, ti, 3)
    assert tr == jr
    for a, b in zip(js_.u + (js_.p,), ts_.u + (ts_.p,)):
        _close(a, b, 1e-8)
    assert abs(float(ts_.t) - float(js_.t)) < 1e-15
    assert float(ti.max_divergence(ts_)) < 1e-9
    assert ti.cfl_dt(ts_) == pytest.approx(ji.cfl_dt(js_), rel=1e-10)


@pytest.mark.slow
def test_channel_32x16_stabilized_ppm_20_steps():
    ji, ti = _pair((32, 16), "stabilized_ppm")
    js_, ts_, jr, tr = _run(ji, ti, 20)
    assert tr == jr
    for a, b in zip(js_.u + (js_.p,), ts_.u + (ts_.p,)):
        _close(a, b, 1e-8)


def test_explicit_dt_and_converted_state():
    """A state carried over with ``convert.open_ins_state`` steps on in
    the port, at an explicit dt, as the reference's does."""
    ji, ti = _pair((12, 8), "upwind")
    js_ = jax.jit(ji.step)(ji.initialize())
    ts_ = convert.open_ins_state(js_, device="cpu")
    js_ = jax.jit(ji.step)(js_, 0.004)
    ts_ = ti.step(ts_, 0.004)
    for a, b in zip(js_.u + (js_.p,), ts_.u + (ts_.p,)):
        _close(a, b, 1e-8)
    assert float(ts_.t) == pytest.approx(0.009, rel=1e-14)
    with pytest.raises(ValueError, match="convective_op_type"):
        to.INSOpenIntegrator((8, 8), (0.1, 0.1), ts.channel_bc(2), mu=0.1,
                             dt=0.01, convective_op_type="ppm",
                             device="cpu")
