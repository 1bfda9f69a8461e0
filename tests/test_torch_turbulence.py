"""Port parity of ``physics/turbulence.py`` against ibamr_tpu at f64 on
the CPU: the Smagorinsky eddy viscosity, ``SmagorinskyINS`` (periodic
FFT-preconditioned and walled multigrid-preconditioned projections),
``TwoLevelSmagorinskyINS`` on a refined window (its eddy forces, steps
and advisory dt), the k-omega model (periodic and walled transport),
``KOmegaINS`` and the wall-resolved channel ``channel_komega`` at the
reference test's own size and iteration count. Explicit operators agree
to 1e-12 relative; fields through a solve to 1e-9 (CG at ``cg_tol``
1e-10, FGMRES at the composite projection's tolerance 1e-9 gives 1e-8);
the channel profile after 30,000 pseudo-time iterations to 1e-10."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.amr import FineBox as JBox
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.physics import turbulence as jt
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.physics import turbulence as tt

EXACT = 1e-12
SOLVE = 1e-9
T64 = dict(dtype=torch.float64, device="cpu")


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test (the suite runs in parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _grids(n):
    lo, up = (0.0,) * len(n), (1.0,) * len(n)
    return JGrid(n=n, x_lo=lo, x_up=up), TGrid(n=n, x_lo=lo, x_up=up)


def _taylor_green(n, amp=1.0, walls=None):
    x = np.arange(n) / n
    xc = (np.arange(n) + 0.5) / n
    u = amp * np.sin(2 * np.pi * x)[:, None] * np.cos(2 * np.pi * xc)[None]
    v = -amp * np.cos(2 * np.pi * xc)[:, None] * np.sin(2 * np.pi * x)[None]
    if walls is not None and walls[1]:
        v[:, 0] = 0.0
    return u, v


@pytest.mark.parametrize("wall_axes", [None, (False, True)])
def test_eddy_viscosity_matches(wall_axes):
    u = tuple(np.random.default_rng(s).standard_normal((16, 12))
              for s in (1, 2))
    dx = (1.0 / 16, 1.0 / 12)
    assert _rel(jt.eddy_viscosity_smagorinsky(tuple(map(jnp.asarray, u)),
                                              dx, 0.2, wall_axes),
                tt.eddy_viscosity_smagorinsky(tuple(map(torch.tensor, u)),
                                              dx, 0.2, wall_axes)) <= EXACT


@pytest.mark.parametrize("wall_axes", [None, (False, True)])
def test_smagorinsky_steps_match(wall_axes):
    n = 24
    jg, tg = _grids((n, n))
    kw = dict(mu=1e-3, rho=1.0, cs=0.3, wall_axes=wall_axes)
    jm = jt.SmagorinskyINS(jg, dtype=jnp.float64, **kw)
    tm = tt.SmagorinskyINS(tg, **T64, **kw)
    for m in (jm, tm):
        m._vc.cg_tol = 1e-10
    u0 = _taylor_green(n, 2.0, wall_axes)
    js = jm.initialize(tuple(map(jnp.asarray, u0)))
    ts = tm.initialize(u0)
    jstep = jax.jit(lambda s: jm.step(s, 2e-3))
    for _ in range(3):
        js, ts = jstep(js), tm.step(ts, 2e-3)
    for a, b in zip(js.u + (js.p,), ts.u + (ts.p,)):
        assert _rel(a, b) <= SOLVE


def test_two_level_smagorinsky_matches():
    """The refined-window LES of ``tests/test_turbulence.py:307``: the
    per-level eddy forces, two composite steps and the advisory dt."""
    n = 32
    jg, tg = _grids((n, n))
    jbox = JBox(lo=(8, 8), shape=(16, 16))
    tbox = convert.fine_box(jbox)
    kw = dict(mu=1e-3, rho=1.0, cs=0.4)
    jm = jt.TwoLevelSmagorinskyINS(jg, jbox, **kw)
    tm = tt.TwoLevelSmagorinskyINS(tg, tbox, device="cpu", **kw)
    u0 = _taylor_green(n, 2.0)
    js = jm.initialize(tuple(jnp.asarray(c) for c in u0))
    ts = convert.two_level_ins_state(jax.tree_util.tree_map(np.asarray, js),
                                     device="cpu")
    for (a, b) in zip(jm._eddy_forces(js), tm._eddy_forces(ts)):
        for x, y in zip(a, b):
            assert _rel(x, y) <= EXACT
    assert abs(float(jm.stable_dt(js)) - float(tm.stable_dt(ts))) \
        <= EXACT * float(jm.stable_dt(js))
    jstep = jax.jit(lambda s: jm.step(s, 1.5e-3))
    for _ in range(2):
        js, ts = jstep(js), tm.step(ts, 1.5e-3)
    for a, b in zip(js.uc + js.uf, ts.uc + ts.uf):
        assert _rel(a, b) <= 1e-8
    assert abs(float(jm.max_divergence(js))
               - float(tm.max_divergence(ts))) < 1e-6


@pytest.mark.parametrize("wall_axes", [None, (False, True)])
def test_komega_model_advance_matches(wall_axes):
    n = (16, 12)
    jg, tg = _grids(n)
    jm = jt.KOmegaModel(jg, nu=1e-3, wall_axes=wall_axes)
    tm = tt.KOmegaModel(tg, nu=1e-3, wall_axes=wall_axes)
    rng = np.random.default_rng(3)
    k = 1e-3 * (1.0 + rng.uniform(0, 1, n))
    w = 2.0 + rng.uniform(0, 1, n)
    u = tuple(0.3 * rng.standard_normal(n) for _ in range(2))
    if wall_axes is not None:
        u[1][:, 0] = 0.0
    js = jt.KOmegaState(k=jnp.asarray(k), omega=jnp.asarray(w))
    ts = convert.komega_state(jax.tree_util.tree_map(np.asarray, js),
                              device="cpu")
    for _ in range(3):
        js = jm.advance(js, tuple(map(jnp.asarray, u)), 1e-3)
        ts = tm.advance(ts, tuple(map(torch.tensor, u)), 1e-3)
    assert _rel(js.k, ts.k) <= EXACT and _rel(js.omega, ts.omega) <= EXACT
    assert _rel(jm.nu_t(js), tm.nu_t(ts)) <= EXACT


@pytest.mark.parametrize("wall_axes", [None, (False, True)])
def test_komega_ins_steps_match(wall_axes):
    n = 20
    jg, tg = _grids((n, n))
    jm = jt.KOmegaINS(jg, mu=1e-3, wall_axes=wall_axes, dtype=jnp.float64)
    tm = tt.KOmegaINS(tg, mu=1e-3, wall_axes=wall_axes, **T64)
    for m in (jm, tm):
        m._vc.cg_tol = 1e-10
    u0 = _taylor_green(n, 1.0, wall_axes)
    ji, jk = jm.initialize(tuple(map(jnp.asarray, u0)), k0=1e-3, omega0=2.0)
    ti, tk = tm.initialize(u0, k0=1e-3, omega0=2.0)
    jstep = jax.jit(lambda a, b: jm.step(a, b, 2e-3))
    for _ in range(3):
        ji, jk = jstep(ji, jk)
        ti, tk = tm.step(ti, tk, 2e-3)
    for a, b in zip(ji.u + (ji.p, jk.k, jk.omega),
                    ti.u + (ti.p, tk.k, tk.omega)):
        assert _rel(a, b) <= SOLVE


def test_channel_komega_matches_reference_run():
    """``tests/test_turbulence.py:148``'s channel (Re_tau 395, 80 cells,
    30,000 iterations) in both packages."""
    pj = jt.channel_komega(re_tau=395.0, n=80, iters=30000)
    pt = tt.channel_komega(re_tau=395.0, n=80, iters=30000, device="cpu")
    assert _rel(pj.y_plus, pt.y_plus) <= EXACT
    for a, b in zip(pj[1:], pt[1:]):
        assert _rel(a, b) <= 1e-10
    # the law of the wall, as the reference test pins it
    y, u = pt.y_plus.numpy(), pt.u_plus.numpy()
    sub = y < 3.0
    assert np.allclose(u[sub], y[sub], rtol=0.1)
    log = (y > 40) & (y < 200)
    assert np.max(np.abs(u[log] - (np.log(y[log]) / 0.41 + 5.0))) < 1.5
    assert math.isfinite(float(pt.nu_t_plus.max()))
