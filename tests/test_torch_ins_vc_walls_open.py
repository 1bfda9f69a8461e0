"""Port parity of ``integrators/ins_vc.py``'s bounded tanks against
ibamr_tpu at f64 on the CPU: no-slip walls on one or all axes (2D and
3D, both forms), a moving lid's tangential wall velocity, and the open
outlet (wall -> outlet on axis 0, gravity referenced to the still
profile), each a few steps at the reference tests' set-ups
(``tests/test_ins_vc_walls.py``, ``test_vc_open.py``) on smaller grids.
Fields through CG at ``cg_tol`` 1e-10 agree to 1e-9 relative; the
open tank's still water stays quiescent in both."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ins_vc as jvc
from ibamr_tpu.physics import waves as jwaves
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ins_vc as tvc
from ibamr_tpu_torch.physics import waves as twaves

SOLVE = 1e-9


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


def _pair(n, kw, x_up=None, cons=False):
    x_up = x_up or (1.0,) * len(n)
    jg = JGrid(n=n, x_lo=(0.0,) * len(n), x_up=x_up)
    tg = TGrid(n=n, x_lo=(0.0,) * len(n), x_up=x_up)
    jc = jvc.INSVCConservativeIntegrator if cons \
        else jvc.INSVCStaggeredIntegrator
    tc = tvc.INSVCConservativeIntegrator if cons \
        else tvc.INSVCStaggeredIntegrator
    return (jc(jg, dtype=jnp.float64, **kw),
            tc(tg, dtype=torch.float64, device="cpu", **kw))


def _coords(n, x_up):
    return np.meshgrid(*[(np.arange(m) + 0.5) * (L / m)
                         for m, L in zip(n, x_up)], indexing="ij")


def _check(js, ts, names=("u", "p", "phi")):
    for nm in names:
        a, b = getattr(js, nm), getattr(ts, nm)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert _rel(x, y) <= SOLVE, nm


def _steps(ji, ti, phi, dt, steps, u0=None):
    js = ji.initialize(jnp.asarray(phi),
                       None if u0 is None else tuple(map(jnp.asarray, u0)))
    ts = ti.initialize(phi, u0)
    return (jvc.advance_vc(ji, js, dt, steps),
            tvc.advance_vc(ti, ts, dt, steps))


@pytest.mark.parametrize("walls", [(True, True), (False, True)])
def test_walled_drop_matches(walls):
    """A heavy drop with surface tension in a closed (or channel) tank,
    reinitialized on the wall-aware stencils at step 4."""
    n, x_up = (24, 20), (1.0, 0.8)
    X, Y = _coords(n, x_up)
    phi = 0.15 - np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2)
    kw = dict(rho0=1.0, rho1=1000.0, mu0=0.01, mu1=0.1, sigma=0.5,
              gravity=(0.0, -1.0), cg_tol=1e-10, wall_axes=walls,
              reinit_interval=4)
    ji, ti = _pair(n, kw, x_up)
    js, ts = _steps(ji, ti, phi, 2e-4, 4)
    _check(js, ts)
    for d in range(2):
        if walls[d]:
            assert float(torch.max(torch.abs(ts.u[d].select(d, 0)))) == 0.0


def test_moving_lid_matches():
    """A tangential wall velocity on the lid (component 0, hi wall of
    axis 1) enters the viscous wall shear and the convective ghosts."""
    n = (20, 16)
    X, Y = _coords(n, (1.0, 1.0))
    phi = 0.4 - Y
    kw = dict(rho0=1.0, rho1=20.0, mu0=0.05, mu1=0.1,
              gravity=(0.0, -1.0), cg_tol=1e-10, wall_axes=(True, True),
              tangential={(0, 1, 1): 0.5}, convective_op_type="centered")
    ji, ti = _pair(n, kw)
    js, ts = _steps(ji, ti, phi, 1e-3, 4)
    _check(js, ts)
    assert float(torch.max(torch.abs(ts.u[0]))) > 1e-3


def test_conservative_walled_matches():
    n = (20, 20)
    X, Y = _coords(n, (1.0, 1.0))
    phi = 0.12 - np.sqrt((X - 0.5) ** 2 + (Y - 0.6) ** 2)
    kw = dict(rho0=1.0, rho1=20.0, mu0=0.01, mu1=0.02, cg_tol=1e-10,
              gravity=(0.0, -2.0), wall_axes=(True, True))
    ji, ti = _pair(n, kw, cons=True)
    js, ts = _steps(ji, ti, phi, 1e-3, 3)
    _check(js, ts, ("u", "p", "phi", "rho"))


def test_3d_walled_drop_matches():
    """The 3D closed tank of ``tests/test_ins_vc_walls.py:260`` on 12^3,
    three steps."""
    n = (12, 12, 12)
    X, Y, Z = _coords(n, (1.0,) * 3)
    phi = 0.2 - np.sqrt((X - 0.5) ** 2 + (Y - 0.5) ** 2 + (Z - 0.6) ** 2)
    kw = dict(rho0=1.0, rho1=10.0, mu0=0.01, mu1=0.02,
              gravity=(0.0, 0.0, -5.0), convective_op_type="upwind",
              reinit_interval=3, cg_tol=1e-10,
              wall_axes=(True, True, True))
    ji, ti = _pair(n, kw)
    js, ts = _steps(ji, ti, phi, 1e-3, 3)
    _check(js, ts)


def _tank(n=(32, 16), L=1.5, H=1.0, still=0.5):
    kw = dict(rho0=100.0, rho1=1.0, mu0=1e-3, mu1=1e-5,
              gravity=(0.0, -9.81), wall_axes=(False, True),
              open_outlet=True, still_level=still, cg_tol=1e-10)
    ji, ti = _pair(n, kw, (L, H))
    zc = (np.arange(n[1]) + 0.5) * (H / n[1])
    phi = np.broadcast_to((zc - still)[None, :], n).copy()
    return ji, ti, phi


def test_open_outlet_still_water_stays_quiescent():
    ji, ti, phi = _tank()
    js, ts = _steps(ji, ti, phi, 1e-3, 5)
    assert max(float(torch.max(torch.abs(c))) for c in ts.u) < 1e-10
    assert max(float(jnp.max(jnp.abs(c))) for c in js.u) < 1e-10


def test_open_outlet_throughflow_matches():
    """A current through the outlet face (slot 0 of u_0) and a tilted
    surface: the outlet's half-cell coefficient, the mixed Neumann /
    Dirichlet multigrid and the zero-gradient outlet seed."""
    ji, ti, phi = _tank()
    n = phi.shape
    X, Y = _coords(n, (1.5, 1.0))
    phi = phi + 0.02 * np.cos(2.0 * np.pi * X / 1.5)
    u0 = (0.05 * (phi < 0), np.zeros(n))
    js, ts = _steps(ji, ti, phi, 2e-3, 4, u0=u0)
    _check(js, ts)
    assert abs(float(ts.u[0][0, 4])) > 1e-3


def test_open_outlet_wave_zones_match():
    """One wave-train step of ``tests/test_vc_open.py:115`` (generation
    and damping zones blended after the integrator step)."""
    n, L, H, still = (48, 16), 3.0, 1.0, 0.5
    kw = dict(rho0=100.0, rho1=1.0, mu0=1e-3, mu1=1e-5,
              gravity=(0.0, -9.81), wall_axes=(False, True),
              open_outlet=True, still_level=still, cg_tol=1e-10)
    ji, ti = _pair(n, kw, (L, H))
    jg, tg = ji.grid, ti.grid
    kw64 = dict(dtype=jnp.float64)
    tkw = dict(dtype=torch.float64, device="cpu")
    wj = jwaves.StokesWave(amplitude=0.02, wavelength=1.0,
                           still_level=still, depth=still)
    wt = twaves.StokesWave(amplitude=0.02, wavelength=1.0,
                           still_level=still, depth=still)
    zones = [(jwaves.make_zone(jg, 0.0, 0.8, "generation", "lo", **kw64),
              twaves.make_zone(tg, 0.0, 0.8, "generation", "lo", **tkw)),
             (jwaves.make_zone(jg, 2.2, 3.0, "damping", "hi", **kw64),
              twaves.make_zone(tg, 2.2, 3.0, "damping", "hi", **tkw))]
    zc = (np.arange(n[1]) + 0.5) / n[1]
    phi = np.broadcast_to((zc - still)[None, :], n).copy()
    sj = jwaves.still_targets(jg, still, **kw64)
    st_ = twaves.still_targets(tg, still, **tkw)

    def jbody(s, _):
        s = ji.step(s, 2.5e-3)
        pj, uj = jwaves.wave_targets(jg, wj, s.t, **kw64)
        phj, usj = jwaves.apply_zone(s.phi, s.u, zones[0][0], pj, uj)
        phj, usj = jwaves.apply_zone(phj, usj, zones[1][0], *sj)
        return s._replace(phi=phj, u=usj), None

    js, _ = jax.lax.scan(jbody, ji.initialize(jnp.asarray(phi)), None,
                         length=3)
    ts = ti.initialize(phi)
    for _ in range(3):
        ts = ti.step(ts, 2.5e-3)
        pt, ut = twaves.wave_targets(tg, wt, ts.t, **tkw)
        pht, ust = twaves.apply_zone(ts.phi, ts.u, zones[0][1], pt, ut)
        pht, ust = twaves.apply_zone(pht, ust, zones[1][1], *st_)
        ts = ts._replace(phi=pht, u=ust)
    _check(js, ts)


def test_constructor_rules_match():
    g = TGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    bad = [dict(precond="cg"), dict(wall_axes=(True, False), precond="fft"),
           dict(open_outlet=True, precond="fft"),
           dict(open_outlet=True, wall_axes=(True, False)),
           dict(open_outlet=True, gravity=(0.0, -1.0)),
           dict(open_outlet=True, gravity=(1.0, -1.0), still_level=0.5)]
    for kw in bad:
        with pytest.raises(ValueError):
            tvc.INSVCStaggeredIntegrator(g, device="cpu", **kw)
