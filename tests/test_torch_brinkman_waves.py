"""Port parity of ``physics/brinkman.py`` and ``physics/waves.py`` against
ibamr_tpu at f64 on the CPU: the body SDFs and indicators, the implicit
penalty and its impulses, ``BrinkmanPenalization.step`` on the staggered
INS (fixed, prescribed-motion and free bodies), Stokes and irregular
wave theory, the relaxation zones and targets, and ``WaveTank`` steps on
the two-phase integrator (Brinkman slabs, a damping beach, the
conservative form). Set-ups follow ``tests/test_brinkman_waves.py`` on
smaller grids and a few steps. Explicit operators agree to 1e-12
relative (roundoff); steps through the spectral projection to 1e-10;
steps through the variable-density CG (``cg_tol`` 1e-10) to 1e-9."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.integrators import ins_vc as jvc
from ibamr_tpu.physics import brinkman as jb
from ibamr_tpu.physics import waves as jw
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS
from ibamr_tpu_torch.integrators import ins_vc as tvc
from ibamr_tpu_torch.physics import brinkman as tb
from ibamr_tpu_torch.physics import waves as tw

EXACT = 1e-12
SPECTRAL = 1e-10
SOLVE = 1e-9
J64 = dict(dtype=jnp.float64)
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
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _grids(n, x_up=None):
    x_up = x_up or (1.0,) * len(n)
    lo = (0.0,) * len(n)
    return JGrid(n=n, x_lo=lo, x_up=x_up), TGrid(n=n, x_lo=lo, x_up=x_up)


def _body_states(center, U=(0.0, 0.0), theta=0.0, omega=0.0):
    vals = dict(center=np.asarray(center, float), U=np.asarray(U, float),
                theta=np.asarray(theta), omega=np.asarray(omega))
    js = jb.RigidBodyState(**{k: jnp.asarray(v) for k, v in vals.items()})
    return js, convert.rigid_body_state(js, device="cpu")


# -- Brinkman -------------------------------------------------------------------

@pytest.mark.parametrize("dim", [2, 3])
def test_sdfs_match(dim):
    rng = np.random.default_rng(0)
    xb = [rng.uniform(-0.4, 0.4, (7, 5)) for _ in range(dim)]
    for mk, arg in ((jb.make_cylinder_sdf, 0.12),
                    (jb.make_box_sdf, (0.1, 0.2, 0.15)[:dim])):
        ref = mk(arg)([jnp.asarray(x) for x in xb])
        got = getattr(tb, mk.__name__)(arg)([torch.tensor(x) for x in xb])
        assert _rel(ref, got) <= EXACT


def test_penalize_matches():
    """Two bodies, one translating and spinning: the clamped velocity,
    the momentum impulses and the torque impulse."""
    jg, tg = _grids((24, 20))
    bodies_j = [jb.BrinkmanBody(jb.make_cylinder_sdf(0.12), eta=1e-3),
                jb.BrinkmanBody(jb.make_box_sdf((0.1, 0.05)), eta=5e-3,
                                smear_cells=1.5)]
    bodies_t = [tb.BrinkmanBody(tb.make_cylinder_sdf(0.12), eta=1e-3),
                tb.BrinkmanBody(tb.make_box_sdf((0.1, 0.05)), eta=5e-3,
                                smear_cells=1.5)]
    s1 = _body_states((0.3, 0.4), U=(0.2, -0.1), theta=0.3, omega=1.5)
    s2 = _body_states((0.7, 0.6), theta=0.7)
    u = tuple(np.random.default_rng(s).standard_normal((24, 20))
              for s in (1, 2))
    uj, ij = jb.penalize(tuple(map(jnp.asarray, u)), jg, 2e-3, bodies_j,
                         [s1[0], s2[0]])
    ut, it = tb.penalize(tuple(map(torch.tensor, u)), tg, 2e-3, bodies_t,
                         [s1[1], s2[1]])
    for a, b in zip(uj, ut):
        assert _rel(a, b) <= EXACT
    for (pj, lj), (pt, lt) in zip(ij, it):
        assert _rel(pj, pt) <= EXACT and _rel(lj, lt) <= EXACT
    assert _rel(bodies_j[0].chi(jg, 1, s1[0]),
                bodies_t[0].chi(tg, 1, s1[1])) <= EXACT


@pytest.mark.parametrize("kind", ["fixed", "prescribed", "free"])
def test_brinkman_penalization_steps_match(kind):
    n = (24, 24)
    jg, tg = _grids(n)
    ji = JINS(jg, mu=0.05, rho=1.0, dtype=jnp.float64)
    ti = TINS(tg, mu=0.05, rho=1.0, dtype=torch.float64, device="cpu")
    r = 0.12
    kw, grav, f = {}, None, None
    if kind == "free":
        kw = dict(density=3.0, volume=math.pi * r * r, moment=0.002)
        grav = [0.0, -1.0]
    bj = jb.BrinkmanBody(jb.make_cylinder_sdf(r), eta=1e-3, **kw)
    bt = tb.BrinkmanBody(tb.make_cylinder_sdf(r), eta=1e-3, **kw)
    pj = jb.BrinkmanPenalization(ji, [bj], gravity=grav)
    pt = tb.BrinkmanPenalization(ti, [bt], gravity=grav)
    U = (0.25, 0.0) if kind == "prescribed" else (0.0, 0.0)
    sj, st_ = _body_states((0.5, 0.6), U=U, omega=0.5)
    if kind == "fixed":
        f = tuple(np.stack([0.2 * np.ones(n), np.zeros(n)]))
    js, ts = ji.initialize(), ti.initialize()
    bsj, bst = [sj], [st_]
    for _ in range(3):
        js, bsj, impj = pj.step(js, bsj, 2e-3, f=None if f is None else
                                tuple(map(jnp.asarray, f)))
        ts, bst, impt = pt.step(ts, bst, 2e-3, f=None if f is None else
                                tuple(map(torch.tensor, f)))
    for a, b in zip(js.u, ts.u):
        assert _rel(a, b) <= SPECTRAL
    for a, b in zip(bsj[0], bst[0]):
        assert _rel(a, b) <= SPECTRAL
    assert _rel(impj[0][0], impt[0][0]) <= SPECTRAL


# -- waves ----------------------------------------------------------------------

@pytest.mark.parametrize("order", [1, 2])
def test_stokes_wave_matches(order):
    kw = dict(amplitude=0.02, wavelength=1.0, depth=0.25,
              still_level=0.25, gravity=1.0, order=order, phase=0.3)
    wj, wt = jw.StokesWave(**kw), tw.StokesWave(**kw)
    assert wj.k == wt.k and wj.omega == wt.omega
    rng = np.random.default_rng(3)
    x, z = rng.uniform(0, 2, (9, 7)), rng.uniform(-0.1, 0.6, (9, 7))
    soft = 0.37
    wjs = wj.scaled(jnp.asarray(soft))
    wts = wt.scaled(torch.tensor(soft, dtype=torch.float64))
    for a, b in ((wj, wt), (wjs, wts)):
        assert _rel(a.elevation(jnp.asarray(x), 0.7),
                    b.elevation(torch.tensor(x), 0.7)) <= EXACT
        for c in (0, 1):
            assert _rel(a.velocity(jnp.asarray(x), jnp.asarray(z), 0.7, c),
                        b.velocity(torch.tensor(x), torch.tensor(z), 0.7,
                                   c)) <= EXACT


def test_irregular_sea_matches():
    kw = dict(depth=0.25, still_level=0.31, gravity=1.0)
    vals = ([0.01, 0.005, 0.002], [1.0, 0.6, 0.4], [0.0, 1.0, 2.5])
    sj = jw.IrregularSea(*map(jnp.asarray, vals), **kw)
    st = tw.IrregularSea(*map(np.asarray, vals), **kw)
    assert sj.omega == st.omega
    x = np.linspace(0.0, 2.0, 41)
    z = np.linspace(0.0, 0.5, 41)
    for a, b in ((sj, st), (sj.scaled(0.5), st.scaled(0.5))):
        assert _rel(a.elevation(jnp.asarray(x), 0.7),
                    b.elevation(torch.tensor(x), 0.7)) <= EXACT
        for c in (0, 1):
            assert _rel(a.velocity(jnp.asarray(x), jnp.asarray(z), 0.7, c),
                        b.velocity(torch.tensor(x), torch.tensor(z), 0.7,
                                   c)) <= EXACT


def test_zones_and_targets_match():
    jg, tg = _grids((32, 12), (2.0, 0.75))
    for args in ((0.0, 0.6, "generation", "lo", 1.0),
                 (1.3, 2.0, "damping", "hi", 0.5)):
        zj = jw.make_zone(jg, *args, **J64)
        zt = tw.make_zone(tg, *args, **T64)
        assert zj.kind == zt.kind
        for a, b in zip((zj.w_cc,) + zj.w_face, (zt.w_cc,) + zt.w_face):
            assert _rel(a, b) <= EXACT
    wave = dict(amplitude=0.02, wavelength=1.0, depth=0.3, still_level=0.3,
                gravity=1.0)
    pj, uj = jw.wave_targets(jg, jw.StokesWave(**wave), 0.4, **J64)
    pt, ut = tw.wave_targets(tg, tw.StokesWave(**wave), 0.4, **T64)
    for a, b in zip((pj,) + uj, (pt,) + ut):
        assert _rel(a, b) <= EXACT
    sj, st = jw.still_targets(jg, 0.3, **J64), tw.still_targets(tg, 0.3,
                                                                  **T64)
    assert _rel(sj[0], st[0]) <= EXACT
    phi = np.random.default_rng(4).standard_normal((32, 12))
    u = tuple(np.random.default_rng(s).standard_normal((32, 12))
              for s in (5, 6))
    aj = jw.apply_zone(jnp.asarray(phi), tuple(map(jnp.asarray, u)), zj,
                       pj, uj)
    at = tw.apply_zone(torch.tensor(phi), tuple(map(torch.tensor, u)), zt,
                       pt, ut)
    assert _rel(aj[0], at[0]) <= EXACT
    for a, b in zip(aj[1], at[1]):
        assert _rel(a, b) <= EXACT


@pytest.mark.parametrize("cons", [False, True])
def test_wave_tank_steps_match(cons):
    """The irregular-sea tank of ``tests/test_brinkman_waves.py:285`` at
    f64 on 32x12 (floor, lid and end-wall slabs, a generation zone and a
    damping beach), 3 steps; the conservative form relaxes its density
    with the zones."""
    n, x_up = (32, 12), (1.28, 0.48)
    jg, tg = _grids(n, x_up)
    kw = dict(rho0=1.0, rho1=1e-2, mu0=1e-4, mu1=1e-4, gravity=[0.0, -1.0],
              reinit_interval=0, precond="mg", cg_tol=1e-10)
    jc = jvc.INSVCConservativeIntegrator if cons \
        else jvc.INSVCStaggeredIntegrator
    tc = tvc.INSVCConservativeIntegrator if cons \
        else tvc.INSVCStaggeredIntegrator
    ji, ti = jc(jg, **J64, **kw), tc(tg, **T64, **kw)
    vals = ([0.01, 0.005], [0.6, 0.4], [0.0, 1.0])
    sea_kw = dict(depth=0.2, still_level=0.25, gravity=1.0)
    seaj = jw.IrregularSea(*map(jnp.asarray, vals), **sea_kw)
    seat = tw.IrregularSea(*map(np.asarray, vals), **sea_kw)
    tank_kw = dict(floor=0.05, lid=0.05, end_wall=0.08, ramp_time=0.01)
    tj = jw.WaveTank(ji, seaj, jw.make_zone(jg, 0.04, 0.3, "generation",
                                            "lo", **J64),
                     jw.make_zone(jg, 0.9, 1.18, "damping", "hi", **J64),
                     **tank_kw)
    tt = tw.WaveTank(ti, seat, tw.make_zone(tg, 0.04, 0.3, "generation",
                                            "lo", **T64),
                     tw.make_zone(tg, 0.9, 1.18, "damping", "hi", **T64),
                     **tank_kw)
    zc = jw.cell_coords(jg, jnp.float64)[1] - 0.25
    js = ji.initialize(zc)
    ts = ti.initialize(np.asarray(zc))

    def body(s, _):
        return tj.step(s, 2e-3), None

    js, _ = jax.lax.scan(body, js, None, length=3)
    for _ in range(3):
        ts = tt.step(ts, 2e-3)
    names = ("u", "p", "phi") + (("rho",) if cons else ())
    for nm in names:
        a, b = getattr(js, nm), getattr(ts, nm)
        for x, y in (zip(a, b) if isinstance(a, tuple) else [(a, b)]):
            assert _rel(x, y) <= SOLVE, nm
    assert abs(float(tj.elevation_probe(js, 10))
               - float(tt.elevation_probe(ts, 10))) <= EXACT
