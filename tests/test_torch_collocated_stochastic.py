"""Port parity of ``integrators/ins_collocated.py`` and
``ops/stochastic.py`` against ibamr_tpu at f64 on the CPU.

The collocated (cell-centered, approximate-projection) integrator: the
Taylor-Green vortex (centered and upwind, with and without a body
force) and the walled channel, a few steps each; fields agree to 1e-10
relative (through the FFT or fast-diagonalization solves).

Stochastic forcing: the reference draws with ``jax.random``, which torch
cannot reproduce, so the port maps unit normals to the stress and its
divergence in a helper of its own; fed the normals that the reference's
``sample(key, dt)`` draws (split and drawn here from the same keys),
it gives the reference's force to 1e-12 relative. The reference's
statistical tests (zero net momentum, variance scaling with dt,
equipartition scaling with kT, scalar conservation) run on the port's
own ``torch.Generator`` draws."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ins_collocated as jcol
from ibamr_tpu.ops import stochastic as jsto
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ins_collocated as tcol
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS
from ibamr_tpu_torch.ops import stochastic as tsto

EXACT = 1e-12
SPECTRAL = 1e-10
T64 = dict(dtype=torch.float64, device="cpu")
TWO_PI = 2.0 * math.pi


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


def _tg_cc(n):
    c = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(c, c, indexing="ij")
    return (np.sin(TWO_PI * X) * np.cos(TWO_PI * Y),
            -np.cos(TWO_PI * X) * np.sin(TWO_PI * Y))


@pytest.mark.parametrize("conv,forced", [("centered", False),
                                         ("upwind", True),
                                         ("none", False)])
def test_collocated_taylor_green_matches(conv, forced):
    n = 24
    jg, tg = _grids((n, n))
    ji = jcol.INSCollocatedIntegrator(jg, rho=1.0, mu=0.01,
                                      convective_op_type=conv,
                                      dtype=jnp.float64)
    ti = tcol.INSCollocatedIntegrator(tg, rho=1.0, mu=0.01,
                                      convective_op_type=conv, **T64)
    u0 = _tg_cc(n)
    f = (0.3 * u0[1], 0.2 * u0[0]) if forced else None
    js = ji.initialize(u0_arrays=tuple(map(jnp.asarray, u0)))
    ts = ti.initialize(u0_arrays=u0)
    js = jcol.advance_collocated(ji, js, 5e-3, 6, None if f is None else
                                 tuple(map(jnp.asarray, f)))
    ts = tcol.advance_collocated(ti, ts, 5e-3, 6, None if f is None else
                                 tuple(map(torch.tensor, f)))
    for a, b in zip(js.u, ts.u):
        assert _rel(a, b) <= SPECTRAL
    # without convection the vortex is an exact mode and p is roundoff:
    # compare it against a unit floor
    assert np.max(np.abs(np.asarray(js.p) - ts.p.numpy())) \
        <= SPECTRAL * max(float(np.max(np.abs(np.asarray(js.p)))), 1.0)
    assert ts.k == 6
    assert abs(float(ji.kinetic_energy(js)) - float(ti.kinetic_energy(ts))) \
        <= SPECTRAL * float(ji.kinetic_energy(js))
    assert abs(float(ji.max_divergence(js))
               - float(ti.max_divergence(ts))) <= 1e-9


def test_collocated_callable_initial_state_matches():
    n = 16
    jg, tg = _grids((n, n))
    ji = jcol.INSCollocatedIntegrator(jg, dtype=jnp.float64)
    ti = tcol.INSCollocatedIntegrator(tg, **T64)
    fj = [lambda c, t: jnp.sin(TWO_PI * c[0]) * jnp.cos(TWO_PI * c[1]),
          lambda c, t: 0.5 + 0 * c[0]]
    ft = [lambda c, t: torch.sin(TWO_PI * c[0]) * torch.cos(TWO_PI * c[1]),
          lambda c, t: 0.5 + 0 * c[0]]
    for a, b in zip(ji.initialize(u0=fj).u, ti.initialize(u0=ft).u):
        assert _rel(a, b) <= EXACT


@pytest.mark.parametrize("conv", ["centered", "upwind"])
def test_collocated_walled_channel_matches(conv):
    """The walled channel of ``tests/test_collocated_stochastic.py:169``
    with a convecting perturbation, a few steps; a state carried over
    from the reference continues identically."""
    n = 20
    jg, tg = _grids((n, n))
    kw = dict(mu=0.02, wall_axes=(False, True), convective_op_type=conv)
    ji = jcol.INSCollocatedIntegrator(jg, dtype=jnp.float64, **kw)
    ti = tcol.INSCollocatedIntegrator(tg, **T64, **kw)
    y = (np.arange(n) + 0.5) / n
    u0 = (np.broadcast_to(np.sin(np.pi * y)[None, :], (n, n)).copy(),
          0.1 * _tg_cc(n)[1])
    js = jcol.advance_collocated(ji, ji.initialize(
        u0_arrays=tuple(map(jnp.asarray, u0))), 2e-3, 3)
    ts = convert.collocated_ins_state(
        jax.tree_util.tree_map(np.asarray, js), device="cpu")
    js = jcol.advance_collocated(ji, js, 2e-3, 3)
    ts = tcol.advance_collocated(ti, ts, 2e-3, 3)
    for a, b in zip(js.u + (js.p,), ts.u + (ts.p,)):
        assert _rel(a, b) <= SPECTRAL


def _reference_normals(key, count, n):
    keys = jax.random.split(key, count)
    return [torch.tensor(np.asarray(jax.random.normal(keys[i], n,
                                                      dtype=jnp.float64)))
            for i in range(count)]


@pytest.mark.parametrize("n", [(24, 20), (8, 10, 12)])
def test_stress_forcing_from_reference_normals_matches(n):
    jg, tg = _grids(n)
    jf = jsto.StochasticStressForcing(jg, mu=0.1, kT=2.0, dtype=jnp.float64)
    tf = tsto.StochasticStressForcing(tg, mu=0.1, kT=2.0, **T64)
    key = jax.random.PRNGKey(7)
    Z = _reference_normals(key, tf.n_draws, n)
    for a, b in zip(jf.sample(key, 1e-3), tf.force_from_normals(Z, 1e-3)):
        assert _rel(a, b) <= EXACT
    dj, oj = jf.sample_stress(key, 1e-3)
    dt_, ot = tf.stress_from_normals(Z, 1e-3)
    for a, b in zip(dj, dt_):
        assert _rel(a, b) <= EXACT
    assert sorted(oj) == sorted(ot)
    for ij in oj:
        assert _rel(oj[ij], ot[ij]) <= EXACT


def test_flux_forcing_from_reference_normals_matches():
    jg, tg = _grids((32, 24))
    jf = jsto.StochasticFluxForcing(jg, kappa=0.01, Q_ref=2.0,
                                    dtype=jnp.float64)
    tf = tsto.StochasticFluxForcing(tg, kappa=0.01, Q_ref=2.0, **T64)
    key = jax.random.PRNGKey(2)
    Z = _reference_normals(key, 2, (32, 24))
    assert _rel(jf.sample(key, 1e-3), tf.source_from_normals(Z, 1e-3)) \
        <= EXACT


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def test_port_draws_inject_zero_net_momentum_and_scale_with_dt():
    for n in ((32, 32), (12, 12, 12)):
        tg = TGrid(n=n, x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
        f = tsto.StochasticStressForcing(tg, mu=0.1, kT=2.0, **T64)
        for comp in f.sample(_gen(0), dt=1e-3):
            assert abs(float(torch.sum(comp))) < 1e-8
            assert float(torch.std(comp)) > 0.0
    tg = TGrid(n=(64, 64), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    f = tsto.StochasticStressForcing(tg, mu=0.1, kT=1.0, **T64)
    v1 = float(torch.var(f.sample(_gen(1), dt=1e-3)[0]))
    v2 = float(torch.var(f.sample(_gen(1), dt=4e-3)[0]))
    assert abs(v1 / v2 - 4.0) < 1e-6
    flux = tsto.StochasticFluxForcing(tg, kappa=0.01, **T64)
    dq = flux.sample(_gen(2), dt=1e-3)
    assert abs(float(torch.sum(dq))) < 1e-8 and float(torch.std(dq)) > 0.0


def test_port_draws_equipartition_scales_with_kT():
    """Thermal steady-state kinetic energy scales linearly with kT (the
    reference's 300-step run at 32^2, on the port's draws)."""
    tg = TGrid(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ins = TINS(tg, rho=1.0, mu=0.1, convective_op_type="none", **T64)
    dt, steps = 2e-3, 300

    def run(kT, seed):
        forcing = tsto.StochasticStressForcing(tg, mu=ins.mu, kT=kT, **T64)
        gen, st, kes = _gen(seed), ins.initialize(), []
        for _ in range(steps):
            st = ins.step(st, dt, f=forcing.sample(gen, dt))
            kes.append(0.5 * sum(float(torch.sum(c * c)) for c in st.u)
                       * tg.cell_volume)
        return float(np.mean(kes[steps // 2:]))

    ke1, ke4 = run(1.0, 0), run(4.0, 1)
    assert ke1 > 0.0
    assert 2.5 < ke4 / ke1 < 6.0
