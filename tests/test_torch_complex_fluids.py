"""Port parity of ``physics/complex_fluids.py`` (Oldroyd-B) against
ibamr_tpu at f64 on the CPU: packing, the cell-centered velocity
gradient, the upper-convected source, the polymer stress and its MAC
divergence (periodic and walled), and ``OldroydB`` steps coupled to the
staggered INS through ``f=``. Inputs are seeded random fields (numpy).
Everything agrees to 1e-12 relative (roundoff); the coupled steps,
which pass through the spectral solve, to 1e-10."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.physics import complex_fluids as jcf
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS
from ibamr_tpu_torch.physics import complex_fluids as tcf

EXACT = 1e-12
WALLS = [None, (False, True)]


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


def _rand(shape, seed, scale=1.0):
    return scale * np.random.default_rng(seed).standard_normal(shape)


@pytest.mark.parametrize("dim", [2, 3])
def test_pack_unpack_identity_and_stress_match(dim):
    n = (6,) * dim
    jg, tg = _grids(n)
    C = _rand(n + (tcf.n_components(dim),), 1)
    Cf_j, Cf_t = jcf.unpack(jnp.asarray(C), dim), tcf.unpack(
        torch.tensor(C), dim)
    assert _rel(Cf_j, Cf_t) == 0.0
    assert _rel(jcf.pack(Cf_j), tcf.pack(Cf_t)) == 0.0
    assert _rel(jcf.identity_conformation(jg, jnp.float64),
                tcf.identity_conformation(tg, torch.float64, "cpu")) == 0.0
    assert _rel(jcf.polymer_stress(jnp.asarray(C), 0.3, 0.7, dim),
                tcf.polymer_stress(torch.tensor(C), 0.3, 0.7, dim)) <= EXACT


@pytest.mark.parametrize("wall_axes", WALLS)
def test_velocity_gradient_and_source_match(wall_axes):
    n = (16, 12)
    dx = (1.0 / 16, 1.0 / 12)
    u = tuple(_rand(n, s) for s in (2, 3))
    gj = jcf.velocity_gradient_cc(tuple(map(jnp.asarray, u)), dx,
                                  wall_axes=wall_axes)
    gt = tcf.velocity_gradient_cc(tuple(map(torch.tensor, u)), dx,
                                  wall_axes=wall_axes)
    assert _rel(gj, gt) <= EXACT
    C = 1.0 + _rand(n + (3,), 4, 0.1)
    assert _rel(jcf.oldroyd_b_source(jnp.asarray(C), gj, 0.5),
                tcf.oldroyd_b_source(torch.tensor(C), gt, 0.5)) <= EXACT


@pytest.mark.parametrize("wall_axes", WALLS + [(True, True, False)])
def test_stress_divergence_matches(wall_axes):
    dim = 3 if wall_axes is not None and len(wall_axes) == 3 else 2
    n = (12, 10, 8)[:dim]
    jg, tg = _grids(n)
    tau = _rand(n + (tcf.n_components(dim),), 5)
    for a, b in zip(jcf.stress_divergence_mac(jnp.asarray(tau), jg,
                                              wall_axes=wall_axes),
                    tcf.stress_divergence_mac(torch.tensor(tau), tg,
                                              wall_axes=wall_axes)):
        assert _rel(a, b) <= EXACT


@pytest.mark.parametrize("wall_axes", WALLS)
def test_oldroyd_b_step_and_body_force_match(wall_axes):
    n = (16, 16)
    jg, tg = _grids(n)
    jm = jcf.OldroydB(jg, mu_p=0.2, lam=0.5, wall_axes=wall_axes,
                      dtype=jnp.float64)
    tm = tcf.OldroydB(tg, mu_p=0.2, lam=0.5, wall_axes=wall_axes,
                      dtype=torch.float64, device="cpu")
    C = np.asarray(jm.initialize()) + _rand(n + (3,), 6, 0.05)
    u = tuple(_rand(n, s, 0.5) for s in (7, 8))
    if wall_axes is not None:
        u[1][:, 0] = 0.0
    Cj = jm.step(jnp.asarray(C), tuple(map(jnp.asarray, u)), 1e-3)
    Ct = tm.step(torch.tensor(C), tuple(map(torch.tensor, u)), 1e-3)
    assert _rel(Cj, Ct) <= EXACT
    for a, b in zip(jm.body_force(Cj), tm.body_force(Ct)):
        assert _rel(a, b) <= EXACT


def test_oldroyd_b_coupled_to_ins_matches():
    """Four steps of a sheared periodic Oldroyd-B fluid: the polymer body
    force enters the staggered INS step through ``f=``."""
    n = (16, 16)
    jg, tg = _grids(n)
    jm = jcf.OldroydB(jg, mu_p=0.1, lam=0.3, dtype=jnp.float64)
    tm = tcf.OldroydB(tg, mu_p=0.1, lam=0.3, dtype=torch.float64,
                      device="cpu")
    ji = JINS(jg, mu=0.05, dtype=jnp.float64)
    ti = TINS(tg, mu=0.05, dtype=torch.float64, device="cpu")
    y = (np.arange(16) + 0.5) / 16
    u0 = (np.broadcast_to(np.sin(2 * np.pi * y)[None, :], n).copy(),
          np.zeros(n))
    js = ji.initialize(u0_arrays=tuple(map(jnp.asarray, u0)))
    ts = ti.initialize(u0_arrays=u0)
    Cj, Ct = jm.initialize(), tm.initialize()
    for _ in range(4):
        js = ji.step(js, 2e-3, f=jm.body_force(Cj))
        ts = ti.step(ts, 2e-3, f=tm.body_force(Ct))
        Cj, Ct = jm.step(Cj, js.u, 2e-3), tm.step(Ct, ts.u, 2e-3)
    assert _rel(Cj, Ct) <= 1e-10
    for a, b in zip(js.u, ts.u):
        assert _rel(a, b) <= 1e-10
