"""Port parity of the walled and PPM/CUI INS integrator
(``integrators/ins.py`` with ``integrators/ins_walls.py``): a 16^2
lid-driven cavity under every convective operator, a walled Poiseuille
channel with a body force, the fully periodic PPM/CUI path, and a
divergence source through the walled projection, each against
ibamr_tpu at f64 on the CPU. The fields agree to 1e-11 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ins as jins
from ibamr_tpu.integrators import ins_walls as jw
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ins as tins
from ibamr_tpu_torch.integrators import ins_walls as tw

RTOL = 1e-11


def _pair(n, **kw):
    box = dict(n=n, x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
    return (jins.INSStaggeredIntegrator(JGrid(**box), dtype=jnp.float64,
                                        **kw),
            tins.INSStaggeredIntegrator(TGrid(**box), dtype=torch.float64,
                                        device="cpu", **kw))


def _close_state(js, ts, rtol=RTOL):
    for a, b in zip(js.u + (js.p,), ts.u + (ts.p,)):
        a = np.asarray(a)
        assert np.max(np.abs(b.numpy() - a)) <= rtol * np.max(np.abs(a))
    assert int(ts.k) == int(js.k)


def _run(ji, ti, steps, dt, f=None, q=None):
    jf = None if f is None else tuple(map(jnp.asarray, f))
    tf = None if f is None else tuple(map(torch.tensor, f))
    js = jax.jit(lambda s: jins.advance(ji, s, dt, steps, f=jf,
                                        q=None if q is None
                                        else jnp.asarray(q)))(ji.initialize())
    ts = tins.advance(ti, ti.initialize(), dt, steps, f=tf,
                      q=None if q is None else torch.tensor(q))
    return js, ts


@pytest.mark.parametrize("op", ["ppm", "cui", "centered", "upwind", "none"])
def test_lid_driven_cavity_matches_reference(op):
    ji, ti = _pair((16, 16), mu=0.01, convective_op_type=op,
                   wall_axes=(True, True), wall_tangential={(0, 1, 1): 1.0})
    js, ts = _run(ji, ti, 20, 0.01)
    _close_state(js, ts)
    assert float(ti.max_divergence(ts)) < 1e-12
    # the pinned wall faces stay zero
    assert float(ts.u[0][0].abs().max()) == 0.0
    assert float(ts.u[1][:, 0].abs().max()) == 0.0


def test_walled_poiseuille_matches_reference():
    ji, ti = _pair((16, 16), mu=0.1, convective_op_type="ppm",
                   wall_axes=(False, True))
    f = (np.full((16, 16), 1.0), np.zeros((16, 16)))
    js, ts = _run(ji, ti, 100, 2e-3, f=f)
    _close_state(js, ts)
    # a parabola develops across the walls, symmetric about the middle
    prof = ts.u[0][0].numpy()
    assert prof.max() > 3 * prof[0] > 0
    np.testing.assert_allclose(prof, prof[::-1], rtol=1e-10)


@pytest.mark.parametrize("op", ["ppm", "cui"])
def test_periodic_ppm_and_cui_match_reference(op):
    ji, ti = _pair((12, 10), mu=0.02, convective_op_type=op)
    rng = np.random.default_rng(3)
    u0 = [rng.standard_normal((12, 10)) for _ in range(2)]
    js = ji.initialize(u0_arrays=tuple(map(jnp.asarray, u0)))
    ts = ti.initialize(u0_arrays=tuple(map(torch.tensor, u0)))
    js = jax.jit(lambda s: jins.advance(ji, s, 2e-3, 10))(js)
    ts = tins.advance(ti, ts, 2e-3, 10)
    assert ti.fused_stokes is not None
    _close_state(js, ts, 1e-10)


def test_divergence_source_through_the_wall_projection():
    ji, ti = _pair((12, 12), mu=0.05, convective_op_type="centered",
                   wall_axes=(True, False))
    q = np.random.default_rng(4).standard_normal((12, 12))
    js, ts = _run(ji, ti, 5, 5e-3, q=q)
    _close_state(js, ts)
    from ibamr_tpu_torch.ops import stencils

    div = stencils.divergence(ts.u, ti.grid.dx)
    assert float(torch.max(torch.abs(div - (torch.tensor(q) - q.mean())))) \
        < 1e-10 * float(torch.max(torch.abs(div)))


def test_wall_ops_match_reference_and_validate():
    jg = JGrid(n=(10, 8), x_lo=(0.0, 0.0), x_up=(1.0, 0.8))
    tg = TGrid(n=(10, 8), x_lo=(0.0, 0.0), x_up=(1.0, 0.8))
    tang = {(1, 0, 0): 0.5, (0, 1, 1): -1.0}
    jo = jw.WallOps(jg, (True, True), tangential=tang)
    to = tw.WallOps(tg, (True, True), tangential=tang, device="cpu")
    rng = np.random.default_rng(5)
    u = [rng.standard_normal((10, 8)) for _ in range(2)]
    ju, tu = tuple(map(jnp.asarray, u)), tuple(map(torch.tensor, u))
    for a, b in zip(jo.laplacian_vel(ju, jg.dx), to.laplacian_vel(tu, tg.dx)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12 * np.max(np.abs(np.asarray(a))))
    for a, b in zip(jo.helmholtz_vel(ju, jg.dx, 100.0, -0.01),
                    to.helmholtz_vel(tu, tg.dx, 100.0, -0.01)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12 * np.max(np.abs(np.asarray(a))))
    (ja, jphi), (ta, tphi) = jo.project(ju, jg.dx), to.project(tu, tg.dx)
    for a, b in zip(ja + (jphi,), ta + (tphi,)):
        np.testing.assert_allclose(b.numpy(), np.asarray(a), rtol=0,
                                   atol=1e-12 * np.max(np.abs(np.asarray(a))))
    g = TGrid(n=(8, 8), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    with pytest.raises(ValueError, match="wall_tangential"):
        tins.INSStaggeredIntegrator(g, wall_axes=(True, False),
                                    wall_tangential={(0, 0, 1): 1.0},
                                    device="cpu")
    with pytest.raises(ValueError, match="spectral_dtype"):
        tins.INSStaggeredIntegrator(g, wall_axes=(True, False),
                                    spectral_dtype="bf16", device="cpu")
    with pytest.raises(ValueError, match="wall_axes"):
        tins.INSStaggeredIntegrator(g, wall_axes=(True,), device="cpu")


def test_state_carried_across_continues_like_reference():
    """A walled state converted from the reference (``convert.ins_state``)
    steps on in the port as the reference steps on."""
    ji, ti = _pair((12, 12), mu=0.01, convective_op_type="ppm",
                   wall_axes=(True, True), wall_tangential={(0, 1, 1): 1.0})
    js = jax.jit(lambda s: jins.advance(ji, s, 0.01, 5))(ji.initialize())
    ts = convert.ins_state(js, device="cpu")
    js = jax.jit(lambda s: jins.advance(ji, s, 0.01, 5))(js)
    ts = tins.advance(ti, ts, 0.01, 5)
    _close_state(js, ts)
