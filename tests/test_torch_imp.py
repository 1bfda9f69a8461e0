"""Port parity of the immersed material-point method
(``integrators/imp.py``) against ibamr_tpu at f64 on the CPU: the
elastic disc of ``tests/test_imp.py`` (32^2, a 0.15-radius disc of
BSPLINE_3 points, neo-Hookean mu = lam = 5, a 10% pre-stretch), 20 steps
from the same state: X and F within 1e-10 relative; and the neo-Hookean
stress and the seeded disc within 1e-13."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import imp as jimp
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import imp as timp
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _grids(n=32, dim=2):
    kw = dict(n=(n,) * dim, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    return JGrid(**kw), TGrid(**kw)


@pytest.mark.parametrize("dim", [2, 3])
def test_material_disc_and_pk1_match_reference(dim):
    jg, tg = _grids(16, dim)
    c = (0.5,) * dim
    jX, jV = jimp.material_disc(jg, c, 0.2, points_per_cell=2)
    tX, tV = timp.material_disc(tg, c, 0.2, points_per_cell=2,
                                device="cpu")
    assert _rel(jX, tX) == 0.0 and _rel(jV, tV) == 0.0
    rng = np.random.default_rng(dim)
    F = np.eye(dim) + 0.2 * rng.standard_normal((50, dim, dim))
    ref = jimp.NeoHookean(1.5, 2.5).pk1(jnp.asarray(F))
    got = timp.NeoHookean(1.5, 2.5).pk1(torch.tensor(F))
    assert _rel(ref, got) <= 1e-13


@pytest.mark.parametrize("scheme", ["midpoint", "forward_euler"])
def test_elastic_disc_matches_reference(scheme):
    jg, tg = _grids()
    X0, V0 = jimp.material_disc(jg, (0.5, 0.5), 0.15, points_per_cell=2)
    model = (5.0, 5.0)
    ji = jimp.IMPExplicitIntegrator(
        JINS(jg, mu=0.05, rho=1.0, dtype=jnp.float64),
        jimp.IMPMethod(V0, jimp.NeoHookean(*model)), scheme=scheme)
    ti = timp.IMPExplicitIntegrator(
        TINS(tg, mu=0.05, rho=1.0, dtype=torch.float64, device="cpu"),
        timp.IMPMethod(np.asarray(V0), timp.NeoHookean(*model),
                       device="cpu"), scheme=scheme)
    js = ji.initialize(X0)
    stretch = jnp.asarray([[1.1, 0.0], [0.0, 1.0]], dtype=js.F.dtype)
    js = jimp.IMPState(ins=js.ins, X=js.X, F=js.F @ stretch, mask=js.mask)
    ts = convert.imp_state(js, "cpu")
    jstep = jax.jit(lambda s: ji.step(s, 2e-3))
    for _ in range(20):
        js, ts = jstep(js), ti.step(ts, 2e-3)
    assert _rel(js.X, ts.X) <= 1e-10
    assert _rel(js.F, ts.F) <= 1e-10
    assert _rel(ji.jacobians(js), ti.jacobians(ts)) <= 1e-10
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) <= 1e-10
    assert float(torch.max(torch.abs(ts.ins.u[0]))) > 1e-4


def test_unknown_scheme_raises():
    _, tg = _grids(8)
    ins = TINS(tg, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="unknown IMP scheme"):
        timp.IMPExplicitIntegrator(ins, timp.IMPMethod(
            torch.ones(1), timp.NeoHookean(1.0, 1.0), device="cpu"),
            scheme="rk4")
