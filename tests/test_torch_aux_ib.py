"""Port parity of the penalty IB (``integrators/penalty_ib.py``) and the
instruments (``instruments.py``) against ibamr_tpu at f64 on the CPU, on
the set-ups of ``tests/test_aux_ib.py``: the massive and the massless
membranes (markers, mass points and their velocities within 1e-10
relative), the 2D and 3D meter panels with padded meters and the
structure-table meters (within 1e-12), and the control-volume momentum
budget of ``HydrodynamicForceEvaluator`` on the Taylor-Green vortex
(within 1e-12)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import instruments as jinst
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import penalty_ib as jpen
from ibamr_tpu.integrators.ib import IBMethod as JIB
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.io.structures import StructureData as JData
from ibamr_tpu.models.membrane2d import make_circle_membrane as jmembrane
from ibamr_tpu_torch import convert
from ibamr_tpu_torch import instruments as tinst
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import penalty_ib as tpen
from ibamr_tpu_torch.integrators.ib import IBMethod as TIB
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS
from ibamr_tpu_torch.io.structures import StructureData as TData
from ibamr_tpu_torch.models.membrane2d import make_circle_membrane as tmembrane


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


def _grids(n, dim=2):
    kw = dict(n=(n,) * dim, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    return JGrid(**kw), TGrid(**kw)


@pytest.mark.parametrize("case", ["massive", "massless"])
def test_penalty_membrane_matches_reference(case):
    n_grid, num, mass, g, steps = {
        "massive": (48, 48, 0.05, -1.0, 20),
        "massless": (32, 32, 0.0, -5.0, 20)}[case]
    jg, tg = _grids(n_grid)
    args = (num, 0.12, (0.5, 0.6))
    kw = dict(stiffness=2.0, rest_length_factor=1.0)
    js_, ts_ = jmembrane(*args, **kw), tmembrane(*args, **kw)
    masses = np.full(num, mass)
    masses[::7] = 0.0 if case == "massive" else masses[::7]
    ji = jpen.PenaltyIBIntegrator(
        JINS(jg, rho=1.0, mu=0.1, convective_op_type="none",
             dtype=jnp.float64),
        JIB(js_.force_specs(dtype=jnp.float64)), mass=masses,
        stiffness=200.0, gravity=(0.0, g))
    ti = tpen.PenaltyIBIntegrator(
        TINS(tg, rho=1.0, mu=0.1, convective_op_type="none",
             dtype=torch.float64, device="cpu"),
        TIB(ts_.force_specs(dtype=torch.float64, device="cpu")),
        mass=masses, stiffness=200.0, gravity=(0.0, g))
    jst = ji.initialize(js_.vertices)
    tst = convert.penalty_ib_state(jst, "cpu")
    jstep = jax.jit(lambda s: ji.step(s, 1e-3))
    for _ in range(steps):
        jst, tst = jstep(jst), ti.step(tst, 1e-3)
    assert _rel(jst.ib.X, tst.ib.X) <= 1e-10
    assert _rel(jst.Y, tst.Y) <= 1e-10
    if case == "massive":
        assert _rel(jst.V, tst.V) <= 1e-10
        assert float(tst.ib.X[:, 1].mean()) < float(np.mean(
            ts_.vertices[:, 1]))
    else:
        assert float(torch.max(torch.abs(tst.V))) == 0.0


def test_mass_arrays_match_reference():
    verts = np.zeros((6, 2))
    masses = np.array([[1, 0.5, 30.0], [4, 0.25, 10.0]])
    ref = JData(name="m", vertices=verts, masses=masses).mass_arrays()
    got = TData(name="m", vertices=verts, masses=masses).mass_arrays()
    for a, b in zip(ref, got):
        assert np.array_equal(a, b)
    assert TData(name="m", vertices=verts).mass_arrays() is None


def _panel(jg, tg, loops, closed):
    jm = jinst.make_meters(loops, closed=closed, dtype=jnp.float64)
    tm = tinst.make_meters(loops, closed=closed, dtype=torch.float64,
                           device="cpu")
    for a, b in zip(jm, tm):
        assert np.array_equal(np.asarray(a), b.numpy())
    for a, b in zip(jm, convert.meter_specs(jm, "cpu")):
        assert np.array_equal(np.asarray(a), b.numpy())
    return jinst.InstrumentPanel(jg, jm), tinst.InstrumentPanel(tg, tm)


def _check(jp, tp, u, p, X):
    ref = jp.readings(tuple(jnp.asarray(c) for c in u), jnp.asarray(p),
                      jnp.asarray(X))
    got = tp.readings(tuple(torch.tensor(c) for c in u), torch.tensor(p),
                      torch.tensor(X))
    for k in ("flux", "mean_pressure"):
        assert _rel(ref[k], got[k]) <= 1e-12
    return got


def test_panel_2d_padded_meters_match_reference():
    jg, tg = _grids(32)
    rng = np.random.default_rng(0)
    ys1, ys2 = np.linspace(0.2, 0.8, 13), np.linspace(0.4, 0.6, 5)
    X0 = np.concatenate([np.stack([np.full(13, 0.3), ys1], axis=1),
                         np.stack([np.full(5, 0.7), ys2], axis=1)])
    jp, tp = _panel(jg, tg, [list(range(13)), list(range(13, 18))],
                    [False, True])
    u = [1.0 + 0.1 * rng.standard_normal(tg.n) for _ in range(2)]
    _check(jp, tp, u, rng.standard_normal(tg.n),
           X0 + 0.01 * rng.standard_normal(X0.shape))
    got = _check(jp, tp, [np.full(tg.n, 1.0), np.zeros(tg.n)],
                 np.zeros(tg.n), X0)
    assert abs(float(got["flux"][0]) - 0.6) < 1e-5


def test_panel_3d_matches_reference():
    jg, tg = _grids(16, 3)
    r, m = 0.2, 24
    th = 2 * np.pi * np.arange(m) / m
    X = np.stack([np.full(m, 0.5), 0.5 + r * np.cos(th),
                  0.5 + r * np.sin(th)], axis=1)
    X = np.concatenate([X, X[:10] + [0.1, 0.0, 0.0]])
    jp, tp = _panel(jg, tg, [list(range(m)), list(range(m, m + 10))], True)
    rng = np.random.default_rng(1)
    u = [0.6 + 0.1 * rng.standard_normal(tg.n) for _ in range(3)]
    xc = np.broadcast_to(((np.arange(16) + 0.5) / 16)[:, None, None],
                         tg.n).copy()
    got = _check(jp, tp, u, xc, X)
    assert abs(float(got["mean_pressure"][0]) - 0.5) < 0.02


def test_meter_specs_from_a_structure_table():
    inst = np.array([[3, 0, 1], [1, 0, 0], [2, 0, 2], [5, 1, 1], [4, 1, 0]])
    verts = np.zeros((6, 2))
    ref = JData(name="i", vertices=verts, inst=inst,
                index_offset=2).meter_specs(closed=False, dtype=jnp.float64)
    got = TData(name="i", vertices=verts, inst=inst,
                index_offset=2).meter_specs(closed=False,
                                            dtype=torch.float64,
                                            device="cpu")
    for a, b in zip(ref, got):
        assert np.array_equal(np.asarray(a), b.numpy())


def _tg(n, nu):
    two_pi = 2.0 * np.pi
    xf = np.arange(n) / n
    xc = (np.arange(n) + 0.5) / n
    X, Y = np.meshgrid(xf, xc, indexing="ij")
    u = np.sin(two_pi * X) * np.cos(two_pi * Y)
    Xc, Yf = np.meshgrid(xc, xf, indexing="ij")
    v = -np.cos(two_pi * Xc) * np.sin(two_pi * Yf)
    Xcc, Ycc = np.meshgrid(xc, xc, indexing="ij")
    p = 0.25 * (np.cos(2 * two_pi * Xcc) + np.cos(2 * two_pi * Ycc))
    return (u, v), p


@pytest.mark.parametrize("n", [32, 64])
def test_force_evaluator_budget_matches_reference(n):
    jg, tg = _grids(n)
    u, p = _tg(n, 0.02)
    lo, hi = (3 * n // 32, 5 * n // 32), (13 * n // 32, 14 * n // 32)
    je = jinst.HydrodynamicForceEvaluator(jg, lo, hi, rho=1.0, mu=0.02)
    te = tinst.HydrodynamicForceEvaluator(tg, lo, hi, rho=1.0, mu=0.02)
    ju, tu = tuple(jnp.asarray(c) for c in u), tuple(torch.tensor(c)
                                                     for c in u)
    S = te.surface_force(tu, torch.tensor(p))
    M = te.momentum(tu)
    assert _rel(je.surface_force(ju, jnp.asarray(p)), S) <= 1e-12
    assert _rel(je.momentum(ju), M) <= 1e-12
    dMdt = -2.0 * (2.0 * math.pi) ** 2 * 0.02 * M
    assert float(torch.max(torch.abs(S - dMdt)) / torch.max(
        torch.abs(dMdt))) < (0.2 if n == 32 else 0.02)
    bf = te.body_force(tu, torch.tensor(p), M, 1.01 * M, 0.1)
    assert _rel(je.body_force(ju, jnp.asarray(p), je.momentum(ju),
                              1.01 * je.momentum(ju), 0.1), bf) <= 1e-12


def test_force_evaluator_rejects_a_cv_at_the_edge():
    _, tg = _grids(16)
    with pytest.raises(ValueError, match="clearance"):
        tinst.HydrodynamicForceEvaluator(tg, (0, 2), (8, 8))
