"""Port parity of scalar transport: ``integrators/adv_diff.py``,
``ops/godunov.py``, ``ops/sources.py``, ``StructureData.source_specs`` and
the ``StaggeredGrid`` geometry methods, against ibamr_tpu at f64 on the
CPU. The inputs are the set-ups of ``tests/test_adv_diff.py``,
``test_adv_diff_walls.py``, ``test_robin_bc.py`` and ``test_godunov.py``
cut to a few steps on 16^2-32^2 grids, made from a numpy seed. Fields
agree to 1e-12 relative; to 1e-10 where a spectral (FFT) or
fast-diagonalization solve lies between."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import bc as jbc
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import adv_diff as jad
from ibamr_tpu.io import structures as jstruct
from ibamr_tpu.ops import godunov as jgod
from ibamr_tpu.ops import sources as jsrc
from ibamr_tpu_torch import bc as tbc
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import adv_diff as tad
from ibamr_tpu_torch.io import structures as tstruct
from ibamr_tpu_torch.ops import godunov as tgod
from ibamr_tpu_torch.ops import sources as tsrc

EXACT_RTOL = 1e-12
SOLVE_RTOL = 1e-10
TWO_PI = 2.0 * math.pi


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _grids(n, x_up=None):
    x_up = x_up or (1.0,) * len(n)
    lo = (0.0,) * len(n)
    return JGrid(n=n, x_lo=lo, x_up=x_up), TGrid(n=n, x_lo=lo, x_up=x_up)


def _t(a):
    return torch.tensor(np.asarray(a))


# -- grid --------------------------------------------------------------------

@pytest.mark.parametrize("n,x_up", [((16, 12), (1.0, 0.75)),
                                    ((8, 6, 10), (1.0, 0.5, 2.0))])
def test_grid_geometry_methods_match_reference(n, x_up):
    jg, tg = _grids(n, x_up)
    assert tg.lengths == jg.lengths and tg.num_cells == jg.num_cells
    for dt_j, dt_t in ((jnp.float32, torch.float32),
                       (jnp.float64, torch.float64)):
        for a, b in zip(jg.cell_centers(dt_j), tg.cell_centers(dt_t, "cpu")):
            assert b.dtype == dt_t and tuple(b.shape) == a.shape
            np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    X = np.random.default_rng(0).uniform(0.0, 1.0, (7, len(n)))
    np.testing.assert_array_equal(
        tg.position_to_index(_t(X)).numpy(),
        np.asarray(jg.position_to_index(jnp.asarray(X))))


# -- sources -----------------------------------------------------------------

def test_eulerian_source_matches_reference():
    jg, tg = _grids((24, 20))
    rng = np.random.default_rng(1)
    X = rng.uniform(0.2, 0.8, (30, 2))
    idx, Q = np.array([3, 7, 11, 29]), rng.standard_normal(4)
    en = np.array([1.0, 0.0, 1.0, 1.0])
    js = jsrc.make_sources(idx, Q, en, dtype=jnp.float64)
    ts = tsrc.make_sources(idx, Q, en, dtype=torch.float64, device="cpu")
    assert ts.idx.dtype == torch.int64
    for kernel in ("IB_4", "BSPLINE_3"):
        ref = jsrc.eulerian_source(js, jg, jnp.asarray(X), kernel=kernel)
        got = tsrc.eulerian_source(ts, tg, _t(X), kernel=kernel)
        assert _rel(ref, got) <= EXACT_RTOL
    Qt = rng.standard_normal(4)
    assert _rel(jsrc.eulerian_source(js, jg, jnp.asarray(X),
                                     Q=jnp.asarray(Qt)),
                tsrc.eulerian_source(ts, tg, _t(X), Q=_t(Qt))) <= EXACT_RTOL


def test_structure_source_specs_match_reference(tmp_path):
    rng = np.random.default_rng(2)
    verts = rng.uniform(0.0, 1.0, (6, 2))
    src = np.array([[1.0, 0.5], [4.0, -0.5]])
    jstruct.write_structure(str(tmp_path / "s"), jstruct.StructureData(
        name="s", vertices=verts, sources=src))
    jd = jstruct.read_structure(str(tmp_path / "s"))
    td = tstruct.read_structure(str(tmp_path / "s"))
    jd.index_offset = td.index_offset = 10
    js, ts = jd.source_specs(dtype=jnp.float64), td.source_specs(
        dtype=torch.float64, device="cpu")
    for a, b in zip(js, ts):
        np.testing.assert_array_equal(b.numpy(), np.asarray(a))
    td.sources = None
    assert td.source_specs(device="cpu") is None


# -- godunov -----------------------------------------------------------------

def _godunov_case(n, seed):
    rng = np.random.default_rng(seed)
    Q = rng.standard_normal(n)
    Q[3:6] = 1.0                          # flat runs and extrema
    u = tuple(rng.standard_normal(n) for _ in n)
    u[0][::4] = 0.0                       # faces with u == 0
    return Q, u


@pytest.mark.parametrize("wall", [False, True])
@pytest.mark.parametrize("axis", [0, 1])
def test_mc_limited_slope_matches_reference(axis, wall):
    Q, _ = _godunov_case((16, 12), 3)
    ref = jgod.mc_limited_slope(jnp.asarray(Q), axis, wall=wall)
    got = tgod.mc_limited_slope(_t(Q), axis, wall=wall)
    np.testing.assert_array_equal(got.numpy(), np.asarray(ref))


@pytest.mark.parametrize("ctu", [True, False])
@pytest.mark.parametrize("walls", [None, (False, True)])
def test_godunov_face_values_and_advect_match_reference(ctu, walls):
    Q, u = _godunov_case((16, 12), 4)
    dx, dt = (1.0 / 16, 1.0 / 12), 0.01
    ju, tu = tuple(jnp.asarray(c) for c in u), tuple(_t(c) for c in u)
    ref = jgod.godunov_face_values(jnp.asarray(Q), ju, dx, dt, ctu=ctu,
                                   wall_axes=walls)
    got = tgod.godunov_face_values(_t(Q), tu, dx, dt, ctu=ctu,
                                   wall_axes=walls)
    for a, b in zip(ref, got):
        assert _rel(a, b) <= EXACT_RTOL
    assert _rel(jgod.advect(jnp.asarray(Q), ju, dx, dt, ctu=ctu,
                            wall_axes=walls),
                tgod.advect(_t(Q), tu, dx, dt, ctu=ctu,
                            wall_axes=walls)) <= EXACT_RTOL


@pytest.mark.parametrize("n", [(16, 12), (8, 6, 10)])
def test_advect_split_matches_reference(n):
    Q, u = _godunov_case(n, 5)
    dx = tuple(1.0 / m for m in n)
    ju, tu = tuple(jnp.asarray(c) for c in u), tuple(_t(c) for c in u)
    jq, tq = jnp.asarray(Q), _t(Q)
    for parity in range(3):
        jq = jgod.advect_split(jq, ju, dx, 0.01, parity=parity)
        tq = tgod.advect_split(tq, tu, dx, 0.01, parity=parity)
    assert _rel(jq, tq) <= EXACT_RTOL


@pytest.mark.parametrize("kappa", [0.0, 0.01])
def test_predictor_corrector_matches_reference(kappa):
    jg, tg = _grids((16, 16))
    Q, u = _godunov_case((16, 16), 6)
    ju, tu = tuple(jnp.asarray(c) for c in u), tuple(_t(c) for c in u)
    jp = jgod.AdvDiffPredictorCorrector(jg, kappa=kappa)
    tp = tgod.AdvDiffPredictorCorrector(tg, kappa=kappa)
    jq, tq = jnp.asarray(Q), _t(Q)
    for _ in range(4):
        jq, tq = jp.step(jq, ju, 0.005), tp.step(tq, tu, 0.005)
    assert _rel(jq, tq) <= (SOLVE_RTOL if kappa else EXACT_RTOL)


# -- the integrator ----------------------------------------------------------

def _quantity(mod, bcm, name, kappa, scheme, walls=None, source=None,
              bdry=None):
    """One TransportedQuantity of package ``mod`` with its bc module
    ``bcm``; ``walls`` names the non-periodic set-up."""
    bc = None
    if walls == "dirichlet":
        bc = bcm.DomainBC(axes=(bcm.dirichlet_axis(), bcm.dirichlet_axis()))
    elif walls == "hot":
        bc = bcm.DomainBC(axes=(bcm.periodic_axis(), bcm.AxisBC(
            bcm.SideBC("dirichlet", 1.0), bcm.SideBC("dirichlet", 0.0))))
    elif walls == "neumann_flux":
        bc = bcm.DomainBC(axes=(bcm.periodic_axis(), bcm.AxisBC(
            bcm.SideBC("neumann", 2.0), bcm.SideBC("neumann", 0.0))))
    elif walls == "neumann":
        bc = bcm.DomainBC(axes=(bcm.periodic_axis(), bcm.neumann_axis()))
    elif walls == "robin":
        bc = bcm.DomainBC(axes=(bcm.robin_axis(2.0, 1.0, lo=1.0, hi=1.0),
                                bcm.AxisBC()))
    elif walls == "strip":
        bc = bcm.DomainBC(axes=(bcm.AxisBC(), bcm.dirichlet_axis()))
    return mod.TransportedQuantity(name, kappa=kappa, source=source,
                                   convective_op_type=scheme, bc=bc,
                                   bdry_data=bdry)


CASES = {
    # name: (grid n, kappa, scheme, walls, with velocity, steps, dt)
    "diffusion_decay": ((32, 32), 0.01, "none", None, False, 6, 1e-3),
    "centered": ((24, 24), 0.0, "centered", None, True, 8, 2e-3),
    "upwind_diffusive": ((24, 24), 0.02, "upwind", None, True, 8, 1e-3),
    "cui": ((24, 24), 0.0, "cui", None, True, 8, 2e-3),
    "dirichlet_box": ((16, 16), 0.02, "none", "dirichlet", False, 6, 2e-3),
    "hot_wall": ((4, 24), 0.1, "none", "hot", False, 6, 0.02),
    "neumann_flux": ((4, 16), 0.1, "none", "neumann_flux", False, 6, 1e-3),
    "wall_upwind": ((16, 16), 0.01, "upwind", "neumann", True, 6, 1e-3),
    "wall_cui": ((16, 16), 0.0, "cui", "neumann", True, 6, 1e-3),
    "robin": ((16, 8), 1.0, "none", "robin", False, 6, 0.05),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_adv_diff_steps_match_reference(case):
    n, kappa, scheme, walls, with_u, steps, dt = CASES[case]
    jg, tg = _grids(n)
    rng = np.random.default_rng(7)
    x, y = (np.asarray(c) for c in jg.cell_centers(jnp.float64))
    Q0 = np.broadcast_to(np.exp(-((x - 0.4) ** 2 + (y - 0.6) ** 2) / 0.02)
                         + 0.1 * np.sin(TWO_PI * x), n).copy()
    u = None
    if with_u:
        u = [rng.standard_normal(n) for _ in range(2)]
        if walls:
            u[1][:, 0] = 0.0           # pinned wall face, u.n = 0
    src = (lambda c, t, Q: 2.0 * kappa + 0 * Q) if walls == "robin" else None
    ji = jad.AdvDiffSemiImplicitIntegrator(
        jg, [_quantity(jad, jbc, "Q", kappa, scheme, walls, src)],
        dtype=jnp.float64)
    ti = tad.AdvDiffSemiImplicitIntegrator(
        tg, [_quantity(tad, tbc, "Q", kappa, scheme, walls, src)],
        dtype=torch.float64, device="cpu")
    js, ts = ji.initialize([Q0]), ti.initialize([Q0])
    ju = None if u is None else tuple(jnp.asarray(c) for c in u)
    tu = None if u is None else tuple(_t(c) for c in u)
    for _ in range(steps):
        js, ts = ji.step(js, dt, u=ju), ti.step(ts, dt, u=tu)
    tol = SOLVE_RTOL if kappa else EXACT_RTOL
    assert _rel(js.Q[0], ts.Q[0]) <= tol
    assert _rel(js.n_prev[0], ts.n_prev[0]) <= tol if with_u else True
    assert int(ts.k) == steps and ts.k.dtype == torch.int32
    assert abs(float(ts.t) - float(js.t)) <= 1e-15
    assert _rel(ji.total(js), ti.total(ts)) <= tol
    if tu is not None:
        # the wall-face pin works on a copy: the caller's u is unchanged
        for a, b in zip(tu, u):
            np.testing.assert_array_equal(a.numpy(), b)


def test_bdry_data_sources_and_two_quantities_match_reference():
    n = (16, 16)
    jg, tg = _grids(n)
    xc = (np.arange(n[0]) + 0.5) / n[0]
    strip = np.where(np.abs(xc - 0.5) < 0.1, 1.0, 0.0)[:, None]
    kw = dict(source=lambda c, t, Q: 1.0 + c[0] * 0 * Q)
    ji = jad.AdvDiffSemiImplicitIntegrator(jg, [
        _quantity(jad, jbc, "T", 0.05, "upwind", "strip",
                  bdry={(1, 0): jnp.asarray(strip)}),
        _quantity(jad, jbc, "B", 0.0, "none", **kw)], dtype=jnp.float64)
    ti = tad.AdvDiffSemiImplicitIntegrator(tg, [
        _quantity(tad, tbc, "T", 0.05, "upwind", "strip",
                  bdry={(1, 0): _t(strip)}),
        _quantity(tad, tbc, "B", 0.0, "none", **kw)], dtype=torch.float64,
        device="cpu")
    rng = np.random.default_rng(8)
    u = [rng.standard_normal(n) for _ in range(2)]
    u[1][:, 0] = 0.0
    src = rng.standard_normal(n)
    js, ts = ji.initialize(), ti.initialize()
    for k in range(5):
        sj = [None, jnp.asarray(src)] if k % 2 else None
        st = [None, _t(src)] if k % 2 else None
        js = ji.step(js, 0.01, u=tuple(jnp.asarray(c) for c in u),
                     sources=sj)
        ts = ti.step(ts, 0.01, u=tuple(_t(c) for c in u), sources=st)
    for a, b in zip(js.Q, ts.Q):
        assert _rel(a, b) <= SOLVE_RTOL
    advanced = tad.advance_adv_diff(ti, ti.initialize(), 0.01, 3)
    ref = jad.advance_adv_diff(ji, ji.initialize(), 0.01, 3)
    for a, b in zip(ref.Q, advanced.Q):
        assert _rel(a, b) <= SOLVE_RTOL


def test_helmholtz_seam_is_used():
    _, tg = _grids((16, 16))
    ti = tad.AdvDiffSemiImplicitIntegrator(
        tg, [tad.TransportedQuantity("Q", kappa=0.1,
                                     convective_op_type="none")],
        dtype=torch.float64, device="cpu")
    calls = []

    def solve(rhs, dx, alpha, beta):
        calls.append((alpha, beta))
        return torch.zeros_like(rhs)

    ti.helmholtz_solve = solve
    s = ti.step(ti.initialize([torch.ones(16, 16, dtype=torch.float64)]),
                0.5)
    assert calls == [(2.0, -0.05)] and float(s.Q[0].abs().max()) == 0.0
