"""Port parity of the composite two-level INS and IB (``amr_ins.py``)
against ibamr_tpu at f64 on the CPU, on the set-ups of
``tests/test_amr_ins.py`` and ``tests/test_amr_ins_regrid.py`` cut to
16^2-32^2 (16^3 in 3D) and a few steps, made from a numpy seed. The box
stencils and transfers agree to 1e-12 relative; everything after a
composite projection (FGMRES over the FFT and fast-diagonalization
preconditioner) to 1e-10, with the FGMRES restart counts and the window
origins equal."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_ins as jins
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ib import IBMethod as JIB
from ibamr_tpu.models.membrane2d import make_circle_membrane as jmembrane
from ibamr_tpu.models.shell3d import make_spherical_shell as jshell
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_ins as tins
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators.ib import IBMethod as TIB
from ibamr_tpu_torch.models.membrane2d import make_circle_membrane as tmembrane
from ibamr_tpu_torch.models.shell3d import make_spherical_shell as tshell

EXACT = 1e-12

@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)

SOLVE = 1e-10


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _close(ref, got, tol):
    for a, b in zip(ref, got):
        assert _rel(a, b) <= tol


def _grids(n):
    lo, up = (0.0,) * len(n), (1.0,) * len(n)
    return JGrid(n=n, x_lo=lo, x_up=up), TGrid(n=n, x_lo=lo, x_up=up)


def _boxes(lo, shape):
    return jamr.FineBox(lo=lo, shape=shape), tamr.FineBox(lo=lo, shape=shape)


def _t(a):
    return torch.tensor(np.asarray(a))


def _mac(rng, n, extra=True, scale=0.1):
    """Random MAC components: periodic layout, or box layout (+1 on its
    own axis) with ``extra``."""
    return [scale * rng.standard_normal(tuple(
        m + (1 if (extra and a == d) else 0) for a, m in enumerate(n)))
        for d in range(len(n))]


@pytest.mark.parametrize("dim", [2, 3])
def test_box_stencils_match_reference(dim):
    rng = np.random.default_rng(0)
    fine_n = (6, 8, 4)[:dim]
    g = 3
    uext = [rng.standard_normal(tuple(m + (1 if a == d else 0) + 2 * g
                                      for a, m in enumerate(fine_n)))
            for d in range(dim)]
    dx_f = (0.03, 0.02, 0.025)[:dim]
    ju, tu = tuple(jnp.asarray(c) for c in uext), tuple(_t(c) for c in uext)
    for fn in ("_box_convective_rate", "_box_laplacian"):
        _close(getattr(jins, fn)(ju, dx_f, g, fine_n),
               getattr(tins, fn)(tu, dx_f, g, fine_n), EXACT)
    js = jins.box_strain_magnitude(ju, dx_f, g, fine_n)
    ts = tins.box_strain_magnitude(tu, dx_f, g, fine_n)
    assert _rel(js, ts) <= EXACT
    _close(jins.box_eddy_viscous_force(ju, js, dx_f, g, fine_n),
           tins.box_eddy_viscous_force(tu, ts, dx_f, g, fine_n), EXACT)
    phi = rng.standard_normal(tuple(m + 2 for m in fine_n))
    assert _rel(jins._box_cc_laplacian(jnp.asarray(phi), dx_f, fine_n),
                tins._box_cc_laplacian(_t(phi), dx_f, fine_n)) <= EXACT
    ub = _mac(rng, fine_n)
    _close(jins.box_mac_gradient_correct(
        tuple(jnp.asarray(c) for c in ub), jnp.asarray(phi), dx_f),
        tins.box_mac_gradient_correct(tuple(_t(c) for c in ub), _t(phi),
                                      dx_f), EXACT)


@pytest.mark.parametrize("dim", [2, 3])
def test_transfers_and_flux_correction_match_reference(dim):
    n = (16,) * dim
    jg, tg = _grids(n)
    jb, tb = _boxes((4,) * dim, (6,) + (4,) * (dim - 1))
    rng = np.random.default_rng(1)
    uc, uf = _mac(rng, n, extra=False), _mac(rng, jb.fine_n)
    juc, tuc = tuple(jnp.asarray(c) for c in uc), tuple(_t(c) for c in uc)
    juf, tuf = tuple(jnp.asarray(c) for c in uf), tuple(_t(c) for c in uf)
    for ghost in (1, 2):
        _close(jins.fill_fine_ghosts_mac(juf, juc, jb, ghost),
               tins.fill_fine_ghosts_mac(tuf, tuc, tb, ghost), EXACT)
    _close(jins.scatter_box_mac_to_coarse(juc, jamr.restrict_mac(juf), jb),
           tins.scatter_box_mac_to_coarse(tuc, tamr.restrict_mac(tuf), tb),
           EXACT)
    phi_c = rng.standard_normal(n)
    phi_ext = rng.standard_normal(tuple(m + 2 for m in jb.fine_n))
    lap = rng.standard_normal(n)
    dx_f = tuple(h / 2 for h in jg.dx)
    lap_t = _t(lap)
    got = tins.interface_flux_correction(lap_t, _t(phi_c), _t(phi_ext), tb,
                                         tg.dx, dx_f)
    np.testing.assert_array_equal(lap_t.numpy(), lap)   # out of place
    assert _rel(jins.interface_flux_correction(
        jnp.asarray(lap), jnp.asarray(phi_c), jnp.asarray(phi_ext), jb,
        jg.dx, dx_f), got) <= EXACT


def test_composite_projection_matches_reference():
    jg, tg = _grids((24, 24))
    jb, tb = _boxes((6, 6), (12, 10))
    rng = np.random.default_rng(2)
    uc, uf = _mac(rng, jg.n, extra=False), _mac(rng, jb.fine_n)
    jp = jins.CompositeProjection(jg, jb, tol=1e-11, m=20, restarts=12)
    tp = tins.CompositeProjection(tg, tb, tol=1e-11, m=20, restarts=12,
                                  device="cpu")
    phi = (rng.standard_normal(jg.n), rng.standard_normal(jb.fine_n))
    _close(jp.operator(tuple(jnp.asarray(c) for c in phi)),
           tp.operator(tuple(_t(c) for c in phi)), EXACT)
    _close(jp._precondition(tuple(jnp.asarray(c) for c in phi)),
           tp._precondition(tuple(_t(c) for c in phi)), SOLVE)
    q = (0.01 * rng.standard_normal(jg.n), 0.01 * rng.standard_normal(
        jb.fine_n))
    ref = jp.project(tuple(jnp.asarray(c) for c in uc),
                     tuple(jnp.asarray(c) for c in uf),
                     q_c=jnp.asarray(q[0]), q_f=jnp.asarray(q[1]))
    jp.record_stats = True
    got = tp.project(tuple(_t(c) for c in uc), tuple(_t(c) for c in uf),
                     q_c=_t(q[0]), q_f=_t(q[1]))
    for a, b in zip(ref[:2], got[:2]):
        _close(a, b, SOLVE)
    _close(ref[2:], got[2:], SOLVE)
    assert tp.last_solve_stats["iters"] == jp.last_solve_stats["iters"]
    assert tp.last_solve_stats["converged"]
    # the sharded path's dense-periodic coarse inverse: the reference's
    tp.build_dense_coarse_solver()
    jp.build_dense_coarse_solver()
    r = np.random.default_rng(5).standard_normal(tp.grid.n)
    _close(jp._coarse_dense_solver.solve(jnp.asarray(r), 0.0, 1.0,
                                         zero_nullspace=True),
           tp._coarse_dense_solver.solve(_t(r), 0.0, 1.0,
                                         zero_nullspace=True), SOLVE)


def _vortex(g, A=0.05, s=0.08):
    nx, ny = g.n
    X, Y = np.meshgrid(np.arange(nx) * g.dx[0], np.arange(ny) * g.dx[1],
                       indexing="ij")
    psi = A * np.exp(-((X - 0.5) ** 2 + (Y - 0.5) ** 2) / s ** 2)
    return ((np.roll(psi, -1, 1) - psi) / g.dx[1],
            -(np.roll(psi, -1, 0) - psi) / g.dx[0])


@pytest.mark.parametrize("convective", [True, False])
def test_two_level_ins_steps_match_reference(convective):
    jg, tg = _grids((24, 24))
    jb, tb = _boxes((6, 6), (12, 12))
    kw = dict(rho=1.0, mu=0.01, convective=convective, proj_tol=1e-10)
    ji, ti = jins.TwoLevelINS(jg, jb, **kw), tins.TwoLevelINS(
        tg, tb, device="cpu", **kw)
    u = _vortex(jg)
    js = ji.initialize(tuple(jnp.asarray(c) for c in u))
    ts = ti.initialize(tuple(_t(c) for c in u))
    _close(js.uf, ts.uf, 1e-11)
    f_f = _mac(np.random.default_rng(3), jb.fine_n, scale=0.5)
    # the reference's step compiled, its restarts recorded per call
    ji.proj.record_stats = True
    jstep = jax.jit(lambda s: ji.step(s, 2e-3, f_f=tuple(
        jnp.asarray(c) for c in f_f)))
    its, ref_its = [], []
    for _ in range(3):
        js = jstep(js)
        jax.block_until_ready(js.uc)
        ref_its.append(ji.proj.last_solve_stats["iters"])
        ts = ti.step(ts, 2e-3, f_f=tuple(_t(c) for c in f_f))
        its.append(ti.proj.last_solve_stats["iters"])
    assert its == ref_its
    _close(js.uc, ts.uc, SOLVE)
    _close(js.uf, ts.uf, SOLVE)
    assert int(ts.k) == 3 and abs(float(ts.t) - float(js.t)) < 1e-15
    assert abs(float(ji.max_divergence(js))
               - float(ti.max_divergence(ts))) <= 1e-10
    assert float(ti.stable_dt(ts)) == pytest.approx(float(ji.stable_dt(js)),
                                                    rel=1e-12)
    got = tins.advance_two_level(ti, ts, 2e-3, 1)
    assert int(got.k) == 4 and got.uc[0].shape == ts.uc[0].shape


def _membrane_pair(n_markers=32, center=(0.5, 0.5), radius=0.12):
    js = jmembrane(n_markers, radius, center, stiffness=2.0, aspect=1.2,
                   rest_length_factor=0.7)
    ts = tmembrane(n_markers, radius, center, stiffness=2.0, aspect=1.2,
                   rest_length_factor=0.7)
    return (JIB(js.force_specs(dtype=jnp.float64), kernel="IB_4"),
            TIB(ts.force_specs(dtype=torch.float64, device="cpu"),
                kernel="IB_4"), js.vertices)


def test_two_level_ib_steps_match_reference():
    jg, tg = _grids((24, 24))
    jb, tb = _boxes((6, 6), (12, 12))
    jib, tib, X0 = _membrane_pair()
    kw = dict(rho=1.0, mu=0.02, proj_tol=1e-10)
    ji = jins.TwoLevelIBINS(jg, jb, jib, **kw)
    ti = tins.TwoLevelIBINS(tg, tb, tib, device="cpu", **kw)
    js, ts = ji.initialize(jnp.asarray(X0)), ti.initialize(_t(X0))
    js = jax.jit(lambda s: jins.advance_two_level_ib(ji, s, 5e-4, 3))(js)
    ts = tins.advance_two_level_ib(ti, ts, 5e-4, 3)
    assert _rel(js.X, ts.X) <= SOLVE and _rel(js.U, ts.U) <= SOLVE
    _close(js.fluid.uf, ts.fluid.uf, SOLVE)
    _close(js.fluid.uc, ts.fluid.uc, SOLVE)


def test_two_level_ib_3d_shell_matches_reference():
    jg, tg = _grids((16, 16, 16))
    jb, tb = _boxes((4, 4, 4), (8, 8, 8))
    js_ = jshell(8, 8, 0.1, (0.5, 0.5, 0.5), 1.0, rest_length_factor=0.75)
    ts_ = tshell(8, 8, 0.1, (0.5, 0.5, 0.5), 1.0, rest_length_factor=0.75)
    jib = JIB(js_.force_specs(dtype=jnp.float64), kernel="IB_4")
    tib = TIB(ts_.force_specs(dtype=torch.float64, device="cpu"),
              kernel="IB_4")
    kw = dict(mu=0.05, proj_tol=1e-10)
    ji = jins.TwoLevelIBINS(jg, jb, jib, **kw)
    ti = tins.TwoLevelIBINS(tg, tb, tib, device="cpu", **kw)
    js = ji.initialize(jnp.asarray(js_.vertices, jnp.float64))
    ts = ti.initialize(_t(ts_.vertices))
    js = jax.jit(lambda s: jins.advance_two_level_ib(ji, s, 5e-4, 2))(js)
    ts = tins.advance_two_level_ib(ti, ts, 5e-4, 2)
    assert _rel(js.X, ts.X) <= SOLVE
    _close(js.fluid.uf, ts.fluid.uf, SOLVE)


def test_box_from_markers_and_window_match_reference():
    jg, tg = _grids((64, 64))
    for center, radius in (((0.4, 0.6), 0.1), ((0.3, 0.5), 0.06),
                           ((0.71, 0.33), 0.13)):
        v = jmembrane(32, radius, center, stiffness=1.0).vertices
        for pad in (3, 4):
            for X in (v, v.astype(np.float32)):
                assert tins.box_from_markers(tg, _t(X), pad=pad) == \
                    tamr.FineBox(**vars(jins.box_from_markers(jg, X,
                                                              pad=pad)))
        for shape in ((20, 20), (16, 18), (6, 6)):
            try:
                ref = jins._window_lo_from_markers(jg, v, shape)
            except ValueError:
                with pytest.raises(ValueError, match="does not fit"):
                    tins._window_lo_from_markers(tg, _t(v), shape)
                continue
            assert tins._window_lo_from_markers(tg, _t(v), shape) == ref


def _regrid_setup(n=32, box_shape=(12, 12), center=(0.3, 0.5), U0=0.5):
    jg, tg = _grids((n, n))
    jib, tib, X0 = _membrane_pair(32, center, 0.06)
    lo = tuple(int(round(c * n - s / 2)) for c, s in zip(center, box_shape))
    jb, tb = _boxes(lo, box_shape)
    kw = dict(mu=0.02, proj_tol=1e-10)
    ji = jins.TwoLevelIBINS(jg, jb, jib, **kw)
    ti = tins.TwoLevelIBINS(tg, tb, tib, device="cpu", **kw)
    uc = np.zeros((2, n, n))
    uc[0] = U0
    js = ji.initialize(jnp.asarray(X0), uc=tuple(jnp.asarray(c) for c in uc))
    ts = ti.initialize(_t(X0), uc=tuple(_t(c) for c in uc))
    return (jg, tg), (ji, ti), (js, ts)


def test_regrid_transfer_matches_reference():
    _, (ji, ti), (js, ts) = _regrid_setup()
    shift = np.array([0.08, 0.03])
    js2 = js._replace(X=js.X + jnp.asarray(shift))
    ts2 = ts._replace(X=ts.X + _t(shift))
    ji2, js3 = jins.regrid_two_level_ib(ji, js2)
    ti2, ts3 = tins.regrid_two_level_ib(ti, ts2)
    assert ti2.box == tamr.FineBox(**vars(ji2.box)) and ti2.box != ti.box
    _close(js3.fluid.uf, ts3.fluid.uf, SOLVE)
    _close(js3.fluid.uc, ts3.fluid.uc, SOLVE)
    assert ti2.core.proj.last_solve_stats["iters"] == \
        ji2.core.proj.last_solve_stats["iters"]
    # no move: both unchanged
    ti3, ts4 = tins.regrid_two_level_ib(ti, ts)
    assert ti3 is ti and ts4 is ts


def test_regrid_carries_projection_config():
    _, (_, ti), (_, ts) = _regrid_setup()
    built = []

    def factory(grid, box):
        built.append(box.lo)
        return lambda r: r

    ti = tins.TwoLevelIBINS(ti.grid, ti.box, ti.ib, mu=0.02, proj_tol=1e-8,
                            proj_m=10, proj_restarts=3,
                            precond_factory=factory, device="cpu")
    ti2, _ = tins.regrid_two_level_ib(
        ti, ts._replace(X=ts.X + _t(np.array([0.1, 0.0]))))
    assert (ti2.core.proj.tol, ti2.core.proj.m, ti2.core.proj.restarts) == \
        (1e-8, 10, 3)
    assert ti2.core.proj._external_precond is not None
    assert built[-1] == ti2.box.lo != built[0]


def test_regridding_advance_matches_reference():
    """The moving window of test_amr_ins_regrid.py on a 32^2 grid in a
    stream of 2: 20 steps with a regrid every 5 (the structure travels
    as far as in 40 steps at a stream of 1, and the window moves); the
    window origins after every chunk equal, the state to 1e-10."""
    _, (ji, ti), (js, ts) = _regrid_setup(U0=2.0)
    jlog, tlog = [], []
    ji_end, js_end = jins.advance_two_level_ib_regridding(
        ji, js, 2.5e-3, 20, regrid_interval=5,
        on_chunk=lambda i, s, d: jlog.append((d, i.box.lo)))
    ti_end, ts_end = tins.advance_two_level_ib_regridding(
        ti, ts, 2.5e-3, 20, regrid_interval=5,
        on_chunk=lambda i, s, d: tlog.append((d, i.box.lo)))
    assert tlog == jlog and len({lo for _, lo in tlog}) > 1
    assert ti_end.box.lo == ji_end.box.lo
    assert _rel(js_end.X, ts_end.X) <= SOLVE
    _close(js_end.fluid.uf, ts_end.fluid.uf, SOLVE)
