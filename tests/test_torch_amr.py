"""Port parity of the two-level hierarchy's transfers and scalar advance:
``amr.py`` and ``amr_dynamic.py`` against ibamr_tpu at f64 on the CPU, on
the set-ups of ``tests/test_amr.py`` and ``tests/test_amr_dynamic.py``
cut to 16^2-32^2 and a few steps, made from a numpy seed. Fields agree
to 1e-12 relative; window origins, tags and the composite totals'
conservation are exact checks."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_dynamic as jdyn
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_dynamic as tdyn
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid

RTOL = 1e-12


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _grids(n):
    lo, up = (0.0,) * len(n), (1.0,) * len(n)
    return JGrid(n=n, x_lo=lo, x_up=up), TGrid(n=n, x_lo=lo, x_up=up)


def _t(a):
    return torch.tensor(np.asarray(a))


def _boxes(lo, shape):
    return jamr.FineBox(lo=lo, shape=shape), tamr.FineBox(lo=lo, shape=shape)


# -- amr.py ------------------------------------------------------------------

def test_fine_box_geometry_matches_reference():
    jg, tg = _grids((32, 24))
    jb, tb = _boxes((6, 5), (8, 10))
    assert (tb.hi, tb.fine_n, tb.dim) == (jb.hi, jb.fine_n, jb.dim)
    jf, tf = jb.fine_grid(jg), tb.fine_grid(tg)
    assert (tf.n, tf.x_lo, tf.x_up) == (jf.n, jf.x_lo, jf.x_up)
    tb.validate(tg)
    with pytest.raises(ValueError, match="domain edge"):
        tamr.FineBox(lo=(1, 5), shape=(8, 10)).validate(tg)
    with pytest.raises(ValueError, match="ratio"):
        tamr.FineBox(lo=(4, 4), shape=(4, 4), ratio=4)


@pytest.mark.parametrize("shape", [(8, 6), (8, 8, 4)])
def test_restrictions_match_reference(shape):
    rng = np.random.default_rng(0)
    f = rng.standard_normal(shape)
    assert _rel(jamr.restrict_cc(jnp.asarray(f)),
                tamr.restrict_cc(_t(f))) <= RTOL
    uf = [rng.standard_normal(tuple(n + (1 if a == d else 0)
                                    for a, n in enumerate(shape)))
          for d in range(len(shape))]
    for fn in ("restrict_mac", "box_mac_to_cc"):
        ref = getattr(jamr, fn)(tuple(jnp.asarray(c) for c in uf))
        got = getattr(tamr, fn)(tuple(_t(c) for c in uf))
        for a, b in zip(ref, got):
            assert _rel(a, b) <= RTOL


@pytest.mark.parametrize("order", [1, 2])
def test_interp_periodic_matches_reference(order):
    rng = np.random.default_rng(1)
    field = rng.standard_normal((12, 10, 8))
    pts = rng.uniform(-2.0, 14.0, (5, 7, 3))
    pts[0, :3] = np.round(pts[0, :3]) + 0.5     # rounding ties (half even)
    assert _rel(jamr.interp_periodic(jnp.asarray(field), jnp.asarray(pts),
                                     order),
                tamr.interp_periodic(_t(field), _t(pts), order)) <= RTOL


@pytest.mark.parametrize("dim", [2, 3])
def test_prolong_and_ghost_fill_match_reference(dim):
    n = 16
    jg, tg = _grids((n,) * dim)
    jb, tb = _boxes((4,) * dim, (4,) * (dim - 1) + (6,))
    rng = np.random.default_rng(2)
    Qc = rng.standard_normal(jg.n)
    for ghost in (0, 2):
        assert _rel(jamr.prolong_cc(jnp.asarray(Qc), jb, ghost=ghost),
                    tamr.prolong_cc(_t(Qc), tb, ghost=ghost)) <= RTOL
    Qf = rng.standard_normal(jb.fine_n)
    for ghost in (1, 2):
        ref = jamr.fill_fine_ghosts(jnp.asarray(Qf), jnp.asarray(Qc), jb,
                                    ghost)
        for _ in range(2):                     # the cached plan reused
            got = tamr.fill_fine_ghosts(_t(Qf), _t(Qc), tb, ghost)
            assert _rel(ref, got) <= RTOL


@pytest.mark.parametrize("dim", [2, 3])
def test_prolong_mac_div_preserving_matches_reference(dim):
    n = 16
    jg, tg = _grids((n,) * dim)
    jb, tb = _boxes((4,) * dim, (4,) * (dim - 1) + (3,))
    rng = np.random.default_rng(3)
    u = [rng.standard_normal(jg.n) for _ in range(dim)]
    ref = jamr.prolong_mac_div_preserving(tuple(jnp.asarray(c) for c in u),
                                          jg, jb)
    got = tamr.prolong_mac_div_preserving(tuple(_t(c) for c in u), tg, tb)
    for a, b in zip(ref, got):
        assert _rel(a, b) <= 1e-11
    np.testing.assert_allclose(
        tamr._neumann_block_pinv(dim, tg.dx),
        jamr._neumann_block_pinv(dim, jg.dx), rtol=0, atol=0)
    dx_f = tuple(h / 2 for h in tg.dx)
    assert _rel(jamr._box_mac_divergence(ref, dx_f),
                tamr.box_mac_divergence(got, dx_f)) <= 1e-10


def _gauss(mod):
    def fn(coords):
        r2 = 0.0
        for c, x in zip(coords, (0.45, 0.45)):
            r2 = r2 + (c - x) ** 2
        return mod.exp(-r2 / 0.08 ** 2)
    return fn


@pytest.mark.parametrize("with_u", [True, False])
def test_two_level_adv_diff_matches_reference(with_u):
    n = 24
    jg, tg = _grids((n, n))
    jb, tb = _boxes((6, 6), (10, 8))
    kw = {}
    if with_u:
        rng = np.random.default_rng(4)
        uc = [rng.standard_normal(jg.n) for _ in range(2)]
        uf = [rng.standard_normal((jb.fine_n[0] + 1, jb.fine_n[1])),
              rng.standard_normal((jb.fine_n[0], jb.fine_n[1] + 1))]
        jkw = dict(u_coarse=tuple(jnp.asarray(c) for c in uc),
                   u_fine=tuple(jnp.asarray(c) for c in uf))
        kw = dict(u_coarse=tuple(_t(c) for c in uc),
                  u_fine=tuple(_t(c) for c in uf))
    else:
        jkw = {}
    scheme = "upwind" if with_u else "centered"
    ji = jamr.TwoLevelAdvDiff(jg, jb, kappa=2e-3, scheme=scheme, **jkw)
    ti = tamr.TwoLevelAdvDiff(tg, tb, kappa=2e-3, scheme=scheme,
                              device="cpu", **kw)
    jc, jf = ji.initialize(_gauss(jnp))
    tc, tf = ti.initialize(_gauss(torch))
    assert _rel(jc, tc) <= RTOL and _rel(jf, tf) <= RTOL
    tot0 = float(ti.total(tc, tf))
    for _ in range(6):
        jc, jf = ji.step(jc, jf, 2e-3)
        tc, tf = ti.step(tc, tf, 2e-3)
    assert _rel(jc, tc) <= RTOL and _rel(jf, tf) <= RTOL
    assert abs(float(ji.total(jc, jf)) - float(ti.total(tc, tf))) <= 1e-14
    assert abs(float(ti.total(tc, tf)) - tot0) <= 1e-12


# -- amr_dynamic.py ------------------------------------------------------------

def test_tags_match_reference():
    jg, tg = _grids((32, 32))
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((32, 32)) * (rng.uniform(size=(32, 32)) > 0.9)
    np.testing.assert_array_equal(
        tdyn.tag_value(_t(Q), 0.5).numpy(),
        np.asarray(jdyn.tag_value(jnp.asarray(Q), 0.5)))
    np.testing.assert_array_equal(
        tdyn.tag_gradient(_t(Q), tg, 0.7).numpy(),
        np.asarray(jdyn.tag_gradient(jnp.asarray(Q), jg, 0.7)))
    X = rng.uniform(-0.2, 1.2, (40, 2))
    mask = (rng.uniform(size=40) > 0.3).astype(float)
    for buffer in (0, 1, 2):
        for m in (None, mask):
            np.testing.assert_array_equal(
                tdyn.tag_markers(_t(X), tg, None if m is None else _t(m),
                                 buffer=buffer).numpy(),
                np.asarray(jdyn.tag_markers(
                    jnp.asarray(X), jg,
                    None if m is None else jnp.asarray(m), buffer=buffer)))


def _tag_cases():
    rng = np.random.default_rng(6)
    cases = []
    for _ in range(40):
        t = np.zeros((32, 32), dtype=bool)
        i, j = rng.integers(0, 32, 2)
        w, h = rng.integers(1, 12, 2)
        t[i:i + w, j:j + h] = True
        cases.append(np.roll(t, rng.integers(0, 32, 2), axis=(0, 1)))
    t = np.zeros((32, 32), dtype=bool)
    cases.append(t)                                  # no tags
    t = t.copy()
    t[10:14, 20:22] = True                           # symmetric blobs
    cases.append(t)
    t = np.zeros((32, 32), dtype=bool)
    t[0:3, 29:32] = True                             # clipped to clearance
    cases.append(t)
    return cases


@pytest.mark.parametrize("box", [(8, 8), (7, 12), (12, 5)])
def test_fit_box_origin_matches_reference_exactly(box):
    jitted = jax.jit(lambda t: jdyn.fit_box_origin(t, box, 2))
    for tags in _tag_cases():
        ref = np.asarray(jdyn.fit_box_origin(jnp.asarray(tags), box, 2))
        got = tdyn.fit_box_origin(torch.tensor(tags), box, 2)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), ref)
        # compiled, as inside the reference's advance
        assert tdyn.fit_box_origin_host(torch.tensor(tags), box, 2,
                                        compiled=True) \
            == tuple(np.asarray(jitted(jnp.asarray(tags))))


@pytest.mark.parametrize("n", [24, 40, 48, 64])
def test_fit_box_origin_sizes_match_reference_exactly(n):
    """Random tagged boxes on n^2 grids (the summation order of the
    reference's CPU backend changes past 32 cells), eager and compiled."""
    rng = np.random.default_rng(n)
    jitted = jax.jit(lambda t: jdyn.fit_box_origin(t, (8, 7), 2))
    for _ in range(40):
        t = np.zeros((n, n), dtype=bool)
        i, j = rng.integers(0, n, 2)
        w, h = rng.integers(1, n // 3, 2)
        t[i:i + w, j:j + h] = True
        t = np.roll(t, rng.integers(0, n, 2), axis=(0, 1))
        assert tdyn.fit_box_origin_host(torch.tensor(t), (8, 7), 2) == \
            tuple(np.asarray(jdyn.fit_box_origin(jnp.asarray(t), (8, 7), 2)))
        assert tdyn.fit_box_origin_host(torch.tensor(t), (8, 7), 2,
                                        compiled=True) \
            == tuple(np.asarray(jitted(jnp.asarray(t))))


def test_dynamic_transfers_match_reference():
    rng = np.random.default_rng(7)
    Qc = rng.standard_normal((16, 16))
    lo, lo2 = (3, 5), (5, 6)
    ref = jdyn.prolong_cc_conservative(jnp.asarray(Qc), jnp.asarray(lo),
                                       (6, 4))
    assert _rel(ref, tdyn.prolong_cc_conservative(_t(Qc), lo, (6, 4))) \
        <= RTOL
    Qf = rng.standard_normal((12, 8))
    assert _rel(jdyn.restrict_into_coarse(jnp.asarray(Qc), jnp.asarray(Qf),
                                          jnp.asarray(lo)),
                tdyn.restrict_into_coarse(_t(Qc), _t(Qf),
                                          torch.tensor(lo))) <= RTOL
    new = rng.standard_normal((12, 8))
    for a, b in ((lo2, lo), (lo, lo2), (lo, lo), ((9, 10), lo)):
        ref = jdyn.copy_overlap(jnp.asarray(new), jnp.asarray(Qf),
                                jnp.asarray(a), jnp.asarray(b))
        np.testing.assert_array_equal(
            tdyn.copy_overlap(_t(new), _t(Qf), a, b).numpy(),
            np.asarray(ref))
    rc, rf = jdyn.regrid(jnp.asarray(Qc), jnp.asarray(Qf), jnp.asarray(lo),
                         jnp.asarray(lo2))
    tc, tf = tdyn.regrid(_t(Qc), _t(Qf), lo, lo2)
    assert _rel(rc, tc) <= RTOL and _rel(rf, tf) <= RTOL
    for ghost in (1, 2):
        ref = jdyn.fill_fine_ghosts_dyn(jnp.asarray(Qf), jnp.asarray(Qc),
                                        jnp.asarray(lo), ghost)
        got = tdyn.fill_fine_ghosts_dyn(_t(Qf), _t(Qc), lo, ghost)
        assert _rel(ref, got) <= RTOL
    # the reference clamps a window that leaves the domain; the port raises
    with pytest.raises(ValueError, match="clearance"):
        tdyn.prolong_cc_conservative(_t(Qc), (0, 5), (6, 4))
    with pytest.raises(ValueError, match="clearance"):
        tdyn.restrict_into_coarse(_t(Qc), _t(Qf), (12, 5))


def _u_fn(mod):
    def u_fn(coords, d):
        return mod.full_like(coords[0], 0.7 if d == 0 else 0.0)
    return u_fn


@pytest.mark.parametrize("moving", [True, False])
def test_dynamic_advance_matches_reference(moving):
    """The moving-window advance of test_amr_dynamic.py:122 on a 32^2
    grid, 16 steps with a regrid every 4: origins at every regrid equal,
    fields to 1e-12, the composite total conserved."""
    jg, tg = _grids((32, 32))
    kw = dict(kappa=1e-4, scheme="upwind", tag_threshold=0.03)
    if not moving:
        kw = dict(kappa=2e-3, tag_threshold=0.02)
    js = jdyn.DynamicTwoLevelAdvDiff(
        jg, (10, 10), u_fn=_u_fn(jnp) if moving else None, dtype=jnp.float64,
        **kw)
    ts = tdyn.DynamicTwoLevelAdvDiff(
        tg, (10, 10), u_fn=_u_fn(torch) if moving else None,
        dtype=torch.float64, device="cpu", **kw)
    ic = (lambda m: (lambda c: m.exp(-((c[0] - 0.3) ** 2
                                       + (c[1] - 0.5) ** 2) / 0.07 ** 2)))
    jst, tst = js.initialize(ic(jnp)), ts.initialize(ic(torch))
    np.testing.assert_array_equal(tst.lo.numpy(), np.asarray(jst.lo))
    T0 = float(ts.total(tst))
    dt = 0.25 * tg.dx[0] / 0.7 / 2
    los_j, los_t = [], []
    for _ in range(4):
        jst = js.advance(jst, dt, 4, regrid_interval=4)
        tst = ts.advance(tst, dt, 4, regrid_interval=4)
        los_j.append(np.asarray(jst.lo).tolist())
        los_t.append(tst.lo.tolist())
    assert los_t == los_j
    if moving:
        assert los_t[-1][0] > tst.lo.new_tensor(
            ts.initialize(ic(torch)).lo)[0]
    assert _rel(jst.Qc, tst.Qc) <= RTOL and _rel(jst.Qf, tst.Qf) <= RTOL
    assert abs(float(ts.total(tst)) - T0) < 1e-12 * max(1.0, abs(T0))
    # one regrid and one step through the public single-step API
    a = tdyn.AMRState(*tst)
    ref = js.step(js.regrid_state(jst), dt)
    got = ts.step(ts.regrid_state(a), dt)
    assert _rel(ref.Qc, got.Qc) <= RTOL and _rel(ref.Qf, got.Qf) <= RTOL


def test_dynamic_advance_f32_origins_match_reference():
    """The advance as the chip smoke runs it, f32: the same origins at
    every regrid as the reference's (whose fit is f32 in any mode)."""
    jg, tg = _grids((48, 48))
    kw = dict(kappa=1e-4, scheme="upwind", tag_threshold=0.03)
    with jax.enable_x64(False):
        js = jdyn.DynamicTwoLevelAdvDiff(jg, (12, 12), u_fn=_u_fn(jnp),
                                         dtype=jnp.float32, **kw)
        jst = js.initialize(lambda c: jnp.exp(-((c[0] - 0.3) ** 2 + (
            c[1] - 0.5) ** 2) / 0.07 ** 2))
        dt = 0.25 * jg.dx[0] / 0.7 / 2
        los_j = []
        for _ in range(8):
            jst = js.advance(jst, dt, 4, regrid_interval=4)
            los_j.append(np.asarray(jst.lo).tolist())
    ts = tdyn.DynamicTwoLevelAdvDiff(tg, (12, 12), u_fn=_u_fn(torch),
                                     dtype=torch.float32, device="cpu", **kw)
    tst = ts.initialize(lambda c: torch.exp(-((c[0] - 0.3) ** 2 + (
        c[1] - 0.5) ** 2) / 0.07 ** 2))
    los_t = []
    for _ in range(8):
        tst = ts.advance(tst, dt, 4, regrid_interval=4)
        los_t.append(tst.lo.tolist())
    assert los_t == los_j
    assert _rel(jst.Qf, tst.Qf) <= 1e-5
