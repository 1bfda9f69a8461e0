"""Port parity of the multi-box dynamic AMR (``amr_multibox.py``) against
ibamr_tpu at f64 on the CPU. The host clustering gives identical
components and boxes on the tag sets of ``tests/test_amr_multibox.py``
and on seeded random tag fields; the K = 2 window integrator on the
two-blob set-up of that file (48^2) takes the same origins at every
regrid, with fields within 1e-12 relative and totals within 1e-13
relative. The reference file's two long runs (400 and 60 steps) are
``slow`` here too."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr_multibox as jmb
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu_torch import amr_multibox as tmb
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


EXACT = 1e-12


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _tags(shape, *blocks):
    t = np.zeros(shape, dtype=bool)
    for b in blocks:
        t[b] = True
    return t


REF_TAGS = [
    (_tags((32, 32), np.s_[4:8, 4:8], np.s_[20:26, 20:26]), (8, 8), None),
    (_tags((32, 32), np.s_[10:12, 10:12], np.s_[14:16, 14:16]), (8, 8),
     None),
    (_tags((32, 32), np.s_[4:7, 4:7], np.s_[22:25, 22:25]), (8, 8),
     np.asarray([[20, 20], [3, 3]])),
    (np.zeros((16, 16), dtype=bool), (4, 4), np.asarray([[2, 2], [8, 8]])),
    (_tags((32, 32), np.s_[10:12, 10:12], np.s_[13:15, 10:12]), (8, 8),
     None),
]


def _random_tags(seed):
    rng = np.random.default_rng(seed)
    shape = (32, 32) if seed % 2 else (20, 24, 16)
    return rng.random(shape) > 0.985


def _same_clusters(tags, box_shape, prev, K=2):
    jc = jmb.connected_components(tags)
    tc = tmb.connected_components(tags)
    assert [c.tolist() for c in tc] == [c.tolist() for c in jc]
    try:
        ref = jmb.cluster_boxes(tags, K, box_shape, clearance=2, prev=prev)
    except ValueError as e:
        with pytest.raises(ValueError, match="disjoint"):
            tmb.cluster_boxes(tags, K, box_shape, clearance=2, prev=prev)
        return str(e)
    got = tmb.cluster_boxes(tags, K, box_shape, clearance=2, prev=prev)
    assert got.dtype == ref.dtype and np.array_equal(got, ref)
    return got


@pytest.mark.parametrize("case", range(len(REF_TAGS)))
def test_clusters_match_on_reference_tag_sets(case):
    tags, box_shape, prev = REF_TAGS[case]
    _same_clusters(tags, box_shape, prev)


@pytest.mark.parametrize("seed", range(5))
def test_clusters_match_on_random_tag_fields(seed):
    tags = _random_tags(seed)
    box = (6,) * tags.ndim
    for K in (1, 2, 3):
        _same_clusters(tags, box, None, K=K)
    prev = np.full((2, tags.ndim), 3)
    _same_clusters(tags, box, prev, K=2)


def test_impossible_layout_raises_in_both():
    msg = _same_clusters(np.zeros((16, 16), dtype=bool), (8, 8), None)
    assert "disjoint" in msg


def _two_gauss(lib, x0a, y0a, x0b, y0b, w):
    def fn(coords):
        x, y = coords
        return (lib.exp(-((x - x0a) ** 2 + (y - y0a) ** 2) / w ** 2)
                + lib.exp(-((x - x0b) ** 2 + (y - y0b) ** 2) / w ** 2))
    return fn


def _u(lib, amp):
    def u_fn(coords, d):
        x = coords[0]
        if d == 0:
            return -amp * lib.sin(2.0 * np.pi * x)
        return lib.zeros_like(x)
    return u_fn


def _pair(box=(12, 12), amp=0.4, kappa=1e-3, thr=0.03):
    kw = dict(n=(48, 48), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    js = jmb.MultiBoxDynamicAdvDiff(JGrid(**kw), box, K=2, kappa=kappa,
                                    u_fn=_u(jnp, amp), tag_threshold=thr,
                                    dtype=jnp.float64)
    ts = tmb.MultiBoxDynamicAdvDiff(TGrid(**kw), box, K=2, kappa=kappa,
                                    u_fn=_u(torch, amp), tag_threshold=thr,
                                    device="cpu")
    return js, ts


def _check(jst, tst):
    assert tst.lo.tolist() == np.asarray(jst.lo).tolist()
    assert _rel(jst.Qc, tst.Qc) <= EXACT
    assert _rel(jst.Qf, tst.Qf) <= EXACT


def test_regrid_cycles_match_reference():
    """Two blobs advected apart: two regrid cycles of 10 steps give the
    same origins, fields and totals."""
    js, ts = _pair()
    jst = js.initialize(_two_gauss(jnp, 0.36, 0.5, 0.64, 0.5, 0.06))
    tst = ts.initialize(_two_gauss(torch, 0.36, 0.5, 0.64, 0.5, 0.06))
    _check(jst, tst)
    t0 = float(ts.total(tst))
    assert abs(t0 - float(js.total(jst))) <= 1e-13 * abs(t0)
    tst = convert.multibox_state(jst, "cpu")
    for _ in range(2):
        jst, tst = js.regrid_state(jst), ts.regrid_state(tst)
        _check(jst, tst)
        jst = js._jit_advance(jst, 2.5e-4, 10)
        tst = ts.advance(tst, 2.5e-4, 10)
        _check(jst, tst)
        assert abs(float(ts.total(tst)) - float(js.total(jst))) \
            <= 1e-13 * abs(t0)
        assert abs(float(ts.total(tst)) - t0) <= 1e-13 * abs(t0)


@pytest.mark.slow
def test_two_blobs_tracked_like_reference():
    """The reference's 400-step two-blob run, regrid every 10 steps."""
    js, ts = _pair()
    jst = js.initialize(_two_gauss(jnp, 0.36, 0.5, 0.64, 0.5, 0.06))
    tst = convert.multibox_state(jst, "cpu")
    jst = js.advance_regridding(jst, 2.5e-4, 400, regrid_interval=10)
    tst = ts.advance_regridding(tst, 2.5e-4, 400, regrid_interval=10)
    _check(jst, tst)
    assert abs(float(ts.total(tst)) - float(js.total(jst))) \
        <= 1e-13 * abs(float(js.total(jst)))


@pytest.mark.slow
def test_regrid_invariance_like_reference():
    """The reference's regrid-invariance set-up: 60 steps regridding
    every 6, and 60 steps with the windows in place."""
    js, ts = _pair(box=(14, 14), amp=0.25, kappa=2e-3, thr=0.02)
    ic = (0.35, 0.5, 0.65, 0.5, 0.06)
    jst = js.initialize(_two_gauss(jnp, *ic))
    tst = convert.multibox_state(jst, "cpu")
    _check(js.advance_regridding(jst, 2.5e-4, 60, regrid_interval=6),
           ts.advance_regridding(tst, 2.5e-4, 60, regrid_interval=6))
    _check(jax.jit(lambda s: js.advance(s, 2.5e-4, 60))(jst),
           ts.advance(tst, 2.5e-4, 60))
