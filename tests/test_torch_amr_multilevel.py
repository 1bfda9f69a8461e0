"""Port parity of the L-level advection-diffusion hierarchy
(``amr_multilevel.py``) against ibamr_tpu at f64 on the CPU, on the
set-ups of ``tests/test_amr_multilevel.py`` (a 32^2 root with two nested
16^2 boxes, a Gaussian in a constant flow). The 3-level subcycled advance
agrees to 1e-12 relative on every level, and its composite total is
conserved to 1e-13 relative."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_multilevel as jml
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_multilevel as tml
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


def _vel(mesh):
    return (0.7 + 0.0 * mesh[0], 0.3 + 0.0 * mesh[1])


def _jgauss(c):
    return jnp.exp(-((c[0] - 0.4) ** 2 + (c[1] - 0.5) ** 2) / 0.02)


def _tgauss(c):
    return torch.exp(-((c[0] - 0.4) ** 2 + (c[1] - 0.5) ** 2) / 0.02)


def _pair(n=32, kappa=0.002, scheme="centered", boxes=None):
    kw = dict(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    if boxes is None:
        boxes = [((n // 4,) * 2, (n // 2,) * 2)] * 2
    jm = jml.MultiLevelAdvDiff(JGrid(**kw), [jamr.FineBox(lo=l, shape=s)
                                             for l, s in boxes],
                               kappa=kappa, scheme=scheme, vel_fn=_vel)
    tm = tml.MultiLevelAdvDiff(TGrid(**kw), [tamr.FineBox(lo=l, shape=s)
                                             for l, s in boxes],
                               kappa=kappa, scheme=scheme, vel_fn=_vel,
                               device="cpu")
    return jm, tm


@pytest.mark.parametrize("boxes", [
    [((1, 8), (16, 16))],                       # too close to the edge
    [((8, 8), (16, 16)), ((1, 8), (16, 16))],   # level 2 hugs level 1
    [((8, 8), (16, 16)), ((8, 8), (16, 24))],   # level 2 leaves level 1
])
def test_build_hierarchy_rejects_the_same_bad_nestings(boxes):
    """The reference asserts; the port raises ValueError (``FineBox``'s
    own validation, as since the two-level port)."""
    kw = dict(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    with pytest.raises(AssertionError):
        jml.build_hierarchy(JGrid(**kw), [jamr.FineBox(lo=l, shape=s)
                                          for l, s in boxes])
    with pytest.raises(ValueError):
        tml.build_hierarchy(TGrid(**kw), [tamr.FineBox(lo=l, shape=s)
                                          for l, s in boxes])


def test_build_hierarchy_matches_reference():
    kw = dict(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    boxes = [((8, 8), (16, 16)), ((6, 8), (16, 12))]
    jl = jml.build_hierarchy(JGrid(**kw), [jamr.FineBox(lo=l, shape=s)
                                           for l, s in boxes])
    tl = tml.build_hierarchy(TGrid(**kw), [tamr.FineBox(lo=l, shape=s)
                                           for l, s in boxes])
    assert len(tl) == 3
    for a, b in zip(jl, tl):
        assert (a.grid.n, a.grid.x_lo, a.grid.x_up) == \
            (b.grid.n, b.grid.x_lo, b.grid.x_up)


@pytest.mark.parametrize("scheme", ["centered", "upwind"])
def test_three_level_advance_matches_reference(scheme):
    jm, tm = _pair(scheme=scheme)
    jQ, tQ = jm.initialize(_jgauss), tm.initialize(_tgauss)
    for a, b in zip(jQ, tQ):
        assert _rel(a, b) <= EXACT
    dt = 0.2 / 32
    jstep = jax.jit(jm.step, static_argnums=1)
    for _ in range(20):
        jQ, tQ = jstep(jQ, dt), tm.step(tQ, dt)
    for a, b in zip(jQ, tQ):
        assert _rel(a, b) <= EXACT
    assert abs(float(tm.total(tQ)) - float(jm.total(jQ))) \
        <= EXACT * abs(float(jm.total(jQ)))


def test_three_level_total_is_conserved():
    _, tm = _pair()
    Q = tm.initialize(_tgauss)
    t0 = float(tm.total(Q))
    for _ in range(20):
        Q = tm.step(Q, 0.2 / 32)
    assert abs(float(tm.total(Q)) - t0) <= 1e-13 * abs(t0)


def test_single_level_and_dtype():
    """``boxes=[]`` is the uniform periodic grid, as in the reference's
    fine-grid oracle."""
    kw = dict(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    jm = jml.MultiLevelAdvDiff(JGrid(**kw), [], kappa=0.001, vel_fn=_vel)
    tm = tml.MultiLevelAdvDiff(TGrid(**kw), [], kappa=0.001, vel_fn=_vel,
                               device="cpu")
    jQ, tQ = jm.initialize(_jgauss), tm.initialize(_tgauss)
    for _ in range(8):
        jQ, tQ = jm.step(jQ, 0.01), tm.step(tQ, 0.01)
    assert tQ[0].dtype == torch.float64
    assert _rel(jQ[0], tQ[0]) <= EXACT
