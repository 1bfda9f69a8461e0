"""Port parity of the explicit IB coupling on the L-level composite
hierarchy (``amr_ins_multilevel.py``) against ibamr_tpu at f64 on the
CPU, on the set-ups of ``tests/test_amr_ins_multilevel.py``, from the
same initial state (``convert.multilevel_ib_state``). A membrane inside
the finest box of a 32^2 root with two nested 16^2 boxes, and a shell
inside the finest box of a 24^3 root with two 12^3 boxes, 10 steps each:
X within 1e-10 and every level's u within 1e-10 relative (the 3D shell is
``slow``: ~60 s on one core)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_ins_multilevel as jml
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ib import IBMethod as JIB
from ibamr_tpu.models.membrane2d import make_circle_membrane as jmembrane
from ibamr_tpu.models.shell3d import make_spherical_shell as jshell
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_ins_multilevel as tml
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators.ib import IBMethod as TIB
from ibamr_tpu_torch.models.membrane2d import make_circle_membrane as tmembrane
from ibamr_tpu_torch.models.shell3d import make_spherical_shell as tshell


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


SOLVE = 1e-10
BOXES3 = [((8, 8), (16, 16)), ((8, 8), (16, 16))]


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _close_fields(ref, got, tol):
    """Every level's u within ``tol`` of that level's max |u| (one
    component may be ~0 in a flow along one axis)."""
    for a, b in zip(ref, got):
        scale = max(float(np.max(np.abs(np.asarray(c)))) for c in a)
        for ca, cb in zip(a, b):
            err = np.max(np.abs(cb.detach().numpy() - np.asarray(ca)))
            assert err <= tol * scale


def _grids(n, dim=2):
    kw = dict(n=(n,) * dim, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    return JGrid(**kw), TGrid(**kw)


def _boxes(spec):
    return ([jamr.FineBox(lo=l, shape=s) for l, s in spec],
            [tamr.FineBox(lo=l, shape=s) for l, s in spec])


def _ib_pair(struct_j, struct_t, kernel="IB_4"):
    return (JIB(struct_j.force_specs(dtype=jnp.float64), kernel=kernel),
            TIB(struct_t.force_specs(dtype=torch.float64, device="cpu"),
                kernel=kernel))


def _check_ib(js, ts):
    assert _rel(js.X, ts.X) <= SOLVE
    _close_fields(js.fluid.us, ts.fluid.us, SOLVE)


def test_membrane_ib_3level_matches_reference():
    args = (64, 0.08, (0.5, 0.5))
    kw = dict(stiffness=2.0, aspect=1.2, rest_length_factor=0.7)
    jib, tib = _ib_pair(jmembrane(*args, **kw), tmembrane(*args, **kw))
    jg, tg = _grids(32)
    jb, tb = _boxes(BOXES3)
    ji = jml.MultiLevelIBINS(jg, jb, jib, mu=0.02, proj_tol=1e-10)
    ti = tml.MultiLevelIBINS(tg, tb, tib, mu=0.02, proj_tol=1e-10,
                             device="cpu")
    js = ji.initialize(jnp.asarray(jmembrane(*args, **kw).vertices,
                                   jnp.float64))
    ts = convert.multilevel_ib_state(js, "cpu")
    js = jml.advance_multilevel_ib(ji, js, 2.5e-4, 10)
    ts = tml.advance_multilevel_ib(ti, ts, 2.5e-4, 10)
    _check_ib(js, ts)
    assert float(ti.core.max_divergence(ts.fluid)) < 1e-8


@pytest.mark.slow
def test_shell_ib_3d_matches_reference():
    args = (10, 10, 0.07, (0.5,) * 3, 1.0)
    jib, tib = _ib_pair(jshell(*args, rest_length_factor=0.8),
                        tshell(*args, rest_length_factor=0.8))
    jg, tg = _grids(24, 3)
    jb, tb = _boxes([((6, 6, 6), (12, 12, 12))] * 2)
    ji = jml.MultiLevelIBINS(jg, jb, jib, mu=0.05, proj_tol=1e-9)
    ti = tml.MultiLevelIBINS(tg, tb, tib, mu=0.05, proj_tol=1e-9,
                             device="cpu")
    js = ji.initialize(jnp.asarray(jshell(*args, rest_length_factor=0.8)
                                   .vertices, jnp.float64))
    ts = convert.multilevel_ib_state(js, "cpu")
    js = jml.advance_multilevel_ib(ji, js, 5e-4, 10)
    ts = tml.advance_multilevel_ib(ti, ts, 5e-4, 10)
    _check_ib(js, ts)

