"""Port parity of the moving-window regrid of the whole box chain on the
L-level composite hierarchy (``amr_ins_multilevel.py``) against
ibamr_tpu at f64 on the CPU, on the set-ups of
``tests/test_amr_ins_multilevel.py``, from the same initial state
(``convert.multilevel_ib_state``). A membrane carried by a uniform flow
through a 32^2 root with two nested 16^2 windows, 40 steps with a regrid
every 10 (``slow``): the same chain moves at the same regrids to the same
origins, and X and u agree within 1e-10; and one regrid from an
off-center chain, with the step after it."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_ins_multilevel as jml
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ib import IBMethod as JIB
from ibamr_tpu.models.membrane2d import make_circle_membrane as jmembrane
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_ins_multilevel as tml
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators.ib import IBMethod as TIB
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


SOLVE = 1e-10


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


@pytest.mark.slow
def test_regridding_moves_the_same_chain_at_the_same_steps():
    """A membrane carried by a uniform flow: the window chain moves at
    the same regrids to the same origins in both packages."""
    args = (64, 0.06, (0.4, 0.5))
    jib, tib = _ib_pair(jmembrane(*args, stiffness=1.0),
                        tmembrane(*args, stiffness=1.0))
    jg, tg = _grids(32)
    spec = [((5, 8), (16, 16)), ((8, 8), (16, 16))]
    jb, tb = _boxes(spec)
    ji = jml.MultiLevelIBINS(jg, jb, jib, mu=0.005, proj_tol=1e-10)
    ti = tml.MultiLevelIBINS(tg, tb, tib, mu=0.005, proj_tol=1e-10,
                             device="cpu")

    def vel(d, mesh):
        return 2.0 + 0.0 * mesh[0] if d == 0 else 0.0 * mesh[0]

    js = ji.initialize(jnp.asarray(jmembrane(*args, stiffness=1.0)
                                   .vertices, jnp.float64), vel_fn=vel)
    ts = convert.multilevel_ib_state(js, "cpu")
    same, st = tml.regrid_multilevel_ib(ti, ts)
    assert same is ti and st is ts
    chains = {"j": [], "t": []}

    def log(key):
        return lambda integ, s, done: chains[key].append(
            (done, tuple(spec.box.lo for spec in integ.levels[1:])))

    ji2, js = jml.advance_multilevel_ib_regridding(
        ji, js, 1e-3, 40, regrid_interval=10, on_chunk=log("j"))
    ti2, ts = tml.advance_multilevel_ib_regridding(
        ti, ts, 1e-3, 40, regrid_interval=10, on_chunk=log("t"))
    assert chains["t"] == chains["j"]
    assert ti2.levels[1].box.lo != tb[0].lo
    assert ti2.levels[2].box.lo != tb[1].lo
    _check_ib(js, ts)


def test_regrid_moves_the_same_chain():
    """One regrid from a chain whose level-2 window sits off the membrane:
    the same new chain and transferred state, then the same next step."""
    args = (64, 0.06, (0.4, 0.5))
    jib, tib = _ib_pair(jmembrane(*args, stiffness=1.0),
                        tmembrane(*args, stiffness=1.0))
    jg, tg = _grids(32)
    jb, tb = _boxes([((5, 8), (16, 16)), ((6, 8), (16, 16))])
    ji = jml.MultiLevelIBINS(jg, jb, jib, mu=0.005, proj_tol=1e-10)
    ti = tml.MultiLevelIBINS(tg, tb, tib, mu=0.005, proj_tol=1e-10,
                             device="cpu")
    js = ji.initialize(jnp.asarray(jmembrane(*args, stiffness=1.0)
                                   .vertices, jnp.float64),
                       vel_fn=lambda d, mesh: (2.0 if d == 0 else 0.0)
                       + 0.0 * mesh[0])
    ts = convert.multilevel_ib_state(js, "cpu")
    ji, js = jml.regrid_multilevel_ib(ji, js)
    ti2, ts = tml.regrid_multilevel_ib(ti, ts)
    chain = [tuple(spec.box.lo) for spec in ti2.levels[1:]]
    assert chain == [tuple(spec.box.lo) for spec in ji.levels[1:]]
    assert chain != [tuple(b.lo) for b in tb]
    _close_fields(js.fluid.us, ts.fluid.us, SOLVE)
    js = jax.jit(lambda s_: ji.step(s_, 1e-3))(js)
    ts = ti2.step(ts, 1e-3)
    _check_ib(js, ts)
