"""Port parity of the FAC preconditioners (``solvers/fac.py``) against
ibamr_tpu at f64 on the CPU, on the set-ups of ``tests/test_fac.py`` and
``tests/test_amr_ins_multilevel.py`` (32^2 root, 16^2 boxes; 16^3 in
3D), inputs from a numpy seed (the reference's lone V-cycles run under
``jax.jit``: eager they take seconds). One V-cycle agrees to 1e-12 relative; a
projection with FAC as its preconditioner takes the same FGMRES restart
count and agrees to 1e-12 relative in phi and the corrected velocity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_ins as jins
from ibamr_tpu import amr_multilevel as jml
from ibamr_tpu.bc import DomainBC as JBC
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.solvers import fac as jfac
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_ins as tins
from ibamr_tpu_torch import amr_multilevel as tml
from ibamr_tpu_torch.bc import DomainBC as TBC
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.solvers import fac as tfac


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


TOL = 1e-12


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _t(a):
    return torch.tensor(np.asarray(a))


def _setup(n, dim):
    kw = dict(n=(n,) * dim, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    lo, shape = (n // 4,) * dim, (n // 2,) * dim
    return (JGrid(**kw), TGrid(**kw), jamr.FineBox(lo=lo, shape=shape),
            tamr.FineBox(lo=lo, shape=shape))


def _fields(jg, jb, seed):
    rng = np.random.default_rng(seed)
    uc = tuple(jnp.asarray(rng.standard_normal(jg.n)) for _ in jg.n)
    uf = tuple(jnp.asarray(rng.standard_normal(tuple(
        m + (1 if d == a else 0) for a, m in enumerate(jb.fine_n))))
        for d in range(jg.dim))
    uc = jins.scatter_box_mac_to_coarse(uc, jamr.restrict_mac(uf), jb)
    return uc, uf


@pytest.mark.parametrize("dim,n", [(2, 32), (3, 16)])
def test_two_level_vcycle_matches_reference(dim, n):
    jg, tg, jb, tb = _setup(n, dim)
    rng = np.random.default_rng(3)
    r_c = rng.standard_normal(jg.n)
    r_f = rng.standard_normal(jb.fine_n)
    jf = jfac.FACCompositePoisson(jg.n, JBC.periodic(dim), jg.dx, jb)
    tf = tfac.FACCompositePoisson(tg.n, TBC.periodic(dim), tg.dx, tb,
                                  device="cpu")
    ref = jax.jit(jf.precondition)((jnp.asarray(r_c), jnp.asarray(r_f)))
    got = tf.precondition((_t(r_c), _t(r_f)))
    for a, b in zip(ref, got):
        assert _rel(a, b) <= TOL


@pytest.mark.parametrize("dim,n", [(2, 32), (3, 16)])
def test_fac_projection_matches_reference(dim, n):
    """FAC as ``CompositeProjection``'s M: equal restart counts, phi and
    the corrected velocity within 1e-12 relative."""
    jg, tg, jb, tb = _setup(n, dim)
    uc, uf = _fields(jg, jb, seed=5)
    jf = jfac.FACCompositePoisson(jg.n, JBC.periodic(dim), jg.dx, jb)
    tf = tfac.FACCompositePoisson(tg.n, TBC.periodic(dim), tg.dx, tb,
                                  device="cpu")
    jp = jins.CompositeProjection(jg, jb, tol=1e-10,
                                  preconditioner=jf.precondition)
    tp = tins.CompositeProjection(tg, tb, tol=1e-10,
                                  preconditioner=tf.precondition,
                                  device="cpu")
    ref = jp.project(uc, uf)
    got = tp.project(tuple(_t(c) for c in uc), tuple(_t(c) for c in uf))
    assert tp.last_solve_stats["iters"] == int(jp.last_solve_stats["iters"])
    assert tf.last_solve_stats["iters"] == tp.last_solve_stats["iters"]
    for a, b in zip(ref[0] + ref[1] + ref[2:], got[0] + got[1] + got[2:]):
        assert _rel(a, b) <= TOL


def _levels(n=32):
    jg, tg = (G(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
              for G in (JGrid, TGrid))
    boxes = [((8, 8), (16, 16)), ((8, 8), (16, 16))]
    return (jml.build_hierarchy(jg, [jamr.FineBox(lo=l, shape=s)
                                     for l, s in boxes]),
            tml.build_hierarchy(tg, [tamr.FineBox(lo=l, shape=s)
                                     for l, s in boxes]))


def test_multilevel_vcycle_matches_reference():
    jl, tl = _levels()
    rng = np.random.default_rng(7)
    rs = [rng.standard_normal(spec.grid.n) for spec in jl]
    ref = jax.jit(jfac.FACMultilevelPoisson(jl, nu=2).precondition)(
        tuple(jnp.asarray(r) for r in rs))
    got = tfac.FACMultilevelPoisson(tl, nu=2, device="cpu").precondition(
        tuple(_t(r) for r in rs))
    assert len(got) == 3
    for a, b in zip(ref, got):
        assert _rel(a, b) <= TOL
