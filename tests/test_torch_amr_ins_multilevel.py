"""Port parity of the L-level composite INS and IB
(``amr_ins_multilevel.py``) against ibamr_tpu at f64 on the CPU, on the
set-ups of ``tests/test_amr_ins_multilevel.py`` (a 32^2 root with two
nested 16^2 boxes), inputs from a numpy
seed. Projections take the same FGMRES restart counts (with the default
and the FAC preconditioner, directly and through the integrator's
``precond_factory``) and agree to 1e-10 relative. The IB coupling and the
regrid have files of their own (``..._ib.py``, ``..._regrid.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_ins as jins
from ibamr_tpu import amr_ins_multilevel as jml
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.solvers import fac as jfac
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_ins_multilevel as tml
from ibamr_tpu_torch import convert
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


SOLVE = 1e-10


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _grids(n, dim=2):
    kw = dict(n=(n,) * dim, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    return JGrid(**kw), TGrid(**kw)


def _boxes(spec):
    return ([jamr.FineBox(lo=l, shape=s) for l, s in spec],
            [tamr.FineBox(lo=l, shape=s) for l, s in spec])


BOXES3 = [((8, 8), (16, 16)), ((8, 8), (16, 16))]


def _random_slaved(levels, seed):
    rng = np.random.default_rng(seed)
    us = []
    for l, spec in enumerate(levels):
        g = spec.grid
        us.append(tuple(jnp.asarray(0.1 * rng.standard_normal(tuple(
            g.n[e] + (1 if (l > 0 and e == d) else 0)
            for e in range(g.dim)))) for d in range(g.dim)))
    for l in range(len(levels) - 2, -1, -1):
        us[l] = jins.scatter_box_mac_to_coarse(
            us[l], jamr.restrict_mac(us[l + 1]), levels[l + 1].box)
    return us


def _close_fields(ref, got, tol):
    for a, b in zip(ref, got):
        for ca, cb in zip(a, b):
            assert _rel(ca, cb) <= tol


@pytest.mark.parametrize("depth", [2, 3])
@pytest.mark.parametrize("fac", [False, True])
def test_projection_matches_reference(depth, fac):
    jg, tg = _grids(32)
    jb, tb = _boxes(BOXES3[:depth - 1])
    jl = jml.build_hierarchy(jg, jb)
    tl = convert.level_specs(jl)
    assert [s.box for s in tl] == [None] + tb
    jM = jfac.FACMultilevelPoisson(jl).precondition if fac else None
    tM = tfac.FACMultilevelPoisson(tl, device="cpu").precondition \
        if fac else None
    jp = jml.MultiLevelCompositeProjection(jl, tol=1e-10, m=40, restarts=10,
                                           preconditioner=jM)
    tp = tml.MultiLevelCompositeProjection(tl, tol=1e-10, m=40, restarts=10,
                                           preconditioner=tM, device="cpu")
    us = _random_slaved(jl, seed=depth)
    ref, jit = jp.project(us)
    got, tit = tp.project(tuple(tuple(torch.tensor(np.asarray(c))
                                      for c in u) for u in us))
    assert tit == int(jit)
    _close_fields(ref, got, SOLVE)
    assert float(tp.max_divergence(got)) < 1e-8


def test_precond_factory_takes_fac():
    """FAC through the integrator's ``precond_factory``: the same restart
    counts as the reference's, step by step."""
    jg, tg = _grids(32)
    jb, tb = _boxes(BOXES3)
    ji = jml.MultiLevelINS(jg, jb, mu=0.002, proj_tol=1e-10,
                           precond_factory=lambda lv: jfac.
                           FACMultilevelPoisson(lv).precondition)
    ti = tml.MultiLevelINS(tg, tb, mu=0.002, proj_tol=1e-10,
                           precond_factory=lambda lv: tfac.
                           FACMultilevelPoisson(lv, device="cpu")
                           .precondition, device="cpu")
    js = ji.initialize(_vortex, dtype=jnp.float64)
    ts = convert.multilevel_ins_state(js, "cpu")
    ji.proj.record_stats = True
    jstep = jax.jit(ji.step, static_argnums=1)
    for _ in range(2):
        js, ts = jstep(js, 6.25e-4), ti.step(ts, 6.25e-4)
        jax.effects_barrier()
        assert ti.proj.last_solve_stats["iters"] == \
            ji.proj.last_solve_stats["iters"]
    _close_fields(js.us, ts.us, SOLVE)


_A, _S = 0.05, 0.08


def _vortex(d, mesh):
    x, y = mesh
    psi = _A * np.exp(-((x - 0.5) ** 2 + (y - 0.5) ** 2) / _S ** 2)
    if d == 0:
        return psi * (-2.0 * (y - 0.5) / _S ** 2)
    return psi * (2.0 * (x - 0.5) / _S ** 2)

