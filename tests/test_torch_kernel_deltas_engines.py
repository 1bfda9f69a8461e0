"""Port parity of the three kernel engines at IB_6 and BSPLINE_3 and of
one coupled step at IB_6, on the CPU (where the engines run the
kernels' plain versions) at f64. ``pallas_packed``
(``PackedKernelInteraction``), ``pallas`` (``TileKernelInteraction``) and
``hybrid_packed`` (``HybridKernelInteraction``): ``spread_vel`` and
``interpolate_vel`` of forces and a MAC field at markers whose supports
reach past every face, the overflow paths included, against the
reference's engines of the same layout, sums and weights within
``1e-12·max|ref|``: its ``packed`` engine (``PackedInteraction``) for
the packed layout and its ``mxu`` engine (``FastInteraction``) for the
per-tile one. Its Pallas engines cannot trace IB_6's table, and at
BSPLINE_3 they would cost ~2 s an interpret-mode call (the f64 files
hold the plain kernels to those Pallas programs). Then one midpoint step
of the 16³ shell on ``pallas_packed`` at IB_6 against the reference's
``build_shell_example`` on ``packed`` from the same state, within
``1e-10·max|ref|`` of X, U, u and p."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from _kernel_deltas import N_CELLS, grids, markers
from ibamr_tpu.models.shell3d import build_shell_example as jbuild
from ibamr_tpu.ops.interaction_fast import FastInteraction as JFast
from ibamr_tpu.ops.interaction_packed import PackedInteraction as JPacked
from ibamr_tpu.ops.interaction_packed import suggest_chunks
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.models.shell3d import build_shell_example as tbuild
from ibamr_tpu_torch.ops import cuda_interaction as ci

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_thread():
    # six xdist workers oversubscribe the cores otherwise
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _engines(engine, kernel, X):
    jg, tg = grids()
    if engine == "pallas":
        return (JFast(jg, kernel=kernel, tile=8, cap=128),
                ci.TileKernelInteraction(tg, kernel=kernel, tile=8, cap=128,
                                         device="cpu"))
    Q = suggest_chunks(jg, X, kernel=kernel, tile=8, chunk=32, slack=1.3)
    kw = dict(kernel=kernel, tile=8, chunk=32, nchunks=Q)
    cls = (ci.PackedKernelInteraction if engine == "pallas_packed"
           else ci.HybridKernelInteraction)
    return JPacked(jg, **kw), cls(tg, device="cpu", **kw)


@pytest.mark.parametrize("kernel", ["IB_6", "BSPLINE_3"])
@pytest.mark.parametrize("engine", ["pallas_packed", "pallas",
                                    "hybrid_packed"])
def test_kernel_engines_match_reference(engine, kernel):
    X, F, u = markers(60, np.float64)
    je, te = _engines(engine, kernel, X)
    assert te.kernel == kernel
    jX, tX = jnp.asarray(X), torch.tensor(X)
    jb, tb = je.buckets(jX), te.buckets(tX)
    for a, b in zip(je.spread_vel(jnp.asarray(F), jX, b=jb),
                    te.spread_vel(torch.tensor(F), tX, b=tb)):
        assert _rel(a, b) <= TOL
    assert _rel(je.interpolate_vel(tuple(map(jnp.asarray, u)), jX, b=jb),
                te.interpolate_vel(tuple(map(torch.tensor, u)), tX,
                                   b=tb)) <= TOL


def test_coupled_step_on_pallas_packed_at_ib6_matches_reference():
    shell = dict(n_cells=N_CELLS[0], n_lat=8, n_lon=8, kernel="IB_6")
    jinteg, js = jbuild(use_fast_interaction="packed", dtype=jnp.float64,
                        engine_fallback=False, **shell)
    tinteg, _ = tbuild(use_fast_interaction="pallas_packed",
                       dtype=torch.float64, device="cpu", **shell)
    assert isinstance(tinteg.ib.fast, ci.PackedKernelInteraction)
    assert tinteg.ib.fast.kernel == "IB_6"
    assert tinteg.ib.fast.nchunks == jinteg.ib.fast.nchunks
    ts = convert.ib_state(js, device="cpu")
    js, _ = jax.jit(jinteg.step_with_stats, static_argnums=1)(js, 5e-3)
    ts, _ = tinteg.step_with_stats(ts, 5e-3)
    for a, b in ((js.X, ts.X), (js.U, ts.U), (js.ins.p, ts.ins.p),
                 *zip(js.ins.u, ts.ins.u)):
        assert _rel(a, b) <= 1e-10
