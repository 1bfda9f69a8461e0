"""Port parity of the hybrid transfer engines (``hybrid_bf16``, alias
``hybrid_packed_bf16``, and ``hybrid_packed``): the ``packed_spread``
kernel's plain version for the spread and the ``packed`` engine's interp,
over one shared packed context, in ibamr_tpu_torch against the
reference's ``HybridPackedInteraction`` (its Pallas spread in interpret
mode) on the CPU. The cases mirror ``tests/test_hybrid_engine.py``: the
spread within 2e-6 of the field's scale at f32, the f32 interp within
2e-6 and the bf16 interp within 2e-2 of the markers' scale, one refresh
of the shared context; then 3 midpoint steps of the 16^3 shell on each
engine against the reference: 1e-10 relative at f64 (``hybrid_packed``)
and the JAX test's own 5e-5 on X at f32 with bf16 operands."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.models.shell3d import build_shell_example as jbuild
from ibamr_tpu.ops.interaction_packed import suggest_chunks
from ibamr_tpu.ops.pallas_interaction import HybridPackedInteraction
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.models.shell3d import build_shell_example as tbuild
from ibamr_tpu_torch.ops import cuda_interaction as ci

SPREAD_TOL = 2e-6
INTERP_TOL = {None: 2e-6, "bf16": 2e-2}
RTOL_F64 = 1e-10
X_ATOL_BF16 = 5e-5
SHELL = dict(n_cells=16, n_lat=8, n_lon=8)
DT = 5e-3


def _engines(n, X, compute_dtype):
    box = dict(x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    jg, tg = JGrid(n=n, **box), TGrid(n=n, **box)
    Q = suggest_chunks(jg, X, tile=8, chunk=64, slack=1.3)
    je = HybridPackedInteraction(
        jg, kernel="IB_4", tile=8, chunk=64, nchunks=Q, interpret=True,
        compute_dtype=jnp.bfloat16 if compute_dtype else None)
    te = ci.HybridKernelInteraction(
        tg, kernel="IB_4", tile=8, chunk=64, nchunks=Q,
        compute_dtype=torch.bfloat16 if compute_dtype else None,
        device="cpu")
    return je, te


def _err(ref, got):
    """max |got - ref| over max |ref|."""
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.numpy() - ref)) / np.max(np.abs(ref)))


@pytest.mark.parametrize("compute_dtype", [None, "bf16"])
def test_hybrid_matches_reference_on_one_shared_context(compute_dtype):
    rng = np.random.default_rng(0 if compute_dtype is None else 2)
    n = (16, 16, 32)
    X = rng.uniform(0, 1, (300, 3)).astype(np.float32)
    F = rng.standard_normal((300, 3)).astype(np.float32)
    u = [rng.standard_normal(n).astype(np.float32) for _ in range(3)]
    je, te = _engines(n, X, compute_dtype)
    dX = 0.2 / 16 * rng.uniform(-1, 1, X.shape).astype(np.float32)

    @jax.jit
    def reference(F, X, Xh, u):
        b = je.buckets(X)                 # ONE context, both directions
        bh, hit = je.refresh(b, Xh)       # and its refresh at X + dX
        return (b.slot_of_marker, je.spread_vel(F, X, b=b),
                je.interpolate_vel(u, X, b=b), bh.Xb, hit,
                je.spread_vel(F, Xh, b=bh))

    (jslot, jf, jU, jXbh, jhit, jfh) = reference(
        jnp.asarray(F), jnp.asarray(X), jnp.asarray(X + dX),
        [jnp.asarray(c) for c in u])
    tb = te.buckets(torch.tensor(X))
    np.testing.assert_array_equal(tb.slot_of_marker.numpy(),
                                  np.asarray(jslot))
    before = dict(ci.LAUNCHES)
    for a, b in zip(jf, te.spread_vel(torch.tensor(F), torch.tensor(X),
                                      b=tb)):
        assert b.dtype == torch.float32
        assert _err(a, b) <= SPREAD_TOL
    U = te.interpolate_vel([torch.tensor(c) for c in u], torch.tensor(X),
                           b=tb)
    assert _err(jU, U) <= INTERP_TOL[compute_dtype]
    # CPU tensors run the plain versions: no kernel launch is counted
    assert ci.LAUNCHES == before

    tr, thit = te.refresh(tb, torch.tensor(X + dX))
    assert thit is bool(jhit) is True
    np.testing.assert_array_equal(tr.Xb.numpy(), np.asarray(jXbh))
    for a, b in zip(jfh, te.spread_vel(torch.tensor(F), torch.tensor(X + dX),
                                       b=tr)):
        assert _err(a, b) <= SPREAD_TOL


@pytest.mark.parametrize("engine,dtype", [("hybrid_packed", "f64"),
                                          ("hybrid_bf16", "f32")])
def test_three_midpoint_steps_match_reference(engine, dtype):
    jdt, tdt = ((jnp.float64, torch.float64) if dtype == "f64"
                else (jnp.float32, torch.float32))
    jinteg, js = jbuild(use_fast_interaction=engine, dtype=jdt,
                        engine_fallback=False, **SHELL)
    tinteg, _ = tbuild(use_fast_interaction=engine, dtype=tdt, device="cpu",
                       **SHELL)
    assert tinteg.ib.engine_name == jinteg.ib.engine_name == engine
    assert isinstance(tinteg.ib.fast, ci.HybridKernelInteraction)
    assert tinteg.ib.fast.nchunks == jinteg.ib.fast.nchunks
    ts = convert.ib_state(js, device="cpu")
    jstep = jax.jit(jinteg.step_with_stats, static_argnums=1)
    for _ in range(3):
        js, jstats = jstep(js, DT)
        ts, tstats = tinteg.step_with_stats(ts, DT)
        assert bool(jstats["refresh_hit"]) is tstats["refresh_hit"]
    assert ts.X.dtype == tdt
    if dtype == "f64":
        for a, b in ((js.X, ts.X), (js.U, ts.U), (js.ins.p, ts.ins.p),
                     *zip(js.ins.u, ts.ins.u)):
            assert _err(a, b) <= RTOL_F64
    else:
        assert float(np.max(np.abs(ts.X.numpy() - np.asarray(js.X)))) \
            <= X_ATOL_BF16


def test_engine_names_build_like_reference():
    from ibamr_tpu_torch.utils.input_db import parse_input_string

    for name, bf16 in (("hybrid_bf16", True), ("hybrid_packed_bf16", True),
                       ("hybrid_packed", False)):
        integ, state = tbuild(use_fast_interaction=name, device="cpu",
                              **SHELL)
        eng = integ.ib.fast
        assert integ.ib.engine_name == name
        assert eng.compute_dtype is (torch.bfloat16 if bf16 else None)
        assert eng.overflow_cap == 2048
    # an input file that names the engine runs
    db = parse_input_string('IBMethod { delta_fcn = "IB_4"  '
                            'transfer_engine = "hybrid_bf16" }')
    integ, state = tbuild(input_db=db, device="cpu", **SHELL)
    assert integ.ib.engine_name == "hybrid_bf16"
    state, stats = integ.step_with_stats(state, DT)
    assert stats["refresh_hit"] is True
    assert bool(torch.isfinite(state.X).all())
