"""Port parity for the slice as a whole: 3 midpoint steps of the 16³
flagship shell (8x8 markers) in ibamr_tpu_torch against ibamr_tpu at f64
on the CPU, on the ``pallas_packed`` and ``pallas`` engines (the
reference's Pallas programs in interpret mode, the port's plain kernel
versions), on the torch-op engines ``mxu`` and ``packed3`` and on the
``scatter`` oracle; the bf16 engines within 1e-7 (f32 sums in another
order). The reference's initial state is carried over by
``ibamr_tpu_torch.convert``. FFT backends and transfer sum orders
differ, so X, its displacement, u and p agree to 1e-10 relative."""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.models.shell3d import build_shell_example as jbuild
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.models.shell3d import build_shell_example as tbuild

RTOL = 1e-10
BF16_STEP_RTOL = 1e-7
DT = 5e-3
SHELL = dict(n_cells=16, n_lat=8, n_lon=8)


def _jname(engine):
    """The reference builder's ``use_fast_interaction`` for a name."""
    return {"scatter": False, "mxu": True}.get(engine, engine)


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.numpy() - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


@pytest.mark.parametrize("engine", ["pallas_packed", "pallas", "scatter",
                                    "mxu", "packed3"])
def test_three_midpoint_steps_match_reference(engine):
    jinteg, js = jbuild(use_fast_interaction=_jname(engine),
                        dtype=jnp.float64, engine_fallback=False, **SHELL)
    tinteg, _ = tbuild(use_fast_interaction=engine, dtype=torch.float64,
                       device="cpu", **SHELL)
    assert tinteg.ib.engine_name == engine
    ts = convert.ib_state(js, device="cpu")
    X0 = np.asarray(js.X)
    jstep = jax.jit(jinteg.step_with_stats, static_argnums=1)
    for _ in range(3):
        js, jstats = jstep(js, DT)
        ts, tstats = tinteg.step_with_stats(ts, DT)
        if engine == "pallas_packed":
            assert bool(jstats["refresh_hit"]) is tstats["refresh_hit"]
        else:
            assert jstats["refresh_hit"] is tstats["refresh_hit"] is None
    assert _rel(js.X, ts.X) < RTOL
    assert _rel(np.asarray(js.X) - X0, ts.X - torch.tensor(X0)) < RTOL
    assert _rel(js.U, ts.U) < RTOL
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) < RTOL
    assert _rel(js.ins.p, ts.ins.p) < RTOL
    assert int(ts.ins.k) == 3 and abs(float(ts.ins.t) - 3 * DT) < 1e-15


@pytest.mark.parametrize("engine", ["mxu_bf16", "packed3_bf16"])
def test_three_bf16_engine_steps_match_reference(engine):
    """The bf16 engines: the same bf16 operands, f32 sums in another
    order, so 3 steps agree within BF16_STEP_RTOL, not 1e-10."""
    jinteg, js = jbuild(use_fast_interaction=engine, dtype=jnp.float64,
                        engine_fallback=False, **SHELL)
    tinteg, _ = tbuild(use_fast_interaction=engine, dtype=torch.float64,
                       device="cpu", **SHELL)
    assert tinteg.ib.engine_name == engine
    assert tinteg.ib.fast.compute_dtype is torch.bfloat16
    ts = convert.ib_state(js, device="cpu")
    X0 = np.asarray(js.X)
    jstep = jax.jit(jinteg.step, static_argnums=1)
    for _ in range(3):
        js = jstep(js, DT)
        ts = tinteg.step(ts, DT)
    assert _rel(np.asarray(js.X) - X0, ts.X - torch.tensor(X0)) \
        < BF16_STEP_RTOL
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) < BF16_STEP_RTOL


def test_forward_euler_scatter_step_matches_reference():
    from ibamr_tpu.integrators.ib import IBExplicitIntegrator as JInteg
    from ibamr_tpu_torch.integrators.ib import IBExplicitIntegrator as TInteg

    jinteg, js = jbuild(use_fast_interaction=False, dtype=jnp.float64,
                        engine_fallback=False, **SHELL)
    tinteg, _ = tbuild(use_fast_interaction="scatter", dtype=torch.float64,
                       device="cpu", **SHELL)
    jfe = JInteg(jinteg.ins, jinteg.ib, scheme="forward_euler")
    tfe = TInteg(tinteg.ins, tinteg.ib, scheme="forward_euler")
    ts = convert.ib_state(js, device="cpu")
    for _ in range(2):
        js = jfe.step(js, DT)
        ts = tfe.step(ts, DT)
    assert _rel(js.X, ts.X) < RTOL
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) < RTOL


def test_flagship_options_not_ported_raise():
    # every engine of the registry builds now: "mxu" (True in the
    # reference's vocabulary) is the per-tile torch-op engine
    from ibamr_tpu_torch.ops.interaction_fast import FastInteraction

    for name in ("mxu", True):
        tinteg, _ = tbuild(use_fast_interaction=name, device="cpu", **SHELL)
        assert tinteg.ib.engine_name == "mxu"
        assert type(tinteg.ib.fast) is FastInteraction
    # bf16 / f64 spectral transforms and PPM convection are ported: one
    # step equals the reference's (f64 state; bf16 operands within the
    # reference suite's bf16 class)
    for kw, tol in ((dict(spectral_dtype="bf16"), 2e-2),
                    (dict(spectral_dtype="f64"), 1e-10),
                    (dict(convective_op_type="ppm"), 1e-10)):
        tinteg, ts = tbuild(use_fast_interaction="scatter",
                            dtype=torch.float64, device="cpu", **kw, **SHELL)
        jinteg, js = jbuild(use_fast_interaction=False, dtype=jnp.float64,
                            **kw, **SHELL)
        ts = tinteg.step(ts, 5e-3)
        js = jax.jit(jinteg.step, static_argnums=1)(js, 5e-3)
        for a, b in zip(js.ins.u, ts.ins.u):
            a = np.asarray(a)
            assert np.max(np.abs(b.numpy() - a)) <= tol * np.max(np.abs(a))
    with pytest.raises(ValueError, match="spectral_dtype"):
        tbuild(spectral_dtype="fp8", device="cpu", **SHELL)


def test_absent_or_auto_engine_resolves_like_reference(monkeypatch):
    # an absent engine, "auto" in the input file, or None resolves as the
    # reference does: the 64 markers of the 16^3 shell take the scatter
    # oracle (the packed promotion needs >= 4,096 markers)
    from ibamr_tpu.utils.input_db import parse_input_string as j_parse
    from ibamr_tpu_torch.utils.input_db import parse_input_string

    monkeypatch.delenv("IBAMR_TRANSFER_ENGINE", raising=False)
    monkeypatch.delenv("IBAMR_TUNING_DB", raising=False)
    tinteg, _ = tbuild(use_fast_interaction=None, device="cpu", **SHELL)
    jinteg, _ = jbuild(use_fast_interaction=None, engine_fallback=False,
                       **SHELL)
    assert tinteg.ib.engine_name == jinteg.ib.engine_name == "scatter"
    assert tinteg.ib.fast is None
    for knob in ("", 'transfer_engine = "auto"'):
        text = "IBMethod { delta_fcn = \"IB_4\" %s }" % knob
        tinteg, _ = tbuild(input_db=parse_input_string(text), device="cpu",
                           **SHELL)
        jinteg, _ = jbuild(input_db=j_parse(text), engine_fallback=False,
                           **SHELL)
        assert tinteg.ib.engine_name == jinteg.ib.engine_name == "scatter"


class _NoRefresh:
    """A transfer engine with everything but ``refresh``."""

    def __init__(self, fast):
        self.grid = fast.grid
        self.buckets = fast.buckets
        self.spread_vel = fast.spread_vel
        self.interpolate_vel = fast.interpolate_vel


def test_engine_without_refresh_rebuckets_like_reference():
    # the half-step context of an engine with no refresh is bucketed anew
    # (the reference's getattr guard); the step equals the reference's
    # step on the same engine with its slot-preserving refresh
    jinteg, js = jbuild(use_fast_interaction="pallas_packed",
                        dtype=jnp.float64, engine_fallback=False, **SHELL)
    tinteg, _ = tbuild(use_fast_interaction="pallas_packed",
                       dtype=torch.float64, device="cpu", **SHELL)
    tinteg.ib.fast = _NoRefresh(tinteg.ib.fast)
    ts = convert.ib_state(js, device="cpu")
    assert tinteg.ib.refresh(tinteg.ib.prepare(ts.X, ts.mask), ts.X,
                             ts.mask) == (None, None)
    jstep = jax.jit(jinteg.step_with_stats, static_argnums=1)
    for _ in range(2):
        js, jstats = jstep(js, DT)
        ts, tstats = tinteg.step_with_stats(ts, DT)
        assert bool(jstats["refresh_hit"]) and tstats["refresh_hit"] is None
    assert _rel(js.X, ts.X) < RTOL
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) < RTOL
