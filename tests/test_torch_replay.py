"""Port parity of the flight recorder, the shadow audit and replay
(``utils/flight_recorder.py``, ``solvers/escalation.py``,
``tools/replay.py``) against ``ibamr_tpu`` on the CPU.

The f64 shadow audit of a bf16 substep measures the same drift as the
reference's (within 1e-6 absolute: the bf16 path rounds to 8 bits) and
gives the same breach verdict under each package's bf16 drift injector;
their divergence gaps agree within 1e-4 (single cells, a bf16 ulp).
The port's capsules replay bitwise (``reproduced``), an override of
``spectral_dtype=f64`` classifies ``precision_dependent``, and a dt cure
``dt_dependent``."""

import jax
import jax.numpy as jnp
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.solvers import escalation as jesc
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.solvers import escalation as tesc
from ibamr_tpu_torch.tools import fault_injection as tfi
from ibamr_tpu_torch.tools.replay import (ReplayError, load_capsule,
                                          newest_capsule, read_incidents,
                                          rebuild, replay)
from ibamr_tpu_torch.utils.flight_recorder import (FlightRecorder,
                                                   describe_integrator,
                                                   factory_spec)
from ibamr_tpu_torch.utils.hierarchy_driver import (HierarchyDriver,
                                                    RunConfig)
from ibamr_tpu_torch.utils.supervisor import ResilientDriver
from tools import fault_injection as jfi


@pytest.fixture(autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _pair():
    """The drills' 16^2 f32 Taylor-Green velocity at bf16 spectral
    precision in both packages (a smooth field: few spectral modes, so
    the two packages' FFT roundoff does not move a bf16 rounding)."""
    jg = JGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ji = JINS(jg, rho=1.0, mu=0.05, dtype=jnp.float32,
              spectral_dtype="bf16")
    ti, _ = tfi._tg16_setup(spectral_dtype="bf16", device="cpu")
    xf, yc = jg.face_centers(0, jnp.float32)
    xc, yf = jg.face_centers(1, jnp.float32)
    u = jnp.sin(2 * jnp.pi * xf) * jnp.cos(2 * jnp.pi * yc) + 0 * yc
    v = -jnp.cos(2 * jnp.pi * xc) * jnp.sin(2 * jnp.pi * yf) + 0 * xc
    js = ji.initialize(u0_arrays=(u, v))
    return ji, js, ti, convert.ins_state(js, device="cpu")


@pytest.mark.parametrize("inject", [False, True])
def test_shadow_audit_drift_matches_reference(inject):
    ji, js, ti, ts = _pair()
    jaud, taud = jesc.ShadowAuditor(every=1), tesc.ShadowAuditor(every=1)
    out = {}
    for name, aud, integ, st, ctx, exc in (
            ("j", jaud, ji, js, jfi.bf16_drift_injector,
             jesc.PrecisionDrift),
            ("t", taud, ti, ts, tfi.bf16_drift_injector,
             tesc.PrecisionDrift)):
        with (ctx(scale=0.35) if inject else _null()):
            jax.clear_caches()
            try:
                aud.audit(integ, st, 1e-3, step=4)
                out[name] = (False, aud.last)
            except exc as e:
                out[name] = (True, aud.last)
                assert e.step == 4 and e.spectral_dtype == "bf16"
    assert out["t"][0] == out["j"][0] == inject
    tr, jr = out["t"][1], out["j"][1]
    assert abs(tr["drift"] - jr["drift"]) <= 1e-6
    # the divergence gap reads single cells, where an operand that lands
    # on the other side of a bf16 rounding boundary (f32 roundoff apart
    # in the two packages) moves it by a bf16 ulp of the field (2^-8)
    assert abs(tr["div_drift"] - jr["div_drift"]) <= 1e-4
    assert tr["spectral_dtype"] == jr["spectral_dtype"] == "bf16"
    assert (tr["drift"] > 0.02) == inject


class _null:
    def __enter__(self):
        return None

    def __exit__(self, *a):
        return False


def test_replay_drill_escalates_and_classifies(tmp_path):
    got = tfi.run_replay_smoke(str(tmp_path), device="cpu")
    assert got["baseline_verdict"] == "reproduced"
    assert got["override_verdict"] == "precision_dependent"
    rec = [r for r in got["incidents"]
           if r["event"] == "precision_escalation"][0]
    assert (rec["spectral_dtype_before"], rec["spectral_dtype_after"]) == \
        ("bf16", "f32")
    manifest, arrays = load_capsule(rec["replay"])
    assert manifest["fingerprint"]["injectors"] == {
        "bf16_drift": {"scale": 0.35}}
    assert manifest["fingerprint"]["integrator"]["kind"] == "ins"
    assert sorted(arrays) == sorted(manifest["leaf_order"])
    assert newest_capsule(str(tmp_path)) == rec["replay"]
    assert read_incidents(str(tmp_path / "incidents.jsonl"))[0]["schema"] \
        == 3


def test_divergence_capsule_replays_bitwise_and_dt_cures(tmp_path):
    integ, st0 = tfi._tg16_setup(device="cpu", dtype=torch.float64)
    inj = dict(at_step=5, leaf_path="u[1]", dt_gate=0.99e-3)
    rec = FlightRecorder(capacity=3, spec=factory_spec(
        "ibamr_tpu_torch.tools.fault_injection", "_tg16_setup",
        device="cpu", dtype="float64"))
    with tfi.recorded("nan", **inj):
        drv = HierarchyDriver(integ, RunConfig(dt=1e-3, num_steps=8,
                                               restart_interval=4,
                                               health_interval=2),
                              step_fn=tfi.nan_injector_step(integ.step,
                                                            **inj),
                              recorder=rec)
        sup = ResilientDriver(drv, str(tmp_path), handle_signals=False)
        out = sup.run(st0)
    assert int(out.k) == 8 and rec.snapshots >= 4 and rec.overhead_s > 0
    div = [r for r in sup.incidents if r["event"] == "divergence"]
    assert len(div) == 1 and div[0]["rollback_step"] == 4
    cap = div[0]["replay"]
    manifest, _ = load_capsule(cap)
    assert manifest["chunk"] == {"start_step": 4, "length": 2, "dt": 1e-3}
    assert manifest["post"]["finite"] is False
    assert len(rec.run_id(drv)) == 16
    base = replay(cap)
    assert base["verdict"] == "reproduced" and base["bitwise"]
    cured = replay(cap, dt_scale=0.5)
    assert cured["verdict"] == "reproduced" and cured["dt_dependent"]
    # the recorded INS spec rebuilds the same integrator
    spec = describe_integrator(integ)
    integ2, st = rebuild({"fingerprint": {"integrator": spec}})
    assert describe_integrator(integ2) == spec and st.u[0].shape == (16, 16)
    with pytest.raises(ReplayError):
        rebuild({"fingerprint": {"integrator": spec}},
                overrides={"engine": "scatter"})


def test_fingerprint_is_canonical():
    integ, _ = tfi._tg16_setup(device="cpu")
    cfg = RunConfig(dt=1e-3, num_steps=4)
    a = FlightRecorder(extra_fingerprint={"b": 1, "a": {"y": 2, "x": 3}})
    b = FlightRecorder(extra_fingerprint={"a": {"x": 3, "y": 2}, "b": 1})
    a.observe(integ, cfg)
    b.observe(integ, cfg)
    assert a.fingerprint() == b.fingerprint() and a.run_id() == b.run_id()
    fp = a.fingerprint()
    assert fp["platform"] == "cpu" and fp["spectral_dtype"] == "f32"
    assert fp["integrator"]["kind"] == "ins"
