"""Port parity of the health probe (``ibamr_tpu_torch/utils/health.py``)
against ``ibamr_tpu/utils/health.py`` at f64 on the CPU: ``measure``'s
vitals on a 16^2 Taylor-Green state and on a 2D IB membrane (its
polygon-area sentinel) agree within 1e-6 relative (the vitals vector is
float32 by schema), and ``classify`` / ``check`` / ``check_lanes`` give
the same verdict sequences on the same vitals streams."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.models.membrane2d import build_membrane_example as jmem
from ibamr_tpu.utils import health as jh
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator as TINS
from ibamr_tpu_torch.models.membrane2d import build_membrane_example as tmem
from ibamr_tpu_torch.utils import health as th

RNG = np.random.default_rng(7)


def _tg(n=16):
    jg = JGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    tg = TGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    ji = JINS(jg, rho=1.0, mu=0.05, dtype=jnp.float64)
    ti = TINS(tg, rho=1.0, mu=0.05, dtype=torch.float64, device="cpu")
    xf, yc = jg.face_centers(0, jnp.float64)
    xc, yf = jg.face_centers(1, jnp.float64)
    u = jnp.sin(2 * jnp.pi * xf) * jnp.cos(2 * jnp.pi * yc) + 0 * yc
    v = -jnp.cos(2 * jnp.pi * xc) * jnp.sin(2 * jnp.pi * yf) + 0 * xc
    u = u + 1e-3 * RNG.standard_normal(u.shape)
    js = ji.initialize(u0_arrays=(u, v))
    return ji, ti, js, convert.ins_state(js, device="cpu")


def _close(a, b, rtol=1e-6, atol=1e-30):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    assert a.shape == b.shape
    fin = np.isfinite(b)
    assert (np.isfinite(a) == fin).all()
    atol = np.broadcast_to(atol, b.shape)[fin]
    scale = np.abs(b[fin])
    assert np.all(np.abs(a[fin] - b[fin]) <= rtol * scale + atol)


def test_measure_matches_reference_on_taylor_green():
    ji, ti, js, ts = _tg()
    jv = jh.HealthProbe.for_integrator(ji).measure(js, 1e-3)
    tv = th.HealthProbe.for_integrator(ti).measure(ts, 1e-3)
    assert tv.dtype == torch.float32 and tv.shape == (7,)
    _close(tv.numpy(), jv)
    assert np.isnan(np.asarray(jv)[5])             # no volume sentinel
    bad = ts._replace(p=torch.full_like(ts.p, float("nan")))
    assert th.HealthProbe.for_integrator(ti).measure(bad, 1e-3)[0] == 0.0


def test_measure_matches_reference_on_ib_membrane():
    kw = dict(n_cells=16, num_markers=32, aspect=1.3)
    ji, js = jmem(dtype=jnp.float64, **kw)
    ti, _ = tmem(dtype=torch.float64, device="cpu", **kw)
    js = ji.step(js, 1e-3)
    ts = convert.ib_state(js, device="cpu")
    jv = np.asarray(jh.HealthProbe.for_integrator(ji).measure(js, 1e-3))
    tv = th.HealthProbe.for_integrator(ti).measure(ts, 1e-3).numpy()
    # the momentum budget (slot 6) of this flow is zero but for roundoff
    # (~1e-21): held absolutely, far below the field's scale
    _close(tv, jv, atol=np.array([0, 0, 0, 0, 0, 0, 1e-17]))
    assert np.isfinite(tv[5]) and tv[5] > 0         # the polygon area


def _stream(n, lanes=None):
    """Vitals chunks: growing velocity and functional, a drifting volume
    and budget, one non-finite chunk."""
    shape = (7,) if lanes is None else (7, lanes)
    out = []
    for i in range(n):
        v = np.ones(shape)
        g = 1.0 + 0.4 * i * (1 + RNG.uniform(0, 1, shape[1:]))
        v[1] = 0.5 * g
        v[2] = 0.1 * g
        v[3] = 1e-7 * g
        v[4] = 2.0 * g ** 2
        v[5] = 1.0 - 0.004 * i * RNG.uniform(0.5, 1.5, shape[1:])
        v[6] = 3.0 + 0.01 * i
        if i == n - 2:
            v[0] = 0.0 if lanes is None else np.where(np.arange(lanes) == 1,
                                                      0.0, 1.0)
        out.append(v.astype(np.float32))
    return out


THRESH = dict(max_u_warn=1.0, max_u_fatal=3.0, cfl_fatal=0.5,
              div_warn=5e-7, func_growth_warn=4.0, func_growth_fatal=60.0,
              vol_drift_warn=0.01, vol_drift_fatal=0.05,
              budget_drift_warn=0.02, sustain=2,
              functional_fn=lambda s: 0.0, volume_fn=lambda s: 0.0,
              budget_fn=lambda s: 0.0)


def _verdicts(mod, stream):
    probe = mod.HealthProbe(**THRESH)
    out = []
    for i, v in enumerate(stream):
        level, reasons, _ = probe.classify(v, step=i, dt=1e-3)
        out.append((level, tuple(reasons), probe._warn_streak))
    probe2 = mod.HealthProbe(**THRESH)
    raised = []
    for i, v in enumerate(stream):
        try:
            probe2.check(v, step=i, dt=1e-3)
            raised.append(None)
        except mod.HealthDegraded as e:
            raised.append((e.step, tuple(e.reasons)))
    return out, raised


def test_classify_and_check_match_reference():
    stream = _stream(10)
    t = _verdicts(th, [torch.as_tensor(v) for v in stream])
    j = _verdicts(jh, [jnp.asarray(v) for v in stream])
    assert t == j
    levels = {lv for lv, _, _ in t[0]}
    assert {"ok", "warn", "fatal"} <= levels
    assert any(r is not None for r in t[1])


def test_check_lanes_matches_reference():
    B = 4
    stream = _stream(8, lanes=B)
    alive = np.array([True, True, False, True])
    res = {}
    for name, mod in (("t", th), ("j", jh)):
        probe = mod.HealthProbe(**THRESH)
        seq = []
        for i, v in enumerate(stream):
            rec = probe.check_lanes(v, step=i, dt=np.full(B, 1e-3),
                                    alive=alive)
            seq.append([(r["lane"], r["level"], r["fire"],
                         tuple(r["reasons"]), r["warn_streak"])
                        for r in rec])
            if i == 3:
                probe.reset_lane(0)
        res[name] = seq
    assert res["t"] == res["j"]
    assert any(r[2] for seq in res["t"] for r in seq)
    assert all(seq[2][1] == "quarantined" for seq in res["t"])
    with pytest.raises(ValueError):
        th.HealthProbe(**THRESH).check_lanes(stream[0][:, 0], step=0,
                                             dt=1e-3)
