"""Port parity of the ex4 driver path: the input-file parser, the model
builder reading an input database, the run loop (``HierarchyDriver`` and
``RunConfig``), checkpoints and the metrics log of ibamr_tpu_torch
against ibamr_tpu on the CPU. Parsed databases, checkpoint bytes and log
lines must be equal; the driven 16³ shell state (f64, scatter engine)
agrees to 1e-10 relative (the FFT backends differ). The ex4 entry point
runs against the reference example's callbacks on the committed input
cut to 16³ (f32, pallas engine): its metrics log, viz files,
checkpoints and final state agree to 1e-5 relative (1e-4 for the
kinetic energy's f32 sum)."""

import io
import json
import math
import os
from pathlib import Path
from types import SimpleNamespace

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.models.shell3d import build_shell_example as jbuild
from ibamr_tpu.utils import checkpoint as jckpt
from ibamr_tpu.utils import hierarchy_driver as jdrv
from ibamr_tpu.utils.input_db import parse_input_file as j_parse_file
from ibamr_tpu.utils.input_db import parse_input_string as j_parse
from ibamr_tpu.utils.metrics import MetricsLogger as JLogger
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.models.shell3d import build_shell_example as tbuild
from ibamr_tpu_torch.utils import checkpoint as tckpt
from ibamr_tpu_torch.utils import hierarchy_driver as tdrv
from ibamr_tpu_torch.utils.input_db import parse_input_file as t_parse_file
from ibamr_tpu_torch.utils.input_db import parse_input_string as t_parse
from ibamr_tpu_torch.utils.metrics import MetricsLogger as TLogger

ROOT = Path(__file__).resolve().parent.parent
INPUTS = sorted(str(p.relative_to(ROOT))
                for p in (ROOT / "examples").rglob("input*") if p.is_file())
RTOL = 1e-10
DT = 5e-3
SHELL = dict(n_cells=16, n_lat=8, n_lon=8)
SHELL_INPUT = """
// a 16^3 shell on the pallas engine
CartesianGeometry { n_cells = 16, 16, 16
                    x_lo = 0.0, 0.0, 0.0   x_up = 1.0, 1.0, 1.0 }
INSStaggeredHierarchyIntegrator { rho = 1.5  mu = 0.02
                                  convective_op_type = "upwind" }
IBMethod { delta_fcn = "IB_4"  transfer_engine = "pallas"
           engine_fallback = FALSE }
Shell { n_lat = 8  n_lon = 10  radius = 0.2  aspect = 1.3
        stiffness = 10.0  rest_length_factor = 0.5  bend_rigidity = 0.1 }
"""


def _rel(ref, got):
    ref = np.asarray(ref)
    return float(np.max(np.abs(got.numpy() - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def test_all_committed_inputs_are_found():
    assert len(INPUTS) == 18


@pytest.mark.parametrize("path", INPUTS)
def test_input_file_parses_like_reference(path):
    ref = j_parse_file(str(ROOT / path))
    got = t_parse_file(str(ROOT / path))
    assert got.to_dict() == ref.to_dict()
    assert got.keys() == ref.keys()


def test_build_from_input_db_matches_reference():
    jinteg, js = jbuild(input_db=j_parse(SHELL_INPUT), dtype=jnp.float64)
    tinteg, ts = tbuild(input_db=t_parse(SHELL_INPUT), dtype=torch.float64,
                        device="cpu")
    assert tinteg.ib.engine_name == jinteg.ib.engine_name == "pallas"
    g, jg = tinteg.ins.grid, jinteg.ins.grid
    assert (g.n, g.x_lo, g.x_up) == (jg.n, jg.x_lo, jg.x_up)
    assert (tinteg.ins.rho, tinteg.ins.mu) == (jinteg.ins.rho, jinteg.ins.mu)
    assert tinteg.ins.convective_op_type == "upwind"
    assert tuple(tinteg.ib.fast.geom) == tuple(jinteg.ib.fast.geom)
    assert tinteg.ib.fast.overflow_cap == jinteg.ib.fast.overflow_cap
    np.testing.assert_array_equal(ts.X.numpy(), np.asarray(js.X))
    assert ts.X.shape == (80, 3)
    F = tinteg.ib.compute_force(ts.X, ts.U, ts.ins.t)
    jF = jinteg.ib.compute_force(js.X, js.U, js.ins.t)
    assert _rel(jF, F) < 1e-12


def test_input_db_engine_knob_errors():
    db = t_parse(SHELL_INPUT.replace('"pallas"', '"warp_drive"'))
    with pytest.raises(ValueError, match="warp_drive"):
        tbuild(input_db=db, device="cpu")
    # "mxu" in the file builds the per-tile torch-op engine, as the
    # reference's file knob does
    text = SHELL_INPUT.replace('"pallas"', '"mxu"')
    tinteg, _ = tbuild(input_db=t_parse(text), device="cpu")
    jinteg, _ = jbuild(input_db=j_parse(text))
    assert tinteg.ib.engine_name == "mxu"
    assert tuple(tinteg.ib.fast.geom) == tuple(jinteg.ib.fast.geom)
    assert tinteg.ib.fast.overflow_cap == jinteg.ib.fast.overflow_cap
    # the file's spectral_dtype is taken as the reference takes it (a
    # typo raises in both)
    for value, want in (('"bf16"', torch.bfloat16), ('"f64"', torch.float64),
                        ('"f32"', None)):
        text = SHELL_INPUT.replace('convective_op_type = "upwind"',
                                   f"spectral_dtype = {value}")
        tinteg, _ = tbuild(input_db=t_parse(text), device="cpu")
        jinteg, _ = jbuild(input_db=j_parse(text))
        assert tinteg.ins.spectral_dtype is want
        assert (jinteg.ins.spectral_dtype is None) == (want is None)
    text = SHELL_INPUT.replace('convective_op_type = "upwind"',
                               'spectral_dtype = "fp8"')
    for build, parse in ((tbuild, t_parse), (jbuild, j_parse)):
        with pytest.raises(ValueError, match="spectral_dtype"):
            build(input_db=parse(text), **({"device": "cpu"}
                                           if build is tbuild else {}))


@pytest.mark.parametrize("kw,err", [
    (dict(dt=0.0), ValueError), (dict(dt=float("nan")), ValueError),
    (dict(num_steps=-1), ValueError), (dict(viz_dump_interval=-2),
                                       ValueError),
    (dict(restart_interval=-1), ValueError),
    (dict(regrid_interval=-1), ValueError),
    (dict(health_interval=0), ValueError), (dict(cfl=0.0), ValueError),
    (dict(remat="dots_all"), ValueError),
    (dict(donate=True, remat="checkpoint_dots"), ValueError)])
def test_run_config_rejects(kw, err):
    args = dict(dt=1e-3, num_steps=10)
    args.update(kw)
    with pytest.raises(err):
        tdrv.RunConfig(**args)
    if err is ValueError:      # the reference rejects the same inputs
        with pytest.raises(ValueError):
            jdrv.RunConfig(**args)


def test_driver_features_not_ported_raise():
    # the probe, recorder, audit, lanes, donate, remat and (since the
    # parallel layer) the lane mesh are ported; a lane mesh refuses the
    # fleets the reference refuses
    from ibamr_tpu_torch.parallel.mesh import make_lane_mesh

    cfg = tdrv.RunConfig(dt=1e-3, num_steps=1, donate=True, remat="full")
    integ = SimpleNamespace(step=lambda s, dt: s)
    mesh = make_lane_mesh(2, device="cpu")
    for kw in (dict(lanes=2), dict(health_probe=object()),
               dict(recorder=object()), dict(shadow_audit=object()),
               dict(lanes=2, lane_mesh=mesh)):
        tdrv.HierarchyDriver(integ, cfg, **kw)
    with pytest.raises(ValueError, match="not divisible"):
        tdrv.HierarchyDriver(integ, cfg, lanes=3, lane_mesh=mesh)
    with pytest.raises(ValueError, match="fleet mode"):
        tdrv.HierarchyDriver(integ, cfg, lane_mesh=mesh)


def _recording_driver(mod, integ, cfg, seen):
    def metrics_fn(s, k):
        seen.append(("metrics", k))
        return {"step": k}

    def regrid_fn(s, k):
        seen.append(("regrid", k))
        return s
    return mod.HierarchyDriver(
        integ, cfg, metrics_fn=metrics_fn, regrid_fn=regrid_fn,
        viz_fn=lambda s, k: seen.append(("viz", k)),
        checkpoint_fn=lambda s, k: seen.append(("checkpoint", k)))


@pytest.mark.parametrize("start", [0, 4])
def test_driver_sequence_and_state_match_reference(start):
    jinteg, js = jbuild(use_fast_interaction=False, dtype=jnp.float64,
                        engine_fallback=False, **SHELL)
    tinteg, _ = tbuild(use_fast_interaction="scatter", dtype=torch.float64,
                       device="cpu", **SHELL)
    ts = convert.ib_state(js, device="cpu")
    kw = dict(dt=DT, num_steps=7, viz_dump_interval=2, restart_interval=3,
              regrid_interval=4, health_interval=3)
    jseen, tseen = [], []
    jd = _recording_driver(jdrv, jinteg, jdrv.RunConfig(**kw), jseen)
    td = _recording_driver(tdrv, tinteg, tdrv.RunConfig(**kw), tseen)
    js = jd.run(js, start_step=start)
    ts = td.run(ts, start_step=start)
    assert tseen == jseen
    assert td.history == jd.history
    if start == 4:      # resumed on a regrid boundary: the regrid fires
        assert tseen[0] == ("regrid", 4)
    assert tseen[-1] == ("viz", 7)       # the final, unaligned viz
    assert int(ts.ins.k) == int(js.ins.k) == 7 - start
    assert _rel(js.X, ts.X) < RTOL
    for a, b in zip(js.ins.u, ts.ins.u):
        assert _rel(a, b) < RTOL
    assert _rel(js.ins.p, ts.ins.p) < RTOL


def test_driver_cfl_dt_uses_the_integrator():
    tinteg, ts = tbuild(use_fast_interaction="scatter", dtype=torch.float64,
                        device="cpu", **SHELL)
    ins_state = ts.ins._replace(u=tuple(torch.full_like(c, 2.0)
                                        for c in ts.ins.u))
    assert tinteg.ins.cfl_dt(ins_state, 0.5) == 0.5 * (1 / 16) / 2.0
    assert tinteg.ins.cfl_dt(ts.ins) == math.inf
    steps = []

    class Ins:
        def cfl_dt(self, s, cfl):
            return tinteg.ins.cfl_dt(s, cfl)

        def step(self, s, dt):
            steps.append(dt)
            return s
    tdrv.HierarchyDriver(Ins(), tdrv.RunConfig(dt=1.0, num_steps=2,
                                                cfl=0.5)).run(ins_state)
    assert steps == [0.5 * (1 / 16) / 2.0] * 2


def test_divergence_raises_naming_the_bad_leaf():
    tinteg, ts = tbuild(use_fast_interaction="scatter", dtype=torch.float64,
                        device="cpu", **SHELL)
    ckpts = []

    def poisoned(s, dt):
        s = tinteg.step(s, dt)
        return s._replace(X=s.X * float("nan")) if int(s.ins.k) == 4 else s
    drv = tdrv.HierarchyDriver(
        tinteg, tdrv.RunConfig(dt=DT, num_steps=6, restart_interval=2,
                               health_interval=2),
        step_fn=poisoned, checkpoint_fn=lambda s, k: ckpts.append(k))
    with pytest.raises(tdrv.SimulationDiverged) as ei:
        drv.run(ts)
    assert ei.value.step == 4 and ei.value.bad_leaves == [".X"]
    assert ckpts == [2]          # nothing of the broken state was written


def _stepped_states():
    jinteg, js = jbuild(use_fast_interaction=False, dtype=jnp.float64,
                        engine_fallback=False, **SHELL)
    js = jax.jit(jinteg.step, static_argnums=1)(js, DT)
    tinteg, _ = tbuild(use_fast_interaction="scatter", dtype=torch.float64,
                       device="cpu", **SHELL)
    return js, convert.ib_state(js, device="cpu"), tinteg


def _bitwise(jstate, tstate):
    jl = jax.tree_util.tree_leaves(jstate)
    tl = tckpt.flatten_with_path(tstate)
    assert len(jl) == len(tl)
    for a, (_, b) in zip(jl, tl):
        a = np.asarray(a)
        assert a.dtype == b.numpy().dtype
        np.testing.assert_array_equal(a, b.numpy())


def test_checkpoints_cross_restore_bitwise(tmp_path):
    js, ts, _ = _stepped_states()
    assert tckpt.state_schema(ts) == jckpt.state_schema(js)
    # JAX writes, the port restores
    jckpt.save_checkpoint(str(tmp_path / "j"), js, 5)
    template = convert.ib_state(jax.tree_util.tree_map(jnp.zeros_like, js),
                                device="cpu")
    got, step, meta = tckpt.restore_checkpoint(str(tmp_path / "j"), template)
    assert step == 5 and meta["step"] == 5
    _bitwise(js, got)
    # the port writes, JAX restores; the two files hold the same arrays
    tckpt.save_checkpoint(str(tmp_path / "t"), ts, 5)
    assert tckpt.verify_checkpoint(str(tmp_path / "t"), 5)
    assert jckpt.verify_checkpoint(str(tmp_path / "t"), 5)
    back, step, _ = jckpt.restore_checkpoint(
        str(tmp_path / "t"), jax.tree_util.tree_map(jnp.zeros_like, js))
    assert step == 5
    _bitwise(back, ts)
    with np.load(tmp_path / "j" / "restore.00000005.npz") as a, \
            np.load(tmp_path / "t" / "restore.00000005.npz") as b:
        assert sorted(a.files) == sorted(b.files)
        assert "ins/u/0" in a.files and "X" in a.files
        for k in a.files:
            np.testing.assert_array_equal(a[k], b[k])


def test_corrupt_checkpoint_is_skipped(tmp_path):
    _, ts, _ = _stepped_states()
    d = str(tmp_path)
    tckpt.save_checkpoint(d, ts, 1)
    later = ts._replace(X=ts.X + 1.0)
    tckpt.save_checkpoint(d, later, 2)
    assert tckpt.latest_step(d) == 2
    path = os.path.join(d, "restore.00000002.npz")
    raw = bytearray(open(path, "rb").read())
    raw[len(raw) // 2] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    assert not tckpt.verify_checkpoint(d, 2)
    assert tckpt.latest_step(d) == 1
    assert tckpt.latest_step(d, verified_only=False) == 2
    with pytest.warns(UserWarning, match="skipping unverified"):
        got, step, _ = tckpt.restore_checkpoint(d, ts)
    assert step == 1 and torch.equal(got.X, ts.X)
    with pytest.raises(tckpt.CheckpointCorruptError):
        tckpt.restore_checkpoint(d, ts, step=2)
    # pruning to one checkpoint keeps the newest verified one
    tckpt._prune(d, keep=1)
    assert tckpt.latest_step(d) == 1


EX4_INPUT = ROOT / "examples/IB/explicit/ex4/input3d"
EX4_STEPS, EX4_VIZ, EX4_RESTART = 6, 2, 3
# f32 runs of the two packages: FFT backends and sum orders differ
EX4_RTOL = 1e-5
# the kinetic energy is one f32 sum of 3 x 16^3 squares, in another order
EX4_KE_RTOL = 1e-4


def _ex4_db(parse, out):
    """The committed ex4 input cut to a 16^3 grid and an 8x10 shell on
    the pallas engine, its outputs under ``out``."""
    db = parse(str(EX4_INPUT))
    main = db.get_database("Main")
    for key, val in (("log_file", str(out / "metrics.jsonl")),
                     ("viz_dirname", str(out / "viz")),
                     ("restart_dirname", str(out / "restart")),
                     ("viz_dump_interval", EX4_VIZ),
                     ("restart_interval", EX4_RESTART)):
        main.put(key, val)
    db.get_database("CartesianGeometry").put("n_cells", [16, 16, 16])
    ins = db.get_database("INSStaggeredHierarchyIntegrator")
    ins.put("dt", 1e-3)
    ins.put("num_steps", EX4_STEPS)
    db.get_database("IBMethod").put("transfer_engine", "pallas")
    shell = db.get_database("Shell")
    shell.put("n_lat", 8)
    shell.put("n_lon", 10)
    return db


def _jax_ex4_run(db):
    """``examples/IB/explicit/ex4/main.py`` on one device: its build, run
    configuration and callbacks."""
    from ibamr_tpu.models.shell3d import shell_volume
    from ibamr_tpu.utils.timers import TimerManager

    main_db = db.get_database("Main")
    ins_db = db.get_database("INSStaggeredHierarchyIntegrator")
    integ, state = jbuild(input_db=db, dtype=jnp.float32)
    step_fn = jax.jit(lambda s, d: integ.step(s, d))
    viz_dir = main_db.get_string("viz_dirname")
    rst_dir = main_db.get_string("restart_dirname")
    os.makedirs(viz_dir, exist_ok=True)
    geo = db.get_database_with_default("CartesianGeometry")
    center = tuple(0.5 * (lo + hi) for lo, hi in zip(
        geo.get_array("x_lo"), geo.get_array("x_up")))
    viz_int = main_db.get_int("viz_dump_interval", 0)
    cfg = jdrv.RunConfig(
        dt=ins_db.get_float("dt"), num_steps=ins_db.get_int("num_steps"),
        viz_dump_interval=viz_int,
        restart_interval=main_db.get_int("restart_interval", 0),
        health_interval=min(20, viz_int) if viz_int else 20)
    with JLogger(main_db.get_string("log_file")) as log:

        def metrics_fn(s, step):
            rec = {"step": step, "t": s.ins.t,
                   "volume": shell_volume(s.X, center),
                   "ke": integ.ins.kinetic_energy(s.ins),
                   "max_div": integ.ins.max_divergence(s.ins),
                   "cfl_dt": integ.ins.cfl_dt(s.ins)}
            log.log(rec)
            return rec

        def viz_fn(s, step):
            np.savetxt(os.path.join(viz_dir, f"markers.{step:06d}.csv"),
                       np.asarray(s.X), delimiter=",")

        driver = jdrv.HierarchyDriver(
            integ, cfg, step_fn=step_fn, metrics_fn=metrics_fn,
            viz_fn=viz_fn,
            checkpoint_fn=lambda s, k: jckpt.save_checkpoint(rst_dir, s, k),
            timer=TimerManager.instance(),
            timer_name="IB::advanceHierarchy")
        return driver.run(state)


def _records(out):
    lines = (out / "metrics.jsonl").read_text().splitlines()
    return [json.loads(ln) for ln in lines]


def test_ex4_entry_point_matches_reference(tmp_path):
    """The port's ex4 entry point against the reference example's build,
    run loop and callbacks on the same input: the metrics log, the viz
    files, the checkpoints and the final state; then a restart of the
    port from the reference's mid-run checkpoint."""
    from ibamr_tpu_torch.examples import ib_explicit_ex4

    jout, tout = tmp_path / "jax", tmp_path / "port"
    js = _jax_ex4_run(_ex4_db(j_parse_file, jout))
    ts = ib_explicit_ex4.run(_ex4_db(t_parse_file, tout), device="cpu")
    assert ts.X.dtype == torch.float32 and int(ts.ins.k) == EX4_STEPS
    for a, b in ((js.X, ts.X), (js.U, ts.U), (js.ins.p, ts.ins.p),
                 *zip(js.ins.u, ts.ins.u)):
        assert _rel(a, b) < EX4_RTOL

    # one record per chunk, at the same steps, with the same diagnostics
    jrec, trec = _records(jout), _records(tout)
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] \
        == [2, 3, 4, 6]
    umax = max(float(np.max(np.abs(np.asarray(c)))) for c in js.ins.u)
    for j, t in zip(jrec, trec):
        assert t.keys() == j.keys()
        for key in ("t", "volume", "cfl_dt"):
            assert abs(t[key] - j[key]) <= EX4_RTOL * abs(j[key]), key
        assert abs(t["ke"] - j["ke"]) <= EX4_KE_RTOL * j["ke"]
        # roundoff in both: held against the velocity's scale over dx
        assert abs(t["max_div"] - j["max_div"]) <= EX4_RTOL * umax * 16
        assert t["max_div"] <= EX4_RTOL * umax * 16

    # the same viz files and checkpoints, each holding the same state
    assert sorted(os.listdir(tout / "viz")) == sorted(
        os.listdir(jout / "viz")) == [
            f"markers.{k:06d}.csv" for k in (2, 4, 6)]
    for name in os.listdir(jout / "viz"):
        ref = np.loadtxt(jout / "viz" / name, delimiter=",")
        got = np.loadtxt(tout / "viz" / name, delimiter=",")
        assert np.max(np.abs(got - ref)) <= EX4_RTOL * np.max(np.abs(ref))
    assert sorted(os.listdir(tout / "restart")) == sorted(
        os.listdir(jout / "restart"))
    assert tckpt.latest_step(str(tout / "restart")) == EX4_STEPS
    for k in (EX4_RESTART, EX4_STEPS):
        jk, _, _ = tckpt.restore_checkpoint(str(jout / "restart"), ts, k)
        tk, _, _ = tckpt.restore_checkpoint(str(tout / "restart"), ts, k)
        for (_, a), (_, b) in zip(tckpt.flatten_with_path(jk),
                                  tckpt.flatten_with_path(tk)):
            assert _rel(a.numpy(), b) < EX4_RTOL

    # the port restarts from the reference's step-3 checkpoint and
    # reaches the reference's final state
    again = ib_explicit_ex4.run(_ex4_db(t_parse_file, tmp_path / "again"),
                                device="cpu",
                                restart=(str(jout / "restart"), EX4_RESTART))
    assert int(again.ins.k) == EX4_STEPS
    assert [r["step"] for r in _records(tmp_path / "again")] == [4, 6]
    assert _rel(js.X, again.X) < EX4_RTOL
    for a, b in zip(js.ins.u, again.ins.u):
        assert _rel(a, b) < EX4_RTOL


def test_ex4_diagnostics_match_reference():
    """``shell_volume`` and the integrator's ``kinetic_energy``,
    ``max_divergence`` and ``cfl_dt`` (the ex4 metrics record) on a
    stepped 16^3 state carried over from the reference, at f64."""
    from ibamr_tpu.models.shell3d import shell_volume as j_volume
    from ibamr_tpu_torch.models.shell3d import shell_volume as t_volume

    js, ts, tinteg = _stepped_states()
    jinteg, _ = jbuild(use_fast_interaction=False, dtype=jnp.float64,
                       engine_fallback=False, **SHELL)
    center = (0.5, 0.5, 0.5)
    for ref, got in (
            (j_volume(js.X, center), t_volume(ts.X, center)),
            (jinteg.ins.kinetic_energy(js.ins),
             tinteg.ins.kinetic_energy(ts.ins)),
            (jinteg.ins.cfl_dt(js.ins), tinteg.ins.cfl_dt(ts.ins)),
            (jinteg.ins.cfl_dt(js.ins, 0.3), tinteg.ins.cfl_dt(ts.ins, 0.3))):
        assert abs(float(got) - float(ref)) <= 1e-14 * abs(float(ref))
    assert abs(float(tinteg.ins.max_divergence(ts.ins))
               - float(jinteg.ins.max_divergence(js.ins))) <= 1e-14


def test_metrics_logger_lines_match_reference(tmp_path):
    recs = [{"step": 3, "t": 0.25, "volume": 0.065, "ke": 1e-6,
             "max_div": float("nan"), "cfl_dt": float("inf"),
             "name": "ex4", "vec": [1.0, 2.5]}]
    jrecs = [{**recs[0], "t": jnp.asarray(0.25, dtype=jnp.float32),
              "ke": np.float64(1e-6), "vec": jnp.asarray([1.0, 2.5])}]
    trecs = [{**recs[0], "t": torch.tensor(0.25, dtype=torch.float32),
              "ke": torch.tensor(1e-6, dtype=torch.float64),
              "vec": torch.tensor([1.0, 2.5])}]
    outs = {}
    for name, cls, rs in (("j", JLogger, jrecs), ("t", TLogger, trecs)):
        echo = io.StringIO()
        with cls(str(tmp_path / name / "m.jsonl"), echo=True,
                 stream=echo) as log:
            for r in rs:
                log.log(r)
        outs[name] = ((tmp_path / name / "m.jsonl").read_text(),
                      echo.getvalue())
    assert outs["t"] == outs["j"]
    assert '"max_div": null, "max_div_nonfinite": "nan"' in outs["t"][0]
