"""Port parity of the ex0 driver: ``ibamr_tpu_torch.examples.
ib_explicit_ex0.run`` against the reference's
``examples/IB/explicit/ex0/main.py`` (loaded by path) on the committed
``input2d`` cut to 20 steps (viz every 5, restart every 10), each run in
its own working directory so that the input's relative output paths land
there. f32 in both packages: the FFT backends and sum orders differ, so
the metrics log, the marker CSVs and the final state agree to 1e-5
relative (the divergence, roundoff in both, to 1e-5 of max|u| over dx).
Each package restarts from the other's step-10 checkpoint and reaches
the other's final state to the same tolerance; the port restarted from
its own checkpoint reaches its own final state bitwise."""

import importlib.util
import json
import os
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from ibamr_tpu_torch.examples import ib_explicit_ex0
from ibamr_tpu_torch.utils.input_db import parse_input_file
from ibamr_tpu_torch.utils.tree import flatten_with_path

ROOT = Path(__file__).resolve().parent.parent
INPUT2D = ROOT / "examples/IB/explicit/ex0/input2d"
STEPS, VIZ, RESTART = 20, 5, 10
RTOL = 1e-5


def _load_reference_main():
    path = ROOT / "examples/IB/explicit/ex0/main.py"
    spec = importlib.util.spec_from_file_location("example_ex0_main", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _cut_input(out: Path) -> Path:
    """``input2d`` with 20 steps, viz every 5 and restart every 10; every
    other entry, the relative output paths included, as committed."""
    text = INPUT2D.read_text()
    for key, val in (("num_steps", STEPS), ("viz_dump_interval", VIZ),
                     ("restart_interval", RESTART)):
        text, k = re.subn(rf"({key}\s*=\s*)\d+", rf"\g<1>{val}", text)
        assert k == 1, key
    path = out / "input2d"
    path.write_text(text)
    return path


def _run_in(directory: Path, fn):
    directory.mkdir(parents=True, exist_ok=True)
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        return fn()
    finally:
        os.chdir(cwd)


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The straight runs of both packages: (input path, reference module,
    JAX final state, port final state, their working directories)."""
    base = tmp_path_factory.mktemp("ex0")
    inp = _cut_input(base)
    ref = _load_reference_main()
    jdir, tdir = base / "jax", base / "port"
    js = _run_in(jdir, lambda: ref.main(["main.py", str(inp)]))
    ts = _run_in(tdir, lambda: ib_explicit_ex0.run(
        parse_input_file(str(inp)), device="cpu"))
    return inp, ref, js, ts, jdir, tdir


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    return float(np.max(np.abs(got - ref)) / np.max(np.abs(ref)))


def _states_close(js, ts):
    for a, b in ((js.X, ts.X), (js.U, ts.U), (js.ins.p, ts.ins.p),
                 *zip(js.ins.u, ts.ins.u)):
        assert _rel(a, b) < RTOL


def _records(directory: Path):
    lines = (directory / "viz_ex0/metrics.jsonl").read_text().splitlines()
    return [json.loads(ln) for ln in lines]


def test_ex0_run_matches_reference(runs):
    _, _, js, ts, jdir, tdir = runs
    assert ts.X.dtype == torch.float32 and ts.X.shape == (128, 2)
    assert int(ts.ins.k) == STEPS
    _states_close(js, ts)

    # one record per chunk of viz_dump_interval steps, same keys
    jrec, trec = _records(jdir), _records(tdir)
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] \
        == [5, 10, 15, 20]
    umax = max(float(np.max(np.abs(np.asarray(c)))) for c in js.ins.u)
    for j, t in zip(jrec, trec):
        assert list(t) == list(j) == ["step", "t", "area", "ke", "max_div",
                                      "cfl_dt"]
        assert all(isinstance(t[k], float) for k in list(t)[1:])
        for key in ("t", "area", "ke", "cfl_dt"):
            assert abs(t[key] - j[key]) <= RTOL * abs(j[key]), key
        assert abs(t["max_div"] - j["max_div"]) <= RTOL * umax * 64

    # the same marker CSVs and checkpoints, in the relative directories
    names = [f"markers.{k:06d}.csv" for k in (5, 10, 15, 20)]
    assert sorted(p.name for p in (tdir / "viz_ex0").glob("*.csv")) == \
        sorted(p.name for p in (jdir / "viz_ex0").glob("*.csv")) == names
    for name in names:
        ref = np.loadtxt(jdir / "viz_ex0" / name, delimiter=",")
        got = np.loadtxt(tdir / "viz_ex0" / name, delimiter=",")
        assert got.shape == (128, 2)
        assert np.max(np.abs(got - ref)) <= RTOL * np.max(np.abs(ref))
    assert sorted(os.listdir(tdir / "restart_ex0")) == \
        sorted(os.listdir(jdir / "restart_ex0"))


def test_ex0_restarts_across_packages(runs):
    inp, ref, js, ts, jdir, tdir = runs
    db = parse_input_file(str(inp))
    # the port from the reference's checkpoint, and from its own, bitwise
    from_jax = _run_in(tdir.parent / "port_from_jax", lambda: ib_explicit_ex0
                       .run(db, device="cpu",
                            restart=(str(jdir / "restart_ex0"), RESTART)))
    assert int(from_jax.ins.k) == STEPS
    _states_close(js, from_jax)
    again = _run_in(tdir.parent / "port_again", lambda: ib_explicit_ex0.run(
        db, device="cpu", restart=(str(tdir / "restart_ex0"), RESTART)))
    assert all(torch.equal(a, b) for (_, a), (_, b) in zip(
        flatten_with_path(again), flatten_with_path(ts)))
    # the reference from the port's checkpoint
    from_port = _run_in(tdir.parent / "jax_from_port", lambda: ref.main(
        ["main.py", str(inp), str(tdir / "restart_ex0"), str(RESTART)]))
    assert int(from_port.ins.k) == STEPS
    _states_close(from_port, ts)
    assert [r["step"] for r in _records(tdir.parent / "jax_from_port")] \
        == [15, 20]


def test_ex0_main_needs_a_gpu_and_checks_its_arguments():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        ib_explicit_ex0.main(["ib_explicit_ex0", str(INPUT2D)])
    with pytest.raises(SystemExit):
        ib_explicit_ex0.main(["ib_explicit_ex0", str(INPUT2D), "dir"])
    assert os.path.samefile(ib_explicit_ex0.DEFAULT_INPUT, INPUT2D)
