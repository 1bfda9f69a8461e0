"""Port parity of the two multiphase drivers, ``examples/multiphase/
dam_break`` and ``falling_drop`` (``input2d`` and ``input2d.walled``).
Each runs its committed input with only the grid and ``num_steps`` cut,
in its own working directory, in both packages; the reference runs in
JAX's default 32-bit mode, as a user of its example runs it, and the
port's drivers compute in f32. The JSONL records carry the same keys,
steps and times; the dam break's surge fronts are equal, the volume
drifts agree to 1e-5 (absolute, on drifts of ~1e-3) and max|div u| stays
at the solver's f32 floor in both (within a factor 2: the residual of a
CG stopped at 20 eps). The dam break's restart continuation (at 48x32: 10
steps with a dump, then ``--restart`` to 20) lands bitwise on the
straight 20-step run, as the reference's does."""

import importlib.util
import json
import os
import re
from pathlib import Path

import jax
import pytest
import torch

from ibamr_tpu_torch.examples import (multiphase_dam_break,
                                      multiphase_falling_drop)
from ibamr_tpu_torch.utils.input_db import parse_input_file

ROOT = Path(__file__).resolve().parent.parent
DRIFT_ATOL = 1e-5


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test (the suite runs in parallel
    workers)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cut(text, subs):
    for a, b in subs:
        text, k = re.subn(a, b, text)
        assert k == 1, a
    return text


def _ref_main(ex):
    spec = importlib.util.spec_from_file_location(
        "ref_" + ex.replace("/", "_"), ROOT / ex / "main.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _run_both(tmp_path, ex, port, inp_name, subs):
    text = _cut((ROOT / ex / inp_name).read_text(), subs)
    inp = tmp_path / inp_name
    inp.write_text(text)
    ref = _ref_main(ex)
    dirs = tmp_path / "jax", tmp_path / "port"
    cwd = os.getcwd()
    try:
        for d in dirs:
            d.mkdir()
            os.chdir(d)
            if d.name == "jax":
                with jax.enable_x64(False):
                    ref.main(["main.py", str(inp)])
            else:
                integ, st = port.run(parse_input_file(str(inp)),
                                     device="cpu")
    finally:
        os.chdir(cwd)
    return dirs, integ, st


def _records(d):
    (path,) = list(d.glob("*.jsonl"))
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def _compare(jr, tr):
    assert [sorted(r) for r in jr] == [sorted(r) for r in tr]
    for a, b in zip(jr, tr):
        assert a["step"] == b["step"]
        assert abs(a["t"] - b["t"]) <= 1e-6 * a["t"]
        assert abs(a["volume_drift"] - b["volume_drift"]) <= DRIFT_ATOL
        assert 0.5 <= b["max_div"] / a["max_div"] <= 2.0, (a, b)
        if "front" in a:
            assert a["front"] == b["front"], (a, b)


def test_dam_break_driver_matches_reference(tmp_path):
    """The committed tank on the 64x48 grid of
    ``tests/test_examples_r5.py:188`` (dt 1e-3 there; 5e-4 committed),
    40 steps: the front leaves the dam, the reference's bounds hold."""
    (jdir, tdir), integ, st = _run_both(
        tmp_path, "examples/multiphase/dam_break", multiphase_dam_break,
        "input2d", [(r"n = 128, 96", "n = 64, 48"),
                    (r"dt = 5.0e-4", "dt = 1.0e-3"),
                    (r"num_steps = 600", "num_steps = 40")])
    jr, tr = _records(jdir), _records(tdir)
    assert [r["step"] for r in tr] == [20, 40]
    _compare(jr, tr)
    dx = 1.0 / 64
    fronts = [r["front"] for r in tr]
    assert all(b >= a - dx for a, b in zip(fronts, fronts[1:]))
    assert fronts[-1] > 0.25
    assert tr[-1]["volume_drift"] < 1e-2 and tr[-1]["max_div"] < 1e-2
    assert st.phi.dtype == torch.float32 and st.k == 40
    assert integ.projections == 40 and integ.cg_iterations >= 40
    assert _files(jdir) == _files(tdir)


def test_dam_break_restart_continues_bitwise(tmp_path):
    """``tests/test_examples_r5.py:393`` on the port, cut to 10 steps with
    a dump, then a restart to 20 (the chip runs the full 20 + 20): equal
    bitwise to the straight 20-step run in front and volume drift (the
    drift reference is taken before the restore)."""
    base = (ROOT / "examples/multiphase/dam_break/input2d").read_text()

    def cfg(name, rdir, rint, steps):
        text = _cut(base, [(r"n = 128, 96", "n = 48, 32"),
                           (r"dt = 5.0e-4", "dt = 1.5e-3"),
                           (r"num_steps = 600", f"num_steps = {steps}"),
                           (r"log_interval = 20", "log_interval = 10"),
                           (r'log_jsonl = "dam_break_metrics.jsonl"',
                            f'log_jsonl = "{name}.jsonl"\n'
                            f'   restart_dirname = "{rdir}"\n'
                            f'   restart_interval = {rint}')])
        return parse_input_file(_write(tmp_path / f"in_{name}", text))

    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        multiphase_dam_break.run(cfg("a", "ra", 0, 20), device="cpu")
        multiphase_dam_break.run(cfg("b", "rb", 10, 10), device="cpu")
        assert (tmp_path / "rb").is_dir()
        _, st = multiphase_dam_break.run(cfg("c", "rb", 10, 20),
                                         device="cpu", restart=True)
    finally:
        os.chdir(cwd)
    a = [json.loads(ln) for ln in (tmp_path / "a.jsonl").read_text()
         .splitlines()][-1]
    c = [json.loads(ln) for ln in (tmp_path / "c.jsonl").read_text()
         .splitlines()]
    assert [r["step"] for r in c] == [20] and st.k == 20
    assert a["front"] == c[-1]["front"]
    assert a["volume_drift"] == c[-1]["volume_drift"]


def _write(path, text):
    path.write_text(text)
    return str(path)


@pytest.mark.parametrize("inp", ["input2d", "input2d.walled"])
def test_falling_drop_driver_matches_reference(tmp_path, inp):
    """The committed drop (open periodic box, and the closed tank of
    ``input2d.walled``) on a 32^2 grid, 20 steps with a dump every 10."""
    (jdir, tdir), integ, st = _run_both(
        tmp_path, "examples/multiphase/falling_drop",
        multiphase_falling_drop, inp,
        [(r"n = 64, 64", "n = 32, 32"), (r"num_steps = 300",
                                         "num_steps = 40"),
         (r"viz_dump_interval = 50", "viz_dump_interval = 20")])
    jr, tr = _records(jdir), _records(tdir)
    assert [r["step"] for r in tr] == [20, 40]
    _compare(jr, tr)
    assert integ.wall_axes == ((True, True) if inp.endswith("walled")
                               else (False, False))
    assert _files(jdir) == _files(tdir)
