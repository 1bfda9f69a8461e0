"""Port parity of the three drivers of scalar transport and two-level AMR:
``examples/adv_diff/ex0``, ``examples/IB/explicit/ex0_amr`` and
``ex4_amr``. Each runs its committed input with only ``num_steps`` cut
(the AMR drivers past their first regrid), in its own working directory,
in both packages. The reference runs in JAX's default 32-bit mode, as a
user of its example runs it; the port's drivers compute in f32. The
final states agree to 1e-5 of their largest value (X and the scalar; the
velocity components to 1e-5 of the largest speed),
the window origins of every metrics record are equal, and the metrics
and viz files carry the same keys and names.

ex4_amr's committed 64^3 grid takes over 40 s for 12 steps on the CPU in
the reference (its two compiled chunks), so its test cuts the grid to
32^3 (the shell, the stream and the regrid cadence as committed) and
is marked slow all the same (about 30 s)."""

import importlib.util
import json
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ibamr_tpu_torch.examples import (adv_diff_ex0, ib_explicit_ex0_amr,
                                      ib_explicit_ex4_amr)
from ibamr_tpu_torch.utils.input_db import parse_input_file

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5


def _run_both(tmp_path, ex, port, steps, subs=()):
    """Both drivers on the committed input with ``num_steps`` cut (and
    ``subs``); returns the two working directories and both results."""
    (inp_name,) = [p.name for p in (ROOT / ex).iterdir()
                   if p.name.startswith("input")]
    text, k = re.subn(r"(num_steps\s*=\s*)\d+", rf"\g<1>{steps}",
                      (ROOT / ex / inp_name).read_text())
    assert k == 1
    for a, b in subs:
        text, k = re.subn(a, b, text)
        assert k == 1
    inp = tmp_path / inp_name
    inp.write_text(text)
    spec = importlib.util.spec_from_file_location(
        "ref_" + ex.replace("/", "_"), ROOT / ex / "main.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    dirs = tmp_path / "jax", tmp_path / "port"
    cwd = os.getcwd()
    try:
        for d in dirs:
            d.mkdir()
            os.chdir(d)
            if d.name == "jax":
                with jax.enable_x64(False):
                    rout = ref.main(["main.py", str(inp)])
            else:
                tout = port.run(parse_input_file(str(inp)), device="cpu")
    finally:
        os.chdir(cwd)
    return dirs, rout, tout


def _close(ref, got, scale=None):
    ref = np.asarray(ref, dtype=np.float64)
    got = got.detach().cpu().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, dtype=np.float64)
    assert got.shape == ref.shape
    scale = np.max(np.abs(ref)) if scale is None else scale
    assert np.max(np.abs(got - ref)) <= RTOL * scale


def _close_vel(ref, got):
    """Velocity components to 1e-5 of the largest speed."""
    scale = max(float(np.max(np.abs(np.asarray(c)))) for c in ref)
    for a, b in zip(ref, got):
        _close(a, b, scale)


def _records(d):
    (path,) = [p for p in d.rglob("metrics.jsonl")]
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _files(d):
    return sorted(str(p.relative_to(d)) for p in d.rglob("*") if p.is_file())


def test_adv_diff_ex0_driver_matches_reference(tmp_path):
    (jdir, tdir), (rs, ra), (ts, ta) = _run_both(
        tmp_path, "examples/adv_diff/ex0", adv_diff_ex0, 6)
    _close(rs.X, ts.X)
    _close_vel(rs.ins.u, ts.ins.u)
    _close(ra.Q[0], ta.Q[0])
    assert ta.Q[0].dtype == torch.float32 and int(ta.k) == 6
    jr, tr = _records(jdir), _records(tdir)
    assert [sorted(r) for r in jr] == [sorted(r) for r in tr]
    for a, b in zip(jr, tr):
        for k in ("t", "area", "scalar_total", "scalar_max"):
            assert abs(a[k] - b[k]) <= RTOL * abs(a[k])
    # the scalar's total is the time integral of the markers' sources
    n_markers = ts.X.shape[0]
    assert abs(tr[-1]["scalar_total"] - n_markers * tr[-1]["t"]) \
        <= 1e-5 * n_markers * tr[-1]["t"]
    assert _files(jdir) == _files(tdir)


def _amr_checks(jdir, tdir, rout, tout):
    (ri, rs), (ti, ts) = rout, tout
    assert ti.box.lo == ri.box.lo and ti.box.shape == ri.box.shape
    _close(rs.X, ts.X)
    _close_vel(rs.fluid.uf, ts.fluid.uf)
    _close_vel(rs.fluid.uc, ts.fluid.uc)
    jr, tr = _records(jdir), _records(tdir)
    assert [r["window_lo"] for r in jr] == [r["window_lo"] for r in tr]
    assert [r["step"] for r in jr] == [r["step"] for r in tr]
    assert [sorted(r) for r in jr] == [sorted(r) for r in tr]
    assert all(r["max_div"] < 1e-3 for r in tr)
    assert _files(jdir) == _files(tdir)


def test_ex0_amr_driver_matches_reference(tmp_path):
    (jdir, tdir), rout, tout = _run_both(
        tmp_path, "examples/IB/explicit/ex0_amr", ib_explicit_ex0_amr, 21,
        [(r"viz_dump_interval\s*=\s*50", "viz_dump_interval  = 20")])
    _amr_checks(jdir, tdir, rout, tout)
    assert tout[1].fluid.uf[0].dtype == torch.float32


@pytest.mark.slow
def test_ex4_amr_driver_matches_reference(tmp_path):
    (jdir, tdir), rout, tout = _run_both(
        tmp_path, "examples/IB/explicit/ex4_amr", ib_explicit_ex4_amr, 11,
        [(r"n_cells = 64, 64, 64", "n_cells = 32, 32, 32"),
         (r"viz_dump_interval\s*=\s*20", "viz_dump_interval  = 10")])
    _amr_checks(jdir, tdir, rout, tout)
