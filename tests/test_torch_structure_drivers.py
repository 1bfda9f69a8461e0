"""Port parity of the six structure drivers: each runs the reference's
committed input with ``num_steps`` cut (and, where the tier-1 budget
needs it, the grid cut; each cut is named in its test), in its own
working directory, in both packages, and writes the same metrics keys
and viz files. The reference runs in JAX's default 32-bit mode and the
port's drivers in f32, and the metrics agree to 1e-5 of each value's
scale (positions to 1e-5 of the unit box, drifts and small differences
of positions absolutely). Two CIB drivers compare at f64 (the
reference's x64 mode) instead: at f32 the CIB ex0 CG stops at its 400
iterations on the f32 floor, where the two packages' roundoff leaves U
6.5e-5 apart after 2 steps, and the walled oscillating cylinder cannot
reach its 1e-10 Stokes tolerance (ROADMAP C)."""

import functools
import importlib.util
import json
import os
import re
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu_torch.examples import (cib_ex0, cib_oscillating_cylinder,
                                      constraint_ib_eel2d,
                                      ib_explicit_filament2d,
                                      ibfe_explicit_beam2d,
                                      ibfe_explicit_ex0)
from ibamr_tpu_torch.utils.input_db import parse_input_file

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
DRIVERS = {
    "ibfe_ex0": ("examples/IBFE/explicit/ex0", ibfe_explicit_ex0),
    "beam2d": ("examples/IBFE/explicit/beam2d", ibfe_explicit_beam2d),
    "filament2d": ("examples/IB/explicit/filament2d",
                   ib_explicit_filament2d),
    "cib_ex0": ("examples/CIB/ex0", cib_ex0),
    "oscillating_cylinder": ("examples/CIB/oscillating_cylinder",
                             cib_oscillating_cylinder),
    "eel2d": ("examples/ConstraintIB/eel2d", constraint_ib_eel2d),
}


def _run_both(tmp_path, name, subs, x64=False, patch=None, monkeypatch=None):
    """Both drivers on the committed input with the ``subs`` (pattern,
    replacement) cuts applied; returns the two working directories and
    the port's result. With ``monkeypatch`` the port's driver builds at
    f64, as ``x64`` and ``patch`` make the reference's."""
    ex, port = DRIVERS[name]
    if monkeypatch is not None:
        monkeypatch.setattr(port, "build", functools.partial(
            port.build, dtype=torch.float64))
    text = (ROOT / ex / "input2d").read_text()
    for pat, rep in subs:
        text, k = re.subn(pat, rep, text)
        assert k == 1, pat
    inp = tmp_path / "input2d"
    inp.write_text(text)
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  ROOT / ex / "main.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    if patch is not None:
        patch(ref)
    dirs = tmp_path / "jax", tmp_path / "port"
    cwd = os.getcwd()
    try:
        for d in dirs:
            d.mkdir()
            os.chdir(d)
            if d.name == "jax":
                with jax.enable_x64(x64):
                    ref.main(["main.py", str(inp)])
            else:
                out = port.run(parse_input_file(str(inp)), device="cpu")
    finally:
        os.chdir(cwd)
    return dirs, out


def _steps(n):
    return (r"(num_steps\s*=\s*)\d+", rf"\g<1>{n}")


def _records(d):
    (path,) = [p for p in d.rglob("*.jsonl")]
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _compare(jdir, tdir, scales):
    """Same keys in the same order; each value within RTOL * its scale
    (``None``: equal)."""
    jrec, trec = _records(jdir), _records(tdir)
    assert [list(r) for r in trec] == [list(r) for r in jrec]
    for j, t in zip(jrec, trec):
        for key, scale in scales.items():
            a, b = np.asarray(j[key], float), np.asarray(t[key], float)
            if scale is None:
                assert np.array_equal(a, b), (key, j[key], t[key])
            else:
                assert np.max(np.abs(a - b)) <= RTOL * scale, \
                    (key, j[key], t[key])
    return jrec, trec


def test_ibfe_ex0_driver_matches_reference(tmp_path):
    (jdir, tdir), st = _run_both(tmp_path, "ibfe_ex0", [_steps(20)])
    assert st.X.dtype == torch.float32 and int(st.ins.k) == 20
    jrec, _ = _compare(jdir, tdir, {
        "step": None, "t": 1e-3, "area": 0.1, "area_drift": 1.0,
        "elastic_energy": 0.02})
    assert [r["step"] for r in jrec] == [1, 10, 20]
    names = sorted(os.listdir(jdir / "viz_ibfe"))
    assert names == sorted(os.listdir(tdir / "viz_ibfe")) == \
        ["metrics.jsonl", "nodes_00020.npy"]
    a, b = (np.load(d / "viz_ibfe" / "nodes_00020.npy") for d in (jdir, tdir))
    assert b.dtype == a.dtype and np.max(np.abs(a - b)) <= RTOL


def test_eel2d_driver_matches_reference(tmp_path):
    (jdir, tdir), st = _run_both(tmp_path, "eel2d",
                                 [_steps(20), (r"(log_interval\s*=\s*)\d+",
                                               r"\g<1>10")])
    assert st.X.dtype == torch.float32
    jrec, trec = _compare(jdir, tdir, {
        "step": None, "t": 1e-3, "com_x": 1.0, "com_y": 1.0,
        "swim_dx": 1.0})
    for j, t in zip(jrec, trec):
        U = np.asarray(j["U_body"])
        assert np.max(np.abs(np.asarray(t["U_body"]) - U)) <= \
            RTOL * np.max(np.abs(U))


class _F64Numpy:
    """The reference module's ``jnp`` with ``float32`` read as
    ``float64``: its beam and filament drivers hard-code f32."""

    float32 = jnp.float64

    def __getattr__(self, name):
        return getattr(jnp, name)


def _reference_at_f64(ref):
    """Patch a loaded reference driver to build at f64 (run it under
    ``jax.enable_x64``)."""
    ref.jnp = _F64Numpy()
    if hasattr(ref, "IBFEMethod"):
        ref.IBFEMethod = functools.partial(ref.IBFEMethod, dtype=jnp.float64)
    if hasattr(ref, "build_filament"):
        ref.build_filament.__defaults__ = (jnp.float64,)


@pytest.mark.slow
@pytest.mark.parametrize("name", ["beam2d", "filament2d"])
def test_open_structure_drivers_match_reference_at_f32(tmp_path, name):
    """Grid cut 128x64 -> 64x32 and the steps to 2: at the drivers' f32
    every saddle FGMRES exhausts its 12 restarts and returns ~0 (the
    inflow never enters, in both packages: ROADMAP C), ~20 s a step on
    the CPU."""
    subs = [_steps(2), (r"(n\s*=\s*)128, 64", r"\g<1>64, 32")]
    subs.append((r"(log_interval\s*=\s*)\d+", r"\g<1>1") if name == "beam2d"
                else (r"(viz_dump_interval\s*=\s*)\d+", r"\g<1>1"))
    (jdir, tdir), st = _run_both(tmp_path, name, subs)
    assert st.X.dtype == torch.float32
    keys = ({"step": None, "tip_deflection": 1.0, "tip_y": 1.0}
            if name == "beam2d" else
            {"step": None, "t": 1e-3, "tail_x": 1.0, "tail_y": 1.0})
    _compare(jdir, tdir, keys)
    assert abs(float(st.fluid.u[0][0].abs().max())) < 1e-6


@pytest.mark.slow
@pytest.mark.parametrize("name", ["beam2d", "filament2d"])
def test_open_structure_drivers_match_reference_at_f64(tmp_path, name,
                                                      monkeypatch):
    """Both drivers built at f64 (the reference's by reading its f32 as
    f64, the port's by its ``build``'s ``dtype``), grid cut 128x64 ->
    64x32, steps cut to 30, where the saddle solve converges in one
    restart and the structure moves."""
    subs = [_steps(30), (r"(n\s*=\s*)128, 64", r"\g<1>64, 32")]
    subs.append((r"(log_interval\s*=\s*)\d+", r"\g<1>10") if name == "beam2d"
                else (r"(viz_dump_interval\s*=\s*)\d+", r"\g<1>10"))
    (jdir, tdir), st = _run_both(tmp_path, name, subs, x64=True,
                                 patch=_reference_at_f64,
                                 monkeypatch=monkeypatch)
    assert st.X.dtype == torch.float64
    if name == "beam2d":
        jrec, _ = _compare(jdir, tdir, {
            "step": None, "tip_deflection": 1.0, "tip_y": 1.0})
        assert jrec[-1]["tip_deflection"] > 0.0
        scale = {"elastic_energy": max(abs(r["elastic_energy"])
                                       for r in jrec)}
    else:
        jrec, _ = _compare(jdir, tdir, {
            "step": None, "t": 1e-3, "tail_x": 1.0, "tail_y": 1.0})
        drag = max(abs(r["drag"]) for r in jrec)
        scale = {"drag": drag, "lift": drag}
        names = sorted(os.listdir(jdir / "viz_filament2d"))
        assert names == sorted(os.listdir(tdir / "viz_filament2d"))
        assert "lag_000030.vtp" in names
    for j, t in zip(*(_records(d) for d in (jdir, tdir))):
        for key, sc in scale.items():
            assert abs(t[key] - j[key]) <= RTOL * sc, key


def _length(X):
    X = np.asarray(X, dtype=np.float64)
    return float(np.linalg.norm(X[1:] - X[:-1], axis=1).sum())


@pytest.mark.slow
def test_filament_length_at_f64_matches_reference(tmp_path, monkeypatch,
                                                  capsys):
    """The committed filament2d input (128x64, 48 markers) with its 4000
    steps cut to 100, both drivers at f64: the filament stretches the
    same way in both packages (+11.3% at step 50, +5.7% at step 100),
    which is why the 5% length bound is checked on the
    configuration of tests/test_examples_r5.py:78 instead (~60 s in the
    reference and 150-400 s in the port on the CPU)."""
    states = {"jax": [], "port": []}

    def recording(adv, key):
        def advance(integ, st, m):
            out = adv(integ, st, m)
            states[key] += [st, out]
            return out
        return advance

    def patch(ref):
        _reference_at_f64(ref)
        ref.advance_ib_open = recording(ref.advance_ib_open, "jax")

    _, port = DRIVERS["filament2d"]
    monkeypatch.setattr(port, "advance_ib_open",
                        recording(port.advance_ib_open, "port"))
    (jdir, tdir), _ = _run_both(tmp_path, "filament2d", [_steps(100)],
                                x64=True, patch=patch,
                                monkeypatch=monkeypatch)
    _compare(jdir, tdir, {"step": None, "t": 1e-3, "tail_x": 1.0,
                          "tail_y": 1.0})
    # states: (in, out) of each 50-step chunk
    rel = {k: [_length(s.X) / _length(v[0].X) - 1.0 for s in v[1::2]]
           for k, v in states.items()}
    with capsys.disabled():
        print(f"\nfilament2d at f64, length change at steps 50 and 100: "
              f"reference {rel['jax']}, port {rel['port']}")
    assert np.allclose(rel["port"], rel["jax"], rtol=RTOL, atol=0.0)


@pytest.mark.slow
def test_cib_ex0_driver_matches_reference_at_f64(tmp_path, monkeypatch):
    """40 -> 2 steps, f64 (see the module docstring)."""
    (jdir, tdir), X = _run_both(tmp_path, "cib_ex0", [_steps(2)], x64=True,
                                monkeypatch=monkeypatch)
    jrec, trec = _compare(jdir, tdir, {
        "step": None, "t": 1e-3, "cg_converged": None, "cg_iters": None,
        "centroid": 1.0})
    for j, t in zip(jrec, trec):
        U = np.asarray(j["U"])
        assert np.max(np.abs(np.asarray(t["U"]) - U)) <= \
            RTOL * np.max(np.abs(U))
        assert t["U"][1] < 0
    assert sorted(os.listdir(tdir / "viz_cib")) == \
        sorted(os.listdir(jdir / "viz_cib")) == ["metrics.jsonl"]


@pytest.mark.slow
def test_oscillating_cylinder_driver_matches_reference_at_f64(tmp_path):
    """Grid cut 48^2 -> 16^2, markers 48 -> 8 and 2 periods of 40 steps
    -> 1 period of 4 (phases 45, 135, 225 and 315 degrees), f64: as
    committed the first step's CG runs to its 300 iterations of nested
    FGMRES solves (minutes on the CPU in either package), and the 48
    markers are 4 to a cell at 16^2, where the CG does not converge."""
    (jdir, tdir), (lam, FT) = _run_both(tmp_path, "oscillating_cylinder", [
        (r"(n_cells\s*=\s*)48, 48", r"\g<1>16, 16"),
        (r"(n_markers\s*=\s*)48", r"\g<1>8"),
        (r"(num_periods\s*=\s*)2", r"\g<1>1"),
        (r"(steps_per_period\s*=\s*)40", r"\g<1>4")], x64=True)
    assert FT.dtype == torch.float64
    jrec, _ = _compare(jdir, tdir, {"step": None, "t": 0.0, "u": 0.0,
                                    "converged": None})
    fx = max(abs(r["fx"]) for r in jrec)
    for j, t in zip(*(_records(d) for d in (jdir, tdir))):
        assert t["converged"]
        for key in ("fx", "fy", "torque"):
            assert abs(t[key] - j[key]) <= RTOL * fx, key
        assert abs(t["R_eff"] - j["R_eff"]) <= RTOL * abs(j["R_eff"])


@pytest.mark.parametrize("name", sorted(DRIVERS))
def test_driver_main_needs_a_gpu(name):
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    ex, port = DRIVERS[name]
    assert os.path.samefile(port.DEFAULT_INPUT, ROOT / ex / "input2d")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        port.main([port.__name__, port.DEFAULT_INPUT])
    with pytest.raises(SystemExit):
        port.main([port.__name__, "a", "b"])
