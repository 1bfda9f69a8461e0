"""Port parity of the three walled / open-boundary drivers: each runs its
committed input with only ``num_steps`` cut, in its own working
directory, in both packages, and writes the same metrics keys and viz
files. The reference runs in JAX's default 32-bit mode, as a user of its
example runs it; the port's drivers compute in f32. The metrics agree to
1e-5 relative (a value that is zero by symmetry, the cylinder's lift, to
1e-5 of the drag; the divergence, roundoff in both, to 1e-5 of max|u|
over dx), and so do the viz files' arrays."""

import importlib.util
import json
import os
import re
from pathlib import Path

import jax
import numpy as np
import pytest
import torch

from ibamr_tpu_torch.examples import (ib_explicit_cylinder2d,
                                      navier_stokes_cavity2d,
                                      navier_stokes_channel2d)
from ibamr_tpu_torch.utils.input_db import parse_input_file

ROOT = Path(__file__).resolve().parent.parent
RTOL = 1e-5
DRIVERS = {
    "cavity": ("examples/navier_stokes/cavity2d", navier_stokes_cavity2d),
    "channel": ("examples/navier_stokes/channel2d", navier_stokes_channel2d),
    "cylinder": ("examples/IB/explicit/cylinder2d", ib_explicit_cylinder2d),
}


def _run_both(tmp_path, name, steps):
    """Both drivers on the committed input with ``num_steps`` cut; returns
    the two working directories."""
    ex, port = DRIVERS[name]
    text, k = re.subn(r"(num_steps\s*=\s*)\d+", rf"\g<1>{steps}",
                      (ROOT / ex / "input2d").read_text())
    assert k == 1
    inp = tmp_path / "input2d"
    inp.write_text(text)
    spec = importlib.util.spec_from_file_location(f"ref_{name}",
                                                  ROOT / ex / "main.py")
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
                    ref.main(["main.py", str(inp)])
            else:
                st = port.run(parse_input_file(str(inp)), device="cpu")
    finally:
        os.chdir(cwd)
    return dirs, st


def _records(d):
    (path,) = d.glob("*_metrics.jsonl")
    return [json.loads(ln) for ln in path.read_text().splitlines()]


def _vtk_arrays(path):
    """Every DataArray of an ascii VTK file as a float array."""
    text = path.read_text()
    return [np.array(m.split(), dtype=float) for m in re.findall(
        r"<DataArray[^>]*>\s*(.*?)\s*</DataArray>", text, re.S)]


def _close(ref, got, scale=None):
    ref, got = np.asarray(ref, float), np.asarray(got, float)
    assert got.shape == ref.shape
    scale = np.max(np.abs(ref)) if scale is None else scale
    assert np.max(np.abs(got - ref)) <= RTOL * scale


def test_cavity_driver_matches_reference(tmp_path):
    (jdir, tdir), st = _run_both(tmp_path, "cavity", 40)
    assert st.u[0].dtype == torch.float32 and int(st.k) == 40
    jrec, trec = _records(jdir), _records(tdir)
    assert [list(r) for r in trec] == [list(r) for r in jrec] == \
        [["step", "t", "u_center_min", "max_div"]] * 1 + [["step",
                                                          "centerline_u"]]
    j, t = jrec[0], trec[0]
    assert t["step"] == j["step"] == 40
    for key in ("t", "u_center_min"):
        assert abs(t[key] - j[key]) <= RTOL * abs(j[key])
    assert abs(t["max_div"] - j["max_div"]) <= RTOL * 1.0 * 64
    _close(jrec[1]["centerline_u"], trec[1]["centerline_u"])
    assert sorted(os.listdir(tdir)) == sorted(os.listdir(jdir))


@pytest.mark.slow
def test_channel_driver_matches_reference(tmp_path, capsys):
    (jdir, tdir), st = _run_both(tmp_path, "channel", 20)
    out = capsys.readouterr().out
    errs = [float(v) for v in re.findall(
        r"developed-profile error vs Poiseuille: (\S+)", out)]
    assert len(errs) == 2 and abs(errs[1] - errs[0]) <= 0.01 * errs[0]
    jrec, trec = _records(jdir), _records(tdir)
    assert [list(r) for r in trec] == [list(r) for r in jrec] == \
        [["step", "t", "outflow_flux", "max_div"]]
    for key in ("t", "outflow_flux"):
        assert abs(trec[0][key] - jrec[0][key]) <= RTOL * abs(jrec[0][key])
    assert abs(trec[0]["max_div"] - jrec[0]["max_div"]) <= RTOL * 1.0 * 32
    names = sorted(os.listdir(jdir / "viz_channel2d"))
    assert names == sorted(os.listdir(tdir / "viz_channel2d")) == \
        ["u_00020.vti"]
    for a, b in zip(_vtk_arrays(jdir / "viz_channel2d" / names[0]),
                    _vtk_arrays(tdir / "viz_channel2d" / names[0])):
        _close(a, b)
    assert abs(navier_stokes_channel2d.profile_error(
        parse_input_file(str(tmp_path / "input2d")), st) - errs[1]) \
        <= 1e-2 * errs[1]


@pytest.mark.slow
def test_cylinder_driver_matches_reference(tmp_path):
    (jdir, tdir), st = _run_both(tmp_path, "cylinder", 4)
    assert st.X.dtype == torch.float32 and st.X.shape == (64, 2)
    jrec, trec = _records(jdir), _records(tdir)
    assert [list(r) for r in trec] == [list(r) for r in jrec] == \
        [["step", "t", "drag", "lift", "cd"]]
    j, t = jrec[0], trec[0]
    for key in ("t", "drag", "cd"):
        assert abs(t[key] - j[key]) <= RTOL * abs(j[key])
    assert abs(t["lift"] - j["lift"]) <= RTOL * abs(j["drag"])
    names = sorted(os.listdir(jdir / "viz_cylinder2d"))
    assert names == sorted(os.listdir(tdir / "viz_cylinder2d")) == \
        ["eul_000004.vti", "eulerian.pvd", "lag_000004.vtp",
         "lagrangian.pvd"]
    for name in names[:1] + names[2:3]:
        for a, b in zip(_vtk_arrays(jdir / "viz_cylinder2d" / name),
                        _vtk_arrays(tdir / "viz_cylinder2d" / name)):
            _close(a, b)
    for name in ("eulerian.pvd", "lagrangian.pvd"):
        assert (jdir / "viz_cylinder2d" / name).read_bytes() == \
            (tdir / "viz_cylinder2d" / name).read_bytes()


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


@pytest.mark.slow
def test_chip_smoke_channel_constant_is_the_reference_drivers(tmp_path):
    """``chip_smoke.CHANNEL_PROFILE_ERR`` is what the reference's channel
    driver reaches on the committed input (150 steps, JAX's 32-bit
    mode)."""
    import sys

    sys.path.insert(0, str(ROOT))
    import chip_smoke

    ex, _ = DRIVERS["channel"]
    spec = importlib.util.spec_from_file_location("ref_channel_full",
                                                  ROOT / ex / "main.py")
    ref = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(ref)
    seen = []
    real_max = ref.np.max

    def spy(a, *args, **kwargs):
        seen.append(float(real_max(a, *args, **kwargs)))
        return seen[-1]

    ref.np.max = spy
    cwd = os.getcwd()
    os.chdir(tmp_path)
    try:
        with jax.enable_x64(False):
            ref.main(["main.py", str(ROOT / ex / "input2d")])
    finally:
        os.chdir(cwd)
        ref.np.max = real_max
    assert seen[-1] == chip_smoke.CHANNEL_PROFILE_ERR


@pytest.mark.slow
def test_reference_cylinder_example_diverges_in_f32(tmp_path, capsys):
    """Why ``chip_smoke.CYL_STEPS`` stops at 100: the reference's own
    cylinder example (committed input, JAX's 32-bit mode) runs stably to
    step ~110 and then blows up, so its 2000 steps cannot finish. The
    same build at f64 runs on. Prints the drag and max|u| every 10
    steps."""
    import jax.numpy as jnp

    from ibamr_tpu.integrators.ib import IBMethod
    from ibamr_tpu.integrators.ib_open import IBOpenIntegrator
    from ibamr_tpu.integrators.ins_open import INSOpenIntegrator
    from ibamr_tpu.ops.forces import ForceSpecs
    from ibamr_tpu.solvers.stokes import channel_bc

    def run(dtype, steps):
        n, dx = (128, 64), (4.0 / 128, 2.0 / 64)
        ins = INSOpenIntegrator(n, dx, channel_bc(2), mu=0.01, dt=4e-3,
                                bdry={(0, 0, 0): 1.0}, tol=1e-7,
                                convective_op_type="stabilized_ppm",
                                dtype=dtype)
        th = 2.0 * np.pi * np.arange(64) / 64
        X0 = jnp.asarray(np.stack([1.0 + 0.25 * np.cos(th),
                                   1.0 + 0.25 * np.sin(th)], axis=1), dtype)
        ib = IBMethod(ForceSpecs(), kernel="IB_4",
                      force_fn=lambda X, U, t: -50.0 * (X - X0) - 1.0 * U)
        integ = IBOpenIntegrator(ins, ib, x_lo=(0.0, 0.0))
        step, st = jax.jit(integ.step), integ.initialize(X0)
        umax = []
        for k in range(1, steps + 1):
            st = step(st)
            if k % 10 == 0:
                umax.append(float(jnp.max(jnp.abs(st.fluid.u[0]))))
                print(dtype.__name__, k, -float(st.F_net[0]), umax[-1])
        return umax

    with jax.enable_x64(False):
        u32 = run(jnp.float32, 140)
    assert max(u32[:10]) < 2.5          # stable to step 100
    assert not (max(u32[10:]) < 1e3)    # then it blows up (or NaNs)
    u64 = run(jnp.float64, 140)
    assert max(u64) < 2.5
