"""Port parity of the native host runtime (``ibamr_tpu_torch/io/native.py``,
``io/structures._read_table_native``, ``io/vtk.write_vtu`` and the native
``_b64``) against ``ibamr_tpu/io`` on the CPU.

The same bytes (numpy seeds) go through both packages' C++ parsers and
encoders and through the NumPy paths: tables equal value for value (NaN
for NaN), structure files read back equal, base64 equals the stdlib's
byte for byte, binary ``.vti`` and ``.vtu`` files equal the reference's
byte for byte, and the strict rejections of ``tests/test_native.py``
raise in both. The port builds its own library under
``ibamr_tpu_torch/csrc/build/``, never the reference's."""

import base64
import os

import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.io import native as jnative
from ibamr_tpu.io import structures as jstruct
from ibamr_tpu.io import vtk as jvtk
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.io import native as tnative
from ibamr_tpu_torch.io import structures as tstruct
from ibamr_tpu_torch.io import vtk as tvtk

RNG = np.random.default_rng(20261018)
HAVE_NATIVE = tnative.get_lib() is not None and jnative.get_lib() is not None


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _equal_nan(a, b):
    return a.shape == b.shape and np.array_equal(a, b, equal_nan=True)


def test_the_port_builds_its_own_library():
    assert HAVE_NATIVE, "g++ builds the library in this environment"
    path = tnative.lib_path()
    assert path.exists()
    assert path.parent == tnative._BUILD_DIR
    assert os.path.commonpath([str(path), jnative._BUILD_DIR]) != \
        jnative._BUILD_DIR
    with open(tnative._SRC, "rb") as a, open(jnative._SRC, "rb") as b:
        assert a.read() == b.read()


def _table_text(rng, rows, max_cols):
    lines = [f"{rows}  # count line with comment"]
    for i in range(rows):
        k = int(rng.integers(1, max_cols + 1))
        vals = rng.standard_normal(k) * 10.0 ** rng.integers(-5, 5, k)
        lines.append(" ".join(repr(float(v)) for v in vals))
        if i % 7 == 3:
            lines.append("// full-line comment to skip")
    return ("\n".join(lines) + "\n").encode()


@pytest.mark.parametrize("seed", range(3))
def test_parse_table_matches_reference(seed):
    rng = np.random.default_rng(seed)
    text = _table_text(rng, 400, 5)
    rt, nt = tnative.parse_table_native(text, 5)
    rj, nj = jnative.parse_table_native(text, 5)
    assert np.array_equal(nt, nj)
    live = np.arange(5)[None, :] < nt[:, None]
    assert np.array_equal(rt[live], rj[live])


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_structure_files_read_back_as_the_reference(tmp_path, kind,
                                                    monkeypatch):
    n = 500
    verts = RNG.random((n, 3))
    springs = np.stack([np.arange(n), (np.arange(n) + 1) % n,
                        RNG.uniform(1, 3, n), RNG.uniform(0, 0.1, n)],
                       axis=1)
    targets = np.stack([np.arange(0, n, 5), RNG.uniform(1, 5, n // 5)],
                       axis=1)
    data = jstruct.StructureData(name="s", vertices=verts, springs=springs,
                                 targets=targets)
    base = str(tmp_path / "s")
    jstruct.write_structure(base, data)
    if kind == "numpy":
        monkeypatch.setattr(tstruct, "_read_table_native",
                            lambda *a, **k: None)
    got = tstruct.read_structure(base)
    ref = jstruct.read_structure(base)
    for name in ("vertices", "springs", "targets"):
        assert np.array_equal(getattr(got, name), getattr(ref, name)), name


def test_base64_and_binary_vti_match_reference(tmp_path):
    for n in (0, 1, 2, 3, 100, 1001, 65537):
        data = RNG.bytes(n)
        assert tnative.base64_native(data) == base64.b64encode(data)
        assert tvtk._b64(data) == jvtk._b64(data)
    box = dict(x_lo=(0.0, 0.0, 0.0), x_up=(1.0, 1.0, 1.0))
    n = (6, 5, 4)
    p = RNG.standard_normal(n).astype(np.float32)
    u = RNG.standard_normal(n + (3,)).astype(np.float32)
    a = tvtk.write_vti(str(tmp_path / "t.vti"), TGrid(n=n, **box),
                       {"p": p, "u": u}, fmt="binary")
    b = jvtk.write_vti(str(tmp_path / "j.vti"), JGrid(n=n, **box),
                       {"p": p, "u": u}, fmt="binary")
    assert open(a, "rb").read() == open(b, "rb").read()


def test_write_vtu_matches_reference_bytes(tmp_path):
    from ibamr_tpu.fe import mesh as jmesh

    meshes = [jmesh.disc_mesh(n_rings=3),
              jmesh.to_quadratic(jmesh.disc_mesh(n_rings=2)),
              jmesh.rect_quad_mesh(3, 2), jmesh.box_hex_mesh(2, 2, 2)]
    for m in meshes:
        nodes = np.asarray(m.nodes) + 1e-3 * RNG.standard_normal(
            np.shape(m.nodes))
        pdata = {"disp": RNG.standard_normal(np.shape(m.nodes)),
                 "id": np.arange(m.n_nodes)}
        a = tvtk.write_vtu(str(tmp_path / f"t_{m.elem_type}.vtu"), nodes,
                           m.elems, m.elem_type, point_data=pdata)
        b = jvtk.write_vtu(str(tmp_path / f"j_{m.elem_type}.vtu"), nodes,
                           m.elems, m.elem_type, point_data=pdata)
        assert open(a, "rb").read() == open(b, "rb").read(), m.elem_type
    for mod in (tvtk, jvtk):
        with pytest.raises(ValueError, match="unsupported element"):
            mod.write_vtu(str(tmp_path / "bad.vtu"), meshes[0].nodes,
                          meshes[0].elems, "PYRAMID5")


def _raises_in_both(path, lo, hi, what, match=None):
    """Both packages raise the same message."""
    msgs = []
    for mod in (tstruct, jstruct):
        with pytest.raises(ValueError, match=match) as e:
            mod._read_table(str(path), lo, hi, what)
        msgs.append(str(e.value))
    assert msgs[0] == msgs[1]


@pytest.mark.parametrize("kind", ["native", "numpy"])
def test_strict_rejections_match_reference(tmp_path, kind, monkeypatch):
    native = kind == "native"
    if not native:
        for mod in (tstruct, jstruct):
            monkeypatch.setattr(mod, "_read_table_native",
                                lambda *a, **k: None)
    p = tmp_path / "bad.spring"
    for tok in ("oops", "0x10", "1e"):
        p.write_text(f"1\n0 1 {tok} 0.5\n")
        _raises_in_both(p, 4, 5, "spring")
    p = tmp_path / "t.target"
    p.write_text("1\n1 2 3 4 5\n")
    _raises_in_both(p, 2, 3, "target", match="columns")
    p = tmp_path / "v.vertex"
    for text in ("0.5 1.5\n0.25 0.75\n", "-3\n1 2\n"):
        p.write_text(text)
        # the NumPy parser reads "-3" as a count and finds no rows
        _raises_in_both(p, 2, 3, "vertex",
                        match="count" if native or text[0] != "-"
                        else "declared")
    p.write_text("3\n1 2\n")
    _raises_in_both(p, 2, 3, "vertex", match="declared")


def test_data_nan_survives_and_pads_are_zero(tmp_path):
    p = tmp_path / "t.target"
    for text in ("1\n1.0 2.0 nan\n", "2\n1.0 2.0 nan\n3.0 4.0\n"):
        p.write_text(text)
        got = tstruct._read_table(str(p), 2, 3, "target")
        assert _equal_nan(got, jstruct._read_table(str(p), 2, 3, "target"))
        assert np.isnan(got[0, 2])
    assert got[1, 2] == 0.0
