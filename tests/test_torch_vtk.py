"""Port parity of ``io/vtk.py``: the same arrays give byte-equal
``.vti`` (ascii and inline-binary), ``.vtp`` (vertices, polylines, point
data) and ``.pvd`` files in both packages. The reference encodes binary
payloads with its native encoder when that is built, the port with the
standard library; both are standard base64."""

import numpy as np
import pytest

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.io import vtk as jvtk
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.io import vtk as tvtk


def _grids(dim):
    box = dict(n=(6, 4, 3)[:dim], x_lo=(0.0, -0.5, 0.25)[:dim],
               x_up=(1.5, 0.5, 1.0)[:dim])
    return JGrid(**box), TGrid(**box)


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("fmt", ["ascii", "binary"])
def test_vti_bytes_equal(tmp_path, dim, fmt):
    jg, tg = _grids(dim)
    rng = np.random.default_rng(dim)
    fields = {"p": rng.standard_normal(tg.n),
              "u": tuple(rng.standard_normal(tg.n) for _ in range(dim)),
              "w": rng.standard_normal((dim,) + tg.n)}
    a = jvtk.write_vti(str(tmp_path / "a.vti"), jg, fields, fmt=fmt)
    b = tvtk.write_vti(str(tmp_path / "b.vti"), tg, fields, fmt=fmt)
    assert open(a, "rb").read() == open(b, "rb").read()
    with pytest.raises(ValueError):
        tvtk.write_vti(str(tmp_path / "c.vti"), tg, fields, fmt="hdf5")


@pytest.mark.parametrize("lines", [None, [[0, 1, 2, 3], [4, 5, 6]]])
def test_vtp_bytes_equal(tmp_path, lines):
    rng = np.random.default_rng(3)
    X = rng.standard_normal((7, 2))
    data = {"F": rng.standard_normal((7, 2)), "s": rng.standard_normal(7)}
    a = jvtk.write_vtp(str(tmp_path / "a.vtp"), X, data, lines=lines)
    b = tvtk.write_vtp(str(tmp_path / "b.vtp"), X, data, lines=lines)
    assert open(a, "rb").read() == open(b, "rb").read()


def test_viz_writer_series_bytes_equal(tmp_path):
    jg, tg = _grids(2)
    jw = jvtk.VizWriter(str(tmp_path / "jax"), jg)
    tw = tvtk.VizWriter(str(tmp_path / "port"), tg)
    rng = np.random.default_rng(4)
    for step, t in ((10, 0.1), (20, 0.2)):
        kw = dict(cell_fields={"u": rng.standard_normal(tg.n),
                               "p": rng.standard_normal(tg.n)},
                  markers=rng.standard_normal((5, 2)),
                  marker_data={"U": rng.standard_normal((5, 2))})
        jw.dump(step, t, **kw)
        tw.dump(step, t, **kw)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert names == ["eul_000010.vti", "eul_000020.vti", "eulerian.pvd",
                     "lag_000010.vtp", "lag_000020.vtp", "lagrangian.pvd"]
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name


def test_base64_matches_the_reference_encoder():
    data = bytes(range(256)) * 3 + b"\x00\x01"
    assert tvtk._b64(data) == jvtk._b64(data)


@pytest.mark.parametrize("fmt", ["ascii", "binary"])
@pytest.mark.parametrize("dim", [2, 3])
def test_vtm_hierarchy_bytes_equal(tmp_path, dim, fmt):
    """The AMR hierarchy dump: the .vtm index, one .vti per level and the
    hierarchy.pvd series, byte for byte."""
    from ibamr_tpu.amr import FineBox as JBox
    from ibamr_tpu_torch.amr import FineBox as TBox

    jg, tg = _grids(dim)
    lo, shape = (1,) * dim, (2,) * dim
    jf, tf = JBox(lo, shape).fine_grid(jg), TBox(lo, shape).fine_grid(tg)
    rng = np.random.default_rng(5)
    jw = jvtk.VizWriter(str(tmp_path / "jax"), jg)
    tw = tvtk.VizWriter(str(tmp_path / "port"), tg)
    for step, t in ((50, 0.0125), (100, 0.025)):
        fields = [{"u": tuple(rng.standard_normal(tg.n) for _ in range(dim))},
                  {"u": tuple(rng.standard_normal(tf.n) for _ in range(dim)),
                   "p": rng.standard_normal(tf.n)}]
        jw.dump_hierarchy(step, t, [jg, jf], fields, fmt=fmt)
        tw.dump_hierarchy(step, t, [tg, tf], fields, fmt=fmt)
    names = sorted(p.name for p in (tmp_path / "jax").iterdir())
    assert names == sorted(p.name for p in (tmp_path / "port").iterdir())
    assert "hierarchy.pvd" in names and "amr_000100_L1.vti" in names
    for name in names:
        assert (tmp_path / "jax" / name).read_bytes() == \
            (tmp_path / "port" / name).read_bytes(), name
    with pytest.raises(ValueError, match="dropped"):
        tvtk.write_vtm_hierarchy(str(tmp_path / "x.vtm"), [tg, tf],
                                 fields[:1])
