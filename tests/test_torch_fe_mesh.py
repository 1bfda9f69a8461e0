"""Port parity of ``fe/mesh.py``: every generator and converter gives the
reference's node and element arrays (nodes within 1e-13, integers
exact), the measure by each family's quadrature within 1e-13, the
Triangle and Gmsh readers read what the reference reads, and
``write_gmsh`` writes the reference's bytes, for every element family of
``tests/test_fe_elements.py`` (TRI3/6, QUAD4/8/9, TET4/10, HEX8/20/27)."""

import numpy as np
import pytest

from ibamr_tpu.fe import mesh as jm
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.fe import mesh as tm

FAMILIES = ["TRI3", "TRI6", "QUAD4", "QUAD8", "QUAD9", "TET4", "TET10",
            "HEX8", "HEX20", "HEX27"]


def _pair(etype):
    """The same mesh of ``etype`` built by each package's generators."""
    out = []
    for m in (jm, tm):
        if etype in ("TRI3", "TRI6"):
            mesh = m.disc_mesh(n_rings=3)
            mesh = mesh if etype == "TRI3" else m.to_quadratic(mesh)
        elif etype in ("TET4", "TET10"):
            mesh = m.block_mesh_tet(2, 1, 2, x_up=(1.0, 0.5, 0.8))
            mesh = mesh if etype == "TET4" else m.to_quadratic(mesh)
        elif etype.startswith("QUAD"):
            mesh = m.rect_quad_mesh(3, 2, x_lo=(0.1, -0.2), x_up=(0.9, 0.4))
            if etype != "QUAD4":
                mesh = m.to_quadratic_tensor(mesh,
                                             serendipity=etype == "QUAD8")
        else:
            mesh = m.box_hex_mesh(2, 1, 2, x_up=(1.0, 0.6, 0.7))
            if etype != "HEX8":
                mesh = m.to_quadratic_tensor(mesh,
                                             serendipity=etype == "HEX20")
        out.append(mesh)
    return out


def _same(ref, got):
    assert got.elem_type == ref.elem_type
    assert np.array_equal(np.asarray(got.elems), np.asarray(ref.elems))
    assert np.max(np.abs(got.nodes - ref.nodes)) <= 1e-13
    assert (got.dim, got.n_nodes, got.n_elems) == \
        (ref.dim, ref.n_nodes, ref.n_elems)


@pytest.mark.parametrize("etype", FAMILIES)
def test_generators_match_reference(etype):
    ref, got = _pair(etype)
    _same(ref, got)
    assert abs(got.volume() - ref.volume()) <= 1e-13 * ref.volume()


def test_block_mesh_tri_and_converter():
    ref = jm.block_mesh_tri(3, 4, x_lo=(0.2, 0.1), x_up=(0.7, 0.9))
    _same(ref, tm.block_mesh_tri(3, 4, x_lo=(0.2, 0.1), x_up=(0.7, 0.9)))
    _same(ref, convert.fe_mesh(ref))


def test_disc_mesh_options_match_reference():
    for kw in (dict(n_rings=1), dict(n_rings=6, radius=0.3,
                                     center=(0.4, 0.6))):
        _same(jm.disc_mesh(**kw), tm.disc_mesh(**kw))


@pytest.mark.parametrize("etype", ["TRI3", "TRI6", "QUAD4", "TET4", "TET10",
                                   "HEX8"])
def test_write_gmsh_byte_equal_and_read_back(etype, tmp_path):
    ref, got = _pair(etype)
    jm.write_gmsh(ref, str(tmp_path / "ref.msh"))
    tm.write_gmsh(got, str(tmp_path / "port.msh"))
    assert (tmp_path / "port.msh").read_bytes() == \
        (tmp_path / "ref.msh").read_bytes()
    _same(jm.read_gmsh(str(tmp_path / "ref.msh")),
          tm.read_gmsh(str(tmp_path / "ref.msh")))


def test_read_gmsh_mixed_blocks_and_surface_in_3d(tmp_path):
    """A file with a line block beside a surface block curved through 3D
    (its z column is kept), and an explicit type choice."""
    path = tmp_path / "mixed.msh"
    path.write_text(
        "$MeshFormat\n2.2 0 8\n$EndMeshFormat\n$Nodes\n5\n"
        "10 0 0 0\n11 1 0 0.1\n12 0 1 0.2\n13 1 1 0.0\n14 2 2 2\n"
        "$EndNodes\n$Elements\n4\n1 1 2 0 0 10 11\n"
        "2 2 2 0 0 10 11 12\n3 2 2 0 0 11 13 12\n4 15 2 0 0 14\n"
        "$EndElements\n")
    for kw in ({}, {"elem_type": "TRI3"}):
        _same(jm.read_gmsh(str(path), **kw), tm.read_gmsh(str(path), **kw))
    with pytest.raises(ValueError, match="no QUAD4"):
        tm.read_gmsh(str(path), elem_type="QUAD4")


def test_read_triangle_matches_reference(tmp_path):
    node, ele = tmp_path / "m.node", tmp_path / "m.ele"
    node.write_text("# a square\n4 2 0 0\n1 0.0 0.0\n2 1.0 0.0\n"
                    "3 1.0 1.0\n4 0.0 1.0\n")
    ele.write_text("2 3 0\n1 1 2 3\n2 1 3 4  # last\n")
    _same(jm.read_triangle(str(node), str(ele)),
          tm.read_triangle(str(node), str(ele)))


def test_to_quadratic_rejects_what_the_reference_rejects():
    quad = tm.rect_quad_mesh(1, 1)
    with pytest.raises(ValueError, match="not a linear simplex"):
        tm.to_quadratic(quad)
    with pytest.raises(ValueError, match="not a linear tensor"):
        tm.to_quadratic_tensor(tm.disc_mesh(n_rings=1))
