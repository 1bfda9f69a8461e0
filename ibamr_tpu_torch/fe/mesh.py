"""Finite-element meshes for the IBFE structure path (port of
``ibamr_tpu/fe/mesh.py``, the package's own copy: the port imports
nothing of the JAX package).

A mesh is plain host arrays (nodes, connectivity) built with NumPy;
everything the device touches is the quadrature tables of
:mod:`ibamr_tpu_torch.fe.fem`. Element families: TRI3/TRI6, QUAD4/8/9,
TET4/TET10 and HEX8/20/27, with the generators, the Triangle reader and
Gmsh MSH v2 ASCII import/export (``write_gmsh`` writes the reference's
bytes).
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Tuple

import numpy as np


@dataclass
class FEMesh:
    """Nodal mesh of one linear-simplex element type.

    nodes: (n_nodes, dim) float reference coordinates
    elems: (n_elems, nen) int connectivity (nen = dim + 1)
    elem_type: "TRI3" | "TET4" | "TRI6" | "TET10" | "QUAD4" | "HEX8"
    """
    nodes: np.ndarray
    elems: np.ndarray
    elem_type: str

    @property
    def dim(self) -> int:
        return self.nodes.shape[1]

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_elems(self) -> int:
        return self.elems.shape[0]

    def volume(self) -> float:
        """Total reference measure (area in 2D, volume in 3D), by the
        element family's own quadrature — exact for every type in the
        menu."""
        from ibamr_tpu_torch.fe.fem import _shape_table
        _, dN, qw = _shape_table(self.elem_type)
        X = self.nodes[self.elems]                    # (E, nen, dim)
        J = np.einsum("qad,eai->eqid", dN, X)
        return float(np.sum(np.abs(np.linalg.det(J)) * qw[None, :]))


def disc_mesh(radius: float = 0.25,
              center: Tuple[float, float] = (0.5, 0.5),
              n_rings: int = 8) -> FEMesh:
    """Unstructured TRI3 disc: a center node plus ``n_rings`` concentric
    rings; ring r holds ``6r`` nodes (hex-like layout keeps triangles
    well-shaped). The standard IBFE-ex0-style solid body."""
    nodes = [np.array(center, dtype=np.float64)]
    ring_start = [0]
    for r in range(1, n_rings + 1):
        ring_start.append(len(nodes))
        m = 6 * r
        th = 2.0 * np.pi * np.arange(m) / m
        rr = radius * r / n_rings
        for t in th:
            nodes.append(np.array([center[0] + rr * np.cos(t),
                                   center[1] + rr * np.sin(t)]))
    nodes = np.stack(nodes, axis=0)

    elems = []
    # inner fan: center to ring 1 (6 nodes)
    s1 = ring_start[1]
    for k in range(6):
        elems.append([0, s1 + k, s1 + (k + 1) % 6])
    # strips between ring r (6r nodes) and ring r+1 (6(r+1) nodes)
    for r in range(1, n_rings):
        si, mi = ring_start[r], 6 * r
        so, mo = ring_start[r + 1], 6 * (r + 1)
        # walk the outer ring; connect each outer edge to the nearest
        # inner node, and fill the leftover wedges
        inner_of = [int(np.floor(k * mi / mo + 0.5)) % mi
                    for k in range(mo)]
        for k in range(mo):
            k1 = (k + 1) % mo
            a, b = inner_of[k], inner_of[k1]
            elems.append([so + k, so + k1, si + a])
            if a != b:
                elems.append([so + k1, si + b, si + a])
    return FEMesh(nodes=nodes, elems=np.asarray(elems, dtype=np.int32),
                  elem_type="TRI3")


def block_mesh_tri(nx: int, ny: int,
                   x_lo: Tuple[float, float] = (0.0, 0.0),
                   x_up: Tuple[float, float] = (1.0, 1.0)) -> FEMesh:
    """Structured TRI3 rectangle: (nx x ny) quads split into 2 triangles."""
    xs = np.linspace(x_lo[0], x_up[0], nx + 1)
    ys = np.linspace(x_lo[1], x_up[1], ny + 1)
    gx, gy = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([gx.ravel(), gy.ravel()], axis=1)

    def nid(i, j):
        return i * (ny + 1) + j

    elems = []
    for i in range(nx):
        for j in range(ny):
            a, b = nid(i, j), nid(i + 1, j)
            c, d = nid(i + 1, j + 1), nid(i, j + 1)
            elems.append([a, b, c])
            elems.append([a, c, d])
    return FEMesh(nodes=nodes, elems=np.asarray(elems, dtype=np.int32),
                  elem_type="TRI3")


def block_mesh_tet(nx: int, ny: int, nz: int,
                   x_lo=(0.0, 0.0, 0.0), x_up=(1.0, 1.0, 1.0)) -> FEMesh:
    """Structured TET4 box: each hex cell split into 6 tetrahedra."""
    xs = np.linspace(x_lo[0], x_up[0], nx + 1)
    ys = np.linspace(x_lo[1], x_up[1], ny + 1)
    zs = np.linspace(x_lo[2], x_up[2], nz + 1)
    gx, gy, gz = np.meshgrid(xs, ys, zs, indexing="ij")
    nodes = np.stack([gx.ravel(), gy.ravel(), gz.ravel()], axis=1)

    def nid(i, j, k):
        return (i * (ny + 1) + j) * (nz + 1) + k

    # 6-tet (Kuhn) subdivision of the unit cube
    kuhn = [(0, 1, 3, 7), (0, 1, 5, 7), (0, 2, 3, 7),
            (0, 2, 6, 7), (0, 4, 5, 7), (0, 4, 6, 7)]
    elems = []
    for i in range(nx):
        for j in range(ny):
            for k in range(nz):
                corner = [nid(i + a, j + b, k + c)
                          for a in (0, 1) for b in (0, 1) for c in (0, 1)]
                # corner index bit order: a*4 + b*2 + c
                for t in kuhn:
                    elems.append([corner[v] for v in t])
    return FEMesh(nodes=nodes, elems=np.asarray(elems, dtype=np.int32),
                  elem_type="TET4")


def _read_tokens(path: str):
    """Whitespace tokens with Triangle-format '#' comments stripped."""
    with open(path) as f:
        return [t for line in f
                for t in line.split("#", 1)[0].split()]


def read_triangle(node_path: str, ele_path: str) -> FEMesh:
    """Read a mesh in the public Triangle ``.node``/``.ele`` ASCII format
    (the rebuild's analog of the reference's libMesh file readers)."""
    toks = _read_tokens(node_path)
    n_nodes, dim = int(toks[0]), int(toks[1])
    n_attr, n_bdry = int(toks[2]), int(toks[3])
    stride = 1 + dim + n_attr + n_bdry
    body = toks[4:4 + n_nodes * stride]
    first_idx = int(body[0])
    nodes = np.array(
        [[float(body[r * stride + 1 + d]) for d in range(dim)]
         for r in range(n_nodes)])
    toks = _read_tokens(ele_path)
    n_elems, nen = int(toks[0]), int(toks[1])
    n_attr = int(toks[2])
    stride = 1 + nen + n_attr
    body = toks[3:3 + n_elems * stride]
    elems = np.array(
        [[int(body[r * stride + 1 + a]) - first_idx for a in range(nen)]
         for r in range(n_elems)], dtype=np.int32)
    etype = "TRI3" if nen == 3 else "TET4"
    return FEMesh(nodes=nodes, elems=elems, elem_type=etype)


def to_quadratic(mesh: FEMesh) -> FEMesh:
    """Convert a linear simplex mesh to its quadratic family member
    (TRI3 -> TRI6, TET4 -> TET10) by inserting midside nodes — the
    higher-order path of the reference's general element support
    (T16/P17). Shared edges share one midside node."""
    if mesh.elem_type == "TRI3":
        edges = [(0, 1), (1, 2), (2, 0)]
        new_type = "TRI6"
    elif mesh.elem_type == "TET4":
        edges = [(0, 1), (1, 2), (0, 2), (0, 3), (1, 3), (2, 3)]
        new_type = "TET10"
    else:
        raise ValueError(f"to_quadratic: {mesh.elem_type} is not a "
                         "linear simplex type")
    edge_id = {}
    E = mesh.n_elems
    mids = np.zeros((E, len(edges)), dtype=mesh.elems.dtype)
    next_id = mesh.n_nodes
    new_pts = []
    for e in range(E):
        conn = mesh.elems[e]
        for m, (i, j) in enumerate(edges):
            key = (min(conn[i], conn[j]), max(conn[i], conn[j]))
            if key not in edge_id:
                edge_id[key] = next_id
                new_pts.append(0.5 * (mesh.nodes[conn[i]]
                                      + mesh.nodes[conn[j]]))
                next_id += 1
            mids[e, m] = edge_id[key]
    all_nodes = np.concatenate([mesh.nodes, np.asarray(new_pts)], axis=0)
    elems = np.concatenate([mesh.elems, mids], axis=1)
    return FEMesh(nodes=all_nodes, elems=elems, elem_type=new_type)


def to_quadratic_tensor(mesh: FEMesh, serendipity: bool = False
                        ) -> FEMesh:
    """Convert a tensor mesh to its quadratic family member
    (QUAD4 -> QUAD9/QUAD8, HEX8 -> HEX27/HEX20) by inserting edge
    midpoints (shared), plus face centers and the cell center for the
    full (non-serendipity) families — node order matching
    fe.fem's libMesh-convention shape tables (corners, edges[,
    faces, center])."""
    if mesh.elem_type == "QUAD4":
        edges = [(0, 1), (1, 2), (2, 3), (3, 0)]
        faces = []
        new_type = "QUAD8" if serendipity else "QUAD9"
        center_nodes = not serendipity
    elif mesh.elem_type == "HEX8":
        edges = [(0, 1), (1, 2), (2, 3), (3, 0),
                 (0, 4), (1, 5), (2, 6), (3, 7),
                 (4, 5), (5, 6), (6, 7), (7, 4)]
        faces = [(0, 1, 2, 3), (0, 1, 5, 4), (1, 2, 6, 5),
                 (2, 3, 7, 6), (3, 0, 4, 7), (4, 5, 6, 7)]
        new_type = "HEX20" if serendipity else "HEX27"
        center_nodes = not serendipity
        if serendipity:
            faces = []
    else:
        raise ValueError(f"to_quadratic_tensor: {mesh.elem_type} is "
                         "not a linear tensor type")
    E = mesh.n_elems
    next_id = mesh.n_nodes
    new_pts = []
    edge_id = {}
    mids = np.zeros((E, len(edges)), dtype=mesh.elems.dtype)
    for e in range(E):
        conn = mesh.elems[e]
        for m, (i, j) in enumerate(edges):
            key = (min(conn[i], conn[j]), max(conn[i], conn[j]))
            if key not in edge_id:
                edge_id[key] = next_id
                new_pts.append(0.5 * (mesh.nodes[conn[i]]
                                      + mesh.nodes[conn[j]]))
                next_id += 1
            mids[e, m] = edge_id[key]
    cols = [mesh.elems, mids]
    if faces:
        face_id = {}
        fmids = np.zeros((E, len(faces)), dtype=mesh.elems.dtype)
        for e in range(E):
            conn = mesh.elems[e]
            for m, idx in enumerate(faces):
                key = tuple(sorted(int(conn[i]) for i in idx))
                if key not in face_id:
                    face_id[key] = next_id
                    new_pts.append(np.mean(
                        [mesh.nodes[conn[i]] for i in idx], axis=0))
                    next_id += 1
                fmids[e, m] = face_id[key]
        cols.append(fmids)
    if center_nodes:
        centers = np.arange(next_id, next_id + E,
                            dtype=mesh.elems.dtype)[:, None]
        new_pts.extend(np.mean(mesh.nodes[mesh.elems[e]], axis=0)
                       for e in range(E))
        next_id += E
        cols.append(centers)
    all_nodes = np.concatenate([mesh.nodes, np.asarray(new_pts)],
                               axis=0)
    return FEMesh(nodes=all_nodes,
                  elems=np.concatenate(cols, axis=1),
                  elem_type=new_type)


def rect_quad_mesh(nx: int, ny: int,
                   x_lo=(0.0, 0.0), x_up=(1.0, 1.0)) -> FEMesh:
    """Structured QUAD4 mesh of a rectangle."""
    xs = np.linspace(x_lo[0], x_up[0], nx + 1)
    ys = np.linspace(x_lo[1], x_up[1], ny + 1)
    X, Y = np.meshgrid(xs, ys, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1)], axis=1)
    nid = np.arange((nx + 1) * (ny + 1)).reshape(nx + 1, ny + 1)
    elems = np.stack([nid[:-1, :-1], nid[1:, :-1],
                      nid[1:, 1:], nid[:-1, 1:]],
                     axis=-1).reshape(-1, 4)
    return FEMesh(nodes=nodes, elems=elems.astype(np.int64),
                  elem_type="QUAD4")


def box_hex_mesh(nx: int, ny: int, nz: int,
                 x_lo=(0.0, 0.0, 0.0), x_up=(1.0, 1.0, 1.0)) -> FEMesh:
    """Structured HEX8 mesh of a box."""
    axes = [np.linspace(x_lo[d], x_up[d], n + 1)
            for d, n in enumerate((nx, ny, nz))]
    X, Y, Z = np.meshgrid(*axes, indexing="ij")
    nodes = np.stack([X.reshape(-1), Y.reshape(-1), Z.reshape(-1)],
                     axis=1)
    nid = np.arange(nodes.shape[0]).reshape(nx + 1, ny + 1, nz + 1)
    c = nid[:-1, :-1, :-1]
    elems = np.stack([
        c, nid[1:, :-1, :-1], nid[1:, 1:, :-1], nid[:-1, 1:, :-1],
        nid[:-1, :-1, 1:], nid[1:, :-1, 1:], nid[1:, 1:, 1:],
        nid[:-1, 1:, 1:]], axis=-1).reshape(-1, 8)
    return FEMesh(nodes=nodes, elems=elems.astype(np.int64),
                  elem_type="HEX8")


# --------------------------------------------------------------------------
# Gmsh MSH v2 ASCII import/export (T16 external-geometry path)
# --------------------------------------------------------------------------

# Gmsh element-type id -> (elem_type, nodes-per-element, topological dim).
# Node orderings (Gmsh reference manual §9.3) match this module's
# conventions directly for TRI3/TRI6/TET4/QUAD4/HEX8; TET10 differs in
# the last two midside nodes — Gmsh stores e(2,3) at slot 8 and e(1,3)
# at slot 9, while fem._shape_table's TET10 (libMesh order) wants
# e(1,3) then e(2,3) — so slots 8 and 9 are swapped on read/write.
_GMSH_TYPES = {
    2: ("TRI3", 3, 2),
    3: ("QUAD4", 4, 2),
    4: ("TET4", 4, 3),
    5: ("HEX8", 8, 3),
    9: ("TRI6", 6, 2),
    11: ("TET10", 10, 3),
}
_GMSH_IDS = {v[0]: (k, v[1], v[2]) for k, v in _GMSH_TYPES.items()}
_TET10_GMSH_TO_LIBMESH = [0, 1, 2, 3, 4, 5, 6, 7, 9, 8]


def read_gmsh(path: str, elem_type: str = None) -> FEMesh:
    """Read a Gmsh ``.msh`` v2 ASCII file into an :class:`FEMesh` —
    the rebuild's analog of the reference's libMesh mesh readers
    (``FEDataManager`` geometry input via ``libMesh::ExodusII_IO`` /
    ``GmshIO``, SURVEY.md T16 [U]): user geometries enter the IBFE
    path from a file instead of the programmatic generators.

    Supports the full element menu of :mod:`ibamr_tpu_torch.fe.fem`
    (TRI3/TRI6/QUAD4/TET4/TET10/HEX8). A file may carry several
    element types (boundary lines/faces alongside the solid): the
    reader keeps ``elem_type`` if given, else the highest-dimension
    supported type present (the solid body). Node ids may be
    non-contiguous (Gmsh never guarantees contiguity); they are
    remapped densely and unreferenced nodes are dropped. For 2D
    element types the z column is discarded only when degenerate
    (all ~0); a surface mesh embedded in 3D keeps all three columns
    (spatial dim independent of element dim, as in libMesh).
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f]

    def section(name):
        try:
            a = lines.index(f"${name}") + 1
            b = lines.index(f"$End{name}")
        except ValueError:
            raise ValueError(f"{path}: missing ${name} section "
                             "(is this MSH v2 ASCII?)")
        return lines[a:b]

    fmt = section("MeshFormat")[0].split()
    if not fmt[0].startswith("2"):
        raise ValueError(
            f"{path}: MSH version {fmt[0]} unsupported (need v2 ASCII; "
            "export with `gmsh -format msh2`)")
    if int(fmt[1]) != 0:
        raise ValueError(f"{path}: binary MSH unsupported")

    node_lines = section("Nodes")
    n_nodes = int(node_lines[0])
    ids = np.empty(n_nodes, dtype=np.int64)
    xyz = np.empty((n_nodes, 3), dtype=np.float64)
    for r, ln in enumerate(node_lines[1:1 + n_nodes]):
        t = ln.split()
        ids[r] = int(t[0])
        xyz[r] = [float(t[1]), float(t[2]), float(t[3])]
    id2row = {int(i): r for r, i in enumerate(ids)}

    elem_lines = section("Elements")
    n_elems = int(elem_lines[0])
    by_type = {}
    for ln in elem_lines[1:1 + n_elems]:
        t = ln.split()
        gtype = int(t[1])
        if gtype not in _GMSH_TYPES:
            continue                      # points/lines/unsupported
        name, nen, _ = _GMSH_TYPES[gtype]
        ntags = int(t[2])
        conn = [id2row[int(v)] for v in t[3 + ntags:3 + ntags + nen]]
        by_type.setdefault(name, []).append(conn)
    if not by_type:
        raise ValueError(f"{path}: no supported volume/surface elements")

    if elem_type is None:
        elem_type = max(by_type, key=lambda k: (_GMSH_IDS[k][2],
                                                len(by_type[k])))
    if elem_type not in by_type:
        raise ValueError(f"{path}: no {elem_type} elements "
                         f"(found {sorted(by_type)})")
    elems = np.asarray(by_type[elem_type], dtype=np.int64)
    if elem_type == "TET10":
        elems = elems[:, _TET10_GMSH_TO_LIBMESH]

    # drop nodes not referenced by the kept element block (the file may
    # carry boundary-only nodes or other-dimension blocks); remap
    # connectivity densely
    used = np.unique(elems)
    dim = _GMSH_IDS[elem_type][2]
    # Spatial dim is independent of element dim (libMesh semantics): a
    # TRI3/TRI6 shell CURVED through 3D (codim-1 IBFE surface) must
    # keep its z column. A planar sheet — z constant across the nodes
    # this block references, whether at z=0, an offset plane, or with
    # CAD-transform roundoff — stays a 2D solid (the volumetric FE
    # path needs square Jacobians). Spread is measured against the
    # mesh extent so roundoff-level z noise never promotes.
    if dim == 2:
        zs = xyz[used, 2]
        extent = max(1.0, float(np.ptp(xyz[used], axis=0).max()))
        if float(np.ptp(zs)) > 1e-9 * extent:
            dim = 3
    nodes = xyz[:, :dim]
    remap = -np.ones(nodes.shape[0], dtype=np.int64)
    remap[used] = np.arange(used.size)
    return FEMesh(nodes=nodes[used], elems=remap[elems],
                  elem_type=elem_type)


def write_gmsh(mesh: FEMesh, path: str) -> None:
    """Write an :class:`FEMesh` as Gmsh ``.msh`` v2 ASCII (round-trip
    partner of :func:`read_gmsh`; also lets generated meshes feed any
    external Gmsh-reading tool)."""
    gtype, nen, _ = _GMSH_IDS[mesh.elem_type]
    elems = mesh.elems
    if mesh.elem_type == "TET10":
        inv = np.argsort(_TET10_GMSH_TO_LIBMESH)
        elems = elems[:, inv]
    with open(path, "w") as f:
        f.write("$MeshFormat\n2.2 0 8\n$EndMeshFormat\n")
        f.write(f"$Nodes\n{mesh.n_nodes}\n")
        for i, p in enumerate(mesh.nodes):
            x, y = p[0], p[1]
            z = p[2] if mesh.dim == 3 else 0.0
            f.write(f"{i + 1} {x:.17g} {y:.17g} {z:.17g}\n")
        f.write("$EndNodes\n")
        f.write(f"$Elements\n{mesh.n_elems}\n")
        for e, conn in enumerate(elems):
            nodes = " ".join(str(int(v) + 1) for v in conn)
            f.write(f"{e + 1} {gtype} 2 0 0 {nodes}\n")
        f.write("$EndElements\n")
