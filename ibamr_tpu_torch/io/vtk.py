"""VTK XML writers: Eulerian grid fields and Lagrangian marker data (port
of ``ibamr_tpu/io/vtk.py``).

``.vti`` ImageData for cell fields (ascii, or inline base64 binary),
``.vtp`` PolyData for markers and fiber polylines, and ``.pvd``
collections indexing a time series, and the ``.vtm`` multiblock index of
an AMR hierarchy (one ``.vti`` per level), byte for byte as the reference
writes them, and the ``.vtu`` UnstructuredGrid of an FE mesh. Fields come
as numpy arrays (callers move tensors to the host once per dump). Binary
payloads are encoded by the native C++ encoder of ``io/native.py`` when
it is available, else by the stdlib: the same bytes either way.
"""

from __future__ import annotations

import base64
import os
from typing import Dict, Optional, Sequence

import numpy as np

from ibamr_tpu_torch.grid import StaggeredGrid


def _ascii(flat: np.ndarray) -> str:
    """Float32-precision ascii payload (callers pass data pre-raveled
    in the required order)."""
    return " ".join(f"{v:.7g}" for v in np.asarray(flat).ravel())


def _b64(data: bytes) -> str:
    """Base64 via the native C++ encoder (``io/native.py``), with the
    stdlib encoder when the library is unavailable."""
    from ibamr_tpu_torch.io.native import base64_native

    out = base64_native(data)
    if out is None:
        out = base64.b64encode(data)
    return out.decode("ascii")


def _binary_payload(arr: np.ndarray) -> str:
    """VTK inline-binary DataArray payload: uint32 byte count header +
    raw little-endian data, base64 encoded."""
    raw = np.ascontiguousarray(arr, dtype=np.float32).tobytes()
    head = np.uint32(len(raw)).tobytes()
    return _b64(head + raw)


def write_vti(path: str, grid: StaggeredGrid,
              cell_fields: Optional[Dict[str, np.ndarray]] = None,
              fmt: str = "ascii") -> str:
    """Write cell-centered fields on the uniform grid as VTK ImageData.

    Vector fields may be passed as tuples/stacked (dim, *n) arrays —
    written as 3-component vectors (zero-padded in 2D).
    ``fmt``: "ascii" (diff-friendly) or "binary" (inline base64, for
    large grids).
    """
    if fmt not in ("ascii", "binary"):
        raise ValueError(f"unknown vti format {fmt!r}")
    cell_fields = cell_fields or {}
    dim = grid.dim
    n = tuple(grid.n) + (1,) * (3 - dim)
    dx = tuple(grid.dx) + (1.0,) * (3 - dim)
    x0 = tuple(grid.x_lo) + (0.0,) * (3 - dim)

    def emit(parts, flat, name, ncomp):
        comp_attr = (f'NumberOfComponents="{ncomp}" ' if ncomp > 1 else "")
        parts.append(f'        <DataArray type="Float32" Name="{name}" '
                     f'{comp_attr}format="{fmt}">\n')
        if fmt == "ascii":
            parts.append(_ascii(flat))
        else:
            parts.append(_binary_payload(flat))
        parts.append('\n        </DataArray>\n')

    parts = []
    parts.append('<?xml version="1.0"?>\n')
    parts.append('<VTKFile type="ImageData" version="0.1" '
                 'byte_order="LittleEndian" header_type="UInt32">\n')
    parts.append(f'  <ImageData WholeExtent="0 {n[0]} 0 {n[1]} 0 {n[2]}" '
                 f'Origin="{x0[0]} {x0[1]} {x0[2]}" '
                 f'Spacing="{dx[0]} {dx[1]} {dx[2]}">\n')
    parts.append(f'    <Piece Extent="0 {n[0]} 0 {n[1]} 0 {n[2]}">\n')
    parts.append('      <CellData>\n')
    for name, arr in cell_fields.items():
        a = np.asarray(arr)
        if isinstance(arr, (tuple, list)) or a.ndim == dim + 1:
            comps = [np.asarray(c) for c in arr] if isinstance(
                arr, (tuple, list)) else [a[d] for d in range(a.shape[0])]
            while len(comps) < 3:
                comps.append(np.zeros_like(comps[0]))
            vec = np.stack([c.ravel(order="F") for c in comps], axis=1)
            emit(parts, vec, name, 3)
        else:
            emit(parts, a.ravel(order="F"), name, 1)
    parts.append('      </CellData>\n')
    parts.append('    </Piece>\n  </ImageData>\n</VTKFile>\n')
    with open(path, "w") as f:
        f.write("".join(parts))
    return path


def write_vtp(path: str, X: np.ndarray,
              point_data: Optional[Dict[str, np.ndarray]] = None,
              lines: Optional[Sequence[Sequence[int]]] = None) -> str:
    """Write markers (and optional fiber polylines) as VTK PolyData.

    X: (N, dim) positions (zero-padded to 3D); point_data: per-marker
    scalars/vectors; lines: index chains rendered as polylines (the
    LSiloDataWriter fiber analog).
    """
    X = np.asarray(X, dtype=np.float64)
    N, dim = X.shape
    if dim < 3:
        X = np.concatenate([X, np.zeros((N, 3 - dim))], axis=1)
    point_data = point_data or {}
    lines = lines or []

    parts = []
    parts.append('<?xml version="1.0"?>\n')
    parts.append('<VTKFile type="PolyData" version="0.1" '
                 'byte_order="LittleEndian">\n  <PolyData>\n')
    n_verts = 0 if lines else N
    parts.append(f'    <Piece NumberOfPoints="{N}" NumberOfVerts="{n_verts}" '
                 f'NumberOfLines="{len(lines)}" NumberOfStrips="0" '
                 'NumberOfPolys="0">\n')
    parts.append('      <Points>\n        <DataArray type="Float32" '
                 'NumberOfComponents="3" format="ascii">\n')
    parts.append(_ascii(X))
    parts.append('\n        </DataArray>\n      </Points>\n')

    parts.append('      <PointData>\n')
    for name, arr in point_data.items():
        a = np.asarray(arr, dtype=np.float64)
        if a.ndim == 2:
            if a.shape[1] < 3:
                a = np.concatenate(
                    [a, np.zeros((a.shape[0], 3 - a.shape[1]))], axis=1)
            parts.append(f'        <DataArray type="Float32" Name="{name}" '
                         'NumberOfComponents="3" format="ascii">\n')
        else:
            parts.append(f'        <DataArray type="Float32" Name="{name}" '
                         'format="ascii">\n')
        parts.append(_ascii(a))
        parts.append('\n        </DataArray>\n')
    parts.append('      </PointData>\n')

    if lines:
        conn = []
        offs = []
        total = 0
        for chain in lines:
            conn.extend(int(i) for i in chain)
            total += len(chain)
            offs.append(total)
        parts.append('      <Lines>\n        <DataArray type="Int32" '
                     'Name="connectivity" format="ascii">\n')
        parts.append(" ".join(str(i) for i in conn))
        parts.append('\n        </DataArray>\n        <DataArray '
                     'type="Int32" Name="offsets" format="ascii">\n')
        parts.append(" ".join(str(i) for i in offs))
        parts.append('\n        </DataArray>\n      </Lines>\n')
    else:
        parts.append('      <Verts>\n        <DataArray type="Int32" '
                     'Name="connectivity" format="ascii">\n')
        parts.append(" ".join(str(i) for i in range(N)))
        parts.append('\n        </DataArray>\n        <DataArray '
                     'type="Int32" Name="offsets" format="ascii">\n')
        parts.append(" ".join(str(i + 1) for i in range(N)))
        parts.append('\n        </DataArray>\n      </Verts>\n')

    parts.append('    </Piece>\n  </PolyData>\n</VTKFile>\n')
    with open(path, "w") as f:
        f.write("".join(parts))
    return path


class VizWriter:
    """Time-series dump manager (the VisItDataWriter/viz_dump_interval
    analog): collects per-step .vti/.vtp files under ``viz_dir`` and
    maintains .pvd collection indexes ParaView opens directly."""

    def __init__(self, viz_dir: str, grid: StaggeredGrid):
        self.viz_dir = viz_dir
        self.grid = grid
        os.makedirs(viz_dir, exist_ok=True)
        self._eul: list = []
        self._lag: list = []
        self._amr: list = []

    def dump(self, step: int, t: float,
             cell_fields: Optional[Dict] = None,
             markers: Optional[np.ndarray] = None,
             marker_data: Optional[Dict] = None,
             fibers: Optional[Sequence[Sequence[int]]] = None) -> None:
        if cell_fields:
            fname = f"eul_{step:06d}.vti"
            write_vti(os.path.join(self.viz_dir, fname), self.grid,
                      {k: np.asarray(v) if not isinstance(v, (tuple, list))
                       else tuple(np.asarray(c) for c in v)
                       for k, v in cell_fields.items()})
            self._eul.append((t, fname))
        if markers is not None:
            fname = f"lag_{step:06d}.vtp"
            write_vtp(os.path.join(self.viz_dir, fname),
                      np.asarray(markers),
                      point_data={k: np.asarray(v) for k, v in
                                  (marker_data or {}).items()},
                      lines=fibers)
            self._lag.append((t, fname))
        self._write_pvd()

    def dump_hierarchy(self, step: int, t: float, level_grids,
                       level_fields, fmt: str = "ascii") -> None:
        """AMR time-series dump: a .vtm multiblock (one ImageData per
        level) per step, indexed by hierarchy.pvd."""
        fname = f"amr_{step:06d}.vtm"
        write_vtm_hierarchy(os.path.join(self.viz_dir, fname),
                            level_grids, level_fields, fmt=fmt)
        self._amr.append((t, fname))
        self._write_pvd()

    def _write_pvd(self) -> None:
        for series, name in ((self._eul, "eulerian.pvd"),
                             (self._lag, "lagrangian.pvd"),
                             (self._amr, "hierarchy.pvd")):
            if not series:
                continue
            rows = "\n".join(
                f'    <DataSet timestep="{t}" file="{f}"/>'
                for t, f in series)
            body = ('<?xml version="1.0"?>\n<VTKFile type="Collection" '
                    'version="0.1">\n  <Collection>\n'
                    + rows + '\n  </Collection>\n</VTKFile>\n')
            with open(os.path.join(self.viz_dir, name), "w") as f:
                f.write(body)


def write_vtm_hierarchy(path: str, level_grids, level_fields,
                        fmt: str = "ascii") -> str:
    """AMR hierarchy dump: one ``.vti`` ImageData per level (each with its
    own origin and spacing) referenced from a ``.vtm``
    vtkMultiBlockDataSet index. ``level_grids``: one StaggeredGrid per
    level (level 0 the root, finer levels e.g. ``box.fine_grid(parent)``);
    ``level_fields``: per-level dict for :func:`write_vti`."""
    if len(level_grids) != len(level_fields):
        raise ValueError(
            f"{len(level_grids)} level grids vs {len(level_fields)} "
            "field dicts — a level would be silently dropped")
    base = os.path.splitext(os.path.basename(path))[0]
    d = os.path.dirname(path) or "."
    os.makedirs(d, exist_ok=True)
    rows = []
    for l, (g, fields) in enumerate(zip(level_grids, level_fields)):
        fname = f"{base}_L{l}.vti"
        write_vti(os.path.join(d, fname), g, fields, fmt=fmt)
        rows.append(f'    <Block index="{l}" name="level_{l}">\n'
                    f'      <DataSet index="0" file="{fname}"/>\n'
                    f'    </Block>')
    body = ('<?xml version="1.0"?>\n'
            '<VTKFile type="vtkMultiBlockDataSet" version="1.0" '
            'byte_order="LittleEndian">\n'
            '  <vtkMultiBlockDataSet>\n'
            + "\n".join(rows)
            + '\n  </vtkMultiBlockDataSet>\n</VTKFile>\n')
    with open(path, "w") as f:
        f.write(body)
    return path


# VTK cell-type ids for the FE element menu. Node orderings: VTK's
# quadratic simplices list corners then edge midpoints over the same
# edge sets as fe/fem.py's libMesh-order tables ((0,1),(1,2),(2,0)[,(0,3),
# (1,3),(2,3)]) — midpoints are direction-free, so connectivity passes
# through unchanged; QUAD4/HEX8 counterclockwise/bottom-top orders also
# coincide.
_VTK_CELL_TYPES = {
    "TRI3": 5,
    "QUAD4": 9,
    "TET4": 10,
    "HEX8": 12,
    "TRI6": 22,
    "TET10": 24,
}


def write_vtu(path: str, nodes: np.ndarray, elems: np.ndarray,
              elem_type: str,
              point_data: Optional[Dict[str, np.ndarray]] = None) -> str:
    """Write an FE mesh (current or reference configuration) as VTK
    UnstructuredGrid — the IBFE structure-viz analog of the reference's
    libMesh Exodus output: ParaView renders the
    deformed solid with its real element connectivity, not just a
    marker cloud. ``point_data``: per-node scalars/vectors (zero-padded
    to 3 components)."""
    if elem_type not in _VTK_CELL_TYPES:
        raise ValueError(f"unsupported element type {elem_type!r} "
                         f"(menu: {sorted(_VTK_CELL_TYPES)})")
    nodes = np.asarray(nodes, dtype=np.float64)
    elems = np.asarray(elems, dtype=np.int64)
    N, dim = nodes.shape
    if dim < 3:
        nodes = np.concatenate([nodes, np.zeros((N, 3 - dim))], axis=1)
    E, nen = elems.shape
    ctype = _VTK_CELL_TYPES[elem_type]
    point_data = point_data or {}

    parts = ['<?xml version="1.0"?>\n',
             '<VTKFile type="UnstructuredGrid" version="0.1" '
             'byte_order="LittleEndian">\n  <UnstructuredGrid>\n',
             f'    <Piece NumberOfPoints="{N}" NumberOfCells="{E}">\n',
             '      <Points>\n        <DataArray type="Float32" '
             'NumberOfComponents="3" format="ascii">\n',
             _ascii(nodes.reshape(-1)),
             '\n        </DataArray>\n      </Points>\n',
             '      <Cells>\n        <DataArray type="Int64" '
             'Name="connectivity" format="ascii">\n',
             " ".join(str(v) for v in elems.reshape(-1)),
             '\n        </DataArray>\n        <DataArray type="Int64" '
             'Name="offsets" format="ascii">\n',
             " ".join(str(nen * (e + 1)) for e in range(E)),
             '\n        </DataArray>\n        <DataArray type="UInt8" '
             'Name="types" format="ascii">\n',
             " ".join(str(ctype) for _ in range(E)),
             '\n        </DataArray>\n      </Cells>\n']
    if point_data:
        parts.append('      <PointData>\n')
        for name, arr in point_data.items():
            a = np.asarray(arr, dtype=np.float64)
            if a.ndim == 1:
                ncomp = 1
                flat = a
            else:
                if a.shape[1] < 3:
                    a = np.concatenate(
                        [a, np.zeros((a.shape[0], 3 - a.shape[1]))],
                        axis=1)
                ncomp = a.shape[1]
                flat = a.reshape(-1)
            parts.append(f'        <DataArray type="Float32" '
                         f'Name="{name}" NumberOfComponents="{ncomp}" '
                         'format="ascii">\n')
            parts.append(_ascii(flat))
            parts.append('\n        </DataArray>\n')
        parts.append('      </PointData>\n')
    parts.append('    </Piece>\n  </UnstructuredGrid>\n</VTKFile>\n')
    with open(path, "w") as f:
        f.write("".join(parts))
    return path
