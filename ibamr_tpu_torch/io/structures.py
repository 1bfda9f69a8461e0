"""Readers and writers of the reference's structure files, and the host-side
structure data they fill (port of ``ibamr_tpu/io/structures.py``):

  name.vertex: line 1 = N;  then N lines  "x y [z]"
  name.spring: line 1 = M;  then M lines  "idx0 idx1 stiffness rest_length
                                           [force_fcn_idx]"
  name.beam:   line 1 = M;  then M lines  "prev mid next bend_rigidity
                                           [curvature components]"
  name.target: line 1 = M;  then M lines  "idx stiffness [damping]"
  name.rod:    line 1 = M;  then M lines  "curr next ds a1 a2 a3 b1 b2 b3
                                           kappa1 kappa2 tau"
  name.anchor: line 1 = M;  then M lines  "idx"
  name.mass:   line 1 = M;  then M lines  "idx mass [stiffness]"
  name.source: line 1 = M;  then M lines  "idx strength"
  name.inst:   line 1 = M;  then M lines  "idx meter_idx node_idx"

Indices are 0-based within the structure. Parsing is host-side: the
C++ tokenizer of ``io/native.py`` when ``g++`` is present, else the
reference's Python parser, with the same result and the same strict
rejections. ``StructureData.force_specs`` turns springs, beams and
targets into device force specs, ``StructureData.source_specs`` the
source table into point sources; anchors become targets through
``anchors_to_targets``. The rod, mass and instrument tables are read and
written; their converters wait for the modules they feed.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import Optional

import numpy as np
import torch

from ibamr_tpu_torch.ops import forces
from ibamr_tpu_torch.ops import sources as source_mod


def _read_table(path: str, min_cols: int, max_cols: int,
                what: str) -> np.ndarray:
    """The count line, then ``count`` rows of ``min_cols..max_cols``
    numbers (``#`` starts a comment), as a zero-padded float64 array:
    the native parser when it is available, else the NumPy one."""
    native = _read_table_native(path, min_cols, max_cols, what)
    if native is not None:
        return native
    with open(path) as f:
        tokens = f.read().split("\n")
    lines = [ln.split("#")[0].strip() for ln in tokens]
    lines = [ln for ln in lines if ln]
    if not lines:
        raise ValueError(f"{path}: empty {what} file")
    try:
        count = int(lines[0].split()[0])
    except ValueError:
        raise ValueError(f"{path}: first line must be the {what} count")
    rows = []
    for ln in lines[1:count + 1]:
        cols = ln.split()
        if not (min_cols <= len(cols) <= max_cols):
            raise ValueError(
                f"{path}: expected {min_cols}..{max_cols} columns, got "
                f"{len(cols)}: {ln!r}")
        rows.append([float(c) for c in cols])
    if len(rows) != count:
        raise ValueError(
            f"{path}: declared {count} {what} entries, found {len(rows)}")
    width = max(len(r) for r in rows)
    out = np.zeros((count, width))
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


def _read_table_native(path: str, min_cols: int, max_cols: int,
                       what: str) -> Optional[np.ndarray]:
    """C++ fast path (``io/native.py``): same contract as the Python parser;
    None when the native library is unavailable."""
    from ibamr_tpu_torch.io.native import parse_table_native

    with open(path, "rb") as f:
        text = f.read()
    try:
        parsed = parse_table_native(text, max_cols)
    except ValueError as e:
        raise ValueError(f"{path}: {e}")
    if parsed is None:
        return None
    rows, ncols = parsed
    if rows.shape[0] == 0:
        raise ValueError(f"{path}: empty {what} file")
    count_f = rows[0, 0]
    if not np.isfinite(count_f) or count_f != int(count_f) \
            or count_f < 0:
        raise ValueError(f"{path}: first line must be the {what} count")
    count = int(count_f)
    if rows.shape[0] - 1 < count:
        raise ValueError(
            f"{path}: declared {count} {what} entries, found "
            f"{rows.shape[0] - 1}")
    body = rows[1:count + 1]
    nc = ncols[1:count + 1]
    if count and not ((nc >= min_cols) & (nc <= max_cols)).all():
        bad = int(np.argmax((nc < min_cols) | (nc > max_cols)))
        raise ValueError(
            f"{path}: expected {min_cols}..{max_cols} columns, got "
            f"{int(nc[bad])} on entry {bad}")
    width = int(nc.max()) if count else min_cols
    out = body[:, :width].copy()
    # zero ONLY the pad slots (columns beyond each row's true count) —
    # a genuine 'nan' data value must survive, as in the Python parser
    if count:
        pad = np.arange(width)[None, :] >= nc[:, None]
        out[pad] = 0.0
    return out


@dataclass
class StructureData:
    """One structure's host-side data."""
    name: str
    vertices: np.ndarray                   # (N, dim)
    springs: Optional[np.ndarray] = None   # (M, >=4): idx0 idx1 k L0 [fcn]
    beams: Optional[np.ndarray] = None     # (M, >=4): prev mid next c [C0...]
    targets: Optional[np.ndarray] = None   # (M, >=2): idx kappa [damping]
    rods: Optional[np.ndarray] = None      # (M, 12): curr next + 10 params
    anchors: Optional[np.ndarray] = None   # (M, 1): idx
    masses: Optional[np.ndarray] = None    # (M, >=2): idx mass [stiffness]
    sources: Optional[np.ndarray] = None   # (M, 2): idx strength
    inst: Optional[np.ndarray] = None      # (M, 3): idx meter node
    index_offset: int = 0                  # global offset when concatenating

    @property
    def num_markers(self) -> int:
        return self.vertices.shape[0]

    @property
    def dim(self) -> int:
        return self.vertices.shape[1]

    def force_specs(self, dtype=torch.float32,
                    device="cuda") -> forces.ForceSpecs:
        """Device force specs (springs, beams, targets) with indices
        shifted by ``index_offset``, and their gather table over the
        markers up to this structure's last."""
        off = self.index_offset
        kw = dict(dtype=dtype, device=device)
        springs = beams = targets = None
        if self.springs is not None and len(self.springs):
            s = self.springs
            springs = forces.make_springs(
                s[:, 0].astype(np.int64) + off,
                s[:, 1].astype(np.int64) + off, s[:, 2], s[:, 3], **kw)
        if self.beams is not None and len(self.beams):
            b = self.beams
            curv = b[:, 4:4 + self.dim] if b.shape[1] >= 4 + self.dim \
                else None
            beams = forces.make_beams(
                b[:, 0].astype(np.int64) + off,
                b[:, 1].astype(np.int64) + off,
                b[:, 2].astype(np.int64) + off,
                b[:, 3], curv, dim=self.dim, **kw)
        if self.targets is not None and len(self.targets):
            t = self.targets
            idx = t[:, 0].astype(np.int64)
            damping = t[:, 2] if t.shape[1] > 2 else None
            targets = forces.make_targets(idx + off, t[:, 1],
                                          self.vertices[idx], damping, **kw)
        return forces.make_force_specs(springs, beams, targets,
                                       num_markers=off + self.num_markers)

    def source_specs(self, dtype=torch.float32, device="cuda"):
        """Device source specs from the .source table, indices shifted by
        ``index_offset`` (None without sources)."""
        if self.sources is None or not len(self.sources):
            return None
        s = self.sources
        return source_mod.make_sources(
            s[:, 0].astype(np.int64) + self.index_offset, s[:, 1],
            dtype=dtype, device=device)

    def rod_specs(self, dtype=torch.float32, device="cuda"):
        """Device rod specs from the .rod table, indices shifted by
        ``index_offset`` (None without rods)."""
        from ibamr_tpu_torch.ops import rods as rods_mod

        if self.rods is None or not len(self.rods):
            return None
        r = self.rods
        off = self.index_offset
        return rods_mod.make_rods(
            r[:, 0].astype(np.int64) + off, r[:, 1].astype(np.int64) + off,
            b=r[:, 3:6], s=r[:, 6:9], kappa=r[:, 9:12], ds=r[:, 2],
            dtype=dtype, device=device)

    def meter_specs(self, closed=True, dtype=torch.float32, device="cuda"):
        """Instrument meters from the .inst table: rows grouped by meter
        index, nodes ordered by node index within a meter (None without
        meters)."""
        from ibamr_tpu_torch import instruments

        if self.inst is None or not len(self.inst):
            return None
        tbl = self.inst
        loops = []
        for m in sorted(set(int(v) for v in tbl[:, 1])):
            rows = tbl[tbl[:, 1] == m]
            order = np.argsort(rows[:, 2])
            loops.append([int(v) + self.index_offset
                          for v in rows[order, 0]])
        return instruments.make_meters(loops, closed=closed, dtype=dtype,
                                       device=device)

    def mass_arrays(self, dtype=np.float64):
        """Host (mass (N,), penalty stiffness (N,)) arrays for the
        penalty-IB integrator from the .mass table (None without
        masses)."""
        if self.masses is None or not len(self.masses):
            return None
        N = self.num_markers
        mass = np.zeros(N, dtype=dtype)
        kappa = np.zeros(N, dtype=dtype)
        m = self.masses
        idx = m[:, 0].astype(np.int64)
        mass[idx] = m[:, 1]
        kappa[idx] = m[:, 2] if m.shape[1] > 2 else 0.0
        return mass, kappa

    def anchors_to_targets(self, stiffness: float) -> None:
        """Realize anchored nodes (.anchor) as stiff target points at
        their initial positions, appended to the .target table. The
        anchors are consumed, so a second call adds nothing."""
        if self.anchors is None or not len(self.anchors):
            return
        rows = np.zeros((len(self.anchors), 2))
        rows[:, 0] = self.anchors[:, 0]
        rows[:, 1] = float(stiffness)
        self.anchors = None
        if self.targets is None:
            self.targets = rows
        else:
            w = max(self.targets.shape[1], 2)
            old = np.zeros((len(self.targets), w))
            old[:, :self.targets.shape[1]] = self.targets
            new = np.zeros((len(rows), w))
            new[:, :2] = rows
            self.targets = np.concatenate([old, new])


# (attribute, file extension, min columns, max columns or None for
# 4 + dim, vertex-index columns) of every table besides .vertex
_TABLES = (("springs", "spring", 4, 5, (0, 1)),
           ("beams", "beam", 4, None, (0, 1, 2)),
           ("targets", "target", 2, 3, (0,)),
           ("rods", "rod", 12, 12, (0, 1)),
           ("anchors", "anchor", 1, 1, (0,)),
           ("masses", "mass", 2, 3, (0,)),
           ("sources", "source", 2, 2, (0,)),
           ("inst", "inst", 3, 3, (0,)))


def read_structure(basename: str, dim: Optional[int] = None) -> StructureData:
    """Read ``basename.vertex`` and whichever of the other tables exist;
    every vertex index is checked against the vertex count."""
    vpath = basename + ".vertex"
    if not os.path.exists(vpath):
        raise FileNotFoundError(vpath)
    verts = _read_table(vpath, 2, 3, "vertex")
    if dim is not None:
        verts = verts[:, :dim]
    data = StructureData(name=os.path.basename(basename), vertices=verts)
    n, d = verts.shape
    for attr, ext, lo, hi, cols in _TABLES:
        path = f"{basename}.{ext}"
        if not os.path.exists(path):
            continue
        tbl = _read_table(path, lo, 4 + d if hi is None else hi, ext)
        setattr(data, attr, tbl)
        for c in cols:
            bad = (tbl[:, c] < 0) | (tbl[:, c] >= n)
            if bad.any():
                raise ValueError(
                    f"{basename}.{ext}: vertex index out of range "
                    f"(N={n}) on entry {int(np.argmax(bad))}")
    return data


def _fmt(nint: int):
    """Row formatter: the first ``nint`` columns as ints, the rest as
    round-trip floats."""
    def fmt(row):
        return " ".join([f"{int(v)}" for v in row[:nint]]
                        + [f"{v:.17g}" for v in row[nint:]])
    return fmt


_WRITE_INT_COLS = {"vertices": 0, "springs": 2, "beams": 3, "targets": 1,
                   "rods": 2, "anchors": 1, "masses": 1, "sources": 1,
                   "inst": 3}


def write_structure(basename: str, data: StructureData) -> None:
    """Write the structure back out in the reference formats."""
    exts = {"vertices": "vertex", **{a: e for a, e, *_ in _TABLES}}
    for attr, nint in _WRITE_INT_COLS.items():
        arr = getattr(data, attr)
        if arr is None:
            continue
        fmt = _fmt(nint)
        with open(f"{basename}.{exts[attr]}", "w") as f:
            f.write(f"{arr.shape[0]}\n")
            for row in arr:
                f.write(fmt(row) + "\n")
