"""Staggered (MAC) Cartesian grid geometry (port of ``ibamr_tpu/grid.py``).

Geometry is static metadata; field data are plain tensors carried in the
state. Conventions as in the reference: ``n`` cells per axis, cell ``i``
centered at ``x_lo + (i + 1/2) dx``, and MAC component ``d`` stored on
the lower ``d``-face of each cell, so every component has shape ``n``
under periodicity.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Tuple

import torch


@dataclasses.dataclass(frozen=True)
class StaggeredGrid:
    """Static MAC-grid geometry for a single uniform level."""

    n: Tuple[int, ...]
    x_lo: Tuple[float, ...]
    x_up: Tuple[float, ...]

    def __post_init__(self):
        if not len(self.n) == len(self.x_lo) == len(self.x_up):
            raise ValueError("n, x_lo and x_up need one entry per axis")
        if not all(nd >= 2 for nd in self.n):
            raise ValueError("need >= 2 cells per dim")
        object.__setattr__(self, "n", tuple(int(v) for v in self.n))
        object.__setattr__(self, "x_lo", tuple(float(v) for v in self.x_lo))
        object.__setattr__(self, "x_up", tuple(float(v) for v in self.x_up))

    @property
    def dim(self) -> int:
        return len(self.n)

    @property
    def dx(self) -> Tuple[float, ...]:
        return tuple((hi - lo) / nd
                     for lo, hi, nd in zip(self.x_lo, self.x_up, self.n))

    @property
    def lengths(self) -> Tuple[float, ...]:
        return tuple(hi - lo for lo, hi in zip(self.x_lo, self.x_up))

    @property
    def cell_volume(self) -> float:
        return math.prod(self.dx)

    @property
    def num_cells(self) -> int:
        return math.prod(self.n)

    def cell_coords_1d(self, axis: int, dtype, device) -> torch.Tensor:
        """Cell-center coordinates along one axis, shape (n[axis],)."""
        d = self.dx[axis]
        return self.x_lo[axis] + (torch.arange(
            self.n[axis], dtype=dtype, device=device) + 0.5) * d

    def face_coords_1d(self, axis: int, dtype, device) -> torch.Tensor:
        """Lower-face coordinates along one axis, shape (n[axis],)."""
        d = self.dx[axis]
        return self.x_lo[axis] + torch.arange(
            self.n[axis], dtype=dtype, device=device) * d

    def _bcast(self, coords_1d: torch.Tensor, axis: int) -> torch.Tensor:
        shape = [1] * self.dim
        shape[axis] = self.n[axis]
        return coords_1d.reshape(shape)

    def cell_centers(self, dtype, device) -> Tuple[torch.Tensor, ...]:
        """Broadcastable cell-center coordinate tensors, one per axis."""
        return tuple(self._bcast(self.cell_coords_1d(a, dtype, device), a)
                     for a in range(self.dim))

    def face_centers(self, comp: int, dtype, device) -> Tuple[torch.Tensor, ...]:
        """Broadcastable coordinates of velocity-component ``comp`` faces:
        face coordinate along axis ``comp``, cell-center along the others."""
        return tuple(
            self._bcast(self.face_coords_1d(a, dtype, device) if a == comp
                        else self.cell_coords_1d(a, dtype, device), a)
            for a in range(self.dim))

    def position_to_index(self, x: torch.Tensor) -> torch.Tensor:
        """Continuous cell index of physical position(s) x (..., dim):
        cell i contains [i, i+1) in these units."""
        lo = torch.as_tensor(self.x_lo, dtype=x.dtype, device=x.device)
        dx = torch.as_tensor(self.dx, dtype=x.dtype, device=x.device)
        return (x - lo) / dx
