"""Two-level static mesh refinement: restriction, prolongation, coarse-fine
interpolation, and a subcycled composite advance with refluxing (port of
``ibamr_tpu/amr.py``).

The fine level is one dense tensor over a static index box (``FineBox``);
every transfer is a reshape or a gather with static shapes:

- restriction        = block-mean reshape (cell) / coincident-face mean (MAC);
- CF ghost fill      = separable quadratic (3-point Lagrange) gather from
                       the periodic coarse level at fine ghost centers;
- div-preserving MAC prolongation = flux-preserving linear interpolation
  followed by an exact per-coarse-cell Neumann correction, one
  (2^dim x 2^dim) pseudo-inverse applied to all cells with one matmul.

The interpolation geometry of a ghost shell depends only on the box, so
its gather indices and weights are computed once per (box, dtype, device)
and reused: a composite Poisson operator fills the same shell at every
Krylov iteration.
"""

from __future__ import annotations

import dataclasses
import functools
import itertools
from typing import Dict, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils

Vel = Tuple[torch.Tensor, ...]


# -- geometry ----------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FineBox:
    """A static refined region: coarse cells [lo, lo+shape) at ``ratio``x.

    The box must sit inside the periodic coarse domain with clearance
    (>= 2 cells by default) so coarse-fine stencils never wrap around the
    domain, the reference's proper nesting."""

    lo: Tuple[int, ...]        # coarse cell index of the box lower corner
    shape: Tuple[int, ...]     # box extent in coarse cells
    ratio: int = 2

    def __post_init__(self):
        object.__setattr__(self, "lo", tuple(int(v) for v in self.lo))
        object.__setattr__(self, "shape", tuple(int(v) for v in self.shape))
        if self.ratio != 2:
            raise ValueError("only refinement ratio 2 is implemented")
        if not all(s >= 1 for s in self.shape):
            raise ValueError(f"empty fine box shape {self.shape}")

    @property
    def dim(self) -> int:
        return len(self.lo)

    @property
    def hi(self) -> Tuple[int, ...]:
        return tuple(l + s for l, s in zip(self.lo, self.shape))

    @property
    def fine_n(self) -> Tuple[int, ...]:
        return tuple(s * self.ratio for s in self.shape)

    def validate(self, grid: StaggeredGrid, clearance: int = 2) -> None:
        if self.dim != grid.dim:
            raise ValueError(f"{self.dim}D box on a {grid.dim}D grid")
        for d in range(grid.dim):
            if not (clearance <= self.lo[d]
                    and self.hi[d] <= grid.n[d] - clearance):
                raise ValueError(
                    f"fine box too close to domain edge on axis {d}")

    def fine_grid(self, grid: StaggeredGrid) -> StaggeredGrid:
        """Geometry of the refined region as its own (non-periodic) grid."""
        dx = grid.dx
        x_lo = tuple(grid.x_lo[d] + self.lo[d] * dx[d]
                     for d in range(grid.dim))
        x_up = tuple(grid.x_lo[d] + self.hi[d] * dx[d]
                     for d in range(grid.dim))
        return StaggeredGrid(n=self.fine_n, x_lo=x_lo, x_up=x_up)


def box_slices(lo: Sequence[int], shape: Sequence[int],
               extra_axis: Optional[int] = None) -> Tuple[slice, ...]:
    """Slices of the coarse cells [lo, lo+shape) (one more plane along
    ``extra_axis``: the faces of a MAC component)."""
    return tuple(slice(l, l + s + (1 if a == extra_axis else 0))
                 for a, (l, s) in enumerate(zip(lo, shape)))


# -- restriction (fine -> coarse) --------------------------------------------

def restrict_cc(fine: torch.Tensor, ratio: int = 2) -> torch.Tensor:
    """Conservative block-mean coarsening of cell data."""
    shape = []
    for d in range(fine.ndim):
        if fine.shape[d] % ratio:
            raise ValueError(f"fine extent {fine.shape[d]} not a multiple "
                             f"of the ratio {ratio}")
        shape += [fine.shape[d] // ratio, ratio]
    arr = fine.reshape(shape)
    for d in reversed(range(fine.ndim)):
        arr = arr.mean(dim=2 * d + 1)
    return arr


def box_mac_to_cc(uf) -> Vel:
    """Each box MAC component (complete faces: shape n + e_d) to cell
    centers, the box-layout twin of ``stencils.fc_to_cc``."""
    return tuple(0.5 * (stencils.axis_slice(c, d, 0, c.shape[d] - 1)
                        + stencils.axis_slice(c, d, 1, c.shape[d]))
                 for d, c in enumerate(uf))


def restrict_mac(u_fine: Sequence[torch.Tensor], ratio: int = 2) -> Vel:
    """Coarsen box MAC data (component d has shape fine_n + e_d): coarse
    face value = mean of the 2^(dim-1) coincident fine faces (even normal
    index). Preserves fluxes through coarse faces exactly."""
    out = []
    for d, uf in enumerate(u_fine):
        dim = uf.ndim
        sl = [slice(None)] * dim
        sl[d] = slice(0, None, ratio)
        arr = uf[tuple(sl)]
        shape, axes, k = [], [], 0
        for a in range(dim):
            if a == d:
                shape.append(arr.shape[a])
                k += 1
            else:
                shape += [arr.shape[a] // ratio, ratio]
                axes.append(k + 1)
                k += 2
        out.append(arr.reshape(shape).mean(dim=tuple(axes)))
    return tuple(out)


# -- separable Lagrange interpolation from the periodic coarse level ----------

def _interp_plan(shape: Sequence[int], pts: torch.Tensor, order: int = 2):
    """Gather indices into the flattened periodic grid of ``shape`` and
    their tensor-product weights at continuous index coordinates ``pts``
    (..., dim) -> ``(lin, wgt)``, each (npts, s^dim)."""
    dim = len(shape)
    flat_pts = pts.reshape(-1, dim)
    npts = flat_pts.shape[0]
    dev = pts.device
    if order == 2:
        offs = torch.arange(-1, 2, device=dev)

        def weights(t):
            # t in [-0.5, 0.5]: Lagrange through nodes {-1, 0, +1}
            return torch.stack([0.5 * t * (t - 1.0),
                                (1.0 - t) * (1.0 + t),
                                0.5 * t * (t + 1.0)], dim=-1)

        def base(x):
            # round half to even, as the reference's jnp.round
            return torch.round(x).to(torch.int64)
    elif order == 1:
        offs = torch.arange(0, 2, device=dev)

        def weights(t):
            return torch.stack([1.0 - t, t], dim=-1)

        def base(x):
            return torch.floor(x).to(torch.int64)
    else:
        raise ValueError(f"unsupported order {order}")

    lin = wgt = None
    s = offs.shape[0]
    for d in range(dim):
        x = flat_pts[:, d]
        b = base(x)
        t = x - b.to(x.dtype)
        idx = torch.remainder(b[:, None] + offs[None, :], shape[d])
        w = weights(t)
        if lin is None:
            lin, wgt = idx, w
        else:
            lin = lin[..., :, None] * shape[d] + idx.reshape(
                (npts,) + (1,) * (lin.ndim - 1) + (s,))
            wgt = wgt[..., :, None] * w.reshape(
                (npts,) + (1,) * (wgt.ndim - 1) + (s,))
    return lin.reshape(npts, -1), wgt.reshape(npts, -1)


def _apply_plan(field: torch.Tensor, lin: torch.Tensor, wgt: torch.Tensor,
                out_shape) -> torch.Tensor:
    vals = field.reshape(-1)[lin]
    return torch.sum(vals * wgt, dim=-1).reshape(out_shape)


def interp_periodic(field: torch.Tensor, pts: torch.Tensor,
                    order: int = 2) -> torch.Tensor:
    """Interpolate a periodic grid tensor at continuous index coordinates.

    ``pts`` is (..., dim) in units where grid point ``i`` sits at index
    coordinate ``i`` (callers fold in the 0.5 cell-center offset).
    ``order`` = 1 (2-point linear) or 2 (3-point quadratic, the CF
    interpolation order of the reference)."""
    lin, wgt = _interp_plan(field.shape, pts, order)
    return _apply_plan(field, lin, wgt, pts.shape[:-1])


def _fine_to_coarse_coord(box: FineBox, axis: int, i):
    """Coarse cell-center index coordinate of fine cell ``i`` (may be a
    ghost index < 0 or >= fine_n): lo + (i + 0.5)/r - 0.5."""
    return box.lo[axis] + (i + 0.5) / box.ratio - 0.5


def _fine_cell_index_coords(box: FineBox, ghost: int, dtype,
                            device) -> torch.Tensor:
    """Continuous coarse cell-center index coordinates of fine cell
    centers (including ``ghost`` fine ghost layers), shape (*nf+2g, dim)."""
    axes = [_fine_to_coarse_coord(
        box, d, torch.arange(-ghost, box.fine_n[d] + ghost, dtype=dtype,
                             device=device))
        for d in range(box.dim)]
    return torch.stack(torch.meshgrid(*axes, indexing="ij"), dim=-1)


def prolong_cc(coarse: torch.Tensor, box: FineBox, ghost: int = 0,
               order: int = 2) -> torch.Tensor:
    """Interpolate coarse cell data onto fine cell centers of ``box``
    (plus ``ghost`` fine ghost layers): initial fill / CF ghost fill."""
    pts = _fine_cell_index_coords(box, ghost, coarse.dtype, coarse.device)
    return interp_periodic(coarse, pts, order=order)


def onion_slabs(fine_n: Sequence[int], ghost: int):
    """Per axis d and side (lo, hi), the index ranges of the ghost slab in
    the padded array: axes before d keep the interior (the slabs of
    earlier axes carry the corners), axis d its ghost layers, later axes
    their full padded extent. Returns 2 dim lists of (start, stop)."""
    dim, g = len(fine_n), ghost
    out = []
    for d in range(dim):
        for side in (0, 1):
            rng = []
            for a in range(dim):
                if a < d:
                    rng.append((g, g + fine_n[a]))
                elif a == d:
                    rng.append((0, g) if side == 0
                               else (fine_n[a] + g, fine_n[a] + 2 * g))
                else:
                    rng.append((0, fine_n[a] + 2 * g))
            out.append(rng)
    return out


@functools.lru_cache(maxsize=32)
def _ghost_slab_points(box: FineBox, ghost: int, dtype_name: str):
    """Static ghost-shell geometry: per onion slab, the coarse index
    coordinates of its points (host numpy, so the cache holds no device
    memory)."""
    dtype = np.dtype(dtype_name)
    slabs = []
    for rng in onion_slabs(box.fine_n, ghost):
        axes = [np.asarray(_fine_to_coarse_coord(
            box, a, np.arange(lo_i - ghost, hi_i - ghost, dtype=dtype)))
            for a, (lo_i, hi_i) in enumerate(rng)]
        slabs.append(np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1))
    return tuple(slabs)


_PLAN_CACHE: Dict[tuple, tuple] = {}


def cached_plans(key: tuple, build):
    """``build()`` (a tuple of device tensors) cached under ``key``; not
    cached while a CUDA graph is being captured."""
    hit = _PLAN_CACHE.get(key)
    if hit is not None:
        return hit
    plans = build()
    if not (torch.cuda.is_available()
            and torch.cuda.is_current_stream_capturing()):
        if len(_PLAN_CACHE) > 256:
            _PLAN_CACHE.clear()
        _PLAN_CACHE[key] = plans
    return plans


def _np_dtype_name(dtype: torch.dtype) -> str:
    return str(dtype).replace("torch.", "")


def _ghost_plans(box: FineBox, ghost: int, coarse_shape, dtype, device):
    def build():
        out = []
        for pts in _ghost_slab_points(box, ghost, _np_dtype_name(dtype)):
            p = torch.as_tensor(pts, device=device)
            lin, wgt = _interp_plan(coarse_shape, p, order=2)
            out.append((lin, wgt, tuple(pts.shape[:-1])))
        return tuple(out)

    return cached_plans(("ghost", box, ghost, tuple(coarse_shape), dtype,
                         str(device)), build)


def fill_fine_ghosts(fine: torch.Tensor, coarse: torch.Tensor, box: FineBox,
                     ghost: int) -> torch.Tensor:
    """Pad the fine interior with ``ghost`` layers interpolated from the
    coarse level (quadratic), keeping interior values exact. Assembly is
    concatenation in reverse-axis onion order; only the ghost shell is
    interpolated."""
    out = fine
    plans = _ghost_plans(box, ghost, coarse.shape, coarse.dtype,
                         coarse.device)
    for d in reversed(range(box.dim)):
        lo = _apply_plan(coarse, *plans[2 * d])
        hi = _apply_plan(coarse, *plans[2 * d + 1])
        out = torch.cat([lo, out, hi], dim=d)
    return out


# -- divergence-preserving MAC prolongation ----------------------------------

def _neumann_block_pinv(dim: int, dx_f: Sequence[float]) -> np.ndarray:
    """Pseudo-inverse of the 2^dim-subcell Neumann Laplacian of one coarse
    cell (zero flux through the coarse cell boundary). Host-precomputed."""
    n = 2 ** dim
    A = np.zeros((n, n))
    cells = list(itertools.product(*[range(2)] * dim))
    index = {c: i for i, c in enumerate(cells)}
    for c in cells:
        i = index[c]
        for d in range(dim):
            for s in (-1, 1):
                nb = list(c)
                nb[d] += s
                if 0 <= nb[d] < 2:
                    j = index[tuple(nb)]
                    w = 1.0 / (dx_f[d] ** 2)
                    A[i, i] -= w
                    A[i, j] += w
    return np.linalg.pinv(A)


def box_mac_divergence(u: Sequence[torch.Tensor],
                       dx: Sequence[float]) -> torch.Tensor:
    """Divergence on a box MAC layout (component d has +1 extent on d)."""
    out = None
    for d, c in enumerate(u):
        term = (stencils.axis_slice(c, d, 1, c.shape[d])
                - stencils.axis_slice(c, d, 0, c.shape[d] - 1)) / dx[d]
        out = term if out is None else out + term
    return out


def prolong_mac_div_preserving(u_coarse: Sequence[torch.Tensor],
                               grid: StaggeredGrid,
                               box: FineBox) -> Vel:
    """Prolong a periodic coarse MAC field onto ``box`` so that each fine
    cell's divergence equals its parent coarse cell's (discretely
    div-free stays div-free). Returns box MAC tensors (component d has
    shape fine_n + e_d): flux-preserving linear interpolation, then an
    exact local Neumann Poisson correction per coarse cell."""
    dim = grid.dim
    r = box.ratio
    dx = grid.dx
    dx_f = tuple(h / r for h in dx)
    nb = box.shape
    dtype = u_coarse[0].dtype

    # step A: componentwise interpolation
    u_fine = []
    for d in range(dim):
        arr = u_coarse[d]
        for a in range(dim):
            if a == d:
                continue
            # central-slope reconstruction at offsets -/+ 1/4: the pair
            # averages to the coarse value exactly (flux preserving)
            slope = 0.5 * (torch.roll(arr, -1, a) - torch.roll(arr, 1, a))
            lo_v = arr - 0.25 * slope
            hi_v = arr + 0.25 * slope
            arr = torch.stack([lo_v, hi_v], dim=arr.ndim)
        # the box with one extra coarse face plane along d (clearance
        # keeps hi + 1 <= n without wrapping)
        arr = arr[box_slices(box.lo, box.shape, extra_axis=d)]
        perm = []
        trans_axes = [a for a in range(dim) if a != d]
        for a in range(dim):
            perm.append(a)
            if a != d:
                perm.append(dim + trans_axes.index(a))
        arr = arr.permute(perm)
        new_shape = tuple(nb[a] * r if a != d else nb[a] + 1
                          for a in range(dim))
        planes = arr.reshape(new_shape)   # nb[d]+1 coarse face planes
        mid = 0.5 * (stencils.axis_slice(planes, d, 0, nb[d])
                     + stencils.axis_slice(planes, d, 1, nb[d] + 1))
        shape_f = list(planes.shape)
        shape_f[d] = nb[d] * r + 1
        out = torch.zeros(shape_f, dtype=dtype, device=planes.device)
        ev = [slice(None)] * dim
        od = [slice(None)] * dim
        ev[d] = slice(0, None, 2)
        od[d] = slice(1, None, 2)
        out[tuple(ev)] = planes
        out[tuple(od)] = mid
        u_fine.append(out)

    # step B: exact local Neumann correction
    div_c = stencils.divergence(u_coarse, dx)
    target = div_c[box_slices(box.lo, box.shape)]
    d0 = box_mac_divergence(u_fine, dx_f)
    blk = d0.reshape([v for a in range(dim) for v in (nb[a], r)])
    perm = [2 * a for a in range(dim)] + [2 * a + 1 for a in range(dim)]
    blk = blk.permute(perm).reshape(int(np.prod(nb)), r ** dim)
    defect = target.reshape(-1, 1) - blk

    pinv = torch.as_tensor(_neumann_block_pinv(dim, dx_f), dtype=dtype,
                           device=defect.device)
    phi = defect @ pinv.T
    phi = phi.reshape([nb[a] for a in range(dim)] + [r] * dim)
    phi = phi.permute(tuple(np.argsort(perm))).reshape(box.fine_n)

    # add grad(phi) on block-interior faces (odd face index along d)
    out = []
    for d in range(dim):
        uf = u_fine[d].clone()
        lo_p = [slice(None)] * dim
        hi_p = [slice(None)] * dim
        lo_p[d] = slice(0, None, 2)
        hi_p[d] = slice(1, None, 2)
        g = (phi[tuple(hi_p)] - phi[tuple(lo_p)]) / dx_f[d]
        od = [slice(None)] * dim
        od[d] = slice(1, None, 2)
        uf[tuple(od)] += g
        out.append(uf)
    return tuple(out)


# -- two-level subcycled advection-diffusion advance with refluxing -----------

class TwoLevelAdvDiff:
    """Composite two-level advance of dQ/dt + div(uQ) = kappa lap(Q) on
    one static fine box: a facade over the moving-window core
    (:class:`ibamr_tpu_torch.amr_dynamic.DynamicTwoLevelAdvDiff`) with the
    window origin pinned to ``box.lo``. ``u_coarse`` (periodic layout)
    and ``u_fine`` (box MAC layout) are fixed velocity tensors on
    ``device``."""

    def __init__(self, grid: StaggeredGrid, box: FineBox,
                 kappa: float = 0.0, scheme: str = "centered",
                 u_coarse: Optional[Vel] = None,
                 u_fine: Optional[Vel] = None, device="cuda"):
        from ibamr_tpu_torch.amr_dynamic import DynamicTwoLevelAdvDiff

        box.validate(grid)
        self.grid = grid
        self.box = box
        self.kappa = float(kappa)
        self.scheme = scheme
        self.fine = box.fine_grid(grid)
        self.dx_f = tuple(h / box.ratio for h in grid.dx)
        self._core = DynamicTwoLevelAdvDiff(
            grid, box.shape, kappa=kappa, scheme=scheme,
            u_c=u_coarse, u_f=u_fine, ratio=box.ratio, clearance=1,
            device=device)
        self.device = self._core.device

    def _state(self, Qc, Qf):
        from ibamr_tpu_torch.amr_dynamic import AMRState

        return AMRState(Qc=Qc, Qf=Qf, lo=torch.tensor(
            self.box.lo, dtype=torch.int32, device=Qc.device))

    def step(self, Qc: torch.Tensor, Qf: torch.Tensor,
             dt: float) -> Tuple[torch.Tensor, torch.Tensor]:
        out = self._core.step_at(self._state(Qc, Qf), dt, self.box.lo)
        return out.Qc, out.Qf

    def total(self, Qc: torch.Tensor, Qf: torch.Tensor) -> torch.Tensor:
        """Composite conserved integral: uncovered coarse + fine."""
        return self._core.total_at(Qc, Qf, self.box.lo)

    def initialize(self, fn, dtype=torch.float64):
        """Evaluate ``fn(coords_tuple) -> tensor`` on both levels."""
        dev = self.device
        Qc = torch.as_tensor(fn(self.grid.cell_centers(dtype, dev)),
                             dtype=dtype, device=dev)
        Qf = torch.as_tensor(fn(self.fine.cell_centers(dtype, dev)),
                             dtype=dtype, device=dev)
        return (Qc.expand(self.grid.n).clone(),
                Qf.expand(self.fine.n).clone())
