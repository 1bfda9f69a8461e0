"""Dynamic AMR: tagging, box fitting and regrid of one moving fine window
(port of ``ibamr_tpu/amr_dynamic.py``).

The fine level is a fixed-shape dense window whose origin ``lo`` moves:
tagging gives a boolean coarse-cell tensor (gradient, value or marker
criteria), box fitting reduces the tags to a clipped window origin (the
single-box Berger-Rigoutsos role), and the regrid synchronizes the coarse
level under the old window by conservative restriction, fills the new
window by conservative-linear prolongation, and copies surviving fine
data across the overlap. Every transfer conserves the composite integral
to roundoff.

The reference keeps ``lo`` traced inside one compiled scan and reads its
windows with clamping dynamic slices. Here ``lo`` is read to the host
once per regrid (``AMRState.lo`` stays an int32 tensor), the windows are
plain slices, and a window that would need the clamping raises instead.
The box fit runs on the host in float32, as the reference computes it
whatever its precision setting, so the origins are the same on the GPU
and the CPU.
"""

from __future__ import annotations

import ctypes
import ctypes.util
import functools
from typing import Callable, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.amr import (_apply_plan, _interp_plan, _np_dtype_name,
                                 box_slices, cached_plans, onion_slabs,
                                 restrict_cc)
from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.ops.convection import advective_face_value

Vel = Tuple[torch.Tensor, ...]
Origin = Tuple[int, ...]


# -- tagging -----------------------------------------------------------------

def tag_value(Q: torch.Tensor, threshold: float) -> torch.Tensor:
    """Tag cells where |Q| exceeds ``threshold``."""
    return torch.abs(Q) > threshold


def tag_gradient(Q: torch.Tensor, grid: StaggeredGrid,
                 threshold: float) -> torch.Tensor:
    """Tag cells with a large undivided gradient."""
    mag = torch.zeros_like(Q)
    for d in range(Q.ndim):
        mag = mag + torch.abs(torch.roll(Q, -1, d) - torch.roll(Q, 1, d))
    return mag > threshold


def tag_markers(X: torch.Tensor, grid: StaggeredGrid,
                mask: Optional[torch.Tensor] = None,
                buffer: int = 1) -> torch.Tensor:
    """Tag cells containing Lagrangian markers, dilated by ``buffer``
    cells."""
    lin = None
    for d in range(grid.dim):
        i = torch.floor((X[:, d] - grid.x_lo[d]) / grid.dx[d]).to(
            torch.int64)
        i = torch.remainder(i, grid.n[d])
        lin = i if lin is None else lin * grid.n[d] + i
    w = (torch.ones(X.shape[0], dtype=torch.float32, device=X.device)
         if mask is None else mask)
    counts = torch.zeros(grid.num_cells, dtype=w.dtype, device=X.device)
    counts = counts.index_put((lin,), w, accumulate=True)
    tags = counts.reshape(grid.n) > 0
    for _ in range(buffer):
        grown = tags
        for d in range(grid.dim):
            grown = grown | torch.roll(tags, 1, d) | torch.roll(tags, -1, d)
        tags = grown
    return tags


@functools.lru_cache(maxsize=1)
def _libm():
    """The C library's float32 cosf, sinf and atan2f: the functions the
    reference's CPU backend (XLA) evaluates for float32 cos, sin and
    arctan2, value for value."""
    lib = ctypes.CDLL(ctypes.util.find_library("m"))
    for name, nargs in (("cosf", 1), ("sinf", 1), ("atan2f", 2)):
        fn = getattr(lib, name)
        fn.restype = ctypes.c_float
        fn.argtypes = [ctypes.c_float] * nargs
    return lib


def _xla_f32_sum(v: np.ndarray) -> np.float32:
    """Sum of a float32 vector in the order XLA's CPU backend reduces
    one: sequential up to 32 entries, else sequential partial sums of
    consecutive chunks (two halves up to 64 entries, 32 each beyond)
    added in order. Measured on XLA's CPU reductions up to 64 entries
    and at multiples of 32; other lengths past 64 are an approximation."""
    n = v.shape[0]
    if n <= 32:
        bounds = [0, n]
    elif n <= 64 and n % 32:
        bounds = [0, (n + 1) // 2, n]
    else:
        bounds = list(range(0, n, 32)) + [n]
    total = np.float32(0.0)
    for a, b in zip(bounds[:-1], bounds[1:]):
        part = np.float32(0.0)
        for x in v[a:b]:
            part = np.float32(part + x)
        total = np.float32(total + part)
    return total


def fit_box_origin_host(tags: torch.Tensor, box_shape: Sequence[int],
                        clearance: int = 2, compiled: bool = False) -> Origin:
    """:func:`fit_box_origin` as host ints (one device read of the
    per-axis tag lines), in the reference's float32 arithmetic on the
    CPU, so that a center within roundoff of a rounding tie rounds the
    same way: the C library's cosf/sinf/atan2f and XLA's summation order
    (:func:`_xla_f32_sum`). The reference divides by n and by 2 pi where
    it runs eagerly (its set-up); compiled inside its advance, XLA turns
    each division by a constant into a product with the float32
    reciprocal and folds the constants (theta = i * (2 pi * (1/n)), the
    angle times (1/(2 pi)) * n), and the product and the following + 1/2
    contract into one fused multiply-add. ``compiled`` picks the
    latter."""
    dim = tags.ndim
    lines = [torch.any(tags, dim=tuple(a for a in range(dim) if a != d))
             if dim > 1 else tags for d in range(dim)]
    lines = [ln.cpu().numpy() for ln in lines]
    lib = _libm()
    f32 = np.float32
    two_pi = f32(2.0 * np.pi)
    los = []
    for d, line in enumerate(lines):
        n = line.shape[0]
        i = np.arange(n, dtype=f32)
        th = i * (two_pi * (f32(1.0) / f32(n))) if compiled \
            else two_pi * i / f32(n)
        cs = _xla_f32_sum(np.array([lib.cosf(t) if on else 0.0
                                    for t, on in zip(th, line)], dtype=f32))
        sn = _xla_f32_sum(np.array([lib.sinf(t) if on else 0.0
                                    for t, on in zip(th, line)], dtype=f32))
        ang = f32(lib.atan2f(sn, cs))
        if compiled:
            # one fused multiply-add, rounded once (exact in float64)
            scale = (f32(1.0) / two_pi) * f32(n)
            center = f32(np.float64(ang) * np.float64(scale) + 0.5)
        else:
            center = ang / two_pi * f32(n) + f32(0.5)
        center = np.mod(center, f32(n))
        if not line.any():
            center = f32(n / 2.0)
        lo = int(np.round(center - f32(box_shape[d] / 2.0)))
        los.append(min(max(lo, clearance), n - box_shape[d] - clearance))
    return tuple(los)


def fit_box_origin(tags: torch.Tensor, box_shape: Sequence[int],
                   clearance: int = 2) -> torch.Tensor:
    """Window origin (coarse cells, (dim,) int32) centering the tagged
    region, clipped so the fixed-shape window keeps ``clearance`` cells
    from every domain edge; with no tags, the domain's center. The
    per-axis center is the circular mean of the tagged indices (a blob
    straddling the periodic boundary still centers), taken in float32
    and rounded half to even, as the reference takes it."""
    return torch.tensor(fit_box_origin_host(tags, box_shape, clearance),
                        dtype=torch.int32, device=tags.device)


def _origin(lo) -> Origin:
    """A window origin as host ints (one device read for a tensor)."""
    if isinstance(lo, torch.Tensor):
        return tuple(int(v) for v in lo.tolist())
    return tuple(int(v) for v in lo)


def _check_window(shape, start: Origin, size: Sequence[int],
                  what: str) -> None:
    """The reference's dynamic slices clamp a window that leaves the
    domain; the port raises instead."""
    for d, (s, w) in enumerate(zip(start, size)):
        if not (0 <= s and s + w <= shape[d]):
            raise ValueError(
                f"{what}: window [{s}, {s + w}) on axis {d} leaves the "
                f"domain of {shape[d]} cells (too little clearance)")


# -- transfer operators at a given origin ------------------------------------

def prolong_cc_conservative(coarse: torch.Tensor, lo,
                            box_shape: Sequence[int],
                            ratio: int = 2) -> torch.Tensor:
    """Conservative-linear prolongation of the window [lo, lo+shape) to
    fine cells: per-axis central slopes, subcell offsets -1/4, +1/4; each
    fine block averages exactly to its parent."""
    if ratio != 2:
        raise ValueError("only refinement ratio 2 is implemented")
    lo = _origin(lo)
    start = tuple(l - 1 for l in lo)
    size = tuple(s + 2 for s in box_shape)
    _check_window(coarse.shape, start, size, "prolong_cc_conservative")
    arr = coarse[box_slices(start, size)]
    for d in range(coarse.ndim):
        m = arr.shape[d]
        slope = 0.5 * (stencils.axis_slice(arr, d, 2, m)
                       - stencils.axis_slice(arr, d, 0, m - 2))
        c = stencils.axis_slice(arr, d, 1, m - 1)
        arr = torch.stack([c - 0.25 * slope, c + 0.25 * slope], dim=d + 1)
        arr = arr.reshape(arr.shape[:d] + (2 * c.shape[d],)
                          + arr.shape[d + 2:])
    return arr


def restrict_into_coarse(Qc: torch.Tensor, Qf: torch.Tensor, lo,
                         ratio: int = 2) -> torch.Tensor:
    """The block-mean restriction of the fine window written into (a copy
    of) the coarse tensor at origin ``lo``."""
    lo = _origin(lo)
    r = restrict_cc(Qf, ratio)
    _check_window(Qc.shape, lo, r.shape, "restrict_into_coarse")
    out = Qc.clone()
    out[box_slices(lo, r.shape)] = r
    return out


def copy_overlap(Qf_new: torch.Tensor, Qf_old: torch.Tensor, lo_new, lo_old,
                 ratio: int = 2) -> torch.Tensor:
    """Prolonged values replaced by surviving old fine data wherever the
    old and new windows overlap."""
    lo_new, lo_old = _origin(lo_new), _origin(lo_old)
    dim = Qf_new.ndim
    shift = [(o - n) * ratio for o, n in zip(lo_old, lo_new)]
    rolled = torch.roll(Qf_old, shifts=tuple(shift), dims=tuple(range(dim)))
    mask = torch.ones_like(Qf_new, dtype=torch.bool)
    for d in range(dim):
        nf = Qf_new.shape[d]
        i = torch.arange(nf, device=Qf_new.device)
        ok = (i >= shift[d]) & (i < nf + shift[d])
        shape = [1] * dim
        shape[d] = nf
        mask = mask & ok.reshape(shape)
    return torch.where(mask, rolled, Qf_new)


def regrid(Qc: torch.Tensor, Qf: torch.Tensor, lo_old, lo_new,
           ratio: int = 2) -> Tuple[torch.Tensor, torch.Tensor]:
    """Move the fine window: sync coarse under the old window, prolong
    the new window, keep surviving fine data on the overlap. Conserves
    the composite integral to roundoff."""
    Qc = restrict_into_coarse(Qc, Qf, lo_old, ratio)
    box_shape = tuple(s // ratio for s in Qf.shape)
    Qf_new = prolong_cc_conservative(Qc, lo_new, box_shape, ratio)
    return Qc, copy_overlap(Qf_new, Qf, lo_new, lo_old, ratio)


# -- ghost fill at a given origin --------------------------------------------

def _rel_ghost_points(fine_shape, ghost: int, ratio: int, dtype):
    """Origin-relative coarse index coordinates of the ghost-padded fine
    cell centers, per onion slab (host numpy)."""
    out = []
    for rng in onion_slabs(fine_shape, ghost):
        axes = [np.arange(lo_i - ghost, hi_i - ghost, dtype=dtype)
                for (lo_i, hi_i) in rng]
        axes = [(ax + 0.5) / ratio - 0.5 for ax in axes]
        out.append((tuple(slice(a, b) for a, b in rng),
                    np.stack(np.meshgrid(*axes, indexing="ij"), axis=-1)))
    return out


def fill_fine_ghosts_dyn(fine: torch.Tensor, coarse: torch.Tensor, lo,
                         ghost: int, ratio: int = 2) -> torch.Tensor:
    """Ghost-padded fine tensor with quadratic CF interpolation from the
    periodic coarse level at window origin ``lo``."""
    lo = _origin(lo)
    g = ghost
    nf = tuple(fine.shape)
    dt, dev = coarse.dtype, coarse.device

    def build():
        lo_f = torch.tensor(lo, dtype=dt, device=dev)
        plans = []
        for sl, pts in _rel_ghost_points(nf, g, ratio, _np_dtype_name(dt)):
            p = torch.as_tensor(pts, device=dev) + lo_f
            lin, wgt = _interp_plan(coarse.shape, p, order=2)
            plans.append((sl, lin, wgt, tuple(pts.shape[:-1])))
        return tuple(plans)

    plans = cached_plans(("dyn", nf, g, ratio, lo, tuple(coarse.shape), dt,
                          str(dev)), build)
    out = torch.zeros(tuple(n + 2 * g for n in nf), dtype=fine.dtype,
                      device=dev)
    out[tuple(slice(g, g + n) for n in nf)] = fine
    for sl, lin, wgt, shape in plans:
        out[sl] = _apply_plan(coarse, lin, wgt, shape)
    return out


# -- moving-window two-level advection-diffusion integrator -------------------

class AMRState(NamedTuple):
    Qc: torch.Tensor      # coarse level (periodic)
    Qf: torch.Tensor      # fine window (fixed shape)
    lo: torch.Tensor      # (dim,) int32 window origin in coarse cells


class DynamicTwoLevelAdvDiff:
    """Two-level advance of dQ/dt + div(uQ) = kappa lap(Q) whose fine
    window follows the solution: ``advance(state, dt, n,
    regrid_interval)`` runs the subcycled composite advance with a
    tag/fit/regrid every ``regrid_interval`` steps (the first before step
    0). ``u_fn(coords, d)`` gives the face-normal velocity at arbitrary
    coordinates (evaluated on the moving window each substep); or fixed
    per-level velocity tensors ``u_c`` (periodic layout) / ``u_f`` (box
    MAC layout), valid while the window stays put (the static case of
    :class:`ibamr_tpu_torch.amr.TwoLevelAdvDiff`)."""

    GHOST = 1   # flux stencils read exactly one ghost layer

    def __init__(self, grid: StaggeredGrid,
                 box_shape: Tuple[int, ...],
                 kappa: float = 0.0,
                 scheme: str = "centered",
                 u_fn: Optional[Callable] = None,
                 u_c: Optional[Vel] = None,
                 u_f: Optional[Vel] = None,
                 tag_threshold: float = 0.05,
                 ratio: int = 2,
                 clearance: int = 2,
                 dtype=torch.float32,
                 device="cuda"):
        if scheme not in ("centered", "upwind"):
            raise ValueError(f"unknown scheme {scheme!r}")
        if clearance < 1:
            raise ValueError("clearance >= 1 required (prolongation reads "
                             "a 1-cell halo)")
        if u_fn is not None and (u_c is not None or u_f is not None):
            raise ValueError("give u_fn or the velocity tensors, not both")
        self.grid = grid
        self.box_shape = tuple(int(s) for s in box_shape)
        self.kappa = float(kappa)
        self.scheme = scheme
        self.u_fn = u_fn
        self.u_c = u_c
        self.u_f = u_f
        self.tag_threshold = float(tag_threshold)
        self.ratio = ratio
        self.clearance = clearance
        self.dtype = dtype
        self.device = resolve_device(device)
        self.dx_f = tuple(h / ratio for h in grid.dx)
        self.fine_shape = tuple(s * ratio for s in self.box_shape)

    # -- coordinates of the moving window -----------------------------------
    def _fine_face_coords(self, lo: Origin, d):
        """Physical coords of fine faces normal to d (box MAC layout)."""
        grid, r = self.grid, self.ratio
        axes = []
        for a in range(grid.dim):
            n = self.fine_shape[a] + (1 if a == d else 0)
            i = torch.arange(n, dtype=self.dtype, device=self.device)
            off = 0.0 if a == d else 0.5
            axes.append(grid.x_lo[a] + (lo[a] + (i + off) / r) * grid.dx[a])
        return torch.meshgrid(*axes, indexing="ij")

    def _coarse_face_coords(self, d):
        grid = self.grid
        axes = []
        for a in range(grid.dim):
            i = torch.arange(grid.n[a], dtype=self.dtype, device=self.device)
            off = 0.0 if a == d else 0.5
            axes.append(grid.x_lo[a] + (i + off) * grid.dx[a])
        return torch.meshgrid(*axes, indexing="ij")

    # -- fluxes --------------------------------------------------------------
    def _coarse_fluxes(self, Qc):
        dx = self.grid.dx
        out = []
        for d in range(self.grid.dim):
            Qm = torch.roll(Qc, 1, d)
            F = torch.zeros_like(Qc)
            u = None
            if self.u_c is not None:
                u = self.u_c[d]
            elif self.u_fn is not None:
                u = self.u_fn(self._coarse_face_coords(d), d)
            if u is not None:
                F = F + u * advective_face_value(Qm, Qc, u, self.scheme)
            if self.kappa != 0.0:
                F = F - self.kappa * (Qc - Qm) / dx[d]
            out.append(F)
        return tuple(out)

    def _fine_fluxes(self, Qg, lo: Origin):
        g = self.GHOST
        dim = self.grid.dim
        nf = self.fine_shape
        out = []
        for d in range(dim):
            lo_sl = [slice(g, g + nf[a]) for a in range(dim)]
            hi_sl = [slice(g, g + nf[a]) for a in range(dim)]
            lo_sl[d] = slice(g - 1, g + nf[d])
            hi_sl[d] = slice(g, g + nf[d] + 1)
            Qm = Qg[tuple(lo_sl)]
            Qp = Qg[tuple(hi_sl)]
            F = torch.zeros_like(Qm)
            u = None
            if self.u_f is not None:
                u = self.u_f[d]
            elif self.u_fn is not None:
                u = self.u_fn(self._fine_face_coords(lo, d), d)
            if u is not None:
                F = F + u * advective_face_value(Qm, Qp, u, self.scheme)
            if self.kappa != 0.0:
                F = F - self.kappa * (Qp - Qm) / self.dx_f[d]
            out.append(F)
        return tuple(out)

    # -- one composite step ----------------------------------------------------
    def _fine_substeps(self, Qc, Qc_new, Qf, lo: Origin, dt):
        """Advance one window's fine data r substeps against the coarse
        predictor; returns (Qf_new, acc_lo, acc_hi) boundary-flux sums
        for the reflux."""
        dim = self.grid.dim
        r = self.ratio
        dt_f = dt / r
        acc_lo = [None] * dim
        acc_hi = [None] * dim
        for m in range(r):
            theta = m / r
            Qc_theta = (1.0 - theta) * Qc + theta * Qc_new
            Qg = fill_fine_ghosts_dyn(Qf, Qc_theta, lo, self.GHOST, r)
            Ff = self._fine_fluxes(Qg, lo)
            divf = None
            for d in range(dim):
                n = Ff[d].shape[d]
                t = (stencils.axis_slice(Ff[d], d, 1, n)
                     - stencils.axis_slice(Ff[d], d, 0, n - 1)) \
                    / self.dx_f[d]
                divf = t if divf is None else divf + t
                f_lo = Ff[d].select(d, 0)
                f_hi = Ff[d].select(d, n - 1)
                acc_lo[d] = f_lo if acc_lo[d] is None else acc_lo[d] + f_lo
                acc_hi[d] = f_hi if acc_hi[d] is None else acc_hi[d] + f_hi
            Qf = Qf - dt_f * divf
        return Qf, acc_lo, acc_hi

    def _restrict_and_reflux(self, Qc_new, Qf, lo: Origin, Fc, acc_lo,
                             acc_hi, dt):
        """Restrict one window onto the coarse level and reflux its CF
        interface neighbors."""
        dim = self.grid.dim
        r = self.ratio
        dx = self.grid.dx
        Qc_new = restrict_into_coarse(Qc_new, Qf, lo, r)
        bs = self.box_shape
        for d in range(dim):
            tr = [a for a in range(dim) if a != d]

            def face_avg(f):
                new_shape = []
                for a in tr:
                    new_shape += [bs[a], r]
                return f.reshape(new_shape).mean(
                    dim=tuple(2 * i + 1 for i in range(len(tr))))

            favg_lo = face_avg(acc_lo[d]) / r
            favg_hi = face_avg(acc_hi[d]) / r
            slab = tuple(1 if a == d else bs[a] for a in range(dim))
            hi_face = tuple(l + (bs[d] if a == d else 0)
                            for a, l in enumerate(lo))
            nb_lo = tuple(l - (1 if a == d else 0) for a, l in enumerate(lo))
            for start in (lo, hi_face, nb_lo):
                _check_window(Qc_new.shape, start, slab, "reflux")
            fc_lo = Fc[d][box_slices(lo, slab)].select(d, 0)
            fc_hi = Fc[d][box_slices(hi_face, slab)].select(d, 0)
            # lower neighbor cell at lo[d]-1: F[lo] is its upper face;
            # upper neighbor at lo[d]+shape: F[hi] is its lower face
            sl = box_slices(nb_lo, slab)
            Qc_new[sl] = Qc_new[sl] + (-dt / dx[d]) * (
                favg_lo - fc_lo).reshape(slab)
            sl = box_slices(hi_face, slab)
            Qc_new[sl] = Qc_new[sl] + (dt / dx[d]) * (
                favg_hi - fc_hi).reshape(slab)
        return Qc_new

    def _coarse_advance(self, Qc, dt):
        """Coarse-level flux divergence advance; returns (Fc, Qc_new)."""
        dx = self.grid.dx
        Fc = self._coarse_fluxes(Qc)
        div = None
        for d in range(self.grid.dim):
            t = (torch.roll(Fc[d], -1, d) - Fc[d]) / dx[d]
            div = t if div is None else div + t
        return Fc, Qc - dt * div

    def step_at(self, state: AMRState, dt: float, lo: Origin) -> AMRState:
        """One composite step with the window origin ``lo`` given as host
        ints (equal to ``state.lo``)."""
        Qc, Qf = state.Qc, state.Qf
        Fc, Qc_new = self._coarse_advance(Qc, dt)
        Qf, acc_lo, acc_hi = self._fine_substeps(Qc, Qc_new, Qf, lo, dt)
        Qc_new = self._restrict_and_reflux(Qc_new, Qf, lo, Fc, acc_lo,
                                           acc_hi, dt)
        return AMRState(Qc=Qc_new, Qf=Qf, lo=state.lo)

    def step(self, state: AMRState, dt: float) -> AMRState:
        return self.step_at(state, dt, _origin(state.lo))

    # -- tag / fit / regrid ---------------------------------------------------
    def regrid_at(self, state: AMRState, lo: Origin,
                  compiled: bool = False) -> Tuple[AMRState, Origin]:
        """Tag, fit and regrid from the window at ``lo`` (host ints);
        returns the new state and its origin as host ints. ``compiled``
        fits the box as the reference's compiled advance does
        (:func:`fit_box_origin_host`)."""
        Qc, Qf = state.Qc, state.Qf
        Qc_sync = restrict_into_coarse(Qc, Qf, lo, self.ratio)
        tags = tag_gradient(Qc_sync, self.grid, self.tag_threshold)
        lo_new = fit_box_origin_host(tags, self.box_shape, self.clearance,
                                     compiled=compiled)
        Qc2, Qf2 = regrid(Qc, Qf, lo, lo_new, self.ratio)
        lo_t = torch.tensor(lo_new, dtype=torch.int32, device=Qc.device)
        return AMRState(Qc=Qc2, Qf=Qf2, lo=lo_t), lo_new

    def regrid_state(self, state: AMRState) -> AMRState:
        """One tag/fit/regrid, as the reference's run eagerly."""
        return self.regrid_at(state, _origin(state.lo))[0]

    def advance(self, state: AMRState, dt: float, num_steps: int,
                regrid_interval: int = 4) -> AMRState:
        """``num_steps`` composite steps with a regrid before every
        ``regrid_interval``-th (the first included); one host read of the
        origin per regrid."""
        lo = _origin(state.lo)
        for k in range(num_steps):
            if k % regrid_interval == 0:
                state, lo = self.regrid_at(state, lo, compiled=True)
            state = self.step_at(state, dt, lo)
        return state

    # -- setup / diagnostics --------------------------------------------------
    def initialize(self, fn, lo0=None) -> AMRState:
        """Evaluate ``fn(coords)->tensor`` on the coarse level, fit the
        window to the initial tags (or use ``lo0``), and sample ``fn`` on
        the window's fine cells."""
        kw = dict(dtype=self.dtype, device=self.device)
        Qc = torch.as_tensor(
            fn(self.grid.cell_centers(self.dtype, self.device)), **kw)
        Qc = Qc.expand(self.grid.n).clone()
        if lo0 is None:
            tags = tag_gradient(Qc, self.grid, self.tag_threshold)
            lo = fit_box_origin_host(tags, self.box_shape, self.clearance)
        else:
            lo = _origin(lo0)
        Qf = torch.as_tensor(fn(self._fine_cell_coords(lo)), **kw)
        Qf = Qf.expand(self.fine_shape).clone()
        return AMRState(Qc=Qc, Qf=Qf, lo=torch.tensor(
            lo, dtype=torch.int32, device=self.device))

    def _fine_cell_coords(self, lo: Origin):
        grid, r = self.grid, self.ratio
        axes = []
        for a in range(grid.dim):
            i = torch.arange(self.fine_shape[a], dtype=self.dtype,
                             device=self.device)
            axes.append(grid.x_lo[a] + (lo[a] + (i + 0.5) / r) * grid.dx[a])
        return torch.meshgrid(*axes, indexing="ij")

    def total_at(self, Qc: torch.Tensor, Qf: torch.Tensor,
                 lo: Origin) -> torch.Tensor:
        """Composite conserved integral (uncovered coarse + fine) with the
        window at ``lo`` (host ints)."""
        vol_c = self.grid.cell_volume
        vol_f = vol_c / (self.ratio ** self.grid.dim)
        _check_window(Qc.shape, lo, self.box_shape, "total")
        covered = torch.zeros(self.grid.n, dtype=torch.bool,
                              device=Qc.device)
        covered[box_slices(lo, self.box_shape)] = True
        return (torch.sum(torch.where(covered, torch.zeros_like(Qc), Qc))
                * vol_c + torch.sum(Qf) * vol_f)

    def total(self, state: AMRState) -> torch.Tensor:
        """Composite conserved integral (uncovered coarse + fine)."""
        return self.total_at(state.Qc, state.Qf, _origin(state.lo))
