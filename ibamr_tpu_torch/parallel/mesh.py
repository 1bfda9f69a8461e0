"""Device meshes, layouts and sharded simulation steps (port of
``ibamr_tpu/parallel/mesh.py``).

The port's mesh is the single-process mesh of ``parallel/spmd.py``:
shards over a list of torch devices (all on ``cuda:0`` with one card,
on the CPU in the tests). Its contract is the reference's: a sharded
step is the single-device step with the explicit seams swapped in --

- the periodic fluid solves go through the pencil FFT
  (:class:`~ibamr_tpu_torch.parallel.fftpar.PencilFFT`), transposes as
  all-to-alls between the shards' blocks;
- the marker transfers go through the co-partitioned engine
  (:class:`~ibamr_tpu_torch.parallel.lagrangian.ShardedInteraction`):
  owner-bucketed pools, per-shard local scatter/gather, halo exchange;

The INS and IB families, periodic or wall-bounded, the adv-diff family
and the two-phase (variable-coefficient) family, periodic or walled on
any axes, are block-resident, as the reference's GSPMD step keeps every
grid array split: :func:`place_state`
/ :func:`shard_state` hold each grid array as
:class:`~ibamr_tpu_torch.parallel.spmd.Blocks` (per-shard blocks on the
shards' own devices, carrying their layout), and the step never builds
a whole-grid tensor. Its stencils (convection, the Laplacians, the
pressure gradient, the projection's divergence and gradient) run as
halo stencils (``spmd.halo_apply``: ghost layers by ppermute, the roll
form on every padded block, bitwise the whole-grid stencil; at a wall
the edge shards build the ghosts the whole-grid stencil pads there),
the RHS assembly cell by cell on the blocks, the solves through the
pencils (with walls, the pencil fast-diagonalization:
:class:`~ibamr_tpu_torch.parallel.fftpar.PencilFastDiag`) and the
transfers from and into the blocks. The two-phase step adds the
multigrid V-cycle and the CG on blocks (a multigrid level too coarse to
cut runs whole on the first shard, gathered and scattered under its own
census name) and the level set on halos; the adv-diff step its flux
divergence on halos and the pencil solves of each quantity. Only the
host-facing edges (:func:`unshard_state`, checkpoints, viz) assemble a
whole tensor.

The other families (the two-phase step with an open outlet, the other
open-boundary families, the AMR hierarchies, LES, CIB) keep the pinned
form: the step runs on whole tensors on the mesh's first device, with
the layout attached to every grid array (``spmd.pin``), their seams
swapped as the reference swaps them.

The lane mesh (:func:`make_lane_mesh`) splits a B-lane fleet (lane axis
0 of every leaf) into whole lanes per shard; the fleet chunk of
``utils/hierarchy_driver.py`` steps each shard's lanes from its own
block.
"""

from __future__ import annotations

import copy
import math
from typing import Optional, Sequence, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.parallel.spmd import (Blocks, Mesh, NamedSharding, P,
                                           PartitionSpec, halo_stencil,
                                           mesh_devices, pin, shard,
                                           sharding_of, smap, split_dims,
                                           unshard)
from ibamr_tpu_torch.utils.tree import leaves, map_with_path, tree_map

__all__ = ["Mesh", "NamedSharding", "P", "PartitionSpec", "factor_devices",
           "make_mesh", "grid_pspec", "shard_state", "place_state",
           "unshard_state",
           "make_sharded_step", "make_sharded_ins_step",
           "make_sharded_ib_step", "make_lane_mesh", "shard_lanes",
           "place_lanes", "sharding_of"]


def factor_devices(n: int, max_axes: int = 2) -> Tuple[int, ...]:
    """Near-square factorization of the shard count into mesh axes."""
    if max_axes == 1 or n == 1:
        return (n,)
    a = int(math.isqrt(n))
    while a > 1 and n % a != 0:
        a -= 1
    if a == 1:
        return (n,)
    return (n // a, a)


def make_mesh(n_devices: Optional[int] = None,
              devices: Optional[Sequence] = None,
              axis_names: Tuple[str, ...] = ("x", "y"),
              max_axes: int = 2, device="cuda") -> Mesh:
    """A 1D/2D spatial mesh of ``n_devices`` shards (default: one per
    GPU), or one shard per entry of ``devices``. On ``cuda`` the shards
    cycle over the GPUs; ``device="cpu"`` puts them on the CPU."""
    if devices is None:
        if n_devices is None:
            n_devices = (torch.cuda.device_count()
                         if torch.device(device).type == "cuda" else 1)
        devices = mesh_devices(n_devices, device)
    elif n_devices is not None:
        devices = list(devices)[:n_devices]
    devices = [torch.device(d) for d in devices]
    shape = factor_devices(len(devices), max_axes)
    arr = np.empty(len(devices), dtype=object)
    arr[:] = devices
    return Mesh(arr.reshape(shape), axis_names[:len(shape)])


def grid_pspec(mesh: Mesh, grid_dim: int) -> PartitionSpec:
    """PartitionSpec splitting the leading grid axes over the mesh axes."""
    names = list(mesh.axis_names)[:grid_dim]
    return P(*names, *([None] * (grid_dim - len(names))))



def shard_state(state, grid: StaggeredGrid, mesh: Mesh):
    """The state with every grid-shaped tensor cut into
    :class:`Blocks` under the spatial layout; block-resident leaves and
    everything else (markers, scalars) pass through."""
    spec = grid_pspec(mesh, grid.dim)
    gshape = tuple(grid.n)

    def cut(_, a):
        if isinstance(a, torch.Tensor) and tuple(a.shape) == gshape:
            return Blocks.cut(mesh, a, spec)
        return a

    return map_with_path(cut, state)


def place_state(state, grid: StaggeredGrid, mesh: Mesh):
    """The initial state placed on the mesh: grid-shaped tensors as
    :class:`Blocks` under the spatial layout (a leaf already in blocks
    of another layout is re-cut), every other tensor replicated on the
    mesh's first device."""
    spec = grid_pspec(mesh, grid.dim)
    replicated = NamedSharding(mesh, P())
    gshape = tuple(grid.n)

    def put(_, a):
        if isinstance(a, Blocks):
            if a.mesh is mesh and tuple(a.spec) == tuple(spec):
                return a
            a = a.assemble()
        a = torch.as_tensor(a)
        if tuple(a.shape) == gshape:
            return Blocks.cut(mesh, a, spec)
        return pin(a, replicated)

    return map_with_path(put, state)


def unshard_state(state, device=None):
    """The host-facing edge of a block-resident state: every
    :class:`Blocks` leaf assembled into its whole tensor on ``device``
    (default: its mesh's first device); other leaves pass through."""
    def whole(_, a):
        return a.assemble(device) if isinstance(a, Blocks) else a

    return map_with_path(whole, state)


def _pin_grid_state(state, grid: StaggeredGrid, mesh: Mesh):
    """The pinned form: every grid-shaped tensor whole on the mesh's
    first device carrying the spatial layout (Blocks assembled)."""
    sharding = NamedSharding(mesh, grid_pspec(mesh, grid.dim))
    gshape = tuple(grid.n)

    def constrain(_, a):
        if isinstance(a, Blocks):
            a = a.assemble()
        if isinstance(a, torch.Tensor) and tuple(a.shape) == gshape:
            return pin(a, sharding)
        return a

    return map_with_path(constrain, state)


# ---------------------------------------------------------------------------
# the sharding seam: the block-resident INS / IB steps, one generic
# pinned-step wrapper for the other families, per-family prepare hooks
# and a name-dispatched entry point
# ---------------------------------------------------------------------------

def _block_fluid(ins, mesh: Mesh):
    """Shallow copy of an INS integrator that steps block-resident
    state, periodic or wall-bounded: the solves take and return Blocks
    (pencil FFT; with walls the pencil fast-diagonalization of
    ``WallOps.on_mesh``; the fused single-device spectral path off), and
    every stencil of the step (convection at its scheme's ghost width,
    the Laplacians, the pressure gradient, the divergence) a halo
    stencil, wall-aware at the mesh's edge shards. A block thinner than
    a stencil's ghost width along a split axis (on a wall axis, one more
    cell: the pinned wall ghosts read it), or a grid the pencils cannot
    split, raises."""
    from ibamr_tpu_torch.ops import stencils
    from ibamr_tpu_torch.ops.convection import GHOST_WIDTH
    from ibamr_tpu_torch.parallel.fftpar import PencilFFT

    walls = ins.wall_axes
    width = 1
    if ins._convective is not None:
        width = GHOST_WIDTH[ins.convective_op_type]
    spec = grid_pspec(mesh, ins.grid.dim)
    for d, axis in split_dims(NamedSharding(mesh, spec), ins.grid.dim):
        extent = ins.grid.n[d] // mesh.axis_size(axis)
        need = width + (1 if walls[d] and ins._convective is not None
                        else 0)
        if extent < need:
            raise ValueError(
                f"grid axis {d} splits into blocks of {extent} cells, "
                f"thinner than the {ins.convective_op_type!r} "
                f"convection's ghost width {width}"
                f"{' (+1 at a wall)' if walls[d] else ''}: use fewer "
                f"shards or a bigger grid")
    integ = copy.copy(ins)
    integ.fused_stokes = None
    integ._step_graphs = {}
    if any(walls):
        # the wall operators take Blocks themselves, and so does the
        # ghost-padded convection
        ops = ins.wall_ops.on_mesh(mesh, ins.dtype)
        integ.wall_ops = ops
        integ.helmholtz_vel_solve = ops.helmholtz_vel
        integ.project = ops.project
        integ.laplacian_vel = ops.laplacian_vel
        integ.pressure_gradient = ops.pressure_gradient
        integ.laplacian_cc = ops.laplacian_cc
        return integ
    pencil = PencilFFT(ins.grid, mesh)
    integ.helmholtz_vel_solve = pencil.helmholtz_vel
    integ.project = pencil.project_divergence_free
    if ins._convective is not None:
        integ._convective = halo_stencil(ins._convective, width)
    integ.laplacian_vel = halo_stencil(stencils.laplacian_vel, 1)
    return integ


def _block_step(integ, grid: StaggeredGrid, mesh: Mesh):
    """``integ.step`` on block-resident state: grid-shaped tensors among
    the state and the arguments are cut into blocks once (a state from
    :func:`place_state` is already), and the result stays in blocks."""
    def step(state, *args, **kwargs):
        args = tuple(shard_state(a, grid, mesh) for a in args)
        kwargs = {k: shard_state(v, grid, mesh) for k, v in kwargs.items()}
        return integ.step(shard_state(state, grid, mesh), *args, **kwargs)

    step.integ = integ
    step.mesh = mesh
    return step


def _generic_pinned_step(integ, mesh: Mesh, prepare=None, pin_state=None):
    """The pinned wrapper the families not yet partitioned use: lay the
    state and every tensor argument out on the mesh, call
    ``integ.step``, lay the result out. ``pin_state`` defaults to the
    exact-shape grid layout (:func:`_pin_grid_state`); Blocks leaves are
    assembled first."""
    if prepare is not None:
        integ = prepare(integ, mesh)
    lay = pin_state
    if lay is None:
        grid = integ.grid

        def lay(t):
            return _pin_grid_state(t, grid, mesh)

    def pin_state(t):
        return lay(unshard_state(t))

    def step(state, *args, **kwargs):
        args = tuple(pin_state(a) for a in args)
        kwargs = {k: pin_state(v) for k, v in kwargs.items()}
        return pin_state(integ.step(pin_state(state), *args, **kwargs))

    step.integ = integ
    step.mesh = mesh
    return step


def make_sharded_ins_step(integ, mesh: Mesh):
    """INS step over ``mesh``, block-resident, periodic or wall-bounded:
    every grid array stays in blocks from entry to exit; the solves go
    through the pencils (FFT, or the fast-diagonalization transforms on
    the wall axes) and the stencils through the halo pass."""
    return _block_step(_block_fluid(integ, mesh), integ.grid, mesh)


def _check_extents(grid: StaggeredGrid, mesh: Mesh, width, what: str):
    """Raise when a block along a split axis is thinner than the ghost
    width ``width[d]`` the step's stencils read there."""
    for d, axis in split_dims(NamedSharding(mesh, grid_pspec(mesh, grid.dim)),
                              grid.dim):
        p = mesh.axis_size(axis)
        if grid.n[d] % p:
            raise ValueError(f"grid axis {d} ({grid.n[d]}) does not divide "
                             f"over mesh axis {axis!r} ({p})")
        extent = grid.n[d] // p
        if extent < width[d]:
            raise ValueError(
                f"grid axis {d} splits into blocks of {extent} cells, "
                f"thinner than the {what}'s ghost width {width[d]}: use "
                f"fewer shards or a bigger grid")


def make_sharded_adv_diff_step(integ, mesh: Mesh):
    """Adv-diff step over ``mesh``, block-resident, periodic or walled:
    every grid array (and the velocity and sources it is given, cut at
    the step's edge) in blocks; the flux divergence and the Laplacians
    halo stencils, the Crank-Nicolson solves through the pencils."""
    _check_extents(integ.grid, mesh, (2,) * integ.grid.dim,
                   "flux divergence")
    return _block_step(integ.on_mesh(mesh), integ.grid, mesh)


def make_sharded_step(integ, mesh: Mesh, **opts):
    """THE sharding entry point: dispatch an integrator to its family's
    sharded-step builder by class name, walking the MRO so a subclass
    keeps its family's seams. Integrators outside the table that expose
    ``.grid`` and ``.step`` get the generic wrapper."""
    table = {
        "INSStaggeredIntegrator": make_sharded_ins_step,
        "AdvDiffSemiImplicitIntegrator": make_sharded_adv_diff_step,
        "INSVCStaggeredIntegrator": make_sharded_vc_step,
        "INSVCConservativeIntegrator": make_sharded_vc_step,
        "INSOpenIntegrator": make_sharded_open_ins_step,
        "IBOpenIntegrator": make_sharded_ib_open_step,
        "IBExplicitIntegrator": make_sharded_ib_step,
        "TwoLevelIBINS": make_sharded_two_level_ib_step,
        "MultiLevelAdvDiff": make_sharded_multilevel_step,
        "MultiLevelINS": make_sharded_multilevel_ins_step,
        "MultiLevelIBINS": make_sharded_multilevel_ib_step,
        "MultiBoxDynamicAdvDiff": make_sharded_multibox_step,
        "TwoLevelSmagorinskyINS": make_sharded_les_two_level_step,
        "CIBMethod": make_sharded_cib_constraint,
    }
    for klass in type(integ).__mro__:
        builder = table.get(klass.__name__)
        if builder is not None:
            return builder(integ, mesh, **opts)
    if hasattr(integ, "grid") and hasattr(integ, "step"):
        return _generic_pinned_step(integ, mesh, **opts)
    raise TypeError(
        f"no sharded-step builder for {type(integ).__name__}; expose "
        f".grid/.step for the generic wrapper or register a family "
        f"builder")


def _spatial(mesh: Mesh, dim: int) -> NamedSharding:
    return NamedSharding(mesh, grid_pspec(mesh, dim))


def make_sharded_multilevel_step(ml, mesh: Mesh):
    """Level-by-level AMR: every level of a ``MultiLevelAdvDiff``
    hierarchy laid out over the same mesh."""
    shardings = [_spatial(mesh, len(spec.grid.n)) for spec in ml.levels]

    def constrain(Qs):
        return tuple(pin(q, s) for q, s in zip(unshard_state(Qs),
                                                shardings))

    def step(Qs, dt):
        return constrain(ml.step(constrain(tuple(Qs)), dt))

    return step


def _wrap_sharded_markers(base_ib, grid: StaggeredGrid, mesh: Mesh,
                          marker_cap: Optional[int] = None,
                          marker_slack: float = 2.0,
                          warn_strategy: bool = False,
                          blocks: bool = False):
    """The facade routing an IBMethod's transfers through the
    co-partitioned engine on ``grid``; ``None`` when it cannot engage
    (a non-IBMethod strategy, warned only on an explicit request; a
    (grid, mesh) the engine refuses, warned). ``blocks=True`` spreads
    into grid Blocks (the block-resident step); whole tensors
    otherwise."""
    import warnings

    from ibamr_tpu_torch.integrators.ib import IBMethod
    from ibamr_tpu_torch.parallel.lagrangian import ShardedInteraction

    if not isinstance(base_ib, IBMethod):
        if warn_strategy:
            warnings.warn(
                "sharded markers disabled: the facade understands "
                f"marker-point IBMethod transfers only (got "
                f"{type(base_ib).__name__}); keeping the strategy's own "
                "transfers")
        return None
    try:
        ShardedInteraction(grid, mesh, kernel=base_ib.kernel, cap=8)
    except ValueError as e:
        warnings.warn(f"sharded markers disabled for this (grid, mesh): {e}")
        return None

    engines = {}

    def get_engine(N):
        # keyed by marker count: a capacity sized for another N is wrong.
        # On blocks a shard's pool holds every marker by default: the
        # per-shard work follows the filled slots, not the capacity, and
        # the overflow fallback (the replicated oracle) needs the whole
        # grid
        if N not in engines:
            cap = marker_cap
            if cap is None and blocks:
                cap = N
            engines[N] = ShardedInteraction(
                grid, mesh, kernel=base_ib.kernel, n_markers=N,
                cap=cap, slack=marker_slack)
        return engines[N]

    class _ShardedIB:
        """IBMethod facade routing transfers through the sharded
        engine; force evaluation stays with the base method."""

        def __init__(self):
            self.specs = base_ib.specs
            self.kernel = base_ib.kernel
            self.engine_name = "sharded"
            self.base = base_ib

        def engine(self, N):
            return get_engine(N)

        def compute_force(self, X, U, t):
            return base_ib.compute_force(X, U, t)

        def prepare(self, X, mask):
            return get_engine(X.shape[0]).buckets(X, mask)

        def interpolate_velocity(self, u, g, X, mask, ctx=None):
            eng = get_engine(X.shape[0])
            if ctx is None:
                ctx = eng.buckets(X, mask)
            return eng.interpolate_vel(u, X, weights=mask, b=ctx)

        def spread_force(self, F, g, X, mask, ctx=None):
            eng = get_engine(X.shape[0])
            if ctx is None:
                ctx = eng.buckets(X, mask)
            return eng.spread_vel(F, X, weights=mask, b=ctx, blocks=blocks)

    return _ShardedIB()


def make_sharded_ib_step(integ, mesh: Mesh,
                         sharded_markers: Optional[bool] = None,
                         marker_cap: Optional[int] = None,
                         marker_slack: float = 2.0):
    """Coupled IB step (interp -> force -> spread -> fluid solve ->
    correct) over ``mesh``, block-resident over a periodic or a
    wall-bounded fluid: the fluid as in :func:`make_sharded_ins_step`
    and the marker transfers through the co-partitioned engine, which
    reads the velocity blocks and returns force blocks (its transfers
    wrap periodically, as the single-device ones do); markers stay
    replicated on the mesh's first device. The engine is required: a
    strategy it cannot take, or ``sharded_markers=False``, raises. Its
    pools hold every marker a shard (``marker_cap`` overrides; a layout
    that overflows an explicit cap takes the replicated oracle, which
    assembles the grid)."""
    grid = integ.ins.grid
    integ = copy.copy(integ)
    integ._jitted_steps = {}
    if sharded_markers is False:
        raise ValueError(
            "the block-resident IB step needs the co-partitioned "
            "marker transfers (sharded_markers=False)")
    wrapped = _wrap_sharded_markers(integ.ib, grid, mesh, marker_cap,
                                    marker_slack, warn_strategy=True,
                                    blocks=True)
    if wrapped is None:
        raise ValueError(
            "the block-resident IB step needs the co-partitioned "
            "marker transfers, which cannot engage here (warned "
            "above)")
    integ.ins = _block_fluid(integ.ins, mesh)
    integ.ib = wrapped
    return _block_step(integ, grid, mesh)


def make_sharded_two_level_ib_step(integ, mesh: Mesh,
                                   shard_window: bool = False,
                                   sharded_markers: bool = False,
                                   marker_cap: Optional[int] = None,
                                   marker_slack: float = 2.0):
    """Composite two-level INS/IB step with the COARSE level laid out
    over ``mesh`` and the fine window replicated (default) or laid out
    too (``shard_window=True``). The composite projection's coarse
    preconditioner becomes the dense-periodic fast-diagonalization
    inverse (``build_dense_coarse_solver``), as in the reference's
    sharded path. ``sharded_markers=True`` routes the fine-level marker
    transfers through the co-partitioned engine on the fine grid."""
    grid = integ.grid
    spatial = _spatial(mesh, grid.dim)
    replicated = NamedSharding(mesh, P())
    window_sh = spatial if shard_window else replicated

    integ = copy.copy(integ)
    integ.core = copy.copy(integ.core)
    proj = copy.copy(integ.core.proj)
    proj.level_sharding = spatial
    proj.window_sharding = window_sh
    proj._graphs = None
    proj.build_dense_coarse_solver()
    integ.core.proj = proj

    if sharded_markers:
        wrapped = _wrap_sharded_markers(
            integ.ib, integ.fine_grid, mesh, marker_cap, marker_slack,
            warn_strategy=True)
        if wrapped is not None:
            integ.ib = wrapped

    def pin_state(st):
        st = unshard_state(st)
        fluid = st.fluid._replace(
            uc=tuple(pin(c, spatial) for c in st.fluid.uc),
            uf=tuple(pin(f, window_sh) for f in st.fluid.uf))
        return st._replace(fluid=fluid, X=pin(st.X, replicated),
                           U=pin(st.U, replicated),
                           mask=pin(st.mask, replicated))

    def step(state, dt):
        return pin_state(integ.step(pin_state(state), dt))

    step.integ = integ
    return step


def _shard_multilevel_proj(core, mesh: Mesh, shard_boxes: bool = False):
    """Copy of an L-level core integrator whose composite projection
    has the root laid out over the mesh (boxes replicated, or laid out
    too with ``shard_boxes``) and the dense-periodic root inverse."""
    core = copy.copy(core)
    proj = copy.copy(core.proj)
    spatial = _spatial(mesh, core.grid.dim)
    proj.root_sharding = spatial
    proj.box_sharding = spatial if shard_boxes else NamedSharding(mesh, P())
    proj._graphs = None
    proj.build_dense_root_solver()
    core.proj = proj
    return core


def _pin_multilevel_us(us, spatial, box_sh):
    return tuple(tuple(pin(c, spatial if l == 0 else box_sh) for c in lev)
                 for l, lev in enumerate(us))


def make_sharded_multilevel_ins_step(integ, mesh: Mesh,
                                     shard_boxes: bool = False):
    """L-level composite INS step (``MultiLevelINS``) with the root
    level laid out over ``mesh``."""
    integ = _shard_multilevel_proj(integ, mesh, shard_boxes=shard_boxes)
    spatial = _spatial(mesh, integ.grid.dim)
    box_sh = spatial if shard_boxes else NamedSharding(mesh, P())

    def pin_state(st):
        st = unshard_state(st)
        return st._replace(us=_pin_multilevel_us(st.us, spatial, box_sh))

    def step(state, dt):
        return pin_state(integ.step(pin_state(state), dt))

    step.integ = integ
    return step


def make_sharded_multilevel_ib_step(integ, mesh: Mesh,
                                    shard_boxes: bool = False):
    """L-level composite INS/IB step (``MultiLevelIBINS``): root level
    laid out over ``mesh``, box levels replicated (or laid out with
    ``shard_boxes``), markers replicated."""
    integ = copy.copy(integ)
    integ.core = _shard_multilevel_proj(integ.core, mesh,
                                        shard_boxes=shard_boxes)
    spatial = _spatial(mesh, integ.grid.dim)
    replicated = NamedSharding(mesh, P())
    box_sh = spatial if shard_boxes else replicated

    def pin_state(st):
        st = unshard_state(st)
        fluid = st.fluid._replace(
            us=_pin_multilevel_us(st.fluid.us, spatial, box_sh))
        return st._replace(fluid=fluid, X=pin(st.X, replicated),
                           U=pin(st.U, replicated),
                           mask=pin(st.mask, replicated))

    def step(state, dt):
        return pin_state(integ.step(pin_state(state), dt))

    step.integ = integ
    return step


# ---- fleet lane sharding ----------------------------------------------------
# A lane mesh splits a B-lane fleet (lane axis ALWAYS axis 0 of every
# leaf, utils/lanes.py) into B/D whole lanes per shard; lanes are
# independent, so no block ever crosses shards inside a step.

LANE_AXIS = "lanes"


def make_lane_mesh(n_devices: Optional[int] = None,
                   devices: Optional[Sequence] = None,
                   device="cuda") -> Mesh:
    """1-D mesh over the lane (batch) axis of a stacked fleet state."""
    return make_mesh(n_devices, devices, axis_names=(LANE_AXIS,),
                     max_axes=1, device=device)


def lane_pspec(mesh: Mesh) -> PartitionSpec:
    """PartitionSpec splitting axis 0 (the lane axis) over the lane mesh."""
    return P(mesh.axis_names[0])


def _check_lane_divisible(lanes: int, mesh: Mesh) -> None:
    d = int(mesh.devices.size)
    if lanes % d != 0:
        raise ValueError(
            f"fleet of {lanes} lanes does not divide the {d}-device "
            f"lane mesh evenly (lanes % devices must be 0 so every "
            f"device owns whole lanes)")


def shard_lanes(state, mesh: Mesh):
    """Every leaf's lane axis (axis 0) laid out over the lane mesh."""
    sharding = NamedSharding(mesh, lane_pspec(mesh))

    def constrain(a):
        if isinstance(a, torch.Tensor) and a.dim() >= 1:
            return pin(a, sharding)
        return a

    return tree_map(constrain, state)


def place_lanes(state, mesh: Mesh):
    """A lane-stacked fleet state placed on the lane mesh (lane-laid-out
    leaves; scalars replicated), so sharded checkpoints record the lane
    layout. Raises when the lanes do not divide over the mesh."""
    sharding = NamedSharding(mesh, lane_pspec(mesh))
    replicated = NamedSharding(mesh, P())
    ls = [x for x in leaves(state) if getattr(x, "ndim", 0) >= 1]
    if ls:
        _check_lane_divisible(int(ls[0].shape[0]), mesh)

    def put(a):
        a = torch.as_tensor(a)
        return pin(a, sharding if a.dim() >= 1 else replicated)

    return tree_map(put, state)


def step_lane_blocks(mesh: Mesh, state, lane_step):
    """One fleet step on a lane mesh: shard i's body steps its own whole
    lanes (``lane_step(ctx, block, first_lane) -> block``, ``block`` a
    copy of the state's rows of those lanes on the shard's device), and
    the blocks are laid out over the lane mesh again."""
    spec = lane_pspec(mesh)
    sharding = NamedSharding(mesh, spec)
    ls = leaves(state)
    per = int(ls[0].shape[0]) // mesh.size
    cols = [shard(mesh, x, spec) for x in ls]

    def block(i):
        it = iter([c[i] for c in cols])
        return tree_map(lambda _x: next(it), state)

    outs = smap(lambda ctx, blk: lane_step(ctx, blk, ctx.index * per),
                mesh, [block(i) for i in range(mesh.size)])
    out_cols = [leaves(b) for b in outs]
    it = iter([pin(unshard(mesh, [c[k] for c in out_cols], spec,
                            ls[k].device), sharding)
               for k in range(len(ls))])
    return tree_map(lambda _x: next(it), state)


def make_sharded_vc_step(integ, mesh: Mesh):
    """Variable-coefficient (two-phase) INS step over ``mesh``, both
    forms, periodic or walled on any axes: block-resident (the
    stencils on halos, the CG and its multigrid or pencil-FFT
    preconditioner on blocks, the level set on halos). The open outlet
    (face-complete axis-0 assemblies) keeps the pinned form."""
    if integ.open_outlet:
        return _generic_pinned_step(integ, mesh)
    _check_extents(integ.grid, mesh, integ.halo_width(), "two-phase step")
    return _block_step(integ.on_mesh(mesh), integ.grid, mesh)


def _pin_rank_dim(mesh: Mesh, dim: int):
    """Lay out every rank-``dim`` tensor of a pytree spatially (the
    face-complete open-boundary layouts have +1 extents, so an exact
    shape cannot classify them; rank does)."""
    sharding = _spatial(mesh, dim)

    def pin_one(a):
        if isinstance(a, torch.Tensor) and a.dim() == dim:
            return pin(a, sharding)
        return a

    def pin_state(st):
        st = unshard_state(st)
        return tree_map(pin_one, st)

    return pin_state


def make_sharded_multibox_step(mb, mesh: Mesh, costs=None, X=None,
                               w_marker: float = 4.0):
    """Workload-balanced box -> shard placement for the K-window
    multi-box hierarchy: per-window costs (fine cells + ``w_marker`` x
    markers, ``workload.box_costs``) unless given, greedy LPT packing of
    the boxes onto the shards (``workload.lpt_assign``); the step runs
    every shard's fine-window substeps from its own slots against the
    pristine coarse predictor, then applies the restriction/reflux
    write-backs in box order (the plain step's read-then-write order).

    Returns ``step(state, dt)``; ``step.placement()`` gives the
    assignment and per-shard loads, ``step.rebuild(state)`` re-places
    after a host-side regrid moved the windows. ``costs`` overrides the
    cost model for the initial layout only."""
    from ibamr_tpu_torch.amr_multibox import MultiBoxState, _origins
    from ibamr_tpu_torch.parallel.workload import box_costs, lpt_assign

    D = mesh.size
    K = mb.K
    win = mb.win
    holder = {"explicit_costs": costs}
    replicated = NamedSharding(mesh, P())
    current = {}

    def make(lo_np):
        c = holder.pop("explicit_costs", None)
        if c is None:
            c = box_costs(lo_np, mb.win.box_shape, mb.grid, ratio=mb.ratio,
                          X=X, w_marker=w_marker)
        device_of_box, load = lpt_assign(c, D)
        boxes_of = [[k for k in range(K) if int(device_of_box[k]) == d]
                    for d in range(D)]
        current.update(costs=c, device_of_box=device_of_box, load=load,
                       slots_per_device=int(max(1, max(
                           len(b) for b in boxes_of))),
                       boxes_of=boxes_of)

    def step(state, dt):
        if not current:
            make(np.asarray(_origins(state.lo)))
        los = _origins(state.lo)
        Qc = pin(state.Qc, replicated)
        Fc, Qc_new = win._coarse_advance(Qc, dt)
        boxes_of = current["boxes_of"]
        pools = [[state.Qf[k] for k in boxes_of[d]] for d in range(D)]

        def substeps(ctx, pool):
            return [win._fine_substeps(Qc, Qc_new, qf, los[k], dt)
                    for qf, k in zip(pool, boxes_of[ctx.index])]

        subs_of = smap(substeps, mesh, pools)
        subs = [None] * K
        for d in range(D):
            for k, s in zip(boxes_of[d], subs_of[d]):
                subs[k] = s
        for k in range(K):             # cheap, exact, box order
            Qf_k, acc_lo, acc_hi = subs[k]
            Qc_new = win._restrict_and_reflux(Qc_new, Qf_k, los[k], Fc,
                                              acc_lo, acc_hi, dt)
        return MultiBoxState(Qc=pin(Qc_new, replicated),
                             Qf=pin(torch.stack([s[0] for s in subs]),
                                     replicated), lo=state.lo)

    def rebuild(state):
        """Re-place after a host-side regrid moved the windows."""
        current.clear()
        make(np.asarray(_origins(state.lo)))

    def placement():
        return ({k: v for k, v in current.items() if k != "boxes_of"}
                if current else None)

    step.placement = placement
    step.rebuild = rebuild
    return step


def make_sharded_les_two_level_step(les, mesh: Mesh):
    """Composite-window LES step: the coarse level laid out over
    ``mesh``, the refined window replicated, with the dense-periodic
    coarse preconditioner of the sharded composite projection."""
    spatial = _spatial(mesh, les.grid.dim)
    replicated = NamedSharding(mesh, P())
    les = copy.copy(les)
    les.core = copy.copy(les.core)
    proj = copy.copy(les.core.proj)
    proj.level_sharding = spatial
    proj.window_sharding = replicated
    proj._graphs = None
    proj.build_dense_coarse_solver()
    les.core.proj = proj

    def pin_state(st):
        st = unshard_state(st)
        return st._replace(uc=tuple(pin(c, spatial) for c in st.uc),
                           uf=tuple(pin(f, replicated) for f in st.uf))

    def step(state, dt):
        return pin_state(les.step(pin_state(state), dt))

    step.integ = les
    return step


def make_sharded_cib_constraint(cibm, mesh: Mesh):
    """CIB prescribed-kinematics solve on the mesh: markers and the
    solve's outputs replicated; the nested mobility's Eulerian fields
    run on the mesh's first device."""
    replicated = NamedSharding(mesh, P())

    def solve(X, U):
        lam, FT, info = cibm.solve_constraint(pin(X, replicated),
                                              pin(U, replicated))
        return pin(lam, replicated), pin(FT, replicated), info

    return solve


def make_sharded_open_ins_step(integ, mesh: Mesh):
    """Inflow/outflow (open-boundary) INS step laid out over ``mesh``."""
    return _generic_pinned_step(integ, mesh,
                                pin_state=_pin_rank_dim(mesh, len(integ.n)))


def make_sharded_ib_open_step(integ, mesh: Mesh):
    """Coupled IB step over the open-boundary fluid, the Eulerian state
    laid out over ``mesh`` and the markers replicated."""
    pin_fluid = _pin_rank_dim(mesh, len(integ.ins.n))
    replicated = NamedSharding(mesh, P())

    def pin_all(st):
        if hasattr(st, "fluid"):
            return st._replace(fluid=pin_fluid(st.fluid),
                               X=pin(st.X, replicated),
                               U=pin(st.U, replicated),
                               mask=pin(st.mask, replicated))
        return st

    return _generic_pinned_step(integ, mesh, pin_state=pin_all)
