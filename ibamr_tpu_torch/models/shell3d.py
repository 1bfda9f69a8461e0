"""3D elastic shell, the ex4-equivalent flagship (port of
``ibamr_tpu/models/shell3d.py``).

A latitude-longitude lattice of ``n_lat`` rings of ``n_lon`` markers
(poles excluded) with ring and meridian springs and optional meridian
beams, in a periodic unit box of incompressible fluid, IB_4 delta.

Transfer engines: ``"pallas_packed"`` (the packed chunk layout driven by
the packed CUDA spread/interp kernels, ``ops/cuda_interaction.py``),
``"pallas"`` (the per-tile layout driven by the tile kernels),
``"hybrid_bf16"`` (alias ``"hybrid_packed_bf16"``) and
``"hybrid_packed"`` (the packed spread kernel with the ``packed``
interp, bf16 operands for ``*_bf16``), and the reference's XLA engines in
torch ops: ``"packed"`` / ``"packed_bf16"`` (the xy-packed layout,
``ops/interaction_packed.py``), ``"mxu"`` / ``"mxu_bf16"`` (the per-tile
layout, ``ops/interaction_fast.py``) and ``"packed3"`` /
``"packed3_bf16"`` (the fully blocked layout,
``ops/interaction_packed3.py``); ``"scatter"`` is the scatter/gather
oracle. An absent or ``"auto"`` engine resolves through
``models/engine_resolver.py`` as in the reference. The reference's
build-failure fallback chain is not carried over: the port never
degrades to another engine.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ib import (IBExplicitIntegrator, IBMethod,
                                            IBState)
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.io.structures import StructureData
from ibamr_tpu_torch.models.engine_resolver import (RESOLVED_ENGINES,
                                                    current_platform,
                                                    resolve_engine)
from ibamr_tpu_torch.ops.delta import get_kernel
from ibamr_tpu_torch.ops.interaction_packed import normalize_engine_name


def make_spherical_shell(n_lat: int, n_lon: int, radius: float,
                         center: Tuple[float, float, float],
                         stiffness: float,
                         rest_length_factor: float = 1.0,
                         aspect: float = 1.0,
                         bend_rigidity: float = 0.0) -> StructureData:
    """Structured spherical-shell marker lattice with ring + meridian
    springs (and optional meridian beams). ``aspect`` stretches the z
    axis. Marker (i, j) = ring i, longitude j; index = i * n_lon + j."""
    theta = math.pi * (np.arange(n_lat) + 0.5) / n_lat
    phi = 2.0 * math.pi * np.arange(n_lon) / n_lon
    st, ct = np.sin(theta)[:, None], np.cos(theta)[:, None]
    cp, sp = np.cos(phi)[None, :], np.sin(phi)[None, :]
    x = center[0] + radius * st * cp
    y = center[1] + radius * st * sp
    z = center[2] + radius * aspect * ct * np.ones_like(cp)
    verts = np.stack([x.ravel(), y.ravel(), z.ravel()], axis=1)

    def gid(i, j):
        return i * n_lon + j % n_lon

    I, J = np.meshgrid(np.arange(n_lat), np.arange(n_lon), indexing="ij")
    ring0 = gid(I, J).ravel()
    ring1 = gid(I, J + 1).ravel()
    ring_rest = np.repeat(2.0 * math.pi * radius * np.sin(theta) / n_lon,
                          n_lon)
    Im, Jm = np.meshgrid(np.arange(n_lat - 1), np.arange(n_lon),
                         indexing="ij")
    mer0 = gid(Im, Jm).ravel()
    mer1 = gid(Im + 1, Jm).ravel()
    mer_rest = np.full(mer0.shape, math.pi * radius / n_lat)

    idx0 = np.concatenate([ring0, mer0])
    idx1 = np.concatenate([ring1, mer1])
    rest = np.concatenate([ring_rest, mer_rest]) * rest_length_factor
    springs = np.stack([idx0, idx1,
                        np.full(idx0.shape, stiffness), rest], axis=1)

    data = StructureData(name="shell3d", vertices=verts, springs=springs)
    if bend_rigidity > 0.0:
        Ib, Jb = np.meshgrid(np.arange(1, n_lat - 1), np.arange(n_lon),
                             indexing="ij")
        data.beams = np.stack([
            gid(Ib - 1, Jb).ravel(), gid(Ib, Jb).ravel(),
            gid(Ib + 1, Jb).ravel(),
            np.full(Ib.size, bend_rigidity)], axis=1)
    return data


def shell_volume(X: torch.Tensor, center: Tuple[float, float, float]):
    """Approximate enclosed volume of the marker cloud treated as radial
    samples: V ~ mean(r^3) * 4 pi / 3 (a diagnostic)."""
    c = torch.tensor(center, dtype=X.dtype, device=X.device)
    r = torch.sqrt(torch.sum((X - c) ** 2, dim=-1))
    return (4.0 / 3.0) * math.pi * torch.mean(r ** 3)


def construct_transfer_engine(name, grid: StaggeredGrid, vertices,
                              kernel: str, device="cuda"):
    """Build the named transfer engine for markers at ``vertices`` with
    the reference's sizing: the per-tile layouts (``"pallas"``, ``"mxu"``,
    ``"mxu_bf16"``) hold 1.2 x the fullest tile, at most 1024; the xy-
    packed ones (``"pallas_packed"``, the hybrid engines, ``"packed"``,
    ``"packed_bf16"``) 1.3 x the demand of chunks of 128; ``"packed3"``
    and ``"packed3_bf16"`` 1.3 x the demand of chunks of 64 on z tiles of
    16, else 8 (``ValueError`` when neither fits); every engine buffers
    ``max(2048, N // 4)`` overflow markers. ``"scatter"`` is None (the
    scatter path); a name outside the registry raises ``ValueError``."""
    name = normalize_engine_name(name)
    if name == "scatter":
        return None
    if name not in RESOLVED_ENGINES:
        raise ValueError(f"unknown transfer engine {name!r}")
    from ibamr_tpu_torch.ops.cuda_interaction import (
        HybridKernelInteraction, PackedKernelInteraction,
        TileKernelInteraction)
    from ibamr_tpu_torch.ops.interaction_fast import (FastInteraction,
                                                      suggest_cap)
    from ibamr_tpu_torch.ops.interaction_packed import (PackedInteraction,
                                                        suggest_chunks)
    from ibamr_tpu_torch.ops.interaction_packed3 import (PackedInteraction3,
                                                         suggest_chunks3)

    overflow_cap = max(2048, vertices.shape[0] // 4)
    bf16 = torch.bfloat16 if name.endswith("_bf16") else None
    if name in ("pallas", "mxu", "mxu_bf16"):
        # pole-clustered tiles overflow into the compact scatter path;
        # the bound keeps the dense capacity (and its padding) sane
        cap = min(suggest_cap(grid, vertices, kernel=kernel, tile=8,
                              slack=1.2), 1024)
        if name == "pallas":
            return TileKernelInteraction(grid, kernel=kernel, tile=8,
                                         cap=cap, overflow_cap=overflow_cap,
                                         device=device)
        return FastInteraction(grid, kernel=kernel, tile=8, cap=cap,
                               overflow_cap=overflow_cap,
                               compute_dtype=bf16, device=device)
    if name in ("packed3", "packed3_bf16"):
        # the z tile: the larger of 16 and 8 that divides the z extent
        # and leaves room for the footprint
        s = get_kernel(kernel)[0]
        nz = grid.n[-1]
        tz = next((t for t in (16, 8)
                   if nz % t == 0 and nz >= t + s + 1 and t >= s + 1), None)
        if tz is None:
            raise ValueError(
                f"packed3 engine: no valid z tile for n_z = {nz} with "
                f"kernel {kernel!r} (need n_z divisible by 8 or 16 with "
                f"n_z >= tile+{s + 1}); use the 'packed' engine instead")
        Q3 = suggest_chunks3(grid, vertices, kernel=kernel, tile=8,
                             tile_last=tz, chunk=64, slack=1.3)
        return PackedInteraction3(grid, kernel=kernel, tile=8,
                                  tile_last=tz, chunk=64, nchunks=Q3,
                                  overflow_cap=overflow_cap,
                                  compute_dtype=bf16, device=device)
    Q = suggest_chunks(grid, vertices, kernel=kernel, tile=8, chunk=128,
                       slack=1.3)
    if name == "pallas_packed":
        return PackedKernelInteraction(
            grid, kernel=kernel, tile=8, chunk=128, nchunks=Q,
            overflow_cap=overflow_cap, device=device)
    if name in ("hybrid_bf16", "hybrid_packed_bf16", "hybrid_packed"):
        return HybridKernelInteraction(
            grid, kernel=kernel, tile=8, chunk=128, nchunks=Q,
            overflow_cap=overflow_cap, compute_dtype=bf16, device=device)
    return PackedInteraction(
        grid, kernel=kernel, tile=8, chunk=128, nchunks=Q,
        overflow_cap=overflow_cap, compute_dtype=bf16, device=device)


def build_shell_example(
        n_cells: int = 64,
        n_lat: int = 32,
        n_lon: int = 32,
        radius: float = 0.25,
        aspect: float = 1.2,
        stiffness: float = 1.0,
        rest_length_factor: float = 0.75,
        bend_rigidity: float = 0.0,
        rho: float = 1.0,
        mu: float = 0.05,
        kernel: str = "IB_4",
        convective_op_type: str = "centered",
        use_fast_interaction=None,
        dtype=torch.float32,
        input_db=None,
        spectral_dtype=None,
        device="cuda") -> Tuple[IBExplicitIntegrator, IBState]:
    """Assemble the ex4-equivalent simulation (3D periodic box) on
    ``device`` (the GPU unless ``device="cpu"``).

    ``use_fast_interaction`` names the transfer engine (a name of
    ``RESOLVED_ENGINES``, True for ``"mxu"`` or False for ``"scatter"``);
    None is ``"auto"``. ``input_db`` (an ``InputDatabase``)
    overrides the keyword arguments as the reference reads it:
    ``CartesianGeometry``, ``INSStaggeredHierarchyIntegrator``,
    ``IBMethod`` (``delta_fcn``, ``transfer_engine``) and ``Shell``; the
    file's ``transfer_engine`` applies when ``use_fast_interaction`` is
    None. An absent or ``"auto"`` engine resolves through
    :func:`~ibamr_tpu_torch.models.engine_resolver.resolve_engine` for
    this grid, marker count, delta support, spectral dtype and the
    platform of ``device``; ``ib.engine_name`` is the resolved name. The
    port never degrades to another engine: a failed build raises, and the
    file's ``IBMethod.engine_fallback`` is ignored.
    """
    n = (n_cells,) * 3
    x_lo, x_up = (0.0,) * 3, (1.0,) * 3
    if input_db is not None:
        geo = input_db.get_database_with_default("CartesianGeometry")
        n = tuple(int(v) for v in geo.get_int_array("n_cells", list(n)))
        x_lo = tuple(float(v) for v in geo.get_array("x_lo", list(x_lo)))
        x_up = tuple(float(v) for v in geo.get_array("x_up", list(x_up)))
        ins_db = input_db.get_database_with_default(
            "INSStaggeredHierarchyIntegrator")
        rho = ins_db.get_float("rho", rho)
        mu = ins_db.get_float("mu", mu)
        convective_op_type = ins_db.get_string("convective_op_type",
                                               convective_op_type)
        spectral_dtype = ins_db.get_string(
            "spectral_dtype",
            spectral_dtype if spectral_dtype is not None else "f32")
        ib_db = input_db.get_database_with_default("IBMethod")
        kernel = ib_db.get_string("delta_fcn", kernel)
        if use_fast_interaction is None:
            knob = ("auto",) + RESOLVED_ENGINES
            eng = ib_db.get_string("transfer_engine", "auto").lower()
            if eng not in knob:
                raise ValueError(
                    f"IBMethod.transfer_engine = {eng!r}: expected one "
                    f"of {knob}")
            use_fast_interaction = {"auto": None, "scatter": False,
                                    "mxu": True}.get(eng, eng)
        sh = input_db.get_database_with_default("Shell")
        n_lat = sh.get_int("n_lat", n_lat)
        n_lon = sh.get_int("n_lon", n_lon)
        radius = sh.get_float("radius", radius)
        aspect = sh.get_float("aspect", aspect)
        stiffness = sh.get_float("stiffness", stiffness)
        rest_length_factor = sh.get_float("rest_length_factor",
                                          rest_length_factor)
        bend_rigidity = sh.get_float("bend_rigidity", bend_rigidity)

    grid = StaggeredGrid(n=n, x_lo=x_lo, x_up=x_up)
    ins = INSStaggeredIntegrator(grid, rho=rho, mu=mu,
                                 convective_op_type=convective_op_type,
                                 dtype=dtype, spectral_dtype=spectral_dtype,
                                 device=device)
    center = tuple(0.5 * (lo + hi) for lo, hi in zip(x_lo, x_up))
    structure = make_spherical_shell(
        n_lat, n_lon, radius, center=center,
        stiffness=stiffness, rest_length_factor=rest_length_factor,
        aspect=aspect, bend_rigidity=bend_rigidity)
    if use_fast_interaction is None:
        # "auto": the env override, a tuning DB, else the default rule,
        # queried with the spectral dtype and the device's platform
        use_fast_interaction = resolve_engine(
            n, structure.vertices.shape[0], get_kernel(kernel)[0],
            spectral_dtype=spectral_dtype,
            platform=current_platform(ins.device))
    fast = construct_transfer_engine(use_fast_interaction, grid,
                                     structure.vertices, kernel,
                                     device=ins.device)
    ib = IBMethod(structure.force_specs(dtype=dtype, device=ins.device),
                  kernel=kernel, fast=fast)
    ib.engine_name = normalize_engine_name(use_fast_interaction)
    integ = IBExplicitIntegrator(ins, ib, scheme="midpoint")
    return integ, integ.initialize(structure.vertices)
