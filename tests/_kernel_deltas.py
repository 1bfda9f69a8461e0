"""Shared cases of the ``test_torch_kernel_deltas*.py`` files: the ten
named deltas, a 16³ grid with tile 8 (the smallest legal size at support
6), markers whose supports reach past every face, and the reference's
programs of the four transfer kernels on both layouts. The reference's
Pallas programs cannot trace IB_6 (its table would be a constant the
kernel captures, which Pallas refuses), so at IB_6 (and where a case
asks for it: each interpret-mode Pallas call costs ~2 s) the reference
side is the same program in XLA ops: the reference's own tile weights
contracted per layout row, summed per tile and folded (the sums of
``interaction_packed._spread_raw`` / ``_interp_raw`` and of the ``mxu``
engine without their overflow paths)."""

import math

import jax
import numpy as np
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction_fast as jfast
from ibamr_tpu.ops import pallas_interaction as jpal
from ibamr_tpu.ops.interaction import _centering_offsets
from ibamr_tpu.ops.interaction_packed import suggest_chunks
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import cuda_interaction as ci

DELTAS = ("PIECEWISE_LINEAR", "BSPLINE_2", "IB_3", "BSPLINE_3", "COSINE",
          "IB_4", "BSPLINE_4", "BSPLINE_5", "IB_6", "BSPLINE_6")
N_CELLS = (16, 16, 16)
TOL_F64 = 1e-12


def grids():
    box = dict(x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    return JGrid(n=N_CELLS, **box), TGrid(n=N_CELLS, **box)


def markers(seed, dtype, N=120):
    """Markers in the box and within one cell of each face, so that
    supports reach past every face; forces and a field of each
    component."""
    rng = np.random.default_rng(seed)
    X = rng.uniform(0, 1, (N, 3))
    near = rng.uniform(0, 1, (N // 2, 3)) / N_CELLS[0]
    X[: N // 2] = np.where(rng.uniform(size=(N // 2, 3)) < 0.5, near,
                           1.0 - near)
    F = rng.standard_normal((N, 3))
    u = [rng.standard_normal(N_CELLS) for _ in range(3)]
    return X.astype(dtype), F.astype(dtype), [c.astype(dtype) for c in u]


def close(ref, got, tol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    scale = float(np.max(np.abs(ref)))
    assert scale > 0
    np.testing.assert_allclose(got, ref, rtol=0, atol=tol * scale)


def packed_case(kernel, X):
    jg, tg = grids()
    Q = suggest_chunks(jg, X, kernel=kernel, tile=8, chunk=32, slack=1.3)
    je = jpal.PallasPackedInteraction(jg, kernel=kernel, tile=8, chunk=32,
                                      nchunks=Q, interpret=True)
    te = ci.PackedKernelInteraction(tg, kernel=kernel, tile=8, chunk=32,
                                    nchunks=Q, device="cpu")
    jb = je.buckets(jnp.asarray(X))
    return je, te, jb, convert.packed_buckets(jb, device="cpu")


def ref_packed_spread(je, jb, centering, coef, pallas=True):
    """The reference's packed spread program onto the grid: the Pallas
    program and its visited-tile mask, or (IB_6, or ``pallas=False``) the
    same sums in XLA."""
    geom, grid = je.geom, je.grid
    B = math.prod(geom.nblk)
    if je.kernel == "IB_6" or not pallas:
        A, W = jfast._tile_weights(geom, grid, jb, centering, je.kernel)
        Tq = jnp.einsum("qmp,qmz->qpz", A * coef[..., None], W,
                        precision=jax.lax.Precision.HIGHEST)
        T = jax.ops.segment_sum(Tq, jb.tile_of_chunk, num_segments=B)
    else:
        call = jpal._packed_spread_kernel_3d(
            geom, grid, _centering_offsets(grid, centering), je._phi, True)
        T = call(jb.tile_of_chunk, jb.Xb.astype(coef.dtype), coef, B)
        T = jnp.where(je._visited_mask(jb)[:, None, None], T, 0.0)
    return jfast._overlap_add(geom, grid, T.reshape(
        (B,) + tuple(geom.width) + (grid.n[2],)))


def ref_packed_interp(je, jb, centering, f, pallas=True):
    """The reference's packed interp program at every slot, from the
    extracted tiles: Pallas, or (IB_6, or ``pallas=False``) the same sums
    in XLA."""
    geom, grid = je.geom, je.grid
    T = jfast._extract_tiles(geom, grid, f)
    if je.kernel == "IB_6" or not pallas:
        A, W = jfast._tile_weights(geom, grid, jb, centering, je.kernel)
        D = jnp.einsum("qpz,qmz->qmp", jnp.take(T, jb.tile_of_chunk, axis=0),
                       W, precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(A * D, axis=-1)
    call = jpal._packed_interp_kernel_3d(
        geom, grid, _centering_offsets(grid, centering), je._phi, True)
    return call(jb.tile_of_chunk, jb.Xb.astype(f.dtype), T)[:, 0, :]


def coef_of(je, jb, F, centering):
    return (jfast.bucketed_channel(jb, jnp.asarray(F[:, centering]))
            * jb.wb.astype(F.dtype) / float(np.prod(je.grid.dx)))


def tile_case(kernel, X, cap=128):
    jg, tg = grids()
    je = jpal.PallasInteraction(jg, kernel=kernel, tile=8, cap=cap,
                                interpret=True)
    te = ci.TileKernelInteraction(tg, kernel=kernel, tile=8, cap=cap,
                                  device="cpu")
    jb = je.buckets(jnp.asarray(X))
    return je, te, jb, convert.buckets(jb, device="cpu")


def ref_tile_spread(je, jb, centering, coef, pallas=True):
    """The reference's tile spread program onto the grid: Pallas, or
    (IB_6, or ``pallas=False``) the same sums in XLA."""
    geom, grid = je.geom, je.grid
    if je.kernel == "IB_6" or not pallas:
        A, W = jfast._tile_weights(geom, grid, jb, centering, je.kernel)
        T = jnp.einsum("bmp,bmz->bpz", A * coef[..., None], W,
                       precision=jax.lax.Precision.HIGHEST)
    else:
        call = jpal._spread_kernel_3d(
            geom, grid, _centering_offsets(grid, centering), je._phi, True)
        T = call(jb.Xb.astype(coef.dtype), coef)
    return jfast._overlap_add(geom, grid, T.reshape(
        (T.shape[0],) + tuple(geom.width) + (grid.n[2],)))


def ref_tile_interp(je, jb, centering, f, pallas=True):
    """The reference's tile interp program at every slot: Pallas, or
    (IB_6, or ``pallas=False``) the same sums in XLA."""
    geom, grid = je.geom, je.grid
    T = jfast._extract_tiles(geom, grid, f)
    if je.kernel == "IB_6" or not pallas:
        A, W = jfast._tile_weights(geom, grid, jb, centering, je.kernel)
        D = jnp.einsum("bpz,bmz->bmp", T, W,
                       precision=jax.lax.Precision.HIGHEST)
        return jnp.sum(A * D, axis=-1)
    call = jpal._interp_kernel_3d(
        geom, grid, _centering_offsets(grid, centering), je._phi, True)
    return call(jb.Xb.astype(f.dtype), T)[:, 0, :]
