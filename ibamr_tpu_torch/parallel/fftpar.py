"""Pencil-decomposed distributed FFT Poisson/Helmholtz solvers (port of
``ibamr_tpu/parallel/fftpar.py``).

Scheme (classic pencil transpose), as the reference's: FFT the locally
complete trailing axes of each shard's block, then for each sharded axis
transpose it against an already transformed axis with an all-to-all and
FFT it locally; apply the (sliced) discrete Laplacian symbol; mirror the
transposes back. The local FFTs are ``torch.fft`` calls (cuFFT on the
card) on each shard's block; the transposes are
:func:`~ibamr_tpu_torch.parallel.spmd.all_to_all` with the reference's
``split_axis`` / ``concat_axis`` block order.

Supported decompositions (grid axes sharded left to right by the mesh
axes): 2D or 3D grid x 1D mesh; 3D grid x 2D mesh (true pencils); 2D
grid x 2D mesh (both mesh axes flattened into one transpose group).

``tiles``: where the reference software-pipelines each 3D pencil stage
along a bystander axis (an axis the stage's transpose and FFT never
touch), the port moves each of that stage's transposes in ``tiles``
pieces along the bystander axis, one after another. The FFTs and the
symbol run on whole blocks, so the result is bitwise independent of
``tiles``.
"""

from __future__ import annotations

import math
from typing import Callable, Tuple

import numpy as np
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import stencils
from ibamr_tpu_torch.parallel.mesh import grid_pspec
from ibamr_tpu_torch.parallel.spmd import (Blocks, Mesh, P, all_to_all,
                                           halo_stencil, smap)

Vel = Tuple[torch.Tensor, ...]

# the projection's stencils on blocks (radius 1)
_halo_divergence = halo_stencil(stencils.divergence, 1)
_halo_gradient = halo_stencil(stencils.gradient, 1)


def _axis_symbol(n: int, h: float, dtype, device) -> torch.Tensor:
    """Eigenvalues of the 1D discrete periodic Laplacian, full-spectrum
    (fft, not rfft) ordering: (2 cos(2 pi k / n) - 2) / h^2."""
    k = np.fft.fftfreq(n)
    lam = (2.0 * np.cos(2.0 * math.pi * k) - 2.0) / (h * h)
    return torch.as_tensor(lam).to(device=device, dtype=dtype)


def _slice_for_shard(lam: torch.Tensor, idx: int, count: int
                     ) -> torch.Tensor:
    size = lam.shape[0] // count
    return lam[idx * size:(idx + 1) * size]


class PencilFFT:
    """Distributed spectral solver bound to one (grid, mesh) pair.

    ``op(sym, rhat, *scalars)`` runs pointwise in the spectral domain on
    each shard's pencil.
    """

    def __init__(self, grid: StaggeredGrid, mesh: Mesh, tiles: int = 2):
        self.grid = grid
        self.mesh = mesh
        if tiles < 1:
            raise ValueError(f"tiles must be >= 1, got {tiles}")
        self.tiles = tiles
        dim = grid.dim
        axes = tuple(mesh.axis_names)
        sizes = tuple(mesh.shape[a] for a in axes)
        if len(axes) > dim:
            raise ValueError("mesh has more axes than the grid")
        n = grid.n
        for d, (name, p) in enumerate(zip(axes, sizes)):
            if n[d] % p != 0:
                raise ValueError(
                    f"grid axis {d} ({n[d]}) not divisible by mesh axis "
                    f"{name!r} ({p})")
        if dim == 2 and len(axes) == 2:
            ptot = sizes[0] * sizes[1]
            if n[0] % ptot or n[1] % ptot:
                raise ValueError("2D grid on 2D mesh needs n % (Px*Py) == 0")
        elif dim == 3 and len(axes) == 2:
            if n[2] % sizes[1] or n[1] % sizes[0]:
                raise ValueError(
                    "3D pencil needs n[2] % Py == 0 and n[1] % Px == 0")
        elif len(axes) == 1 and dim >= 2:
            if n[1] % sizes[0]:
                raise ValueError("1D pencil needs n[1] % P == 0")
        self.axes = axes
        self.sizes = sizes
        self.spec = grid_pspec(mesh, dim)
        self._lams = {}

    # -- pieces --------------------------------------------------------------
    def _lam(self, rdt, device):
        key = (rdt, str(device))
        if key not in self._lams:
            self._lams[key] = [_axis_symbol(self.grid.n[d], self.grid.dx[d],
                                            rdt, device)
                               for d in range(self.grid.dim)]
        return self._lams[key]

    def _transpose(self, blocks, axis, split_axis: int, concat_axis: int,
                   bystander=None, tiles: int = 1):
        """One pencil transpose; with ``tiles > 1`` moved in that many
        pieces along the ``bystander`` axis (copies only: the same
        bits)."""
        if bystander is None or tiles <= 1:
            return all_to_all(self.mesh, blocks, axis, split_axis,
                              concat_axis)
        parts = smap(lambda ctx, b: torch.chunk(b, tiles, dim=bystander),
                     self.mesh, blocks)
        moved = [all_to_all(self.mesh, [p[t] for p in parts], axis,
                            split_axis, concat_axis) for t in range(tiles)]
        return smap(lambda ctx, *ps: torch.cat(ps, dim=bystander),
                    self.mesh, *moved)

    def _pencils(self, blocks, op: Callable, scalars, rdt, lead: int = 0):
        """The forward transforms, the pointwise ``op`` and the inverse
        transforms on the per-shard blocks -> per-shard real blocks.
        ``lead`` leading batch axes (stacked components) ride along."""
        mesh, dim, L = self.mesh, self.grid.dim, lead
        axes, sizes, n = self.axes, self.sizes, self.grid.n
        cdt = torch.complex128 if rdt == torch.float64 else torch.complex64
        fft, ifft = torch.fft.fft, torch.fft.ifft

        def tp(c, axis, split, concat, by=None, tiles=1):
            return self._transpose(c, axis, split + L, concat + L,
                                   None if by is None else by + L, tiles)

        if len(axes) == 1:
            ax = axes[0]
            tn = math.gcd(self.tiles, n[2]) if dim == 3 else 1
            by = 2 if dim == 3 else None

            def forward(ctx, r):
                c = r.to(cdt)
                for d in range(1, dim):
                    c = fft(c, dim=d + L)
                return c

            def solve(ctx, c):
                i = ctx.axis_index(ax)
                lam = self._lam(rdt, ctx.device)
                parts = [lam[0].reshape((-1,) + (1,) * (dim - 1)),
                         _slice_for_shard(lam[1], i, sizes[0]).reshape(
                             (1, -1) + (1,) * (dim - 2))]
                for d in range(2, dim):
                    parts.append(lam[d].reshape(
                        (1,) * d + (-1,) + (1,) * (dim - 1 - d)))
                y = fft(c, dim=L)
                y = op(sum(parts), y, *scalars)
                return ifft(y, dim=L)

            def backward(ctx, c):
                for d in range(dim - 1, 0, -1):
                    c = ifft(c, dim=d + L)
                return c.real.to(rdt)

            c = smap(forward, mesh, blocks)
            c = tp(c, ax, 1, 0, by, tn)
            c = smap(solve, mesh, c)
            c = tp(c, ax, 0, 1, by, tn)
            return smap(backward, mesh, c)

        ax, ay = axes
        if dim == 3:
            ta = math.gcd(self.tiles, n[0] // sizes[0])
            tb = math.gcd(self.tiles, n[2] // sizes[1])

            def solve(ctx, c):
                ix, iy = ctx.axis_index(ax), ctx.axis_index(ay)
                lam = self._lam(rdt, ctx.device)
                sym = (lam[0][:, None, None]
                       + _slice_for_shard(lam[1], ix, sizes[0])[None, :, None]
                       + _slice_for_shard(lam[2], iy, sizes[1])[None, None, :])
                y = fft(c, dim=L)
                y = op(sym, y, *scalars)
                return ifft(y, dim=L)

            c = smap(lambda ctx, r: fft(r.to(cdt), dim=2 + L), mesh, blocks)
            c = tp(c, ay, 2, 1, 0, ta)                  # stage A
            c = smap(lambda ctx, c: fft(c, dim=1 + L), mesh, c)
            c = tp(c, ax, 1, 0, 2, tb)                  # stage B
            c = smap(solve, mesh, c)
            c = tp(c, ax, 0, 1, 2, tb)
            c = smap(lambda ctx, c: ifft(c, dim=1 + L), mesh, c)
            c = tp(c, ay, 1, 2, 0, ta)                  # stage C
            return smap(lambda ctx, c: ifft(c, dim=2 + L).real.to(rdt),
                        mesh, c)

        # dim == 2, 2D mesh: both mesh axes flattened into one group
        ptot = sizes[0] * sizes[1]

        def solve(ctx, c):
            i = ctx.axis_index((ax, ay))
            lam = self._lam(rdt, ctx.device)
            sym = lam[0][:, None] + _slice_for_shard(lam[1], i, ptot)[None, :]
            y = fft(c, dim=L)
            y = op(sym, y, *scalars)
            return ifft(y, dim=L)

        c = smap(lambda ctx, r: r.to(cdt), mesh, blocks)
        c = tp(c, ay, 0, 1)          # unshard axis 1 by splitting axis 0
        c = smap(lambda ctx, c: fft(c, dim=1 + L), mesh, c)
        c = tp(c, (ax, ay), 1, 0)
        c = smap(solve, mesh, c)
        c = tp(c, (ax, ay), 0, 1)
        c = smap(lambda ctx, c: ifft(c, dim=1 + L), mesh, c)
        c = tp(c, ay, 1, 0)
        return smap(lambda ctx, c: c.real.to(rdt), mesh, c)

    def _solve_blocks(self, blocks, op: Callable, scalars, lead: int = 0):
        """The pencil solve of per-shard blocks -> per-shard blocks."""
        rdt = blocks[0].dtype
        scalars = tuple(torch.as_tensor(s, dtype=rdt, device=blocks[0].device)
                        if isinstance(s, torch.Tensor) else float(s)
                        for s in scalars)
        return self._pencils(blocks, op, scalars, rdt, lead)

    def _spectral_apply(self, rhs, op: Callable, *scalars, lead: int = 0):
        """``op`` applied in the spectral domain: Blocks in, Blocks out;
        a whole tensor (the pinned families) is cut into blocks and the
        result assembled on its device."""
        if isinstance(rhs, Blocks):
            return rhs.like(self._solve_blocks(rhs.blocks, op, scalars,
                                               lead))
        spec = P(*([None] * lead), *self.spec)
        x = Blocks.cut(self.mesh, rhs, spec)
        return x.like(self._solve_blocks(x.blocks, op, scalars, lead)
                      ).assemble(rhs.device)

    def _cut(self, x):
        return None if x is None else Blocks.cut(self.mesh, x, self.spec)

    # -- public solves -------------------------------------------------------
    def poisson(self, rhs):
        """Zero-mean solution of lap(p) = rhs (periodic)."""
        def op(sym, rhat):
            safe = torch.where(sym == 0, torch.ones_like(sym), sym)
            return torch.where(sym == 0, torch.zeros_like(rhat),
                               rhat / safe)

        return self._spectral_apply(rhs, op)

    def helmholtz(self, rhs, alpha, beta, lead: int = 0):
        """Solve (alpha + beta lap) u = rhs; ``lead`` leading axes of
        ``rhs`` are a batch of independent solves."""
        return self._spectral_apply(rhs, _helmholtz_op, alpha, beta,
                                    lead=lead)

    def helmholtz_cc(self, rhs: torch.Tensor, dx, alpha, beta
                     ) -> torch.Tensor:
        """Drop-in for ``solvers.fft.solve_helmholtz_periodic`` (dx is
        carried by the bound grid; accepted for signature parity)."""
        return self.helmholtz(rhs, alpha, beta)

    def helmholtz_vel(self, rhs: Vel, dx, alpha, beta) -> Vel:
        """Drop-in for ``solvers.fft.solve_helmholtz_periodic_vel``: the
        components go through the pencils together, one stacked batch a
        shard. Blocks in, Blocks out; whole tensors are cut and the
        results assembled."""
        if not isinstance(rhs[0], Blocks):
            out = self.helmholtz_vel(tuple(self._cut(c) for c in rhs), dx,
                                     alpha, beta)
            return tuple(c.assemble(r.device) for c, r in zip(out, rhs))
        ref = rhs[0]
        stacked = smap(lambda ctx, *c: torch.stack(c), self.mesh,
                       *[c.blocks for c in rhs])
        out = self._solve_blocks(stacked, _helmholtz_op, (alpha, beta),
                                 lead=1)
        return tuple(ref.like([o[k] for o in out]) for k in range(len(rhs)))

    def project_divergence_free(self, u: Vel, dx, q=None):
        """Drop-in for ``solvers.fft.project_divergence_free``: the
        divergence and the gradient as halo stencils, the Poisson solve
        through the pencils. Blocks in, Blocks out; whole tensors are cut
        and the results assembled."""
        if not isinstance(u[0], Blocks):
            out, phi = self.project_divergence_free(
                tuple(self._cut(c) for c in u), dx, self._cut(q))
            dev = u[0].device
            return tuple(c.assemble(dev) for c in out), phi.assemble(dev)
        div = _halo_divergence(u, dx)
        if q is not None:
            div = div - q
        phi = self.poisson(div)
        g = _halo_gradient(phi, dx)
        return tuple(c - gc for c, gc in zip(u, g)), phi


def _helmholtz_op(sym, rhat, a, b):
    return rhat / (a + b * sym)
