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
from ibamr_tpu_torch.parallel.spmd import Blocks, Mesh, P, all_to_all, smap
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver

Vel = Tuple[torch.Tensor, ...]


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

    def _enter(self, r, cdt):
        """A real block as the pencils' working dtype (complex: the
        transforms are FFTs)."""
        return r.to(cdt)

    def _leave(self, c, rdt):
        return c.real.to(rdt)

    def _fwd(self, c, d: int, L: int):
        """The forward transform of grid axis ``d`` (tensor dim d + L)."""
        return torch.fft.fft(c, dim=d + L)

    def _inv(self, c, d: int, L: int):
        return torch.fft.ifft(c, dim=d + L)

    def _extras(self, local, ctx, rdt):
        """Per-shard spectral tensors handed to ``op`` after the
        scalars (none for the FFT plans)."""
        return ()

    def _pencils(self, blocks, op: Callable, scalars, rdt, lead: int = 0):
        """The forward transforms, the pointwise ``op`` and the inverse
        transforms on the per-shard blocks -> per-shard real blocks.
        ``lead`` leading batch axes (stacked components) ride along.
        Each grid axis is transformed (``_fwd`` / ``_inv``) while it is
        local; ``op(sym, y, *scalars, *extras)`` sees the shard's slice
        of the symbol."""
        mesh, dim, L = self.mesh, self.grid.dim, lead
        axes, sizes, n = self.axes, self.sizes, self.grid.n
        cdt = torch.complex128 if rdt == torch.float64 else torch.complex64

        def fwd(c, d):
            return self._fwd(c, d, L)

        def inv(c, d):
            return self._inv(c, d, L)

        def tp(c, axis, split, concat, by=None, tiles=1):
            return self._transpose(c, axis, split + L, concat + L,
                                   None if by is None else by + L, tiles)

        if len(axes) == 1:
            ax = axes[0]
            tn = math.gcd(self.tiles, n[2]) if dim == 3 else 1
            by = 2 if dim == 3 else None

            def forward(ctx, r):
                c = self._enter(r, cdt)
                for d in range(1, dim):
                    c = fwd(c, d)
                return c

            def local(vecs, ctx):
                i = ctx.axis_index(ax)
                parts = [vecs[0].reshape((-1,) + (1,) * (dim - 1)),
                         _slice_for_shard(vecs[1], i, sizes[0]).reshape(
                             (1, -1) + (1,) * (dim - 2))]
                for d in range(2, dim):
                    parts.append(vecs[d].reshape(
                        (1,) * d + (-1,) + (1,) * (dim - 1 - d)))
                return sum(parts)

            def backward(ctx, c):
                for d in range(dim - 1, 0, -1):
                    c = inv(c, d)
                return self._leave(c, rdt)

        elif dim == 3:
            ax, ay = axes
            ta = math.gcd(self.tiles, n[0] // sizes[0])
            tb = math.gcd(self.tiles, n[2] // sizes[1])

            def local(vecs, ctx):
                ix, iy = ctx.axis_index(ax), ctx.axis_index(ay)
                return (vecs[0][:, None, None]
                        + _slice_for_shard(vecs[1], ix, sizes[0])[None, :,
                                                                  None]
                        + _slice_for_shard(vecs[2], iy, sizes[1])[None,
                                                                  None, :])
        else:
            # dim == 2, 2D mesh: both mesh axes flattened into one group
            ax, ay = axes
            ptot = sizes[0] * sizes[1]

            def local(vecs, ctx):
                i = ctx.axis_index((ax, ay))
                return (vecs[0][:, None]
                        + _slice_for_shard(vecs[1], i, ptot)[None, :])

        def solve(ctx, c):
            sym = local(self._lam(rdt, ctx.device), ctx)
            y = fwd(c, 0)
            y = op(sym, y, *scalars, *self._extras(local, ctx, rdt))
            return inv(y, 0)

        if len(axes) == 1:
            c = smap(forward, mesh, blocks)
            c = tp(c, ax, 1, 0, by, tn)
            c = smap(solve, mesh, c)
            c = tp(c, ax, 0, 1, by, tn)
            return smap(backward, mesh, c)

        if dim == 3:
            c = smap(lambda ctx, r: fwd(self._enter(r, cdt), 2), mesh,
                     blocks)
            c = tp(c, ay, 2, 1, 0, ta)                  # stage A
            c = smap(lambda ctx, c: fwd(c, 1), mesh, c)
            c = tp(c, ax, 1, 0, 2, tb)                  # stage B
            c = smap(solve, mesh, c)
            c = tp(c, ax, 0, 1, 2, tb)
            c = smap(lambda ctx, c: inv(c, 1), mesh, c)
            c = tp(c, ay, 1, 2, 0, ta)                  # stage C
            return smap(lambda ctx, c: self._leave(inv(c, 2), rdt), mesh, c)

        c = smap(lambda ctx, r: self._enter(r, cdt), mesh, blocks)
        c = tp(c, ay, 0, 1)          # unshard axis 1 by splitting axis 0
        c = smap(lambda ctx, c: fwd(c, 1), mesh, c)
        c = tp(c, (ax, ay), 1, 0)
        c = smap(solve, mesh, c)
        c = tp(c, (ax, ay), 0, 1)
        c = smap(lambda ctx, c: inv(c, 1), mesh, c)
        c = tp(c, ay, 1, 0)
        return smap(lambda ctx, c: self._leave(c, rdt), mesh, c)

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
        div = stencils.divergence(u, dx)
        if q is not None:
            div = div - q
        phi = self.poisson(div)
        g = stencils.gradient(phi, dx)
        return tuple(c - gc for c, gc in zip(u, g)), phi


def _helmholtz_op(sym, rhat, a, b):
    return rhat / (a + b * sym)


def _dense(x: torch.Tensor, M: torch.Tensor, dim: int) -> torch.Tensor:
    """``M`` (real) applied along ``dim`` of ``x`` at ``x``'s real dtype;
    a complex ``x`` (a wall axis reached after an FFT axis) takes it on
    its real and imaginary parts."""
    if x.is_complex():
        return torch.complex(_dense(x.real, M, dim), _dense(x.imag, M, dim))
    return FastDiagSolver._axis_matmul(x, M, dim)


class PencilFastDiag(PencilFFT):
    """``FastDiagSolver.solve`` through the pencils: every grid axis is
    transformed while it is local, by its own plan -- the dense
    eigenvector product ``V^T`` / ``V`` on a wall axis, the FFT on a
    periodic one -- and the symbol on each shard is the slice of every
    axis's eigenvalues its spectral block holds.

    A ``fc_pinned`` axis has n-1 unknowns (faces 1..n-1), which do not
    divide over shards: its ``V`` is embedded in an n x n transform that
    maps slot 0 to mode 0 alone (so the wall face's right-hand side
    never reaches the interior), mode 0 is zeroed in the spectral
    domain, and slot 0 comes back as the whole-grid solve's pinned 0.
    The null-space tolerance of ``zero_nullspace`` is the whole
    spectrum's (the sum of every axis's largest and smallest
    eigenvalue, in the field's dtype, as the whole-grid solve reduces
    its symbol), not a shard's. Where a wall axis is reached after an
    FFT axis its ``V`` acts on complex data. The dense sums run over
    blocks in another order than over the whole tensor, so the result
    equals ``FastDiagSolver.solve``'s to roundoff."""

    def __init__(self, solver: FastDiagSolver, mesh: Mesh, tiles: int = 2):
        super().__init__(solver.grid, mesh, tiles)
        self.solver = solver
        pinned = set(solver._pinned())
        self._mats, self._lam64, self._pin = [], [], []
        for d, plan in enumerate(solver.plans):
            n = int(solver.grid.n[d])
            pin = torch.zeros(n, dtype=torch.float64)
            if plan[0] == "fft":
                self._mats.append(None)
                lam = plan[1].detach().cpu().double()
            else:
                V = plan[1].detach().cpu().double()
                lam = plan[2].detach().cpu().double()
                if d in pinned:
                    full = torch.zeros((n, n), dtype=torch.float64)
                    full[0, 0] = 1.0
                    full[1:, 1:] = V
                    V, lam = full, torch.cat([lam[:1], lam])
                    pin[0] = 1.0
                self._mats.append(V)
            self._lam64.append(lam)
            self._pin.append(pin)
        self._complex = any(m is None for m in self._mats)
        self._any_pinned = bool(pinned)
        self._cache = {}

    def _on(self, rdt, device):
        """Per (dtype, device): each axis's (V, V^T), eigenvalues and
        pin vector, and the null-space tolerance."""
        key = (rdt, str(device))
        if key not in self._cache:
            mats = [None if V is None else
                    (V.to(device=device, dtype=rdt),
                     V.T.contiguous().to(device=device, dtype=rdt))
                    for V in self._mats]
            lams = [lam.to(device=device, dtype=rdt) for lam in self._lam64]
            pins = [p.to(device=device, dtype=rdt) for p in self._pin]
            hi = torch.zeros((), dtype=rdt, device=device)
            lo = torch.zeros((), dtype=rdt, device=device)
            for lam in lams:
                hi = hi + torch.max(lam)
                lo = lo + torch.min(lam)
            tol = float(1e-8 * torch.maximum(torch.abs(hi), torch.abs(lo)))
            self._cache[key] = (mats, lams, pins, tol)
        return self._cache[key]

    def _lam(self, rdt, device):
        return self._on(rdt, device)[1]

    def _enter(self, r, cdt):
        return r.to(cdt) if self._complex else r

    def _leave(self, c, rdt):
        return c.real.to(rdt) if c.is_complex() else c

    def _fwd(self, c, d: int, L: int):
        mats = self._on(_real_dtype(c), c.device)[0]
        if mats[d] is None:
            return torch.fft.fft(c, dim=d + L)
        return _dense(c, mats[d][1], d + L)

    def _inv(self, c, d: int, L: int):
        mats = self._on(_real_dtype(c), c.device)[0]
        if mats[d] is None:
            return torch.fft.ifft(c, dim=d + L)
        return _dense(c, mats[d][0], d + L)

    def _extras(self, local, ctx, rdt):
        if not self._any_pinned:
            return ()
        return (local(self._on(rdt, ctx.device)[2], ctx),)

    def op(self, zero_nullspace: bool) -> Callable:
        """The spectral division of ``FastDiagSolver.solve``, with the
        pinned modes zeroed."""
        def op(sym, y, a, b, *pin):
            denom = a + b * sym
            if zero_nullspace:
                tol = self._on(sym.dtype, sym.device)[3]
                null = torch.abs(denom) <= tol
                safe = torch.where(null, torch.ones_like(denom), denom)
                y = (y / safe).masked_fill(null, 0.0)
            else:
                y = y / denom
            if pin:
                y = y.masked_fill(pin[0] > 0, 0.0)
            return y

        return op

    def solve(self, rhs, alpha, beta, zero_nullspace: bool = False,
              lead: int = 0):
        """``FastDiagSolver.solve`` of ``rhs`` (Blocks in, Blocks out; a
        whole tensor is cut and the result assembled); ``lead`` leading
        axes are a batch of independent solves."""
        return self._spectral_apply(rhs, self.op(zero_nullspace), alpha,
                                    beta, lead=lead)


def _real_dtype(c: torch.Tensor) -> torch.dtype:
    return {torch.complex64: torch.float32,
            torch.complex128: torch.float64}.get(c.dtype, c.dtype)
