"""The halo pass of the block-resident sharded step
(``ibamr_tpu_torch/parallel/spmd.py``: ``Blocks``, ``halo_apply``,
``ghost_fill`` / ``halo_add``) on the CPU.

- Every stencil of the periodic INS step, taken from the block-resident
  integrator's own seams (convection for every scheme at its ghost width,
  the velocity Laplacian, the pressure gradient, the pressure Laplacian,
  the divergence) and the projection's divergence and gradient, on
  blocks equals the same stencil on the whole tensor BITWISE, on the
  (4,), (2, 2) and (4, 2) meshes, 2-D and 3-D periodic grids, with every
  per-shard body under ``spmd.audit_blocks``. One cell less of ghost
  than a scheme's width is not enough (the widths are the reaches).
- A ghost width beyond a block's extent raises.
- Cell-by-cell ops on blocks are bitwise the whole tensor's; whole
  reductions agree with the whole tensor's to roundoff and are bitwise
  run to run; ``halo_add`` is the adjoint of ``ghost_fill``.
"""

import numpy as np
import pytest
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.ops import convection, stencils
from ibamr_tpu_torch.parallel import spmd
from ibamr_tpu_torch.parallel.mesh import _block_fluid, grid_pspec, make_mesh

SCHEMES = ("centered", "upwind", "ppm", "cui")
# (shards, mesh axes): the (4,), (2, 2) and (4, 2) meshes
MESHES = ((4, 1), (4, 2), (8, 2))
SHAPES = ((16, 16), (16, 16, 16))


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _setup(shape, n_shards, axes, seed=0):
    mesh = make_mesh(n_shards, max_axes=axes, device="cpu")
    spec = grid_pspec(mesh, len(shape))
    rng = np.random.default_rng(seed)
    u = tuple(torch.tensor(rng.standard_normal(shape))
              for _ in range(len(shape)))
    p = torch.tensor(rng.standard_normal(shape))
    cut = [spmd.Blocks.cut(mesh, x, spec) for x in (*u, p)]
    return mesh, u, p, tuple(cut[:-1]), cut[-1]


def _same(got, want):
    if isinstance(want, tuple):
        assert isinstance(got, tuple) and len(got) == len(want)
        return all(_same(g, w) for g, w in zip(got, want))
    assert isinstance(got, spmd.Blocks)
    return torch.equal(got.assemble(), want)


def _integrators(shape, scheme):
    g = StaggeredGrid(n=shape, x_lo=(0.0,) * len(shape),
                      x_up=(1.0,) * len(shape))
    plain = INSStaggeredIntegrator(g, mu=0.02, convective_op_type=scheme,
                                   dtype=torch.float64, device="cpu")
    return g, plain


@pytest.mark.parametrize("shape", SHAPES, ids=["2d", "3d"])
@pytest.mark.parametrize("n_shards,axes", MESHES,
                         ids=["mesh4", "mesh2x2", "mesh4x2"])
def test_every_step_stencil_on_blocks_is_bitwise(shape, n_shards, axes):
    mesh, u, p, ub, pb = _setup(shape, n_shards, axes)
    g, plain = _integrators(shape, "centered")
    blk = _block_fluid(plain, mesh)
    dx = g.dx
    with spmd.audit_blocks() as audit:
        for scheme in SCHEMES:
            _, pl = _integrators(shape, scheme)
            bl = _block_fluid(pl, mesh)
            assert _same(bl._convective(ub, dx), pl._convective(u, dx)), \
                scheme
        assert _same(blk.laplacian_vel(ub, dx), plain.laplacian_vel(u, dx))
        assert _same(blk.pressure_gradient(pb, dx),
                     plain.pressure_gradient(p, dx))
        assert _same(blk.laplacian_cc(pb, dx), plain.laplacian_cc(p, dx))
        assert _same(blk.divergence(ub, dx), stencils.divergence(u, dx))
        # the projection's stencils and the stencils module's own forms
        halo = spmd.halo_stencil
        assert _same(halo(stencils.divergence, 1)(ub, dx),
                     stencils.divergence(u, dx))
        assert _same(halo(stencils.gradient, 1)(pb, dx),
                     stencils.gradient(p, dx))
        assert _same(halo(stencils.laplacian, 1)(pb, dx),
                     stencils.laplacian(p, dx))
        for scheme in ("centered", "upwind"):
            assert _same(halo(convection.convective_rate, 1)(
                ub, dx, scheme=scheme),
                convection.convective_rate(u, dx, scheme=scheme))
    assert audit["bodies"] > 0


@pytest.mark.parametrize("scheme", ["ppm", "cui"])
def test_ghost_width_is_the_schemes_reach(scheme):
    """The wide schemes' widths are needed: one layer less of ghost
    gives another result at the block edges."""
    mesh, u, _, ub, _ = _setup((16, 16, 16), 8, 2, seed=3)
    g, plain = _integrators((16, 16, 16), scheme)
    w = convection.GHOST_WIDTH[scheme]
    want = plain._convective(u, g.dx)
    ok = spmd.halo_stencil(plain._convective, w)(ub, g.dx)
    short = spmd.halo_stencil(plain._convective, w - 1)(ub, g.dx)
    assert _same(ok, want)
    assert not all(torch.equal(a.assemble(), b)
                   for a, b in zip(short, want))


def test_ghost_width_beyond_a_block_raises():
    """16 cells over 8 shards of one axis: blocks of 2 cells, thinner
    than PPM's ghost width 3."""
    mesh, u, _, ub, _ = _setup((16, 16), 8, 1)
    g, plain = _integrators((16, 16), "ppm")
    with pytest.raises(ValueError, match="ghost width 3 exceeds"):
        spmd.halo_stencil(plain._convective, 3)(ub, g.dx)
    with pytest.raises(ValueError, match="ghost width 3"):
        _block_fluid(plain, mesh)
    # centered (width 1) fits the same blocks
    assert _same(spmd.halo_stencil(convection.convective_rate, 1)(
        ub, g.dx), convection.convective_rate(u, g.dx))


def test_cell_ops_reductions_and_the_halo_adjoint():
    mesh, u, p, ub, pb = _setup((16, 16, 16), 8, 2, seed=1)
    c = torch.tensor(0.25, dtype=torch.float64)
    with spmd.audit_blocks():
        got = 2.0 * ub[0] - c * ub[1] / 3.0 + pb
        assert torch.equal(got.assemble(), 2.0 * u[0] - c * u[1] / 3.0 + p)
        w = torch.where(c > 0, torch.full_like(pb, 1.5), pb)
        assert torch.equal(w.assemble(), torch.full_like(p, 1.5))
        parts = [torch.sum(torch.square(ub[0])), torch.max(torch.abs(pb)),
                 torch.isfinite(pb).all()]
    again = [torch.sum(torch.square(ub[0])), torch.max(torch.abs(pb))]
    assert all(torch.equal(a, b) for a, b in zip(parts, again))
    assert float(parts[0]) == pytest.approx(float(torch.sum(u[0] ** 2)),
                                            rel=1e-14)
    assert torch.equal(parts[1], torch.max(torch.abs(p)))
    assert bool(parts[2])
    with pytest.raises(TypeError, match="not a per-block op"):
        torch.roll(pb, 1, 0)
    with pytest.raises(TypeError, match="0-dim tensors"):
        pb + p
    # <ghost_fill(x), y> == <x, halo_add(y)>
    rng = np.random.default_rng(2)
    xs = pb.blocks
    ext = list(xs)
    for d, axis in spmd.split_dims(pb.sharding, 3):
        ext = spmd.ghost_fill(mesh, ext, axis, d, 2)
    ys = [torch.tensor(rng.standard_normal(tuple(e.shape))) for e in ext]
    back = ys
    for d, axis in reversed(spmd.split_dims(pb.sharding, 3)):
        back = spmd.halo_add(mesh, back, axis, d, 2)
    lhs = sum(float(torch.sum(e * y)) for e, y in zip(ext, ys))
    rhs = sum(float(torch.sum(x * b)) for x, b in zip(xs, back))
    assert lhs == pytest.approx(rhs, rel=1e-12)
