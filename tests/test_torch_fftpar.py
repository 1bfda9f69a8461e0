"""Port parity of the pencil FFT (``ibamr_tpu_torch/parallel/fftpar.py``)
against ``ibamr_tpu``'s single-device spectral solves on the CPU at f64.

The same seeded fields go through the reference's
``solvers.fft.solve_poisson_periodic`` / ``solve_helmholtz_periodic`` /
``project_divergence_free`` and the port's ``PencilFFT`` on 2-, 4- and
8-shard meshes, 1D and 2D, on 16^2, 16^3 and 32x16x16 grids: within
1e-12 of the largest value. Every per-shard body runs under
``spmd.audit_blocks`` (a body that touches the global field or another
shard's block raises), the transposes' block order is held against
``lax.all_to_all`` in ``shard_map``, the result does not depend on
``tiles`` (bitwise), and the divisibility checks raise the reference's
messages."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import PartitionSpec as JP

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.parallel.fftpar import PencilFFT as JPencil
from ibamr_tpu.parallel.mesh import make_mesh as jmake_mesh
from ibamr_tpu.solvers import fft as jfft
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.parallel import spmd
from ibamr_tpu_torch.parallel.fftpar import PencilFFT
from ibamr_tpu_torch.parallel.mesh import make_mesh

TOL = 1e-12

try:                        # jax >= 0.6 promotes shard_map to the top level
    from jax import shard_map
except ImportError:
    from jax.experimental.shard_map import shard_map


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grids(shape):
    dim = len(shape)
    lo, hi = (0.0,) * dim, (1.0,) * dim
    return JGrid(n=shape, x_lo=lo, x_up=hi), StaggeredGrid(n=shape, x_lo=lo,
                                                           x_up=hi)


def _close(got, want):
    want = np.asarray(want)
    err = np.abs(got.numpy() - want).max()
    assert err <= TOL * np.abs(want).max(), err


CASES = [((16, 16), 4, 1), ((16, 16), 4, 2), ((16, 16, 16), 8, 2),
         ((16, 16, 16), 2, 1), ((32, 16, 16), 4, 1), ((32, 16, 16), 8, 2)]


@pytest.mark.parametrize("shape,n_shards,axes", CASES)
def test_pencil_solves_match_reference(shape, n_shards, axes):
    jg, g = _grids(shape)
    mesh = make_mesh(n_shards, max_axes=axes, device="cpu")
    rng = np.random.default_rng(sum(shape) + n_shards)
    rhs = rng.standard_normal(shape)
    u = tuple(rng.standard_normal(shape) for _ in shape)
    pencil = PencilFFT(g, mesh)
    with spmd.audit_blocks() as audit:
        p = pencil.poisson(torch.tensor(rhs))
        h = pencil.helmholtz_vel(tuple(torch.tensor(c) for c in u), g.dx,
                                 alpha=10.0, beta=-0.05)
        up, phi = pencil.project_divergence_free(
            tuple(torch.tensor(c) for c in u), g.dx)
    assert audit["bodies"] > 0
    _close(p, jfft.solve_poisson_periodic(jnp.asarray(rhs), jg.dx))
    hj = jfft.solve_helmholtz_periodic_vel(
        tuple(jnp.asarray(c) for c in u), jg.dx, 10.0, -0.05)
    for a, b in zip(h, hj):
        _close(a, b)
    upj, phij = jfft.project_divergence_free(
        tuple(jnp.asarray(c) for c in u), jg.dx)
    for a, b in zip(up, upj):
        _close(a, b)
    _close(phi, phij)


@pytest.mark.parametrize("axes,tiles", [(1, 2), (1, 4), (2, 2), (2, 4)])
def test_tiles_do_not_change_the_bits(axes, tiles):
    _, g = _grids((16, 16, 8))
    mesh = make_mesh(8 if axes == 2 else 4, max_axes=axes, device="cpu")
    rhs = torch.tensor(np.random.default_rng(3).standard_normal((16, 16, 8)))
    one = PencilFFT(g, mesh, tiles=1).helmholtz(rhs, 10.0, -0.05)
    many = PencilFFT(g, mesh, tiles=tiles).helmholtz(rhs, 10.0, -0.05)
    assert torch.equal(one, many)


def test_a_body_reading_the_global_field_raises():
    _, g = _grids((16, 16))
    mesh = make_mesh(4, device="cpu")
    f = torch.ones(16, 16, dtype=torch.float64)
    with spmd.audit_blocks():
        blocks = spmd.shard(mesh, f, spmd.P("x", "y"))
        spmd.smap(lambda ctx, b: b * 2, mesh, blocks)
        with pytest.raises(spmd.BlockLeakError):
            spmd.smap(lambda ctx, b: b + f[:8, :8], mesh, blocks)
        with pytest.raises(spmd.BlockLeakError):
            spmd.smap(lambda ctx, b: b + blocks[(ctx.index + 1) % 4],
                      mesh, blocks)


@pytest.mark.parametrize("axes", [1, 2])
def test_collectives_match_lax(axes):
    """all_to_all (both split/concat orders, a flattened axis group),
    ppermute and psum on the port's mesh equal lax's in shard_map on the
    reference's 8-device mesh, block for block."""
    jm = jmake_mesh(8, max_axes=axes)
    tm = make_mesh(8, max_axes=axes, device="cpu")
    names = jm.axis_names
    spec = JP(*names) if axes == 2 else JP(names[0], None)
    x = np.random.default_rng(5).standard_normal(
        (16, 16) if axes == 2 else (64, 16))
    ax = names[-1]
    grp = tuple(names) if axes == 2 else names[0]
    P0 = jm.shape[ax]
    perm = [(i, (i + 1) % P0) for i in range(P0)]

    def body(b):
        return (jax.lax.all_to_all(b, ax, 1, 0, tiled=True),
                jax.lax.all_to_all(b, ax, 0, 1, tiled=True),
                jax.lax.all_to_all(b, grp, 1, 0, tiled=True),
                jax.lax.ppermute(b, ax, perm=perm),
                jax.lax.psum(b, ax))

    want = jax.jit(shard_map(body, mesh=jm, in_specs=(spec,),
                             out_specs=(spec,) * 5))(jnp.asarray(x))
    tspec = spmd.P(*names) if axes == 2 else spmd.P(names[0], None)
    blocks = spmd.shard(tm, torch.tensor(x), tspec)
    got = [spmd.all_to_all(tm, blocks, ax, 1, 0),
           spmd.all_to_all(tm, blocks, ax, 0, 1),
           spmd.all_to_all(tm, blocks, grp, 1, 0),
           spmd.ppermute(tm, blocks, ax, perm),
           spmd.psum(tm, blocks, ax)]
    for g_, w in zip(got, want):
        np.testing.assert_array_equal(
            spmd.unshard(tm, g_, tspec).numpy(), np.asarray(w))


def test_divisibility_errors_match_reference():
    for shape, axes in (((12, 16), 1), ((16, 12), 1), ((16, 18, 16), 2),
                        ((12, 12), 2)):
        jg, g = _grids(shape)
        with pytest.raises(ValueError) as je:
            JPencil(jg, jmake_mesh(8, max_axes=axes))
        with pytest.raises(ValueError) as te:
            PencilFFT(g, make_mesh(8, max_axes=axes, device="cpu"))
        assert str(te.value) == str(je.value)
    with pytest.raises(ValueError, match="tiles"):
        PencilFFT(_grids((16, 16))[1], make_mesh(4, device="cpu"), tiles=0)
