"""Port parity of ``integrators/ibfe.py`` at f64: ``spread_force`` and
``interpolate_velocity`` of ``IBFEMethod`` and ``IBFESurfaceMethod``,
nodal and unified, ``transfer_level`` 0 and 1, against the reference
within 1e-10 of max|ref|: in 2D through the scatter oracle, in 3D also
with ``fast=`` the port's ``packed`` engine against the reference's
``PackedInteraction`` and with the kernel engines' plain versions; a
10-step ``build_fe_disc_example`` trajectory (32^2, 4 rings) for both
couplings; the shared grid guard ``check_fast_grid``; in 2D with
``fast=`` each torch-op engine (``mxu``, ``packed``, ``packed3``) against
the reference's engine of the same family and its scatter oracle, within
1e-10 of max|ref|."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.fe import fem as jf
from ibamr_tpu.fe import mesh as jm
from ibamr_tpu.fe import surface as js
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ib as jib
from ibamr_tpu.integrators import ibfe as jibfe
from ibamr_tpu.models.fe_disc2d import build_fe_disc_example as jdisc
from ibamr_tpu.ops.interaction_packed import PackedInteraction as JPacked
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.fe import fem as tf
from ibamr_tpu_torch.fe import surface as ts
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ib as tib
from ibamr_tpu_torch.integrators import ibfe as tibfe
from ibamr_tpu_torch.models.fe_disc2d import build_fe_disc_example as tdisc
from ibamr_tpu_torch.ops.cuda_interaction import (PackedKernelInteraction,
                                                  TileKernelInteraction)
from ibamr_tpu_torch.ops.interaction_packed import PackedInteraction

TOL = 1e-10


def _close(ref, got, tol=TOL):
    ref = np.asarray(ref, dtype=float)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-300)


def _grids(n, dim):
    kw = dict(n=(n,) * dim, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    return JGrid(**kw), TGrid(**kw)


def _transfer_pair(jmeth, tmeth, jgrid, tgrid, X, seed):
    """Both methods' spread of a random nodal force and interp of a random
    MAC field at the nodal positions X (with a mask that drops one node)."""
    rng = np.random.default_rng(seed)
    F = rng.standard_normal(X.shape)
    u = [rng.standard_normal(jgrid.n) for _ in range(len(jgrid.n))]
    mask = np.ones(X.shape[0])
    mask[1] = 0.0
    tX, tm_ = torch.tensor(X), torch.tensor(mask)

    @jax.jit
    def reference(X, mask, F, u):
        ctx = jmeth.prepare(X, mask)
        return (jmeth.spread_force(F, jgrid, X, mask, ctx=ctx),
                jmeth.interpolate_velocity(u, jgrid, X, mask, ctx=ctx))

    fj, Uj = reference(jnp.asarray(X), jnp.asarray(mask), jnp.asarray(F),
                       tuple(jnp.asarray(c) for c in u))
    tctx = tmeth.prepare(tX, tm_)
    ft = tmeth.spread_force(torch.tensor(F), tgrid, tX, tm_, ctx=tctx)
    for a, b in zip(fj, ft):
        _close(a, b)
    Ut = tmeth.interpolate_velocity(tuple(torch.tensor(c) for c in u), tgrid,
                                    tX, tm_, ctx=tctx)
    _close(Uj, Ut)
    return ft, Ut


@pytest.mark.parametrize("coupling,level", [("nodal", 0), ("unified", 0),
                                            ("unified", 1)])
def test_volume_transfers_2d_match_reference(coupling, level):
    jgrid, tgrid = _grids(32, 2)
    mesh = jm.disc_mesh(n_rings=3, radius=0.2)
    kw = dict(coupling=coupling, transfer_level=level)
    jmeth = jibfe.IBFEMethod(mesh, jf.neo_hookean(1.0, 4.0),
                             dtype=jnp.float64, **kw)
    tmeth = tibfe.IBFEMethod(convert.fe_mesh(mesh), tf.neo_hookean(1.0, 4.0),
                             dtype=torch.float64, device="cpu", **kw)
    X = mesh.nodes @ np.array([[1.2, 0.1], [0.0, 0.9]]) + 0.05
    _transfer_pair(jmeth, tmeth, jgrid, tgrid, X, 1)
    zero = np.zeros_like(X)
    _close(jmeth.compute_force(jnp.asarray(X), jnp.asarray(zero), 0.0),
           tmeth.compute_force(torch.tensor(X), torch.tensor(zero), 0.0))
    _close(jmeth.current_volume(jnp.asarray(X)),
           tmeth.current_volume(torch.tensor(X)), 1e-13)
    _close(jmeth.energy(jnp.asarray(X)), tmeth.energy(torch.tensor(X)), 1e-13)


@pytest.mark.parametrize("coupling", ["nodal", "unified"])
def test_surface_transfers_2d_match_reference(coupling):
    jgrid, tgrid = _grids(32, 2)
    ring = js.ring_mesh(n=40, radius=0.2, aspect=1.2)
    kw = dict(coupling=coupling, damping=0.3)
    jmeth = jibfe.IBFESurfaceMethod(ring, js.neo_hookean_membrane(1.0, 2.0),
                                    dtype=jnp.float64, **kw)
    tmeth = tibfe.IBFESurfaceMethod(convert.surface_mesh(ring),
                                    ts.neo_hookean_membrane(1.0, 2.0),
                                    dtype=torch.float64, device="cpu", **kw)
    X = ring.nodes * 1.1 - 0.03
    _transfer_pair(jmeth, tmeth, jgrid, tgrid, X, 2)
    U = np.random.default_rng(3).standard_normal(X.shape)
    _close(jmeth.compute_force(jnp.asarray(X), jnp.asarray(U), 0.0),
           tmeth.compute_force(torch.tensor(X), torch.tensor(U), 0.0))
    _close(jmeth.current_area(jnp.asarray(X)),
           tmeth.current_area(torch.tensor(X)), 1e-13)


def _sphere_methods(coupling, t_engine, j_engine):
    mesh = js.sphere_surface_mesh(center=(0.5, 0.5, 0.5), radius=0.25,
                                  n_subdiv=2)
    W = (js.neo_hookean_membrane(1.0, 2.0), ts.neo_hookean_membrane(1.0, 2.0))
    jmeth = jibfe.IBFESurfaceMethod(mesh, W[0], coupling=coupling,
                                    dtype=jnp.float64, fast=j_engine)
    tmeth = tibfe.IBFESurfaceMethod(convert.surface_mesh(mesh), W[1],
                                    coupling=coupling, dtype=torch.float64,
                                    fast=t_engine, device="cpu")
    return mesh, jmeth, tmeth


@pytest.mark.parametrize("coupling", ["nodal", "unified"])
def test_surface_3d_packed_engine_matches_reference_packed(coupling):
    jgrid, tgrid = _grids(16, 3)
    mesh, jmeth, tmeth = _sphere_methods(
        coupling, PackedInteraction(tgrid, nchunks=64, device="cpu"),
        JPacked(jgrid, nchunks=64))
    X = 0.5 + (mesh.nodes - 0.5) * np.array([1.1, 0.95, 1.0])
    _transfer_pair(jmeth, tmeth, jgrid, tgrid, X, 4)


@pytest.mark.parametrize("engine", ["pallas_packed", "pallas"])
def test_surface_3d_kernel_engines_match_oracle(engine):
    """The kernel engines on the FE quad cloud (their plain versions on
    the CPU) against the reference's scatter oracle."""
    jgrid, tgrid = _grids(16, 3)
    eng = (PackedKernelInteraction(tgrid, nchunks=64, device="cpu")
           if engine == "pallas_packed"
           else TileKernelInteraction(tgrid, cap=128, device="cpu"))
    mesh, jmeth, tmeth = _sphere_methods("unified", eng, None)
    X = 0.5 + (mesh.nodes - 0.5) * np.array([1.0, 1.05, 0.9])
    _transfer_pair(jmeth, tmeth, jgrid, tgrid, X, 5)


def test_volume_3d_packed_engine_matches_reference_packed():
    jgrid, tgrid = _grids(16, 3)
    mesh = jm.block_mesh_tet(2, 2, 2, x_lo=(0.3,) * 3, x_up=(0.7,) * 3)
    kw = dict(coupling="unified", transfer_level=1)
    jmeth = jibfe.IBFEMethod(mesh, jf.stvk(1.0, 2.0), dtype=jnp.float64,
                             fast=JPacked(jgrid, nchunks=64), **kw)
    tmeth = tibfe.IBFEMethod(convert.fe_mesh(mesh), tf.stvk(1.0, 2.0),
                             dtype=torch.float64,
                             fast=PackedInteraction(tgrid, nchunks=64,
                                                    device="cpu"),
                             device="cpu", **kw)
    _transfer_pair(jmeth, tmeth, jgrid, tgrid, mesh.nodes + 0.01, 6)


@pytest.mark.parametrize("coupling", ["unified", "nodal"])
def test_fe_disc_trajectory_matches_reference(coupling):
    kw = dict(n_cells=32, n_rings=4, stretch=1.3, coupling=coupling)
    ji, jst = jdisc(dtype=jnp.float64, **kw)
    ti, tst = tdisc(dtype=torch.float64, device="cpu", **kw)
    step = jax.jit(lambda s: ji.step(s, 2e-3))
    for _ in range(10):
        jst = step(jst)
        tst = ti.step(tst, 2e-3)
    _close(jst.X, tst.X)
    _close(np.asarray(jst.X) - np.asarray(ji.ib.mesh.nodes) @ np.diag(
        [1.3, 1 / 1.3]), tst.X.numpy() - ti.ib.mesh.nodes @ np.diag(
        [1.3, 1 / 1.3]), 1e-8)
    _close(jst.U, tst.U)
    for a, b in zip(jst.ins.u, tst.ins.u):
        _close(a, b)
    _close(jst.ins.p, tst.ins.p)


def test_direct_forcing_wraps_any_strategy():
    mesh = jm.disc_mesh(n_rings=2)
    X0 = mesh.nodes
    jbase = jibfe.IBFEMethod(mesh, jf.neo_hookean(1.0, 4.0),
                             dtype=jnp.float64)
    tbase = tibfe.IBFEMethod(convert.fe_mesh(mesh), tf.neo_hookean(1.0, 4.0),
                             dtype=torch.float64, device="cpu")
    jdf = jibfe.DirectForcingKinematics(
        jbase, lambda t: jnp.asarray(X0) + t, kappa=50.0, eta=2.0)
    tdf = tibfe.DirectForcingKinematics(
        tbase, lambda t: torch.tensor(X0) + t, kappa=50.0, eta=2.0)
    X = X0 * 1.05
    U = np.full(X.shape, 0.1)
    _close(jdf.compute_force(jnp.asarray(X), jnp.asarray(U), 0.2),
           tdf.compute_force(torch.tensor(X), torch.tensor(U), 0.2))
    assert tdf.coupling == "unified" and tdf.prepare(torch.tensor(X),
                                                     None) is None
    assert getattr(tdf, "refresh", None) is None


def test_check_fast_grid_error_matches_reference():
    jgrid, tgrid = _grids(16, 3)
    kw = dict(n=(16,) * 3, x_lo=(0.0,) * 3, x_up=(2.0,) * 3)
    eng = PackedInteraction(TGrid(**kw), device="cpu")
    with pytest.raises(ValueError) as ref:
        jib.check_fast_grid(JPacked(JGrid(**kw)), jgrid)
    with pytest.raises(ValueError) as got:
        tib.check_fast_grid(eng, tgrid)
    assert str(got.value) == str(ref.value)
    tib.check_fast_grid(eng, TGrid(**kw))
    tib.check_fast_grid(object(), tgrid)     # an engine with no grid
    mesh, _, tmeth = _sphere_methods("unified", eng, None)
    X = torch.tensor(mesh.nodes)
    with pytest.raises(ValueError, match="rebuild the engine"):
        tmeth.spread_force(X, tgrid, X, torch.ones(X.shape[0],
                                                   dtype=torch.float64))


def test_2d_engine_and_kernel_mismatch_raise():
    # a 2D structure takes a 2D engine (the transfers: the next test);
    # a kernel mismatch still raises
    eng = PackedInteraction(TGrid(n=(16,) * 3, x_lo=(0.0,) * 3,
                                  x_up=(1.0,) * 3), device="cpu")
    mesh = convert.fe_mesh(jm.disc_mesh(n_rings=2))
    eng2 = PackedInteraction(TGrid(n=(16,) * 2, x_lo=(0.0,) * 2,
                                   x_up=(1.0,) * 2), device="cpu")
    assert tibfe.IBFEMethod(mesh, tf.neo_hookean(1.0, 1.0), fast=eng2,
                            device="cpu").fast is eng2
    with pytest.raises(ValueError, match="kernel"):
        tibfe.IBFEMethod(mesh, tf.neo_hookean(1.0, 1.0), kernel="IB_6",
                         fast=eng2, device="cpu")
    sph = ts.sphere_surface_mesh(n_subdiv=1)
    with pytest.raises(ValueError, match="kernel"):
        tibfe.IBFESurfaceMethod(sph, ts.neo_hookean_membrane(1.0, 1.0),
                                kernel="IB_6", fast=eng, device="cpu")
    with pytest.raises(ValueError, match="transfer_level"):
        tibfe.IBFEMethod(mesh, tf.neo_hookean(1.0, 1.0), coupling="nodal",
                         transfer_level=1, device="cpu")


def _engines_2d(engine, n):
    """The reference's and the port's 2D engine of one family on an n^2
    grid, sized for the FE clouds below."""
    from ibamr_tpu.ops.interaction_fast import FastInteraction as JFast
    from ibamr_tpu.ops.interaction_packed3 import PackedInteraction3 as JP3
    from ibamr_tpu_torch.ops.interaction_fast import FastInteraction
    from ibamr_tpu_torch.ops.interaction_packed3 import PackedInteraction3

    jgrid, tgrid = _grids(n, 2)
    if engine == "mxu":
        return (JFast(jgrid, tile=8, cap=64),
                FastInteraction(tgrid, tile=8, cap=64, device="cpu"))
    if engine == "packed":
        return (JPacked(jgrid, tile=8, chunk=64, nchunks=32),
                PackedInteraction(tgrid, tile=8, chunk=64, nchunks=32,
                                  device="cpu"))
    return (JP3(jgrid, tile=8, tile_last=8, chunk=64, nchunks=64),
            PackedInteraction3(tgrid, tile=8, tile_last=8, chunk=64,
                               nchunks=64, device="cpu"))


@pytest.mark.parametrize("engine", ["mxu", "packed", "packed3"])
@pytest.mark.parametrize("coupling", ["nodal", "unified"])
@pytest.mark.parametrize("family", ["volume", "surface"])
def test_fast_engine_2d_matches_reference(engine, coupling, family):
    """The cases of ``tests/test_ibfe.py::test_fast_engine_matches_scatter``
    (a disc or a ring on 32^2, displaced, random force and field) on each
    2D engine: the port with ``fast=`` against the reference with its
    engine of the same family, and against the reference's scatter
    oracle, within 1e-10 of max|ref| at f64."""
    jeng, teng = _engines_2d(engine, 32)
    jgrid, tgrid = _grids(32, 2)
    if family == "volume":
        m = jm.disc_mesh(radius=0.15, center=(0.5, 0.5), n_rings=4)
        W, jcls, tcls = (jf.neo_hookean(1.0, 4.0), jibfe.IBFEMethod,
                         tibfe.IBFEMethod)
        tW, tm = tf.neo_hookean(1.0, 4.0), convert.fe_mesh(m)
    else:
        m = js.ring_mesh(center=(0.5, 0.5), radius=0.15, n=48)
        W, jcls, tcls = (js.neo_hookean_membrane(1.0, 2.0),
                         jibfe.IBFESurfaceMethod, tibfe.IBFESurfaceMethod)
        tW, tm = ts.neo_hookean_membrane(1.0, 2.0), convert.surface_mesh(m)
    j0 = jcls(m, W, coupling=coupling, dtype=jnp.float64)
    j1 = jcls(m, W, coupling=coupling, dtype=jnp.float64, fast=jeng)
    t1 = tcls(tm, tW, coupling=coupling, dtype=torch.float64, fast=teng,
              device="cpu")
    X = np.asarray(m.nodes) * 1.1 - 0.05
    ft, Ut = _transfer_pair(j1, t1, jgrid, tgrid, X, seed=3)
    # the same force and field through the reference's scatter oracle
    rng = np.random.default_rng(3)
    F = rng.standard_normal(X.shape)
    u = [rng.standard_normal(jgrid.n) for _ in range(2)]
    mask = np.ones(X.shape[0])
    mask[1] = 0.0
    Xj, mj = jnp.asarray(X), jnp.asarray(mask)
    for a, b in zip(j0.spread_force(jnp.asarray(F), jgrid, Xj, mj), ft):
        _close(a, b)
    _close(j0.interpolate_velocity(tuple(map(jnp.asarray, u)), jgrid, Xj,
                                   mj), Ut)
