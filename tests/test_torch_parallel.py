"""Port parity of the mesh, the workload model and the sharded steps
(``ibamr_tpu_torch/parallel/{mesh,spmd,workload}.py``) against
``ibamr_tpu/parallel/`` on the CPU at f64, and one test for each call
that raised before the parallel layer was ported.

- ``factor_devices`` / ``make_mesh`` give the reference's shapes;
  ``workload.py`` (the port's own copy) gives the reference's numbers.
- ``make_sharded_step`` on the 3-D IB shell and on INS (2-D and 3-D),
  1D and 2D meshes of 4 and 8 shards, follows the reference's
  single-device step over 3 steps within 1e-10 of the largest value,
  with every per-shard body under ``spmd.audit_blocks``; the sharded
  step is bitwise the same run to run and block-resident: every grid
  array of its state is ``spmd.Blocks`` carrying the layout, each block
  on its shard's device, and no whole-grid ``shard`` / ``unshard`` runs
  inside a step (patched to raise; the census counts 0).
- The ex4 driver sharded over an 8-shard CPU mesh reproduces the
  reference's ex4 main, which shards over the 8 host devices.
- The dispatch table and its MRO walk, the generic wrapper, the
  multibox placement, and the other families (adv-diff, block-resident
  since the two-phase slice, L-level adv-diff and INS, LES, CIB, open
  INS), each held against the reference's single-device step and
  against its own plain step.
- The removed raises: ``build_dense_coarse_solver`` and
  ``build_dense_root_solver`` build the reference's dense-periodic
  inverses (held against the reference's within 1e-12), and the
  sharded two-level step follows the reference's single-device one;
  ``HierarchyDriver(lane_mesh=...)`` gives a fleet bitwise the
  replicated fleet through quarantine and dt backoff, with the elastic
  8 -> 4 restart bitwise; ``ResilientDriver(sharded=, mesh=)`` and
  ``tools/replay.py --sharded`` are held by the sharded drill
  (``tests/test_torch_checkpoint_sharded.py``) and here by a replay of
  a sharded capsule."""

import importlib.util
import json
import math
import os
import re
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.models.shell3d import build_shell_example as jbuild_shell
from ibamr_tpu.parallel import mesh as jmesh
from ibamr_tpu.parallel import workload as jwork
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.models.shell3d import build_shell_example
from ibamr_tpu_torch.parallel import spmd
from ibamr_tpu_torch.parallel import workload as twork
from ibamr_tpu_torch.parallel.fftpar import PencilFFT
from ibamr_tpu_torch.parallel.mesh import (factor_devices, make_lane_mesh,
                                           make_mesh, make_sharded_ins_step,
                                           make_sharded_step, place_lanes,
                                           place_state, shard_lanes)
from ibamr_tpu_torch.utils.hierarchy_driver import HierarchyDriver, RunConfig
from ibamr_tpu_torch.utils.lanes import stack_lanes
from ibamr_tpu_torch.utils.tree import leaves

TOL = 1e-10


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(g - want).max() <= tol * scale, np.abs(g - want).max()


def _bitwise(a, b):
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


# ---------------------------------------------------------------------------
# mesh and workload
# ---------------------------------------------------------------------------

def test_factor_devices_and_mesh_shapes():
    for n in range(1, 17):
        for ax in (1, 2):
            assert factor_devices(n, ax) == jmesh.factor_devices(n, ax)
    for n, ax in ((8, 2), (8, 1), (4, 2), (6, 2)):
        m = make_mesh(n, max_axes=ax, device="cpu")
        jm = jmesh.make_mesh(n, max_axes=ax)
        assert m.devices.shape == jm.devices.shape
        assert m.axis_names == tuple(jm.axis_names)
        assert tuple(jmesh.grid_pspec(jm, 3)) == tuple(
            spmd.P(*m.axis_names, *([None] * (3 - len(m.axis_names)))))
    lm = make_lane_mesh(4, device="cpu")
    assert lm.axis_names == ("lanes",) and lm.size == 4
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            make_mesh(2)


def test_workload_matches_reference():
    rng = np.random.default_rng(7)
    shape = (32, 32)
    jg = JGrid(n=shape, x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    tg = StaggeredGrid(n=shape, x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    X = np.stack([0.5 + 0.02 * rng.standard_normal(3000),
                  rng.random(3000)], axis=-1) % 1.0
    mask = (rng.random(3000) > 0.1).astype(float)
    for sizes in ((4, 2), (8,), (2, 4)):
        np.testing.assert_array_equal(
            twork.shard_marker_counts(X, tg, sizes, mask=mask),
            jwork.shard_marker_counts(X, jg, sizes, mask=mask))
    jr = jwork.choose_mesh(X, jg, 8, min_block=4)
    tr = twork.choose_mesh(X, tg, 8, min_block=4)
    assert tr.sizes == jr.sizes and tr.capacity == jr.capacity
    np.testing.assert_array_equal(tr.cost_per_shard, jr.cost_per_shard)
    assert tr.imbalance == jr.imbalance
    for Xd in (X, 0.1 * X):
        assert twork.needs_rebalance(Xd, tg, tr.sizes, tr.capacity,
                                     min_block=4) == \
            jwork.needs_rebalance(Xd, jg, jr.sizes, jr.capacity,
                                  min_block=4)
    lo = np.array([[2, 2], [10, 4], [20, 20], [4, 18]])
    c = twork.box_costs(lo, (6, 6), tg, X=X)
    np.testing.assert_array_equal(c, jwork.box_costs(lo, (6, 6), jg, X=X))
    for a, b in zip(twork.lpt_assign(c, 3), jwork.lpt_assign(c, 3)):
        np.testing.assert_array_equal(a, b)


# ---------------------------------------------------------------------------
# sharded steps against the reference's single-device step
# ---------------------------------------------------------------------------

_SHELL = dict(n_cells=16, n_lat=8, n_lon=8, mu=0.05,
              use_fast_interaction=None)


@pytest.fixture(scope="module")
def shell_reference():
    ji, js = jbuild_shell(dtype=jnp.float64, **_SHELL)
    s0 = js
    step = jax.jit(ji.step)
    for _ in range(3):
        js = step(js, 5e-3)
    return s0, js


@pytest.mark.parametrize("n_shards,axes", [(8, 2), (4, 1)])
def test_sharded_ib_shell_matches_reference(shell_reference, n_shards, axes):
    s0, want = shell_reference
    integ, _ = build_shell_example(dtype=torch.float64, device="cpu",
                                   **_SHELL)
    mesh = make_mesh(n_shards, max_axes=axes, device="cpu")
    step = make_sharded_step(integ, mesh)
    assert step.integ.ib.engine_name == "sharded"
    assert step.integ.ins.fused_stokes is None
    runs = []
    for _ in range(2):
        s = place_state(convert.ib_state(s0, device="cpu"),
                        integ.ins.grid, mesh)
        with spmd.audit_blocks() as audit:
            for _ in range(3):
                s = step(s, 5e-3)
        runs.append(s)
    assert audit["bodies"] > 0
    assert _bitwise(runs[0], runs[1])
    s = runs[0]
    _close(s.X, want.X)
    assert float(torch.abs(s.X - torch.tensor(np.asarray(s0.X))).max()) \
        > 0
    for a, b in zip(s.ins.u, want.ins.u):
        _close(a, b)
    _close(s.ins.p, want.ins.p)
    _assert_block_resident(s.ins, mesh, axes)
    assert s.X.device == mesh.first_device


def _assert_block_resident(ins_state, mesh, axes):
    """Every grid array of an INS state is Blocks under the spatial
    layout, read from the container, each block on its shard's device;
    the scalars stay plain tensors."""
    for x in (*ins_state.u, ins_state.p, *ins_state.n_prev):
        assert isinstance(x, spmd.Blocks)
        assert x.mesh is mesh
        assert tuple(x.spec)[:axes] == mesh.axis_names
        assert all(b.device == mesh.device(i)
                   for i, b in enumerate(x.blocks))
        assert all(tuple(b.shape) == tuple(hi - lo for lo, hi in
                                           x.sharding.index(i, x.shape))
                   for i, b in enumerate(x.blocks))
    assert isinstance(ins_state.t, torch.Tensor)
    assert isinstance(ins_state.k, torch.Tensor)


@pytest.mark.parametrize("shape,n_shards,axes", [((16, 16), 4, 2),
                                                 ((16, 16, 16), 4, 1)])
def test_sharded_ins_matches_reference(shape, n_shards, axes):
    dim = len(shape)
    jg = JGrid(n=shape, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    tg = StaggeredGrid(n=shape, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    rng = np.random.default_rng(dim)
    u0 = tuple(rng.standard_normal(shape) * 0.1 for _ in range(dim))
    ji = JINS(jg, mu=0.02, dtype=jnp.float64)
    js = ji.initialize(u0_arrays=tuple(jnp.asarray(c) for c in u0))
    jstep = jax.jit(ji.step, static_argnums=1)
    for _ in range(3):
        js = jstep(js, 2e-3)
    ti = INSStaggeredIntegrator(tg, mu=0.02, dtype=torch.float64,
                                device="cpu")
    mesh = make_mesh(n_shards, max_axes=axes, device="cpu")
    step = make_sharded_step(ti, mesh)
    runs = []
    for _ in range(2):
        s = place_state(ti.initialize(u0_arrays=u0), tg, mesh)
        with spmd.audit_blocks() as audit:
            for _ in range(3):
                s = step(s, 2e-3)
        runs.append(s)
    assert audit["bodies"] > 0
    assert _bitwise(runs[0], runs[1])
    s = runs[0]
    for a, b in zip(s.u, js.u):
        _close(a, b)
    _close(s.p, js.p)
    _assert_block_resident(s, mesh, axes)


def _grid_guard(monkeypatch, shape):
    """Patch ``spmd.shard`` / ``spmd.unshard`` (and every module's
    imported copy) to raise, once armed, on a whole tensor whose trailing
    dimensions are the grid's; other calls (the marker pools) pass and
    are counted. Returns ``(armed, passed)``."""
    armed, passed = [False], []
    real = {"shard": spmd.shard, "unshard": spmd.unshard}

    def whole_shape(name, mesh, x, spec):
        if name == "shard":
            return tuple(x.shape)
        parts = tuple(spec) + (None,) * x[0].dim()
        return tuple(n * (mesh.axis_size(p) if p is not None else 1)
                     for n, p in zip(x[0].shape, parts))

    def guarded(name):
        def fn(mesh, x, spec, *args, **kwargs):
            dims = whole_shape(name, mesh, x, spec)
            if armed[0]:
                if dims[len(dims) - len(shape):] == shape:
                    raise AssertionError(f"whole-grid {name} of {dims} "
                                         f"inside a step")
                passed.append((name, dims))
            return real[name](mesh, x, spec, *args, **kwargs)
        return fn

    for mod in list(sys.modules.values()):
        if not (getattr(mod, "__name__", "") or "").startswith(
                "ibamr_tpu_torch"):
            continue
        for name in real:
            if getattr(mod, name, None) is real[name]:
                monkeypatch.setattr(mod, name, guarded(name))
    return armed, passed


@pytest.mark.parametrize("family", ["ib", "ins"])
def test_sharded_step_never_cuts_or_assembles_the_grid(monkeypatch,
                                                       family):
    """Between ``place_state`` and the end of 3 steps no whole-grid
    ``shard`` / ``unshard`` runs (both raise on a tensor of the grid's
    shape); the marker pools still go through them. The census counts 0
    whole-grid layouts a step. The guard itself catches an assembly."""
    from ibamr_tpu_torch.analysis.graph_census import graph_census

    mesh = make_mesh(8, max_axes=2, device="cpu")
    if family == "ib":
        integ, s0 = build_shell_example(dtype=torch.float64, device="cpu",
                                        **_SHELL)
        grid, dt = integ.ins.grid, 5e-3
    else:
        grid = StaggeredGrid(n=(16, 16, 16), x_lo=(0.0,) * 3,
                             x_up=(1.0,) * 3)
        integ = INSStaggeredIntegrator(grid, mu=0.02, dtype=torch.float64,
                                       device="cpu")
        rng = np.random.default_rng(5)
        s0 = integ.initialize(u0_arrays=tuple(
            0.1 * rng.standard_normal(grid.n) for _ in range(3)))
        dt = 2e-3
    step = make_sharded_step(integ, mesh)
    armed, passed = _grid_guard(monkeypatch, tuple(grid.n))
    s = place_state(s0, grid, mesh)
    armed[0] = True
    for _ in range(3):
        s = step(s, dt)
    cen = graph_census(lambda st: step(st, dt), (s,))
    assert cen["whole_grid_layouts"] == 0
    assert cen["ppermute_prims"] > 0 and cen["all_to_all_prims"] > 0
    # the IB step's marker pools are cut and assembled every step
    assert bool(passed) == (family == "ib")
    ins = s.ins if family == "ib" else s
    with pytest.raises(AssertionError, match="whole-grid unshard"):
        ins.u[0].assemble()


def test_block_resident_path_refuses_what_it_cannot_partition():
    """Wall-bounded INS and IB are block-resident now (their steps keep
    every grid array in Blocks); the block path still raises on what it
    cannot partition: the IB step without the co-partitioned transfers
    (periodic or walled), an indivisible grid, a block thinner than the
    convection's ghost width, and on a wall axis one thinner than that
    width plus the cell the pinned wall ghosts read. The two-phase step
    is block-resident too; its open outlet keeps the pinned form."""
    from ibamr_tpu_torch.integrators.ib import IBExplicitIntegrator
    from ibamr_tpu_torch.integrators.ins_vc import INSVCStaggeredIntegrator
    from ibamr_tpu_torch.parallel.mesh import (_block_fluid,
                                               make_sharded_ib_step)

    mesh = make_mesh(8, max_axes=2, device="cpu")
    integ, _ = build_shell_example(dtype=torch.float64, device="cpu",
                                   **_SHELL)
    with pytest.raises(ValueError, match="co-partitioned"):
        make_sharded_ib_step(integ, mesh, sharded_markers=False)
    g = StaggeredGrid(n=(12, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    with pytest.raises(ValueError, match="n % "):
        make_sharded_step(INSStaggeredIntegrator(
            g, dtype=torch.float64, device="cpu"), make_mesh(8,
                                                             device="cpu"))
    g = StaggeredGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    with pytest.raises(ValueError, match="ghost width 3"):
        make_sharded_step(INSStaggeredIntegrator(
            g, convective_op_type="ppm", dtype=torch.float64,
            device="cpu"), make_mesh(8, max_axes=1, device="cpu"))
    # walls: block-resident, and a wall axis needs one cell more
    walled = INSStaggeredIntegrator(g, dtype=torch.float64, device="cpu",
                                    wall_axes=(False, True))
    blk = _block_fluid(walled, make_mesh(4, device="cpu"))
    assert blk.wall_ops.mesh.size == 4
    st = make_sharded_step(walled, make_mesh(4, device="cpu"))(
        walled.initialize(), 1e-3)
    assert isinstance(st.u[0], spmd.Blocks)
    assert st.u[0].mesh.size == 4
    cui = INSStaggeredIntegrator(g, convective_op_type="cui",
                                 dtype=torch.float64, device="cpu",
                                 wall_axes=(True, False))
    with pytest.raises(ValueError, match=r"ghost width 2 \(\+1 at a wall\)"):
        _block_fluid(cui, make_mesh(8, max_axes=1, device="cpu"))
    ib = IBExplicitIntegrator(walled, integ.ib)
    with pytest.raises(ValueError, match="co-partitioned"):
        make_sharded_ib_step(ib, make_mesh(4, device="cpu"),
                             sharded_markers=False)
    # the two-phase step is block-resident; its open outlet (axis-0
    # face-complete assemblies) is what keeps the pinned form
    vc = INSVCStaggeredIntegrator(g, rho0=1.0, rho1=1.0, mu0=0.01,
                                  mu1=0.01, dtype=torch.float64,
                                  precond="fft", device="cpu")
    out = make_sharded_step(vc, make_mesh(4, device="cpu"))(
        vc.initialize(torch.full((16, 16), 0.1, dtype=torch.float64)), 1e-3)
    assert isinstance(out.u[0], spmd.Blocks)
    assert out.u[0].mesh.size == 4
    outlet = INSVCStaggeredIntegrator(g, rho0=1.0, rho1=1.0, mu0=0.01,
                                      mu1=0.01, dtype=torch.float64,
                                      open_outlet=True,
                                      wall_axes=(False, True), device="cpu")
    out = make_sharded_step(outlet, make_mesh(4, device="cpu"))(
        outlet.initialize(torch.full((16, 16), 0.1, dtype=torch.float64)),
        1e-3)
    assert isinstance(out.u[0], torch.Tensor)
    assert spmd.sharding_of(out.u[0]).mesh.size == 4


def test_dispatch_table_mro_and_generic_wrapper():
    from ibamr_tpu_torch.integrators.ins_vc import INSVCStaggeredIntegrator

    mesh = make_mesh(4, device="cpu")
    g = StaggeredGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))

    class MyINS(INSStaggeredIntegrator):
        pass

    ins = MyINS(g, mu=0.02, dtype=torch.float64, device="cpu")
    st = ins.initialize(u0_arrays=tuple(
        torch.tensor(np.random.default_rng(1).standard_normal((16, 16)))
        for _ in range(2)))
    via = make_sharded_step(ins, mesh)
    assert isinstance(via.integ.project.__self__, PencilFFT)
    assert _bitwise(via(st, 1e-3), make_sharded_ins_step(ins, mesh)(st, 1e-3))

    vc = INSVCStaggeredIntegrator(g, rho0=1.0, rho1=2.0, mu0=0.01, mu1=0.01,
                                  dtype=torch.float64, precond="fft",
                                  device="cpu")
    xx = (np.arange(16) + 0.5) / 16
    X, Y = np.meshgrid(xx, xx, indexing="ij")
    out = make_sharded_step(vc, mesh)(
        vc.initialize(torch.tensor(0.1 - np.sqrt((X - 0.5) ** 2
                                                 + (Y - 0.5) ** 2))), 1e-3)
    assert bool(torch.isfinite(out.u[0]).all())
    assert isinstance(out.u[0], spmd.Blocks) and out.u[0].mesh is mesh

    class Minimal:
        grid = g

        def step(self, s, dt):
            return tuple(c + dt for c in s)

    m_out = make_sharded_step(Minimal(), mesh)(
        tuple(torch.zeros(16, 16) for _ in range(2)), 1e-3)
    assert float(m_out[0][0, 0]) == pytest.approx(1e-3)
    with pytest.raises(TypeError):
        make_sharded_step(object(), mesh)


def test_multibox_placement_matches_reference():
    """The LPT placement of three windows on 2 shards and the placed
    step equal the reference's sharded multibox step."""
    from ibamr_tpu.amr_multibox import MultiBoxDynamicAdvDiff as JMB
    from ibamr_tpu_torch.amr_multibox import MultiBoxDynamicAdvDiff as TMB

    kw = dict(n=(48, 48), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))

    def u(lib):
        def u_fn(coords, d):
            x = coords[0]
            if d == 0:
                return -0.3 * lib.sin(2.0 * np.pi * x)
            return lib.zeros_like(x)
        return u_fn

    def three_gauss(coords):
        x, y = coords
        out = 0.0
        for cx, cy in ((0.25, 0.3), (0.55, 0.6), (0.8, 0.35)):
            out = out + jnp.exp(-(((x - cx) ** 2 + (y - cy) ** 2)
                                  / (2 * 0.05 ** 2)))
        return out

    jm = JMB(JGrid(**kw), (10, 10), K=3, kappa=1e-3, u_fn=u(jnp),
             tag_threshold=0.03, dtype=jnp.float64)
    tm = TMB(StaggeredGrid(**kw), (10, 10), K=3, kappa=1e-3, u_fn=u(torch),
             tag_threshold=0.03, device="cpu")
    js = jm.initialize(three_gauss)
    ts = convert.multibox_state(js, device="cpu")
    jstep = jmesh.make_sharded_multibox_step(jm, jmesh.make_mesh(2))
    tstep = make_sharded_step(tm, make_mesh(2, device="cpu"))
    with spmd.audit_blocks():
        for _ in range(2):
            js, ts = jstep(js, 2.5e-4), tstep(ts, 2.5e-4)
    jp, tp = jstep.placement(), tstep.placement()
    np.testing.assert_array_equal(tp["device_of_box"], jp["device_of_box"])
    np.testing.assert_array_equal(tp["load"], jp["load"])
    assert tp["slots_per_device"] == jp["slots_per_device"]
    _close(ts.Qc, js.Qc)
    _close(ts.Qf, js.Qf)


# ---------------------------------------------------------------------------
# the removed raises
# ---------------------------------------------------------------------------

def test_dense_coarse_and_root_solvers_match_reference():
    from ibamr_tpu import amr as jamr
    from ibamr_tpu import amr_ins as jins
    from ibamr_tpu import amr_ins_multilevel as jml
    from ibamr_tpu.amr_multilevel import build_hierarchy as jhier
    from ibamr_tpu_torch import amr as tamr
    from ibamr_tpu_torch import amr_ins as tins
    from ibamr_tpu_torch import amr_ins_multilevel as tml
    from ibamr_tpu_torch.amr_multilevel import build_hierarchy as thier

    shape = (16, 16)
    jg = JGrid(n=shape, x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    tg = StaggeredGrid(n=shape, x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    r = np.random.default_rng(4).standard_normal(shape)
    jp = jins.CompositeProjection(jg, jamr.FineBox((4, 4), (8, 8)))
    tp = tins.CompositeProjection(tg, tamr.FineBox((4, 4), (8, 8)),
                                  device="cpu")
    jp.build_dense_coarse_solver()
    tp.build_dense_coarse_solver()
    want = jp._coarse_dense_solver.solve(jnp.asarray(r), 0.0, 1.0,
                                         zero_nullspace=True)
    _close(tp._coarse_dense_solver.solve(torch.tensor(r), 0.0, 1.0,
                                         zero_nullspace=True), want, 1e-12)

    boxes_j = [jamr.FineBox((4, 4), (8, 8)), jamr.FineBox((4, 4), (8, 8))]
    boxes_t = [tamr.FineBox((4, 4), (8, 8)), tamr.FineBox((4, 4), (8, 8))]
    jmp = jml.MultiLevelCompositeProjection(jhier(jg, boxes_j))
    tmp = tml.MultiLevelCompositeProjection(thier(tg, boxes_t), device="cpu")
    jmp.build_dense_root_solver()
    tmp.build_dense_root_solver()
    want = jmp._root_dense_solver.solve(jnp.asarray(r), 0.0, 1.0,
                                        zero_nullspace=True)
    _close(tmp._root_dense_solver.solve(torch.tensor(r), 0.0, 1.0,
                                        zero_nullspace=True), want, 1e-12)


def test_sharded_two_level_ib_matches_reference():
    """The sharded composite step (dense-periodic coarse preconditioner,
    fine-level markers through the co-partitioned engine) follows the
    reference's single-device composite step within the projection's
    solve tolerance."""
    from ibamr_tpu import amr as jamr
    from ibamr_tpu import amr_ins as jins
    from ibamr_tpu.integrators.ib import IBMethod as JIB
    from ibamr_tpu.models.membrane2d import make_circle_membrane as jmem
    from ibamr_tpu_torch import amr as tamr
    from ibamr_tpu_torch import amr_ins as tins
    from ibamr_tpu_torch.integrators.ib import IBMethod as TIB
    from ibamr_tpu_torch.models.membrane2d import make_circle_membrane as tmem

    jg = JGrid(n=(24, 24), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    tg = StaggeredGrid(n=(24, 24), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    mk = dict(stiffness=2.0, aspect=1.2, rest_length_factor=0.7)
    jm = jmem(32, 0.12, (0.5, 0.5), **mk)
    tm = tmem(32, 0.12, (0.5, 0.5), **mk)
    kw = dict(rho=1.0, mu=0.02, proj_tol=1e-10)
    ji = jins.TwoLevelIBINS(jg, jamr.FineBox((6, 6), (12, 12)),
                            JIB(jm.force_specs(dtype=jnp.float64)), **kw)
    ti = tins.TwoLevelIBINS(tg, tamr.FineBox((6, 6), (12, 12)),
                            TIB(tm.force_specs(dtype=torch.float64,
                                               device="cpu")),
                            device="cpu", **kw)
    js = jax.jit(ji.initialize)(jnp.asarray(jm.vertices))
    ts = ti.initialize(torch.tensor(np.asarray(tm.vertices)))
    js = jax.jit(lambda s: jins.advance_two_level_ib(ji, s, 5e-4, 2))(js)
    step = make_sharded_step(ti, make_mesh(4, device="cpu"),
                             sharded_markers=True)
    assert step.integ.core.proj._coarse_dense_solver is not None
    assert step.integ.ib.engine_name == "sharded"
    for _ in range(2):
        ts = step(ts, 5e-4)
    _close(ts.X, js.X)
    for a, b in zip(ts.fluid.uc, js.fluid.uc):
        _close(a, b, 1e-8)


def _tg_lanes(integ, B):
    g = integ.grid
    out = []
    for i in range(B):
        xf, yc = g.face_centers(0, torch.float64, "cpu")
        xc, yf = g.face_centers(1, torch.float64, "cpu")
        amp = 1.0 + 0.05 * i
        u = amp * torch.sin(2 * math.pi * xf) * torch.cos(2 * math.pi * yc) \
            + 0 * yc
        v = -amp * torch.cos(2 * math.pi * xc) * torch.sin(
            2 * math.pi * yf) + 0 * xc
        out.append(integ.initialize(u0_arrays=(u, v)))
    return out


def _fleet_ins():
    g = StaggeredGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    return INSStaggeredIntegrator(g, mu=0.01, dtype=torch.float64,
                                  device="cpu")


@pytest.mark.parametrize("n_shards", [8, 4])
def test_lane_mesh_fleet_matches_replicated_bitwise(n_shards):
    integ = _fleet_ins()
    states = _tg_lanes(integ, 8)
    cfg = RunConfig(dt=1e-3, num_steps=4, health_interval=2)
    rep = HierarchyDriver(integ, cfg, lanes=8).run(stack_lanes(states))
    mesh = make_lane_mesh(n_shards, device="cpu")
    with spmd.audit_blocks() as audit:
        sh = HierarchyDriver(integ, cfg, lanes=8, lane_mesh=mesh).run(
            place_lanes(stack_lanes(states), mesh))
    assert audit["bodies"] == 4 * n_shards
    assert _bitwise(rep, sh)
    lay = spmd.sharding_of(sh.u[0])
    assert lay.mesh is mesh and tuple(lay.spec) == ("lanes",)
    assert all(spmd.sharding_of(x) is not None
               for x in leaves(shard_lanes(sh, mesh)))


def test_lane_mesh_refuses_indivisible_fleet():
    integ = _fleet_ins()
    mesh = make_lane_mesh(8, device="cpu")
    with pytest.raises(ValueError, match="divisible"):
        HierarchyDriver(integ, RunConfig(dt=1e-3, num_steps=2), lanes=6,
                        lane_mesh=mesh)
    with pytest.raises(ValueError, match="fleet mode"):
        HierarchyDriver(integ, RunConfig(dt=1e-3, num_steps=2),
                        lane_mesh=mesh)
    with pytest.raises(ValueError, match="divide"):
        place_lanes(stack_lanes(_tg_lanes(integ, 6)), mesh)


@pytest.mark.parametrize("max_retries,bad,gated", [(1, 3, True),
                                                    (0, 5, False)])
def test_lane_mesh_quarantine_and_backoff_match_replicated(
        tmp_path, max_retries, bad, gated):
    """The resilience episode (per-lane rollback with dt backoff; or
    quarantine when the retries run out) plays out identically on the
    lane mesh with sharded supervision and on the replicated fleet."""
    from ibamr_tpu_torch.tools.fault_injection import lane_nan_injector
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver

    integ = _fleet_ins()
    states = _tg_lanes(integ, 8)
    cfg = RunConfig(dt=1e-3, num_steps=8, health_interval=2,
                    restart_interval=0)
    inj = dict(at_step=4, lane=bad, fleet_size=8, leaf_path="u[0]",
               step_attr="k", dt_gate=1e-3 if gated else None)
    runs = []
    for tag, mesh in (("rep", None), ("sh", make_lane_mesh(8, device="cpu"))):
        drv = HierarchyDriver(
            integ, cfg, lanes=8, lane_mesh=mesh,
            fleet_step_wrap=lambda s: lane_nan_injector(s, **inj))
        sup = ResilientDriver(drv, os.path.join(str(tmp_path), tag),
                              max_retries=max_retries, dt_backoff=0.5,
                              handle_signals=False,
                              sharded=mesh is not None, mesh=mesh)
        stacked = stack_lanes(states)
        if mesh is not None:
            stacked = place_lanes(stacked, mesh)
        runs.append((drv, sup, sup.run(stacked)))
    (dr, sr, fr), (ds, ss, fs) = runs
    assert [r["event"] for r in sr.incidents] == \
        [r["event"] for r in ss.incidents]
    np.testing.assert_array_equal(dr.lane_dt, ds.lane_dt)
    np.testing.assert_array_equal(dr.lane_alive, ds.lane_alive)
    assert bool(ds.lane_alive[bad]) == gated
    assert _bitwise(fr, fs)
    assert all(v == 1 for v in ds.trace_counts.values())


def test_elastic_lane_restart_8_to_4_bitwise(tmp_path):
    from ibamr_tpu_torch.utils.checkpoint_sharded import (
        restore_sharded, save_sharded_checkpoint)

    integ = _fleet_ins()
    states = _tg_lanes(integ, 8)
    m8, m4 = make_lane_mesh(8, device="cpu"), make_lane_mesh(4, device="cpu")
    half = RunConfig(dt=1e-3, num_steps=4, health_interval=2)
    mid = HierarchyDriver(integ, half, lanes=8, lane_mesh=m8).run(
        place_lanes(stack_lanes(states), m8))
    save_sharded_checkpoint(str(tmp_path), mid, 4, mesh=m8)
    restored, step, _ = restore_sharded(
        str(tmp_path), place_lanes(stack_lanes(states), m4))
    assert step == 4 and _bitwise(restored, mid)
    assert spmd.sharding_of(restored.u[0]).mesh is m4
    fin4 = HierarchyDriver(integ, half, lanes=8, lane_mesh=m4).run(restored)
    fin8 = HierarchyDriver(
        integ, RunConfig(dt=1e-3, num_steps=8, health_interval=2), lanes=8,
        lane_mesh=m8).run(place_lanes(stack_lanes(states), m8))
    assert _bitwise(fin4, fin8)


def test_sharded_capsule_replays_on_its_mesh(tmp_path):
    """``replay(..., sharded=True)`` rebuilds the capsule's recorded
    mesh and re-executes the sharded program bitwise; without the flag
    the capsule replays on one device and the failure reproduces; a
    capsule without a mesh refuses ``--sharded``."""
    from ibamr_tpu_torch.tools.fault_injection import (_tg16_setup,
                                                       nan_injector_step,
                                                       recorded)
    from ibamr_tpu_torch.tools.replay import ReplayError, replay
    from ibamr_tpu_torch.utils.flight_recorder import FlightRecorder
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver

    integ, st0 = _tg16_setup(device="cpu", dtype=torch.float64)
    mesh = make_mesh(4, device="cpu")
    inj = dict(at_step=4, leaf_path="u[0]", dt_gate=1e-3 * 0.99)
    with recorded("nan", **inj):
        drv = HierarchyDriver(
            integ, RunConfig(dt=1e-3, num_steps=6, health_interval=2,
                             restart_interval=2),
            step_fn=nan_injector_step(make_sharded_step(integ, mesh), **inj),
            recorder=FlightRecorder(capacity=2))
        sup = ResilientDriver(drv, str(tmp_path), max_retries=1,
                              handle_signals=False, sharded=True, mesh=mesh)
        sup.run(place_state(st0, integ.grid, mesh))
    cap = [r for r in sup.incidents if r["event"] == "divergence"][0]["replay"]
    res = replay(cap, sharded=True)
    assert res["sharded_replay"] and not res["mesh_degraded"]
    assert res["bitwise"] and res["verdict"] == "reproduced"
    assert res["recorded_mesh"]["shape"] == [2, 2]
    # one device runs the fused spectral step, another program than the
    # pencil solves: the failure reproduces, the recorded bits do not
    plain = replay(cap)
    assert plain["baseline_failed"] and not plain["sharded_replay"]

    drv2 = HierarchyDriver(integ, RunConfig(dt=1e-3, num_steps=4,
                                            health_interval=2),
                           step_fn=nan_injector_step(integ.step, **inj),
                           recorder=FlightRecorder(capacity=2))
    sup2 = ResilientDriver(drv2, str(tmp_path / "plain"), max_retries=0,
                           handle_signals=False)
    with pytest.raises(Exception):
        with recorded("nan", **inj):
            sup2.run(st0)
    cap2 = sup2.incidents[-1]["replay"]
    with pytest.raises(ReplayError, match="no multi-shard mesh"):
        replay(cap2, sharded=True)


def _family(name, mesh):
    """(sharded, plain, reference, tol, ref_tol) of one family at a small
    size: ``reference`` runs the JAX package's single-device step on the
    same inputs and gives its leaves; ``tol`` None means the sharded step
    is bitwise the plain one (no seam swapped), else the swapped solve's
    tolerance; ``ref_tol`` bounds the sharded step against the
    reference (the plain step's own parity bound, or ``tol``)."""
    from ibamr_tpu import amr as jamr
    from ibamr_tpu_torch import amr as tamr

    shape = (16, 16)
    jg = JGrid(n=shape, x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    g = StaggeredGrid(n=shape, x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    rng = np.random.default_rng(9)
    if name == "adv_diff":
        from ibamr_tpu.integrators import adv_diff as jad
        from ibamr_tpu_torch.integrators import adv_diff as tad
        Q0 = rng.standard_normal(shape)
        integ = tad.AdvDiffSemiImplicitIntegrator(
            g, [tad.TransportedQuantity("Q", kappa=0.01)],
            dtype=torch.float64, device="cpu")
        ji = jad.AdvDiffSemiImplicitIntegrator(
            jg, [jad.TransportedQuantity("Q", kappa=0.01)], dtype=jnp.float64)
        st = integ.initialize([torch.tensor(Q0)])
        u = tuple(torch.full(shape, 0.3, dtype=torch.float64)
                  for _ in range(2))
        return (lambda: make_sharded_step(integ, mesh)(st, 1e-3, u=u),
                lambda: integ.step(st, 1e-3, u=u),
                lambda: ji.step(ji.initialize([jnp.asarray(Q0)]), 1e-3,
                                u=tuple(jnp.full(shape, 0.3)
                                        for _ in range(2))), TOL, TOL)
    if name == "multilevel_adv_diff":
        from ibamr_tpu import amr_multilevel as jml
        from ibamr_tpu_torch.amr_multilevel import MultiLevelAdvDiff

        def gauss(lib):
            return lambda c: lib.exp(-((c[0] - 0.4) ** 2
                                       + (c[1] - 0.5) ** 2) / 0.02)

        def vel(m):
            return (0.7 + 0 * m[0], 0.3 + 0 * m[1])

        ml = MultiLevelAdvDiff(g, [tamr.FineBox((4, 4), (8, 8))],
                               kappa=0.002, vel_fn=vel, device="cpu")
        jm = jml.MultiLevelAdvDiff(jg, [jamr.FineBox((4, 4), (8, 8))],
                                   kappa=0.002, vel_fn=vel)
        Qs = ml.initialize(gauss(torch))
        return (lambda: make_sharded_step(ml, mesh)(Qs, 1e-3),
                lambda: ml.step(Qs, 1e-3),
                lambda: jax.jit(jm.step, static_argnums=1)(
                    jm.initialize(gauss(jnp)), 1e-3), None, TOL)
    if name == "multilevel_ins":
        from ibamr_tpu import amr_ins_multilevel as jml
        from ibamr_tpu_torch.amr_ins_multilevel import MultiLevelINS

        def vel(d, m):
            return 0.1 * (m[1 - d] * (1 - m[1 - d]))

        ml = MultiLevelINS(g, [tamr.FineBox((4, 4), (8, 8))], mu=0.01,
                           proj_tol=1e-10, device="cpu")
        jm = jml.MultiLevelINS(jg, [jamr.FineBox((4, 4), (8, 8))], mu=0.01,
                               proj_tol=1e-10)
        st = ml.initialize(vel)
        return (lambda: make_sharded_step(ml, mesh)(st, 1e-3),
                lambda: ml.step(st, 1e-3),
                lambda: jax.jit(jm.step, static_argnums=1)(
                    jm.initialize(vel, dtype=jnp.float64), 1e-3), 1e-8,
                1e-8)
    if name == "les":
        from ibamr_tpu.physics import turbulence as jt
        from ibamr_tpu_torch.physics.turbulence import TwoLevelSmagorinskyINS
        kw = dict(mu=1e-3, cs=0.4, proj_tol=1e-10)
        les = TwoLevelSmagorinskyINS(g, tamr.FineBox((4, 4), (8, 8)),
                                     device="cpu", **kw)
        jles = jt.TwoLevelSmagorinskyINS(jg, jamr.FineBox((4, 4), (8, 8)),
                                         **kw)
        u0 = tuple(0.2 * rng.standard_normal(shape) for _ in range(2))
        st = les.initialize(tuple(torch.tensor(c) for c in u0))
        return (lambda: make_sharded_step(les, mesh)(st, 1e-3),
                lambda: les.step(st, 1e-3),
                lambda: jax.jit(jles.step, static_argnums=1)(jles.initialize(
                    tuple(jnp.asarray(c) for c in u0)), 1e-3), 1e-8, 1e-8)
    if name == "cib":
        from ibamr_tpu.integrators import cib as jc
        from ibamr_tpu_torch.integrators import cib
        X = np.concatenate([np.asarray(jc.make_disc((0.35, 0.5), 0.12, 8)),
                            np.asarray(jc.make_disc((0.68, 0.45), 0.1, 8))])
        bid = np.repeat([0, 1], 8)
        U = np.array([[0.1, -0.2, 0.3], [0.0, 0.1, -0.1]])
        kw = dict(mu=1.3, cg_tol=1e-9, cg_maxiter=200)
        m = cib.CIBMethod(g, cib.RigidBodies(body_id=torch.tensor(bid),
                                             n_bodies=2), device="cpu", **kw)
        jm = jc.CIBMethod(jg, jc.RigidBodies(body_id=jnp.asarray(bid),
                                             n_bodies=2), **kw)
        Xt, Ut = torch.tensor(X), torch.tensor(U)
        return (lambda: make_sharded_step(m, mesh)(Xt, Ut)[:2],
                lambda: m.solve_constraint(Xt, Ut)[:2],
                lambda: jax.jit(jm.solve_constraint)(
                    jnp.asarray(X), jnp.asarray(U))[:2], None, 1e-8)
    from ibamr_tpu.integrators import ins_open as jo
    from ibamr_tpu.solvers import stokes as jstokes
    from ibamr_tpu_torch.integrators.ins_open import INSOpenIntegrator
    from ibamr_tpu_torch.solvers import stokes
    kw = dict(bdry={(0, 0, 0): 1.0}, mu=0.02, dt=0.004, tol=1e-11)
    integ = INSOpenIntegrator(shape, (2.0 / 16, 1.0 / 16),
                              stokes.channel_bc(2), device="cpu", **kw)
    ji = jo.INSOpenIntegrator(shape, (2.0 / 16, 1.0 / 16),
                              jstokes.channel_bc(2), **kw)
    st = integ.initialize()
    return (lambda: make_sharded_step(integ, mesh)(st),
            lambda: integ.step(st),
            lambda: jax.jit(ji.step)(ji.initialize()), None, TOL)


@pytest.mark.parametrize("name", ["adv_diff", "multilevel_adv_diff",
                                  "multilevel_ins", "les", "cib",
                                  "open_ins"])
def test_family_sharded_step_follows_its_plain_step(name):
    """Every family's sharded step follows the JAX package's
    single-device step on the same inputs, and is its own plain step
    with the seams swapped: bitwise where no seam applies, within the
    swapped solve's tolerance where one does; its outputs carry the
    layout."""
    mesh = make_mesh(4, device="cpu")
    sharded, plain, reference, tol, ref_tol = _family(name, mesh)
    with spmd.audit_blocks():
        got = sharded()
    want = plain()
    ref = [np.asarray(x) for x in jax.tree_util.tree_leaves(reference())]
    la, lb = leaves(got), leaves(want)
    assert len(la) == len(lb) == len(ref)
    for a, b, r in zip(la, lb, ref):
        _close(a, r, ref_tol)
        if tol is None:
            assert torch.equal(a, b)
        else:
            _close(a, b.numpy(), tol)
    assert any(spmd.sharding_of(x) is not None and
               spmd.sharding_of(x).mesh is mesh for x in la)


def test_parallel_entry_points_raise_without_a_gpu(tmp_path, capsys):
    """The parallel layer's entry points default to the GPU and raise
    without one, like every entry point of the port."""
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device works here")
    from ibamr_tpu_torch.tools import fault_injection as fi
    from ibamr_tpu_torch.tools import fleet
    from ibamr_tpu_torch.tools.replay import ReplayError, rebuild_mesh

    for call in (lambda: make_mesh(8), lambda: make_lane_mesh(2),
                 lambda: fi.run_sharded_smoke(str(tmp_path)),
                 lambda: fi.run_sharded_crash_child(str(tmp_path), 2, 1)):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            call()
    with pytest.raises(ReplayError, match="cannot be rebuilt"):
        rebuild_mesh({"shape": [2, 2], "axis_names": ["x", "y"]})
    assert fleet.main(["--lanes", "2", "--n", "8", "--mesh", "2"]) == 1
    out = capsys.readouterr().out.strip().splitlines()[-1]
    assert "no CUDA device" in out


ROOT = Path(__file__).resolve().parent.parent
EX4_INPUT = ROOT / "examples/IB/explicit/ex4/input3d"
EX4_STEPS, EX4_VIZ, EX4_RESTART = 6, 2, 3
# f32 runs of the two packages: FFT backends and sum orders differ (the
# bounds of tests/test_torch_driver.py's ex4 test)
EX4_RTOL = 1e-5
EX4_KE_RTOL = 1e-4


def _ex4_cut_input(out: Path) -> Path:
    """``input3d`` cut to a 16^3 grid, an 8x10 shell, dt 1e-3 and 6
    steps with viz every 2 and a restart every 3; the relative output
    paths as committed."""
    text = EX4_INPUT.read_text()
    for pat, val in ((r"(n_cells\s*=\s*)[\d, ]+\n", r"\g<1>16, 16, 16\n"),
                     (r"(dt\s*=\s*)[\d.e-]+", r"\g<1>1e-3"),
                     (r"(num_steps\s*=\s*)\d+", rf"\g<1>{EX4_STEPS}"),
                     (r"(viz_dump_interval\s*=\s*)\d+", rf"\g<1>{EX4_VIZ}"),
                     (r"(restart_interval\s*=\s*)\d+",
                      rf"\g<1>{EX4_RESTART}"),
                     (r"(n_lat\s*=\s*)\d+", r"\g<1>8"),
                     (r"(n_lon\s*=\s*)\d+", r"\g<1>10")):
        text, k = re.subn(pat, val, text)
        assert k == 1, pat
    out.mkdir(parents=True, exist_ok=True)
    path = out / "input3d"
    path.write_text(text)
    return path


def _in_dir(directory: Path, fn):
    cwd = os.getcwd()
    os.chdir(directory)
    try:
        return fn()
    finally:
        os.chdir(cwd)


def _rel(a, b):
    a, b = np.asarray(a, dtype=np.float64), np.asarray(b, dtype=np.float64)
    return float(np.max(np.abs(a - b)) / max(np.max(np.abs(b)), 1e-30))


def test_ex4_driver_sharded_matches_reference_sharded(tmp_path, capsys):
    """The port's ex4 driver over an 8-shard CPU mesh
    (``run(db, device="cpu", mesh=make_mesh(8, device="cpu"))``) against
    the reference's ex4 main, which shards over the 8 host devices: the
    metrics records, the viz files, the checkpoints and the final state
    within the ex4 bounds; the port's final state is block-resident."""
    from ibamr_tpu.utils import checkpoint as jckpt
    from ibamr_tpu_torch.examples import ib_explicit_ex4
    from ibamr_tpu_torch.utils import checkpoint as tckpt
    from ibamr_tpu_torch.utils.input_db import parse_input_file

    assert len(jax.devices()) == 8
    spec = importlib.util.spec_from_file_location(
        "example_ex4_main", ROOT / "examples/IB/explicit/ex4/main.py")
    jmain = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(jmain)
    jdir, tdir = tmp_path / "jax", tmp_path / "port"
    jpath, tpath = _ex4_cut_input(jdir), _ex4_cut_input(tdir)
    js = _in_dir(jdir, lambda: jmain.main(["main.py", str(jpath)]))
    mesh = make_mesh(8, device="cpu")
    ts = _in_dir(tdir, lambda: ib_explicit_ex4.run(
        parse_input_file(str(tpath)), device="cpu", mesh=mesh))
    out = capsys.readouterr().out
    assert out.count("sharding over mesh {'x': 4, 'y': 2}") == 2
    assert int(ts.ins.k) == EX4_STEPS
    _assert_block_resident(ts.ins, mesh, 2)
    for a, b in ((ts.X, js.X), (ts.U, js.U), (ts.ins.p, js.ins.p),
                 *zip(ts.ins.u, js.ins.u)):
        assert _rel(a, b) < EX4_RTOL

    def records(d):
        lines = (d / "viz_ex4/metrics.jsonl").read_text().splitlines()
        return [json.loads(ln) for ln in lines]

    jrec, trec = records(jdir), records(tdir)
    assert [r["step"] for r in trec] == [r["step"] for r in jrec] \
        == [2, 3, 4, 6]
    umax = max(float(np.max(np.abs(np.asarray(c)))) for c in js.ins.u)
    for j, t in zip(jrec, trec):
        assert t.keys() == j.keys()
        for key in ("t", "volume", "cfl_dt"):
            assert abs(t[key] - j[key]) <= EX4_RTOL * abs(j[key]), key
        assert abs(t["ke"] - j["ke"]) <= EX4_KE_RTOL * j["ke"]
        assert abs(t["max_div"] - j["max_div"]) <= EX4_RTOL * umax * 16
    viz = sorted(os.listdir(jdir / "viz_ex4"))
    assert sorted(os.listdir(tdir / "viz_ex4")) == viz
    for name in viz:
        if name.endswith(".csv"):
            ref = np.loadtxt(jdir / "viz_ex4" / name, delimiter=",")
            got = np.loadtxt(tdir / "viz_ex4" / name, delimiter=",")
            assert _rel(got, ref) <= EX4_RTOL
    assert sorted(os.listdir(tdir / "restart_ex4")) == sorted(
        os.listdir(jdir / "restart_ex4"))
    for k in (EX4_RESTART, EX4_STEPS):
        jk, _, _ = jckpt.restore_checkpoint(str(jdir / "restart_ex4"), js, k)
        tk, _, _ = tckpt.restore_checkpoint(str(tdir / "restart_ex4"), ts, k)
        for a, b in zip(leaves(tk), jax.tree_util.tree_leaves(jk)):
            assert _rel(a, b) < EX4_RTOL
        assert isinstance(tk.ins.u[0], spmd.Blocks)
