"""The adv-diff and two-phase (variable-coefficient) steps on
block-resident state (``ibamr_tpu_torch/parallel/{spmd,mesh}.py``,
``solvers/{multigrid,krylov}.py``, ``ops/{norms,godunov}.py``,
``physics/level_set.py``, ``integrators/{ins_vc,adv_diff}.py``) on the
CPU at f64, inputs from a numpy seed.

- ``PoissonMultigrid.vcycle`` on Blocks is the whole-tensor V-cycle:
  bitwise with walls, within 1e-14 periodic, on a grid whose coarsest
  level has blocks at odd offsets (the red-black colours by global
  index), and with a level too coarse to cut gathered to the first
  shard (counted as a coarse gather, never of the fine grid's shape; a
  finest level of odd blocks is gathered as a counted whole-grid
  layout).
- ``ghost_fill`` moves each neighbour slab to its shard's device (8
  shards cycling over 6 fake GPUs).
- ``reinitialize``, ``advect`` and ``curvature`` on Blocks with walls on
  a split axis are bitwise the whole-grid functions.
- The two-phase step through ``make_sharded_step`` (the reference's
  case: 32^2, rho 1 / 10, sigma 0.1, ``reinit_interval=2``, ``cg_tol``
  1e-10), periodic and walled on (4, 2) for 4 steps, the conservative
  form walled on (2, 2) for 3 steps, and a periodic 3D case (16^3 on
  (2, 2), 2 steps) follow the JAX package's single-device step within
  ``SOLVE`` (the bound of ``tests/test_torch_ins_vc.py``) and the port's
  unsharded step within 1e-12 (the reference's sharded bound), with the
  CG iterations equal every step and every grid leaf in Blocks.
- The adv-diff step: the reference's walled case (32^2, Dirichlet on
  axis 0) on 8 shards for 5 steps, with and without a velocity, and a
  periodic CUI case with a source callable, within ``SOLVE_RTOL`` (the
  bound of ``tests/test_torch_adv_diff.py``) of the JAX package's step
  and within 1e-13 of the port's unsharded step.
- One step's census of each family counts 0 whole-grid layouts; a
  two-phase block state saves shard by shard and restores bitwise; the
  open outlet keeps the pinned wrapper; ``fast_sweeping_distance`` on
  Blocks raises; a block thinner than the step's ghost width raises
  with the width.
"""

import contextlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.bc import DomainBC as JDomainBC
from ibamr_tpu.bc import dirichlet_axis as jdirichlet_axis
from ibamr_tpu.bc import periodic_axis as jperiodic_axis
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import adv_diff as jad
from ibamr_tpu.integrators import ins_vc as jvc
from ibamr_tpu_torch.analysis.graph_census import (graph_census,
                                                   grid_layout_census)
from ibamr_tpu_torch.bc import (AxisBC, DomainBC, dirichlet_axis,
                                neumann_axis, periodic_axis)
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators import adv_diff as tad
from ibamr_tpu_torch.integrators import ins_vc as tvc
from ibamr_tpu_torch.ops.godunov import advect
from ibamr_tpu_torch.parallel import spmd
from ibamr_tpu_torch.parallel.mesh import (grid_pspec, make_mesh,
                                           make_sharded_step, place_state,
                                           unshard_state)
from ibamr_tpu_torch.physics import level_set as ls
from ibamr_tpu_torch.solvers import multigrid
from ibamr_tpu_torch.solvers.multigrid import PoissonMultigrid
from ibamr_tpu_torch.utils import checkpoint_sharded as cs
from ibamr_tpu_torch.utils.tree import leaves

SOLVE = 1e-9          # tests/test_torch_ins_vc.py: fields through CG
SOLVE_RTOL = 1e-10    # tests/test_torch_adv_diff.py: the CN solves
SHARDED = 1e-12       # the reference's sharded bound (test_parallel.py)
ADV_SHARDED = 1e-13   # the reference's walled adv-diff sharded bound

VC_KW = dict(rho0=1.0, rho1=10.0, mu0=0.01, mu1=0.02, gravity=(0.0, -2.0),
             sigma=0.1, convective_op_type="upwind", reinit_interval=2,
             cg_tol=1e-10)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test (the suite runs in parallel
    workers; the block bodies are small)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _mesh(n=8):
    return make_mesh(n, max_axes=2, device="cpu")


def _rel(ref, got):
    ref = np.asarray(ref)
    got = np.asarray(got)
    assert got.shape == ref.shape, (got.shape, ref.shape)
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _drop(n, c=(0.5, 0.6), r=0.15):
    xs = [(np.arange(m) + 0.5) / m for m in n]
    X = np.meshgrid(*xs, indexing="ij")
    return r - np.sqrt(sum((x - cc) ** 2 for x, cc in zip(X, c)))


def _grids(n):
    lo, up = (0.0,) * len(n), (1.0,) * len(n)
    return JGrid(n=n, x_lo=lo, x_up=up), StaggeredGrid(n=n, x_lo=lo,
                                                       x_up=up)


def _grid_leaves(state, dim):
    return [x for x in leaves(state) if getattr(x, "dim", None)
            and x.dim() == dim]


# ---------------------------------------------------------------------------
# (a) the V-cycle, the level set and the advection on blocks
# ---------------------------------------------------------------------------

@contextlib.contextmanager
def _layouts():
    """Every whole tensor cut into Blocks or assembled from them, as
    (kind, shape) pairs (``spmd.GRID_LISTENERS``)."""
    seen = []

    def rec(kind, whole):
        seen.append((kind, tuple(whole.shape)))

    spmd.GRID_LISTENERS.append(rec)
    try:
        yield seen
    finally:
        spmd.GRID_LISTENERS.remove(rec)


@pytest.mark.parametrize("case", ["walled", "periodic", "gathered",
                                  "odd_fine"])
def test_vcycle_on_blocks_is_the_whole_vcycle(case, monkeypatch):
    """32x24 on (4, 2), every level cut (``MIN_BLOCK`` 1): levels 32x24,
    16x12, 8x6; the coarsest level's blocks are 2x3 cells, the second
    row of them at offset 3 (odd). On 24x24 the 6x6 level does not divide
    over the 4 shards of axis 0 and runs whole on the first shard, the
    12x12 level's odd (3-cell) blocks gathered before their restriction;
    at the default ``MIN_BLOCK`` (64) every level below the finest runs
    there, the finest level's blocks restricted in place and only the
    coarse level gathered -- never a tensor of the fine grid's shape.
    On 12x24 the finest blocks are odd (3 cells): the fine residual is
    gathered, and the census counts it as a whole-grid layout."""
    n = {"gathered": (24, 24), "odd_fine": (12, 24)}.get(case, (32, 24))
    walls = case != "periodic"
    rng = np.random.default_rng(3)
    D = torch.tensor(0.5 + rng.random(n))
    f = torch.tensor(rng.standard_normal(n))
    bc = DomainBC(axes=tuple(neumann_axis() if walls else AxisBC()
                             for _ in n))
    dx = tuple(1.0 / s for s in n)
    whole = PoissonMultigrid(n, bc, dx, D=D, device="cpu")
    want = whole.vcycle(torch.zeros_like(f), f)
    mesh = _mesh()
    spec = grid_pspec(mesh, 2)
    Db, fb = spmd.Blocks.cut(mesh, D, spec), spmd.Blocks.cut(mesh, f, spec)
    with monkeypatch.context() as mp:
        mp.setattr(multigrid, "MIN_BLOCK", 1)
        with spmd.audit_blocks() as audit, grid_layout_census() as lay, \
                _layouts() as seen:
            mg = PoissonMultigrid(n, bc, dx, D=Db, device="cpu")
            got = mg.vcycle(torch.zeros_like(fb), fb)
    assert isinstance(got, spmd.Blocks) and audit["bodies"] > 0
    coarse = [shape for kind, shape in seen if kind.startswith("coarse")]
    assert n not in coarse
    if case == "odd_fine":
        assert [lv.blocks for lv in mg.levels] == [True, False]
        assert lay["whole_grid_layouts"] >= 2
        assert ("assemble", n) in seen and ("cut", n) in seen
    else:
        assert lay["whole_grid_layouts"] == 0
    if case == "gathered":
        assert [lv.blocks for lv in mg.levels] == [True, True, False]
        assert lay["coarse_gathers"] >= 1 and lay["coarse_scatters"] >= 1
        assert set(coarse) == {(12, 12)}
    elif case != "odd_fine":
        coarse_lv = mg.levels[-1]
        assert coarse_lv.blocks and coarse_lv.shape == (8, 6)
        offsets = {lo for i in range(mesh.size)
                   for lo, _ in [got.sharding.index(i, coarse_lv.shape)[1]]}
        assert any(o % 2 for o in offsets)
        assert lay["coarse_gathers"] == 0
    got = got.assemble()
    if walls:
        assert torch.equal(got, want)
    else:
        assert _rel(want.numpy(), got.numpy()) <= 1e-14
    with grid_layout_census() as lay, _layouts() as seen:
        dflt = PoissonMultigrid(n, bc, dx, D=Db, device="cpu")
        again = dflt.vcycle(torch.zeros_like(fb), fb)
    assert [lv.blocks for lv in dflt.levels][:2] == [True, False]
    if case != "odd_fine":
        assert lay["whole_grid_layouts"] == 0
        assert {shape for _, shape in seen} == {tuple(s // 2 for s in n)}
    again = again.assemble()
    assert torch.equal(again, want) if walls else \
        _rel(want.numpy(), again.numpy()) <= 1e-14


@pytest.mark.parametrize("walls", [(True, True), (False, True)])
def test_level_set_and_advection_on_blocks_are_bitwise(walls):
    """The reinitialization (20 iterations), the Godunov advection and
    the curvature with walls on a split axis: the wall masks by global
    index, so the edge shards mask what the whole grid masks."""
    n = (32, 32)
    dx = (1.0 / 32, 1.0 / 32)
    rng = np.random.default_rng(5)
    phi = torch.tensor(_drop(n, c=(0.1, 0.5), r=0.2)
                       + 0.01 * rng.standard_normal(n))
    u = [torch.tensor(0.3 * rng.standard_normal(n)) for _ in range(2)]
    for d in range(2):
        if walls[d]:
            u[d][(slice(None),) * d + (slice(0, 1),)] = 0.0
    mesh = _mesh()
    spec = grid_pspec(mesh, 2)
    pb = spmd.Blocks.cut(mesh, phi, spec)
    ub = tuple(spmd.Blocks.cut(mesh, c, spec) for c in u)
    with spmd.audit_blocks():
        r = ls.reinitialize(pb, dx, iters=20, wall_axes=walls)
        a = advect(pb, ub, dx, 1e-2, wall_axes=walls)
        k = ls.curvature(pb, dx, wall_axes=walls)
    assert torch.equal(r.assemble(),
                       ls.reinitialize(phi, dx, iters=20, wall_axes=walls))
    assert torch.equal(a.assemble(), advect(phi, tuple(u), dx, 1e-2,
                                            wall_axes=walls))
    assert torch.equal(k.assemble(), ls.curvature(phi, dx,
                                                  wall_axes=walls))


# ---------------------------------------------------------------------------
# (b) the two-phase steps
# ---------------------------------------------------------------------------

def _vc_pair(n, walls, cons=False, **over):
    jg, tg = _grids(n)
    kw = dict(VC_KW, **over)
    if walls:
        kw["wall_axes"] = (True,) * len(n)
    jc = jvc.INSVCConservativeIntegrator if cons \
        else jvc.INSVCStaggeredIntegrator
    tc = tvc.INSVCConservativeIntegrator if cons \
        else tvc.INSVCStaggeredIntegrator
    return (jc(jg, dtype=jnp.float64, **kw),
            tc(tg, dtype=torch.float64, device="cpu", **kw))


def _vc_run(n, walls, mesh, steps, dt, cons=False, **over):
    """(JAX single-device state, port unsharded state, port sharded
    state, unsharded CG iterations, sharded CG iterations)."""
    ji, ti = _vc_pair(n, walls, cons, **over)
    phi = _drop(n, c=(0.5,) * (len(n) - 1) + (0.6,))
    js = (jvc.advance_vc_conservative if cons else jvc.advance_vc)(
        ji, ji.initialize(jnp.asarray(phi)), dt, steps)
    ts = ti.initialize(phi)
    step = make_sharded_step(ti, mesh)
    sh = place_state(ts, ti.grid, mesh)
    its, sits = [], []
    for _ in range(steps):
        ts = ti.step(ts, dt)
        its.append(ti.last_solve_stats["iters"])
        sh = step(sh, dt)
        sits.append(step.integ.last_solve_stats["iters"])
    return js, ts, sh, its, sits


def _check_vc(js, ts, sh, its, sits, dim):
    assert sits == its
    for x in (*sh.u, sh.p, sh.phi):
        assert isinstance(x, spmd.Blocks)
    assert all(isinstance(x, spmd.Blocks) for x in _grid_leaves(sh, dim))
    w = unshard_state(sh)
    fields = [(a, b, c) for a, b, c in zip(js.u, ts.u, w.u)]
    fields += [(js.p, ts.p, w.p), (js.phi, ts.phi, w.phi)]
    for ref, plain, got in fields:
        assert _rel(np.asarray(ref), got.numpy()) <= SOLVE
        np.testing.assert_allclose(got.numpy(), plain.numpy(),
                                   rtol=SHARDED, atol=SHARDED)
    assert w.k == ts.k and float(w.t) == float(ts.t)


@pytest.mark.parametrize("walls", [False, True])
def test_vc_step_on_blocks_follows_reference_and_unsharded(walls):
    js, ts, sh, its, sits = _vc_run((32, 32), walls, _mesh(), 4, 5e-4)
    assert sh.u[0].mesh.shape == {"x": 4, "y": 2}
    _check_vc(js, ts, sh, its, sits, 2)


def test_vc_conservative_walled_on_blocks():
    js, ts, sh, its, sits = _vc_run((32, 32), True, _mesh(4), 3, 5e-4,
                                    cons=True)
    assert isinstance(sh.rho, spmd.Blocks)
    _check_vc(js, ts, sh, its, sits, 2)
    np.testing.assert_allclose(unshard_state(sh).rho.numpy(),
                               ts.rho.numpy(), rtol=SHARDED, atol=SHARDED)
    assert _rel(np.asarray(js.rho), unshard_state(sh).rho.numpy()) <= SOLVE


def test_vc_periodic_3d_on_blocks():
    js, ts, sh, its, sits = _vc_run((16, 16, 16), False, _mesh(4), 2,
                                    5e-4, gravity=(0.0, 0.0, -2.0))
    assert sh.u[0].mesh.shape == {"x": 2, "y": 2}
    _check_vc(js, ts, sh, its, sits, 3)


# ---------------------------------------------------------------------------
# (c) the adv-diff step
# ---------------------------------------------------------------------------

def _adv_pair(n, tq, jq):
    jg, tg = _grids(n)
    return (jad.AdvDiffSemiImplicitIntegrator(jg, [jq], dtype=jnp.float64),
            tad.AdvDiffSemiImplicitIntegrator(tg, [tq], dtype=torch.float64,
                                              device="cpu"))


def _adv_run(ji, ti, Q0, steps, dt, u=None):
    mesh = _mesh()
    js = ji.initialize([jnp.asarray(Q0)])
    ts = ti.initialize([torch.tensor(Q0)])
    step = make_sharded_step(ti, mesh)
    sh = place_state(ts, ti.grid, mesh)
    tu = None if u is None else tuple(torch.tensor(c) for c in u)
    ju = None if u is None else tuple(jnp.asarray(c) for c in u)
    with spmd.audit_blocks():
        for _ in range(steps):
            js = ji.step(js, dt, u=ju)
            ts = ti.step(ts, dt, u=tu)
            sh = step(sh, dt, u=tu)
    assert all(isinstance(x, spmd.Blocks) for x in (*sh.Q, *sh.n_prev))
    got = unshard_state(sh).Q[0].numpy()
    assert _rel(np.asarray(js.Q[0]), got) <= SOLVE_RTOL
    assert np.max(np.abs(got - ts.Q[0].numpy())) <= ADV_SHARDED * max(
        1.0, float(ts.Q[0].abs().max()))


@pytest.mark.parametrize("moving", [False, True])
def test_adv_diff_walled_on_blocks(moving):
    """The reference's walled case (Dirichlet 0 / 1 on axis 0, periodic
    axis 1, kappa 0.05); ``moving`` adds an upwind velocity whose wall
    faces the step pins."""
    n = (32, 32)
    x = (np.arange(32) + 0.5) / 32
    Q0 = np.broadcast_to(np.sin(np.pi * x)[:, None], n).copy()
    tq = tad.TransportedQuantity(
        "Q", kappa=0.05, bc=DomainBC((dirichlet_axis(0.0, 1.0),
                                      periodic_axis())))
    jq = jad.TransportedQuantity(
        "Q", kappa=0.05, bc=JDomainBC((jdirichlet_axis(0.0, 1.0),
                                       jperiodic_axis())))
    ji, ti = _adv_pair(n, tq, jq)
    u = None
    if moving:
        rng = np.random.default_rng(7)
        u = [0.5 * rng.standard_normal(n) for _ in range(2)]
        u[0][0, :] = 0.0
    _adv_run(ji, ti, Q0, 5, 1e-3, u=u)


def test_adv_diff_periodic_cui_with_source_on_blocks():
    n = (32, 32)

    def src(lib):
        return lambda c, t, Q: lib.sin(2 * np.pi * c[0]) \
            * lib.cos(2 * np.pi * c[1]) * (1.0 + t)

    rng = np.random.default_rng(11)
    Q0 = rng.standard_normal(n)
    u = [0.3 + 0.1 * rng.standard_normal(n) for _ in range(2)]
    tq = tad.TransportedQuantity("Q", kappa=0.01, source=src(torch),
                                 convective_op_type="cui")
    jq = jad.TransportedQuantity("Q", kappa=0.01, source=src(jnp),
                                 convective_op_type="cui")
    ji, ti = _adv_pair(n, tq, jq)
    _adv_run(ji, ti, Q0, 4, 1e-3, u=u)


# ---------------------------------------------------------------------------
# (d) census, checkpoints, what stays pinned or raises
# ---------------------------------------------------------------------------

def _family_step(name, mesh):
    """(sharded step, placed state, extra step arguments) at 16^2."""
    n = (16, 16)
    _, g = _grids(n)
    phi = _drop(n)
    if name == "adv_diff":
        ti = tad.AdvDiffSemiImplicitIntegrator(
            g, [tad.TransportedQuantity("Q", kappa=0.01)],
            dtype=torch.float64, device="cpu")
        st = ti.initialize([torch.tensor(phi)])
        u = tuple(torch.full(n, 0.3, dtype=torch.float64)
                  for _ in range(2))
        sh = place_state(st, g, mesh)
        return make_sharded_step(ti, mesh), sh, dict(
            u=tuple(spmd.Blocks.cut(mesh, c, grid_pspec(mesh, 2))
                    for c in u))
    cls = tvc.INSVCConservativeIntegrator if name == "conservative" \
        else tvc.INSVCStaggeredIntegrator
    ti = cls(g, dtype=torch.float64, device="cpu",
             **dict(VC_KW, wall_axes=None if name == "vc_periodic"
                    else (True, True)))
    return make_sharded_step(ti, mesh), place_state(ti.initialize(phi), g,
                                                    mesh), {}


@pytest.mark.parametrize("name", ["vc_periodic", "vc_walled",
                                  "conservative", "adv_diff"])
def test_one_block_step_census_has_no_whole_grid_layout(name):
    mesh = _mesh(4)
    step, sh, kw = _family_step(name, mesh)
    with _layouts() as seen:
        cen = graph_census(lambda s: step(s, 1e-3, **kw), (sh,))
    assert cen["whole_grid_layouts"] == 0
    assert cen["ppermute_prims"] > 0
    # the multigrid's levels below the finest (blocks thinner than 64
    # cells) run on the first shard: the restricted residual (8x8, never
    # the fine 16x16 grid) gathered once a V-cycle, under its own name
    assert (cen["coarse_gathers"] > 0) == (name != "adv_diff")
    assert {shape for _, shape in seen} <= {(8, 8)}


def test_ghost_fill_moves_each_slab_to_its_shard():
    """8 shards cycling over 6 GPUs ((4, 2); fake tensors, so no card is
    needed): along x, shard 0 on cuda:0 has its lo neighbour (shard 6)
    on cuda:0 and its hi neighbour (shard 2) on cuda:2. Every padded
    block lands on its shard's device."""
    from torch._subclasses.fake_tensor import FakeTensorMode

    mesh = make_mesh(devices=[f"cuda:{i % 6}" for i in range(8)])
    assert mesh.shape == {"x": 4, "y": 2}
    with FakeTensorMode():
        blocks = [torch.zeros(4, 3, device=mesh.device(i))
                  for i in range(mesh.size)]
        out = spmd.ghost_fill(mesh, blocks, "x", 0, 1)
    assert [o.device for o in out] == [mesh.device(i)
                                       for i in range(mesh.size)]
    assert all(tuple(o.shape) == (6, 3) for o in out)


def test_vc_block_state_checkpoint_round_trips(tmp_path):
    mesh = _mesh()
    _, g = _grids((32, 32))
    ti = tvc.INSVCStaggeredIntegrator(g, dtype=torch.float64, device="cpu",
                                      **dict(VC_KW, wall_axes=(True, True)))
    step = make_sharded_step(ti, mesh)
    s = step(place_state(ti.initialize(_drop((32, 32))), g, mesh), 5e-4)
    d = str(tmp_path / "ck")
    cs.save_sharded_checkpoint(d, s, 1, mesh=mesh)
    assert cs.verify_sharded_checkpoint(d, 1)
    tmpl = place_state(ti.initialize(np.zeros((32, 32))), g, mesh)
    got, k, man = cs.restore_sharded(d, tmpl)
    assert k == 1 and man["mesh"]["n_shards"] == 8
    assert all(isinstance(x, spmd.Blocks) for x in _grid_leaves(got, 2))
    assert _same(got, s)
    # the restored state steps on, bitwise the state that never stopped
    assert _same(step(got, 5e-4), step(s, 5e-4))


def _same(a, b):
    """Bitwise equal states (the host step counter may come back as a
    0-dim tensor)."""
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(
        torch.equal(x, y) if isinstance(x, spmd.Blocks)
        else torch.equal(torch.as_tensor(x), torch.as_tensor(y))
        for x, y in zip(la, lb))


def test_open_outlet_pinned_and_refusals():
    mesh = _mesh(4)
    _, g = _grids((16, 16))
    vc = tvc.INSVCStaggeredIntegrator(
        g, rho0=1.0, rho1=2.0, open_outlet=True, wall_axes=(False, True),
        dtype=torch.float64, device="cpu")
    step = make_sharded_step(vc, mesh)
    assert step.integ is vc
    out = step(vc.initialize(torch.tensor(_drop((16, 16)))), 1e-3)
    assert isinstance(out.u[0], torch.Tensor)
    assert spmd.sharding_of(out.u[0]).mesh is mesh
    phi = spmd.Blocks.cut(mesh, torch.tensor(_drop((16, 16))),
                          grid_pspec(mesh, 2))
    with pytest.raises(TypeError, match="fast_sweeping_distance"):
        ls.fast_sweeping_distance(phi, g.dx)
    thin = tvc.INSVCStaggeredIntegrator(
        StaggeredGrid(n=(16, 16), x_lo=(0.0, 0.0), x_up=(1.0, 1.0)),
        sigma=0.1, dtype=torch.float64, device="cpu")
    with pytest.raises(ValueError, match="ghost width 3"):
        make_sharded_step(thin, make_mesh(8, max_axes=1, device="cpu"))
