"""The wall-bounded INS and IB steps on block-resident state
(``ibamr_tpu_torch/parallel/{spmd,fftpar,mesh}.py``,
``integrators/ins_walls.py``, ``ops/convection.py``) on the CPU at f64.

- Every wall stencil of the step on Blocks (the walled Laplacian with
  moving lids, the pressure gradient, the Neumann Laplacian, the
  divergence, and the ghost-padded convection of every scheme) is
  bitwise the whole-grid stencil, on 2D grids over (4, 2) and 1D meshes
  and a 3D grid over a (2, 2) mesh, for every wall set that includes a
  split axis. The velocity operands keep the storage convention of
  ``integrators/ins_walls.py``: the pinned slot of a wall-normal
  component holds 0.
- The pencil fast-diagonalization solve follows ``FastDiagSolver``
  within 1e-12 of the largest value: Dirichlet, Neumann and Robin ends,
  ``fc_pinned``, periodic axes beside wall axes, and the Neumann
  Poisson solve with ``zero_nullspace``.
- The walled INS step (the reference's cavity; a 3D duct) and the
  walled IB step (the reference's circle; a shell in the duct) through
  ``make_sharded_step`` follow the JAX package's single-device walled
  step over 3 steps within 1e-12 of the largest value; they are bitwise
  the same run to run, every grid array stays ``spmd.Blocks`` of the
  mesh, no whole-grid ``shard`` / ``unshard`` runs inside a step, and
  the census counts 0 whole-grid layouts a step.
- A walled block state saves shard by shard and restores into blocks
  bitwise.
"""

import itertools
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ib import IBExplicitIntegrator as JIB
from ibamr_tpu.integrators.ib import IBMethod as JIBMethod
from ibamr_tpu.integrators.ins import INSStaggeredIntegrator as JINS
from ibamr_tpu.models.shell3d import build_shell_example as jbuild_shell
from ibamr_tpu.ops.forces import ForceSpecs as JForceSpecs
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.bc import (AxisBC, DomainBC, dirichlet_axis,
                                neumann_axis, robin_axis)
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ib import IBExplicitIntegrator, IBMethod
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
from ibamr_tpu_torch.integrators.ins_walls import pin_normal
from ibamr_tpu_torch.models.shell3d import build_shell_example
from ibamr_tpu_torch.ops.forces import ForceSpecs
from ibamr_tpu_torch.parallel import spmd
from ibamr_tpu_torch.parallel.fftpar import PencilFastDiag
from ibamr_tpu_torch.parallel.mesh import (_block_fluid, grid_pspec,
                                           make_mesh, make_sharded_step,
                                           place_state, unshard_state)
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver
from ibamr_tpu_torch.utils import checkpoint_sharded as cs
from ibamr_tpu_torch.utils.tree import leaves

TOL = 1e-12


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _grid(shape, cls=StaggeredGrid):
    dim = len(shape)
    return cls(n=shape, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)


def _close(got, want, tol=TOL):
    want = np.asarray(want)
    g = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    scale = max(np.abs(want).max(), 1e-300)
    assert np.abs(g - want).max() <= tol * scale, \
        np.abs(g - want).max() / scale


def _same(got, want) -> bool:
    if isinstance(want, tuple):
        return len(got) == len(want) and all(_same(g, w)
                                             for g, w in zip(got, want))
    assert isinstance(got, spmd.Blocks)
    return torch.equal(got.assemble(), want)


def _bitwise(a, b) -> bool:
    la, lb = leaves(a), leaves(b)
    return len(la) == len(lb) and all(torch.equal(x, y)
                                      for x, y in zip(la, lb))


def _lids(walls):
    """A moving tangential velocity on both sides of every wall, for
    every component (distinct values, so a ghost taken from the wrong
    side or component shows)."""
    dim = len(walls)
    return {(d, e, s): 0.5 + d - 0.75 * s + 0.25 * e
            for e in range(dim) if walls[e]
            for d in range(dim) if d != e for s in (0, 1)}


# ---------------------------------------------------------------------------
# (a) the wall stencils on blocks
# ---------------------------------------------------------------------------

_MESHES = [((32, 32), 8, 2), ((32, 32), 4, 1), ((16, 16, 16), 4, 2)]
_STENCIL_CASES = [
    (shape, n, axes, walls)
    for shape, n, axes in _MESHES
    for walls in itertools.product((False, True), repeat=len(shape))
    if any(walls[:axes])]


@pytest.mark.parametrize(
    "shape,n_shards,axes,walls", _STENCIL_CASES,
    ids=[f"{len(s)}d-mesh{n}x{a}-" + "".join("W" if w else "p" for w in ws)
         for s, n, a, ws in _STENCIL_CASES])
def test_wall_stencils_on_blocks_are_bitwise(shape, n_shards, axes, walls):
    dim = len(shape)
    g = _grid(shape)
    mesh = make_mesh(n_shards, max_axes=axes, device="cpu")
    spec = grid_pspec(mesh, dim)
    rng = np.random.default_rng(sum(walls) + 3 * dim + n_shards)
    u = tuple(pin_normal(torch.tensor(rng.standard_normal(shape)), d, walls)
              for d in range(dim))
    p = torch.tensor(rng.standard_normal(shape))
    ub = tuple(spmd.Blocks.cut(mesh, c, spec) for c in u)
    pb = spmd.Blocks.cut(mesh, p, spec)
    dx = g.dx
    with spmd.audit_blocks() as audit:
        for scheme in ("centered", "upwind", "cui", "ppm"):
            plain = INSStaggeredIntegrator(
                g, mu=0.02, convective_op_type=scheme, wall_axes=walls,
                wall_tangential=_lids(walls), dtype=torch.float64,
                device="cpu")
            blk = _block_fluid(plain, mesh)
            assert _same(blk._convective(ub, dx),
                         plain._convective(u, dx)), scheme
        assert _same(blk.laplacian_vel(ub, dx), plain.laplacian_vel(u, dx))
        assert _same(blk.pressure_gradient(pb, dx),
                     plain.pressure_gradient(p, dx))
        assert _same(blk.laplacian_cc(pb, dx), plain.laplacian_cc(p, dx))
        assert _same(blk.divergence(ub, dx), plain.divergence(u, dx))
    assert audit["bodies"] > 0


# ---------------------------------------------------------------------------
# (b) the pencil fast-diagonalization solve
# ---------------------------------------------------------------------------

_FD_CASES = [
    ("dirichlet-neumann", (32, 32), 8, 2,
     (dirichlet_axis(), neumann_axis()), ("cc", "cc")),
    ("robin-pinned", (32, 32), 8, 2,
     (robin_axis(1.0, 0.5), dirichlet_axis()), ("cc", "fc_pinned")),
    ("pinned-periodic-1d", (32, 32), 4, 1,
     (dirichlet_axis(), AxisBC()), ("fc_pinned", "cc")),
    ("duct-pinned", (16, 16, 16), 4, 2,
     (dirichlet_axis(), dirichlet_axis(), AxisBC()),
     ("fc_pinned", "cc", "cc")),
    ("periodic-pinned-neumann", (16, 16, 16), 4, 1,
     (AxisBC(), dirichlet_axis(), neumann_axis()),
     ("cc", "fc_pinned", "cc")),
    ("neumann-poisson-2d", (32, 32), 8, 2,
     (neumann_axis(), neumann_axis()), ("cc", "cc")),
    ("neumann-duct-poisson", (16, 16, 16), 4, 2,
     (neumann_axis(), neumann_axis(), AxisBC()), ("cc", "cc", "cc")),
]


@pytest.mark.parametrize("shape,n_shards,axes,bcs,cents",
                         [c[1:] for c in _FD_CASES],
                         ids=[c[0] for c in _FD_CASES])
def test_pencil_fastdiag_matches_fastdiag(shape, n_shards, axes, bcs, cents):
    g = _grid(shape)
    solver = FastDiagSolver(g, DomainBC(axes=bcs), cents, device="cpu")
    mesh = make_mesh(n_shards, max_axes=axes, device="cpu")
    pencil = PencilFastDiag(solver, mesh)
    rng = np.random.default_rng(len(shape) + n_shards)
    rhs = torch.tensor(rng.standard_normal(shape))
    x = spmd.Blocks.cut(mesh, rhs, grid_pspec(mesh, len(shape)))
    with spmd.audit_blocks():
        for alpha, beta, zero in ((10.0, -0.5, False), (0.0, 1.0, True)):
            want = solver.solve(rhs, alpha, beta, zero_nullspace=zero)
            got = pencil.solve(x, alpha, beta, zero_nullspace=zero)
            assert isinstance(got, spmd.Blocks)
            _close(got.assemble(), want)
            # a whole tensor is cut and the result assembled
            _close(pencil.solve(rhs, alpha, beta, zero_nullspace=zero), want)
    if "fc_pinned" in cents:
        d = cents.index("fc_pinned")
        assert float(got.assemble().narrow(d, 0, 1).abs().max()) == 0.0


# ---------------------------------------------------------------------------
# (c)-(e) the walled INS and IB steps
# ---------------------------------------------------------------------------

def _grid_guard(monkeypatch, shape):
    """Patch ``spmd.shard`` / ``spmd.unshard`` (and every module's
    imported copy) to raise, once armed, on a whole tensor whose trailing
    dimensions are the grid's."""
    armed = [False]
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
            if armed[0] and dims[len(dims) - len(shape):] == shape:
                raise AssertionError(f"whole-grid {name} of {dims} inside "
                                     f"a step")
            return real[name](mesh, x, spec, *args, **kwargs)
        return fn

    for mod in list(sys.modules.values()):
        if not (getattr(mod, "__name__", "") or "").startswith(
                "ibamr_tpu_torch"):
            continue
        for name in real:
            if getattr(mod, name, None) is real[name]:
                monkeypatch.setattr(mod, name, guarded(name))
    return armed


def _run_sharded(monkeypatch, step, s0, grid, mesh, dt, fluid):
    """Three sharded steps from ``s0``, twice; the second run under the
    grid guard, and the census of one more step. Returns the state."""
    from ibamr_tpu_torch.analysis.graph_census import graph_census

    runs = []
    for k in range(2):
        s = place_state(s0, grid, mesh)
        if k:
            _grid_guard(monkeypatch, tuple(grid.n))[0] = True
        with spmd.audit_blocks() as audit:
            for _ in range(3):
                s = step(s, dt)
        assert audit["bodies"] > 0
        runs.append(s)
    assert _bitwise(runs[0], runs[1])
    s = runs[0]
    cen = graph_census(lambda st: step(st, dt), (s,))
    assert cen["whole_grid_layouts"] == 0
    assert cen["ppermute_prims"] > 0 and cen["all_to_all_prims"] > 0
    monkeypatch.undo()
    ins = fluid(s)
    for x in (*ins.u, ins.p, *ins.n_prev):
        assert isinstance(x, spmd.Blocks) and x.mesh is mesh
        assert all(b.device == mesh.device(i)
                   for i, b in enumerate(x.blocks))
    return s


_INS_CASES = {
    # the reference's cavity (tests/test_parallel.py)
    "cavity": dict(shape=(32, 32), n_shards=8, axes=2, walls=(True, True),
                   lid={(0, 1, 1): 1.0}, scheme="ppm", mu=0.01, u0=False),
    "duct": dict(shape=(16, 16, 16), n_shards=4, axes=2,
                 walls=(True, True, False), lid={}, scheme="centered",
                 mu=0.02, u0=True),
}


@pytest.mark.parametrize("case", list(_INS_CASES))
def test_walled_ins_sharded_matches_reference(monkeypatch, case):
    c = _INS_CASES[case]
    shape, walls, dim = c["shape"], c["walls"], len(c["shape"])
    kw = dict(mu=c["mu"], rho=1.0, wall_axes=walls,
              wall_tangential=c["lid"], convective_op_type=c["scheme"])
    u0 = None
    if c["u0"]:
        rng = np.random.default_rng(dim)
        u0 = tuple(pin_normal(torch.tensor(0.1 * rng.standard_normal(shape)),
                              d, walls).numpy() for d in range(dim))
    ji = JINS(_grid(shape, JGrid), dtype=jnp.float64, **kw)
    js = ji.initialize(u0_arrays=None if u0 is None
                       else tuple(map(jnp.asarray, u0)))
    jstep = jax.jit(ji.step, static_argnums=1)
    for _ in range(3):
        js = jstep(js, 1e-3)
    g = _grid(shape)
    ti = INSStaggeredIntegrator(g, dtype=torch.float64, device="cpu", **kw)
    mesh = make_mesh(c["n_shards"], max_axes=c["axes"], device="cpu")
    step = make_sharded_step(ti, mesh)
    assert step.integ.wall_ops.mesh is mesh
    s = _run_sharded(monkeypatch, step, ti.initialize(u0_arrays=u0), g,
                     mesh, 1e-3, lambda st: st)
    for a, b in zip(s.u, js.u):
        _close(a.assemble(), b)
    _close(s.p.assemble(), js.p)
    # the unsharded port step agrees too
    ref = ti.initialize(u0_arrays=u0)
    for _ in range(3):
        ref = ti.step(ref, 1e-3)
    w = unshard_state(s)
    for a, b in zip(w.u + (w.p,), ref.u + (ref.p,)):
        _close(a, b.numpy())


def _circle(walls_fluid):
    """The reference's walled IB circle (tests/test_parallel.py): 16
    markers on a stiff spring to a circle, over a 32^2 cavity; they start
    on an ellipse (the reference starts them on the circle, at rest), so
    the springs drive the fluid."""
    th = np.linspace(0, 2 * np.pi, 17)[:-1]
    X0 = np.stack([0.5 + 0.1 * np.cos(th), 0.5 + 0.1 * np.sin(th)], -1)
    start = np.stack([0.5 + 0.12 * np.cos(th), 0.5 + 0.085 * np.sin(th)],
                     -1)
    jins = JINS(_grid((32, 32), JGrid), mu=0.02, wall_axes=walls_fluid,
                dtype=jnp.float64)
    jX0 = jnp.asarray(X0)
    jinteg = JIB(jins, JIBMethod(JForceSpecs(), kernel="IB_4",
                                 force_fn=lambda X, U, t: -30.0 * (X - jX0)))
    tins = INSStaggeredIntegrator(_grid((32, 32)), mu=0.02,
                                  wall_axes=walls_fluid, dtype=torch.float64,
                                  device="cpu")
    tX0 = torch.tensor(X0)
    tinteg = IBExplicitIntegrator(
        tins, IBMethod(ForceSpecs(), kernel="IB_4",
                       force_fn=lambda X, U, t: -30.0 * (X - tX0)))
    return (jinteg, jinteg.initialize(jnp.asarray(start)), tinteg,
            tinteg.initialize(torch.tensor(start)), 8)


def _shell_in_duct(walls_fluid):
    """A 16^3 shell (the sharded IB test's) in a duct: the shell's
    IBMethod over a walled fluid on the same grid."""
    shell = dict(n_cells=16, n_lat=8, n_lon=8, mu=0.05,
                 use_fast_interaction=None)
    ji, js = jbuild_shell(dtype=jnp.float64, **shell)
    jins = JINS(ji.ins.grid, mu=0.05, wall_axes=walls_fluid,
                dtype=jnp.float64)
    jinteg = JIB(jins, ji.ib)
    ti, ts = build_shell_example(dtype=torch.float64, device="cpu", **shell)
    tins = INSStaggeredIntegrator(ti.ins.grid, mu=0.05,
                                  wall_axes=walls_fluid,
                                  dtype=torch.float64, device="cpu")
    tinteg = IBExplicitIntegrator(tins, ti.ib)
    return (jinteg, jinteg.initialize(js.X), tinteg,
            tinteg.initialize(convert.ib_state(js, device="cpu").X), 4)


@pytest.mark.parametrize("case,walls", [("circle", (True, True)),
                                        ("shell_in_duct",
                                         (True, True, False))])
def test_walled_ib_sharded_matches_reference(monkeypatch, case, walls):
    build = _circle if case == "circle" else _shell_in_duct
    jinteg, js, tinteg, ts, n_shards = build(walls)
    dt = 1e-3
    jstep = jax.jit(lambda s: jinteg.step(s, dt))
    for _ in range(3):
        js = jstep(js)
    mesh = make_mesh(n_shards, max_axes=2, device="cpu")
    step = make_sharded_step(tinteg, mesh)
    assert step.integ.ib.engine_name == "sharded"
    grid = tinteg.ins.grid
    s = _run_sharded(monkeypatch, step, ts, grid, mesh, dt,
                     lambda st: st.ins)
    assert s.X.device == mesh.first_device
    _close(s.X, js.X)
    assert float(torch.abs(s.X - ts.X).max()) > 0
    for a, b in zip(s.ins.u, js.ins.u):
        _close(a.assemble(), b)
    _close(s.ins.p.assemble(), js.ins.p)
    # the co-partitioned transfers on the walled grid give what the
    # unsharded walled step's transfers give
    ref = ts
    for _ in range(3):
        ref = tinteg.step(ref, dt)
    _close(s.X, ref.X.numpy())
    for a, b in zip(unshard_state(s.ins).u, ref.ins.u):
        _close(a, b.numpy())


# ---------------------------------------------------------------------------
# (f) checkpoints of walled block state
# ---------------------------------------------------------------------------

def test_walled_block_state_checkpoint_round_trips(tmp_path):
    g = _grid((32, 32))
    ti = INSStaggeredIntegrator(g, mu=0.01, wall_axes=(True, True),
                                wall_tangential={(0, 1, 1): 1.0},
                                convective_op_type="ppm",
                                dtype=torch.float64, device="cpu")
    mesh = make_mesh(8, max_axes=2, device="cpu")
    step = make_sharded_step(ti, mesh)
    s = place_state(ti.initialize(), g, mesh)
    for _ in range(2):
        s = step(s, 1e-3)
    d = str(tmp_path / "ck")
    cs.save_sharded_checkpoint(d, s, 2, mesh=mesh)
    assert cs.verify_sharded_checkpoint(d, 2)
    tmpl = place_state(ti.initialize(), g, mesh)
    got, k, man = cs.restore_sharded(d, tmpl)
    assert k == 2 and man["mesh"]["n_shards"] == 8
    assert all(isinstance(x, spmd.Blocks) for x in (*got.u, got.p))
    assert _bitwise(got, s)
    # the restored state steps on, bitwise the state that never stopped
    assert _bitwise(step(got, 1e-3), step(s, 1e-3))
