"""CUDA-graph replay on the card (``utils/cuda_graph.py``): the walled
INS ``advance`` loop and the Stokes solver's FGMRES operator and
preconditioner, each replayed as a CUDA graph, give bitwise the results
of launching their kernels one by one (the L-level projection, FAC
included, and the implicit step's tangent FGMRES too). Needs an NVIDIA
GPU and skips without one. The file imports neither JAX nor the JAX package:

    python -m pytest --noconftest -p no:cacheprovider -m cuda \
        tests/test_torch_cuda_graphs.py
"""

import numpy as np
import pytest
import torch

from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator, advance
from ibamr_tpu_torch.solvers.krylov import fgmres_flat, flat_operators
from ibamr_tpu_torch.solvers.stokes import StaggeredStokesSolver, channel_bc
from ibamr_tpu_torch.utils.cuda_graph import Graphed


def _needs_gpu():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: CUDA graphs run only there")


@pytest.mark.cuda
def test_graphed_function_replays_on_new_inputs():
    _needs_gpu()
    x = torch.arange(6.0, device="cuda")
    g = Graphed(lambda t: (t[0] * 2.0, t[0].sum()), (x,))
    a, s = g((x + 1.0,))
    assert torch.equal(a, (x + 1.0) * 2.0) and float(s) == 21.0


@pytest.mark.cuda
@pytest.mark.parametrize("op", ["ppm", "centered"])
def test_walled_advance_graphed_equals_eager(op):
    _needs_gpu()
    grid = StaggeredGrid(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    kw = dict(mu=0.01, convective_op_type=op, wall_axes=(True, True),
              wall_tangential={(0, 1, 1): 1.0})
    integ = INSStaggeredIntegrator(grid, **kw)

    def eager(state, steps):
        for _ in range(steps):
            state = integ.step(state, 0.005)
        return state

    a = advance(integ, integ.initialize(), 0.005, 12)
    b = eager(integ.initialize(), 12)
    for x, y in zip(a.u + (a.p, a.t, a.k), b.u + (b.p, b.t, b.k)):
        assert torch.equal(x, y)
    c = advance(integ, a, 0.005, 3)            # the cached graph again
    d = eager(b, 3)
    assert all(torch.equal(x, y) for x, y in zip(c.u, d.u))
    assert list(integ._step_graphs) == [0.005]


@pytest.mark.cuda
def test_stokes_solve_graphed_equals_eager():
    _needs_gpu()
    n = (24, 12)
    solver = StaggeredStokesSolver(n, (2.0 / 24, 1.0 / 12), channel_bc(2),
                                   alpha=200.0, mu=0.05, tol=1e-5,
                                   dtype=torch.float32)
    y = (np.arange(n[1]) + 0.5) / n[1]
    prof = torch.tensor(4.0 * y * (1.0 - y), dtype=torch.float32,
                        device="cuda")[None, :]
    rhs = solver.make_rhs(bdry={(0, 0, 0): prof, (1, 0, 0): 0.0})
    for alpha in (None, 150.0):
        a = solver.solve(rhs, alpha=alpha)
        b = fgmres_flat(*flat_operators(
            lambda x: solver.operator(x, alpha=alpha),
            lambda r: solver.precondition(r, alpha=alpha), rhs), rhs,
            m=solver.m, tol=solver.tol, restarts=solver.restarts)
        u, p = b.x
        assert not solver.p_nullspace and a.iters == b.iters
        assert all(torch.equal(x, z) for x, z in zip(a.u + (a.p,),
                                                     u + (p,)))
    assert len(solver._graphs) == 2


@pytest.mark.cuda
@pytest.mark.parametrize("dim", [2, 3])
def test_composite_projection_graphed_equals_eager(dim):
    """The two-level composite projection with its FGMRES operator and
    preconditioner replayed as CUDA graphs against the same projection on
    the eager flat operators: equal restarts, bitwise equal fields."""
    _needs_gpu()
    from ibamr_tpu_torch.amr import FineBox
    from ibamr_tpu_torch.amr_ins import CompositeProjection

    n = (32, 24, 16)[:dim]
    grid = StaggeredGrid(n=n, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    box = FineBox(lo=(4,) * dim, shape=(8,) * dim)
    rng = np.random.default_rng(dim)
    uc = tuple(torch.tensor(0.1 * rng.standard_normal(n), device="cuda",
                            dtype=torch.float32) for _ in range(dim))
    uf = tuple(torch.tensor(0.1 * rng.standard_normal(tuple(
        m + (1 if a == d else 0) for a, m in enumerate(box.fine_n))),
        device="cuda", dtype=torch.float32) for d in range(dim))
    graphed = CompositeProjection(grid, box, tol=3e-6)
    eager = CompositeProjection(grid, box, tol=3e-6)
    eager.flat_ops = lambda t: flat_operators(eager.operator,
                                              eager._precondition, t)
    for _ in range(2):                       # the cached graphs again
        a = graphed.project(uc, uf)
        b = eager.project(uc, uf)
        assert graphed.last_solve_stats["iters"] == \
            eager.last_solve_stats["iters"]
        for x, y in zip(a[0] + a[1] + a[2:], b[0] + b[1] + b[2:]):
            assert torch.equal(x, y)
    assert graphed._graphs is not None and eager._graphs is None


def _levels_and_field(dim):
    from ibamr_tpu_torch.amr import FineBox
    from ibamr_tpu_torch.amr_multilevel import build_hierarchy

    n = (32, 24, 16)[:dim]
    grid = StaggeredGrid(n=n, x_lo=(0.0,) * dim, x_up=(1.0,) * dim)
    levels = build_hierarchy(grid, [FineBox(lo=(4,) * dim, shape=(8,) * dim),
                                    FineBox(lo=(3,) * dim,
                                            shape=(8,) * dim)])
    rng = np.random.default_rng(dim)
    us = tuple(tuple(torch.tensor(0.1 * rng.standard_normal(tuple(
        m + (1 if (l > 0 and a == d) else 0) for a, m in enumerate(
            spec.grid.n))), device="cuda", dtype=torch.float32)
        for d in range(dim)) for l, spec in enumerate(levels))
    return levels, us


@pytest.mark.cuda
@pytest.mark.parametrize("fac", [False, True])
@pytest.mark.parametrize("dim", [2, 3])
def test_multilevel_projection_graphed_equals_eager(dim, fac):
    """The three-level projection with its operator and preconditioner
    (the default, or the graph-safe FAC V-cycle) replayed as CUDA graphs
    against the same projection on the eager flat operators: equal
    restarts, bitwise equal fields."""
    _needs_gpu()
    from ibamr_tpu_torch.amr_ins_multilevel import \
        MultiLevelCompositeProjection
    from ibamr_tpu_torch.solvers.fac import FACMultilevelPoisson

    levels, us = _levels_and_field(dim)

    def make():
        M = FACMultilevelPoisson(levels, dtype=torch.float32).precondition \
            if fac else None
        return MultiLevelCompositeProjection(levels, tol=3e-6,
                                             preconditioner=M)

    graphed, eager = make(), make()
    eager.flat_ops = lambda t: flat_operators(eager.operator,
                                              eager._precondition, t)
    for _ in range(2):                       # the cached graphs again
        a, ia = graphed.project(us)
        b, ib = eager.project(us)
        assert ia == ib
        for ua, ub in zip(a, b):
            for x, y in zip(ua, ub):
                assert torch.equal(x, y)
    assert graphed._graphs is not None and eager._graphs is None


@pytest.mark.cuda
def test_tangent_fgmres_through_graphs_equals_eager():
    """The tangent FGMRES of the two-level implicit step over the graphed
    composite operator and preconditioner against the same iteration on
    the eager flat operators: bitwise equal primal and tangent."""
    _needs_gpu()
    from ibamr_tpu_torch.amr import FineBox
    from ibamr_tpu_torch.amr_ins import CompositeProjection
    from ibamr_tpu_torch.solvers.krylov import fgmres_flat_jvp
    from ibamr_tpu_torch.utils.tree import ravel

    grid = StaggeredGrid(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    box = FineBox(lo=(8, 8), shape=(16, 16))
    proj = CompositeProjection(grid, box, tol=1e-8)
    rng = np.random.default_rng(5)
    rhs = (torch.tensor(rng.standard_normal((32, 32)), device="cuda"),
           torch.tensor(rng.standard_normal((32, 32)), device="cuda"))
    b = ravel(rhs)[0]
    db = torch.tensor(rng.standard_normal(b.shape[0]), device="cuda")
    sol_g, dx_g = fgmres_flat_jvp(*proj.flat_ops(rhs), b, db, m=16,
                                  tol=1e-8, restarts=2)
    sol_e, dx_e = fgmres_flat_jvp(
        *flat_operators(proj.operator, proj._precondition, rhs), b, db,
        m=16, tol=1e-8, restarts=2)
    plain = fgmres_flat(*proj.flat_ops(rhs), b, m=16, tol=1e-8, restarts=2)
    assert sol_g.iters == sol_e.iters == plain.iters
    assert torch.equal(sol_g.x, sol_e.x) and torch.equal(dx_g, dx_e)
    assert torch.equal(ravel(plain.x)[0], sol_g.x)
