"""Port parity of ``bc.py``: ghost fills (periodic, Dirichlet, Neumann,
Robin; one and three layers; constant and spatially varying data), the
BC-aware Laplacian and the ghost reflection coefficient, against
ibamr_tpu at f64 on the CPU (elementwise arithmetic in the same order:
1e-14 relative), plus the cases of ``tests/test_robin_bc.py`` run on the
port."""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import bc as jbc
from ibamr_tpu_torch import bc as tbc
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.solvers.fastdiag import FastDiagSolver

RTOL = 1e-14
DX = (0.1, 0.125, 0.2)


def _close(ref, got, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.max(np.abs(ref)), 1e-300))


def _axes(mod, kinds):
    make = {"p": lambda: mod.AxisBC(),
            "d": lambda: mod.dirichlet_axis(0.7, -0.3),
            "n": lambda: mod.neumann_axis(0.2, 1.1),
            "r": lambda: mod.robin_axis(1.5, 0.25, lo=0.4, hi=-0.9)}
    return mod.DomainBC(axes=tuple(make[k]() for k in kinds))


@pytest.mark.parametrize("kinds", ["pd", "dn", "rn", "rr", "pdr", "nrp"])
@pytest.mark.parametrize("width", [1, 3])
def test_fill_ghosts_and_laplacian_match_reference(kinds, width):
    rng = np.random.default_rng(len(kinds) * 10 + width)
    shape = (8, 6, 5)[:len(kinds)]
    Q = rng.standard_normal(shape)
    dx = DX[:len(kinds)]
    jb, tb = _axes(jbc, kinds), _axes(tbc, kinds)
    _close(jbc.fill_ghosts_cc(jnp.asarray(Q), jb, dx, width=width),
           tbc.fill_ghosts_cc(torch.tensor(Q), tb, dx, width=width))
    _close(jbc.laplacian_cc(jnp.asarray(Q), jb, dx),
           tbc.laplacian_cc(torch.tensor(Q), tb, dx))


@pytest.mark.parametrize("width", [1, 2])
def test_spatially_varying_boundary_data(width):
    rng = np.random.default_rng(5)
    Q = rng.standard_normal((8, 6))
    g0, g1 = rng.standard_normal((1, 6)), rng.standard_normal((8,))[:, None]
    kinds = "rd"
    jdata = {(0, 0): jnp.asarray(g0), (1, 1): jnp.asarray(g1)}
    tdata = {(0, 0): torch.tensor(g0), (1, 1): torch.tensor(g1)}
    _close(jbc.fill_ghosts_cc(jnp.asarray(Q), _axes(jbc, kinds), DX[:2],
                              bdry_data=jdata, width=width),
           tbc.fill_ghosts_cc(torch.tensor(Q), _axes(tbc, kinds), DX[:2],
                              bdry_data=tdata, width=width))
    _close(jbc.laplacian_cc(jnp.asarray(Q), _axes(jbc, kinds), DX[:2],
                            bdry_data=jdata),
           tbc.laplacian_cc(torch.tensor(Q), _axes(tbc, kinds), DX[:2],
                            bdry_data=tdata))
    with pytest.raises(ValueError, match="incompatible"):
        tbc.fill_ghosts_cc(torch.tensor(Q), _axes(tbc, kinds), DX[:2],
                           bdry_data={(1, 0): torch.zeros(5, 1)})


def test_reflect_coefficient_and_validation():
    for side in (("dirichlet", 1.0), ("neumann", 0.0), ("robin", 0.0)):
        kw = dict(a=2.0, b=0.5) if side[0] == "robin" else {}
        assert tbc.ghost_reflect_coeff(tbc.SideBC(side[0], side[1], **kw),
                                       0.1) == \
            jbc.ghost_reflect_coeff(jbc.SideBC(side[0], side[1], **kw), 0.1)
    with pytest.raises(ValueError, match="robin"):
        tbc.SideBC("robin", 0.0, a=0.0, b=0.0)
    with pytest.raises(ValueError, match="periodic"):
        tbc.AxisBC(tbc.SideBC("periodic"), tbc.SideBC("dirichlet"))
    with pytest.raises(ValueError, match="ill-posed"):
        tbc.ghost_reflect_coeff(tbc.SideBC("robin", a=1.0, b=-0.05), 0.1)
    assert tbc.DomainBC.periodic(3).all_periodic


# -- the cases of tests/test_robin_bc.py, on the port ------------------------------

def test_robin_reduces_to_dirichlet_neumann():
    Q = torch.tensor(np.random.default_rng(0).standard_normal((8, 8)))
    for named, a, b in ((tbc.dirichlet_axis(0.7, -0.3), 1.0, 0.0),
                        (tbc.neumann_axis(0.7, -0.3), 0.0, 1.0)):
        rob = tbc.robin_axis(a, b, lo=0.7, hi=-0.3)
        g_named = tbc.fill_ghosts_cc(
            Q, tbc.DomainBC(axes=(named, tbc.AxisBC())), (0.1, 0.1))
        g_rob = tbc.fill_ghosts_cc(
            Q, tbc.DomainBC(axes=(rob, tbc.AxisBC())), (0.1, 0.1))
        np.testing.assert_allclose(g_rob.numpy(), g_named.numpy(),
                                   atol=1e-13)


def test_robin_ghost_satisfies_condition():
    Q = torch.tensor(np.random.default_rng(1).standard_normal((8, 6)))
    h, a, b, g = 0.125, 2.0, 0.5, 1.3
    dom = tbc.DomainBC(axes=(tbc.robin_axis(a, b, lo=g, hi=g), tbc.AxisBC()))
    G = tbc.fill_ghosts_cc(Q, dom, (h, h))
    ghost_lo, int_lo = G[0, 1:-1].numpy(), Q[0, :].numpy()
    q_face = 0.5 * (ghost_lo + int_lo)
    np.testing.assert_allclose(a * q_face + b * (ghost_lo - int_lo) / h, g,
                               atol=1e-12)


def test_fastdiag_robin_solve_consistent():
    g = StaggeredGrid(n=(16, 12), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    dom = tbc.DomainBC(axes=(tbc.robin_axis(1.5, 0.25), tbc.AxisBC()))
    solver = FastDiagSolver(g, dom, ("cc", "cc"), device="cpu")
    rhs = torch.tensor(np.random.default_rng(2).standard_normal(g.n))
    alpha, beta = 3.0, -0.7
    Q = solver.solve(rhs, alpha, beta)
    resid = alpha * Q + beta * tbc.laplacian_cc(Q, dom, g.dx)
    np.testing.assert_allclose(resid.numpy(), rhs.numpy(), atol=1e-10)


def _laplace_dirichlet_strip_error(n):
    g = StaggeredGrid(n=(n, n), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    dom = tbc.DomainBC(axes=(tbc.dirichlet_axis(), tbc.dirichlet_axis()))
    xc = (torch.arange(n, dtype=torch.float64) + 0.5) / n
    gdata = {(1, 0): torch.sin(math.pi * xc)[:, None]}
    solver = FastDiagSolver(g, dom, ("cc", "cc"), device="cpu")
    b_vec = tbc.laplacian_cc(torch.zeros(g.n, dtype=torch.float64), dom,
                             g.dx, bdry_data=gdata)
    Q = solver.solve(-b_vec, 0.0, 1.0)
    X, Y = np.meshgrid((np.arange(n) + 0.5) / n, (np.arange(n) + 0.5) / n,
                       indexing="ij")
    exact = np.sin(np.pi * X) * np.sinh(np.pi * (1 - Y)) / np.sinh(np.pi)
    return float(np.max(np.abs(Q.numpy() - exact)))


def test_spatially_varying_dirichlet_laplace():
    e32 = _laplace_dirichlet_strip_error(32)
    e64 = _laplace_dirichlet_strip_error(64)
    assert e64 < 1.5e-3, (e32, e64)
    assert e32 / e64 > 3.0, (e32, e64)
