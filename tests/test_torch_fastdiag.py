"""Port parity of ``solvers/fastdiag.py``: every centering (cc,
fc_pinned) and BC mix (periodic by FFT or by the dense Fourier basis,
Dirichlet, Neumann, Robin), against ibamr_tpu at f64 on the CPU. Both
packages take the same host ``numpy.linalg.eigh`` eigenvectors, so the
solutions agree to 1e-12 relative; each solve leaves a residual below
1e-10 through the BC-aware operator."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import bc as jbc
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.solvers import fastdiag as jfd
from ibamr_tpu_torch import bc as tbc
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.solvers import fastdiag as tfd

N = (12, 10, 8)
X_UP = (1.0, 0.8, 1.2)


def _axis(mod, k):
    return {"p": mod.AxisBC(), "d": mod.dirichlet_axis(),
            "n": mod.neumann_axis(),
            "r": mod.robin_axis(1.5, 0.25)}[k]


CASES = [("pd", "cc"), ("dd", "cc"), ("nn", "cc"), ("rd", "cc"),
         ("pnr", "ccc"), ("dn", "fc"), ("pd", "cf"), ("ddd", "fcc"),
         ("dpn", "ccf")]


@pytest.mark.parametrize("kinds,cents", CASES)
@pytest.mark.parametrize("dense", [False, True])
def test_solve_matches_reference_and_inverts_the_operator(kinds, cents,
                                                          dense):
    dim = len(kinds)
    cent = tuple("cc" if c == "c" else "fc_pinned" for c in cents)
    n, x_up = N[:dim], X_UP[:dim]
    jg = JGrid(n=n, x_lo=(0.0,) * dim, x_up=x_up)
    tg = TGrid(n=n, x_lo=(0.0,) * dim, x_up=x_up)
    jb = jbc.DomainBC(axes=tuple(_axis(jbc, k) for k in kinds))
    tb = tbc.DomainBC(axes=tuple(_axis(tbc, k) for k in kinds))
    rhs = np.random.default_rng(dim).standard_normal(n)
    js = jfd.FastDiagSolver(jg, jb, cent, dense_periodic=dense)
    ts = tfd.FastDiagSolver(tg, tb, cent, dense_periodic=dense,
                            device="cpu")
    alpha, beta = 3.0, -0.7
    ref = np.asarray(js.solve(jnp.asarray(rhs), alpha, beta))
    got = ts.solve(torch.tensor(rhs), alpha, beta)
    assert got.shape == ref.shape
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    if all(c == "cc" for c in cent):
        resid = alpha * got + beta * tbc.laplacian_cc(got, tb, tg.dx)
        assert float(torch.max(torch.abs(resid - torch.tensor(rhs)))) < 1e-10
    for d, c in enumerate(cent):
        if c == "fc_pinned" and kinds[d] != "p":
            assert float(torch.max(torch.abs(got.select(d, 0)))) == 0.0


@pytest.mark.parametrize("kinds", ["nn", "pn", "pp"])
def test_zero_nullspace_poisson(kinds):
    n = N[:2]
    jg = JGrid(n=n, x_lo=(0.0, 0.0), x_up=X_UP[:2])
    tg = TGrid(n=n, x_lo=(0.0, 0.0), x_up=X_UP[:2])
    jb = jbc.DomainBC(axes=tuple(_axis(jbc, k) for k in kinds))
    tb = tbc.DomainBC(axes=tuple(_axis(tbc, k) for k in kinds))
    rhs = np.random.default_rng(7).standard_normal(n)
    rhs -= rhs.mean()
    ref = np.asarray(jfd.FastDiagSolver(jg, jb, ("cc", "cc")).solve(
        jnp.asarray(rhs), 0.0, 1.0, zero_nullspace=True))
    ts = tfd.FastDiagSolver(tg, tb, ("cc", "cc"), device="cpu")
    got = ts.solve(torch.tensor(rhs), 0.0, 1.0, zero_nullspace=True)
    assert np.max(np.abs(got.numpy() - ref)) <= 1e-12 * np.max(np.abs(ref))
    resid = tbc.laplacian_cc(got, tb, tg.dx) - torch.tensor(rhs)
    assert float(torch.max(torch.abs(resid))) < 1e-10
    assert abs(float(got.mean())) < 1e-12


def test_1d_matrices_and_bad_centering():
    ax = tbc.robin_axis(2.0, 1.0)
    np.testing.assert_array_equal(
        tfd.laplacian_1d_cc(6, 0.1, ax),
        jfd.laplacian_1d_cc(6, 0.1, jbc.robin_axis(2.0, 1.0)))
    np.testing.assert_array_equal(tfd.laplacian_1d_fc_pinned(6, 0.1),
                                  jfd.laplacian_1d_fc_pinned(6, 0.1))
    np.testing.assert_array_equal(tfd.laplacian_1d_periodic(6, 0.1),
                                  jfd.laplacian_1d_periodic(6, 0.1))
    g = TGrid(n=(4, 4), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    with pytest.raises(ValueError, match="centering"):
        tfd.FastDiagSolver(g, tbc.DomainBC(axes=(tbc.dirichlet_axis(),) * 2),
                           ("cc", "node"), device="cpu")
