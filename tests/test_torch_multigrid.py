"""Port parity of ``solvers/multigrid.py``: one V-cycle equal to the
reference's to 1e-12 relative, and ``solve`` reaching its tolerance in
the reference's number of cycles, for constant and variable coefficients
under periodic, Dirichlet, Neumann and Robin BCs, at f64 on the CPU."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import bc as jbc
from ibamr_tpu.solvers import multigrid as jmg
from ibamr_tpu_torch import bc as tbc
from ibamr_tpu_torch.solvers import multigrid as tmg

SHAPE = (32, 16)
DX = (1.0 / 32, 0.5 / 16)


def _bc(mod, kinds):
    make = {"p": mod.AxisBC, "d": lambda: mod.dirichlet_axis(0.3, -0.2),
            "n": mod.neumann_axis,
            "r": lambda: mod.robin_axis(1.5, 0.25, lo=0.1)}
    return mod.DomainBC(axes=tuple(make[k]() for k in kinds))


def _close(ref, got, rtol=1e-12):
    ref = np.asarray(ref)
    assert np.max(np.abs(got.numpy() - ref)) <= rtol * np.max(np.abs(ref))


CASES = [("pp", 0.0, False), ("dn", 0.0, False), ("nn", 0.0, False),
         ("rp", 2.0, False), ("dd", 50.0, True), ("pn", 0.0, True)]


@pytest.mark.parametrize("kinds,alpha,varcoef", CASES)
def test_vcycle_and_solve_match_reference(kinds, alpha, varcoef):
    rng = np.random.default_rng(len(kinds) + int(alpha))
    f = rng.standard_normal(SHAPE)
    D = rng.uniform(0.5, 2.0, SHAPE) if varcoef else None
    beta = 1.0 if not varcoef else 1.0
    jm = jmg.PoissonMultigrid(SHAPE, _bc(jbc, kinds), DX, alpha=alpha,
                              beta=beta,
                              D=None if D is None else jnp.asarray(D))
    tm = tmg.PoissonMultigrid(SHAPE, _bc(tbc, kinds), DX, alpha=alpha,
                              beta=beta,
                              D=None if D is None else torch.tensor(D),
                              device="cpu")
    assert len(tm.levels) == len(jm.levels) == 3
    for jl, tl in zip(jm.levels, tm.levels):
        _close(jl.diag, tl.diag, 1e-14)
    _close(jm.vcycle(jnp.zeros(SHAPE), jnp.asarray(f)),
           tm.vcycle(torch.zeros(SHAPE, dtype=torch.float64),
                     torch.tensor(f)))
    ref = jm.solve(jnp.asarray(f), tol=1e-9, maxiter=60)
    got = tm.solve(torch.tensor(f), tol=1e-9, maxiter=60)
    assert bool(got.converged) and bool(ref.converged)
    assert got.iters == int(ref.iters)
    _close(ref.x, got.x, 1e-10)


def test_transfers_and_masks_match_reference():
    rng = np.random.default_rng(1)
    fine = rng.standard_normal((8, 12))
    _close(jamr.restrict_cc(jnp.asarray(fine)),
           tmg.restrict_cc(torch.tensor(fine)), 1e-15)
    coarse = rng.standard_normal((4, 6))
    for kinds in ("pp", "dr", "np"):
        _close(jmg.prolong_linear(jnp.asarray(coarse), _bc(jbc, kinds),
                                  (0.2, 0.1)),
               tmg.prolong_linear(torch.tensor(coarse), _bc(tbc, kinds),
                                  (0.2, 0.1)), 1e-15)
    for a, b in zip(jmg.checkerboard_masks((5, 4)),
                    tmg.checkerboard_masks((5, 4))):
        np.testing.assert_array_equal(np.asarray(a), b.numpy())
    assert tmg.homogeneous_bc(_bc(tbc, "dr")).axes[0].lo.value == 0.0
    assert tmg._nullspace(_bc(tbc, "pn")) and not tmg._nullspace(
        _bc(tbc, "pd"))
