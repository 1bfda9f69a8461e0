"""Port parity: Lagrangian spring and beam forces, the structure data
that builds them and the flagship shell's lattice, ibamr_tpu_torch
against ibamr_tpu at f64 on the CPU. Inputs come from a numpy seed. The
force is a sum over at most K contributions per marker taken in the
same order on both sides, so it agrees to 1e-14 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.io.structures import StructureData as JStructure
from ibamr_tpu.models import shell3d as jshell
from ibamr_tpu.ops import forces as jforces
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.io.structures import StructureData as TStructure
from ibamr_tpu_torch.models import shell3d as tshell
from ibamr_tpu_torch.ops import forces as tforces

RTOL = 1e-14


def _close(ref, got):
    ref = np.asarray(ref)
    got = got.numpy()
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=RTOL * scale)


def _topology(N, dim, seed):
    rng = np.random.default_rng(seed)
    M = 3 * N
    springs = np.stack([rng.integers(0, N, M), rng.integers(0, N, M),
                        rng.uniform(0.5, 2.0, M), rng.uniform(0.0, 0.3, M)],
                       axis=1)
    mid = rng.integers(1, N - 1, N)
    beams = np.concatenate([np.stack([mid - 1, mid, mid + 1,
                                      rng.uniform(0.1, 1.0, N)], axis=1),
                            rng.standard_normal((N, dim)) * 0.01], axis=1)
    X = rng.uniform(0, 1, (N, dim))
    U = rng.standard_normal((N, dim))
    return springs, beams, X, U


@pytest.mark.parametrize("dim", [2, 3])
@pytest.mark.parametrize("families", ["springs", "beams", "both"])
def test_force_matches_reference(dim, families):
    N = 60
    springs, beams, X, U = _topology(N, dim, seed=dim)
    kw = dict(springs=springs if families != "beams" else None,
              beams=beams if families != "springs" else None)
    jspecs = JStructure(name="s", vertices=X, **kw).force_specs(
        dtype=jnp.float64)
    tspecs = TStructure(name="s", vertices=X, **kw).force_specs(
        dtype=torch.float64, device="cpu")
    ref = jforces.compute_lagrangian_force(jnp.asarray(X), jnp.asarray(U),
                                           jspecs)
    _close(ref, tforces.compute_lagrangian_force(
        torch.tensor(X), torch.tensor(U), tspecs))
    # the carried specs compute the same force
    carried = convert.force_specs(jspecs, N, device="cpu")
    _close(ref, tforces.compute_lagrangian_force(
        torch.tensor(X), torch.tensor(U), carried))


def test_gather_table_lists_every_contribution_once():
    N = 40
    springs, beams, _, _ = _topology(N, 3, seed=7)
    specs = TStructure(name="s", vertices=np.zeros((N, 3)), springs=springs,
                       beams=beams).force_specs(dtype=torch.float64,
                                                device="cpu")
    M = 2 * len(springs) + 3 * len(beams)
    g = specs.gather.numpy()
    real = np.sort(g[g < M])
    np.testing.assert_array_equal(real, np.arange(M))
    ids = np.concatenate([springs[:, 0], springs[:, 1], beams[:, 0],
                          beams[:, 1], beams[:, 2]]).astype(np.int64)
    rows = np.nonzero(g < M)[0]
    np.testing.assert_array_equal(ids[g[g < M]], rows)


def test_no_specs_give_zero_force():
    X = torch.rand(5, 3, dtype=torch.float64)
    F = tforces.compute_lagrangian_force(X, X, tforces.ForceSpecs())
    assert torch.equal(F, torch.zeros_like(X))


@pytest.mark.parametrize("bend", [0.0, 0.05])
def test_shell_lattice_and_force_match_reference(bend):
    args = (12, 10, 0.25, (0.5, 0.5, 0.5), 1.0)
    kw = dict(rest_length_factor=0.75, aspect=1.2, bend_rigidity=bend)
    js = jshell.make_spherical_shell(*args, **kw)
    ts = tshell.make_spherical_shell(*args, **kw)
    np.testing.assert_array_equal(js.vertices, ts.vertices)
    np.testing.assert_array_equal(js.springs, ts.springs)
    if bend:
        np.testing.assert_array_equal(js.beams, ts.beams)
    else:
        assert js.beams is None and ts.beams is None
    X = js.vertices * 1.1
    ref = jforces.compute_lagrangian_force(
        jnp.asarray(X), jnp.zeros_like(jnp.asarray(X)),
        js.force_specs(dtype=jnp.float64))
    got = tforces.compute_lagrangian_force(
        torch.tensor(X), torch.zeros(X.shape, dtype=torch.float64),
        ts.force_specs(dtype=torch.float64, device="cpu"))
    _close(ref, got)
