"""Port parity of the roofline join (``ibamr_tpu_torch/obs/roofline.py``)
against ``ibamr_tpu/obs/roofline.py`` on the CPU.

``roofline_join`` and ``render_roofline`` are the reference's: on the
same summary and census dicts (random, from a numpy seed) they return
equal blocks and lines. ``census_sidecar`` counts at the call level
under a ``TorchFunctionMode`` where the reference reads a jaxpr: on one
spectral substep at 16^3 f64 the two give the same ``fft_ops`` and
``fft_bytes``, and on the ``mxu`` engine's interp the same ``dot_flops``,
output bytes and ``dot_count`` (one contraction per velocity component in
both), with the two operands on opposite sides."""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.obs import roofline as jrl
from ibamr_tpu.ops.interaction_fast import FastInteraction as JFast
from ibamr_tpu.solvers import spectral_plan as jsp
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.obs import roofline as trl
from ibamr_tpu_torch.ops.interaction_fast import FastInteraction as TFast
from ibamr_tpu_torch.solvers import spectral_plan as tsp

RNG = np.random.default_rng(20261018)


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _random_pair(rng):
    total = float(rng.uniform(0.5, 5.0))
    fft, dot, comm = (float(v) for v in rng.uniform(0, total / 3, 3))
    summary = {"total_device_s": total,
               "op_classes": {"fft_s": fft, "dot_s": dot, "comm_s": comm,
                              "other_s": total - fft - dot - comm}}
    census = {"executions": int(rng.integers(1, 50)),
              "fft_bytes": int(rng.integers(1, 10**10)),
              "fft_ops": int(rng.integers(1, 10)),
              "dot_lhs_bytes": int(rng.integers(0, 10**8)),
              "dot_rhs_bytes": int(rng.integers(0, 10**8)),
              "dot_out_bytes": int(rng.integers(0, 10**8)),
              "dot_flops": int(rng.integers(1, 10**12)),
              "dot_count": int(rng.integers(1, 9)),
              "collective_bytes": int(rng.integers(0, 10**9)),
              "pbroadcast_bytes": int(rng.integers(0, 10**6)),
              "collective_prims": int(rng.integers(0, 5))}
    return summary, census


@pytest.mark.parametrize("seed", range(4))
def test_roofline_join_and_render_match_reference(seed):
    summary, census = _random_pair(np.random.default_rng(seed))
    r = trl.roofline_join(summary, census)
    assert r == jrl.roofline_join(summary, census)
    assert trl.render_roofline(r) == jrl.render_roofline(r)
    for bad in (dict(census, executions=0),):
        assert trl.roofline_join(summary, bad) is None
        assert jrl.roofline_join(summary, bad) is None
    assert trl.render_roofline(None) == jrl.render_roofline(None)


def test_census_of_one_spectral_substep_matches_reference():
    shape = (16, 16, 16)
    dx = tuple(1.0 / s for s in shape)
    rhs = [RNG.standard_normal(shape) for _ in range(3)]
    coeffs = (20.0, -0.025)

    def jfn(*r):
        return jsp.spectral_substep(tuple(r), dx, *coeffs, coeffs)

    def tfn(*r):
        return tsp.spectral_substep(tuple(r), dx, *coeffs, coeffs)

    jc = jrl.census_sidecar(jfn, tuple(map(jnp.asarray, rhs)), label="s",
                            executions=2)
    tc = trl.census_sidecar(tfn, tuple(map(torch.tensor, rhs)), label="s",
                            executions=2)
    assert tc["fft_ops"] == jc["fft_ops"] > 0
    assert tc["fft_bytes"] == jc["fft_bytes"] > 0
    for key in ("schema", "label", "executions", "collective_prims",
                "collective_bytes", "pbroadcast_bytes"):
        assert tc[key] == jc[key]
    assert set(jc) - {"fft_transforms"} <= set(tc)


def test_census_of_the_mxu_interp_matches_reference_flops():
    n, m = 16, 200
    box = dict(x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    jg, tg = JGrid(n=(n,) * 3, **box), TGrid(n=(n,) * 3, **box)
    X = RNG.random((m, 3))
    u = tuple(RNG.standard_normal((n,) * 3) for _ in range(3))
    jeng = JFast(jg, kernel="IB_4", tile=8, cap=128)
    teng = TFast(tg, kernel="IB_4", tile=8, cap=128, device="cpu")
    jb = jeng.buckets(jnp.asarray(X))
    tb = teng.buckets(torch.tensor(X))
    jc = jrl.census_sidecar(
        jax.jit(lambda uu: jeng.interpolate_vel(uu, jnp.asarray(X), b=jb)),
        (tuple(map(jnp.asarray, u)),))
    tc = trl.census_sidecar(
        lambda uu: teng.interpolate_vel(uu, torch.tensor(X), b=tb),
        (tuple(map(torch.tensor, u)),))
    assert tc["dot_flops"] == jc["dot_flops"] > 0
    assert tc["dot_count"] == jc["dot_count"]
    # the port contracts the footprint with the weights, the reference
    # the weights with the footprint: the operand sides swap, their sum
    # and the output agree
    assert (tc["dot_lhs_bytes"], tc["dot_rhs_bytes"]) == (
        jc["dot_rhs_bytes"], jc["dot_lhs_bytes"])
    assert tc["dot_out_bytes"] == jc["dot_out_bytes"]
    assert tc["fft_ops"] == jc["fft_ops"] == 0


def test_census_counts_each_call_once():
    """One ``rfftn`` is one transform, one ``einsum`` one contraction,
    however the library splits them; the flops are 2·|out|·K."""
    a = torch.tensor(RNG.standard_normal((4, 6, 5)))
    b = torch.tensor(RNG.standard_normal((4, 5, 3)))
    x = torch.tensor(RNG.standard_normal((8, 8, 8)))

    def fn():
        torch.fft.irfftn(torch.fft.rfftn(x), s=x.shape)
        torch.einsum("bij,bjk->bik", a, b)
        a @ b
        torch.bmm(a, b)
        torch.mm(a[0], b[0])

    c = trl.census_sidecar(fn, ())
    assert c["fft_ops"] == 2
    assert c["fft_bytes"] == 2 * (8 * 8 * 8 * 8 + 8 * 8 * 5 * 16)
    assert c["dot_count"] == 4
    assert c["dot_flops"] == 3 * 2 * 4 * 6 * 3 * 5 + 2 * 6 * 3 * 5
