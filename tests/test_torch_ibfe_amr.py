"""Port parity of IBFE on the composite two-level hierarchy
(``amr_ins.TwoLevelIBINS`` with an ``integrators.ibfe.IBFEMethod``)
against ibamr_tpu at f64 on the CPU, on the set-up of
``tests/test_ibfe_amr.py``: a 32^2 grid with a 16^2 window, the
pre-stretched neo-Hookean disc, both couplings, 10 steps from the same
state: X within 1e-12 and u within 1e-12 of each level's max |u| (1e-10
with the nodal coupling, see the test); and
the reference's 160-step relaxation (``slow``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu import amr_ins as jins
from ibamr_tpu.fe import fem as jfem
from ibamr_tpu.fe.mesh import disc_mesh
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators.ibfe import IBFEMethod as JIBFE
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import amr_ins as tins
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.fe import fem as tfem
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators.ibfe import IBFEMethod as TIBFE


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)



def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)),
                                                 1e-300))


def _pair(coupling):
    m = disc_mesh(radius=0.08, center=(0.5, 0.5), n_rings=3)
    S = np.diag([1.08, 1.0 / 1.08])
    X0 = (m.nodes - 0.5) @ S.T + 0.5
    kw = dict(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    box = ((8, 8), (16, 16))
    jfe = JIBFE(m, jfem.neo_hookean(1.0, 4.0), kernel="IB_4",
                coupling=coupling, dtype=jnp.float64)
    tfe = TIBFE(convert.fe_mesh(m), tfem.neo_hookean(1.0, 4.0),
                kernel="IB_4", coupling=coupling, dtype=torch.float64,
                device="cpu")
    ji = jins.TwoLevelIBINS(JGrid(**kw), jamr.FineBox(*box), jfe, mu=0.05,
                            proj_tol=1e-9)
    ti = tins.TwoLevelIBINS(TGrid(**kw), tamr.FineBox(*box), tfe, mu=0.05,
                            proj_tol=1e-9, device="cpu")
    js = ji.initialize(jnp.asarray(X0, jnp.float64))
    return ji, ti, js, convert.two_level_ib_state(js, "cpu"), m


def _check(js, ts, tol):
    """X, and each level's u against that level's max |u|."""
    assert _rel(js.X, ts.X) <= tol
    for ref, got in ((js.fluid.uc, ts.fluid.uc), (js.fluid.uf, ts.fluid.uf)):
        scale = max(float(np.max(np.abs(np.asarray(c)))) for c in ref)
        for a, b in zip(ref, got):
            assert np.max(np.abs(b.numpy() - np.asarray(a))) <= tol * scale


@pytest.mark.parametrize("coupling,u_tol", [("unified", 1e-12),
                                             ("nodal", 1e-10)])
def test_ibfe_two_level_matches_reference(coupling, u_tol):
    """With the nodal coupling each projection's FGMRES (relative
    residual 1e-9, two restarts) leaves the two packages' u ~1e-11 of
    max |u| apart from roundoff in the Arnoldi runs, so u is held to
    1e-10 there, the composite-projection tolerance of
    ``tests/test_torch_amr_ins.py``; X stays within 1e-12."""
    ji, ti, js, ts, _ = _pair(coupling)
    jstep = jax.jit(lambda s: ji.step(s, 5e-4))
    for _ in range(10):
        js = jstep(js)
    ts = tins.advance_two_level_ib(ti, ts, 5e-4, 10)
    assert _rel(js.X, ts.X) <= 1e-12
    _check(js, ts, u_tol)


@pytest.mark.slow
def test_ibfe_two_level_relaxation_matches_reference():
    """The reference's 160-step relaxation: the disc's elastic energy
    falls below 0.6 of its start in both packages, which agree."""
    ji, ti, js, ts, m = _pair("unified")
    asm = tfem.build_assembly(convert.fe_mesh(m), dtype=torch.float64,
                              device="cpu")
    W = tfem.neo_hookean(1.0, 4.0)
    e0 = float(tfem.elastic_energy(asm, W, ts.X))
    js = jins.advance_two_level_ib(ji, js, 5e-4, 160)
    ts = tins.advance_two_level_ib(ti, ts, 5e-4, 160)
    _check(js, ts, 1e-10)
    assert float(tfem.elastic_energy(asm, W, ts.X)) < 0.6 * e0
    assert float(ti.core.max_divergence(ts.fluid)) < 1e-6
