"""Port parity of ``fe/fem.py`` at f64 (the suite turns on x64): the
assembly tables of every element family within 1e-13 (integers exact),
the transfer rules, and the forces (``nodal_forces`` by autograd,
``nodal_forces_pk1``, ``pk1``, ``elastic_energy``) of ``neo_hookean`` and
``stvk`` on deformed, nearly inverted (J below the log extension's eps)
and inverted configurations within 1e-10 of max|ref|; the forces are the
same under ``torch.no_grad``; the quadrature-point transfers."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.fe import fem as jf
from ibamr_tpu.fe import mesh as jm
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.fe import fem as tf

FAMILIES = ["TRI3", "TRI6", "QUAD4", "QUAD8", "QUAD9", "TET4", "TET10",
            "HEX8", "HEX20", "HEX27"]


def _mesh(etype):
    if etype in ("TRI3", "TRI6"):
        m = jm.disc_mesh(n_rings=2)
        return m if etype == "TRI3" else jm.to_quadratic(m)
    if etype in ("TET4", "TET10"):
        m = jm.block_mesh_tet(1, 1, 2, x_up=(1.0, 0.5, 0.8))
        return m if etype == "TET4" else jm.to_quadratic(m)
    if etype.startswith("QUAD"):
        m = jm.rect_quad_mesh(2, 2, x_up=(0.9, 0.4))
        return m if etype == "QUAD4" else jm.to_quadratic_tensor(
            m, serendipity=etype == "QUAD8")
    m = jm.box_hex_mesh(1, 1, 2, x_up=(1.0, 0.6, 0.7))
    return m if etype == "HEX8" else jm.to_quadratic_tensor(
        m, serendipity=etype == "HEX20")


def _close(ref, got, tol):
    ref = np.asarray(ref, dtype=float)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-300)


def _tables_equal(ja, ta):
    assert np.array_equal(ta.elems.numpy(), np.asarray(ja.elems))
    for name in ("shape", "dNdX", "wdV", "lumped_mass"):
        _close(getattr(ja, name), getattr(ta, name), 1e-13)
    assert (ta.n_nodes, ta.dim) == (ja.n_nodes, ja.dim)


@pytest.mark.parametrize("etype", FAMILIES)
def test_assembly_tables_match_reference(etype):
    m = _mesh(etype)
    ja = jf.build_assembly(m, dtype=jnp.float64)
    ta = tf.build_assembly(convert.fe_mesh(m), dtype=torch.float64,
                           device="cpu")
    _tables_equal(ja, ta)
    _tables_equal(ja, convert.fe_assembly(ja, device="cpu"))


@pytest.mark.parametrize("etype,level", [("TRI3", 1), ("TRI6", 2),
                                         ("QUAD4", 1), ("TET4", 1),
                                         ("HEX8", 1), ("QUAD9", 1)])
def test_transfer_rules_match_reference(etype, level):
    m = _mesh(etype)
    for a, b in zip(jf.transfer_quadrature(etype, level),
                    tf.transfer_quadrature(etype, level)):
        assert np.array_equal(a, b)
    _tables_equal(jf.build_transfer_assembly(m, level, dtype=jnp.float64),
                  tf.build_transfer_assembly(convert.fe_mesh(m), level,
                                             dtype=torch.float64,
                                             device="cpu"))
    rng = np.random.default_rng(3)
    x = m.nodes * (1.0 + 0.5 * rng.random(m.nodes.shape[1]))
    for h in (0.05, 0.2):
        assert tf.suggest_transfer_level(convert.fe_mesh(m), torch.tensor(x),
                                         h) == \
            jf.suggest_transfer_level(m, x, h)


def _configs(m, seed):
    """Deformed (affine + noise), nearly inverted (J = 5e-5 < eps) and
    inverted nodal positions of ``m``."""
    rng = np.random.default_rng(seed)
    d = m.nodes.shape[1]
    A = np.eye(d) + 0.3 * rng.standard_normal((d, d))
    flat = np.eye(d)
    flat[-1, -1] = 5e-5
    inv = np.eye(d)
    inv[-1, -1] = -0.5
    return {"deformed": m.nodes @ A.T
            + 0.01 * rng.standard_normal(m.nodes.shape),
            "nearly_inverted": m.nodes @ flat.T,
            "inverted": m.nodes @ inv.T}


@pytest.mark.parametrize("material", ["neo_hookean", "stvk"])
@pytest.mark.parametrize("etype", ["TRI3", "TRI6", "QUAD4", "TET4", "HEX8",
                                   "HEX27"])
def test_forces_match_reference(etype, material):
    m = _mesh(etype)
    ja = jf.build_assembly(m, dtype=jnp.float64)
    ta = tf.build_assembly(convert.fe_mesh(m), dtype=torch.float64,
                           device="cpu")
    jW, tW = getattr(jf, material)(1.0, 4.0), getattr(tf, material)(1.0, 4.0)

    @jax.jit
    def reference(x):
        FF = jf.deformation_gradients(ja, x)
        return (jf.nodal_forces(ja, jW, x), jf.elastic_energy(ja, jW, x),
                FF, jf.pk1(jW)(FF))

    for name, x in _configs(m, 7).items():
        tx = torch.tensor(x)
        ref, e_ref, FF, P = (np.asarray(v) for v in reference(jnp.asarray(x)))
        assert np.all(np.isfinite(ref)), name
        _close(ref, tf.nodal_forces(ta, tW, tx), 1e-10)
        _close(ref, tf.nodal_forces_pk1(ta, tW, tx), 1e-10)
        with torch.no_grad():
            _close(ref, tf.nodal_forces(ta, tW, tx), 1e-10)
        assert abs(float(tf.elastic_energy(ta, tW, tx)) - e_ref) <= \
            1e-10 * abs(e_ref)
        _close(FF, tf.deformation_gradients(ta, tx), 1e-13)
        _close(P, tf.pk1(tW)(torch.tensor(FF)), 1e-10)


def test_log_extension_is_linear_below_eps_and_finite():
    J = torch.tensor([-0.5, 0.0, 5e-5, 1e-4, 2e-4, 1.0], dtype=torch.float64,
                     requires_grad=True)
    out = tf._log_ext(J)
    ref = np.asarray(jf._log_ext(jnp.asarray(J.detach().numpy())))
    _close(ref, out, 1e-15)
    (g,) = torch.autograd.grad(out.sum(), J)
    assert torch.isfinite(g).all()
    assert torch.allclose(g[:4], torch.full((4,), 1e4, dtype=torch.float64))


def test_det_closed_form():
    rng = np.random.default_rng(0)
    for d in (1, 2, 3):
        M = rng.standard_normal((5, 4, d, d))
        _close(np.linalg.det(M), tf.det(torch.tensor(M)), 1e-13)
    with pytest.raises(ValueError, match="d <= 3"):
        tf.det(torch.zeros(4, 4, dtype=torch.float64))


def test_inference_mode_raises():
    m = convert.fe_mesh(_mesh("TRI3"))
    ta = tf.build_assembly(m, dtype=torch.float64, device="cpu")
    with torch.inference_mode():
        x = torch.tensor(m.nodes)
        with pytest.raises(RuntimeError, match="inference_mode"):
            tf.nodal_forces(ta, tf.neo_hookean(1.0, 4.0), x)


@pytest.mark.parametrize("etype", ["TRI3", "TRI6", "QUAD8", "TET10", "HEX8"])
def test_quad_transfers_match_reference(etype):
    m = _mesh(etype)
    ja = jf.build_assembly(m, dtype=jnp.float64)
    ta = tf.build_assembly(convert.fe_mesh(m), dtype=torch.float64,
                           device="cpu")
    rng = np.random.default_rng(11)
    x = m.nodes + 0.02 * rng.standard_normal(m.nodes.shape)
    F = rng.standard_normal(m.nodes.shape)
    Eq = ja.wdV.shape[0] * ja.wdV.shape[1]
    vals = rng.standard_normal((Eq, m.nodes.shape[1]))
    _close(np.asarray(jf.quad_positions(ja, jnp.asarray(x))),
           tf.quad_positions(ta, torch.tensor(x)), 1e-13)
    _close(np.asarray(jf.project_to_quads(ja, jnp.asarray(F))),
           tf.project_to_quads(ta, torch.tensor(F)), 1e-13)
    _close(np.asarray(jf.l2_project_from_quads(ja, jnp.asarray(vals))),
           tf.l2_project_from_quads(ta, torch.tensor(vals)), 1e-13)
    args_j = (ja.elems, ja.shape, ja.wdV, ja.n_nodes)
    args_t = (ta.elems, ta.shape, ta.wdV, ta.n_nodes)
    out = tf.distribute_to_quads(*args_t, torch.tensor(F))
    _close(np.asarray(jf.distribute_to_quads(*args_j, jnp.asarray(F))),
           out, 1e-13)
    assert np.allclose(out.sum(0).numpy(), F.sum(0), rtol=0, atol=1e-12)
    ww_den = tf._node_qp_weights(*args_t)
    _close(np.asarray(jf.nodal_average_from_quads(*args_j,
                                                  jnp.asarray(vals))),
           tf.nodal_average_from_quads(*args_t, torch.tensor(vals),
                                       ww_den=ww_den), 1e-13)
    _close(np.asarray(jf.safe_lumped_mass(ja)), tf.safe_lumped_mass(ta),
           1e-13)
