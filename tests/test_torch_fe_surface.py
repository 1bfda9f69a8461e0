"""Port parity of ``fe/surface.py`` at f64: the surface assembly of EDGE2
rings (2D) and TRI3S spheres (3D) within 1e-13, ``membrane_forces``,
``membrane_energy``, ``current_area`` and ``surface_strain`` on stretched,
sheared and nearly collapsed configurations within 1e-10 of max|ref|
(also under ``torch.no_grad``), and the mesh builders exactly."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.fe import mesh as jm
from ibamr_tpu.fe import surface as js
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.fe import mesh as tm
from ibamr_tpu_torch.fe import surface as ts


def _close(ref, got, tol):
    ref = np.asarray(ref, dtype=float)
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    assert got.shape == ref.shape
    assert np.max(np.abs(got - ref)) <= tol * max(np.max(np.abs(ref)), 1e-300)


MESHES = {
    "ring": lambda m: m.ring_mesh(center=(0.5, 0.4), radius=0.2, n=24,
                                  aspect=1.3),
    "sphere": lambda m: m.sphere_surface_mesh(center=(0.5, 0.5, 0.5),
                                              radius=0.25, n_subdiv=2),
}


@pytest.mark.parametrize("name", sorted(MESHES))
def test_builders_and_assembly_match_reference(name):
    jmesh, tmesh = MESHES[name](js), MESHES[name](ts)
    assert tmesh.elem_type == jmesh.elem_type
    assert np.array_equal(tmesh.elems, jmesh.elems)
    assert np.max(np.abs(tmesh.nodes - jmesh.nodes)) <= 1e-13
    ja = js.build_surface_assembly(jmesh, dtype=jnp.float64)
    ta = ts.build_surface_assembly(convert.surface_mesh(jmesh),
                                   dtype=torch.float64, device="cpu")
    assert np.array_equal(ta.elems.numpy(), np.asarray(ja.elems))
    for f in ("shape", "dN", "Ginv", "wdA", "lumped_mass"):
        _close(getattr(ja, f), getattr(ta, f), 1e-13)
    assert (ta.n_nodes, ta.dim, ta.rdim) == (ja.n_nodes, ja.dim, ja.rdim)


@pytest.mark.parametrize("name", sorted(MESHES))
def test_membrane_forces_match_reference(name):
    jmesh = MESHES[name](js)
    ja = js.build_surface_assembly(jmesh, dtype=jnp.float64)
    ta = ts.build_surface_assembly(convert.surface_mesh(jmesh),
                                   dtype=torch.float64, device="cpu")
    jW, tW = js.neo_hookean_membrane(1.0, 2.0), ts.neo_hookean_membrane(1.0,
                                                                       2.0)

    @jax.jit
    def reference(x):
        return (js.membrane_forces(ja, jW, x), js.membrane_energy(ja, jW, x),
                js.current_area(ja, x), js.surface_strain(ja, x))

    rng = np.random.default_rng(5)
    X = jmesh.nodes
    c = X.mean(0)
    d = X.shape[1]
    configs = {
        "stretched": c + (X - c) * (1.0 + 0.2 * np.arange(1, d + 1)),
        "sheared": X + 0.3 * (X[:, :1] - c[0]) * np.eye(d)[1],
        "noisy": X + 0.01 * rng.standard_normal(X.shape),
        # a collapsed direction: det M below the 1e-12 clamp somewhere
        "collapsed": c + (X - c) * np.r_[1.0, 1e-7, 1.0][:d],
    }
    for key, x in configs.items():
        ref = [np.asarray(v) for v in reference(jnp.asarray(x))]
        tx = torch.tensor(x)
        _close(ref[0], ts.membrane_forces(ta, tW, tx), 1e-10)
        with torch.no_grad():
            _close(ref[0], ts.membrane_forces(ta, tW, tx), 1e-10)
        _close(ref[1], ts.membrane_energy(ta, tW, tx), 1e-10)
        _close(ref[2], ts.current_area(ta, tx), 1e-12)
        _close(ref[3], ts.surface_strain(ta, tx), 1e-12)
        _close(np.asarray(js.surface_quad_positions(ja, jnp.asarray(x))),
               ts.surface_quad_positions(ta, tx), 1e-13)


def test_surface_mesh_from_fe_matches_reference(tmp_path):
    """A TRI6 shell curved through 3D, adopted by its corner nodes."""
    sph = js.sphere_surface_mesh(n_subdiv=1)
    shell = jm.to_quadratic(jm.FEMesh(nodes=sph.nodes,
                                      elems=np.asarray(sph.elems),
                                      elem_type="TRI3"))
    ref = js.surface_mesh_from_fe(shell)
    got = ts.surface_mesh_from_fe(convert.fe_mesh(shell))
    assert got.elem_type == ref.elem_type == "TRI3S"
    assert np.array_equal(got.elems, ref.elems)
    assert np.array_equal(got.nodes, ref.nodes)
    with pytest.raises(ValueError, match="codim-1"):
        ts.surface_mesh_from_fe(tm.rect_quad_mesh(1, 1))
