"""Port parity of the ghost-padded convection path
(``ops/convection.py``: ``convective_rate_bc``, the PPM/CUI face states,
``advective_face_value``) and of the rest of ``ops/stencils.py``, against
ibamr_tpu at f64 on the CPU, to 1e-12 relative. Random fields have no
ties, so the MC limiter and the PPM monotonizer take the same branch in
both packages at every face; a branch taken differently would show as an
O(1) difference."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.ops import convection as jcv
from ibamr_tpu.ops import stencils as jst
from ibamr_tpu_torch.ops import convection as tcv
from ibamr_tpu_torch.ops import stencils as tst

RTOL = 1e-12


def _close(ref, got, rtol=RTOL):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, rtol=0,
                               atol=rtol * max(np.max(np.abs(ref)), 1e-300))


def _vel(shape, seed, walls=()):
    rng = np.random.default_rng(seed)
    u = [rng.standard_normal(shape) for _ in shape]
    for d in walls:
        idx = [slice(None)] * len(shape)
        idx[d] = 0
        u[d][tuple(idx)] = 0.0          # the pinned wall face
    return u


@pytest.mark.parametrize("scheme", ["centered", "upwind", "ppm", "cui"])
@pytest.mark.parametrize("walls", [(False, False), (True, False),
                                   (True, True), (False, True, True)])
def test_convective_rate_bc_matches_reference(scheme, walls):
    shape = (12, 10, 8)[:len(walls)]
    dx = (0.1, 0.125, 0.2)[:len(walls)]
    u = _vel(shape, len(walls) * 7 + sum(walls),
             [d for d, w in enumerate(walls) if w])
    tang = {}
    if walls[-1]:
        tang = {(0, len(walls) - 1, 1): 1.0, (0, len(walls) - 1, 0): -0.3}
    ref = jcv.convective_rate_bc(tuple(map(jnp.asarray, u)), dx, scheme,
                                 wall_axes=walls, wall_tangential=tang)
    got = tcv.convective_rate_bc(tuple(map(torch.tensor, u)), dx, scheme,
                                 wall_axes=walls, wall_tangential=tang)
    for a, b in zip(ref, got):
        _close(a, b)


def test_periodic_bc_path_equals_roll_path():
    u = _vel((8, 6), 3)
    for scheme in ("centered", "upwind"):
        a = tcv.convective_rate(tuple(map(torch.tensor, u)), (0.1, 0.2),
                                scheme)
        b = tcv.convective_rate_bc(tuple(map(torch.tensor, u)), (0.1, 0.2),
                                   scheme)
        for x, y in zip(a, b):
            _close(x.numpy(), y)


def test_ppm_states_and_cui_faces_match_reference():
    rng = np.random.default_rng(4)
    a = rng.standard_normal((14, 5))
    # plateaus and extrema exercise every limiter branch
    a[3:6, :] = 0.5
    a[8, :] = 3.0
    for axis in (0, 1):
        n = a.shape[axis] - 6
        jL, jR = jcv._ppm_states(jnp.asarray(a), axis, n, 3)
        tL, tR = tcv._ppm_states(torch.tensor(a), axis, n, 3)
        _close(jL, tL)
        _close(jR, tR)
    U, C, D = (rng.standard_normal((50,)) for _ in range(3))
    D[:5] = U[:5]                    # uniform data: the D == U guard
    _close(jcv._cui_face(*map(jnp.asarray, (U, C, D))),
           tcv._cui_face(*map(torch.tensor, (U, C, D))))


@pytest.mark.parametrize("scheme", ["centered", "upwind", "cui"])
def test_advective_face_value_matches_reference(scheme):
    rng = np.random.default_rng(5)
    q = [rng.standard_normal(20) for _ in range(4)]
    vel = rng.standard_normal(20)
    vel[:3] = 0.0
    ref = jcv.advective_face_value(*map(jnp.asarray, q[1:3]),
                                   jnp.asarray(vel), scheme,
                                   Qmm=jnp.asarray(q[0]),
                                   Qpp=jnp.asarray(q[3]))
    got = tcv.advective_face_value(*map(torch.tensor, q[1:3]),
                                   torch.tensor(vel), scheme,
                                   Qmm=torch.tensor(q[0]),
                                   Qpp=torch.tensor(q[3]))
    _close(ref, got)
    with pytest.raises(ValueError):
        tcv.advective_face_value(torch.tensor(q[1]), torch.tensor(q[2]),
                                 torch.tensor(vel), "cui")


@pytest.mark.parametrize("dim", [2, 3])
def test_stencils_match_reference(dim):
    shape = (8, 6, 5)[:dim]
    dx = (0.1, 0.125, 0.2)[:dim]
    u = _vel(shape, 10 + dim)
    p = np.random.default_rng(dim).standard_normal(shape)
    ju, tu = tuple(map(jnp.asarray, u)), tuple(map(torch.tensor, u))
    for a, b in zip(jst.cc_to_fc(jnp.asarray(p)),
                    tst.cc_to_fc(torch.tensor(p))):
        _close(a, b)
    for a, b in zip(jst.fc_to_cc(ju), tst.fc_to_cc(tu)):
        _close(a, b)
    _close(jst.fc_component_to_fc(ju, 0, 1), tst.fc_component_to_fc(tu, 0, 1))
    _close(jst.fc_component_to_fc(ju, 1, 1), tst.fc_component_to_fc(tu, 1, 1))
    _close(jst.vorticity_magnitude_cc(ju, dx),
           tst.vorticity_magnitude_cc(tu, dx))
    if dim == 2:
        _close(jst.curl_2d_node(ju, dx), tst.curl_2d_node(tu, dx))
    else:
        for a, b in zip(jst.curl_3d_cc(ju, dx), tst.curl_3d_cc(tu, dx)):
            _close(a, b)
    walls = (True,) + (False,) * (dim - 1)
    for w in (None, walls):
        for ra, rb in zip(jst.strain_rate_cc(ju, dx, w),
                          tst.strain_rate_cc(tu, dx, w)):
            for a, b in zip(ra, rb):
                _close(a, b)
        _close(jst.strain_rate_magnitude_cc(ju, dx, w),
               tst.strain_rate_magnitude_cc(tu, dx, w))
    for d in range(dim):
        for wall in (False, True):
            _close(jst.central_grad(jnp.asarray(p), d, dx[d], wall),
                   tst.central_grad(torch.tensor(p), d, dx[d], wall))
        for a, b in zip(jst.wall_boundary_masks(shape, d),
                        tst.wall_boundary_masks(shape, d)):
            np.testing.assert_array_equal(np.asarray(a), b.numpy())
    comp = tst.mac_complete_from_periodic(tu)
    for a, b in zip(jst.mac_complete_from_periodic(ju), comp):
        _close(a, b)
    for a, b in zip(tu, tst.mac_periodic_from_complete(comp, shape)):
        assert torch.equal(a, b)
    _close(jst.axis_slice(jnp.asarray(p), 1, 1, 4),
           tst.axis_slice(torch.tensor(p), 1, 1, 4))


def test_ppm_limiter_branches_agree_at_f32():
    """The MC limiter and the PPM monotonizer branch on signs; at f32 on a
    cavity-like field with plateaus and extrema the two packages take
    the same branch at every face (a flip would show as an O(1)
    difference), and the face states agree to f32 roundoff."""
    rng = np.random.default_rng(6)
    x = np.linspace(0.0, 1.0, 40)
    a = (np.sin(6.0 * x)[:, None] * np.cos(3.0 * x)[None, :]
         + 1e-3 * rng.standard_normal((40, 40))).astype(np.float32)
    a[10:14, :] = a[10, 0]
    for axis in (0, 1):
        n = a.shape[axis] - 6
        jL, jR = jcv._ppm_states(jnp.asarray(a), axis, n, 3)
        tL, tR = tcv._ppm_states(torch.tensor(a), axis, n, 3)
        for j, t in ((jL, tL), (jR, tR)):
            diff = np.abs(t.numpy() - np.asarray(j))
            assert np.max(diff) <= 4 * np.finfo(np.float32).eps * \
                np.max(np.abs(np.asarray(j)))
