"""The delta kernels' derivatives at their knots, port against reference.

Every kernel of the menu is a piecewise expression, C^0 at worst: the hat
and BSPLINE_2 kink at their knots, the others join smoothly or through a
clamp. At a kink the derivative is a convention, and the reference's is
JAX's: d|r|/dr = +1 at 0, and the mean of both sides where ``maximum``
ties. The port must give the same numbers in forward mode
(``torch.func.jvp``) and reverse mode (``torch.autograd.grad``), exactly,
at r = 0, +-1/2, +-1, ... through the support and just outside it. The
transfers built on them inherit the rule: the JVP of interpolate and
spread with respect to the marker positions, for markers on grid nodes,
agrees with JAX's to 1e-14 (the stencil sums may round in another
order).
"""

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import delta as jdelta
from ibamr_tpu.ops import interaction as jinter
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.ops import delta as tdelta
from ibamr_tpu_torch.ops import interaction as tinter

TRANSFER_RTOL = 1e-14


def _axis_specs(name):
    """The distinct (label, support, jax phi, torch phi) of a kernel: one
    for a plain kernel, the normal and tangential axes of a composite."""
    out = []
    for centering in ("cell", 0):
        for axis in range(2):
            (js, jphi) = jdelta.get_kernel_axes(name, centering, 2)[axis]
            (ts, tphi) = tdelta.get_kernel_axes(name, centering, 2)[axis]
            assert js == ts
            if all(s != js for _, s, _, _ in out):
                out.append((f"{centering}/{axis}", js, jphi, tphi))
    return out


def _knots(support):
    """r = 0, +-1/2, +-1, ... to half a stencil past the support's edge,
    and just outside the support on both sides."""
    half = 0.5 * support
    r = np.arange(-2 * (half + 1), 2 * (half + 1) + 1) * 0.5
    edge = np.nextafter(half, np.inf)
    return np.concatenate([r, [edge, -edge, half + 1e-9, -half - 1e-9]])


def _same(ref, got, what):
    ref = np.asarray(ref, dtype=np.float64)
    bad = np.nonzero(ref != got)[0]
    assert bad.size == 0, f"{what} differs at {[(i, ref[i], got[i]) for i in bad]}"


@pytest.mark.parametrize("name", tdelta.available_kernels())
def test_phi_derivatives_at_knots_match_reference(name):
    for label, support, jphi, tphi in _axis_specs(name):
        r = _knots(support)
        rj = jnp.asarray(r)
        jg = np.asarray(jax.vmap(jax.grad(jphi))(rj))
        jt = np.asarray(jax.jvp(jphi, (rj,), (jnp.ones_like(rj),))[1])

        rt = torch.tensor(r, requires_grad=True)
        (tg,) = torch.autograd.grad(tphi(rt).sum(), rt)
        r0 = torch.tensor(r)
        _, tt = torch.func.jvp(tphi, (r0,), (torch.ones_like(r0),))

        _same(jg, tg.numpy(), f"{name} {label} grad")
        _same(jt, tt.detach().numpy(), f"{name} {label} jvp")


def test_c0_kinks_take_the_reference_convention():
    # the numbers of the fault this test guards: the hat at -1, 0, 1 and
    # BSPLINE_2 at 0 (torch.abs and torch.clamp gave 1, -0, -1 and -1)
    r = torch.tensor([-1.0, 0.0, 1.0], dtype=torch.float64,
                     requires_grad=True)
    (g,) = torch.autograd.grad(
        tdelta.get_kernel("PIECEWISE_LINEAR")[1](r).sum(), r)
    assert g.tolist() == [0.5, -1.0, -0.5]
    (g,) = torch.autograd.grad(tdelta.get_kernel("BSPLINE_2")[1](r).sum(), r)
    assert g.tolist() == [0.0, 0.0, 0.0]


def _node_markers(n, dx, centering, rng):
    """Markers on nodes of the sampled field: on every stencil axis the
    grid-unit coordinate is an integer offset from the field's points."""
    dim = len(n)
    off = [0.5 if centering == "cell" or centering != d else 0.0
           for d in range(dim)]
    idx = np.stack([rng.integers(2, n[d] - 2, 12) for d in range(dim)], 1)
    return (idx + np.asarray(off)) * np.asarray(dx)


@pytest.mark.parametrize("kernel", ["PIECEWISE_LINEAR", "BSPLINE_2"])
@pytest.mark.parametrize("centering", ["cell", 0, 1])
@pytest.mark.parametrize("op", ["interpolate", "spread"])
def test_transfer_jvp_at_grid_nodes_matches_reference(kernel, centering, op):
    rng = np.random.default_rng(7)
    n, lo, up = (12, 10), (0.0, 0.0), (1.2, 0.8)
    jg, tg = JGrid(n=n, x_lo=lo, x_up=up), TGrid(n=n, x_lo=lo, x_up=up)
    X = _node_markers(n, jg.dx, centering, rng)
    dX = rng.standard_normal(X.shape)
    if op == "interpolate":
        a = rng.standard_normal(n)
    else:
        a = rng.standard_normal(X.shape[0])

    def jf(Xv):
        if op == "interpolate":
            return jinter.interpolate(jnp.asarray(a), jg, Xv, centering,
                                      kernel)
        return jinter.spread(jnp.asarray(a), jg, Xv, centering, kernel)

    def tf(Xv):
        if op == "interpolate":
            return tinter.interpolate(torch.tensor(a), tg, Xv, centering,
                                      kernel)
        return tinter.spread(torch.tensor(a), tg, Xv, centering, kernel)

    jv, jt = jax.jvp(jf, (jnp.asarray(X),), (jnp.asarray(dX),))
    tv, tt = torch.func.jvp(tf, (torch.tensor(X),), (torch.tensor(dX),))
    for ref, got in ((jv, tv), (jt, tt)):
        ref = np.asarray(ref)
        got = got.detach().numpy()
        assert got.shape == ref.shape
        err = np.max(np.abs(got - ref)) / max(np.max(np.abs(ref)), 1e-300)
        assert err <= TRANSFER_RTOL, err
