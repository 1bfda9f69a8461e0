"""Port parity of reverse mode through the solver pieces, against
ibamr_tpu's custom VJPs at f64 on the CPU (numpy seeds, one PyTorch
thread):

- the fused substep's adjoint Function (``solvers/spectral_plan.py``)
  against ``jax.vjp`` of the reference's substep, 2D and 3D, with and
  without ``filter_sym``, within 1e-12 of max|ref|; its VJP runs exactly
  twice the primal's FFT calls; the bf16-operand path at f32 against the
  reference's within the bf16 class (2e-2, the forward's bound in
  ``tests/test_torch_spectral.py``: one f32 ulp can move a bf16 rounding);
- the packed transfers' adjoint Functions (``ops/interaction_packed.py``)
  against ``jax.vjp`` of the reference's ``PackedInteraction``, 2D with a
  buffered overflow and 3D with an exceeded buffer (each with packed
  markers too), within 1e-12; the spread's backward runs no
  accumulating scatter, with and without overflow;
- the adjoint Functions against plain autograd (``plain_autodiff_*``)
  through a whole IB step on ``packed``, within 1e-12;
- the FE and rod forces carrying an outer gradient (a force's derivative
  with respect to positions and material constants) against ``jax.grad``
  of the reference's forces, within 1e-12;
- the hand-kernel engines refusing autograd on every device, as the
  reference's Pallas engines refuse ``jax.grad``.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu.fe import fem as jfem
from ibamr_tpu.fe.mesh import rect_quad_mesh as j_rect_quad_mesh
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.ops import interaction_packed as jpacked
from ibamr_tpu.ops import pallas_interaction as jpal
from ibamr_tpu.ops import rods as jrods
from ibamr_tpu.solvers import spectral_plan as jsp
from ibamr_tpu_torch.fe import fem as tfem
from ibamr_tpu_torch.fe.mesh import rect_quad_mesh as t_rect_quad_mesh
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.models.shell3d import build_shell_example
from ibamr_tpu_torch.ops import cuda_interaction as ci
from ibamr_tpu_torch.ops import interaction_packed as tpacked
from ibamr_tpu_torch.ops import rods as trods
from ibamr_tpu_torch.solvers import spectral_plan as tsp
from ibamr_tpu_torch.tools.microbench_grad import census, step_grads

TOL = 1e-12
BF16_TOL = 2e-2


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _rel(ref, got):
    ref = np.asarray(ref)
    got = got.detach().double().numpy()
    assert got.shape == ref.shape
    return float(np.max(np.abs(got - ref))
                 / max(np.max(np.abs(ref)), 1e-300))


def _grids(n):
    box = dict(x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
    return JGrid(n=n, **box), TGrid(n=n, **box)


# -- the fused substep

@pytest.mark.parametrize("shape", [(16, 12), (12, 10, 8)])
@pytest.mark.parametrize("filtered", [False, True])
def test_substep_vjp_matches_reference(shape, filtered):
    dx = tuple(1.0 / s for s in shape)
    alpha, beta, coeffs = 2.0e4, -0.025, (2.0e4, -0.025)
    rng = np.random.default_rng(len(shape) + 2 * filtered)
    rhs = [rng.standard_normal(shape) for _ in shape]
    cts = [rng.standard_normal(shape) for _ in range(len(shape) + 1)]
    jfs = (jsp.gaussian_filter_symbol(shape, dx, 0.05, jnp.float64)
           if filtered else None)
    tfs = (tsp.gaussian_filter_symbol(shape, dx, 0.05, torch.float64, "cpu")
           if filtered else None)
    jplan = jsp.get_plan(shape, dx, jnp.float64)
    (ju, jp), pull = jax.vjp(
        lambda r: jplan.substep(r, alpha, beta, coeffs, filter_sym=jfs),
        tuple(jnp.asarray(c) for c in rhs))
    jg = pull((tuple(jnp.asarray(c) for c in cts[:-1]),
               jnp.asarray(cts[-1])))[0]

    tplan = tsp.get_plan(shape, dx, torch.float64, "cpu")
    rr = [torch.tensor(c, requires_grad=True) for c in rhs]
    tu, tp = tplan.substep(rr, alpha, beta, coeffs, filter_sym=tfs)
    tg = torch.autograd.grad(list(tu) + [tp], rr,
                             [torch.tensor(c) for c in cts])
    for a, b in zip(tuple(ju) + (jp,), tuple(tu) + (tp,)):
        assert _rel(a, b) <= TOL
    for a, b in zip(jg, tg):
        assert _rel(a, b) <= TOL

    def primal():
        tplan.substep([r.detach() for r in rr], alpha, beta, coeffs,
                      filter_sym=tfs)

    def vjp():
        u, p = tplan.substep(rr, alpha, beta, coeffs, filter_sym=tfs)
        torch.autograd.grad(list(u) + [p], rr,
                            [torch.ones(shape, dtype=torch.float64)]
                            * (len(shape) + 1))

    assert census(vjp)["fft_ops"] == 2 * census(primal)["fft_ops"] == 4


def test_bf16_substep_vjp_within_the_bf16_class():
    shape = (16, 16, 16)
    dx = tuple(1.0 / s for s in shape)
    alpha, beta, coeffs = 2.0e4, -0.025, (2.0e4, -0.025)
    rng = np.random.default_rng(7)
    rhs = [rng.standard_normal(shape) for _ in range(3)]
    cts = [rng.standard_normal(shape) for _ in range(4)]
    jplan = jsp.get_plan(shape, dx, jnp.float32)
    _, pull = jax.vjp(
        lambda r: jplan.substep(r, alpha, beta, coeffs,
                                spectral_dtype="bf16"),
        tuple(jnp.asarray(c, jnp.float32) for c in rhs))
    jg = pull((tuple(jnp.asarray(c, jnp.float32) for c in cts[:3]),
               jnp.asarray(cts[3], jnp.float32)))[0]
    tplan = tsp.get_plan(shape, dx, torch.float32, "cpu")
    rr = [torch.tensor(c, dtype=torch.float32, requires_grad=True)
          for c in rhs]
    tu, tp = tplan.substep(rr, alpha, beta, coeffs, spectral_dtype="bf16")
    tg = torch.autograd.grad(list(tu) + [tp], rr,
                             [torch.tensor(c, dtype=torch.float32)
                              for c in cts])
    # and the f64 adjoint of the same cotangents, which bf16 approximates
    p64 = tsp.get_plan(shape, dx, torch.float64, "cpu")
    r64 = [torch.tensor(c, requires_grad=True) for c in rhs]
    u64, q64 = p64.substep(r64, alpha, beta, coeffs)
    g64 = torch.autograd.grad(list(u64) + [q64], r64,
                              [torch.tensor(c) for c in cts])
    for a, b, c in zip(jg, tg, g64):
        assert b.dtype == torch.float32
        assert _rel(a, b) <= BF16_TOL
        assert 1e-6 < _rel(c.numpy(), b) <= BF16_TOL


def test_substep_coefficients_are_constants_unless_asked():
    """The adjoint Function gives the coefficients no cotangent, as the
    reference's custom VJP; plain_autodiff_substep differentiates them."""
    shape = (8, 8)
    dx = (0.125, 0.125)
    rng = np.random.default_rng(5)
    rhs = [torch.tensor(rng.standard_normal(shape)) for _ in range(2)]
    plan = tsp.get_plan(shape, dx, torch.float64, "cpu")
    alpha = torch.tensor(20.0, dtype=torch.float64, requires_grad=True)
    u, p = plan.substep(rhs, alpha, -0.025, (20.0, -0.025))
    assert torch.autograd.grad(u[0].sum() + p.sum(), alpha,
                               allow_unused=True)[0] is None
    with tsp.plain_autodiff_substep():
        u, p = plan.substep(rhs, alpha, -0.025, (20.0, -0.025))
    (g,) = torch.autograd.grad(u[0].sum(), alpha)
    assert float(g.abs()) > 0


def test_substep_adjoint_differentiates_again_exactly():
    """The adjoint's backward is torch ops linear in the cotangents, so a
    Jacobian product taken as the transpose of a VJP (the implicit
    Newton's ``linearize_by_vjp``) through it equals plain autograd's."""
    from ibamr_tpu_torch.solvers.krylov import linearize_by_vjp

    shape, dx = (8, 12), (0.125, 1.0 / 12)
    plan = tsp.get_plan(shape, dx, torch.float64, "cpu")

    def F(x):
        r = x.reshape((2,) + shape)
        u, p = plan.substep([r[0] ** 2, r[1]], 20.0, -0.025, (20.0, -0.025))
        return torch.cat([u[0].reshape(-1), u[1].reshape(-1), p.reshape(-1)])

    rng = np.random.default_rng(9)
    x = torch.tensor(rng.standard_normal(2 * 96))
    v = torch.tensor(rng.standard_normal(2 * 96))
    _, jv = linearize_by_vjp(F, x, v)
    with tsp.plain_autodiff_substep():
        _, jv_plain = linearize_by_vjp(F, x, v)
    assert _rel(jv_plain.numpy(), jv) <= TOL


# -- the packed transfers

OVERFLOWS = {"none": dict(nchunks=64),
             "buffered": dict(nchunks=2, chunk=16),
             "exceeded": dict(nchunks=1, chunk=16, overflow_cap=8)}


def _packed_pair(n, seed, overflow):
    jg, tg = _grids(n)
    rng = np.random.default_rng(seed)
    N = 64
    X = 0.3 + 0.4 * rng.random((N, len(n)))
    kw = OVERFLOWS[overflow]
    je = jpacked.PackedInteraction(jg, **kw)
    te = tpacked.PackedInteraction(tg, device="cpu", **kw)
    jb = je.buckets(jnp.asarray(X))
    tb = te.buckets(torch.tensor(X))
    assert tb.any_overflow == (overflow != "none")
    assert tb.exceeded == (overflow == "exceeded")
    return rng, X, je, te, jb, tb


@pytest.mark.parametrize("n, overflow", [((32, 32), "buffered"),
                                         ((16, 16, 16), "exceeded")])
def test_packed_transfer_vjps_match_reference(n, overflow):
    rng, X, je, te, jb, tb = _packed_pair(n, len(n), overflow)
    dim = len(n)
    F = rng.standard_normal((X.shape[0], dim))
    u = [rng.standard_normal(n) for _ in range(dim)]
    gct = [rng.standard_normal(n) for _ in range(dim)]
    uct = rng.standard_normal((X.shape[0], dim))

    # the reference's VJPs compiled (its eager dispatch is the slow part)
    jF, jX = jax.jit(lambda F_, X_, g_: jax.vjp(
        lambda a, b: je.spread_vel(a, b, b=jb), F_, X_)[1](g_))(
        jnp.asarray(F), jnp.asarray(X), tuple(jnp.asarray(c) for c in gct))
    tF = torch.tensor(F, requires_grad=True)
    tX = torch.tensor(X, requires_grad=True)
    gF, gX = torch.autograd.grad(te.spread_vel(tF, tX, b=tb), [tF, tX],
                                 [torch.tensor(c) for c in gct])
    assert _rel(jF, gF) <= TOL and _rel(jX, gX) <= TOL

    ju, jX = jax.jit(lambda u_, X_, c_: jax.vjp(
        lambda a, b: je.interpolate_vel(a, b, b=jb), u_, X_)[1](c_))(
        tuple(jnp.asarray(c) for c in u), jnp.asarray(X), jnp.asarray(uct))
    tu = [torch.tensor(c, requires_grad=True) for c in u]
    gs = torch.autograd.grad(te.interpolate_vel(tu, tX, b=tb), tu + [tX],
                             torch.tensor(uct))
    for a, b in zip(tuple(ju) + (jX,), gs):
        assert _rel(a, b) <= TOL


def test_packed_adjoints_refuse_a_second_derivative():
    """A reverse pass to be differentiated again raises through the
    adjoint Functions (their layout is held constant), and runs under
    plain_autodiff_transfers."""
    _, X, _, te, _, _ = _packed_pair((16, 16, 16), 5, "none")
    tX = torch.tensor(X, requires_grad=True)
    F = torch.ones(X.shape[0], 3, dtype=torch.float64)

    def first_order():
        f = te.spread_vel(F, tX, b=te.buckets(tX))
        return torch.autograd.grad(sum(torch.sum(c ** 2) for c in f), tX,
                                   create_graph=True)[0]

    with pytest.raises(NotImplementedError, match="plain_autodiff"):
        first_order()
    with tpacked.plain_autodiff_transfers():
        (h,) = torch.autograd.grad(first_order().sum(), tX)
    assert bool(torch.isfinite(h).all()) and float(h.abs().max()) > 0


@pytest.mark.parametrize("overflow", list(OVERFLOWS))
def test_packed_spread_backward_runs_no_scatter(overflow):
    _, X, _, te, _, tb = _packed_pair((16, 16, 16), 3, overflow)
    F = torch.ones(X.shape[0], 3, dtype=torch.float64)
    tX = torch.tensor(X)
    gct = [torch.ones((16, 16, 16), dtype=torch.float64)] * 3

    def primal():
        te.spread_vel(F, tX, b=tb)

    def vjp():
        Fa = F.clone().requires_grad_(True)
        Xa = tX.clone().requires_grad_(True)
        torch.autograd.grad(te.spread_vel(Fa, Xa, b=tb), [Fa, Xa], gct)

    p, v = census(primal)["scatter_ops"], census(vjp)["scatter_ops"]
    assert p >= 3 and v == p


def test_adjoint_functions_equal_plain_autograd_through_a_step():
    """The whole IB step's gradient on the ``packed`` engine through the
    adjoint Functions equals plain autograd's (the buckets rebuilt from
    the differentiated positions inside the step)."""
    integ, st = build_shell_example(n_cells=16, n_lat=8, n_lon=8,
                                    use_fast_interaction="packed",
                                    dtype=torch.float64, device="cpu")
    st = integ.step(st, 1e-3)
    custom = step_grads(integ, st, 1e-3)
    with tpacked.plain_autodiff_transfers(), tsp.plain_autodiff_substep():
        plain = step_grads(integ, st, 1e-3)
    for a, b in zip(custom, plain):
        assert float(b.abs().max()) > 0
        assert _rel(b.numpy(), a) <= TOL


# -- R1: forces that carry an outer gradient

def test_nodal_forces_carry_material_and_position_gradients():
    jmesh = j_rect_quad_mesh(4, 2, x_lo=(0.3, 0.46), x_up=(0.7, 0.54))
    tmesh = t_rect_quad_mesh(4, 2, x_lo=(0.3, 0.46), x_up=(0.7, 0.54))
    rng = np.random.default_rng(11)
    x = np.asarray(jmesh.nodes) + 0.01 * rng.standard_normal(
        np.asarray(jmesh.nodes).shape)
    v = rng.standard_normal(x.shape)
    jasm = jfem.build_assembly(jmesh, dtype=jnp.float64)
    tasm = tfem.build_assembly(tmesh, dtype=torch.float64, device="cpu")

    def jwork(mu, lam, xx):
        return jnp.sum(jfem.nodal_forces(jasm, jfem.neo_hookean(mu, lam), xx)
                       * v)

    ref = jax.jit(jax.grad(jwork, argnums=(0, 1, 2)))(0.7, 2.8,
                                                      jnp.asarray(x))
    mu = torch.tensor(0.7, dtype=torch.float64, requires_grad=True)
    lam = torch.tensor(2.8, dtype=torch.float64, requires_grad=True)
    xx = torch.tensor(x, requires_grad=True)
    F = tfem.nodal_forces(tasm, tfem.neo_hookean(mu, lam), xx)
    assert F.requires_grad
    got = torch.autograd.grad(torch.sum(F * torch.tensor(v)),
                              [mu, lam, xx])
    for a, b in zip(ref, got):
        assert _rel(a, b) <= TOL
    # a material constant alone (positions without grad) carries too
    F = tfem.nodal_forces(tasm, tfem.neo_hookean(mu, 4.0 * mu),
                          torch.tensor(x))
    (g,) = torch.autograd.grad(torch.sum(F * torch.tensor(v)), mu)
    jg = jax.jit(jax.grad(lambda m: jwork(m, 4.0 * m, jnp.asarray(x))))(0.7)
    assert _rel(jg, g) <= TOL
    # and with no outer gradient the force holds no graph, as before
    F = tfem.nodal_forces(tasm, tfem.neo_hookean(0.7, 2.8), torch.tensor(x))
    assert not F.requires_grad


def test_rod_forces_carry_position_frame_and_modulus_gradients():
    n, L = 10, 1.1
    rng = np.random.default_rng(3)
    X, D = jrods.straight_rod(n, L, dtype=jnp.float64)
    X = X + 0.05 * jnp.asarray(rng.standard_normal((n, 3)))
    D = jrods.rotate_frames(D, 0.2 * jnp.asarray(
        rng.standard_normal((n, 3))))
    idx = np.arange(n - 1)
    js = jrods.make_rods(idx, idx + 1, 1.0, 0.3, 10.0, L / (n - 1),
                         dtype=jnp.float64)
    ts = trods.make_rods(idx, idx + 1, 1.0, 0.3, 10.0, L / (n - 1),
                         dtype=torch.float64, device="cpu")
    v, w = rng.standard_normal((n, 3)), rng.standard_normal((n, 3))

    def jwork(XX, DD, b):
        F, N = jrods.rod_force_torque(XX, DD, js._replace(b=b))
        return jnp.sum(F * v) + jnp.sum(N * w)

    ref = jax.jit(jax.grad(jwork, argnums=(0, 1, 2)))(X, D, js.b)
    tX = torch.tensor(np.asarray(X), requires_grad=True)
    tD = torch.tensor(np.asarray(D), requires_grad=True)
    b = ts.b.clone().requires_grad_(True)
    F, N = trods.rod_force_torque(tX, tD, ts._replace(b=b))
    got = torch.autograd.grad(torch.sum(F * torch.tensor(v))
                              + torch.sum(N * torch.tensor(w)), [tX, tD, b])
    for a, g in zip(ref, got):
        assert _rel(a, g) <= TOL


def test_ibfe_implicit_newton_takes_the_elastic_jacobian():
    """The implicit step's Jacobian products differentiate the FE force:
    with it, Newton converges quadratically on a stiff FE disc (two
    iterations a step to roundoff); a force without its derivative
    leaves a Jacobian that misses the elastic term."""
    from ibamr_tpu_torch.integrators.ib_implicit import IBImplicitIntegrator
    from ibamr_tpu_torch.models.fe_disc2d import build_fe_disc_example

    integ, st = build_fe_disc_example(n_cells=32, n_rings=3, stretch=1.2,
                                      mu_s=20.0, lam_s=80.0,
                                      dtype=torch.float64, device="cpu")
    imp = IBImplicitIntegrator(integ.ins, integ.ib)
    for _ in range(2):
        st = imp.step(st, 4e-3)
        assert imp.last_solve_stats["iters"] <= 2
        assert float(imp.last_solve_stats["resnorm"]) < 1e-13


# -- R2: the hand-kernel engines refuse autograd

def _kernel_engine(name, tg, X):
    if name == "pallas_packed":
        return ci.PackedKernelInteraction(tg, nchunks=64, device="cpu")
    if name == "pallas":
        return ci.TileKernelInteraction(tg, cap=64, device="cpu")
    return ci.HybridKernelInteraction(
        tg, nchunks=64, device="cpu",
        compute_dtype=torch.bfloat16 if name == "hybrid_bf16" else None)


@pytest.mark.parametrize("engine", ["pallas_packed", "pallas",
                                    "hybrid_bf16", "hybrid_packed"])
def test_kernel_engines_refuse_autograd(engine):
    jg, tg = _grids((16, 16, 16))
    rng = np.random.default_rng(0)
    X = 0.3 + 0.4 * rng.random((64, 3))
    F = rng.standard_normal((64, 3))
    eng = _kernel_engine(engine, tg, X)
    tX = torch.tensor(X, dtype=torch.float32)
    b = eng.buckets(tX)
    tF = torch.tensor(F, dtype=torch.float32)
    with pytest.raises(NotImplementedError, match=engine):
        eng.spread_vel(tF.clone().requires_grad_(True), tX, b=b)
    with pytest.raises(NotImplementedError, match=engine):
        eng.spread_vel(tF, tX.clone().requires_grad_(True), b=b)
    u = [torch.zeros((16, 16, 16), requires_grad=True) for _ in range(3)]
    with pytest.raises(NotImplementedError, match=engine):
        eng.interpolate_vel(u, tX, b=b)
    # without grad mode the forward runs as before
    with torch.no_grad():
        out = eng.spread_vel(tF.clone().requires_grad_(True), tX, b=b)
    assert all(torch.isfinite(c).all() for c in out)

    if engine in ("pallas_packed", "pallas"):
        # the reference refuses reverse mode through its Pallas engines
        je = (jpal.PallasPackedInteraction(jg, nchunks=64, interpret=True)
              if engine == "pallas_packed"
              else jpal.PallasInteraction(jg, cap=64, interpret=True))
        jX = jnp.asarray(X, jnp.float32)
        jb = je.buckets(jX)
        expected = (NotImplementedError if engine == "pallas_packed"
                    else AssertionError)
        with pytest.raises(expected):
            jax.grad(lambda F_: sum(jnp.sum(c) for c in je.spread_vel(
                F_, jX, b=jb)))(jnp.asarray(F, jnp.float32))
