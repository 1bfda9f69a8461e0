"""Port parity of the implicit IB couplings
(``integrators/ib_implicit.py``) against ibamr_tpu at f64 on the CPU. On
the stiff membrane of ``tests/test_ib_implicit.py`` (32^2, 64 markers, k
= 1e5): the midpoint rule at 3x and backward Euler at 14x the explicit
limit (see its test), with the same Newton counts and X within 1e-9 for
the midpoint rule. On the composite two-level set-up of
``tests/test_ib_implicit_amr.py`` (32^2 with a 16^2 window, 48 markers):
backward Euler at 10x the explicit limit, a regrid of the window and
the 40-step regridding run, with the same Newton counts and windows
(``slow``: a minute or more each on one core); and the tangent FGMRES of
the two-level step against ``jax.jvp``. The engines that launch hand
CUDA kernels refuse the implicit step (checked with the engine objects
alone, built for the CPU); the torch-op engines ``mxu`` and ``packed3``
run it as the reference does (``slow``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from ibamr_tpu import amr as jamr
from ibamr_tpu.grid import StaggeredGrid as JGrid
from ibamr_tpu.integrators import ib_implicit as jii
from ibamr_tpu.integrators.ib import IBMethod as JIB
from ibamr_tpu.models.membrane2d import build_membrane_example as jbuild
from ibamr_tpu.models.membrane2d import make_circle_membrane as jmembrane
from ibamr_tpu_torch import amr as tamr
from ibamr_tpu_torch import convert
from ibamr_tpu_torch.grid import StaggeredGrid as TGrid
from ibamr_tpu_torch.integrators import ib_implicit as tii
from ibamr_tpu_torch.integrators.ib import IBMethod as TIB
from ibamr_tpu_torch.models.membrane2d import build_membrane_example as tbuild
from ibamr_tpu_torch.models.membrane2d import make_circle_membrane as tmembrane
from ibamr_tpu_torch.models.shell3d import build_shell_example
from ibamr_tpu_torch.solvers.krylov import linearize_by_vjp


@pytest.fixture(autouse=True)
def _one_torch_thread():
    """One PyTorch CPU thread per test: the suite runs in parallel
    workers, where each worker's default thread pool oversubscribes the
    cores (these files run 2-3x faster single-threaded there)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_K = 1e5


@pytest.fixture
def newton_counts(monkeypatch):
    """The reference's Newton iteration count of every implicit step (its
    step discards them): ``newton_krylov`` wrapped to report through a
    host callback, which also fires inside ``jax.jit``."""
    counts = []
    orig = jii.newton_krylov

    def recording(*args, **kw):
        sol = orig(*args, **kw)
        jax.debug.callback(lambda i: counts.append(int(i)), sol.iters)
        return sol

    monkeypatch.setattr(jii, "newton_krylov", recording)
    return counts


def _max_err(ref, got):
    return float(np.max(np.abs(np.asarray(ref) - got.detach().numpy())))


def _uniform(scheme, **kw):
    build = dict(n_cells=32, num_markers=64, stiffness=_K, aspect=1.05,
                 rest_length_factor=1.0, mu=0.05, convective_op_type="none")
    ji, js = jbuild(dtype=jnp.float64, **build)
    ti, _ = tbuild(dtype=torch.float64, device="cpu", **build)
    args = dict(newton_tol=1e-9, newton_maxiter=15, inner_m=24,
                inner_restarts=2, inner_tol=1e-4)
    args.update(kw)
    return (jii.IBImplicitIntegrator(ji.ins, ji.ib, scheme=scheme, **args),
            tii.IBImplicitIntegrator(ti.ins, ti.ib, scheme=scheme, **args),
            js, convert.ib_state(js, "cpu"))


def test_uniform_midpoint_at_3x_matches_reference(newton_counts):
    dt = 2e-3                                    # 3x the explicit limit
    jint, tint, js, ts = _uniform("midpoint", inner_tol=1e-5)
    jstep = jax.jit(lambda s: jint.step(s, dt))
    for _ in range(3):
        js, ts = jstep(js), tint.step(ts, dt)
        jax.effects_barrier()
        assert tint.last_solve_stats["iters"] == newton_counts[-1]
        assert _max_err(js.X, ts.X) <= 1e-9
    assert _max_err(js.U, ts.U) <= 1e-9 * max(1.0, float(jnp.max(
        jnp.abs(js.U))))
    tint2, ts2 = _uniform("midpoint", inner_tol=1e-5)[1::2]
    ts2 = tii.advance_ib_implicit(tint2, ts2, dt, 3)
    assert torch.equal(ts2.X, ts.X)


def _be_residuals(jint, tint, js, ts, dt):
    """The backward-Euler residual of the first step in both packages
    (the reference's as its step builds it)."""
    def jres(Xn):
        F = jint.ib.compute_force(Xn, (Xn - js.X) / dt, js.ins.t + dt)
        f = jint.ib.spread_force(F, jint.ins.grid, Xn, js.mask)
        ins = jint.ins.step(js.ins, dt, f=f)
        return Xn - js.X - dt * jint.ib.interpolate_velocity(
            ins.u, jint.ins.grid, Xn, js.mask)

    def tres(Xn):
        F = tint.ib.compute_force(Xn, (Xn - ts.X) / dt, ts.ins.t + dt)
        f = tint.ib.spread_force(F, tint.ins.grid, Xn, ts.mask)
        ins = tint.ins.step(ts.ins, dt, f=f)
        return Xn - ts.X - dt * tint.ib.interpolate_velocity(
            ins.u, tint.ins.grid, Xn, ts.mask)

    return jres, tres


def test_uniform_backward_euler_at_14x_matches_reference(newton_counts):
    """At 14x the inner FGMRES stops at its restart cap ~1% short on a
    badly conditioned Jacobian, and the Newton solve at its 15-iteration
    cap, in both packages: fed the same Jacobian, the reference's FGMRES
    and the port's already part in the third digit. So the Jacobian-vector
    product is held to 1e-13 and the first step to equal Newton counts
    with X within 1e-7; later steps' trajectories part (at 5 steps the
    counts read 9 against 13 in one step) and are not compared."""
    dt = 1e-2
    jint, tint, js, ts = _uniform("backward_euler")
    jres, tres = _be_residuals(jint, tint, js, ts, dt)
    rng = np.random.default_rng(0)
    X = np.asarray(js.X) + 1e-3 * rng.standard_normal(js.X.shape)
    V = rng.standard_normal(X.shape)
    with jii._forward_diffable_trace():
        _, jv = jax.jvp(jres, (jnp.asarray(X),), (jnp.asarray(V),))
    _, tv = linearize_by_vjp(lambda x: tres(x.reshape(X.shape)).reshape(-1),
                             torch.tensor(X).reshape(-1),
                             torch.tensor(V).reshape(-1))
    assert _max_err(np.asarray(jv).reshape(-1), tv) <= 1e-13 * float(
        jnp.max(jnp.abs(jv)))
    js = jax.jit(lambda s: jint.step(s, dt))(js)
    ts = tint.step(ts, dt)
    jax.effects_barrier()
    assert tint.last_solve_stats["iters"] == newton_counts[-1] == 15
    assert _max_err(js.X, ts.X) <= 1e-7


def _two_level(**kw):
    kwg = dict(n=(32, 32), x_lo=(0.0, 0.0), x_up=(1.0, 1.0))
    args = (48, 0.08, (0.5, 0.5))
    mkw = dict(stiffness=_K, aspect=1.05, rest_length_factor=1.0)
    js_, ts_ = jmembrane(*args, **mkw), tmembrane(*args, **mkw)
    jib = JIB(js_.force_specs(dtype=jnp.float64), kernel="IB_4")
    tib = TIB(ts_.force_specs(dtype=torch.float64, device="cpu"),
              kernel="IB_4")
    box = ((8, 8), (16, 16))
    jint = jii.TwoLevelIBImplicit(JGrid(**kwg), jamr.FineBox(*box), jib,
                                  mu=0.02, **kw)
    tint = tii.TwoLevelIBImplicit(TGrid(**kwg), tamr.FineBox(*box), tib,
                                  mu=0.02, device="cpu", **kw)
    return jint, tint, jnp.asarray(js_.vertices, jnp.float64)


_BE10 = dict(proj_tol=1e-8, scheme="backward_euler", newton_tol=1e-8,
             newton_maxiter=12, inner_m=16, inner_restarts=2, inner_tol=1e-3)


@pytest.mark.slow
def test_two_level_backward_euler_at_10x_matches_reference(newton_counts):
    jint, tint, X0 = _two_level(**_BE10)
    js = jint.initialize(X0)
    ts = convert.two_level_ib_state(js, "cpu")
    jstep = jax.jit(lambda s: jint.step(s, 5e-4))
    for _ in range(2):
        js, ts = jstep(js), tint.step(ts, 5e-4)
        jax.effects_barrier()
        assert tint.last_solve_stats["iters"] == newton_counts[-1]
        assert _max_err(js.X, ts.X) <= 1e-9
    # the projection stops at its 2 restarts unconverged (in both
    # packages), where the roundoff of the two Arnoldi runs shows at
    # ~3e-8 of max|u|
    for a, b in zip(js.fluid.uf, ts.fluid.uf):
        assert _max_err(a, b) <= 1e-7 * float(jnp.max(jnp.abs(a)))
    assert not tint._expl.core.proj.last_solve_stats["converged"]


@pytest.mark.slow
def test_two_level_regrid_matches_reference(newton_counts):
    """The window placed off the membrane moves at the first regrid: the
    same new box, state and integrator settings, and the next implicit
    step takes the same Newton count."""
    jint, tint, X0 = _two_level(**_BE10)
    box = ((6, 8), (16, 16))
    jint = jii.TwoLevelIBImplicit(jint.grid, jamr.FineBox(*box), jint.ib,
                                  mu=0.02, **_BE10)
    tint = tii.TwoLevelIBImplicit(tint.grid, tamr.FineBox(*box), tint.ib,
                                  mu=0.02, device="cpu", **_BE10)
    uc = tuple(jnp.full((32, 32), 4.0 if d == 0 else 0.0, jnp.float64)
               for d in range(2))
    js = jint.initialize(X0, uc=uc)
    ts = convert.two_level_ib_state(js, "cpu")
    same, st = tii.regrid_two_level_ib_implicit(tint, ts, move_threshold=3)
    assert same is tint and st is ts
    jint2, js = jii.regrid_two_level_ib_implicit(jint, js)
    tint2, ts = tii.regrid_two_level_ib_implicit(tint, ts)
    assert tint2 is not tint and tint2.box.lo == tuple(jint2.box.lo)
    assert (tint2.scheme, tint2.newton_tol, tint2._expl.core.proj.tol) == \
        ("backward_euler", 1e-8, 1e-8)
    for a, b in zip(js.fluid.uc + js.fluid.uf, ts.fluid.uc + ts.fluid.uf):
        assert _max_err(a, b) <= 1e-10 * float(jnp.max(jnp.abs(a)))
    js = jax.jit(lambda s: jint2.step(s, 5e-4))(js)
    ts = tint2.step(ts, 5e-4)
    jax.effects_barrier()
    assert tint2.last_solve_stats["iters"] == newton_counts[-1]
    assert _max_err(js.X, ts.X) <= 1e-9


@pytest.mark.slow
def test_two_level_regridding_run_matches_reference(newton_counts):
    """A stiff membrane in a background stream at 10x the explicit dt,
    40 steps with a regrid every 10: the window moves at the same
    regrids, with the same Newton counts."""
    kw = dict(proj_tol=1e-7, scheme="backward_euler", newton_tol=1e-7,
              newton_maxiter=10, inner_m=12, inner_restarts=2,
              inner_tol=1e-3)
    jint, tint, X0 = _two_level(**kw)
    uc = tuple(jnp.full((32, 32), 4.0 if d == 0 else 0.0, jnp.float64)
               for d in range(2))
    js = jint.initialize(X0, uc=uc)
    ts = convert.two_level_ib_state(js, "cpu")
    boxes = {"j": [], "t": []}

    def log(key):
        return lambda integ, s, done: boxes[key].append(
            (done, integ.box.lo))

    jint2, js = jii.advance_two_level_ib_implicit_regridding(
        jint, js, 5e-4, 40, regrid_interval=10, on_chunk=log("j"))
    tcounts = []

    def chunk(integ, s, dt, n):
        for _ in range(n):
            s = integ.step(s, dt)
            tcounts.append(integ.last_solve_stats["iters"])
        return s

    tint2, ts = tii.advance_with_regrids(
        tint, ts, 5e-4, 40, 10, chunk, tii.regrid_two_level_ib_implicit,
        on_chunk=log("t"))
    assert boxes["t"] == boxes["j"]
    assert tint2.box.lo != tint.box.lo
    assert tcounts == newton_counts
    assert _max_err(js.X, ts.X) <= 1e-9


@pytest.mark.parametrize("m,restarts,tol", [(8, 3, 1e-10), (20, 2, 1e-6),
                                             (60, 2, 1e-12)])
def test_tangent_fgmres_matches_jax_jvp(m, restarts, tol):
    """``krylov.fgmres_flat_jvp`` (the two-level step's derivative of its
    projection) against ``jax.jvp`` of the reference's FGMRES loop, SVD
    least squares included, on a preconditioned nonsymmetric system; the
    last case runs the Krylov space to breakdown (m = n)."""
    from ibamr_tpu.solvers import krylov as jk
    from ibamr_tpu_torch.solvers import krylov as tk

    rng = np.random.default_rng(m)
    n = 60
    A = rng.standard_normal((n, n)) * 0.3 + 4.0 * np.eye(n)
    Minv = np.diag(1.0 / np.diag(A))
    b, db = rng.standard_normal(n), rng.standard_normal(n)
    Aj, Mj = jnp.asarray(A), jnp.asarray(Minv)
    x, dx = jax.jvp(lambda bb: jk._fgmres_flat(
        lambda v: Aj @ v, bb, jnp.zeros(n), lambda v: Mj @ v, m, tol, 0.0,
        restarts)[0], (jnp.asarray(b),), (jnp.asarray(db),))
    At, Mt = torch.tensor(A), torch.tensor(Minv)
    sol, tdx = tk.fgmres_flat_jvp(lambda v: At @ v, lambda v: Mt @ v,
                                  torch.tensor(b), torch.tensor(db), m=m,
                                  tol=tol, restarts=restarts)
    assert _max_err(x, sol.x) <= 1e-13 * float(jnp.max(jnp.abs(x)))
    assert _max_err(dx, tdx) <= 1e-12 * float(jnp.max(jnp.abs(dx)))


@pytest.mark.parametrize("engine", ["pallas_packed", "pallas",
                                    "hybrid_bf16", "hybrid_packed"])
def test_kernel_engines_refuse_the_implicit_step(engine):
    integ, st = build_shell_example(n_cells=32, n_lat=8, n_lon=8,
                                    use_fast_interaction=engine,
                                    dtype=torch.float64, device="cpu")
    imp = tii.IBImplicitIntegrator(integ.ins, integ.ib)
    with pytest.raises(NotImplementedError, match=engine):
        imp.step(st, 1e-3)


@pytest.mark.slow
@pytest.mark.parametrize("engine", ["mxu", "packed3"])
def test_torch_op_engines_run_the_implicit_step_like_reference(engine):
    """The reference's implicit step runs on the ``mxu`` and ``packed3``
    engines (XLA einsums, which JAX linearizes), so the port's runs too:
    one midpoint step of the 16^3 shell (8x8 markers) at f64, X and u
    within 1e-10 of the reference's, Newton converged (``slow``: the
    reference traces its step for ~45 s)."""
    from ibamr_tpu.models.shell3d import build_shell_example as jshell

    shell = dict(n_cells=16, n_lat=8, n_lon=8)
    jinteg, js = jshell(use_fast_interaction=(True if engine == "mxu"
                                              else engine),
                        dtype=jnp.float64, engine_fallback=False, **shell)
    tinteg, _ = build_shell_example(use_fast_interaction=engine,
                                    dtype=torch.float64, device="cpu",
                                    **shell)
    ji = jii.IBImplicitIntegrator(jinteg.ins, jinteg.ib)
    ti = tii.IBImplicitIntegrator(tinteg.ins, tinteg.ib)
    js2 = ji.step(js, 5e-3)
    ts2 = ti.step(convert.ib_state(js, "cpu"), 5e-3)
    assert ti.last_solve_stats["converged"]
    assert _max_err(js2.X, ts2.X) <= 1e-10 * float(jnp.max(jnp.abs(js2.X)))
    for a, b in zip(js2.ins.u, ts2.ins.u):
        assert _max_err(a, b) <= 1e-10 * float(jnp.max(jnp.abs(a)))


def test_unknown_scheme_raises():
    with pytest.raises(ValueError, match="unknown implicit IB scheme"):
        tii.IBImplicitIntegrator(None, None, scheme="rk4")
