"""Port parity: spectral symbols and the fused periodic Stokes substep of
ibamr_tpu_torch against ibamr_tpu at f64 on the CPU. The symbol tables
are elementwise and agree to about 1e-14 relative; the substep goes
through two different FFT backends (PocketFFT via torch, ducc via JAX)
and agrees to 1e-12 relative."""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from ibamr_tpu.solvers import fft as jfft
from ibamr_tpu.solvers import spectral_plan as jsp
from ibamr_tpu_torch.ops import stencils as tst
from ibamr_tpu_torch.solvers import fft as tfft
from ibamr_tpu_torch.solvers import spectral_plan as tsp

SHAPE = (12, 10, 8)
DX = (1.0 / 12, 0.1, 0.15)
RTOL_TABLE = 1e-14
RTOL_FFT = 1e-12


def _close(ref, got, rtol):
    ref = np.asarray(ref)
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert got.shape == ref.shape
    scale = max(float(np.max(np.abs(ref))), 1e-300)
    np.testing.assert_allclose(got, ref, rtol=0, atol=rtol * scale)


def _rhs(seed):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(SHAPE) for _ in range(3)]


def test_symbols():
    _close(jfft.laplacian_symbol(SHAPE, DX, jnp.float64),
           tfft.laplacian_symbol(SHAPE, DX, torch.float64, "cpu"),
           RTOL_TABLE)
    for a, b in zip(jfft._staggered_div_symbols(SHAPE, DX, jnp.complex128),
                    tfft._staggered_div_symbols(SHAPE, DX, torch.complex128,
                                                "cpu")):
        _close(a, b, RTOL_TABLE)


def test_plan_is_cached_per_key():
    a = tsp.get_plan(SHAPE, DX, torch.float64, "cpu")
    assert tsp.get_plan(list(SHAPE), DX, torch.float64, "cpu") is a
    assert tsp.get_plan(SHAPE, DX, torch.float32, "cpu") is not a


def test_kspace_algebra():
    rhs = _rhs(0)
    uh = np.fft.rfftn(np.stack(rhs), axes=(1, 2, 3))
    jplan = jsp.get_plan(SHAPE, DX, jnp.float64)
    tplan = tsp.get_plan(SHAPE, DX, torch.float64, "cpu")
    ref = jplan.kspace_algebra(jnp.asarray(uh), 20.0, -0.025, (20.0, -0.025))
    got = tplan.kspace_algebra(torch.tensor(uh), 20.0, -0.025,
                               (20.0, -0.025))
    _close(ref, got, RTOL_TABLE)


@pytest.mark.parametrize("alpha,beta,coeffs", [
    (20.0, -0.025, (20.0, -0.025)),    # rho/dt, -mu/2: the IB step
    (1.0, 0.0, (1.0, 0.0)),            # pure projection
])
def test_substep_matches_reference(alpha, beta, coeffs):
    rhs = _rhs(1)
    jplan = jsp.get_plan(SHAPE, DX, jnp.float64)
    ju, jp = jsp._substep_raw(jplan, "none", tuple(map(jnp.asarray, rhs)),
                              alpha, beta, coeffs[0], coeffs[1], None)
    tu, tp = tfft.helmholtz_project_periodic(
        tuple(map(torch.tensor, rhs)), DX, alpha=alpha, beta=beta,
        pinc_coeffs=coeffs)
    for a, b in zip(ju, tu):
        _close(a, b, RTOL_FFT)
    _close(jp, tp, RTOL_FFT)


def test_substep_is_divergence_free():
    rhs = tuple(map(torch.tensor, _rhs(2)))
    u, _ = tfft.helmholtz_project_periodic(rhs, DX, alpha=20.0, beta=-0.025,
                                           pinc_coeffs=(20.0, -0.025))
    div = tst.divergence(u, DX)
    scale = max(float(torch.max(torch.abs(c))) for c in u) / min(DX)
    assert float(torch.max(torch.abs(div))) < 1e-13 * scale


# -- the rest of the spectral solvers --------------------------------------------

def _t(a):
    return torch.tensor(np.asarray(a))


def test_periodic_solves_match_reference():
    rng = np.random.default_rng(3)
    f = rng.standard_normal(SHAPE)
    _close(jfft.solve_poisson_periodic(jnp.asarray(f), DX),
           tfft.solve_poisson_periodic(_t(f), DX), RTOL_FFT)
    _close(jfft.solve_helmholtz_periodic(jnp.asarray(f), DX, 20.0, -0.025),
           tfft.solve_helmholtz_periodic(_t(f), DX, 20.0, -0.025), RTOL_FFT)
    vel = _rhs(4)
    for a, b in zip(jfft.solve_helmholtz_periodic_vel(
                        tuple(map(jnp.asarray, vel)), DX, 20.0, -0.025),
                    tfft.solve_helmholtz_periodic_vel(
                        tuple(map(_t, vel)), DX, 20.0, -0.025)):
        _close(a, b, RTOL_FFT)
    ju, jp = jfft.solve_stokes_periodic(tuple(map(jnp.asarray, vel)), DX, 0.3)
    tu, tp = tfft.solve_stokes_periodic(tuple(map(_t, vel)), DX, 0.3)
    for a, b in zip(ju + (jp,), tu + (tp,)):
        _close(a, b, RTOL_FFT)
    # the zero mode is dropped, as in the reference: zero-mean solutions
    assert abs(float(tfft.solve_poisson_periodic(_t(f), DX).mean())) < 1e-14


def test_projection_with_source_matches_reference():
    vel = _rhs(5)
    q = np.random.default_rng(6).standard_normal(SHAPE)
    ju, jphi = jfft.project_divergence_free(tuple(map(jnp.asarray, vel)), DX,
                                            q=jnp.asarray(q))
    tu, tphi = tfft.project_divergence_free(tuple(map(_t, vel)), DX, q=_t(q))
    for a, b in zip(ju + (jphi,), tu + (tphi,)):
        _close(a, b, RTOL_FFT)
    # div u = q up to its mean (the periodic compatibility projection)
    div = tst.divergence(tu, DX)
    scale = max(float(torch.max(torch.abs(c))) for c in tu) / min(DX)
    assert float(torch.max(torch.abs(div - (_t(q) - q.mean())))) \
        < 1e-12 * scale


@pytest.mark.parametrize("alpha", [20.0, 0.0])
def test_saddle_solve_matches_reference(alpha):
    vel = _rhs(7)
    fp = np.random.default_rng(8).standard_normal(SHAPE)
    jplan = jsp.get_plan(SHAPE, DX, jnp.float64)
    tplan = tsp.get_plan(SHAPE, DX, torch.float64, "cpu")
    ju, jp = jplan.solve_stokes_saddle(tuple(map(jnp.asarray, vel)),
                                       jnp.asarray(fp), alpha, 0.1)
    tu, tp = tplan.solve_stokes_saddle(tuple(map(_t, vel)), _t(fp), alpha,
                                       0.1)
    for a, b in zip(ju + (jp,), tu + (tp,)):
        _close(a, b, RTOL_FFT)


def test_kspace_adjoint_matches_reference_and_is_the_transpose():
    rng = np.random.default_rng(9)
    shp = (4,) + SHAPE[:2] + (SHAPE[2] // 2 + 1,)
    ch = rng.standard_normal(shp) + 1j * rng.standard_normal(shp)
    filt = rng.uniform(0.5, 1.0, shp[1:])
    jplan = jsp.get_plan(SHAPE, DX, jnp.float64)
    tplan = tsp.get_plan(SHAPE, DX, torch.float64, "cpu")
    args = (20.0, -0.025, (20.0, -0.025))
    ref = jplan.kspace_algebra_adjoint(jnp.asarray(ch), *args,
                                       filter_sym=jnp.asarray(filt))
    got = tplan.kspace_algebra_adjoint(torch.tensor(ch), *args,
                                       filter_sym=torch.tensor(filt))
    _close(ref, got, RTOL_TABLE)
    # <M u, c> == <u, M^H c> mode by mode
    uh = torch.tensor(rng.standard_normal((3,) + shp[1:])
                      + 1j * rng.standard_normal((3,) + shp[1:]))
    fwd = tplan.kspace_algebra(uh, *args, filter_sym=torch.tensor(filt))
    c = torch.tensor(ch)
    lhs = torch.sum(torch.conj(c) * fwd, dim=0)
    rhs = torch.sum(torch.conj(got) * uh, dim=0)
    assert float(torch.max(torch.abs(lhs - rhs))) \
        < 1e-12 * float(torch.max(torch.abs(lhs)))


def test_gaussian_filter_and_filtered_substep_match_reference():
    jf = jsp.gaussian_filter_symbol(SHAPE, DX, 0.2, jnp.float64)
    tf = tsp.gaussian_filter_symbol(SHAPE, DX, 0.2, torch.float64, "cpu")
    _close(jf, tf, RTOL_TABLE)
    rhs = _rhs(10)
    ju, jp = jsp.spectral_substep(tuple(map(jnp.asarray, rhs)), DX, 20.0,
                                  -0.025, (20.0, -0.025), filter_sym=jf)
    tu, tp = tsp.spectral_substep(tuple(map(_t, rhs)), DX, 20.0, -0.025,
                                  (20.0, -0.025), filter_sym=tf)
    for a, b in zip(ju + (jp,), tu + (tp,)):
        _close(a, b, RTOL_FFT)


def test_bf16_substep_within_the_reference_suite_tolerance():
    """bf16 transform operands, emulated by rounding through bf16: within
    the reference suite's 2e-2 of the f64 oracle (and really compressed),
    and next to the reference's own bf16 substep."""
    shape = (16, 16, 16)
    dx = tuple(1.0 / s for s in shape)
    alpha, beta = 2.0e4, -0.025
    rng = np.random.default_rng(11)
    rhs = [rng.standard_normal(shape) for _ in range(3)]
    r32 = tuple(torch.tensor(c, dtype=torch.float32) for c in rhs)
    args = dict(alpha=alpha, beta=beta, pinc_coeffs=(alpha, beta))
    u64, p64 = tfft.helmholtz_project_periodic(tuple(map(_t, rhs)), dx,
                                               **args)
    ubf, pbf = tfft.helmholtz_project_periodic(r32, dx, **args,
                                               spectral_dtype="bf16")
    jbf, jpbf = jfft.helmholtz_project_periodic(
        tuple(jnp.asarray(c, jnp.float32) for c in rhs), dx, **args,
        spectral_dtype="bf16")

    def rel(a, ref):
        a = a.double().numpy() if isinstance(a, torch.Tensor) \
            else np.asarray(a, np.float64)
        ref = ref.numpy() if isinstance(ref, torch.Tensor) else np.asarray(ref)
        return np.max(np.abs(a - ref)) / np.max(np.abs(ref))

    for d in range(3):
        assert ubf[d].dtype == torch.float32
        assert 1e-6 < rel(ubf[d], u64[d]) < 2e-2
        assert rel(ubf[d], jbf[d]) < 2e-2
    assert rel(pbf, p64) < 2e-2
    # residual divergence stays in the bf16 rounding class
    umax = max(float(torch.max(torch.abs(c))) for c in ubf)
    assert float(torch.max(torch.abs(tst.divergence(ubf, dx)))) \
        < 0.1 * umax / min(dx)


def test_f64_twin_plan_matches_reference_to_roundoff():
    rhs = _rhs(12)
    r32 = tuple(torch.tensor(c, dtype=torch.float32) for c in rhs)
    args = dict(alpha=20.0, beta=-0.025, pinc_coeffs=(20.0, -0.025))
    tu, tp = tfft.helmholtz_project_periodic(r32, DX, **args,
                                             spectral_dtype="f64")
    ju, jp = jfft.helmholtz_project_periodic(
        tuple(jnp.asarray(c, jnp.float32) for c in rhs), DX, **args,
        spectral_dtype="f64")
    assert tu[0].dtype == torch.float32
    # both run the f64 twin plan and round once to f32
    for a, b in zip(ju + (jp,), tu + (tp,)):
        _close(a, b, 1e-7)


def test_spectral_dtype_knob_and_plan_cache_stats():
    assert tsp.canonical_spectral_dtype("BF16") is torch.bfloat16
    assert tsp.canonical_spectral_dtype("f32") is None
    assert tsp.canonical_spectral_dtype(torch.float64) is torch.float64
    for bad in ("fp8", torch.float32):
        with pytest.raises(ValueError):
            tsp.canonical_spectral_dtype(bad)
    tsp.clear_plan_cache()
    assert tsp.plan_cache_stats() == dict(hits=0, misses=0, evictions=0,
                                          size=0, maxsize=16)
    for i in range(18):
        tsp.get_plan((4, 4 + i), (1.0, 1.0), torch.float64, "cpu")
    tsp.get_plan((4, 4 + 17), (1.0, 1.0), torch.float64, "cpu")
    assert tsp.plan_cache_stats() == dict(hits=1, misses=18, evictions=2,
                                          size=16, maxsize=16)


@pytest.mark.parametrize("sdtype", ["bf16", "f64"])
def test_shell_step_takes_spectral_dtype_like_reference(sdtype):
    """``build_shell_example(spectral_dtype=...)`` on the scatter engine:
    two midpoint steps equal to the reference's at f32 (the transforms'
    backends differ: the bf16 rounding of the same operands may fall
    either way, so u is held to the bf16 class, X closer)."""
    import jax

    from ibamr_tpu.models.shell3d import build_shell_example as jbuild
    from ibamr_tpu_torch.models.shell3d import build_shell_example as tbuild

    kw = dict(n_cells=16, n_lat=6, n_lon=6, spectral_dtype=sdtype)
    ji, js = jbuild(**kw, use_fast_interaction=False, dtype=jnp.float32)
    ti, ts = tbuild(**kw, use_fast_interaction="scatter",
                    dtype=torch.float32, device="cpu")
    assert ti.ins.spectral_dtype is tsp.canonical_spectral_dtype(sdtype)
    for _ in range(2):
        js = jax.jit(ji.step, static_argnums=1)(js, 5e-3)
        ts = ti.step(ts, 5e-3)
    tol = 2e-2 if sdtype == "bf16" else 1e-5
    for a, b in zip(js.ins.u, ts.ins.u):
        _close(a, b, tol)
    _close(js.X, ts.X, 1e-6)
