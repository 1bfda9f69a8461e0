"""Microbenchmark: the fluid solve's cost split at one size (port of
``tools/microbench_fluid.py``).

    python -m ibamr_tpu_torch.tools.microbench_fluid [--n 256] [--reps 10]
        [--dt 5e-5] [--json] [--device cuda|cpu]

Times the spectral substep's pieces on one device: the batched forward
and inverse transforms, the diagonal k-space algebra between them, the
fused plan substep and its bf16-operand twin, the chain the fused
substep replaced (separate Helmholtz solves, the projection and the
pressure update), and the whole INS step at f32 and with bf16 transform
operands. Each time is the mean of ``reps`` calls after one warm-up
call, between device synchronizations.
"""

from __future__ import annotations

import argparse
import json
import math

import torch

from ibamr_tpu_torch.tools.microbench_grad import timeit


def run(n: int = 256, reps: int = 10, dt: float = 5e-5, device="cuda",
        quiet: bool = False) -> dict:
    """Time every piece at ``n^3``; returns the flat metrics dict."""
    from ibamr_tpu_torch.device import resolve_device
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.integrators.ins import INSStaggeredIntegrator
    from ibamr_tpu_torch.ops import stencils
    from ibamr_tpu_torch.solvers import fft, spectral_plan

    dev = resolve_device(device)
    grid = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    rho, mu = 1.0, 0.05
    alpha, beta = rho / dt, -0.5 * mu
    gen = torch.Generator().manual_seed(0)
    rhs = tuple(torch.randn(grid.n, generator=gen).to(dev)
                for _ in range(3))
    plan = spectral_plan.get_plan(grid.n, grid.dx, torch.float32, dev)
    axes = (1, 2, 3)
    r = reps
    out = {"n": n, "device": dev.type,
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}

    # the transform / algebra split of the fused substep
    x = torch.stack(rhs)
    out["fwd_transform_ms"] = timeit(
        lambda: torch.fft.rfftn(x, dim=axes), r, dev)
    uh = torch.fft.rfftn(x, dim=axes)
    out["kspace_algebra_ms"] = timeit(
        lambda: plan.kspace_algebra(uh, alpha, beta, (alpha, beta)), r, dev)
    oh = plan.kspace_algebra(uh, alpha, beta, (alpha, beta))
    out["inv_transform_ms"] = timeit(
        lambda: torch.fft.irfftn(oh, s=grid.n, dim=axes), r, dev)
    del x, uh, oh

    # the fused plan substep (two batched transforms) and its bf16 twin
    out["fused_substep_ms"] = timeit(
        lambda: plan.substep(rhs, alpha, beta, (alpha, beta)), r, dev)
    out["fused_substep_bf16_ms"] = timeit(
        lambda: plan.substep(rhs, alpha, beta, (alpha, beta),
                             spectral_dtype="bf16"), r, dev)

    # the chain the fused substep replaced
    def chained():
        u_star = fft.solve_helmholtz_periodic_vel(rhs, grid.dx, alpha, beta)
        u_new, phi0 = fft.project_divergence_free(u_star, grid.dx)
        phi = alpha * phi0
        return u_new, phi - (0.5 * mu * dt / rho) * stencils.laplacian(
            phi, grid.dx)

    out["chained_substep_ms"] = timeit(chained, r, dev)

    # the whole fluid step (convection, rhs assembly, fused substep)
    integ = INSStaggeredIntegrator(grid, rho=rho, mu=mu,
                                   dtype=torch.float32, device=dev)
    st = integ.initialize(u0_arrays=rhs)
    out["ins_step_ms"] = timeit(lambda: integ.step(st, dt), r, dev)
    integ_bf = INSStaggeredIntegrator(grid, rho=rho, mu=mu,
                                      dtype=torch.float32,
                                      spectral_dtype="bf16", device=dev)
    out["ins_step_bf16_ms"] = timeit(lambda: integ_bf.step(st, dt), r, dev)
    out["plan_cache"] = spectral_plan.plan_cache_stats()
    tr = out["fwd_transform_ms"] + out["inv_transform_ms"]
    out["transform_share"] = tr / max(out["fused_substep_ms"], 1e-9)

    if not quiet:
        print(f"n={n} device={out['device_kind']}")
        for key, label in (("fwd_transform_ms", "fwd transform"),
                           ("kspace_algebra_ms", "k-space algebra"),
                           ("inv_transform_ms", "inv transform"),
                           ("fused_substep_ms", "fused substep"),
                           ("fused_substep_bf16_ms", "fused substep bf16"),
                           ("chained_substep_ms", "chained substep"),
                           ("ins_step_ms", "ins step"),
                           ("ins_step_bf16_ms", "ins step bf16")):
            print(f"{label:19s}{out[key]:10.3f} ms")
        share = out["transform_share"]
        print(f"transform share of fused substep: {share:.2f} "
              f"({'transform' if share > 0.5 else 'algebra'}-bound)",
              flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=256)
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--dt", type=float, default=5e-5)
    ap.add_argument("--json", action="store_true",
                    help="print the metrics as one JSON line after the "
                         "table")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    out = run(n=args.n, reps=args.reps, dt=args.dt, device=args.device)
    if args.json:
        print(json.dumps({k: (v if not isinstance(v, float)
                              or math.isfinite(v) else None)
                          for k, v in out.items()}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
