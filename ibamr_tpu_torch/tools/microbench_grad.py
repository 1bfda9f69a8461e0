"""Microbenchmark: the price of the adjoint, piece by piece (port of
``tools/microbench_grad.py``).

    python -m ibamr_tpu_torch.tools.microbench_grad [--n 64] [--reps 5]
        [--dt 5e-5] [--json] [--device cuda|cpu]

Primal against VJP milliseconds of each differentiable piece: the fused
spectral substep, the ``packed`` engine's spread and interp of a MAC
velocity through one packing of the shell, and the whole coupled IB step
on ``packed`` (the gradient of the sum of its output's floating leaves
with respect to the state's velocity, pressure, convective history and
marker positions). Beside each: the ratio, and the counts of aten FFT
calls (``_fft_r2c`` / ``_fft_c2r`` / ``_fft_c2c``), accumulating
scatters (``index_put`` with ``accumulate``, ``index_add``,
``scatter_add``, ``scatter_reduce``) and widenings to float64
(``_to_copy`` to f64 from another type), taken by a ``TorchDispatchMode``
over one call (the reference reads the same numbers from its jaxpr
census). The substep's VJP should show exactly twice the primal's FFT
calls and the spread's VJP no scatter beyond its primal's.

The dispatch mode is thread-local state that the autograd engine carries
into its device threads, so the census of a VJP includes its backward
ops on the card as on the CPU; ``census_threads`` records how many
threads ran counted ops.

Each time is the mean of ``reps`` calls after one warm-up call, between
device synchronizations. :func:`run` is the library form (``chip_smoke.py``
calls it at the flagship with ``plain=True``, which adds the whole step's
gradient under ``plain_autodiff_substep()`` and
``plain_autodiff_transfers()``: its time, the deviation of each leaf from
the custom gradient, and, on the card, each leg's peak device memory).
"""

from __future__ import annotations

import argparse
import json
import math
import threading
import time

import torch
from torch.utils._python_dispatch import TorchDispatchMode

FFT_OPS = ("_fft_r2c", "_fft_c2r", "_fft_c2c")
SCATTER_OPS = ("index_add", "index_add_", "scatter_add", "scatter_add_",
               "scatter_reduce", "scatter_reduce_")
INDEX_PUT_OPS = ("index_put", "index_put_", "_index_put_impl_")


class OpCensus(TorchDispatchMode):
    """Counts of the aten ops this module reports, over every thread that
    runs under the mode."""

    def __init__(self):
        super().__init__()
        self.counts = {"fft_ops": 0, "scatter_ops": 0, "f64_widenings": 0}
        self.threads = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = func.overloadpacket.__name__
        counted = True
        if name in FFT_OPS:
            self.counts["fft_ops"] += 1
        elif name in SCATTER_OPS:
            self.counts["scatter_ops"] += 1
        elif name in INDEX_PUT_OPS:
            acc = kwargs.get("accumulate", args[3] if len(args) > 3
                             else False)
            self.counts["scatter_ops"] += int(bool(acc))
        elif (name == "_to_copy" and kwargs.get("dtype") == torch.float64
              and isinstance(args[0], torch.Tensor)
              and args[0].dtype != torch.float64):
            self.counts["f64_widenings"] += 1
        else:
            counted = False
        if counted:
            self.threads.add(threading.get_ident())
        return func(*args, **kwargs)


def census(fn) -> dict:
    """The :class:`OpCensus` counts of one call of ``fn``."""
    with OpCensus() as c:
        fn()
    return dict(c.counts, census_threads=len(c.threads))


def _sync(device) -> None:
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def timeit(fn, reps: int, device) -> float:
    """Mean milliseconds of ``reps`` calls after one warm-up call."""
    fn()
    _sync(device)
    t0 = time.perf_counter()
    for _ in range(reps):
        fn()
    _sync(device)
    return (time.perf_counter() - t0) / reps * 1e3


def _peak_mib(fn, device):
    """Peak device memory (MiB) of one call of ``fn`` on the card (the
    allocator's high-water mark, including what was live before it), or
    None on the CPU."""
    if torch.device(device).type != "cuda":
        return None
    _sync(device)
    torch.cuda.reset_peak_memory_stats()
    fn()
    _sync(device)
    return torch.cuda.max_memory_allocated() / 2 ** 20


def _grad_leaves(state):
    """The state's differentiated leaves: velocity, pressure, convective
    history and marker positions (the mask is the layout's weight field
    and the step counter an integer; both are held constant)."""
    ins = state.ins
    return list(ins.u) + [ins.p] + list(ins.n_prev) + [state.X]


def step_grads(integ, state, dt):
    """The gradient of the sum of the step's floating output leaves with
    respect to :func:`_grad_leaves` of ``state``; the reverse pass runs
    under PyTorch's deterministic algorithms."""
    from ibamr_tpu_torch.ops.interaction import deterministic
    from ibamr_tpu_torch.utils.tree import leaves

    with torch.enable_grad():
        xs = [x.detach().requires_grad_(True) for x in _grad_leaves(state)]
        ins = state.ins
        dim = len(ins.u)
        s = state._replace(
            ins=ins._replace(u=tuple(xs[:dim]), p=xs[dim],
                             n_prev=tuple(xs[dim + 1:2 * dim + 1])),
            X=xs[-1])
        out = integ.step(s, dt)
        loss = sum(torch.sum(leaf) for leaf in leaves(out)
                   if leaf.is_floating_point())
        with deterministic():
            gs = torch.autograd.grad(loss, xs, allow_unused=True)
    return [torch.zeros_like(x) if g is None else g for g, x in zip(gs, xs)]


def run(n: int = 64, reps: int = 5, dt: float = 5e-5, device="cuda",
        shell=None, plain: bool = False, quiet: bool = False) -> dict:
    """Measure every piece at one size; returns the flat metrics dict.
    ``shell`` (``build_shell_example`` keywords) replaces the reference's
    shell for the coupled pieces (``n_lat = n_lon = max(8, 5n/4)``,
    radius 0.25, aspect 1.2, in ``max(n, 16)^3``: the packed layout needs
    a tile of 8 plus the footprint)."""
    from ibamr_tpu_torch.device import resolve_device
    from ibamr_tpu_torch.grid import StaggeredGrid
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.ops.interaction_packed import \
        plain_autodiff_transfers
    from ibamr_tpu_torch.solvers import spectral_plan

    dev = resolve_device(device)
    r = reps
    rho, mu = 1.0, 0.05
    alpha, beta = rho / dt, -0.5 * mu
    gen = torch.Generator().manual_seed(0)

    def randn(*shape):
        return torch.randn(*shape, generator=gen).to(dev)

    out = {"n": n, "device": dev.type,
           "device_kind": (torch.cuda.get_device_name(dev)
                           if dev.type == "cuda" else "cpu")}
    if not quiet:
        print(f"n={n} dt={dt} device={out['device_kind']}", flush=True)

    # -- the fused substep: primal against its VJP round trip --------------
    grid = StaggeredGrid(n=(n,) * 3, x_lo=(0.0,) * 3, x_up=(1.0,) * 3)
    rhs = tuple(randn(*grid.n) for _ in range(3))
    plan = spectral_plan.get_plan(grid.n, grid.dx, torch.float32, dev)
    cts = [torch.ones(grid.n, device=dev) for _ in range(4)]

    def substep():
        return plan.substep(rhs, alpha, beta, (alpha, beta))

    def substep_vjp():
        with torch.enable_grad():
            rr = [c.detach().requires_grad_(True) for c in rhs]
            u, p = plan.substep(rr, alpha, beta, (alpha, beta))
            return torch.autograd.grad(list(u) + [p], rr, cts)

    out["substep_primal_ms"] = timeit(substep, r, dev)
    out["substep_vjp_ms"] = timeit(substep_vjp, r, dev)
    for k, v in census(substep).items():
        out[f"substep_primal_{k}"] = v
    for k, v in census(substep_vjp).items():
        out[f"substep_vjp_{k}"] = v
    del rhs, cts

    # -- the packed transfers: primal against VJP through one packing ------
    kw = shell or dict(n_cells=max(n, 16), n_lat=max(8, (5 * n) // 4),
                       n_lon=max(8, (5 * n) // 4), radius=0.25, aspect=1.2,
                       stiffness=1.0, rest_length_factor=0.75, mu=mu)
    integ, state = build_shell_example(use_fast_interaction="packed",
                                       dtype=torch.float32, device=dev,
                                       **kw)
    # one step from rest first, so that the convective history is live
    state = integ.step(state, dt)
    out["shell_markers"] = int(state.X.shape[0])
    out["shell_n_cells"] = int(integ.ins.grid.n[0])
    eng = integ.ib.fast
    X, mask = state.X, state.mask
    b = eng.buckets(X, mask)
    F = randn(*X.shape)
    u = state.ins.u
    gct = [torch.ones(integ.ins.grid.n, device=dev) for _ in range(3)]
    uct = torch.ones_like(X)

    def spread():
        return eng.spread_vel(F, X, b=b)

    def spread_vjp():
        with torch.enable_grad():
            Fa, Xa = F.detach().requires_grad_(True), \
                X.detach().requires_grad_(True)
            return torch.autograd.grad(eng.spread_vel(Fa, Xa, b=b),
                                       [Fa, Xa], gct)

    def interp():
        return eng.interpolate_vel(u, X, b=b)

    def interp_vjp():
        with torch.enable_grad():
            ua = [c.detach().requires_grad_(True) for c in u]
            Xa = X.detach().requires_grad_(True)
            return torch.autograd.grad(eng.interpolate_vel(ua, Xa, b=b),
                                       ua + [Xa], uct)

    for piece, fp, fv in (("spread", spread, spread_vjp),
                          ("interp", interp, interp_vjp)):
        out[f"{piece}_primal_ms"] = timeit(fp, r, dev)
        out[f"{piece}_vjp_ms"] = timeit(fv, r, dev)
        for k, v in census(fp).items():
            out[f"{piece}_primal_{k}"] = v
        for k, v in census(fv).items():
            out[f"{piece}_vjp_{k}"] = v
    del b, F, gct, uct

    # -- the whole coupled step: primal against its reverse pass -----------
    def step():
        return integ.step(state, dt)

    def step_vjp():
        return step_grads(integ, state, dt)

    out["step_primal_ms"] = timeit(step, r, dev)
    out["step_vjp_ms"] = timeit(step_vjp, r, dev)
    for k, v in census(step).items():
        out[f"step_primal_{k}"] = v
    for k, v in census(step_vjp).items():
        out[f"step_vjp_{k}"] = v
    out["step_primal_peak_mib"] = _peak_mib(step, dev)
    out["step_vjp_peak_mib"] = _peak_mib(step_vjp, dev)

    if plain:
        def step_vjp_plain():
            with plain_autodiff_transfers(), \
                    spectral_plan.plain_autodiff_substep():
                return step_grads(integ, state, dt)

        out["step_vjp_plain_ms"] = timeit(step_vjp_plain, r, dev)
        for k, v in census(step_vjp_plain).items():
            out[f"step_vjp_plain_{k}"] = v
        out["step_vjp_plain_peak_mib"] = _peak_mib(step_vjp_plain, dev)
        g1, g2 = step_vjp(), step_vjp()
        gp = step_vjp_plain()
        names = [f"u[{d}]" for d in range(3)] + ["p"] + \
            [f"n_prev[{d}]" for d in range(3)] + ["X"]
        out["step_vjp_bitwise"] = all(bool(torch.equal(a, c))
                                      for a, c in zip(g1, g2))
        out["step_plain_rel_dev"] = {
            nm: float(torch.max(torch.abs(a - c)))
            / max(float(torch.max(torch.abs(c))), 1e-300)
            for nm, a, c in zip(names, g1, gp)}
        out["step_plain_max_abs"] = {
            nm: float(torch.max(torch.abs(c))) for nm, c in zip(names, gp)}

    for piece in ("substep", "spread", "interp", "step"):
        p, v = out[f"{piece}_primal_ms"], out[f"{piece}_vjp_ms"]
        out[f"{piece}_grad_ratio"] = v / max(p, 1e-9)
    if plain:
        out["step_plain_grad_ratio"] = out["step_vjp_plain_ms"] / max(
            out["step_primal_ms"], 1e-9)

    if not quiet:
        print(f"{'piece':10s} {'primal ms':>10s} {'vjp ms':>10s} "
              f"{'ratio':>7s} {'ffts p/v':>9s} {'scat p/v':>9s}")
        for piece in ("substep", "spread", "interp", "step"):
            print(f"{piece:10s} {out[f'{piece}_primal_ms']:10.3f} "
                  f"{out[f'{piece}_vjp_ms']:10.3f} "
                  f"{out[f'{piece}_grad_ratio']:7.2f} "
                  f"{out[f'{piece}_primal_fft_ops']:4d}/"
                  f"{out[f'{piece}_vjp_fft_ops']:<4d} "
                  f"{out[f'{piece}_primal_scatter_ops']:4d}/"
                  f"{out[f'{piece}_vjp_scatter_ops']:<4d}")
        wid = sum(v for k, v in out.items() if k.endswith("f64_widenings"))
        print(f"f64 widenings across all pieces: {wid}", flush=True)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--n", type=int, default=64,
                    help="fluid cells per side (the coupled pieces scale "
                         "their shell with it)")
    ap.add_argument("--reps", type=int, default=5)
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
