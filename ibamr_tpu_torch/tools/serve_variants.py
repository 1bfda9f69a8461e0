"""The serving drills with and without the router's run lock.

    python -m ibamr_tpu_torch.tools.serve_variants [--runs 3]
        [--unlocked-runs 2] [--device cuda]

Times the 8^3 shell step alone, then runs the soak drill (at the port's
``SLO.json`` soak rate and length) and the elastic drill ``--runs``
times as the router runs them (one warm chunk at a time,
``serve/router._RUN_LOCK``) and ``--unlocked-runs`` times with the lock
taken out, printing one line per run: its verdict and its healthy shed
rate, healthy warm p99, scale-up and restart seconds and capacity
figures. A measurement tool: nothing imports it.
"""

from __future__ import annotations

import argparse
import tempfile
import time

KEEP = ("healthy_shed_rate", "healthy_warm_p99_s", "chaos_shed",
        "measured_rps", "predicted_rps", "scale_up_s", "restart_warm_s")


def step_ms(device: str, reps: int = 20) -> float:
    """Host milliseconds of one 8^3 shell step (the drills' family)."""
    import torch

    from ibamr_tpu_torch.models.shell3d import build_shell_example

    integ, s = build_shell_example(n_cells=8, n_lat=6, n_lon=8,
                                   device=device)

    def sync():
        if device != "cpu":
            torch.cuda.synchronize()

    for _ in range(3):
        integ.step(s, 5e-5)
    sync()
    t = time.perf_counter()
    for _ in range(reps):
        integ.step(s, 5e-5)
    sync()
    return (time.perf_counter() - t) / reps * 1e3


def run(tag: str, n: int, device: str) -> None:
    from ibamr_tpu_torch.tools import fault_injection as fi

    for _ in range(n):
        for name, fn, kw in (("soak", fi.run_soak_smoke,
                              dict(duration_s=6.0, rate_rps=6.0)),
                             ("elastic", fi.run_elastic_smoke, {})):
            t0 = time.perf_counter()
            try:
                with tempfile.TemporaryDirectory() as tmp:
                    r = fn(tmp, device=device, **kw)
                print(tag, name, "ok", round(time.perf_counter() - t0, 1),
                      {k: r[k] for k in KEEP if k in r}, flush=True)
            except AssertionError as e:
                print(tag, name, "FAIL", e, flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--runs", type=int, default=3)
    ap.add_argument("--unlocked-runs", type=int, default=2)
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)
    from ibamr_tpu_torch.serve import router

    print("8^3 step ms", step_ms(args.device), flush=True)
    run("lock", args.runs, args.device)
    locked = router._one_at_a_time
    router._one_at_a_time = lambda fn: fn
    try:
        run("nolock", args.unlocked_runs, args.device)
    finally:
        router._one_at_a_time = locked
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
