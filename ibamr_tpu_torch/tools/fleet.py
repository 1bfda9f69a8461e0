"""Fleet runner: B ensemble lanes of the 3-D shell in one lane-stacked
state (port of ``tools/fleet.py``).

Runs ``--lanes B`` independently perturbed instances of the 3-D shell as
a lane-stacked fleet: every state leaf carries a leading lane axis, dt
is a (B,) host vector and a (B,) lane-alive mask freezes quarantined
lanes (``utils/hierarchy_driver.py``'s fleet chunk). Under
``ResilientDriver`` supervision (``--dir``) a lane that goes bad is
rolled back alone and quarantined after its retries run out; the other
lanes never stop stepping.

``--mesh D`` lays the lane axis over a D-shard lane mesh
(``parallel.mesh.make_lane_mesh``): each shard owns B/D whole lanes,
checkpoints go through the sharded manifest path, and the per-lane
quarantine and dt machinery is untouched; the result is bitwise the
replicated fleet's. ``--sequential`` also runs each lane alone as a B=1
fleet (the bitwise solo reference) and reports the speedup.

Prints ONE JSON line (the last line of stdout) with per-lane status and
aggregate lane-steps/s; progress goes to stderr. The reference's graph
census of the chunk is JAX-specific and not emitted.

    python -m ibamr_tpu_torch.tools.fleet --lanes 8 --steps 16 --dir RUN
    python -m ibamr_tpu_torch.tools.fleet --lanes 8 --mesh 8 --device cpu
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def perturb_lane(state, i: int, scale: float = 0.01):
    """Lane i's initial condition: the base state with a deterministic
    per-lane velocity perturbation."""
    ins = state.ins
    u = tuple(c * (1.0 + scale * i) + 1e-4 * scale * (i + 1) for c in ins.u)
    return state._replace(ins=ins._replace(u=u))


def lane_steps(state, lane: int) -> int:
    """Steps completed by one lane (the per-lane fluid step counter)."""
    k = state.ins.k if hasattr(state, "ins") else state.k
    return int(k[lane])


def build_fleet(n, n_lat, n_lon, mu, lanes, perturb, dtype, device,
                engine=None):
    from ibamr_tpu_torch.models.shell3d import build_shell_example
    from ibamr_tpu_torch.utils.lanes import stack_lanes

    integ, st0 = build_shell_example(n_cells=n, n_lat=n_lat, n_lon=n_lon,
                                     mu=mu, dtype=dtype, device=device,
                                     use_fast_interaction=engine)
    lane_states = [perturb_lane(st0, i, perturb) for i in range(lanes)]
    return integ, lane_states, stack_lanes(lane_states)


def run_fleet(integ, stacked, cfg, lanes, directory=None, max_retries=2,
              dt_backoff=0.5, quarantine_threshold=0.5, heartbeat=None,
              lane_mesh=None):
    """One supervised fleet run; returns (summary dict, final state).
    With ``lane_mesh`` the stacked state is placed on the lane mesh and
    checkpoints go through the sharded manifest path."""
    from ibamr_tpu_torch import obs
    from ibamr_tpu_torch.utils.health import HealthProbe
    from ibamr_tpu_torch.utils.hierarchy_driver import HierarchyDriver
    from ibamr_tpu_torch.utils.supervisor import ResilientDriver

    if lane_mesh is not None:
        from ibamr_tpu_torch.parallel.mesh import place_lanes
        stacked = place_lanes(stacked, lane_mesh)
    probe = HealthProbe.for_integrator(integ)
    drv = HierarchyDriver(integ, cfg, lanes=lanes, health_probe=probe,
                          lane_mesh=lane_mesh)
    wd = None
    if heartbeat:
        from ibamr_tpu_torch.utils.watchdog import RunWatchdog
        wd = RunWatchdog(heartbeat_path=heartbeat, interval_s=5.0,
                         min_stall_s=300.0)
    t0 = time.perf_counter()
    ledger_path = ledger_seq = None
    if directory:
        ledger_path = os.path.join(directory, "ledger.jsonl")
        sup = ResilientDriver(drv, directory, max_retries=max_retries,
                              dt_backoff=dt_backoff,
                              quarantine_threshold=quarantine_threshold,
                              handle_signals=False, watchdog=wd,
                              sharded=lane_mesh is not None,
                              mesh=lane_mesh,
                              incident_log=os.path.join(directory,
                                                        "incidents.jsonl"))
        with obs.ledger(ledger_path) as led:
            final = sup.run(stacked)
        ledger_seq = led.last_seq if led is not None else None
        incidents = list(sup.incidents)
    else:
        if wd is not None:
            wd.start()
        try:
            final = drv.run(stacked)
        finally:
            if wd is not None:
                wd.stop()
        incidents = []
    wall = time.perf_counter() - t0

    per_lane = []
    total_steps = 0
    for i in range(lanes):
        k = lane_steps(final, i)
        total_steps += k
        per_lane.append({"lane": i, "steps": k,
                         "alive": bool(drv.lane_alive[i]),
                         "dt": float(drv.lane_dt[i])})
    summary = {
        "lanes": lanes,
        "num_steps": cfg.num_steps,
        "wall_s": round(wall, 3),
        "aggregate_steps_per_s": round(total_steps / wall, 3),
        "lanes_quarantined": sum(1 for r in per_lane if not r["alive"]),
        "lanes_backed_off": sum(1 for r in per_lane
                                if r["dt"] != float(cfg.dt)),
        "trace_counts": {str(k): v for k, v in drv.trace_counts.items()},
        "incidents": [r.get("event") for r in incidents],
        "per_lane": per_lane,
    }
    if lane_mesh is not None:
        summary["mesh_devices"] = int(lane_mesh.devices.size)
        summary["lanes_per_device"] = lanes // int(lane_mesh.devices.size)
    if ledger_path is not None:
        summary["ledger_path"] = ledger_path
        summary["ledger_records"] = (ledger_seq + 1
                                     if ledger_seq is not None else 0)
    return summary, final


def run_sequential(integ, lane_states, cfg):
    """Each lane alone as a B=1 fleet (the bitwise solo reference), back
    to back; returns aggregate lane-steps/s over all lanes."""
    from ibamr_tpu_torch.utils.hierarchy_driver import HierarchyDriver
    from ibamr_tpu_torch.utils.lanes import stack_lanes

    t0 = time.perf_counter()
    total = 0
    drv = HierarchyDriver(integ, cfg, lanes=1)
    for st in lane_states:
        final = drv.run(stack_lanes([st]))
        total += lane_steps(final, 0)
        drv.lane_dt[0] = float(cfg.dt)
        drv.lane_alive[0] = True
    wall = time.perf_counter() - t0
    return {"wall_s": round(wall, 3),
            "aggregate_steps_per_s": round(total / wall, 3)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description="lane-stacked ensemble fleet "
                                             "runner")
    ap.add_argument("--lanes", type=int, default=8, help="fleet size B")
    ap.add_argument("--n", type=int, default=32, help="cells/axis")
    ap.add_argument("--n-lat", type=int, default=16)
    ap.add_argument("--n-lon", type=int, default=16)
    ap.add_argument("--mu", type=float, default=0.05)
    ap.add_argument("--steps", type=int, default=16)
    ap.add_argument("--dt", type=float, default=1e-3)
    ap.add_argument("--health-interval", type=int, default=4)
    ap.add_argument("--restart-interval", type=int, default=8)
    ap.add_argument("--perturb", type=float, default=0.01,
                    help="per-lane initial-velocity perturbation scale")
    ap.add_argument("--dir", type=str, default="",
                    help="checkpoint + incident directory (enables "
                         "per-lane rollback/quarantine supervision)")
    ap.add_argument("--max-retries", type=int, default=2)
    ap.add_argument("--dt-backoff", type=float, default=0.5)
    ap.add_argument("--quarantine-threshold", type=float, default=0.5)
    ap.add_argument("--heartbeat", type=str, default="",
                    help="heartbeat.json path")
    ap.add_argument("--mesh", type=int, nargs="?", const=0, default=None,
                    metavar="D",
                    help="lay the lane axis over a D-shard lane mesh "
                         "(omit D for one shard per GPU); the lanes must "
                         "divide over it")
    ap.add_argument("--sequential", action="store_true",
                    help="also run every lane alone (B=1) and report "
                         "the speedup")
    ap.add_argument("--x64", action="store_true",
                    help="run the fleet in float64")
    ap.add_argument("--engine", default=None,
                    help="transfer engine (default: resolved as the "
                         "shell's builder resolves it)")
    ap.add_argument("--device", default="cuda")
    args = ap.parse_args(argv)

    result = {"lanes": args.lanes, "error": None, "device": args.device}
    try:
        from ibamr_tpu_torch.utils.hierarchy_driver import RunConfig

        if args.device == "cpu":
            torch.set_num_threads(1)
        cfg = RunConfig(dt=args.dt, num_steps=args.steps,
                        health_interval=args.health_interval,
                        restart_interval=(args.restart_interval
                                          if args.dir else 0))
        log(f"[fleet] building {args.lanes} lanes of the {args.n}^3 shell "
            f"({args.n_lat * args.n_lon} markers)")
        integ, lane_states, stacked = build_fleet(
            args.n, args.n_lat, args.n_lon, args.mu, args.lanes,
            args.perturb, torch.float64 if args.x64 else torch.float32,
            args.device, engine=args.engine)
        lane_mesh = None
        if args.mesh is not None:
            from ibamr_tpu_torch.parallel.mesh import make_lane_mesh
            lane_mesh = make_lane_mesh(
                n_devices=args.mesh if args.mesh > 0 else None,
                device=args.device)
            result["mesh_devices"] = int(lane_mesh.devices.size)
            log(f"[fleet] lane mesh: {result['mesh_devices']} shards x "
                f"{args.lanes // result['mesh_devices']} lanes each")
        summary, _ = run_fleet(
            integ, stacked, cfg, args.lanes, directory=args.dir or None,
            max_retries=args.max_retries, dt_backoff=args.dt_backoff,
            quarantine_threshold=args.quarantine_threshold,
            heartbeat=args.heartbeat or None, lane_mesh=lane_mesh)
        result.update(summary)
        log(f"[fleet] {args.lanes} lanes x {args.steps} steps: "
            f"{summary['aggregate_steps_per_s']} lane-steps/s "
            f"({summary['lanes_quarantined']} quarantined)")
        if args.sequential:
            cfg_solo = RunConfig(dt=args.dt, num_steps=args.steps,
                                 health_interval=args.health_interval)
            seq = run_sequential(integ, lane_states, cfg_solo)
            result["sequential"] = seq
            if seq["aggregate_steps_per_s"] > 0:
                result["fleet_speedup"] = round(
                    summary["aggregate_steps_per_s"]
                    / seq["aggregate_steps_per_s"], 3)
    except Exception as e:  # noqa: BLE001 - the JSON line must land
        import traceback
        result["error"] = (f"{type(e).__name__}: {e}\n"
                           + traceback.format_exc()[-1200:])
    print(json.dumps(result), flush=True)
    return 0 if result["error"] is None else 1


if __name__ == "__main__":
    sys.exit(main())
