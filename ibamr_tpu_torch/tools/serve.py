"""Warm-pool scenario server command line (port of ``tools/serve.py``).

    python -m ibamr_tpu_torch.tools.serve bench [--device cpu]
    python -m ibamr_tpu_torch.tools.serve check [--device cpu] [--tighten]
        [--json] [--contract PATH]

``bench`` — time request-to-first-step latency cold vs warm through the
router (``cold_warm_drill``) on the card (``--device cpu``: the host),
emitting ONE JSON line on stdout.

``check`` — the cold-vs-warm build-count contract gate (the
``graph_audit`` exit-code convention):

- exit 0 — the drill matches the port's ``SERVE_CONTRACT.json`` exactly
  (clean);
- exit 1 — improved (fewer cold builds) or unbudgeted: re-run with
  ``--tighten`` to pin;
- exit 2 — regressed: a build on the warm path, a new input signature,
  a lost cache hit, or a failed request. A cache regression fails CI
  structurally, not anecdotally.

Contract metric directions: ``cold_compiles``, ``warm_compiles`` and
``warm_new_trace_signatures`` are ceilings (regress UP); ``warm_hits``
is a floor (regresses DOWN). A "compile" in the port is an executable
cache miss: one pool chunk's build and warm-up call. The check runs on
the card unless ``--device cpu``; the counts are structural, so both
give the same verdict, and the CPU run is the hermetic one.
"""

from __future__ import annotations

import argparse
import json
import os

CONTRACT_PATH = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
    "SERVE_CONTRACT.json")

CEILINGS = ("cold_compiles", "warm_compiles",
            "warm_new_trace_signatures")
FLOORS = ("warm_hits",)
CONTRACT_METRICS = CEILINGS + FLOORS


def run_drill(args, device: str) -> dict:
    """The cold/warm drill of ``args`` on ``device``."""
    from ibamr_tpu_torch.serve.router import cold_warm_drill

    out = cold_warm_drill(
        n_cells=args.n, n_lat=args.n_lat, n_lon=args.n_lon,
        lanes=args.lanes, steps=args.steps, dt=args.dt,
        engine=args.engine or None, device=device)
    out["platform"] = "cpu" if device == "cpu" else "cuda"
    return out


def load_contract(path: str = CONTRACT_PATH):
    with open(path) as f:
        return json.load(f)["contract"]


def diff_contract(measured: dict, contract: dict):
    """(regressions, improvements) — each a list of human-readable
    drift lines."""
    regressions, improvements = [], []
    for name in CONTRACT_METRICS:
        if name not in contract:
            continue
        got, want = measured.get(name), contract[name]
        if got is None:
            regressions.append(f"{name}: missing from measurement")
            continue
        if name in FLOORS:
            worse, better = got < want, got > want
        else:
            worse, better = got > want, got < want
        if worse:
            regressions.append(f"{name}: measured {got} vs budget "
                               f"{want} (REGRESSED)")
        elif better:
            improvements.append(f"{name}: measured {got} vs budget "
                                f"{want} (improved)")
    for flag in ("cold_ok", "warm_ok"):
        if not measured.get(flag, False):
            regressions.append(f"{flag}: request failed")
    return regressions, improvements


def cmd_bench(args) -> int:
    out = run_drill(args, args.device)
    print(json.dumps(out, sort_keys=True))
    return 0


def cmd_check(args) -> int:
    measured = run_drill(args, args.device)
    if args.tighten:
        doc = {"_doc": (
            "Cold-vs-warm serving build-count contract of the PyTorch "
            "port (python -m ibamr_tpu_torch.tools.serve check), "
            "measured on the port's router on the "
            f"{measured['platform']} device. A compile is an executable "
            "cache miss: one pool chunk's build and warm-up call. "
            "'warm_hits' is a floor (regresses DOWN), every other "
            "metric a ceiling (regresses UP); warm_compiles == 0 is the "
            "kill-the-cold-start guarantee."),
            "drill": {k: measured[k] for k in
                      ("n", "lanes", "steps", "engine")},
            "contract": {k: measured[k] for k in CONTRACT_METRICS}}
        with open(args.contract, "w") as f:
            json.dump(doc, f, indent=1, sort_keys=True)
            f.write("\n")
        print(f"[serve] wrote {args.contract}")
        return 0
    try:
        contract = load_contract(args.contract)
    except FileNotFoundError:
        contract = None
    regressions, improvements = ([], []) if contract is None \
        else diff_contract(measured, contract)
    if contract is None:
        # an unbudgeted drill still gates request health
        regressions = [f"{flag}: request failed"
                       for flag in ("cold_ok", "warm_ok")
                       if not measured.get(flag, False)]
    rc = 2 if regressions else (1 if improvements or contract is None
                                else 0)
    if args.as_json:
        print(json.dumps({
            "exit": rc, "measured": measured,
            "regressed": regressions, "improved": improvements,
            "unbudgeted": contract is None}, indent=1, sort_keys=True))
        return rc
    for line in regressions:
        print(f"[serve] {line}")
    for line in improvements:
        print(f"[serve] {line}")
    if contract is None:
        print(f"[serve] no contract at {args.contract} — run "
              f"--tighten to pin")
    verdict = {0: "clean — drill matches the serve contract",
               1: "improved/unbudgeted — run --tighten to pin",
               2: "REGRESSED — the warm path is no longer free"}[rc]
    print(f"[serve] cold {measured['cold_first_step_s']}s / warm "
          f"{measured['warm_first_step_s']}s "
          f"(ratio {measured['warm_over_cold']}), "
          f"{measured['cold_compiles']} cold / "
          f"{measured['warm_compiles']} warm compile(s): {verdict}")
    return rc


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(
        description="warm-pool scenario server: cold/warm latency "
                    "bench + build-count contract gate")
    sub = ap.add_subparsers(dest="cmd", required=True)

    def drill_args(p):
        p.add_argument("--n", type=int, default=16)
        p.add_argument("--n-lat", type=int, default=8)
        p.add_argument("--n-lon", type=int, default=16)
        p.add_argument("--lanes", type=int, default=2)
        p.add_argument("--steps", type=int, default=3)
        p.add_argument("--dt", type=float, default=5e-5)
        p.add_argument("--engine", type=str, default="",
                       help="engine name ('' = auto via the resolver)")
        p.add_argument("--device", default="cuda",
                       help="where the pool runs: cuda (the card, the "
                            "default) or cpu")

    b = sub.add_parser("bench", help="cold/warm request-to-first-step "
                                     "latency, one JSON line")
    drill_args(b)
    b.set_defaults(fn=cmd_bench)

    c = sub.add_parser("check", help="gate the cold-vs-warm "
                                     "build-count contract")
    drill_args(c)
    c.add_argument("--tighten", action="store_true",
                   help="rewrite the contract to the measured values")
    c.add_argument("--json", action="store_true", dest="as_json",
                   help="machine-readable report on stdout")
    c.add_argument("--contract", type=str, default=CONTRACT_PATH)
    c.set_defaults(fn=cmd_check)

    args = ap.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    raise SystemExit(main())
