"""Roofline join: attributed device time x call-census counts (port of
``ibamr_tpu/obs/roofline.py``).

A census counts what a step *moves and computes* (``fft_bytes``,
``dot_flops``); :mod:`~ibamr_tpu_torch.obs.deviceprof` measures where
device time *went*. The join divides one by the other:

    achieved FFT GB/s   = fft_bytes_per_step / fft_seconds_per_step
    achieved dot GFLOP/s = dot_flops_per_step / dot_seconds_per_step
    achieved comm GB/s  = wire_bytes_per_step / comm_seconds_per_step
    fraction_of_step_accounted = (fft_s + dot_s + comm_s) / total_device_s

:func:`roofline_join` and :func:`render_roofline` are the reference's.
The census side arrives as the ``census_counts.json`` sidecar that
:func:`census_sidecar` builds. A torch function has no jaxpr to read, so
the sidecar runs ``fn(*args)`` once under a
``torch.overrides.TorchFunctionMode`` that counts, at the call level:

- every ``torch.fft`` call, with its input plus output bytes (the
  reference's ``fft_census``); one ``rfftn`` is one transform, however
  many kernels cuFFT launches for it;
- every ``mm`` / ``bmm`` / ``matmul`` / ``@`` / ``einsum`` call, with
  its operand and output bytes and ``2·|out|·K`` flops, K the product of
  the contracted sizes (the reference's ``dot_census``).

Collectives are 0 on one device. No peak table is hardcoded: the
artifact reports *achieved* rates.
"""

from __future__ import annotations

from typing import List, Optional

__all__ = ["roofline_join", "census_sidecar", "render_roofline"]


def _get(d: dict, key: str, default=0):
    v = d.get(key, default)
    return v if isinstance(v, (int, float)) else default


def roofline_join(summary: dict, census: dict) -> Optional[dict]:
    """Join one attribution summary with its census sidecar.

    ``summary`` needs ``op_classes`` (``fft_s``/``dot_s``) and
    ``total_device_s``; ``census`` needs the ``fft_census``/
    ``dot_census`` byte/flop counts plus ``executions``. Returns the
    roofline block for ``prof_summary.json``, or None when the join is
    impossible (no executions recorded, or no device time)."""
    execs = _get(census, "executions")
    op_classes = summary.get("op_classes") or {}
    total = _get(summary, "total_device_s")
    if execs <= 0 or total <= 0:
        return None
    fft_s = _get(op_classes, "fft_s")
    dot_s = _get(op_classes, "dot_s")
    comm_s = _get(op_classes, "comm_s")
    fft_bytes = _get(census, "fft_bytes")
    dot_bytes = (_get(census, "dot_lhs_bytes")
                 + _get(census, "dot_rhs_bytes")
                 + _get(census, "dot_out_bytes"))
    dot_flops = _get(census, "dot_flops")
    # wire-bytes proxy: pbroadcast is replication bookkeeping that
    # lowers to no-ops — subtract it so achieved GB/s is honest
    comm_bytes = max(0, _get(census, "collective_bytes")
                     - _get(census, "pbroadcast_bytes"))
    out = {
        "executions": int(execs),
        "device_s_per_execution": round(total / execs, 9),
        "fft": None,
        "dot": None,
        "comm": None,
        # how much of the measured device time the censused op classes
        # explain — low values mean the step is dominated by ops the
        # census does not model (elementwise fusions, copies)
        "fraction_of_step_accounted": round(
            (fft_s + dot_s + comm_s) / total, 6),
    }
    if fft_bytes > 0 and fft_s > 0:
        per_exec_s = fft_s / execs
        out["fft"] = {
            "bytes_per_execution": int(fft_bytes),
            "device_s_per_execution": round(per_exec_s, 9),
            "achieved_gb_per_s": round(fft_bytes / per_exec_s / 1e9, 3),
            "fft_ops": int(_get(census, "fft_ops")),
        }
    if dot_flops > 0 and dot_s > 0:
        per_exec_s = dot_s / execs
        out["dot"] = {
            "flops_per_execution": int(dot_flops),
            "bytes_per_execution": int(dot_bytes),
            "device_s_per_execution": round(per_exec_s, 9),
            "achieved_gflop_per_s": round(
                dot_flops / per_exec_s / 1e9, 3),
            "achieved_gb_per_s": round(dot_bytes / per_exec_s / 1e9, 3)
            if dot_bytes > 0 else None,
            "dot_count": int(_get(census, "dot_count")),
        }
    if comm_bytes > 0 and comm_s > 0:
        per_exec_s = comm_s / execs
        out["comm"] = {
            # per-device wire traffic (shard_map avals are per-shard)
            "bytes_per_execution": int(comm_bytes),
            "device_s_per_execution": round(per_exec_s, 9),
            "achieved_gb_per_s": round(
                comm_bytes / per_exec_s / 1e9, 3),
            "collective_prims": int(_get(census, "collective_prims")),
        }
    return out


_DOT_NAMES = {"mm", "bmm", "matmul", "__matmul__", "__rmatmul__",
              "einsum"}
_COLLECTIVE_PRIMS = ("ppermute", "psum", "all_gather", "all_to_all",
                     "pbroadcast")


def _nbytes(t) -> int:
    import torch

    return int(t.numel() * t.element_size()) \
        if isinstance(t, torch.Tensor) else 0


def _einsum_contracted(spec: str, operands) -> int:
    """Product of the sizes of the indices an einsum sums over (those of
    the inputs that the output does not keep)."""
    spec = spec.replace(" ", "")
    lhs, _, out = spec.partition("->")
    terms = lhs.split(",")
    if not _:
        letters = [c for c in lhs if c.isalpha()]
        out = "".join(sorted(c for c in set(letters)
                             if letters.count(c) == 1))
    sizes = {}
    for term, op in zip(terms, operands):
        dims = list(op.shape)
        if "..." in term:
            head, tail = term.split("...")
            term = head + tail
            dims = dims[:len(head)] + dims[len(dims) - len(tail):]
        for c, n in zip(term, dims):
            sizes[c] = int(n)
    k = 1
    for c, n in sizes.items():
        if c not in out:
            k *= n
    return k


def _census_mode():
    """The counting ``TorchFunctionMode`` and the dict it fills (torch is
    imported here: the join itself needs no torch)."""
    import torch
    from torch.overrides import TorchFunctionMode

    counts = {"fft_ops": 0, "fft_bytes": 0,
              "dot_lhs_bytes": 0, "dot_rhs_bytes": 0,
              "dot_out_bytes": 0, "dot_count": 0, "dot_flops": 0}

    class Census(TorchFunctionMode):
        def __torch_function__(self, func, types, args=(), kwargs=None):
            out = func(*args, **(kwargs or {}))
            name = getattr(func, "__name__", "")
            if getattr(func, "__module__", "") == "torch._C._fft" \
                    and not name.endswith(("freq", "shift")):
                counts["fft_ops"] += 1
                counts["fft_bytes"] += _nbytes(args[0]) + _nbytes(out)
            elif name in _DOT_NAMES and isinstance(out, torch.Tensor):
                if name == "einsum":
                    ops = (list(args[1]) if len(args) == 2
                           and isinstance(args[1], (list, tuple))
                           else list(args[1:]))
                    k = _einsum_contracted(args[0], ops)
                    lhs, rhs = (ops + [None, None])[:2]
                else:
                    lhs, rhs = args[0], args[1]
                    k = int(lhs.shape[-1]) if lhs.ndim else 1
                counts["dot_lhs_bytes"] += _nbytes(lhs)
                counts["dot_rhs_bytes"] += _nbytes(rhs)
                counts["dot_out_bytes"] += _nbytes(out)
                counts["dot_flops"] += 2 * int(out.numel()) * k
                counts["dot_count"] += 1
            return out

    return Census(), counts


def census_sidecar(fn, args, label: str = "",
                   executions: int = 0, **extra) -> dict:
    """Build the ``census_counts.json`` document for one captured
    stage: run ``fn(*args)`` once under the counting mode and record its
    FFT, contraction and (on one device, zero) collective counts. Called
    at capture time, when the step function and its arguments are still
    in hand; everything downstream is offline."""
    import torch

    mode, counts = _census_mode()
    with torch.no_grad(), mode:
        fn(*args)
    out = {"schema": 1, "label": label, "executions": int(executions)}
    out.update(counts)
    out.update({"collective_prims": 0, "collective_bytes": 0})
    for p in _COLLECTIVE_PRIMS:
        out[f"{p}_prims"] = 0
        out[f"{p}_bytes"] = 0
    out.update(extra)
    return out


def render_roofline(roofline: Optional[dict]) -> List[str]:
    """Human lines for ``tools/prof.py show``."""
    if not roofline:
        return ["  (no roofline: census sidecar or executions missing)"]
    lines = [
        f"  executions: {roofline.get('executions')}   "
        f"device {roofline.get('device_s_per_execution', 0) * 1e3:.3f} "
        f"ms/execution   "
        f"accounted by fft+dot+comm: "
        f"{100.0 * (roofline.get('fraction_of_step_accounted') or 0):.1f}%"
    ]
    fft = roofline.get("fft")
    if fft:
        lines.append(
            f"  fft: {fft['bytes_per_execution'] / 1e6:.2f} MB/exec in "
            f"{fft['device_s_per_execution'] * 1e3:.3f} ms -> "
            f"{fft['achieved_gb_per_s']:.2f} GB/s achieved "
            f"({fft['fft_ops']} transforms)")
    dot = roofline.get("dot")
    if dot:
        gb = (f", {dot['achieved_gb_per_s']:.2f} GB/s"
              if dot.get("achieved_gb_per_s") else "")
        lines.append(
            f"  dot: {dot['flops_per_execution'] / 1e6:.2f} MFLOP/exec "
            f"in {dot['device_s_per_execution'] * 1e3:.3f} ms -> "
            f"{dot['achieved_gflop_per_s']:.2f} GFLOP/s achieved{gb} "
            f"({dot['dot_count']} contractions)")
    comm = roofline.get("comm")
    if comm:
        lines.append(
            f"  comm: {comm['bytes_per_execution'] / 1e6:.2f} MB/exec "
            f"(per device, wire) in "
            f"{comm['device_s_per_execution'] * 1e3:.3f} ms -> "
            f"{comm['achieved_gb_per_s']:.2f} GB/s achieved "
            f"({comm['collective_prims']} collectives)")
    return lines
