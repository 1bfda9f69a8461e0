"""Search-space enumeration with static pruning (port of
``ibamr_tpu/tune/space.py``).

A trial costs an engine build, a warm-up chunk and timed steps; a
candidate that cannot ship never reaches the runner. Pruning is static
(the geometry facts the engine constructors enforce) plus an optional
probe of the kernel engines:

- **tile divisibility and minimum extent**: every engine but ``scatter``
  blocks the xy plane in 8-tiles and needs ``tile + support + 1`` cells
  per blocked axis, the facts ``default_rule`` promotes on;
- **packed3 z tile**: the z-blocked layout also needs a z tile (16 or 8
  dividing the z extent with room for the footprint), on which
  ``shell3d.construct_transfer_engine`` raises;
- **wall-BC bf16 refusal**: the bf16 spectral transforms are periodic
  only, so a non-periodic configuration prunes every ``bf16`` candidate;
- **kernel probe**: with a ``probe_fn``, each engine that launches hand
  CUDA kernels is built and runs one bucket, spread and interp on the
  requested device (:func:`make_probe_fn`); an engine whose probe raises
  is pruned with the exception's text.

The marker-count threshold of the default rule (4,096) is not a pruning
rule: it is the hand-tuned promotion the measurement replaces.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Optional, Sequence, Tuple

from ibamr_tpu_torch.models.engine_resolver import RESOLVED_ENGINES

# the default searched engine menu; the hybrid aliases and "pallas" stay
# out of it but remain valid engine arguments
DEFAULT_ENGINES = ("scatter", "packed", "packed_bf16", "pallas_packed",
                   "packed3", "packed3_bf16", "mxu", "mxu_bf16")

# the engines that launch hand CUDA kernels: probed when a probe is given
PROBED_ENGINES = frozenset(
    {"pallas", "pallas_packed", "hybrid_packed", "hybrid_packed_bf16",
     "hybrid_bf16"})

_PACKED3 = ("packed3", "packed3_bf16")

# the head of a prune reason the kernel probe wrote
PROBE_PRUNE = "kernel probe failed"


@dataclass(frozen=True)
class Candidate:
    """One point of the engine x spectral_dtype x chunk-length grid."""
    engine: str
    spectral_dtype: str = "f32"
    chunk_length: int = 1

    def label(self) -> str:
        return (f"{self.engine}/{self.spectral_dtype}"
                f"/L{self.chunk_length}")


def _engine_eligible(engine: str, n: Sequence[int],
                     support: int) -> Optional[str]:
    """Static geometry eligibility; returns a prune reason or None."""
    if engine == "scatter":
        return None
    if not all(v % 8 == 0 for v in n[:-1]):
        return (f"xy extents {tuple(n[:-1])} not divisible by the "
                f"8-tile")
    if not all(v >= 8 + support + 1 for v in n[:-1]):
        return (f"xy extents {tuple(n[:-1])} below the make_geometry "
                f"minimum (tile + support + 1 = {8 + support + 1})")
    if engine in _PACKED3:
        tz = next((t for t in (16, 8)
                   if n[-1] % t == 0 and n[-1] >= t + support + 1
                   and t >= support + 1), None)
        if tz is None:
            return (f"no valid z tile for n_z = {n[-1]} "
                    f"(need 8 or 16 dividing it with footprint room)")
    return None


def enumerate_space(
        n: Sequence[int], n_markers: int, support: int, *,
        engines: Sequence[str] = DEFAULT_ENGINES,
        spectral_dtypes: Sequence[str] = ("f32", "bf16"),
        chunk_lengths: Sequence[int] = (1, 4),
        bc: str = "periodic",
        probe_fn: Optional[Callable[[str], None]] = None,
) -> Tuple[list, list]:
    """``(candidates, pruned)`` for one configuration key; ``pruned`` is
    ``[(Candidate, reason), ...]``, so every grid point is accounted for.
    ``probe_fn(engine)`` runs once per probed engine (none when omitted);
    a probe that raises prunes every candidate of that engine."""
    for e in engines:
        if e not in RESOLVED_ENGINES:
            raise ValueError(
                f"unknown engine {e!r} in the search menu; expected "
                f"names from {RESOLVED_ENGINES}")
    candidates, pruned = [], []
    probe_verdict: dict = {}
    for engine in engines:
        geo_reason = _engine_eligible(engine, n, support)
        if geo_reason is None and probe_fn is not None \
                and engine in PROBED_ENGINES:
            if engine not in probe_verdict:
                try:
                    probe_fn(engine)
                    probe_verdict[engine] = None
                except Exception as e:  # noqa: BLE001 - prune, not die
                    probe_verdict[engine] = (
                        f"{PROBE_PRUNE} ({type(e).__name__}: {e})")
            geo_reason = probe_verdict[engine]
        for sd in spectral_dtypes:
            sd = str(sd).lower()
            for L in chunk_lengths:
                cand = Candidate(engine=engine, spectral_dtype=sd,
                                 chunk_length=int(L))
                if geo_reason is not None:
                    pruned.append((cand, geo_reason))
                elif sd == "bf16" and bc != "periodic":
                    pruned.append((
                        cand,
                        f"bf16 spectral transforms are periodic-only "
                        f"(bc={bc!r})"))
                else:
                    candidates.append(cand)
    return candidates, pruned


def make_probe_fn(n: Sequence[int], n_lat: int, n_lon: int,
                  kernel: str = "IB_4",
                  device="cuda") -> Callable[[str], None]:
    """The kernel probe: build the engine against the grid and a shell
    lattice of ``n_lat x n_lon`` markers on ``device`` and run one bucket,
    spread and interp there (the kernels build and launch). Raises on a
    failure."""
    def probe(engine: str) -> None:
        import torch

        from ibamr_tpu_torch.grid import StaggeredGrid
        from ibamr_tpu_torch.models.shell3d import (
            construct_transfer_engine, make_spherical_shell)

        grid = StaggeredGrid(n=tuple(int(v) for v in n),
                             x_lo=(0.0,) * len(n), x_up=(1.0,) * len(n))
        s = make_spherical_shell(n_lat, n_lon, 0.25,
                                 tuple(0.5 for _ in n)[:3], 1.0,
                                 aspect=1.2)
        fast = construct_transfer_engine(engine, grid, s.vertices, kernel,
                                         device=device)
        if fast is None:
            return
        X = torch.as_tensor(s.vertices, dtype=torch.float32, device=device)
        b = fast.buckets(X)
        f = fast.spread_vel(torch.ones_like(X), X, b=b)
        U = fast.interpolate_vel(f, X, b=b)
        if not bool(torch.isfinite(U).all()):
            raise FloatingPointError(f"{engine}: the probe's interp is "
                                     "not finite")
    return probe
