"""Internal fluid sources and sinks carried by Lagrangian points (port of
``ibamr_tpu/ops/sources.py``).

Each source m has a strength Q_m (a volume rate); the Eulerian source
field is q(x) = sum_m Q_m delta_h(x - X_m) at cell centers, spread by
the scatter oracle. In a closed domain the sources must balance the
sinks; the projection removes any residual mean.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ibamr_tpu_torch.device import resolve_device
from ibamr_tpu_torch.grid import StaggeredGrid
from ibamr_tpu_torch.ops import interaction
from ibamr_tpu_torch.ops.delta import Kernel


class SourceSpecs(NamedTuple):
    """M point sources at marker indices ``idx`` with strengths ``Q``."""
    idx: torch.Tensor       # (M,) int64 indices into the marker array
    Q: torch.Tensor         # (M,) volume rates (+source / -sink)
    enabled: torch.Tensor   # (M,) 0/1 mask


def make_sources(idx, Q, enabled=None, dtype=torch.float32,
                 device="cuda") -> SourceSpecs:
    dev = resolve_device(device)
    idx = torch.as_tensor(idx, dtype=torch.int64, device=dev)
    if enabled is None:
        enabled = torch.ones(idx.shape, dtype=dtype, device=dev)
    return SourceSpecs(idx=idx,
                       Q=torch.as_tensor(Q, dtype=dtype, device=dev),
                       enabled=torch.as_tensor(enabled, dtype=dtype,
                                               device=dev))


def eulerian_source(specs: SourceSpecs, grid: StaggeredGrid,
                    X: torch.Tensor, kernel: Kernel = "IB_4",
                    Q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """Cell-centered q(x) = sum_m Q_m delta_h(x - X_m); ``Q`` overrides
    the static strengths (time-varying sources)."""
    strengths = specs.Q if Q is None else Q
    return interaction.spread(strengths * specs.enabled, grid, X[specs.idx],
                              centering="cell", kernel=kernel)
