"""Masked ensemble square-root filter (ESRF/ETKF) analysis (port of
``ibamr_tpu/assim/enkf.py``).

The analysis is small dense linear algebra in ensemble space (Evensen
1994; ETKF square-root form after Hunt et al. 2007): with B lanes and m
observed channels, everything beyond the two (B, n) ensemble products
is (B, B) or (B, m), an eigendecomposition and a few small products.

Robustness contracts, as in the reference:

- **masked statistics**: the (B,) ``alive`` mask weights every ensemble
  moment, so a quarantined lane contributes NOTHING to the mean, the
  anomalies or the gain, and its own rows pass through the analysis
  bitwise frozen (``torch.where`` on the lane axis). Masked analysis on
  B lanes with k alive is the dense analysis on the k-member ensemble.
- **masked observations**: the (m,) ``obs_mask`` from the QC gate zeroes
  rejected channels out of the innovation and the gain instead of
  slicing them out, so a cycle with rejected sensors runs the same
  shapes, and the same cached callable, as a clean one.
- **multiplicative inflation**: a tensor scalar multiplying the
  posterior anomalies, so posterior spread responds exactly linearly.

``torch.linalg.eigh`` of the (B, B) matrix checks its result on the host
on a CUDA device, so the analysis cannot sit inside a CUDA-graph
capture; the cycle keeps it eager (``assim/cycle.py``). Its
eigenvectors may differ from the reference's by sign, and by basis
within a repeated eigenvalue (dead lanes give zero rows); the analysis
itself is invariant to both.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

_EPS = 1e-30


class AnalysisDiag(NamedTuple):
    """Scalar diagnostics of one analysis: one host read takes them all
    after the update (the filter-health sentinels' inputs)."""
    spread_f: torch.Tensor     # forecast ensemble spread (masked rms)
    spread_a: torch.Tensor     # analysis ensemble spread
    innov_rms: torch.Tensor    # rms innovation over accepted channels
    consistency: torch.Tensor  # innovation chi2 / E[chi2] (~1 healthy)
    n_alive: torch.Tensor      # effective ensemble size
    n_obs: torch.Tensor        # accepted channel count


def masked_moments(ens: torch.Tensor, alive: torch.Tensor):
    """Mean and anomalies over alive lanes only.

    ens: (B, n); alive: (B,) bool. Returns (mean (n,), anom (B, n) with
    dead rows zeroed, neff scalar)."""
    w = alive.to(ens.dtype)
    neff = torch.clamp(torch.sum(w), min=1.0)
    mean = torch.sum(w[:, None] * ens, dim=0) / neff
    anom = (ens - mean[None, :]) * w[:, None]
    return mean, anom, neff


def masked_spread(ens: torch.Tensor, alive: torch.Tensor) -> torch.Tensor:
    """Scalar ensemble spread: rms of masked anomalies per alive-lane
    degree of freedom."""
    _, anom, neff = masked_moments(ens, alive)
    n = ens.shape[1]
    denom = torch.clamp(neff - 1.0, min=1.0) * n
    return torch.sqrt(torch.sum(anom * anom) / denom)


def esrf_analysis(ens: torch.Tensor, obs_ens: torch.Tensor,
                  y: torch.Tensor, r: torch.Tensor,
                  alive: torch.Tensor, obs_mask: torch.Tensor,
                  inflation: torch.Tensor
                  ) -> Tuple[torch.Tensor, AnalysisDiag]:
    """One masked ETKF square-root update.

    ens: (B, n) packed state ensemble; obs_ens: (B, m) = H(ens);
    y: (m,) observed values; r: (m,) obs-error variances;
    alive: (B,) lane mask; obs_mask: (m,) QC-accepted mask;
    inflation: scalar posterior multiplicative inflation.

    Returns (analysis ensemble (B, n) with dead lanes frozen, diag).
    """
    B = ens.shape[0]
    dt = ens.dtype
    dev = ens.device
    xbar, Zx, neff = masked_moments(ens, alive)
    ybar, Zy, _ = masked_moments(obs_ens.to(dt), alive)

    om = obs_mask.to(dt)
    r = torch.as_tensor(r, dtype=dt, device=dev)
    rinv = om / r                                   # rejected -> 0
    d = (torch.as_tensor(y, dtype=dt, device=dev) - ybar) * om   # (m,)

    # ensemble-space gain: G = (neff-1) I + Zy R^-1 Zy^T, (B, B)
    C = (Zy * rinv[None, :]) @ Zy.T
    G = (neff - 1.0) * torch.eye(B, dtype=dt, device=dev) + C
    lam, Q = torch.linalg.eigh(G)
    lam = torch.clamp(lam, min=_EPS)
    wbar = (Q / lam[None, :]) @ (Q.T @ (Zy @ (rinv * d)))   # (B,)
    # symmetric square root: Wa = sqrt(neff-1) G^{-1/2}
    Wa = (Q * torch.sqrt((neff - 1.0) / lam)[None, :]) @ Q.T  # (B, B)

    mean_shift = wbar @ Zx                          # (n,)
    anom_a = Wa @ Zx                                # (B, n)
    infl = torch.as_tensor(inflation, dtype=dt, device=dev)
    ana = xbar[None, :] + mean_shift[None, :] + infl * anom_a
    # dead lanes ride through bitwise frozen (lane-freeze idiom)
    ana = torch.where(alive[:, None], ana, ens)

    # diagnostics: innovation consistency, E[d_j^2] = HPH_jj + r_j
    m_eff = torch.clamp(torch.sum(om), min=1.0)
    hph = torch.sum(Zy * Zy, dim=0) / torch.clamp(neff - 1.0, min=1.0)
    chi2 = torch.sum(d * d * om / (hph + r + _EPS))
    diag = AnalysisDiag(
        spread_f=masked_spread(ens, alive),
        spread_a=masked_spread(ana, alive),
        innov_rms=torch.sqrt(torch.sum(d * d) / m_eff),
        consistency=chi2 / m_eff,
        n_alive=neff,
        n_obs=torch.sum(om))
    return ana, diag


# ---------------------------------------------------------------------------
# state packing: the assimilated subset of an IBState as a flat vector
# ---------------------------------------------------------------------------

def state_packer(template_state):
    """(pack, unpack, n) for the assimilated subset of an UNBATCHED
    IBState: the MAC velocity components and the pressure.

    ``pack(state) -> (n,)`` and ``unpack(state, vec) -> state``; over a
    lane-stacked fleet the cycle applies them lane by lane. Markers ride
    along un-assimilated (they are slaved to the velocity field through
    the IB coupling), and ``n_prev``/``t``/``k`` keep the lane's own
    history: the analysis moves the flow, not the clock.
    """
    from ibamr_tpu_torch.utils.tree import ravel

    subset = (template_state.ins.u, template_state.ins.p)
    flat0, unravel = ravel(subset)

    def pack(state):
        v, _ = ravel((state.ins.u, state.ins.p))
        return v

    def unpack(state, vec):
        u, p = unravel(vec.to(flat0.dtype))
        return state._replace(ins=state.ins._replace(u=tuple(u), p=p))

    return pack, unpack, int(flat0.shape[0])
