"""Lane-stacked state pytrees for fleet (ensemble) execution (port of
``ibamr_tpu/utils/lanes.py``).

A *fleet* runs B independent scenarios of one scenario family together:
every leaf of the integrator state gains a leading lane axis. The
helpers here are the only place the lane axis convention lives:

- the lane axis is ALWAYS axis 0 of every leaf;
- every lane shares one tree structure (parameter sweeps vary values,
  not shapes);
- slicing a lane out (:func:`lane_slice`) gives a state bitwise equal
  to that lane's rows, so single-lane incident capsules and per-lane
  checkpoint restores are exact.

Where the reference ``vmap``s the step, the port's fleet chunk
(``utils/hierarchy_driver.py``) steps each live lane's slice in turn and
re-stacks, so lane k of a B-lane chunk is bitwise the same scenario run
alone: the contract the reference pins (``tests/test_fleet.py``) holds
here by construction.
"""

from __future__ import annotations

import torch

from ibamr_tpu_torch.utils.tree import leaves, tree_map


def stack_lanes(states):
    """Stack per-lane state pytrees into one lane-batched pytree (lane
    axis 0 on every leaf). All states must share one structure."""
    if not states:
        raise ValueError("stack_lanes needs at least one lane state")
    return tree_map(lambda *ls: torch.stack([torch.as_tensor(x) for x in ls]),
                    *states)


def fleet_size(state) -> int:
    """B, the lane count of a lane-stacked state."""
    ls = leaves(state)
    if not ls:
        raise ValueError("empty state pytree")
    return int(ls[0].shape[0])


def lane_slice(state, k: int):
    """Lane ``k``'s unbatched state: bitwise the rows of lane k."""
    return tree_map(lambda x: x[k], state)


def set_lane(state, k: int, lane_state):
    """Lane-stacked state with lane ``k``'s rows replaced by
    ``lane_state`` (unbatched). Other lanes' rows are copied bitwise."""
    def put(x, v):
        out = x.clone()
        out[k] = torch.as_tensor(v).to(device=x.device, dtype=x.dtype)
        return out
    return tree_map(put, state, lane_state)


def broadcast_lane(lane_state, n: int):
    """A B=n fleet of identical copies of one unbatched state."""
    return tree_map(
        lambda x: torch.as_tensor(x)[None].expand(
            (n,) + tuple(torch.as_tensor(x).shape)).clone(), lane_state)


def pad_lanes(states, n: int):
    """Lane-stack ``states`` padded to ``n`` lanes with copies of the
    LAST state; returns ``(stacked, alive)`` with ``alive`` the (n,) bool
    mask of the real lanes (padding lanes are frozen by the fleet
    chunk's alive mask, so they never influence a result)."""
    if not states:
        raise ValueError("pad_lanes needs at least one lane state")
    if len(states) > n:
        raise ValueError(
            f"pad_lanes: {len(states)} states exceed the {n}-lane bucket")
    stacked = stack_lanes(list(states) + [states[-1]] * (n - len(states)))
    alive = torch.arange(n) < len(states)
    return stacked, alive


def lane_mask_shape(mask: torch.Tensor, leaf: torch.Tensor) -> torch.Tensor:
    """A (B,) lane mask reshaped to (B, 1, ..., 1) with ``leaf``'s rank,
    for broadcasting against a lane-stacked leaf."""
    return mask.reshape((mask.shape[0],) + (1,) * (leaf.ndim - 1))
