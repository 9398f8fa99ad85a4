"""Multilane world model: the cognition layer's MapState, batch-first
(the JAX package's ``planning/multilane.py``).

The field stack's cognition nodes build a ``MapState``: ego state, ego
Frenet state and a multilane model with per-lane nearest front/rear
obstacles (software/src/cognition/protocol/msg/MapState.msg).  Here it is
a NamedTuple of tensors with the env batch leading every field and the
lane axis ``L`` last where a field is per lane.  The lane-level rule
policies (IDM, LaneUtility) and the RLS decision layer read it.

Lane indices count from the outside (0 = outermost); ``ego_lane_index``
is continuous between lane centers (dynamic_map.py:337-369).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class LaneVehicle(NamedTuple):
    """Nearest vehicle ahead/behind in each lane."""

    exists: torch.Tensor  # [..., L] bool
    s: torch.Tensor       # [..., L] longitudinal position (ego at s=0)
    d: torch.Tensor       # [..., L] continuous lane index of the vehicle
    vs: torch.Tensor      # [..., L] longitudinal speed
    vd: torch.Tensor      # [..., L] lateral speed


class MultiLaneState(NamedTuple):
    """The mmap: everything the lane-level policies read."""

    ego_lane_index: torch.Tensor        # [...] continuous lane index
    ego_speed: torch.Tensor             # [...] m/s
    ego_vd: torch.Tensor                # [...] lateral speed (lanes/s)
    front: LaneVehicle                  # per-lane nearest front vehicle
    rear: LaneVehicle                   # per-lane nearest rear vehicle
    speed_limit: torch.Tensor           # [..., L] m/s
    distance_to_junction: torch.Tensor  # [...] m to the multilane exit
    target_lane_index: torch.Tensor     # [...] exit lane
    traffic_light_stop: torch.Tensor    # [..., L] bool: lane must stop
    stop_distance: torch.Tensor         # [..., L] m to the stop line

    @property
    def num_lanes(self) -> int:
        return self.front.s.shape[-1]


def nearest_in_lanes(member: torch.Tensor, rel_s: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                                torch.Tensor]:
    """Per lane, the nearest member ahead (smallest ``rel_s > 0``) and
    behind (largest ``rel_s <= 0``): ``member`` [..., K, L], ``rel_s``
    [..., K].  Returns (front_idx, front_exists, rear_idx, rear_exists),
    each [..., L]; an empty lane's index is 0 (the first of the all-inf
    keys, as ``jnp.argmin`` takes it), hidden by its ``exists`` flag."""
    r = rel_s[..., None]
    front_key = torch.where(member & (r > 0), r, torch.inf)
    rear_key = torch.where(member & (r <= 0), r, -torch.inf)
    return (torch.argmin(front_key, dim=-2),
            torch.isfinite(front_key.amin(dim=-2)),
            torch.argmax(rear_key, dim=-2),
            rear_key.amax(dim=-2) > -torch.inf)


def lane_vehicles(exists, idx, s, d, vs, vd, lanes, front: bool
                  ) -> LaneVehicle:
    """The LaneVehicle of the objects at ``idx`` [..., L] (per-object
    fields [..., K]), with the reference's defaults where no vehicle
    exists: 50 / lane / 20 / 0 ahead, -50 / lane / 0 / 0 behind."""
    def at(x):
        return torch.gather(x, -1, idx)

    return LaneVehicle(
        exists=exists,
        s=torch.where(exists, at(s), 50.0 if front else -50.0),
        d=torch.where(exists, at(d), lanes),
        vs=torch.where(exists, at(vs), 20.0 if front else 0.0),
        vd=torch.where(exists, at(vd), 0.0),
    )


def locate_objects(num_lanes: int, ego_s: torch.Tensor,
                   ego_lane: torch.Tensor,
                   obj_s: torch.Tensor,      # [..., K] arc-length positions
                   obj_lane: torch.Tensor,   # [..., K] continuous lane indices
                   obj_vs: torch.Tensor,     # [..., K]
                   obj_vd: torch.Tensor,     # [..., K]
                   obj_valid: torch.Tensor,  # [..., K] bool
                   lane_dist_thres: float = 1.0,
                   ) -> Tuple[LaneVehicle, LaneVehicle]:
    """Sort tracked objects into per-lane nearest front/rear slots
    (``locate_surrounding_objects_in_lanes``, dynamic_map.py:293-334): an
    object joins the lane whose center is nearest (within
    ``lane_dist_thres`` lane units)."""
    lanes = torch.arange(num_lanes, dtype=obj_lane.dtype,
                         device=obj_lane.device)
    lane_dist = torch.abs(obj_lane[..., None] - lanes)        # [..., K, L]
    closest = torch.argmin(lane_dist, dim=-1)                 # [..., K]
    in_lane = (lane_dist.amin(dim=-1) <= lane_dist_thres) & obj_valid
    member = (closest[..., None] == torch.arange(
        num_lanes, device=obj_lane.device)) & in_lane[..., None]
    rel_s = obj_s - ego_s[..., None]
    f_idx, f_ex, r_idx, r_ex = nearest_in_lanes(member, rel_s)
    lanes_b = lanes.expand(f_idx.shape)
    return (lane_vehicles(f_ex, f_idx, rel_s, obj_lane, obj_vs, obj_vd,
                          lanes_b, True),
            lane_vehicles(r_ex, r_idx, rel_s, obj_lane, obj_vs, obj_vd,
                          lanes_b, False))
