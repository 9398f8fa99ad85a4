"""LaneUtility, the field stack's rule-based lateral policy, batch-first
(the JAX package's ``planning/lane_utility.py``).

zzz_planning_decision_lane_models/lateral.py:9-155: utility = 1.5 *
available speed + exit-proximity bonus; a lane change is admissible only
when the target lane's front/rear gaps satisfy ``gap > max(10 + 3*dv,
20)``; the current lane gets a +0.5 hysteresis bonus; the junction tail
speed caps the longitudinal command (lateral.py:129-148).
``torch.round`` rounds half to even, as ``jnp.round`` does.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcarl_tpu_torch.planning import idm
from dcarl_tpu_torch.planning.multilane import MultiLaneState

CHANGE_LANE_THRES = 0.5


def lane_utility(mmap: MultiLaneState, lane_index: torch.Tensor
                 ) -> torch.Tensor:
    """utility(lane) = 1.5*v_avail + 1/(|exit-lane|+1) * max(0, 200-d) * 0.1
    (lateral.py:101-108)."""
    speed = idm.longitudinal_speed(mmap, lane_index)
    exit_gap = torch.abs(mmap.target_lane_index
                         - lane_index.to(mmap.ego_speed.dtype))
    bonus = 1.0 / (exit_gap + 1.0) * torch.clamp(
        200.0 - mmap.distance_to_junction, min=0.0) * 0.1
    return speed * 1.5 + bonus


def lane_change_safe(mmap: MultiLaneState, target_index: torch.Tensor
                     ) -> torch.Tensor:
    """Gap acceptance (lateral.py:110-127): front gap > max(10 + 3*(v_ego -
    v_front), 20), rear gap > max(10 + 3*(v_rear - v_ego), 20); lanes off
    the road are unsafe."""
    num_lanes = mmap.num_lanes
    in_range = (target_index >= 0) & (target_index <= num_lanes - 1)
    idx = torch.clamp(target_index, 0, num_lanes - 1)

    def take(x):
        return idm.take_lane(x, idx)

    ego_v = mmap.ego_speed
    front_safe = ~take(mmap.front.exists) | (
        torch.abs(take(mmap.front.s))
        > torch.clamp(10.0 + 3.0 * (ego_v - take(mmap.front.vs)), min=20.0))
    rear_safe = ~take(mmap.rear.exists) | (
        torch.abs(take(mmap.rear.s))
        > torch.clamp(10.0 + 3.0 * (take(mmap.rear.vs) - ego_v), min=20.0))
    return in_range & front_safe & rear_safe


def generate_lane_change_index(mmap: MultiLaneState) -> torch.Tensor:
    """lateral.py:77-99: current / left / right utilities with the +0.5
    keep-lane bonus; an unsafe change scores -1.  [...] i32."""
    ego_idx = torch.round(mmap.ego_lane_index).to(torch.int32)
    current = lane_utility(mmap, ego_idx) + CHANGE_LANE_THRES
    left_u = torch.where(lane_change_safe(mmap, ego_idx + 1),
                         lane_utility(mmap, ego_idx + 1), -1.0)
    right_u = torch.where(lane_change_safe(mmap, ego_idx - 1),
                          lane_utility(mmap, ego_idx - 1), -1.0)
    pick_right = (right_u > current) & (right_u >= left_u)
    pick_left = (left_u > current) & (left_u > right_u)
    return torch.where(pick_right, ego_idx - 1,
                       torch.where(pick_left, ego_idx + 1, ego_idx))


def tail_speed(mmap: MultiLaneState) -> torch.Tensor:
    """Junction-approach speed cap (lateral.py:129-148)."""
    d = mmap.distance_to_junction
    available = torch.sqrt(torch.clamp(2.0 * 0.4 * d, min=0.0))
    ego_v = mmap.ego_speed
    capped = ego_v - (ego_v - available) * 5.0 * 0.4
    speed = torch.where(available > ego_v, 10000.0, capped)
    return torch.where(d <= 0.0, 0.0, speed)


def lateral_decision(mmap: MultiLaneState
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    """LaneUtility.lateral_decision (lateral.py:62-75): (target_lane i32,
    target_speed) with the junction tail-speed cap."""
    target_index = generate_lane_change_index(mmap)
    target_speed = idm.longitudinal_speed(mmap, target_index,
                                          traffic_light=True)
    return target_index, torch.minimum(target_speed, tail_speed(mmap))
