"""IDM longitudinal rule policy, batch-first (the JAX package's
``planning/idm.py``).

The field stack's Intelligent Driver Model
(zzz_planning_decision_lane_models/longitudinal.py:9-138): its constants
(T=3.6, g0=19, a=2.73, b=6.65, delta=4, dt=0.2), the low-speed
acceleration boost, the neighbor-lane cut-in response and the
traffic-light stop rule, for every lane of every env at once.

XLA lowers an integer power ``x ** 4`` to ``(x*x)*(x*x)``; ``torch.pow``
rounds otherwise, so :func:`pow4` writes the two squares out.
"""

from __future__ import annotations

import math

import torch

from dcarl_tpu_torch.planning.multilane import MultiLaneState

T_HEADWAY = 3.6
G0 = 7.0 + 12.0
A_MAX = 2.73
B_COMF = 1.65 + 5.0
DELTA = 4          # the exponent pow4 writes out
DECISION_DT = 0.2


def pow4(x: torch.Tensor) -> torch.Tensor:
    """``x ** 4`` as XLA computes it: the square of the square."""
    sq = x * x
    return sq * sq


def take_lane(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """``x[..., idx]`` of a per-lane field [..., L] at lane ``idx`` [...]."""
    return torch.gather(x, -1, idx[..., None].to(torch.int64))[..., 0]


def idm_speed_in_lane(ego_speed: torch.Tensor,     # [...]
                      speed_limit: torch.Tensor,   # [..., L] m/s
                      front_exists: torch.Tensor,  # [..., L]
                      front_gap: torch.Tensor,     # [..., L] m
                      front_speed: torch.Tensor,   # [..., L] m/s
                      ) -> torch.Tensor:
    """IDM_speed_in_lane (longitudinal.py:63-99) for every lane:
    v' = max(0, v + a_idm * dt)."""
    v = ego_speed[..., None]
    v0 = torch.clamp(speed_limit, min=1e-3)
    a = torch.where(v < 5.0, A_MAX + (5.0 - v) / 5.0 * 2.0, A_MAX)
    dv = torch.where(front_exists, v - front_speed, 0.0)
    g = torch.where(front_exists, torch.clamp(front_gap, min=1e-3), 50.0)
    g1 = torch.where(
        front_exists,
        G0 + T_HEADWAY * v + v * dv / (2.0 * torch.sqrt(a * B_COMF)), 0.0)
    r = g1 / g
    acc = a * (1.0 - pow4(v / v0) - r * r)
    return torch.clamp(v + acc * DECISION_DT, min=0.0)


def traffic_light_speed(ego_speed: torch.Tensor,
                        must_stop: torch.Tensor,      # [..., L] bool
                        stop_distance: torch.Tensor,  # [..., L]
                        ) -> torch.Tensor:
    """traffic_light_speed (longitudinal.py:102-113): 0 when the stop
    line is within the braking envelope, inf otherwise."""
    v = ego_speed[..., None]
    braking = 10.0 + v * v / 2.0 / 2.0
    return torch.where(must_stop & (stop_distance < braking), 0.0, math.inf)


def cutting_in(neighbor_front_d, neighbor_exists, neighbor_idx, ego_idx):
    """neighbor_vehicle_is_cutting_in (longitudinal.py:116-132): the
    neighbor lane's front vehicle is laterally between the two lane
    centers."""
    between = (neighbor_idx - neighbor_front_d) \
        * (ego_idx - neighbor_front_d) < 0
    return neighbor_exists & between


def longitudinal_speed(mmap: MultiLaneState, target_lane_index: torch.Tensor,
                       traffic_light: bool = False) -> torch.Tensor:
    """IDM.longitudinal_speed (longitudinal.py:22-61): the lane's IDM
    speed, min-ed with neighbor-lane IDM speeds where their front
    vehicles cut in, and with the traffic-light rule; 0 for a target
    lane off the road."""
    num_lanes = mmap.num_lanes
    per_lane = idm_speed_in_lane(mmap.ego_speed, mmap.speed_limit,
                                 mmap.front.exists, torch.abs(mmap.front.s),
                                 mmap.front.vs)               # [..., L]
    idx = torch.clamp(target_lane_index.to(torch.int32), 0, num_lanes - 1)
    speed = take_lane(per_lane, idx)
    idx_f = idx.to(per_lane.dtype)
    # neighbor cut-in response (left = idx+1, right = idx-1)
    for delta in (1, -1):
        n_idx = idx + delta
        valid = (n_idx >= 0) & (n_idx < num_lanes)
        n_idx_c = torch.clamp(n_idx, 0, num_lanes - 1)
        cut = cutting_in(take_lane(mmap.front.d, n_idx_c),
                         take_lane(mmap.front.exists, n_idx_c),
                         n_idx_c.to(per_lane.dtype), idx_f) & valid
        speed = torch.where(cut, torch.minimum(
            speed, take_lane(per_lane, n_idx_c)), speed)
    if traffic_light:
        tl = traffic_light_speed(mmap.ego_speed, mmap.traffic_light_stop,
                                 mmap.stop_distance)
        speed = torch.minimum(speed, take_lane(tl, idx))
    # out-of-range target lane -> 0 (longitudinal.py:26-28)
    in_range = (target_lane_index >= 0) \
        & (target_lane_index <= num_lanes - 1)
    return torch.where(in_range, speed, 0.0)
