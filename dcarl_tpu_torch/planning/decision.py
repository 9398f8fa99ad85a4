"""RLSDecision, the lane-level learning decision layer, batch-first (the
JAX package's ``planning/decision.py``).

zzz_planning_decision_lane_models/learning.py:17-208 wraps a 20-D
multilane state, ships it to the DQN+RLS agent and maps the returned
discrete action 0-7 onto a (target_lane, target_speed) command.  Here
the agent is a function of the same program and every env of a batch
evaluates at once.

Action space (learning.py:156-208):
  0: rule (LaneUtility)            1: hard brake (-4 * 0.75)
  2: outside lane, keep speed      3: inside lane, keep speed
  4: outside lane, +2*0.75         5: inside lane, +2*0.75
  6: outside lane, -2*0.75         7: inside lane, -2*0.75
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcarl_tpu_torch.planning import lane_utility as LU
from dcarl_tpu_torch.planning.multilane import MultiLaneState

ACC = 2.0
DECISION_DT = 0.75
HARD_BRAKE = 4.0
NUM_ACTIONS = 8


def wrap_state(mmap: MultiLaneState) -> torch.Tensor:
    """[..., 20] RL state (learning.py:91-151): [0]=0, [1]=ego lane
    index, [2]=ego speed, [3]=ego vd, then per lane k the front vehicle
    (s, d, vs, vd) at [4+4k..] and the rear at [12+4k..]; defaults
    50/k/20/0 (front) and -50/k/0/0 (rear); a single lane fills the
    phantom second lane with lane-1 defaults."""
    dtype = mmap.ego_speed.dtype
    batch = tuple(mmap.ego_speed.shape)
    L = mmap.num_lanes
    assert L <= 2, "the reference state layout carries two lanes"
    lanes = torch.arange(L, dtype=dtype, device=mmap.ego_speed.device)

    def pad_lane(arr, default):
        if L == 2:
            return arr
        return torch.cat([arr, torch.full(batch + (2 - L,), default,
                                          dtype=dtype, device=arr.device)], -1)

    def block(v, default_s, default_vs):
        ex = v.exists
        return torch.stack([
            pad_lane(torch.where(ex, v.s, default_s), default_s),
            pad_lane(torch.where(ex, v.d, lanes), 1.0),
            pad_lane(torch.where(ex, v.vs, default_vs), default_vs),
            pad_lane(torch.where(ex, v.vd, 0.0), 0.0),
        ], dim=-1).reshape(batch + (8,))

    head = torch.stack([torch.zeros(batch, dtype=dtype,
                                    device=mmap.ego_speed.device),
                        mmap.ego_lane_index.to(dtype), mmap.ego_speed,
                        mmap.ego_vd], dim=-1)
    return torch.cat([head, block(mmap.front, 50.0, 20.0),
                      block(mmap.rear, -50.0, 0.0)], dim=-1)


class LaneDecision(NamedTuple):
    target_lane_index: torch.Tensor  # [...] i32
    target_speed: torch.Tensor       # [...]


def decision_from_discrete_action(mmap: MultiLaneState,
                                  action: torch.Tensor) -> LaneDecision:
    """get_decision_from_discrete_action (learning.py:156-208): a select
    over the 8 commands for actions [...] in [0, 8)."""
    inside = 0 if mmap.num_lanes == 1 else 1
    ego_y = torch.round(mmap.ego_lane_index).to(torch.int32)
    v = mmap.ego_speed
    rule_lane, rule_speed = LU.lateral_decision(mmap)
    out_l = torch.zeros_like(ego_y)
    in_l = torch.full_like(ego_y, inside)
    lanes = torch.stack([rule_lane, ego_y, out_l, in_l, out_l, in_l, out_l,
                         in_l], dim=-1)
    up, down = v + ACC * DECISION_DT, v - ACC * DECISION_DT
    speeds = torch.stack([rule_speed, v - HARD_BRAKE * DECISION_DT, v, v,
                          up, up, down, down], dim=-1)
    a = torch.clamp(action, 0, NUM_ACTIONS - 1).to(torch.int64)[..., None]
    return LaneDecision(
        target_lane_index=torch.gather(lanes, -1, a)[..., 0],
        target_speed=torch.gather(speeds, -1, a)[..., 0])
