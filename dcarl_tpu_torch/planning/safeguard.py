"""Reachable-set safeguard, batch-first (the JAX package's
``planning/safeguard.py``).

The field stack's safety layer (zzz_planning_safeguard/reachable_set.py:
28-227): every obstacle's constant-velocity reachable set (a disc growing
linearly in time) is intersected with the decision trajectory, and the
safeguard caps the commanded speed so the ego cannot reach any
intersection point before the obstacle can.  The ladder of speed scales
is a leading axis of one batch (the JAX package ``vmap``-s over it).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import torch

from dcarl_tpu_torch.ops.geometry import norm2
from dcarl_tpu_torch.ops.spline import _cumsum_blocked

# jnp.linspace(1.0, 1/8, 8), as JAX rounds it (three f32 values and four
# f64 values differ in the last place from torch.linspace and numpy's)
SCALES = {
    torch.float32: tuple(float.fromhex(h) for h in (
        "0x1p+0", "0x1.cp-1", "0x1.8p-1", "0x1.3ffffep-1", "0x1.fffffep-2",
        "0x1.8p-2", "0x1.fffff8p-3", "0x1p-3")),
    torch.float64: tuple(float.fromhex(h) for h in (
        "0x1p+0", "0x1.c000000000001p-1", "0x1.8p-1", "0x1.4p-1", "0x1p-1",
        "0x1.8000000000002p-2", "0x1.0000000000001p-2", "0x1p-3")),
}


@functools.lru_cache(maxsize=None)
def _scales(dtype: torch.dtype, device: torch.device) -> torch.Tensor:
    """The ladder on ``device``, copied there once (not every tick)."""
    return torch.tensor(SCALES[dtype], dtype=dtype, device=device)


class SafeguardConfig(NamedTuple):
    ego_radius: float = 1.5       # ego footprint radius
    obstacle_radius: float = 1.0  # obstacle footprint radius
    time_margin: float = 0.5      # s: ego must arrive this much earlier
    max_horizon: float = 5.0      # s: reachable-set horizon


def check_trajectory(traj_xy: torch.Tensor,          # [..., T, 2]
                     desired_speed: torch.Tensor,    # [..., T]
                     obstacles: torch.Tensor,        # [..., K, 5] x y vx vy yaw
                     obstacles_valid: torch.Tensor,  # [..., K]
                     cfg: SafeguardConfig = SafeguardConfig()
                     ) -> torch.Tensor:
    """[...] bool: the trajectory stays outside every obstacle's
    reachable set for the arrival times ``desired_speed`` implies
    (ReachableSet.check_trajectory).  The obstacles' leading dims
    broadcast with the trajectory's."""
    d = torch.diff(traj_xy, dim=-2)
    seg = norm2(d[..., 0], d[..., 1])                          # [..., T-1]
    v_seg = torch.clamp(desired_speed[..., :-1], min=0.1)
    arrival = _cumsum_blocked(seg / v_seg)
    arrival = torch.cat([torch.zeros_like(arrival[..., :1]), arrival],
                        dim=-1)                                # [..., T]
    ox = obstacles[..., None, :, 0]
    oy = obstacles[..., None, :, 1]
    ospeed = torch.sqrt(obstacles[..., None, :, 2] ** 2
                        + obstacles[..., None, :, 3] ** 2)
    dx = traj_xy[..., :, None, 0] - ox                         # [..., T, K]
    dy = traj_xy[..., :, None, 1] - oy
    dist = torch.sqrt(dx ** 2 + dy ** 2)
    reach_time = (dist - cfg.ego_radius - cfg.obstacle_radius) \
        / torch.clamp(ospeed, min=0.1)
    relevant = (arrival[..., :, None] <= cfg.max_horizon) \
        & obstacles_valid[..., None, :]
    conflict = relevant & (reach_time
                           <= arrival[..., :, None] + cfg.time_margin)
    return ~conflict.flatten(-2).any(-1)


def get_safeguard_speed(traj_xy: torch.Tensor, desired_speed: torch.Tensor,
                        obstacles: torch.Tensor,
                        obstacles_valid: torch.Tensor,
                        cfg: SafeguardConfig = SafeguardConfig()
                        ) -> torch.Tensor:
    """The speed cap (ReachableSet.get_safeguard_speed): the largest of
    the eight uniform speed scales 1, 7/8, ..., 1/8 whose arrival
    schedule clears every reachable set; 0 when none does."""
    scales = _scales(desired_speed.dtype, desired_speed.device)
    shape = (-1,) + (1,) * desired_speed.ndim
    safe = check_trajectory(traj_xy, desired_speed * scales.reshape(shape),
                            obstacles, obstacles_valid, cfg)   # [C, ...]
    # the first safe scale (the scales descend); argmax takes no bool
    first = torch.argmax(safe.to(torch.uint8), dim=0)
    scale = torch.where(safe.any(0), scales[first], 0.0)
    return desired_speed * scale[..., None]
