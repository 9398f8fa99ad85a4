"""Longitudinal PID and lateral pure-pursuit control, batch-first (the
JAX package's ``control/controller.py``; the reference's
Data_From_Carla/Agent/zzz/controller.py).

Speed PID with K_P = 0.25/3.6 on the km/h error (K_I = K_D = 0, full
brake when the target speed is zero; :26-90) and pure pursuit with a
speed-scaled lookahead and wheelbase lf + lr = 1.2 + 1.95 (:92-199).
The gains that would carry state are zero, so both are stateless and
take every env of a batch at once: scalars [..], trajectories
[.., T, 2].
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcarl_tpu_torch.ops.geometry import interp, norm2

PID_KP = 0.25 / 3.6
LF = 1.2
LR = 1.95
LWB = LF + LR


class ControlAction(NamedTuple):
    acc: torch.Tensor       # [-1, 1] throttle/brake split
    steering: torch.Tensor  # front-wheel angle [rad]


def longitudinal_pid(target_speed, current_speed) -> torch.Tensor:
    """_pid_control (controller.py:53-90): P-only on the km/h error; a
    hard brake when commanded to stop."""
    target_speed = torch.as_tensor(target_speed)
    e_kmh = (target_speed - current_speed) * 3.6
    u = torch.clamp(PID_KP * e_kmh, -1.0, 1.0)
    return torch.where(target_speed == 0, -1.0, u)


def _lookahead_distance(v):
    """Speed-scaled lookahead (controller.py:105-117)."""
    dt = torch.where(v > 10.0, 0.5 - (v - 10.0) * 0.01, 0.5)
    return torch.clamp(dt * v, min=3.0)


def pure_pursuit(ego_x, ego_y, ego_yaw, ego_v,
                 trajectory_xy: torch.Tensor) -> torch.Tensor:
    """PurePuesuitController.run_step (controller.py:97-186): the
    lookahead point on each trajectory, then the pure-pursuit steering
    law about the rear axle.  The lookahead point is interpolated exactly
    on the trajectory's polyline (``jnp.interp`` on its arc lengths), as
    the JAX package does instead of the reference's 0.1 m resample."""
    like = trajectory_xy
    ego_x, ego_y, ego_yaw, ego_v = (
        torch.as_tensor(a, dtype=like.dtype, device=like.device)
        for a in (ego_x, ego_y, ego_yaw, ego_v))
    tx, ty = trajectory_xy[..., 0], trajectory_xy[..., 1]   # [.., T]
    d2 = (tx - ego_x[..., None]) ** 2 + (ty - ego_y[..., None]) ** 2
    start_idx = torch.argmin(d2, dim=-1)
    sx, sy = torch.diff(tx, dim=-1), torch.diff(ty, dim=-1)
    seg = norm2(sx, sy)                                    # [.., T-1]
    # cumulative arc length, one add after another (XLA's CPU cumsum over
    # one 16-element block)
    acc = torch.zeros_like(seg[..., 0])
    cum = [acc]
    for i in range(seg.shape[-1]):
        acc = acc + seg[..., i]
        cum.append(acc)
    cum = torch.stack(cum, dim=-1)                         # [.., T]
    cum_start = torch.gather(cum, -1, start_idx[..., None])[..., 0]
    target_s = (cum_start + _lookahead_distance(ego_v))[..., None]
    wp_x = interp(target_s, cum, tx)[..., 0]
    wp_y = interp(target_s, cum, ty)[..., 0]

    v0, v1 = torch.cos(ego_yaw), torch.sin(ego_yaw)
    w0, w1 = wp_x - ego_x, wp_y - ego_y
    w_norm = torch.clamp(norm2(w0, w1), min=1e-9)
    cos_a = torch.clamp((w0 * v0 + w1 * v1) / w_norm, -1.0, 1.0)
    alpha = torch.arccos(cos_a)
    cross_z = v0 * w1 - v1 * w0
    alpha = torch.where(cross_z < 0, -alpha, alpha)

    rx, ry = wp_x - (ego_x - v0 * LR), wp_y - (ego_y - v1 * LR)
    l = torch.clamp(norm2(rx, ry), min=1e-6)
    return torch.arctan(2.0 * torch.sin(alpha) * LWB / l)


def get_control(ego_x, ego_y, ego_yaw, ego_v, trajectory_xy: torch.Tensor,
                desired_speed: torch.Tensor) -> ControlAction:
    """Controller.get_control (controller.py:17-24): PID on the
    trajectory's final desired speed, pure-pursuit steering."""
    acc = longitudinal_pid(desired_speed[..., -1], ego_v)
    steer = pure_pursuit(ego_x, ego_y, ego_yaw, ego_v, trajectory_xy)
    return ControlAction(acc=acc, steering=steer)
