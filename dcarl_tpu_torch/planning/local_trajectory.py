"""Lane-level local trajectory: keep-lane windows and hermite lane change,
batch-first (the JAX package's ``planning/local_trajectory.py``).

The reference's ``PolylineTrajectory`` (zzz_planning_decision_lane_models/
local_trajectory.py:13-112) turns the lateral decision (target lane,
desired speed) into a path for the controller:

- ego within ``RECTIFY_THRES`` of the target centerline -> the dense
  centerline window ahead of the ego, ``v * TIME_AHEAD + DIST_AHEAD``
  long (:28-43);
- otherwise -> a cubic hermite blend from the ego pose to a point
  ``max(rectify_dt * v, 6 m)`` down the target centerline, then the
  centerline's continuation (:48-89, :91-112).

Every output is ``[..., n_out, 2]``: points past the horizon repeat the
last valid one, and the keep/change branch is a select.  Each env may
bring its own centerline ([..., N, 2]) or share one ([N, 2]).
"""

from __future__ import annotations

import functools
from typing import NamedTuple

import numpy as np
import torch

from dcarl_tpu_torch.ops import geometry as geo

HERMITE_PTS = 20      # reference hermite resolution (:91)
RECTIFY_THRES = 2.0   # m (:15)
TIME_AHEAD = 5.0      # s (:15)
DIST_AHEAD = 10.0     # m (:15)
LC_DT = 1.5           # s per lane of lateral offset (:16)
LC_V = 2.67           # m/s fallback rectify speed (:16)
RECTIFY_MIN_D = 6.0   # m minimum lane-change distance (:48)


class LocalTrajectory(NamedTuple):
    """DecisionTrajectory analog: fixed-shape path and desired speed."""

    points: torch.Tensor         # [..., n_out, 2]
    desired_speed: torch.Tensor  # [...]
    lane_change: torch.Tensor    # [...] bool: hermite blend active


@functools.lru_cache(maxsize=None)
def _unit_grid(n: int, dtype: torch.dtype, device: torch.device
               ) -> torch.Tensor:
    """``jnp.linspace(0, 1, n)`` on ``device``, copied there once."""
    return torch.as_tensor(np.linspace(0.0, 1.0, n), dtype=dtype,
                           device=device)


def cubic_hermite(p0, p1, m0, m1, n: int = HERMITE_PTS) -> torch.Tensor:
    """[..., n, 2] cubic hermite curves (basis of
    local_trajectory.py:91-112) between points [..., 2] with tangents
    [..., 2].  ``jnp.linspace(0, 1, 20)`` rounds as numpy's does (a
    fused multiply-add in XLA; other counts may differ); the cube is
    ``t * (t * t)``, as XLA expands ``t ** 3``."""
    t = _unit_grid(n, p0.dtype, p0.device)[:, None]
    t2 = t * t
    t3 = t * t2
    h00 = 2 * t3 - 3 * t2 + 1
    h10 = t3 - 2 * t2 + t
    h01 = -2 * t3 + 3 * t2
    h11 = t3 - t2
    return (h00 * p0[..., None, :] + h10 * m0[..., None, :]
            + h01 * p1[..., None, :] + h11 * m1[..., None, :])


def _window(line: torch.Tensor, start_idx: torch.Tensor, n_out: int,
            max_idx: torch.Tensor) -> torch.Tensor:
    """``n_out`` consecutive points from ``start_idx``, the index clamped
    into [0, max_idx] so out-of-horizon points repeat the last one."""
    idx = start_idx[..., None] + torch.arange(n_out, device=line.device)
    idx = torch.minimum(torch.clamp(idx, min=0), max_idx[..., None])
    lines = line.expand(*idx.shape[:-1], *line.shape[-2:])
    return torch.gather(lines, -2, idx[..., None].expand(*idx.shape, 2))


def get_trajectory(dense_center: torch.Tensor,  # [..., N, 2] (uniform res)
                   ego_x, ego_y, ego_yaw, desired_speed, ego_lane_index,
                   target_lane_index,           # -1 => reference-path follow
                   res: float = 0.5, n_out: int = 64) -> LocalTrajectory:
    """Fixed-shape ``PolylineTrajectory.get_trajectory``: the caller
    passes the target lane's centerline (or the junction reference path
    for index -1); the keep/change policy and geometry follow
    local_trajectory.py."""
    dt, dev = dense_center.dtype, dense_center.device

    def t(x):
        return torch.as_tensor(x, dtype=dt, device=dev)

    desired_speed, ego_lane_index = t(desired_speed), t(ego_lane_index)
    target_lane_index, ego_yaw = t(target_lane_index), t(ego_yaw)
    ex, ey = torch.broadcast_tensors(t(ego_x), t(ego_y))
    p_ego = torch.stack([ex, ey], dim=-1)
    n = dense_center.shape[-2]
    proj = geo.project_points_to_lines(p_ego, dense_center)
    nearest_idx = proj.closest_idx
    nearest_dis = torch.abs(proj.distance)

    ahead_pts = ((desired_speed * TIME_AHEAD + DIST_AHEAD) / res
                 ).to(torch.int32)
    horizon = torch.clamp(nearest_idx + ahead_pts, max=n - 1)

    # keep-lane branch: centerline window ahead of ego (:39-43)
    keep = _window(dense_center, nearest_idx, n_out, horizon)

    # lane-change branch (:48-89)
    rectify_dt = torch.where(
        target_lane_index >= 0,
        torch.abs(ego_lane_index - target_lane_index) * LC_DT,
        nearest_dis / LC_V)
    lc_dis = torch.clamp(rectify_dt * desired_speed, min=RECTIFY_MIN_D)
    end_idx = torch.clamp(nearest_idx + (lc_dis / res).to(torch.int32),
                          0, n - 1)
    p_end = geo.gather_rows(dense_center, end_idx)
    # end tangent from the centerline segment at the end point
    nxt = torch.clamp(end_idx + 1, 0, n - 1)
    tangent_end = geo.gather_rows(dense_center, nxt) \
        - geo.gather_rows(dense_center, torch.clamp(nxt - 1, min=0))
    tangent_end = tangent_end / torch.clamp(
        geo.norm2(tangent_end[..., 0], tangent_end[..., 1]), min=1e-6)[..., None]
    tangent_start = torch.stack([torch.cos(ego_yaw), torch.sin(ego_yaw)], -1)
    # tangent magnitude ~ segment length keeps curvature sane
    d_end = p_end - p_ego
    scale = torch.clamp(geo.norm2(d_end[..., 0], d_end[..., 1]),
                        min=1e-3)[..., None]
    lc_path = cubic_hermite(p_ego, p_end, tangent_start * scale,
                            tangent_end * scale)
    cont = _window(dense_center, end_idx, n_out - HERMITE_PTS, horizon)
    change = torch.cat([lc_path, cont], dim=-2)

    do_change = nearest_dis > RECTIFY_THRES
    points = torch.where(do_change[..., None, None], change, keep)
    return LocalTrajectory(points=points, desired_speed=desired_speed,
                           lane_change=do_change)
