"""Constant-velocity obstacle prediction and the trajectory collision
check (the reference's ``predict`` class, Data_From_Carla/Agent/zzz/
predict.py), batch-first.

Each obstacle is rolled out at constant velocity over the planning
horizon, offset forward and backward by ``move_gap`` along its heading
(two circles per vehicle); a candidate path collides if any of its
sampled points (stride 2 from index 2, predict.py:52-59) comes within
``check_radius`` of a predicted point at the same time index.  All
candidates of all envs reduce in one broadcast: per-path masks instead
of the reference's early-return loops.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcarl_tpu_torch.config import WerlingConfig


class PredictedObstacles(NamedTuple):
    x: torch.Tensor      # [..., K, 2, T] front/back circle centres
    y: torch.Tensor      # [..., K, 2, T]
    valid: torch.Tensor  # [..., K] the obstacle exists (padded slots)


def predict_obstacles(obstacles: torch.Tensor, valid: torch.Tensor,
                      cfg: WerlingConfig = WerlingConfig()
                      ) -> PredictedObstacles:
    """``obstacles`` [..., K, 5] rows (x, y, vx, vy, yaw), rolled out at
    dt over ``arange(0, max_t, dt)`` (predict.py:87-110)."""
    n_t = int(cfg.max_t / cfg.dt)
    t = torch.arange(n_t, dtype=obstacles.dtype, device=obstacles.device) \
        * cfg.dt
    x0, y0 = obstacles[..., 0:1], obstacles[..., 1:2]
    vx, vy = obstacles[..., 2:3], obstacles[..., 3:4]
    yaw = obstacles[..., 4:5]
    xt = x0 + t * vx                                   # [..., K, T]
    yt = y0 + t * vy
    gap_x = torch.cos(yaw) * cfg.move_gap
    gap_y = torch.sin(yaw) * cfg.move_gap
    x = torch.stack([xt + gap_x, xt - gap_x], dim=-2)
    y = torch.stack([yt + gap_y, yt - gap_y], dim=-2)
    return PredictedObstacles(x=x, y=y, valid=valid)


def check_collision_free(path_x: torch.Tensor, path_y: torch.Tensor,
                         pred: PredictedObstacles,
                         cfg: WerlingConfig = WerlingConfig()) -> torch.Tensor:
    """Candidate paths [..., P, T] against obstacles predicted per env
    (fields [..., K, 2, T'], the same leading dims) -> [..., P] bool,
    True where the path clears every circle (``check_collision`` returns
    True for "safe", predict.py:21-60).  The checked indices are the
    reference's: 2, 4, ... below ``min(T, T') - 1``."""
    n_path_t = path_x.shape[-1]
    n_pred_t = pred.x.shape[-1]
    len_predict = min(n_path_t - 1, n_pred_t - 1)
    idx = torch.arange(2, len_predict, 2, device=path_x.device)
    px = path_x[..., idx][..., :, None, None, :]       # [..., P, 1, 1, S]
    py = path_y[..., idx][..., :, None, None, :]
    ox = pred.x[..., idx][..., None, :, :, :]          # [..., 1, K, 2, S]
    oy = pred.y[..., idx][..., None, :, :, :]
    d2 = (ox - px) ** 2 + (oy - py) ** 2
    hit = (d2 <= cfg.robot_radius ** 2) & pred.valid[..., None, :, None, None]
    return ~hit.flatten(-3).any(dim=-1)
