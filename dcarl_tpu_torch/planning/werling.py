"""Batched Werling (Frenet-lattice) trajectory planner, batch-first (the
JAX package's ``planning/werling.py``; the reference's
JunctionTrajectoryPlanner, Data_From_Carla/Agent/zzz/).

The lattice is static-shaped: [n_d lateral offsets] x [n_v target
speeds] boundary-value polynomials solved in closed form
(``ops/polynomial.py``), evaluated on a shared time grid and carried to
the global frame through the reference path's cubic spline.  The
reference's list filtering (``check_paths``) and sorted early-exit
collision scan (``get_optimal_trajectory``) become boolean masks and a
masked first-minimum ``argmin``.  Every function takes the envs' batch
dims in front: a start state [..] gives a lattice [.., P, T].

Candidate indexing is the reference action space: index 0 is the brake
trajectory, index i >= 1 lattice path i-1 in enumeration order (d-major,
then target speed), JunctionTrajectoryPlanner.py:113-130.
"""

from __future__ import annotations

import functools
import math
from typing import NamedTuple, Tuple

import torch

from dcarl_tpu_torch.config import WerlingConfig
from dcarl_tpu_torch.ops import polynomial as poly
from dcarl_tpu_torch.ops import spline as spl
from dcarl_tpu_torch.ops.geometry import cartesian_to_frenet
from dcarl_tpu_torch.planning.predictor import (PredictedObstacles,
                                                check_collision_free,
                                                predict_obstacles)


class FrenetStart(NamedTuple):
    """Planner start state (calculate_start_state,
    JunctionTrajectoryPlanner.py:253-283), one entry per env."""

    s0: torch.Tensor
    c_d: torch.Tensor
    c_d_d: torch.Tensor
    c_d_dd: torch.Tensor
    c_speed: torch.Tensor


def start_state_from_ego(ego_x, ego_y, ego_vx, ego_vy, ego_yaw,
                         ref_line: torch.Tensor) -> FrenetStart:
    """Project the ego poses onto the dense reference polyline; the
    reference flips the lateral sign (c_d = -ffstate.d, :279-281)."""
    f = cartesian_to_frenet(ego_x, ego_y, ego_vx, ego_vy, ego_yaw, ref_line)
    v = torch.sqrt(ego_vx ** 2 + ego_vy ** 2)
    return FrenetStart(s0=f.s, c_d=-f.d, c_d_d=f.vd,
                       c_d_dd=torch.zeros_like(f.s), c_speed=v)


class Lattice(NamedTuple):
    """All candidate trajectories of one planning tick."""

    d: torch.Tensor          # [.., P, T] lateral offset
    s: torch.Tensor          # [.., P, T] longitudinal position
    s_d: torch.Tensor        # [.., P, T] longitudinal speed
    x: torch.Tensor          # [.., P, T] global
    y: torch.Tensor          # [.., P, T]
    yaw: torch.Tensor        # [.., P, T]
    curvature: torch.Tensor  # [.., P, T-1]
    cf: torch.Tensor         # [.., P] total cost
    feasible: torch.Tensor   # [.., P] speed / accel / curvature limits hold


def _sum_time(v: torch.Tensor) -> torch.Tensor:
    """Sum over the last (time) dim, one step after another: the order
    of the reference's reduction, whatever the memory layout."""
    acc = v[..., 0]
    for i in range(1, v.shape[-1]):
        acc = acc + v[..., i]
    return acc


@functools.lru_cache(maxsize=None)
def _grid(cfg: WerlingConfig, dtype: torch.dtype, device: torch.device):
    """(d offsets [n_d], target speeds [n_v], time grid [T]) of one planner
    config, made on ``device`` once: a host-to-device copy on every tick
    would stall the card."""
    return (torch.tensor(cfg.d_offsets, dtype=dtype, device=device),
            torch.tensor(cfg.target_speeds, dtype=dtype, device=device),
            torch.arange(cfg.n_time_steps, dtype=dtype, device=device)
            * cfg.dt)


def plan(rp: spl.RefPath, start: FrenetStart,
         cfg: WerlingConfig = WerlingConfig()) -> Lattice:
    """The full candidate lattice of every env (calc_frenet_paths +
    calc_global_paths + check_paths)."""
    horizons = cfg.horizons
    if len(horizons) != 1:
        raise NotImplementedError(
            "multiple horizons need per-path time masks; the reference "
            "grid (4.0..4.2 step 0.3) has exactly one")
    ti = horizons[0]
    n_t = cfg.n_time_steps
    s0 = start.s0
    dtype, device = s0.dtype, s0.device
    d_offsets, tvs, t = _grid(cfg, dtype, device)
    n_d, n_v = d_offsets.shape[0], tvs.shape[0]

    def col(a):
        return a[..., None]

    # lateral quintics, one per d offset: coefficients [.., n_d, 1]
    lat = poly.solve_quintic(col(start.c_d), col(start.c_d_d),
                             col(start.c_d_dd), d_offsets, 0.0, 0.0, ti)
    lat = poly.QuinticCoeffs(*(col(torch.broadcast_to(
        torch.as_tensor(a, dtype=dtype, device=device),
        s0.shape + (n_d,))) for a in lat))
    d = poly.quintic_eval(lat, t)                     # [.., n_d, T]
    d_ddd = poly.quintic_d3(lat, t)

    # longitudinal quartics, one per target speed: [.., n_v, 1]
    lon = poly.solve_quartic(col(s0), col(start.c_speed), 0.0, tvs, 0.0, ti)
    lon = poly.QuarticCoeffs(*(col(torch.broadcast_to(
        torch.as_tensor(a, dtype=dtype, device=device),
        s0.shape + (n_v,))) for a in lon))
    s = poly.quartic_eval(lon, t)                     # [.., n_v, T]
    s_d = poly.quartic_d1(lon, t)
    s_dd = poly.quartic_d2(lon, t)
    s_ddd = poly.quartic_d3(lon, t)

    # costs (JunctionTrajectoryPlanner.py:322-331)
    jp = _sum_time(d_ddd ** 2)                        # [.., n_d]
    js = _sum_time(s_ddd ** 2)                        # [.., n_v]
    ds_cost = (cfg.target_speed - s_d[..., -1]) ** 2
    cd = cfg.kj * jp + cfg.kt * ti + cfg.kd * d[..., -1] ** 2
    cv = cfg.kj * js + cfg.kt * ti + cfg.kd * ds_cost
    cf = (cfg.klat * cd[..., :, None] + cfg.klon * cv[..., None, :]).flatten(-2)

    # global conversion (calc_global_paths :342-365): the spline runs on
    # the [.., n_v, T] longitudinal grid, which the n_d offsets share
    ix, iy, idx, idy = spl.refpath_pos_tangent(rp, s)
    iyaw = torch.atan2(idy, idx)
    half_pi = math.pi / 2.0
    cos_n = torch.cos(iyaw + half_pi)[..., None, :, :]   # [.., 1, n_v, T]
    sin_n = torch.sin(iyaw + half_pi)[..., None, :, :]
    d4 = d[..., :, None, :]                              # [.., n_d, 1, T]
    x = (ix[..., None, :, :] + d4 * cos_n).flatten(-3, -2)   # [.., P, T]
    y = (iy[..., None, :, :] + d4 * sin_n).flatten(-3, -2)

    full = s0.shape + (n_d, n_v, n_t)
    d_full = d4.expand(full).flatten(-3, -2)
    s_full = s[..., None, :, :].expand(full).flatten(-3, -2)
    s_d_full = s_d[..., None, :, :].expand(full).flatten(-3, -2)
    s_dd_full = s_dd[..., None, :, :].expand(full).flatten(-3, -2)

    dx = torch.diff(x, dim=-1)
    dy = torch.diff(y, dim=-1)
    yaw_seg = torch.atan2(dy, dx)                      # [.., P, T-1]
    yaw = torch.cat([yaw_seg, yaw_seg[..., -1:]], dim=-1)
    ds_seg = torch.sqrt(dx ** 2 + dy ** 2)
    ds_seg = torch.where(ds_seg < 1e-5, 0.1, ds_seg)   # carla-bug guard (:369)
    curv = torch.diff(yaw, dim=-1) / ds_seg

    feasible = (~torch.any(s_d_full > cfg.max_speed, dim=-1)
                & ~torch.any(torch.abs(s_dd_full) > cfg.max_accel, dim=-1)
                & ~torch.any(torch.abs(curv) > cfg.max_curvature, dim=-1))
    return Lattice(d=d_full, s=s_full, s_d=s_d_full, x=x, y=y, yaw=yaw,
                   curvature=curv, cf=cf, feasible=feasible)


def rule_trajectory_index(lattice: Lattice, pred: PredictedObstacles,
                          cfg: WerlingConfig = WerlingConfig()
                          ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The rule policy's pick (get_optimal_trajectory :123-130): the
    cheapest feasible, collision-free candidate as index + 1, or 0
    (brake) when none qualifies.  Returns (index [..] i64,
    collision_free [.., P])."""
    free = check_collision_free(lattice.x, lattice.y, pred, cfg)
    ok = lattice.feasible & free
    masked_cost = torch.where(ok, lattice.cf, torch.inf)
    best = torch.argmin(masked_cost, dim=-1)
    index = torch.where(torch.any(ok, dim=-1), best + 1, 0)
    return index, free


class Trajectory(NamedTuple):
    """The executable trajectory (TrajectoryAction)."""

    xy: torch.Tensor             # [.., T, 2]
    desired_speed: torch.Tensor  # [.., T]


def path_rows(a: torch.Tensor, p: torch.Tensor) -> torch.Tensor:
    """Row ``p`` [..] of ``a`` [.., P, T] -> [.., T]."""
    return torch.gather(a, -2, p[..., None, None].expand(
        p.shape + (1, a.shape[-1])))[..., 0, :]


def trajectory_by_index(lattice: Lattice, index: torch.Tensor) -> Trajectory:
    """Candidate lookup (get_trajectory_by_index :132-141): index 0 is the
    brake trajectory, the cheapest path with its desired speed zeroed
    (get_backup_trajectory :143-152); index i >= 1 is lattice path i-1."""
    index = torch.as_tensor(index, device=lattice.cf.device).to(torch.int64)
    brake_path = torch.argmin(lattice.cf, dim=-1)
    p = torch.where(index == 0, brake_path, index - 1)
    xy = torch.stack([path_rows(lattice.x, p), path_rows(lattice.y, p)],
                     dim=-1)
    s_d = path_rows(lattice.s_d, p)
    speed = torch.where((index == 0)[..., None], torch.zeros_like(s_d), s_d)
    return Trajectory(xy=xy, desired_speed=speed)


class PlanOutput(NamedTuple):
    lattice: Lattice
    rule_index: torch.Tensor     # [..] i64
    collision_free: torch.Tensor  # [.., P]


def plan_with_rule(rp: spl.RefPath, ref_line: torch.Tensor,
                   ego: torch.Tensor,              # [.., 5] x, y, vx, vy, yaw
                   obstacles: torch.Tensor,        # [.., K, 5]
                   obstacles_valid: torch.Tensor,  # [.., K]
                   cfg: WerlingConfig = WerlingConfig()) -> PlanOutput:
    """One planning tick: start state -> lattice -> rule pick (the
    trajectory_update pipeline :90-101, without cross-tick state)."""
    start = start_state_from_ego(ego[..., 0], ego[..., 1], ego[..., 2],
                                 ego[..., 3], ego[..., 4], ref_line)
    lattice = plan(rp, start, cfg)
    pred = predict_obstacles(obstacles, obstacles_valid, cfg)
    index, free = rule_trajectory_index(lattice, pred, cfg)
    return PlanOutput(lattice=lattice, rule_index=index, collision_free=free)
