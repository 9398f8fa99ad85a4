"""Lane-major (batch-last) drivers: the rule driver and the
confidence-gated deployment driver.

Each tick: read the world-frame observation, project the ego onto the
reference path, plan the Werling lattice, drop colliding paths, pick the
rule path; the gated driver then queries the confidence store for every
candidate action of every env, runs the Welch z-test gate and follows
the winning candidate; pure-pursuit/PID control drives the env step.

The port keeps the JAX package's layouts at its functions: per-env
scalars ``[B]``, per-(path, time) data ``[P, T, B]``.  Where the JAX code
looks a table up with a one-hot matmul or masked accumulate (fast on a
TPU's matrix unit), the port gathers by index, which gives the same bits
and keeps TF32 out of the picture.  ``jit`` over ``scan`` becomes one
captured CUDA graph of a tick, replayed once a tick, on a CUDA device
(``utils/graphs.py``; on the CPU and over a mesh, the eager loop, which
is also its reference); PRNG keys become a ``torch.Generator`` that
draws the auto-reset jitter.
"""

from __future__ import annotations

import functools
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import EnvConfig, StoreConfig, WerlingConfig
from dcarl_tpu_torch.control.controller import LR, LWB, PID_KP
from dcarl_tpu_torch.core import rls as RLSmod
from dcarl_tpu_torch.core.store import (FIELD_HALF_WIDTHS, _raw_moments,
                                        moments_to_stats)
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.env import driving_env as de
from dcarl_tpu_torch.env.scenario import Scenario
from dcarl_tpu_torch.ops import polynomial as poly
from dcarl_tpu_torch.ops import store_kernels
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel.mesh import ProcessMesh
from dcarl_tpu_torch.utils import graphs, profiling


_NP_DTYPE = {torch.float32: np.float32, torch.float64: np.float64}


# ---------------------------------------------------------------------------
# Static reference-path tables (host-side, built once per driver)
# ---------------------------------------------------------------------------


class RefTables(NamedTuple):
    """Per-vertex / per-segment constants of the reference polyline and
    its arc-length cubic spline: host float64 arrays from
    :func:`build_ref_tables`, or their device copies in the working
    dtype from :func:`tables_to`."""

    line: "np.ndarray | torch.Tensor"    # [N, 2] polyline vertices
    cum: "np.ndarray | torch.Tensor"     # [N] cumulative chord length
    gather: "np.ndarray | torch.Tensor"  # [G, N] vertex-indexed rows
    knots: "np.ndarray | torch.Tensor"   # [M] spline knots (chordal s)
    seg: "np.ndarray | torch.Tensor"     # [M-1, 8] (ax,bx,cx,dx, ay,by,cy,dy)


_G_ROWS = 19  # rows of the projection gather table (see _build_tables)


def build_ref_tables(ref_line: np.ndarray, dtype=torch.float32) -> RefTables:
    """Host-side table build: the reference-path spline is fitted in
    ``dtype`` on the CPU (as the JAX package fits it), then widened to
    float64."""
    from dcarl_tpu_torch.ops import spline as spl

    ref_line = np.asarray(ref_line, np.float64)
    rp = spl.refpath_from_xy(torch.as_tensor(ref_line[:, 0], dtype=dtype),
                             torch.as_tensor(ref_line[:, 1], dtype=dtype))

    def host(t):
        return t.detach().cpu().numpy().astype(np.float64)

    rp_host = {
        "s": host(rp.s),
        "ax": host(rp.sx.a), "bx": host(rp.sx.b),
        "cx": host(rp.sx.c), "dx": host(rp.sx.d),
        "ay": host(rp.sy.a), "by": host(rp.sy.b),
        "cy": host(rp.sy.c), "dy": host(rp.sy.d),
    }
    return _build_tables(ref_line, rp_host)


def _build_tables(ref_line: np.ndarray, rp_host) -> RefTables:
    """``rp_host``: host copies (np.ndarray) of the RefPath coefficients."""
    line = np.asarray(ref_line, np.float64)
    n = line.shape[0]
    cum = np.concatenate(
        [[0.0], np.cumsum(np.linalg.norm(np.diff(line, axis=0), axis=1))])

    idx = np.arange(n)
    sp = np.clip(idx - 1, 0, n - 2)   # previous segment start
    sn = np.clip(idx, 0, n - 2)       # next segment start
    cim1 = np.clip(idx - 1, 0, n - 1)
    cip1 = np.clip(idx + 1, 0, n - 1)

    x, y = line[:, 0], line[:, 1]
    gather = np.stack([
        x, y,                          # 0,1: line[ci]
        x[cim1], y[cim1],              # 2,3: line[ci-1]
        x[cip1], y[cip1],              # 4,5: line[ci+1]
        x[sp], y[sp],                  # 6,7: line[seg_prev]
        x[sp + 1], y[sp + 1],          # 8,9: line[seg_prev+1]
        x[sn], y[sn],                  # 10,11: line[seg_next]
        x[sn + 1], y[sn + 1],          # 12,13: line[seg_next+1]
        cum[sp], cum[sp + 1],          # 14,15
        cum[sn], cum[sn + 1],          # 16,17
        cum,                           # 18: cum[ci]
    ])
    assert gather.shape[0] == _G_ROWS

    knots = np.asarray(rp_host["s"], np.float64)
    m = knots.shape[0]
    seg = np.stack([
        rp_host["ax"][: m - 1], rp_host["bx"][: m - 1],
        rp_host["cx"][: m - 1], rp_host["dx"][: m - 1],
        rp_host["ay"][: m - 1], rp_host["by"][: m - 1],
        rp_host["cy"][: m - 1], rp_host["dy"][: m - 1],
    ], axis=1)
    return RefTables(line=line, cum=cum, gather=gather, knots=knots, seg=seg)


def tables_to(tab: RefTables, dtype: torch.dtype,
              device: torch.device) -> RefTables:
    """Device copies of the host tables in the working dtype."""
    return RefTables(*(torch.as_tensor(np.asarray(a), dtype=dtype,
                                       device=device) for a in tab))


# ---------------------------------------------------------------------------
# Lane-major planning and control
# ---------------------------------------------------------------------------


def _project_ego(px, py, vx, vy, tab: RefTables
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Signed projection of [B] ego points onto the reference polyline
    (``ops.geometry.project_point_to_polyline`` and the velocity rotation
    of ``cartesian_to_frenet``; the 8-case select logic of the JAX
    package).  ``tab`` holds device tensors.  Returns (s0, d, vd)."""
    line = tab.line                               # [N, 2]
    n = line.shape[0]
    dx = line[:, 0][:, None] - px[None, :]        # [N, B]
    dy = line[:, 1][:, None] - py[None, :]
    dist2 = dx * dx + dy * dy
    ci = torch.argmin(dist2, dim=0)               # [B] first minimum
    d_vertex = torch.sqrt(dist2.amin(dim=0))

    g = tab.gather[:, ci]                         # [G, B] index gather
    (cx, cy, x_m1, y_m1, x_p1, y_p1,
     x_sp, y_sp, x_sp1, y_sp1, x_sn, y_sn, x_sn1, y_sn1,
     cum_sp, cum_sp1, cum_sn, cum_sn1, cum_ci) = g.unbind(0)

    def seg_dists(x0, y0, x1, y1, x2, y2):
        l = torch.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2)
        safe_l = torch.where(l == 0, 1.0, l)
        dl = ((y2 - y1) * x0 - (x2 - x1) * y0 + x2 * y1 - x1 * y2) / safe_l
        d1 = (x1 * x1 + x0 * (x2 - x1) - x1 * x2
              + y1 * y1 + y0 * (y2 - y1) - y1 * y2) / safe_l
        d2 = (x2 * x2 - x0 * (x2 - x1) - x1 * x2
              + y2 * y2 - y0 * (y2 - y1) - y1 * y2) / safe_l
        dl0 = torch.sqrt((y0 - y1) ** 2 + (x0 - x1) ** 2)
        dl = torch.where(l == 0, dl0, dl)
        d1 = torch.where(l == 0, 0.0, d1)
        d2 = torch.where(l == 0, 0.0, d2)
        return dl, d1, d2

    dl_p, d1_p, d2_p = seg_dists(px, py, x_sp, y_sp, x_sp1, y_sp1)
    dl_n, d1_n, d2_n = seg_dists(px, py, x_sn, y_sn, x_sn1, y_sn1)

    at_start = ci == 0
    at_end = ci == n - 1

    # interior vertex sign (case 5): turn direction at the vertex
    turn_dl, _, _ = seg_dists(x_p1, y_p1, x_m1, y_m1, cx, cy)
    dist_c0_start = torch.where(dl_n < 0, -d_vertex, d_vertex)
    dist_c0_end = torch.where(dl_p < 0, -d_vertex, d_vertex)
    dist_c0_mid = torch.where(turn_dl > 0, -d_vertex, d_vertex)

    both_out = (d2_p < 0) & (d1_n < 0)
    prev_out = d2_p < 0
    next_out = d1_n < 0
    pick_prev = torch.abs(dl_n) > torch.abs(dl_p)
    dist_i = torch.where(
        both_out, dist_c0_mid,
        torch.where(prev_out, dl_n,
                    torch.where(next_out, dl_p,
                                torch.where(pick_prev, dl_p, dl_n))))
    one = torch.ones_like(ci)
    type_i = torch.where(
        both_out, 0 * one,
        torch.where(prev_out, one,
                    torch.where(next_out, -one,
                                torch.where(pick_prev, -one, one))))

    dist_s = torch.where(d1_n < 0, dist_c0_start, dl_n)
    type_s = torch.where(d1_n < 0, 0 * one, one)
    dist_e = torch.where(d2_p < 0, dist_c0_end, dl_p)
    type_e = torch.where(d2_p < 0, 0 * one, -one)

    distance = torch.where(at_start, dist_s, torch.where(at_end, dist_e, dist_i))
    ctype = torch.where(at_start, type_s, torch.where(at_end, type_e, type_i))

    ds_next = d1_n + cum_sn
    ds_prev = d1_p + cum_sp
    dist_start = torch.where(ctype == 1, ds_next,
                             torch.where(ctype == -1, ds_prev, cum_ci))

    # tangent heading of the hosting segment (cartesian_to_frenet)
    psi_next = torch.atan2(y_p1 - cy, x_p1 - cx)
    psi_prev = torch.atan2(cy - y_m1, cx - x_m1)
    psi_line = torch.where(ctype == -1, psi_prev, psi_next)
    vd = -vx * torch.sin(psi_line) + vy * torch.cos(psi_line)
    return dist_start, distance, vd


def _spline_pos_tangent(s: torch.Tensor, tab: RefTables):
    """(x, y, dx/ds, dy/ds) of the arc-length spline at ``s``: the
    clamped segment rule (searchsorted right - 1 into [0, M-2]) and the
    Horner forms of ``ops.spline.refpath_pos_tangent``.  The JAX lane-major
    form accumulates one masked term per segment, exactly one of which
    fires; a gather of that segment gives the same bits."""
    m = tab.knots.shape[0]
    i = torch.searchsorted(tab.knots, s.contiguous(), right=True) - 1
    i = torch.clamp(i, 0, m - 2)
    ax, bx, cx, dxc, ay, by, cy, dyc = tab.seg[i].unbind(-1)
    dt = s - tab.knots[i]
    px = ax + (bx + (cx + dxc * dt) * dt) * dt
    py = ay + (by + (cy + dyc * dt) * dt) * dt
    tx = bx + (2.0 * cx + 3.0 * dxc * dt) * dt
    ty = by + (2.0 * cy + 3.0 * dyc * dt) * dt
    return px, py, tx, ty


class FastLattice(NamedTuple):
    x: torch.Tensor          # [P, T, B]
    y: torch.Tensor          # [P, T, B]
    s_d_end: torch.Tensor    # [n_v, B] terminal longitudinal speed
    cf: torch.Tensor         # [P, B]
    feasible: torch.Tensor   # [P, B]


@functools.lru_cache(maxsize=None)
def _lattice_consts(wcfg: WerlingConfig, dtype: torch.dtype,
                    device: torch.device):
    """(Ti [], d_off [n_d, 1], tv [n_v, 1]) of one planner config, made
    on ``device`` once: a host-to-device copy on every tick would stall
    the card."""
    def col(values):
        return torch.tensor(values, dtype=dtype, device=device)[:, None]

    return (torch.tensor(wcfg.horizons[0], dtype=dtype, device=device),
            col(wcfg.d_offsets), col(wcfg.target_speeds))


def _plan_lattice(s0, c_d, c_d_d, c_speed, tab: RefTables,
                  wcfg: WerlingConfig) -> FastLattice:
    """Werling lattice, batch-last (``werling.plan``).  The spline is
    evaluated on the [n_v, T, B] longitudinal grid only: the n_d lateral
    offsets share it."""
    dtype, device = s0.dtype, s0.device
    npdt = _NP_DTYPE[dtype]
    Ti, d_off, tv = _lattice_consts(wcfg, dtype, device)
    n_t = wcfg.n_time_steps
    n_d, n_v = len(wcfg.d_offsets), len(wcfg.target_speeds)
    t = torch.arange(n_t, dtype=dtype, device=device) * wcfg.dt   # [T]
    t3 = t[None, :, None]                                          # [1, T, 1]

    zero = torch.zeros_like(s0)
    # Lateral quintics: boundary (c_d, c_d_d, 0) -> (d_off, 0, 0).
    lat = poly.solve_quintic(c_d[None, :], c_d_d[None, :], zero[None, :],
                             d_off, 0.0, 0.0, Ti)           # [n_d, B] coeffs
    lat3 = poly.QuinticCoeffs(*(a[:, None, :] for a in lat))
    d = poly.quintic_eval(lat3, t3)                          # [n_d, T, B]
    d_ddd = poly.quintic_d3(lat3, t3)

    # Longitudinal quartics: (s0, c_speed, 0) -> (tv, 0).
    lon = poly.solve_quartic(s0[None, :], c_speed[None, :], zero[None, :],
                             tv, 0.0, Ti)                    # [n_v, B]
    lon3 = poly.QuarticCoeffs(*(a[:, None, :] for a in lon))
    s = poly.quartic_eval(lon3, t3)                          # [n_v, T, B]
    s_dv = poly.quartic_d1(lon3, t3)
    s_dd = poly.quartic_d2(lon3, t3)
    s_ddd = poly.quartic_d3(lon3, t3)

    # Costs (werling.plan / JunctionTrajectoryPlanner.py:322-331); the
    # scalar product kt * Ti is taken in the working dtype, as in JAX.
    kt_ti = float(npdt(wcfg.kt) * npdt(wcfg.horizons[0]))
    jp = torch.sum(d_ddd ** 2, dim=1)                        # [n_d, B]
    js = torch.sum(s_ddd ** 2, dim=1)                        # [n_v, B]
    ds_cost = (wcfg.target_speed - s_dv[:, -1, :]) ** 2
    cd = wcfg.kj * jp + kt_ti + wcfg.kd * d[:, -1, :] ** 2
    cv = wcfg.kj * js + kt_ti + wcfg.kd * ds_cost
    cf = wcfg.klat * cd[:, None, :] + wcfg.klon * cv[None, :, :]   # [n_d, n_v, B]

    # Global conversion on the shared longitudinal grid.
    ix, iy, idx_, idy_ = _spline_pos_tangent(s, tab)          # [n_v, T, B]
    iyaw = torch.atan2(idy_, idx_)
    half_pi = float(npdt(np.pi / 2.0))
    cos_n = torch.cos(iyaw + half_pi)
    sin_n = torch.sin(iyaw + half_pi)
    x = ix[None] + d[:, None] * cos_n[None]                   # [n_d, n_v, T, B]
    y = iy[None] + d[:, None] * sin_n[None]

    p = n_d * n_v
    b = s0.shape[0]
    x = x.reshape(p, n_t, b)
    y = y.reshape(p, n_t, b)

    dxp = torch.diff(x, dim=1)
    dyp = torch.diff(y, dim=1)
    yaw_seg = torch.atan2(dyp, dxp)                           # [P, T-1, B]
    yaw = torch.cat([yaw_seg, yaw_seg[:, -1:, :]], dim=1)
    ds_seg = torch.sqrt(dxp ** 2 + dyp ** 2)
    ds_seg = torch.where(ds_seg < 1e-5, 0.1, ds_seg)
    curv = torch.diff(yaw, dim=1) / ds_seg                    # [P, T-1, B]

    ok_v = (~torch.any(s_dv > wcfg.max_speed, dim=1)
            & ~torch.any(torch.abs(s_dd) > wcfg.max_accel, dim=1))   # [n_v, B]
    ok_curv = ~torch.any(torch.abs(curv) > wcfg.max_curvature, dim=1)  # [P, B]
    feasible = ok_v[None].expand(n_d, n_v, b).reshape(p, b) & ok_curv

    return FastLattice(x=x, y=y, s_d_end=s_dv[:, -1, :],
                       cf=cf.reshape(p, b), feasible=feasible)


def _collision_free(lat: FastLattice, obstacles: torch.Tensor,
                    wcfg: WerlingConfig) -> torch.Tensor:
    """[P, B] collision-free mask (``predictor.py``: stride-2 indices
    from 2, constant-velocity obstacle rollouts, move_gap circle pair)."""
    dtype, device = lat.x.dtype, lat.x.device
    n_pred_t = int(wcfg.max_t / wcfg.dt)
    n_path_t = lat.x.shape[1]
    len_predict = min(n_path_t - 1, n_pred_t - 1)
    idx = torch.arange(2, len_predict, 2, device=device)
    t_grid = torch.arange(n_pred_t, dtype=dtype, device=device) * wcfg.dt
    t_check = t_grid[idx]                                     # [S]

    ox0 = obstacles[:, 0, :][:, None, :]                      # [K, 1, B]
    oy0 = obstacles[:, 1, :][:, None, :]
    ovx = obstacles[:, 2, :][:, None, :]
    ovy = obstacles[:, 3, :][:, None, :]
    oyaw = obstacles[:, 4, :][:, None, :]
    xt = ox0 + t_check[None, :, None] * ovx                   # [K, S, B]
    yt = oy0 + t_check[None, :, None] * ovy
    gx = torch.cos(oyaw) * wcfg.move_gap
    gy = torch.sin(oyaw) * wcfg.move_gap
    ox = torch.stack([xt + gx, xt - gx], dim=1)               # [K, 2, S, B]
    oy = torch.stack([yt + gy, yt - gy], dim=1)

    px = lat.x[:, idx, :]                                     # [P, S, B]
    py = lat.y[:, idx, :]
    d2 = ((ox[None] - px[:, None, None]) ** 2
          + (oy[None] - py[:, None, None]) ** 2)              # [P, K, 2, S, B]
    hit = d2 <= wcfg.robot_radius ** 2
    return ~hit.flatten(1, 3).any(dim=1)                      # [P, B]


def _control(ego_x, ego_y, ego_yaw, ego_v, traj_x, traj_y, speed_end):
    """PID + pure pursuit, batch-last (``control/controller.py``).  The
    T-point table lookups are index gathers."""
    n_t = traj_x.shape[0]
    # PID (longitudinal_pid)
    e_kmh = (speed_end - ego_v) * 3.6
    u = torch.clamp(PID_KP * e_kmh, -1.0, 1.0)
    acc = torch.where(speed_end == 0, -1.0, u)

    # pure pursuit lookahead
    d2 = (traj_x - ego_x[None]) ** 2 + (traj_y - ego_y[None]) ** 2   # [T, B]
    start_idx = torch.argmin(d2, dim=0)
    segx = torch.diff(traj_x, dim=0)
    segy = torch.diff(traj_y, dim=0)
    seg = torch.sqrt(segx ** 2 + segy ** 2)                   # [T-1, B]
    cum = torch.cat([torch.zeros_like(seg[:1]), torch.cumsum(seg, dim=0)])
    cum_start = cum.gather(0, start_idx[None])[0]

    lookahead_dt = torch.where(ego_v > 10.0, 0.5 - (ego_v - 10.0) * 0.01, 0.5)
    target_s = cum_start + torch.clamp(lookahead_dt * ego_v, min=3.0)

    # linear interp on the (cum, traj) table, clamped like jnp.interp
    i = torch.sum((cum <= target_s[None]).to(torch.int32), dim=0) - 1
    i = torch.clamp(i, 0, n_t - 2).to(torch.int64)[None]      # [1, B]
    c_lo = cum[:-1].gather(0, i)[0]
    c_hi = cum[1:].gather(0, i)[0]
    x_lo = traj_x[:-1].gather(0, i)[0]
    x_hi = traj_x[1:].gather(0, i)[0]
    y_lo = traj_y[:-1].gather(0, i)[0]
    y_hi = traj_y[1:].gather(0, i)[0]
    denom = c_hi - c_lo
    frac = torch.where(denom > 0,
                       (target_s - c_lo) / torch.where(denom == 0, 1.0, denom),
                       0.0)
    frac = torch.clamp(frac, 0.0, 1.0)
    wp_x = x_lo + frac * (x_hi - x_lo)
    wp_y = y_lo + frac * (y_hi - y_lo)

    vx_h = torch.cos(ego_yaw)
    vy_h = torch.sin(ego_yaw)
    wx = wp_x - ego_x
    wy = wp_y - ego_y
    w_norm = torch.clamp(torch.sqrt(wx ** 2 + wy ** 2), min=1e-9)
    cos_a = torch.clamp((wx * vx_h + wy * vy_h) / w_norm, -1.0, 1.0)
    alpha = torch.arccos(cos_a)
    cross_z = vx_h * wy - vy_h * wx
    alpha = torch.where(cross_z < 0, -alpha, alpha)

    rear_x = ego_x - vx_h * LR
    rear_y = ego_y - vy_h * LR
    l = torch.clamp(torch.sqrt((wp_x - rear_x) ** 2 + (wp_y - rear_y) ** 2),
                    min=1e-6)
    steer = torch.arctan(2.0 * torch.sin(alpha) * LWB / l)
    return acc, steer


# ---------------------------------------------------------------------------
# Lane-major env
# ---------------------------------------------------------------------------


class FastEnvState(NamedTuple):
    ego: torch.Tensor          # [5, B]
    ego_speed: torch.Tensor    # [B]
    vehicles: torch.Tensor     # [V, 5, B]
    walker: torch.Tensor       # [5, B]
    stuck_steps: torch.Tensor  # [B] i32
    step_count: torch.Tensor   # [B] i32
    done: torch.Tensor         # [B] bool
    collided: torch.Tensor
    passed: torch.Tensor
    stuck: torch.Tensor
    episode_return: torch.Tensor


def _state_to_lane_major(s: de.EnvState) -> FastEnvState:
    """Transpose a batch-first EnvState into lane-major."""
    return FastEnvState(
        ego=s.ego.T.contiguous(), ego_speed=s.ego_speed,
        vehicles=s.vehicles.permute(1, 2, 0).contiguous(),
        walker=s.walker.T.contiguous(), stuck_steps=s.stuck_steps,
        step_count=s.step_count, done=s.done, collided=s.collided,
        passed=s.passed, stuck=s.stuck, episode_return=s.episode_return)


def _reset_soa(generator: torch.Generator, b: int, sa: de.ScenarioArrays,
               cfg: EnvConfig) -> FastEnvState:
    """Batch reset, jitter drawn as [.., B] blocks from ``generator``."""
    like = sa.ego_spawn
    j = cfg.reset_jitter
    ego = sa.ego_spawn[:, None] + torch.cat([
        de._uniform(generator, (2, b), -1.0, 1.0, like) * j,
        torch.zeros((3, b), dtype=like.dtype, device=like.device)])
    v = sa.vehicle_spawns.shape[0]
    veh = sa.vehicle_spawns[:, :, None].repeat(1, 1, b)
    veh[:, :2, :] += de._uniform(generator, (v, 2, b), -1.0, 1.0, like) * j
    zeros = torch.zeros((b,), dtype=like.dtype, device=like.device)
    zi = torch.zeros((b,), dtype=torch.int32, device=like.device)
    zb = torch.zeros((b,), dtype=torch.bool, device=like.device)
    return FastEnvState(
        ego=ego, ego_speed=zeros, vehicles=veh,
        walker=sa.walker_spawn[:, None].repeat(1, b),
        stuck_steps=zi, step_count=zi, done=zb, collided=zb, passed=zb,
        stuck=zb, episode_return=zeros)


def _step_env_soa(state: FastEnvState, acc_cmd, steer_cmd,
                  generator: torch.Generator, sa: de.ScenarioArrays,
                  cfg: EnvConfig):
    """Lane-major ``driving_env.step_autoreset``: kinematic bicycle,
    scripted traffic, collision / pass / stuck / timeout, reward, and
    auto-reset of finished envs."""
    b = acc_cmd.shape[0]
    dtype = acc_cmd.dtype
    # --- ego kinematics (_step_ego)
    throttle = torch.clamp(acc_cmd, min=0.0)
    brake = torch.clamp(-acc_cmd, min=0.0)
    accel = throttle * cfg.max_accel - brake * cfg.max_brake \
        - 0.05 * state.ego_speed
    v = torch.clamp(state.ego_speed + accel * cfg.dt, 0.0, 60.0)
    steer = torch.clamp(steer_cmd, -cfg.max_steer, cfg.max_steer)
    yaw = state.ego[4] + v / cfg.wheelbase * torch.tan(steer) * cfg.dt
    vx = v * torch.cos(yaw)
    vy = v * torch.sin(yaw)
    x = state.ego[0] + vx * cfg.dt
    y = state.ego[1] + vy * cfg.dt
    ego = torch.stack([x, y, vx, vy, yaw])

    # --- traffic (_step_traffic)
    veh = state.vehicles.clone()
    moving = sa.vehicle_moving[:, None, None]
    new_xy = veh[:, :2, :] + veh[:, 2:4, :] * cfg.dt
    veh[:, :2, :] = torch.where(moving, new_xy, veh[:, :2, :])
    walker = state.walker.clone()
    walker[:2] += state.walker[2:4] * cfg.dt

    # --- collision / termination / reward
    actor_x = torch.cat([veh[:, 0, :], walker[0][None]])     # [V+1, B]
    actor_y = torch.cat([veh[:, 1, :], walker[1][None]])
    d2 = (actor_x - x[None]) ** 2 + (actor_y - y[None]) ** 2
    collided = torch.any(d2 < cfg.collision_radius ** 2, dim=0)
    if cfg.offroute_dist > 0:
        # road departure == environment collision (driving_env.step)
        d2r = ((sa.ref_path[:, 0][:, None] - x[None]) ** 2
               + (sa.ref_path[:, 1][:, None] - y[None]) ** 2).amin(dim=0)
        collided = collided | (d2r > cfg.offroute_dist ** 2)

    passed = y < cfg.pass_line_y
    slow = v < cfg.stuck_speed
    stuck_steps = torch.where(slow, state.stuck_steps + 1, 0).to(torch.int32)
    stuck = stuck_steps > int(cfg.stuck_time / cfg.dt)

    reward = torch.sqrt(v) * cfg.speed_reward_scale \
        + passed.to(dtype) * cfg.reward_pass
    reward = torch.where(collided, cfg.reward_collision, reward)
    reward = torch.where(stuck & ~collided, cfg.reward_stuck, reward)

    step_count = state.step_count + 1
    timeout = step_count >= cfg.max_episode_steps
    done = collided | passed | stuck | timeout

    new_state = FastEnvState(
        ego=ego, ego_speed=v, vehicles=veh, walker=walker,
        stuck_steps=stuck_steps, step_count=step_count, done=done,
        collided=collided, passed=passed, stuck=stuck,
        episode_return=state.episode_return + reward)

    # --- auto-reset blend
    fresh = _reset_soa(generator, b, sa, cfg)
    blended = FastEnvState(*(
        torch.where(done.reshape((1,) * (a.ndim - 1) + done.shape), f, a)
        for a, f in zip(new_state, fresh)))
    blended = blended._replace(done=done, collided=collided, passed=passed,
                               stuck=stuck)
    return blended, reward, done


def _obs_ori_soa(state: FastEnvState, in_state_idx) -> torch.Tensor:
    """[20, B] world-frame observation (walker first, then the in-state
    vehicles, as ``driving_env.wrap_state`` orders them)."""
    rows = [state.ego, state.walker]
    rows += [state.vehicles[i] for i in in_state_idx]
    return torch.cat(rows, dim=0)


# ---------------------------------------------------------------------------
# The drivers
# ---------------------------------------------------------------------------


class _Tick(NamedTuple):
    """What every driver computes before choosing a path."""

    obs: torch.Tensor         # [20, B] world-frame observation
    lat: FastLattice
    rule_index: torch.Tensor  # [B] 0 = brake, p+1 = lattice path p


def _plan_tick(state: FastEnvState, idx, tab: RefTables, wcfg: WerlingConfig,
               n_obj: int) -> _Tick:
    """Observation, lattice, collision gating and the rule pick."""
    obs = _obs_ori_soa(state, idx)
    ego_x, ego_y = obs[0], obs[1]
    ego_vx, ego_vy = obs[2], obs[3]

    # planner start state (start_state_from_ego: c_d = -d)
    s0, d_signed, vd = _project_ego(ego_x, ego_y, ego_vx, ego_vy, tab)
    c_speed = torch.sqrt(ego_vx ** 2 + ego_vy ** 2)
    lat = _plan_lattice(s0, -d_signed, vd, c_speed, tab, wcfg)

    # obstacles: rows 5.. of obs with yaw zeroed (rollout semantics)
    obstacles = obs[5:].reshape(n_obj, 5, -1).clone()
    obstacles[:, 4, :] = 0.0
    free = _collision_free(lat, obstacles, wcfg)

    ok = lat.feasible & free
    masked_cost = torch.where(ok, lat.cf, torch.inf)
    best = torch.argmin(masked_cost, dim=0)
    rule_index = torch.where(ok.any(dim=0), best + 1, 0)
    return _Tick(obs, lat, rule_index)


def _pick_path(lat: FastLattice, index: torch.Tensor, n_v: int):
    """trajectory_by_index, lane-major: (x [T, B], y [T, B], speed_end
    [B]) of candidate ``index`` (0 = brake: the min-cost path at zero
    speed), gathered by index."""
    brake_path = torch.argmin(lat.cf, dim=0)
    p_sel = torch.where(index == 0, brake_path, index - 1)
    tx = lat.x.gather(0, p_sel[None, None].expand(1, *lat.x.shape[1:]))[0]
    ty = lat.y.gather(0, p_sel[None, None].expand(1, *lat.y.shape[1:]))[0]
    # path p runs at terminal speed index p % n_v
    se = lat.s_d_end.gather(0, (p_sel % n_v)[None])[0]
    return tx, ty, torch.where(index == 0, 0.0, se)


def _follow(tick: _Tick, index: torch.Tensor, n_v: int, state: FastEnvState,
            generator, sa, env_cfg: EnvConfig):
    """trajectory_by_index, then control and the env step."""
    obs = tick.obs
    traj_x, traj_y, speed_end = _pick_path(tick.lat, index, n_v)
    ego_v = torch.sqrt(obs[2] ** 2 + obs[3] ** 2)
    acc, steer = _control(obs[0], obs[1], obs[4], ego_v, traj_x, traj_y,
                          speed_end)
    return _step_env_soa(state, acc, steer, generator, sa, env_cfg)


def _setup(sc: Scenario, env_cfg: EnvConfig, dtype, device):
    device = resolve_device(device)
    if dtype not in _NP_DTYPE:
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    sa = de.scenario_to_device(sc, dtype, device)
    idx = de.in_state_indices(sc)
    tab = tables_to(build_ref_tables(np.asarray(sc.ref_path, np.float64),
                                     dtype), dtype, device)

    def init_fn(batch: int, generator: torch.Generator) -> FastEnvState:
        """``batch`` envs at their spawn points, jitter drawn from
        ``generator`` (a generator on the driver's device)."""
        return _state_to_lane_major(de.reset(sa, batch, generator, env_cfg))

    return device, sa, idx, tab, init_fn


def make_rule_driver_fast(sc: Scenario,
                          env_cfg: EnvConfig = EnvConfig(),
                          wcfg: WerlingConfig = WerlingConfig(),
                          dtype: torch.dtype = torch.float32,
                          device: "str | torch.device | None" = None):
    """Lane-major rule driver: (init_fn, run_fn) with

      init_fn(batch, generator)          -> carry (FastEnvState)
      run_fn(carry, n_steps, generator)  -> (carry, (reward, done,
                                             passed, collided)), each [S, B]

    ``device=None`` runs on ``cuda`` (which must exist).  On CUDA each
    run replays one captured CUDA graph of a tick
    (``utils/graphs.TickRunner``, ``run_fn.runner``); on the CPU it runs
    the eager loop, ``graphs.run_loop(run_fn.runner.tick, ...)``, which
    gives the same bits."""
    device, sa, idx, tab, init_fn = _setup(sc, env_cfg, dtype, device)
    n_obj = (env_cfg.state_dim - 5) // 5
    n_v = len(wcfg.target_speeds)

    def tick(state: FastEnvState, _inputs, generator: torch.Generator):
        with profiling.phase("plan"):
            t = _plan_tick(state, idx, tab, wcfg, n_obj)
        with profiling.phase("env_step"):
            state, reward, done = _follow(t, t.rule_index, n_v, state,
                                          generator, sa, env_cfg)
        return state, (reward, done, state.passed, state.collided)

    runner = graphs.TickRunner(tick, device.type == "cuda", name="rule")

    def run_fn(carry: FastEnvState, n_steps: int, generator: torch.Generator):
        return runner(carry, (), n_steps, generator)

    run_fn.runner = runner
    return init_fn, run_fn


class FastCollectorCarry(NamedTuple):
    env: FastEnvState
    triggered: torch.Tensor         # [B] bool
    locked_x: torch.Tensor          # [T, B]
    locked_y: torch.Tensor          # [T, B]
    locked_speed_end: torch.Tensor  # [B]
    recorded_state: torch.Tensor    # [20, B]
    used_action: torch.Tensor       # [B] i32


class FastStepRecord(NamedTuple):
    done: torch.Tensor              # [B]
    collided: torch.Tensor
    passed: torch.Tensor
    recorded_state: torch.Tensor    # [20, B]
    used_action: torch.Tensor       # [B] i32
    episode_return: torch.Tensor
    reward: torch.Tensor
    rule_index: torch.Tensor        # [B] i64


def make_collector_fast(sc: Scenario,
                        env_cfg: EnvConfig = EnvConfig(),
                        wcfg: WerlingConfig = WerlingConfig(),
                        dtype: torch.dtype = torch.float32,
                        trigger_y: float = 90.0,
                        device: "str | torch.device | None" = None):
    """Lane-major value collector (the dqn_value_collect.py loop): each
    env drives the rule until its ego passes ``trigger_y``, then locks the
    round-robin candidate ``used_action`` (and the observation it locked
    at) and follows that trajectory to the episode's end; a finished
    episode moves the env to the next candidate.

    Returns (init_fn, run_fn):
      init_fn(batch, generator)          -> FastCollectorCarry
      run_fn(carry, n_steps, generator)  -> (carry, FastStepRecord), each
                                            record field [S, ...]
    ``device=None`` runs on ``cuda`` (which must exist); the run is
    compiled on CUDA, as :func:`make_rule_driver_fast`'s."""
    device, sa, idx, tab, env_init = _setup(sc, env_cfg, dtype, device)
    n_obj = (env_cfg.state_dim - 5) // 5
    n_v = len(wcfg.target_speeds)
    n_actions = wcfg.num_paths + 1
    n_t = wcfg.n_time_steps
    npdt = _NP_DTYPE[dtype]
    y_trigger = float(npdt(trigger_y))

    def init_fn(batch: int, generator: torch.Generator) -> FastCollectorCarry:
        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return FastCollectorCarry(
            env=env_init(batch, generator),
            triggered=z(batch, dt=torch.bool),
            locked_x=z(n_t, batch), locked_y=z(n_t, batch),
            locked_speed_end=z(batch),
            recorded_state=z(env_cfg.state_dim, batch),
            used_action=z(batch, dt=torch.int32))

    def tick(carry: FastCollectorCarry, _inputs, generator: torch.Generator):
        state = carry.env
        t = _plan_tick(state, idx, tab, wcfg, n_obj)
        obs, lat = t.obs, t.lat

        # trigger: lock the round-robin candidate once y < trigger_y
        trigger_now = (~carry.triggered) & (obs[1] < y_trigger)
        hrl_x, hrl_y, hrl_se = _pick_path(lat, carry.used_action.to(torch.int64),
                                          n_v)
        rule_x, rule_y, rule_se = _pick_path(lat, t.rule_index, n_v)

        locked_x = torch.where(trigger_now[None, :], hrl_x, carry.locked_x)
        locked_y = torch.where(trigger_now[None, :], hrl_y, carry.locked_y)
        locked_se = torch.where(trigger_now, hrl_se, carry.locked_speed_end)
        recorded_state = torch.where(trigger_now[None, :], obs,
                                     carry.recorded_state)
        triggered = carry.triggered | trigger_now

        follow_x = torch.where(triggered[None, :], locked_x, rule_x)
        follow_y = torch.where(triggered[None, :], locked_y, rule_y)
        follow_se = torch.where(triggered, locked_se, rule_se)

        ego_v = torch.sqrt(obs[2] ** 2 + obs[3] ** 2)
        acc, steer = _control(obs[0], obs[1], obs[4], ego_v, follow_x,
                              follow_y, follow_se)
        episode_return_before = state.episode_return
        state, reward, done = _step_env_soa(state, acc, steer, generator, sa,
                                            env_cfg)

        record = FastStepRecord(
            done=done, collided=state.collided, passed=state.passed,
            recorded_state=recorded_state, used_action=carry.used_action,
            episode_return=episode_return_before + reward, reward=reward,
            rule_index=t.rule_index)
        used_action = torch.where(done, (carry.used_action + 1) % n_actions,
                                  carry.used_action).to(torch.int32)
        triggered = torch.where(done, False, triggered)
        return FastCollectorCarry(
            env=state, triggered=triggered, locked_x=locked_x,
            locked_y=locked_y, locked_speed_end=locked_se,
            recorded_state=recorded_state, used_action=used_action), record

    runner = graphs.TickRunner(tick, device.type == "cuda", name="collector")

    def run_fn(carry: FastCollectorCarry, n_steps: int,
               generator: torch.Generator):
        return runner(carry, (), n_steps, generator)

    run_fn.runner = runner
    return init_fn, run_fn


def shard_lanes(x, mesh: ProcessMesh):
    """This rank's block of the env (last) axis of a lane-major tensor or
    state (every field [..., B]); B must divide by the mesh size."""
    def take(t):
        b = t.shape[-1]
        if b % mesh.size:
            raise ValueError(f"env batch {b} does not divide by the mesh "
                             f"size {mesh.size}")
        k = b // mesh.size
        return t[..., mesh.rank * k:(mesh.rank + 1) * k].contiguous()
    if isinstance(x, torch.Tensor):
        return take(x)
    return type(x)(*(take(t) for t in x))


def shard_rule_driver(init_fn, run_fn, mesh: ProcessMesh):
    """The lane-major rule driver over a mesh (``fast_rollout.py:823``).
    It couples no envs, so each rank steps its own block of the batch with
    no collective.  Returns ``(init_sharded, run_fn)``:
    ``init_sharded(batch, generator)`` makes the ``batch``-env start from
    ``generator`` (the same on every rank) and keeps this rank's block
    of ``batch / S`` envs; ``run_fn`` is the unsharded one, on that
    block (its auto-reset draws are the rank's own, as JAX's shards draw
    theirs in blocks)."""
    def init_sharded(batch: int, generator: torch.Generator):
        return shard_lanes(init_fn(batch, generator), mesh)

    return init_sharded, run_fn


def make_gated_driver_fast(sc: Scenario,
                           env_cfg: EnvConfig = EnvConfig(),
                           wcfg: WerlingConfig = WerlingConfig(),
                           store_cfg: "StoreConfig | None" = None,
                           dtype: torch.dtype = torch.float32,
                           device: "str | torch.device | None" = None,
                           use_kernel: "bool | None" = None,
                           with_query_offset: bool = False,
                           mesh: "ProcessMesh | None" = None):
    """Lane-major confidence-gated deployment driver (DCARL_agent.py
    predict loop + RLS.act_test, RLS.py:120-157): plan the lattice,
    query the fixed store for every candidate action of every env, run
    the Welch z-test gate, follow the winning candidate (the rule pick
    when none passes), step the env.

    Returns (init_fn, run_fn):
      init_fn(batch, generator) -> carry
      run_fn(carry, n_steps, store_keys[N, D+1], store_values[N],
             store_valid[N], [query_offset[D],] generator=...)
          -> (carry, (reward, done, passed, collided, executed_action,
                      gated_action)), each [S, B]
    ``gated_action`` is the z-test output g (0 = the rule pick),
    ``executed_action`` the trajectory index followed.

    ``use_kernel`` (None = on CUDA): query through the per-action kernel
    against the store prepared once per ``run_fn`` call; on CPU tensors
    that route takes the kernel's plain version.  ``use_kernel=False``
    is the brute ``_raw_moments`` route over the 21-D candidate keys in
    the working dtype (the reference the tests hold the kernel route to).

    ``with_query_offset=True`` adds a ``query_offset`` [state_dim]
    argument, added to every observation before the store query only
    (the vehicle-life frame alignment of ``workingset.py``).

    On CUDA the run is compiled, as :func:`make_rule_driver_fast`'s: the
    store is prepared once a run, outside the graph, as JAX prepares it
    once before its scan; ``run_fn.inputs(store_keys, store_values,
    store_valid[, query_offset])`` gives what a run's ticks read, which
    the captured graph's buffers take by copy.

    Traced (``utils/profiling``), a tick's phases are ``plan`` (the
    lattice and the query's observation), ``query`` (the per-action
    query: operands, plan, both passes), ``gate`` (the Welch test and the
    executed index) and ``env_step`` (control and the env step), and a
    call's store prepare is the host span ``dcarl.store_prepare``; the
    runner is ``gated``.

    ``mesh`` (JAX's ``psum_axis`` path, :func:`make_gated_driver_sharded`):
    the carry holds this rank's block of the envs and the store arguments
    this rank's rows.  Each tick every env's gate sees the whole store:
    the ranks' [B_local, 20] queries are all-gathered, the rank's rows
    answer the whole [B_global, 20] batch (one kernel launch, against the
    local rows prepared once a run), and a reduce-scatter of the
    [B_global * A, 3] partial moments leaves each rank the sums of its
    own envs.  (A sum of local-batch moments would add moments of
    different envs that share a local index.)  On the kernel route the
    ranks' sums cross in f64 and are rounded to f32 once, after the
    reduce-scatter: a gate then sees the bits of the one-rank run (f32
    partials summed across ranks flipped a decision in a 65,536-env run
    on the card).  The brute route reduces f32 moments, as JAX's does.
    Over a mesh the run stays eager."""
    if mesh is not None:
        device = mesh.device
    device, sa, idx, tab, init_fn = _setup(sc, env_cfg, dtype, device)
    scfg = store_cfg or StoreConfig()
    if use_kernel is None:
        use_kernel = device.type == "cuda"
    n_obj = (env_cfg.state_dim - 5) // 5
    n_v = len(wcfg.target_speeds)
    num_actions = wcfg.num_paths + 1
    hw = np.asarray(scfg.half_widths or FIELD_HALF_WIDTHS, np.float64)
    if hw.shape[0] != env_cfg.state_dim + 1:
        raise ValueError("store half_widths must match state_dim + 1")
    if hw[-1] >= 0.5:
        # the per-action query assigns each row to exactly one action:
        # an action half-width reaching across the 1.0 lattice gap would
        # be silently dropped there
        raise ValueError(
            f"action half_width {hw[-1]} >= 0.5 allows cross-action box "
            "matches, which the per-action query kernel cannot express; use "
            "an exact-match width (< 0.5, e.g. the reference's 0.1)")
    half_widths = torch.as_tensor(hw, dtype=dtype, device=device)
    sum_dtype = torch.float32 if mesh is None else torch.float64

    def run_inputs(store_keys, store_values, store_valid, query_offset=None):
        """What every tick of a run reads: the prepared store (the keys,
        values and valid rows in the working dtype on the brute route)
        and the query offset on the device, or None."""
        store_keys = torch.as_tensor(store_keys, device=device)
        store_values = torch.as_tensor(store_values, device=device)
        store_valid = torch.as_tensor(store_valid, device=device)
        if use_kernel:
            with profiling.span("dcarl.store_prepare"):
                store = store_kernels.prepare_peraction_store(
                    store_keys, store_values, store_valid, half_widths,
                    num_actions=num_actions)
        else:
            store = (store_keys.to(dtype), store_values.to(dtype), store_valid)
        offset = None if query_offset is None else torch.as_tensor(
            query_offset, device=device).to(dtype)
        return store, offset

    def tick(state: FastEnvState, inputs, generator: torch.Generator):
        store, offset = inputs
        with profiling.phase("plan"):
            t = _plan_tick(state, idx, tab, wcfg, n_obj)
            b = t.obs.shape[1]
            obs_bf = t.obs.T                                  # [B, 20]
            if offset is not None:
                obs_bf = obs_bf + offset[None, :]
        with profiling.phase("query"):
            obs_q = obs_bf if mesh is None else coll.all_gather(obs_bf, mesh)
            if use_kernel:
                moments = store_kernels.query_peraction_prepared(
                    store, obs_q.to(torch.float32).contiguous(),
                    out_dtype=sum_dtype).reshape(-1, 3)
            else:
                keys_w, vals_w, valid = store
                moments = _raw_moments(keys_w, vals_w, valid, obs_q,
                                       half_widths, num_actions)
            if mesh is not None:
                moments = coll.reduce_scatter(moments, mesh).to(torch.float32)
        with profiling.phase("gate"):
            qs = moments_to_stats(moments)
            stats = RLSmod.ActionStats(
                count=qs.count.reshape(b, num_actions).to(dtype),
                mean=qs.mean.reshape(b, num_actions).to(dtype),
                var=qs.var.reshape(b, num_actions).to(dtype),
                sigma=qs.sigma.reshape(b, num_actions).to(dtype))
            g = RLSmod.act_test(stats, scfg)                   # [B]
            executed = torch.where(g == 0, t.rule_index, g).to(torch.int32)
        with profiling.phase("env_step"):
            state, reward, done = _follow(t, executed.to(torch.int64), n_v,
                                          state, generator, sa, env_cfg)
        return state, (reward, done, state.passed, state.collided, executed,
                       g)

    runner = graphs.TickRunner(tick, device.type == "cuda" and mesh is None,
                               name="gated")

    def run_fn(carry: FastEnvState, n_steps: int, store_keys, store_values,
               store_valid, query_offset=None, *, generator: torch.Generator):
        if (query_offset is not None) != with_query_offset:
            raise TypeError("query_offset is given iff the driver was made "
                            "with_query_offset=True")
        return runner(carry, run_inputs(store_keys, store_values, store_valid,
                                        query_offset), n_steps, generator)

    run_fn.inputs = run_inputs
    run_fn.runner = runner
    return init_fn, run_fn


def make_gated_driver_sharded(sc: Scenario, mesh: ProcessMesh,
                              env_cfg: EnvConfig = EnvConfig(),
                              wcfg: WerlingConfig = WerlingConfig(),
                              store_cfg: "StoreConfig | None" = None,
                              dtype: torch.dtype = torch.float32,
                              use_kernel: "bool | None" = None):
    """The gated driver over a mesh (``fast_rollout.py:1061``): envs and
    store rows both shard over the ranks.  Returns ``(init_sharded,
    run_fn)``: ``init_sharded(batch, generator)`` makes the ``batch``-env
    start from ``generator`` (the same on every rank) and keeps this
    rank's block; ``run_fn`` is :func:`make_gated_driver_fast`'s with
    ``mesh``, taking this rank's store rows.  One [B_local, 20]
    all-gather and one [B_global * A, 3] reduce-scatter a tick.

    On the concatenated batch and the concatenated rows the integer gate
    outputs equal the one-rank driver's: on the kernel route the ranks'
    f64 sums are added before the one rounding to f32, and on the brute
    route (JAX's) the moments agree to f32 reduction order.  Auto-resets
    draw from each rank's own generator,
    so runs in which envs finish are equal in distribution only, as in
    JAX's per-shard blocks."""
    init_fn, run_fn = make_gated_driver_fast(
        sc, env_cfg, wcfg, store_cfg=store_cfg, dtype=dtype,
        device=mesh.device, use_kernel=use_kernel, mesh=mesh)
    init_sharded, _ = shard_rule_driver(init_fn, run_fn, mesh)
    return init_sharded, run_fn
