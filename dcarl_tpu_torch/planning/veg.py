"""VEG, the value-estimation-guided continuous-action planner, batch-first
(the JAX package's ``planning/veg.py``; the reference's
continuous_models/VEG/VEG_planner.py + Werling_planner_RL.py).

Each planning tick:

1. wraps a 16-D Frenet state (ego + the 3 nearest obstacles,
   VEG_planner.py:140-178);
2. takes the rule trajectory's "RL point", (d, s_d - 15/3.6) at
   KICK_IN_POINT = 7 (2.1 s at DT 0.3; :211-219);
3. takes the agent's (rl_action = [d_target, v_target], rl_q, rule_q),
   which the reference receives over TCP and which here are arguments;
4. kicks in a Werling trajectory toward the RL target iff
   ``rl_q - rule_q > threshold`` and the action is in range, else keeps
   the rule trajectory (generate_VEG_trajectory, :224-240).

The single-target Werling solve (a quintic lateral to d_target and a
quartic longitudinal to v_target, Werling_planner_RL.py:123-160) is in
closed form and takes every env of a batch at once.
"""

from __future__ import annotations

import dataclasses
import math
from typing import NamedTuple, Tuple

import torch

from dcarl_tpu_torch.config import WerlingConfig
from dcarl_tpu_torch.ops import polynomial as poly
from dcarl_tpu_torch.ops import spline as spl
from dcarl_tpu_torch.ops.geometry import cartesian_to_frenet
from dcarl_tpu_torch.planning import werling as W

THRESHOLD = 0.2                    # VEG_planner.py:20
ACTION_SPACE_SYMMETRY = 15.0 / 3.6  # :22 (sic: ACTION_SPACE_SYMMERTY)
KICK_IN_POINT = 7                  # :27, 2.1 s at DT 0.3
OBSTACLES_CONSIDERED = 3
MIN_SPEED_RL = 0.5                 # Werling_planner_RL emergency stop
ACTION_LIMIT = 2333.0              # out-of-range sentinel (:235)

VEG_STATE_DIM = 16


@dataclasses.dataclass(frozen=True)
class VEGConfig:
    """The switch between the reference's two VEG stacks (a copy of the
    JAX package's dataclass).

    ``variant="veg"`` is VEG/VEG_planner.py (the defaults above);
    ``variant="itsc"`` is VEG_ITSC/VEG_planner.py + Werling_trajectory.py,
    whose differences are:

    * Q-advantage gate threshold 5.0, not 0.2 (VEG_ITSC/VEG_planner.py:88,
      :148);
    * +12.5/3.6 m/s added to the received RL speed action (:149);
    * emergency stop below 3/3.6 m/s, not 0.5 (Werling_trajectory.py:188);
    * the executed trajectory is TWO chained Werling segments: the RL
      kick segment, then a rule-optimal continuation planned from its end
      (trajectory_update_withRL_second, Werling_trajectory.py:172-240);
    * the longitudinal start is biased one second ahead
      (``s0 = ffstate.s + c_speed * 1.0``, :202/:219);
    * the rule point is sampled at about 2.25 s (VEG_ITSC/VEG_planner.py:
      114-115, :246-252).
    """

    variant: str = "veg"
    threshold: float = THRESHOLD
    speed_bias: float = 0.0
    min_speed_rl: float = MIN_SPEED_RL
    second_segment: bool = False
    s0_lookahead_s: float = 0.0
    kick_in_point: int = KICK_IN_POINT


def itsc_config() -> VEGConfig:
    return VEGConfig(
        variant="itsc",
        threshold=5.0,
        speed_bias=12.5 / 3.6,
        min_speed_rl=3.0 / 3.6,
        second_segment=True,
        s0_lookahead_s=1.0,
        kick_in_point=KICK_IN_POINT,  # the same ~2.1-2.25 s on a 0.3 s grid
    )


class VEGState(NamedTuple):
    """What the agent sees per tick (wrap_state): the 16-D state, the
    collision and leave flags, and the rule point."""

    state: torch.Tensor       # [.., 16]
    collision: torch.Tensor   # [..]
    leave: torch.Tensor       # [..]
    rule_point: torch.Tensor  # [.., 2] (d, s_d - symmetry) at the kick-in step


def _frenet_row(f) -> torch.Tensor:
    return torch.stack([f.s, -f.d, f.vs, f.vd], dim=-1)


def wrap_state(ref_line: torch.Tensor, ego: torch.Tensor,
               obstacles: torch.Tensor, obstacles_valid: torch.Tensor,
               collision: torch.Tensor, leave: torch.Tensor,
               rule_lattice: W.Lattice, rule_index: torch.Tensor) -> VEGState:
    """VEG_planner.wrap_state (:140-178) and get_RL_point_from_trajectory
    (:211-219): the ego and the 3 nearest valid obstacles (Euclidean
    order, a stable sort) in the reference path's Frenet frame; absent
    obstacles contribute zeros.  ``ego`` [.., 5], ``obstacles`` [.., K, 5]."""
    head = _frenet_row(cartesian_to_frenet(
        ego[..., 0], ego[..., 1], ego[..., 2], ego[..., 3], ego[..., 4],
        ref_line))
    dist = torch.sqrt((obstacles[..., 0] - ego[..., 0, None]) ** 2
                      + (obstacles[..., 1] - ego[..., 1, None]) ** 2)
    dist = torch.where(obstacles_valid, dist, torch.inf)
    order = torch.argsort(dist, dim=-1, stable=True)[..., :OBSTACLES_CONSIDERED]
    near = torch.gather(obstacles, -2, order[..., None].expand(
        order.shape + (obstacles.shape[-1],)))
    feat = _frenet_row(cartesian_to_frenet(
        near[..., 0], near[..., 1], near[..., 2], near[..., 3], near[..., 4],
        ref_line))
    present = torch.isfinite(torch.gather(dist, -1, order))[..., None]
    tail = torch.where(present, feat, torch.zeros_like(feat)).flatten(-2)
    state = torch.cat([head, tail], dim=-1)

    # the rule point: the rule trajectory's (d, s_d) at the kick-in step
    p = torch.where(rule_index == 0, torch.argmin(rule_lattice.cf, dim=-1),
                    rule_index - 1)
    kick = min(KICK_IN_POINT, rule_lattice.d.shape[-1] - 1)
    d_k = W.path_rows(rule_lattice.d, p)[..., kick]
    v_k = W.path_rows(rule_lattice.s_d, p)[..., kick]
    rule_point = torch.stack([d_k, v_k - ACTION_SPACE_SYMMETRY], dim=-1)
    return VEGState(state=state, collision=collision, leave=leave,
                    rule_point=rule_point)


def plan_rl_kick(rp: spl.RefPath, start: W.FrenetStart,
                 d_target: torch.Tensor, v_target: torch.Tensor,
                 cfg: WerlingConfig = WerlingConfig()
                 ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor,
                            W.FrenetStart]:
    """Single-target Werling solve toward the RL action
    (frenet_optimal_planning_withRL, Werling_planner_RL.py:162-210): a
    lateral quintic from the start to d_target and a longitudinal quartic
    from the start speed to v_target over one horizon.  Returns
    (xy [.., T, 2], speed [.., T], feasible [..], end_state)."""
    ti = cfg.horizons[0]
    n_t = cfg.n_time_steps
    s0 = start.s0
    dtype, device = s0.dtype, s0.device
    t = torch.arange(n_t, dtype=dtype, device=device) * cfg.dt

    def col(a):
        return torch.broadcast_to(torch.as_tensor(a, dtype=dtype,
                                                  device=device),
                                  s0.shape)[..., None]

    lat = poly.QuinticCoeffs(*(col(a) for a in poly.solve_quintic(
        start.c_d, start.c_d_d, start.c_d_dd, d_target, 0.0, 0.0, ti)))
    d = poly.quintic_eval(lat, t)
    lon = poly.QuarticCoeffs(*(col(a) for a in poly.solve_quartic(
        s0, start.c_speed, 0.0, v_target, 0.0, ti)))
    s = poly.quartic_eval(lon, t)
    s_d = poly.quartic_d1(lon, t)
    s_dd = poly.quartic_d2(lon, t)

    ix = spl.spline_eval(rp.sx, s)
    iy = spl.spline_eval(rp.sy, s)
    iyaw = torch.atan2(spl.spline_d1(rp.sy, s), spl.spline_d1(rp.sx, s))
    x = ix + d * torch.cos(iyaw + math.pi / 2.0)
    y = iy + d * torch.sin(iyaw + math.pi / 2.0)

    feasible = (~torch.any(s_d > cfg.max_speed, dim=-1)
                & ~torch.any(torch.abs(s_dd) > cfg.max_accel, dim=-1))
    zero = torch.zeros_like(s[..., -1])
    end = W.FrenetStart(s0=s[..., -1], c_d=d[..., -1], c_d_d=zero,
                        c_d_dd=zero, c_speed=s_d[..., -1])
    return torch.stack([x, y], dim=-1), s_d, feasible, end


class VEGPlan(NamedTuple):
    xy: torch.Tensor             # [.., T, 2] executable trajectory
    desired_speed: torch.Tensor  # [.., T]
    kicked_in: torch.Tensor      # [..] bool: the RL action overrode the rule
    rule_index: torch.Tensor     # [..] i64


def plan_veg(rp: spl.RefPath, ref_line: torch.Tensor,
             ego: torch.Tensor,              # [.., 5]
             obstacles: torch.Tensor,        # [.., K, 5]
             obstacles_valid: torch.Tensor,  # [.., K]
             rl_action: torch.Tensor,        # [.., 2] (d_target, v_target),
                                             # already shifted by the symmetry
             rl_q: torch.Tensor,
             rule_q: torch.Tensor,
             cfg: WerlingConfig = WerlingConfig(),
             vcfg: VEGConfig = VEGConfig()) -> VEGPlan:
    """One VEG planning tick (trajectory_update :111-139 +
    generate_VEG_trajectory :224-240; the ITSC variant per
    :class:`VEGConfig`): kick in the RL trajectory iff its Q beats the
    rule's by the variant's threshold, the action is in range and the
    trajectory is feasible; an RL target speed below the emergency-stop
    floor follows that trajectory at speed 0.  For the ITSC variant the
    kicked trajectory is the two-segment chain of
    trajectory_update_withRL_second."""
    out = W.plan_with_rule(rp, ref_line, ego, obstacles, obstacles_valid, cfg)
    rule_traj = W.trajectory_by_index(out.lattice, out.rule_index)

    start = W.start_state_from_ego(ego[..., 0], ego[..., 1], ego[..., 2],
                                   ego[..., 3], ego[..., 4], ref_line)
    if vcfg.s0_lookahead_s:
        # ITSC longitudinal bias: s0 = ffstate.s + c_speed * 1.0
        # (Werling_trajectory.py:202/:219)
        start = start._replace(
            s0=start.s0 + start.c_speed * vcfg.s0_lookahead_s)
    v_cmd = rl_action[..., 1] + vcfg.speed_bias
    rl_xy, rl_speed, rl_feasible, rl_end = plan_rl_kick(
        rp, start, rl_action[..., 0], v_cmd, cfg)

    rule_xy, rule_speed = rule_traj.xy, rule_traj.desired_speed
    if vcfg.second_segment:
        # ITSC continuation: the cheapest feasible (obstacle-free) path
        # planned from the kick segment's end and chained after it (the
        # second frenet_optimal_planning of trajectory_update_withRL_second,
        # with ob=[])
        lat2 = W.plan(rp, rl_end, cfg)
        p2 = torch.argmin(torch.where(lat2.feasible, lat2.cf, torch.inf),
                          dim=-1)
        xy2 = torch.stack([W.path_rows(lat2.x, p2), W.path_rows(lat2.y, p2)],
                          dim=-1)
        speed2 = W.path_rows(lat2.s_d, p2)
        n2 = xy2.shape[-2]
        rl_xy = torch.cat([rl_xy, xy2], dim=-2)
        rl_speed = torch.cat([rl_speed, speed2], dim=-1)
        rule_xy = torch.cat([rule_xy, rule_xy[..., -1:, :].expand(
            rule_xy.shape[:-2] + (n2, 2))], dim=-2)
        rule_speed = torch.cat([rule_speed, rule_speed[..., -1:].expand(
            rule_speed.shape[:-1] + (n2,))], dim=-1)

    in_range = torch.all(torch.abs(rl_action) < ACTION_LIMIT, dim=-1)
    not_stopping = v_cmd >= vcfg.min_speed_rl
    kick = ((rl_q - rule_q) > vcfg.threshold) & in_range & rl_feasible

    # emergency stop: a near-zero RL speed keeps the RL path at speed 0
    # (trajectory_update_RL_kick :125-135; ITSC floor 3/3.6,
    # Werling_trajectory.py:188-189)
    xy = torch.where(kick[..., None, None], rl_xy, rule_xy)
    k1 = kick[..., None]
    speed = torch.where(k1 & not_stopping[..., None], rl_speed,
                        torch.where(k1, torch.zeros_like(rl_speed),
                                    rule_speed))
    return VEGPlan(xy=xy, desired_speed=speed, kicked_in=kick,
                   rule_index=out.rule_index)
