"""Multilane (highway) environment, batch-first (the JAX package's
``env/multilane_env.py``): the field stack's world.

The reference exercises its lane-level stack by replaying rosbags
through cognition into a two-lane ``MapState`` and serving the DQN+RLS
agent over a socket gym (Discrete(8), 20-D state, reward 1 a step, 0 on
collision; gym_routing/envs/cz_dqn.py:30-141).  Here it is a
lane-coordinate highway: IDM traffic on an L-lane road, the ego
commanded by (target_lane, target_speed) decisions at 5 Hz, producing
the ``MultiLaneState`` the decision layer reads.

Every field of the state has the env batch ``B`` leading (``[B]`` or
``[B, K]``), as ``driving_env``'s does.  Resets draw from a
``torch.Generator``; JAX's draws (threefry) can be carried across whole
as a fresh state (``interop.multilane_env_state_from_numpy``) and passed
to :func:`step_autoreset` as ``fresh``.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import torch

from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.planning.idm import pow4
from dcarl_tpu_torch.planning.multilane import (MultiLaneState, lane_vehicles,
                                                nearest_in_lanes)


class MultiLaneEnvConfig(NamedTuple):
    num_lanes: int = 2
    num_vehicles: int = 8
    dt: float = 0.2                  # decision tick (5 Hz)
    road_length: float = 400.0       # distance to the junction/exit
    speed_limit: float = 15.0        # m/s
    lane_change_rate: float = 1.0    # lane-index units / s
    collision_ds: float = 5.0        # longitudinal collision envelope
    collision_dlane: float = 0.5     # lateral collision envelope
    max_steps: int = 200
    target_lane_index: int = 1       # exit lane
    # IDM traffic parameters
    traffic_speed_mean: float = 10.0
    traffic_speed_spread: float = 3.0
    idm_a: float = 1.5
    idm_b: float = 2.0
    idm_t: float = 1.5
    idm_g0: float = 8.0


class MultiLaneEnvState(NamedTuple):
    ego_s: torch.Tensor       # [B]
    ego_lane: torch.Tensor    # [B] continuous
    ego_speed: torch.Tensor   # [B]
    ego_vd: torch.Tensor      # [B] lane-units/s lateral speed
    veh_s: torch.Tensor       # [B, K]
    veh_lane: torch.Tensor    # [B, K]
    veh_speed: torch.Tensor   # [B, K]
    veh_pref: torch.Tensor    # [B, K] preferred speeds
    step_count: torch.Tensor  # [B] i32
    done: torch.Tensor        # [B] bool
    collided: torch.Tensor    # [B] bool
    left_road: torch.Tensor   # [B] bool: passed the exit


def state_from_traffic(veh_s: torch.Tensor, veh_lane: torch.Tensor,
                       veh_pref: torch.Tensor) -> MultiLaneEnvState:
    """Fresh episodes from their traffic draws [B, K]: the ego at s = 0
    in lane 0 at 8 m/s, every vehicle at its preferred speed."""
    b = veh_s.shape[0]
    zero = torch.zeros((b,), dtype=veh_s.dtype, device=veh_s.device)
    zb = torch.zeros((b,), dtype=torch.bool, device=veh_s.device)
    return MultiLaneEnvState(
        ego_s=zero, ego_lane=zero.clone(), ego_speed=torch.full_like(zero, 8.0),
        ego_vd=zero.clone(), veh_s=veh_s, veh_lane=veh_lane,
        veh_speed=veh_pref, veh_pref=veh_pref,
        step_count=torch.zeros((b,), dtype=torch.int32, device=veh_s.device),
        done=zb, collided=zb.clone(), left_road=zb.clone())


def reset(batch: int, generator: torch.Generator,
          cfg: MultiLaneEnvConfig = MultiLaneEnvConfig(),
          dtype: torch.dtype = torch.float32, device=None
          ) -> MultiLaneEnvState:
    """``batch`` fresh episodes: each vehicle's lane uniform in [0, L),
    its position U(-60, 200) and its preferred speed mean +- spread
    (the JAX package's ``reset`` under vmap).  ``generator`` lives on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    k = cfg.num_vehicles

    def uniform(lo, hi):
        u = torch.rand((batch, k), generator=generator, dtype=dtype,
                       device=device)
        return lo + u * (hi - lo)

    veh_lane = torch.randint(0, cfg.num_lanes, (batch, k),
                             generator=generator, device=device).to(dtype)
    veh_s = uniform(-60.0, 200.0)
    veh_pref = cfg.traffic_speed_mean \
        + cfg.traffic_speed_spread * uniform(-1.0, 1.0)
    return state_from_traffic(veh_s, veh_lane, veh_pref)


def to_multilane_state(st: MultiLaneEnvState,
                       cfg: MultiLaneEnvConfig = MultiLaneEnvConfig()
                       ) -> MultiLaneState:
    """The cognition output (MapState.mmap) of the raw sim state: per
    lane the nearest front/rear vehicles relative to the ego."""
    L = cfg.num_lanes
    dtype, dev = st.ego_s.dtype, st.ego_s.device
    b = st.ego_s.shape[0]
    lanes = torch.arange(L, dtype=dtype, device=dev)
    member = torch.abs(st.veh_lane[..., None] - lanes) <= 0.5   # [B, K, L]
    rel_s = st.veh_s - st.ego_s[:, None]
    f_idx, f_ex, r_idx, r_ex = nearest_in_lanes(member, rel_s)
    lanes_b = lanes.expand(b, L)
    no_vd = torch.zeros_like(st.veh_s)      # the sim's traffic keeps its lane
    front = lane_vehicles(f_ex, f_idx, rel_s, st.veh_lane, st.veh_speed,
                          no_vd, lanes_b, True)
    rear = lane_vehicles(r_ex, r_idx, rel_s, st.veh_lane, st.veh_speed,
                         no_vd, lanes_b, False)
    return MultiLaneState(
        ego_lane_index=st.ego_lane, ego_speed=st.ego_speed, ego_vd=st.ego_vd,
        front=front, rear=rear,
        speed_limit=torch.full((b, L), cfg.speed_limit, dtype=dtype,
                               device=dev),
        distance_to_junction=cfg.road_length - st.ego_s,
        target_lane_index=torch.full((b,), float(cfg.target_lane_index),
                                     dtype=dtype, device=dev),
        traffic_light_stop=torch.zeros((b, L), dtype=torch.bool, device=dev),
        stop_distance=torch.full((b, L), 1e6, dtype=dtype, device=dev))


def _idm_traffic(st: MultiLaneEnvState, cfg: MultiLaneEnvConfig
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Traffic follows the nearest leader in its lane (IDM), the ego
    counted as a leader too."""
    all_s = torch.cat([st.veh_s, st.ego_s[:, None]], -1)       # [B, K+1]
    all_lane = torch.cat([st.veh_lane, st.ego_lane[:, None]], -1)
    all_v = torch.cat([st.veh_speed, st.ego_speed[:, None]], -1)
    rel = all_s[:, None, :] - st.veh_s[:, :, None]              # [B, K, K+1]
    same_lane = torch.abs(all_lane[:, None, :] - st.veh_lane[:, :, None]) \
        <= 0.5
    gap_key = torch.where(same_lane & (rel > 0.1), rel, torch.inf)
    leader = torch.argmin(gap_key, dim=-1)                      # [B, K]
    has_leader = torch.isfinite(gap_key.amin(dim=-1))
    gap = torch.where(has_leader,
                      torch.gather(gap_key, -1, leader[..., None])[..., 0],
                      100.0)
    lv = torch.where(has_leader, torch.gather(all_v, -1, leader), st.veh_pref)
    v = st.veh_speed
    g1 = cfg.idm_g0 + cfg.idm_t * v + v * (v - lv) / (
        2.0 * math.sqrt(cfg.idm_a * cfg.idm_b))
    r = g1 / torch.clamp(gap, min=1.0)
    acc = cfg.idm_a * (1.0 - pow4(v / torch.clamp(st.veh_pref, min=0.1))
                       - r * r)
    new_v = torch.clamp(v + acc * cfg.dt, 0.0, 30.0)
    return st.veh_s + new_v * cfg.dt, new_v


def step(st: MultiLaneEnvState, target_lane: torch.Tensor,
         target_speed: torch.Tensor,
         cfg: MultiLaneEnvConfig = MultiLaneEnvConfig()
         ) -> Tuple[MultiLaneEnvState, torch.Tensor, torch.Tensor]:
    """One 0.2 s decision tick -> (state', reward [B], done [B]).  Reward
    1 a surviving step, 0 on collision; an episode ends on collision, on
    leaving the multilane segment or at ``max_steps``."""
    # ego longitudinal: first-order tracking of the commanded speed
    v_cmd = torch.clamp(target_speed, 0.0, 30.0)
    accel = torch.clamp((v_cmd - st.ego_speed) / cfg.dt, -4.0, 2.5)
    ego_speed = torch.clamp(st.ego_speed + accel * cfg.dt, min=0.0)
    ego_s = st.ego_s + ego_speed * cfg.dt
    # ego lateral: slew toward the target lane index
    max_move = cfg.lane_change_rate * cfg.dt
    move = torch.clamp(target_lane.to(st.ego_lane.dtype) - st.ego_lane,
                       -max_move, max_move)
    ego_lane = torch.clamp(st.ego_lane + move, 0.0, cfg.num_lanes - 1.0)
    veh_s, veh_speed = _idm_traffic(st, cfg)
    close_s = torch.abs(veh_s - ego_s[:, None]) < cfg.collision_ds
    close_lane = torch.abs(st.veh_lane - ego_lane[:, None]) \
        < cfg.collision_dlane
    collided = (close_s & close_lane).any(-1)
    left_road = ego_s >= cfg.road_length
    step_count = st.step_count + 1
    done = collided | left_road | (step_count >= cfg.max_steps)
    reward = torch.where(collided, 0.0, 1.0).to(ego_s.dtype)
    new = MultiLaneEnvState(
        ego_s=ego_s, ego_lane=ego_lane, ego_speed=ego_speed,
        ego_vd=move / cfg.dt, veh_s=veh_s, veh_lane=st.veh_lane,
        veh_speed=veh_speed, veh_pref=st.veh_pref, step_count=step_count,
        done=done, collided=collided, left_road=left_road)
    return new, reward, done


def step_autoreset(st: MultiLaneEnvState, target_lane: torch.Tensor,
                   target_speed: torch.Tensor,
                   generator: Optional[torch.Generator],
                   cfg: MultiLaneEnvConfig = MultiLaneEnvConfig(),
                   fresh: Optional[MultiLaneEnvState] = None):
    """:func:`step`, then a fresh episode blended in wherever one ended,
    keeping its outcome flags.  The fresh episodes are drawn from
    ``generator``, or given whole as ``fresh`` (another package's
    draws)."""
    new, reward, done = step(st, target_lane, target_speed, cfg)
    if fresh is None:
        fresh = reset(done.shape[0], generator, cfg, new.ego_s.dtype,
                      new.ego_s.device)

    def blend(a, b):
        return torch.where(done.reshape(done.shape + (1,) * (a.ndim - 1)),
                           b, a)

    blended = MultiLaneEnvState(*(blend(a, b) for a, b in zip(new, fresh)))
    blended = blended._replace(done=done, collided=new.collided,
                               left_road=new.left_road)
    return blended, reward, done
