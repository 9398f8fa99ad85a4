"""Lockstep driving environment (the pure-tensor CARLA replacement of
TestScenario_Town03.py:350-426), batch-first.

``reset -> state``, ``wrap_state -> (obs, obs_ori)`` and ``step(action)
-> (state, obs, reward, done, obs_ori)`` with

* a 20-D observation: ego + 3 objects x (x, y, vx, vy, yaw), the objects
  in the ego frame (``wrap_state``, :206-293);
* reward ``sqrt(v) * 0.1`` per tick, -100 on collision, 0 when stuck;
* termination on pass (y < 73.7), stuck (< 0.1 m/s for 2 s), collision
  or timeout; dt = 0.05 s;
* ``action = (acc, steer)``: ``acc`` in [-1, 1] splits into throttle and
  brake (:375-379), ``steer`` is the front-wheel angle of a kinematic
  bicycle.

The port keeps the state as one batched pytree: every field carries the
env batch ``B`` as its leading axis (the JAX package's vmapped
``EnvState``), and ``planning/fast_rollout.py`` transposes it to the
lane-major (batch-last) layout its drivers tick in.  PRNG keys become a
``torch.Generator`` that draws the reset jitter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import EnvConfig
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.env.scenario import Scenario
from dcarl_tpu_torch.ops.geometry import transfer_to_ego_frame


class EnvState(NamedTuple):
    ego: torch.Tensor          # [B, 5] x, y, vx, vy, yaw
    ego_speed: torch.Tensor    # [B]
    vehicles: torch.Tensor     # [B, V, 5]
    walker: torch.Tensor       # [B, 5]
    stuck_steps: torch.Tensor  # [B] i32 consecutive slow ticks
    step_count: torch.Tensor   # [B] i32
    done: torch.Tensor         # [B] bool: episode ended this step
    collided: torch.Tensor     # [B] bool
    passed: torch.Tensor       # [B] bool
    stuck: torch.Tensor        # [B] bool
    episode_return: torch.Tensor  # [B]


class ScenarioArrays(NamedTuple):
    """Device-side copy of the static scenario."""

    vehicle_spawns: torch.Tensor
    vehicle_moving: torch.Tensor
    vehicle_in_state: torch.Tensor
    walker_spawn: torch.Tensor
    ego_spawn: torch.Tensor
    ref_path: torch.Tensor


def scenario_to_device(sc: Scenario, dtype: torch.dtype,
                       device: torch.device) -> ScenarioArrays:
    def f(a):
        return torch.as_tensor(np.asarray(a), dtype=dtype, device=device)

    return ScenarioArrays(
        vehicle_spawns=f(sc.vehicle_spawns),
        vehicle_moving=torch.as_tensor(np.asarray(sc.vehicle_moving),
                                       device=device),
        vehicle_in_state=torch.as_tensor(np.asarray(sc.vehicle_in_state),
                                         device=device),
        walker_spawn=f(sc.walker_spawn),
        ego_spawn=f(sc.ego_spawn),
        ref_path=f(sc.ref_path),
    )


def _uniform(generator: torch.Generator, shape, lo: float, hi: float,
             like: torch.Tensor) -> torch.Tensor:
    """U(lo, hi) draws from ``generator`` (the port's PRNG key)."""
    u = torch.rand(shape, generator=generator, dtype=like.dtype,
                   device=like.device)
    return lo + u * (hi - lo)


def reset(sa: ScenarioArrays, batch: int, generator: torch.Generator,
          cfg: EnvConfig = EnvConfig()) -> EnvState:
    """``batch`` envs at the fixed spawn points with pose jitter drawn
    from ``generator`` (the JAX package's ``reset`` under vmap)."""
    dtype, device = sa.ego_spawn.dtype, sa.ego_spawn.device
    j = cfg.reset_jitter
    v = sa.vehicle_spawns.shape[0]
    ego = sa.ego_spawn[None].repeat(batch, 1)
    vehicles = sa.vehicle_spawns[None].repeat(batch, 1, 1)
    if j:
        ego[:, :2] += _uniform(generator, (batch, 2), -j, j, ego)
        vehicles[:, :, :2] += _uniform(generator, (batch, v, 2), -j, j, ego)
    zero = torch.zeros((batch,), dtype=dtype, device=device)
    zi = torch.zeros((batch,), dtype=torch.int32, device=device)
    zb = torch.zeros((batch,), dtype=torch.bool, device=device)
    return EnvState(
        ego=ego,
        ego_speed=zero,
        vehicles=vehicles,
        walker=sa.walker_spawn[None].repeat(batch, 1),
        stuck_steps=zi,
        step_count=zi.clone(),
        done=zb,
        collided=zb.clone(),
        passed=zb.clone(),
        stuck=zb.clone(),
        episode_return=zero.clone(),
    )


def in_state_indices(sc: Scenario) -> Tuple[int, ...]:
    """Static indices of scripted vehicles exposed in the state."""
    return tuple(int(i) for i in np.where(np.asarray(sc.vehicle_in_state))[0])


def wrap_state(state: EnvState, sa: ScenarioArrays,
               in_state_idx: Tuple[int, ...],
               cfg: EnvConfig = EnvConfig()
               ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(obs, obs_ori) [B, 20]: ego-frame and world-frame observations.

    Objects come walker first, then the in-state vehicles, as the
    reference spawns them (TestScenario_Town03.py:352-357);
    ``in_state_idx`` is the static tuple of :func:`in_state_indices`."""
    ego = state.ego
    b = ego.shape[0]
    objs = torch.cat([state.walker[:, None]]
                     + [state.vehicles[:, i:i + 1] for i in in_state_idx],
                     dim=1)                                   # [B, K, 5]
    state_ori = torch.cat([ego, objs.reshape(b, -1)], dim=1)
    rows = torch.cat([ego[:, None], objs], dim=1)             # [B, K+1, 5]
    ex, ey, eyaw = ego[:, 0, None], ego[:, 1, None], ego[:, 4, None]
    obs = torch.stack(transfer_to_ego_frame(
        rows[..., 0], rows[..., 1], rows[..., 2], rows[..., 3], rows[..., 4],
        ex, ey, eyaw), dim=-1).reshape(b, -1)
    return obs, state_ori


def _step_ego(ego, ego_speed, acc_cmd, steer_cmd, cfg: EnvConfig):
    """Kinematic bicycle with the reference's throttle/brake split
    (:375-379): ego [B, 5], speed and commands [B]."""
    throttle = torch.clamp(acc_cmd, min=0.0)
    brake = torch.clamp(-acc_cmd, min=0.0)
    accel = throttle * cfg.max_accel - brake * cfg.max_brake \
        - 0.05 * ego_speed  # light drag
    v = torch.clamp(ego_speed + accel * cfg.dt, 0.0, 60.0)
    steer = torch.clamp(steer_cmd, -cfg.max_steer, cfg.max_steer)
    yaw = ego[:, 4] + v / cfg.wheelbase * torch.tan(steer) * cfg.dt
    vx = v * torch.cos(yaw)
    vy = v * torch.sin(yaw)
    x = ego[:, 0] + vx * cfg.dt
    y = ego[:, 1] + vy * cfg.dt
    return torch.stack([x, y, vx, vy, yaw], dim=1), v


def _step_traffic(state: EnvState, sa: ScenarioArrays, cfg: EnvConfig):
    """Scripted traffic: autopilot vehicles hold their spawn heading at
    constant speed; the pedestrian walks its heading."""
    veh = state.vehicles
    moving = sa.vehicle_moving[None, :, None]
    new_xy = veh[..., :2] + veh[..., 2:4] * cfg.dt
    veh = torch.cat([torch.where(moving, new_xy, veh[..., :2]), veh[..., 2:]],
                    dim=-1)
    walker = state.walker
    walker = torch.cat([walker[:, :2] + walker[:, 2:4] * cfg.dt, walker[:, 2:]],
                       dim=1)
    return veh, walker


def step(state: EnvState, action: torch.Tensor, sa: ScenarioArrays,
         in_state_idx: Tuple[int, ...], cfg: EnvConfig = EnvConfig()):
    """One tick of every env -> (state', obs, reward, done, obs_ori);
    ``action`` [B, 2].  Reward and termination follow
    TestScenario_Town03.py:399-424."""
    ego, v = _step_ego(state.ego, state.ego_speed, action[:, 0], action[:, 1],
                       cfg)
    vehicles, walker = _step_traffic(state, sa, cfg)

    # collision: a circle check against every actor (the collision sensor)
    actor_xy = torch.cat([vehicles[..., :2], walker[:, None, :2]], dim=1)
    rel = actor_xy - ego[:, None, :2]
    d2 = rel[..., 0] ** 2 + rel[..., 1] ** 2
    collided = torch.any(d2 < cfg.collision_radius ** 2, dim=1)
    if cfg.offroute_dist > 0:
        # road departure counts as a collision: buildings wall the route
        rr = sa.ref_path[None, :, :2] - ego[:, None, :2]
        d2r = torch.amin(rr[..., 0] ** 2 + rr[..., 1] ** 2, dim=1)
        collided = collided | (d2r > cfg.offroute_dist ** 2)

    passed = ego[:, 1] < cfg.pass_line_y
    slow = v < cfg.stuck_speed
    stuck_steps = torch.where(slow, state.stuck_steps + 1, 0).to(torch.int32)
    stuck = stuck_steps > int(cfg.stuck_time / cfg.dt)

    reward = torch.sqrt(v) * cfg.speed_reward_scale \
        + cfg.reward_pass * passed.to(v.dtype)
    reward = torch.where(collided, cfg.reward_collision, reward)
    reward = torch.where(stuck & ~collided, cfg.reward_stuck, reward)

    step_count = state.step_count + 1
    timeout = step_count >= cfg.max_episode_steps
    done = collided | passed | stuck | timeout

    new_state = EnvState(
        ego=ego, ego_speed=v, vehicles=vehicles, walker=walker,
        stuck_steps=stuck_steps, step_count=step_count, done=done,
        collided=collided, passed=passed, stuck=stuck,
        episode_return=state.episode_return + reward)
    obs, obs_ori = wrap_state(new_state, sa, in_state_idx, cfg)
    return new_state, obs, reward, done, obs_ori


def _blend(done: torch.Tensor, fresh: torch.Tensor, old: torch.Tensor):
    return torch.where(done.reshape(done.shape + (1,) * (old.ndim - 1)),
                       fresh, old)


def step_autoreset(state: EnvState, action: torch.Tensor,
                   generator: torch.Generator, sa: ScenarioArrays,
                   in_state_idx: Tuple[int, ...],
                   cfg: EnvConfig = EnvConfig()):
    """:func:`step`, then a fresh reset (jitter from ``generator``)
    blended in wherever an episode ended, keeping that episode's outcome
    flags (SubprocVecEnv's worker auto-reset, subproc_vec_env.py:10-47).
    The observations are those of the blended state."""
    new_state, obs, reward, done, obs_ori = step(state, action, sa,
                                                 in_state_idx, cfg)
    fresh = reset(sa, done.shape[0], generator, cfg)
    blended = EnvState(*(_blend(done, f, a) for a, f in zip(new_state, fresh)))
    blended = blended._replace(done=done, collided=new_state.collided,
                               passed=new_state.passed, stuck=new_state.stuck)
    obs_r, obs_ori_r = wrap_state(blended, sa, in_state_idx, cfg)
    return (blended, _blend(done, obs_r, obs), reward, done,
            _blend(done, obs_ori_r, obs_ori))


def make_vec_env(sc: Scenario, cfg: EnvConfig = EnvConfig(),
                 dtype: torch.dtype = torch.float32,
                 device: "str | torch.device | None" = None):
    """(reset_fn, step_fn) stepping ``B`` envs in lockstep, the
    DummyVecEnv/SubprocVecEnv equivalent:

      reset_fn(batch, generator)            -> (states, obs [B, 20],
                                                obs_ori [B, 20])
      step_fn(states, actions [B, 2], generator)
                                            -> (states, obs, reward, done,
                                                obs_ori)

    ``generator`` draws the reset jitter where the JAX package takes
    ``keys[B]``.  ``device=None`` runs on ``cuda`` (which must exist)."""
    device = resolve_device(device)
    sa = scenario_to_device(sc, dtype, device)
    idx = in_state_indices(sc)

    def reset_fn(batch: int, generator: torch.Generator):
        states = reset(sa, batch, generator, cfg)
        obs, obs_ori = wrap_state(states, sa, idx, cfg)
        return states, obs, obs_ori

    def step_fn(states: EnvState, actions: torch.Tensor,
                generator: torch.Generator):
        return step_autoreset(states, actions, generator, sa, idx, cfg)

    return reset_fn, step_fn
