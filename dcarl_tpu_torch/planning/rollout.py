"""Closed-loop rollout, batch-first: env -> Werling planner -> controller
-> env (the JAX package's readable ``planning/rollout.py``; the
reference's value-collection driver,
Data_From_Carla/Agent/drl_library/dqn/dqn_value_collect.py:53-146).

* Every tick the planner builds the candidate lattice and the rule pick,
  and the controller tracks the chosen trajectory.
* The collector locks, once per episode when the ego first crosses
  ``TRIGGER_Y`` (obs y < 90, :96-101), the round-robin candidate
  ``used_action`` (brake, then every lattice path, across episodes) and
  follows that trajectory to the episode's end.
* At the episode's end it records {triggered state, action, episode
  return} (collected_data.txt, :128-137) and rotates the action
  (:144-145).

This is the readable account of the tick that ``fast_rollout.py`` lays
out lane-major for speed.  The JAX ``vmap(scan)`` becomes a Python step
loop over batch-first tensors; the records come back [B, S], as the JAX
driver returns them.  PRNG keys become a ``torch.Generator`` that draws
the auto-reset jitter.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import EnvConfig, WerlingConfig
from dcarl_tpu_torch.control.controller import get_control
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.env import driving_env as de
from dcarl_tpu_torch.env.scenario import Scenario
from dcarl_tpu_torch.ops import spline as spl
from dcarl_tpu_torch.planning import werling as W

TRIGGER_Y = 90.0


class RolloutCarry(NamedTuple):
    env: de.EnvState
    triggered: torch.Tensor       # [B] bool: action locked this episode
    locked_xy: torch.Tensor       # [B, T, 2] locked trajectory
    locked_speed: torch.Tensor    # [B, T]
    recorded_state: torch.Tensor  # [B, 20] obs_ori at trigger time
    used_action: torch.Tensor     # [B] i32 current round-robin candidate
    obs_ori: torch.Tensor         # [B, 20]


class StepRecord(NamedTuple):
    done: torch.Tensor            # [B, S] (per tick: [B])
    collided: torch.Tensor
    passed: torch.Tensor
    recorded_state: torch.Tensor  # [B, S, 20]
    used_action: torch.Tensor     # i32
    episode_return: torch.Tensor
    reward: torch.Tensor
    rule_index: torch.Tensor      # i64


def _obstacles_from_obs_ori(obs_ori: torch.Tensor
                            ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The reference's DynamicMap takes only (x, y, vx, vy) per object
    and leaves yaw at 0 (dynamic_map.py:94-106), so the prediction's
    circle offsets use yaw = 0."""
    objs = obs_ori[..., 5:].reshape(obs_ori.shape[:-1] + (-1, 5))
    obstacles = torch.cat([objs[..., :4], torch.zeros_like(objs[..., 4:])],
                          dim=-1)
    valid = torch.ones(objs.shape[:-1], dtype=torch.bool, device=objs.device)
    return obstacles, valid


def _setup(sc: Scenario, dtype: torch.dtype, device):
    """Device, scenario arrays, in-state indices, the reference line and
    its spline (fitted on the host in ``dtype``, as the JAX package fits
    it, then moved to the device)."""
    device = resolve_device(device)
    if dtype not in (torch.float32, torch.float64):
        raise TypeError(f"dtype must be float32 or float64, got {dtype}")
    sa = de.scenario_to_device(sc, dtype, device)
    idx = de.in_state_indices(sc)
    line = torch.as_tensor(np.asarray(sc.ref_path), dtype=dtype)
    rp = spl.refpath_to(spl.refpath_from_xy(line[:, 0], line[:, 1]), device)
    return device, sa, idx, line.to(device), rp


def _control(obs_ori: torch.Tensor, xy: torch.Tensor, speed: torch.Tensor
             ) -> torch.Tensor:
    """[B, 2] (acc, steer) tracking ``xy`` [B, T, 2] at ``speed`` [B, T]."""
    ego = obs_ori[:, :5]
    ego_v = torch.sqrt(ego[:, 2] ** 2 + ego[:, 3] ** 2)
    ctrl = get_control(ego[:, 0], ego[:, 1], ego[:, 4], ego_v, xy, speed)
    return torch.stack([ctrl.acc, ctrl.steering], dim=1)


def make_collector(sc: Scenario, env_cfg: EnvConfig = EnvConfig(),
                   wcfg: WerlingConfig = WerlingConfig(),
                   dtype: torch.dtype = torch.float32,
                   device: "str | torch.device | None" = None):
    """The batched value collector.  Returns (init_fn, run_fn):

      init_fn(batch, generator)          -> RolloutCarry
      run_fn(carry, n_steps, generator)  -> (carry, StepRecord), each
                                            field [B, S, ...]

    ``device=None`` runs on ``cuda`` (which must exist)."""
    device, sa, idx, ref_line, rp = _setup(sc, dtype, device)
    n_t = wcfg.n_time_steps
    n_actions = wcfg.num_paths + 1

    def one_step(carry: RolloutCarry, generator: torch.Generator):
        obs_ori = carry.obs_ori
        obstacles, valid = _obstacles_from_obs_ori(obs_ori)
        out = W.plan_with_rule(rp, ref_line, obs_ori[:, :5], obstacles, valid,
                               wcfg)

        # trigger: lock the round-robin candidate once y < TRIGGER_Y
        # (dqn_value_collect.py:96-101)
        trigger_now = (~carry.triggered) & (obs_ori[:, 1] < TRIGGER_Y)
        hrl = W.trajectory_by_index(out.lattice, carry.used_action)
        rule = W.trajectory_by_index(out.lattice, out.rule_index)
        now = trigger_now[:, None]
        locked_xy = torch.where(now[..., None], hrl.xy, carry.locked_xy)
        locked_speed = torch.where(now, hrl.desired_speed, carry.locked_speed)
        recorded_state = torch.where(now, obs_ori, carry.recorded_state)
        triggered = carry.triggered | trigger_now

        held = triggered[:, None]
        follow_xy = torch.where(held[..., None], locked_xy, rule.xy)
        follow_speed = torch.where(held, locked_speed, rule.desired_speed)
        action = _control(obs_ori, follow_xy, follow_speed)

        return_before = carry.env.episode_return
        env, _, reward, done, new_obs_ori = de.step_autoreset(
            carry.env, action, generator, sa, idx, env_cfg)
        record = StepRecord(
            done=done, collided=env.collided, passed=env.passed,
            recorded_state=recorded_state, used_action=carry.used_action,
            episode_return=return_before + reward, reward=reward,
            rule_index=out.rule_index)

        # episode end: rotate the candidate over the num_paths + 1 choices
        # (dqn_value_collect.py:144-145)
        used_action = torch.where(done, (carry.used_action + 1) % n_actions,
                                  carry.used_action).to(torch.int32)
        triggered = torch.where(done, False, triggered)
        return RolloutCarry(env=env, triggered=triggered, locked_xy=locked_xy,
                            locked_speed=locked_speed,
                            recorded_state=recorded_state,
                            used_action=used_action,
                            obs_ori=new_obs_ori), record

    def init_fn(batch: int, generator: torch.Generator) -> RolloutCarry:
        env0 = de.reset(sa, batch, generator, env_cfg)
        _, obs_ori = de.wrap_state(env0, sa, idx, env_cfg)
        return RolloutCarry(
            env=env0,
            triggered=torch.zeros((batch,), dtype=torch.bool, device=device),
            locked_xy=torch.zeros((batch, n_t, 2), dtype=dtype, device=device),
            locked_speed=torch.zeros((batch, n_t), dtype=dtype, device=device),
            recorded_state=torch.zeros((batch, env_cfg.state_dim), dtype=dtype,
                                       device=device),
            used_action=torch.zeros((batch,), dtype=torch.int32,
                                    device=device),
            obs_ori=obs_ori)

    def run_fn(carry: RolloutCarry, n_steps: int, generator: torch.Generator):
        recs = []
        for _ in range(n_steps):
            carry, rec = one_step(carry, generator)
            recs.append(rec)
        return carry, StepRecord(*(torch.stack(f, dim=1) for f in zip(*recs)))

    return init_fn, run_fn


def make_rule_driver(sc: Scenario, env_cfg: EnvConfig = EnvConfig(),
                     wcfg: WerlingConfig = WerlingConfig(),
                     dtype: torch.dtype = torch.float32,
                     device: "str | torch.device | None" = None):
    """The pure rule-policy driver: every tick follow the planner's rule
    pick.  Returns (init_fn, run_fn):

      init_fn(batch, generator)          -> (EnvState, obs_ori [B, 20])
      run_fn(carry, n_steps, generator)  -> (carry, (reward, done, passed,
                                            collided)), each [B, S]

    ``device=None`` runs on ``cuda`` (which must exist)."""
    device, sa, idx, ref_line, rp = _setup(sc, dtype, device)

    def one_step(carry, generator: torch.Generator):
        env, obs_ori = carry
        obstacles, valid = _obstacles_from_obs_ori(obs_ori)
        out = W.plan_with_rule(rp, ref_line, obs_ori[:, :5], obstacles, valid,
                               wcfg)
        traj = W.trajectory_by_index(out.lattice, out.rule_index)
        action = _control(obs_ori, traj.xy, traj.desired_speed)
        env, _, reward, done, obs_ori = de.step_autoreset(
            env, action, generator, sa, idx, env_cfg)
        return (env, obs_ori), (reward, done, env.passed, env.collided)

    def init_fn(batch: int, generator: torch.Generator):
        env0 = de.reset(sa, batch, generator, env_cfg)
        _, obs_ori = de.wrap_state(env0, sa, idx, env_cfg)
        return env0, obs_ori

    def run_fn(carry, n_steps: int, generator: torch.Generator):
        outs = []
        for _ in range(n_steps):
            carry, o = one_step(carry, generator)
            outs.append(o)
        return carry, tuple(torch.stack(f, dim=1) for f in zip(*outs))

    return init_fn, run_fn
