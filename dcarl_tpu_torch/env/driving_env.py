"""Lockstep driving environment state and reset (the pure-tensor CARLA
replacement of TestScenario_Town03.py).

The port keeps the state as one batched pytree: every field carries the
env batch ``B`` as its leading axis here (the JAX package's vmapped
``EnvState``), and ``planning/fast_rollout.py`` transposes it to the
lane-major (batch-last) layout its driver ticks in.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import EnvConfig
from dcarl_tpu_torch.env.scenario import Scenario


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
