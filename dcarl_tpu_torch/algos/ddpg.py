"""DDPG: deep deterministic policy gradient (``dcarl_tpu/algos/ddpg.py``).

The fork's ``ddpg/ddpg.py`` (1,214 LoC): actor and critic with target
networks, Gaussian action noise, a uniform replay on the device
(``models/replay.py``).  The fork's MpiAdam gradient Allreduce
(mpi_adam.py:51) is an all-reduce over ``mesh``; its parameter-noise and
popart variants are left out (off by default in the reference's usage).
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets
from dcarl_tpu_torch.models import replay as RB


class DDPGConfig(NamedTuple):
    gamma: float = 0.99
    tau: float = 0.001               # ddpg.py default
    actor_lr: float = 1e-4
    critic_lr: float = 1e-3
    action_noise: float = 0.1
    batch_size: int = 128
    replay_capacity: int = 50_000
    train_start: int = 100


class DDPGState(NamedTuple):
    actor_params: dict
    critic_params: dict
    target_actor: dict
    target_critic: dict
    actor_opt: Any
    critic_opt: Any
    replay: RB.Replay
    env_state: Any
    obs: torch.Tensor
    step: torch.Tensor


class OffPolicyDraws(NamedTuple):
    """One off-policy update's draws: the behaviour noise (Gaussian for
    DDPG/TD3, the squashed Gaussian's unit normals for SAC), the env's
    step draws and the replay sample's indices."""

    action_noise: torch.Tensor    # [B, A]
    env: Any                      # [B, ...]
    indices: torch.Tensor         # [batch_size]


def off_policy_draws(env: C.EnvFns, replay: RB.Replay, obs: torch.Tensor,
                     batch_size: int, generator: torch.Generator
                     ) -> OffPolicyDraws:
    """Uniform indices over the replay as it stands after this update's
    push of ``obs.shape[0]`` rows (its size stays on the device)."""
    b = obs.shape[0]
    size_after = torch.clamp(replay.size + b, max=replay.obs.shape[0])
    return OffPolicyDraws(C.normal((b, env.action_dim), generator),
                          env.draw((b,), generator),
                          C.below(size_after, (batch_size,), generator))


def make_ddpg(env: C.EnvFns, cfg: DDPGConfig = DDPGConfig(), hidden=(64, 64),
              mesh=None):
    """Returns (init_fn(generator, batch) -> DDPGState, update_fn(state,
    generator) -> (state, metrics), act_fn(state, obs) -> action)."""

    def build_actor(g=None):
        return nets.DeterministicActor(env.obs_dim, env.action_dim, hidden, g)

    def build_critic(g=None):
        return nets.QCritic(env.obs_dim, env.action_dim, hidden, g)

    actor, critic = build_actor(), build_critic()
    atx = C.adam(cfg.actor_lr)
    ctx = C.adam(cfg.critic_lr)

    def init_fn(generator: torch.Generator, batch: int) -> DDPGState:
        ap = nets.init_params(build_actor, generator)
        cp = nets.init_params(build_critic, generator)
        env_state, obs = env.reset(env.draw((batch,), generator))
        rb = RB.replay_init(cfg.replay_capacity, env.obs_dim,
                            device=generator.device,
                            action_shape=(env.action_dim,))
        return DDPGState(ap, cp, ap, cp, atx.init(ap), ctx.init(cp), rb,
                         env_state, obs,
                         torch.zeros((), dtype=torch.int32,
                                     device=generator.device))

    def critic_loss(cp, state: DDPGState, batch: RB.Batch):
        with torch.no_grad():
            next_a = nets.apply(actor, state.target_actor, batch.next_obs)
            target_q = nets.apply(critic, state.target_critic,
                                  batch.next_obs, next_a)
            y = batch.reward + cfg.gamma * (1.0 - batch.done) * target_q
        q = nets.apply(critic, cp, batch.obs, batch.action)
        return torch.mean((q - y) ** 2)

    def actor_loss(ap, cp, batch: RB.Batch):
        return -torch.mean(nets.apply(critic, cp, batch.obs,
                                      nets.apply(actor, ap, batch.obs)))

    def draw(state: DDPGState, generator: torch.Generator) -> OffPolicyDraws:
        return off_policy_draws(env, state.replay, state.obs, cfg.batch_size,
                                generator)

    def with_draws(state: DDPGState, draws: OffPolicyDraws):
        with torch.no_grad():
            a = nets.apply(actor, state.actor_params, state.obs)
            a = torch.clamp(a + cfg.action_noise * draws.action_noise,
                            -1.0, 1.0)
            env_state, next_obs, rew, done = env.step(state.env_state, a,
                                                      draws.env)
        rb = RB.replay_push(state.replay, state.obs, a, rew, next_obs,
                            done.to(torch.float32))
        mb = RB.replay_take(rb, draws.indices)
        cg = C.grad(critic_loss, state.critic_params, state, mb)
        ag = C.grad(actor_loss, state.actor_params, state.critic_params, mb)
        cg = C.maybe_pmean(cg, mesh)
        ag = C.maybe_pmean(ag, mesh)

        ready = rb.size >= cfg.train_start
        cg, ag = C.tree_map(lambda g: torch.where(ready, g, 0.0), (cg, ag))
        cu, copt = ctx.update(cg, state.critic_opt, state.critic_params)
        cp = C.apply_updates(state.critic_params, cu)
        au, aopt = atx.update(ag, state.actor_opt, state.actor_params)
        ap = C.apply_updates(state.actor_params, au)

        metrics = {"reward_mean": torch.mean(rew),
                   "replay_size": rb.size.to(torch.float32)}
        return DDPGState(
            ap, cp, C.polyak(state.target_actor, ap, cfg.tau),
            C.polyak(state.target_critic, cp, cfg.tau), aopt, copt, rb,
            env_state, next_obs, state.step + 1), metrics

    def update_fn(state: DDPGState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    def act_fn(state: DDPGState, obs):
        with torch.no_grad():
            return nets.apply(actor, state.actor_params, obs)

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.actor, update_fn.critic = actor, critic
    return init_fn, update_fn, act_fn
