"""TD3: twin-delayed DDPG (``dcarl_tpu/algos/td3.py``).

The fork's ``td3/td3.py`` (482 LoC): twin critics with a min target,
target-policy smoothing noise (a draw), delayed actor updates.  The
delay is a ``torch.where`` gate on the actor gradient and the target
rate, as in the JAX package, so no step reads the device on the host.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets
from dcarl_tpu_torch.algos.ddpg import OffPolicyDraws, off_policy_draws
from dcarl_tpu_torch.models import replay as RB


class TD3Config(NamedTuple):
    gamma: float = 0.99
    tau: float = 0.005               # td3.py defaults
    actor_lr: float = 3e-4
    critic_lr: float = 3e-4
    action_noise: float = 0.1
    target_noise: float = 0.2        # target_policy_noise
    noise_clip: float = 0.5          # target_noise_clip
    policy_delay: int = 2
    batch_size: int = 128
    replay_capacity: int = 50_000
    train_start: int = 100


class TD3State(NamedTuple):
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


class TD3Draws(NamedTuple):
    step: OffPolicyDraws
    target_noise: torch.Tensor    # [batch_size, A] unit normals


def make_td3(env: C.EnvFns, cfg: TD3Config = TD3Config(), hidden=(64, 64),
             mesh=None):
    """Returns (init_fn(generator, batch) -> TD3State, update_fn(state,
    generator) -> (state, metrics), act_fn(state, obs) -> action)."""

    def build_actor(g=None):
        return nets.DeterministicActor(env.obs_dim, env.action_dim, hidden, g)

    def build_critic(g=None):
        return nets.TwinQCritic(env.obs_dim, env.action_dim, hidden, g)

    actor, critic = build_actor(), build_critic()
    atx = C.adam(cfg.actor_lr)
    ctx = C.adam(cfg.critic_lr)

    def init_fn(generator: torch.Generator, batch: int) -> TD3State:
        ap = nets.init_params(build_actor, generator)
        cp = nets.init_params(build_critic, generator)
        env_state, obs = env.reset(env.draw((batch,), generator))
        rb = RB.replay_init(cfg.replay_capacity, env.obs_dim,
                            device=generator.device,
                            action_shape=(env.action_dim,))
        return TD3State(ap, cp, ap, cp, atx.init(ap), ctx.init(cp), rb,
                        env_state, obs,
                        torch.zeros((), dtype=torch.int32,
                                    device=generator.device))

    def critic_loss(cp, state: TD3State, batch: RB.Batch, noise_draw):
        with torch.no_grad():
            noise = torch.clamp(cfg.target_noise * noise_draw,
                                -cfg.noise_clip, cfg.noise_clip)
            next_a = torch.clamp(nets.apply(actor, state.target_actor,
                                            batch.next_obs) + noise, -1.0, 1.0)
            tq1, tq2 = nets.apply(critic, state.target_critic,
                                  batch.next_obs, next_a)
            y = batch.reward + cfg.gamma * (1.0 - batch.done) \
                * torch.minimum(tq1, tq2)
        q1, q2 = nets.apply(critic, cp, batch.obs, batch.action)
        return torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)

    def actor_loss(ap, cp, batch: RB.Batch):
        q1, _ = nets.apply(critic, cp, batch.obs,
                           nets.apply(actor, ap, batch.obs))
        return -torch.mean(q1)

    def draw(state: TD3State, generator: torch.Generator) -> TD3Draws:
        step = off_policy_draws(env, state.replay, state.obs, cfg.batch_size,
                                generator)
        return TD3Draws(step, C.normal((cfg.batch_size, env.action_dim),
                                       generator))

    def with_draws(state: TD3State, draws: TD3Draws):
        d = draws.step
        with torch.no_grad():
            a = nets.apply(actor, state.actor_params, state.obs)
            a = torch.clamp(a + cfg.action_noise * d.action_noise, -1.0, 1.0)
            env_state, next_obs, rew, done = env.step(state.env_state, a,
                                                      d.env)
        rb = RB.replay_push(state.replay, state.obs, a, rew, next_obs,
                            done.to(torch.float32))
        mb = RB.replay_take(rb, d.indices)
        ready = rb.size >= cfg.train_start
        delayed = ready & (state.step % cfg.policy_delay == 0)

        cg = C.grad(critic_loss, state.critic_params, state, mb,
                    draws.target_noise)
        ag = C.grad(actor_loss, state.actor_params, state.critic_params, mb)
        cg = C.maybe_pmean(cg, mesh)
        ag = C.maybe_pmean(ag, mesh)
        cg = C.tree_map(lambda g: torch.where(ready, g, 0.0), cg)
        ag = C.tree_map(lambda g: torch.where(delayed, g, 0.0), ag)

        cu, copt = ctx.update(cg, state.critic_opt, state.critic_params)
        cp = C.apply_updates(state.critic_params, cu)
        au, aopt = atx.update(ag, state.actor_opt, state.actor_params)
        ap = C.apply_updates(state.actor_params, au)

        tau_a = torch.where(delayed, cfg.tau, 0.0)
        metrics = {"reward_mean": torch.mean(rew),
                   "replay_size": rb.size.to(torch.float32)}
        return TD3State(
            ap, cp, C.polyak(state.target_actor, ap, tau_a),
            C.polyak(state.target_critic, cp, tau_a), aopt, copt, rb,
            env_state, next_obs, state.step + 1), metrics

    def update_fn(state: TD3State, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    def act_fn(state: TD3State, obs):
        with torch.no_grad():
            return nets.apply(actor, state.actor_params, obs)

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.actor, update_fn.critic = actor, critic
    return init_fn, update_fn, act_fn
