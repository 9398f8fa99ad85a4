"""SAC: soft actor-critic with automatic temperature
(``dcarl_tpu/algos/sac.py``).

The fork's ``sac/sac.py`` (565 LoC): a tanh-squashed Gaussian actor,
twin soft critics, and the auto-tuned entropy temperature
(``ent_coef='auto'``, target entropy = -|A|, sac.py setup_model) with
its own Adam on ``log_alpha``.  The squashed samples' unit normals are
draws.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets
from dcarl_tpu_torch.algos.ddpg import OffPolicyDraws, off_policy_draws
from dcarl_tpu_torch.models import replay as RB


class SACConfig(NamedTuple):
    gamma: float = 0.99
    tau: float = 0.005
    lr: float = 3e-4
    batch_size: int = 128
    replay_capacity: int = 50_000
    train_start: int = 100


class SACState(NamedTuple):
    actor_params: dict
    critic_params: dict
    target_critic: dict
    log_alpha: torch.Tensor
    actor_opt: Any
    critic_opt: Any
    alpha_opt: Any
    replay: RB.Replay
    env_state: Any
    obs: torch.Tensor
    step: torch.Tensor


class SACDraws(NamedTuple):
    step: OffPolicyDraws          # action_noise: the behaviour sample's eps
    critic_eps: torch.Tensor      # [batch_size, A]
    actor_eps: torch.Tensor       # [batch_size, A]


def make_sac(env: C.EnvFns, cfg: SACConfig = SACConfig(), hidden=(64, 64),
             mesh=None):
    """Returns (init_fn(generator, batch) -> SACState, update_fn(state,
    generator) -> (state, metrics), act_fn(state, obs, eps=None) ->
    action, deterministic ``tanh(mean)`` without ``eps``)."""

    def build_actor(g=None):
        return nets.SquashedGaussianActor(env.obs_dim, env.action_dim,
                                          hidden, g)

    def build_critic(g=None):
        return nets.TwinQCritic(env.obs_dim, env.action_dim, hidden, g)

    actor, critic = build_actor(), build_critic()
    target_entropy = -float(env.action_dim)  # sac.py 'auto' default
    atx = C.adam(cfg.lr)
    ctx = C.adam(cfg.lr)
    altx = C.adam(cfg.lr)

    def init_fn(generator: torch.Generator, batch: int) -> SACState:
        dev = generator.device
        ap = nets.init_params(build_actor, generator)
        cp = nets.init_params(build_critic, generator)
        log_alpha = torch.zeros((), device=dev)
        env_state, obs = env.reset(env.draw((batch,), generator))
        rb = RB.replay_init(cfg.replay_capacity, env.obs_dim, device=dev,
                            action_shape=(env.action_dim,))
        return SACState(ap, cp, cp, log_alpha, atx.init(ap), ctx.init(cp),
                        altx.init(log_alpha), rb, env_state, obs,
                        torch.zeros((), dtype=torch.int32, device=dev))

    def critic_loss(cp, state: SACState, batch: RB.Batch, eps):
        with torch.no_grad():
            mean, log_std = nets.apply(actor, state.actor_params,
                                       batch.next_obs)
            next_a, next_logp = nets.squashed_sample(mean, log_std, eps)
            tq1, tq2 = nets.apply(critic, state.target_critic,
                                  batch.next_obs, next_a)
            alpha = torch.exp(state.log_alpha)
            soft_v = torch.minimum(tq1, tq2) - alpha * next_logp
            y = batch.reward + cfg.gamma * (1.0 - batch.done) * soft_v
        q1, q2 = nets.apply(critic, cp, batch.obs, batch.action)
        return torch.mean((q1 - y) ** 2) + torch.mean((q2 - y) ** 2)

    def actor_loss(ap, state: SACState, batch: RB.Batch, eps):
        mean, log_std = nets.apply(actor, ap, batch.obs)
        a, logp = nets.squashed_sample(mean, log_std, eps)
        q1, q2 = nets.apply(critic, state.critic_params, batch.obs, a)
        alpha = torch.exp(state.log_alpha)
        return torch.mean(alpha * logp - torch.minimum(q1, q2)), logp

    def alpha_loss(log_alpha, logp):
        return -torch.mean(log_alpha * (logp + target_entropy).detach())

    def draw(state: SACState, generator: torch.Generator) -> SACDraws:
        step = off_policy_draws(env, state.replay, state.obs, cfg.batch_size,
                                generator)
        shape = (cfg.batch_size, env.action_dim)
        return SACDraws(step, C.normal(shape, generator),
                        C.normal(shape, generator))

    def with_draws(state: SACState, draws: SACDraws):
        d = draws.step
        with torch.no_grad():
            mean, log_std = nets.apply(actor, state.actor_params, state.obs)
            a, _ = nets.squashed_sample(mean, log_std, d.action_noise)
            env_state, next_obs, rew, done = env.step(state.env_state, a,
                                                      d.env)
        rb = RB.replay_push(state.replay, state.obs, a, rew, next_obs,
                            done.to(torch.float32))
        mb = RB.replay_take(rb, d.indices)
        ready = rb.size >= cfg.train_start

        cg = C.grad(critic_loss, state.critic_params, state, mb,
                    draws.critic_eps)
        ag, logp = C.grad(actor_loss, state.actor_params, state, mb,
                          draws.actor_eps, has_aux=True)
        alg = C.grad(alpha_loss, state.log_alpha, logp)
        cg, ag, alg = (C.maybe_pmean(g, mesh) for g in (cg, ag, alg))
        cg, ag, alg = C.tree_map(lambda g: torch.where(ready, g, 0.0),
                                 (cg, ag, alg))

        cu, copt = ctx.update(cg, state.critic_opt, state.critic_params)
        cp = C.apply_updates(state.critic_params, cu)
        au, aopt = atx.update(ag, state.actor_opt, state.actor_params)
        ap = C.apply_updates(state.actor_params, au)
        alu, alopt = altx.update(alg, state.alpha_opt, state.log_alpha)
        log_alpha = C.apply_updates(state.log_alpha, alu)

        metrics = {"reward_mean": torch.mean(rew),
                   "alpha": torch.exp(log_alpha),
                   "replay_size": rb.size.to(torch.float32)}
        return SACState(
            ap, cp, C.polyak(state.target_critic, cp, cfg.tau), log_alpha,
            aopt, copt, alopt, rb, env_state, next_obs,
            state.step + 1), metrics

    def update_fn(state: SACState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    def act_fn(state: SACState, obs, eps=None):
        with torch.no_grad():
            mean, log_std = nets.apply(actor, state.actor_params, obs)
            if eps is None:
                return torch.tanh(mean)  # deterministic eval
            return nets.squashed_sample(mean, log_std, eps)[0]

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.actor, update_fn.critic = actor, critic
    return init_fn, update_fn, act_fn
