"""PPO: clipped-surrogate policy optimization, the fork's PPO2
(``dcarl_tpu/algos/ppo.py``).

``ppo2/ppo2.py`` (570 LoC): GAE over a rollout on the device, then E
epochs x M minibatches of the clipped loss over shuffled minibatch
indices.  Discrete and continuous action spaces, MlpPolicy's
categorical / diagonal-Gaussian heads; :func:`ppo1_config` is the PPO1
surface with the learning rate and the clip range annealed.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets


class PPOConfig(NamedTuple):
    n_steps: int = 128
    gamma: float = 0.99
    lam: float = 0.95
    clip_range: float = 0.2
    learning_rate: float = 2.5e-4
    vf_coef: float = 0.5
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5
    n_epochs: int = 4
    n_minibatches: int = 4
    # PPO1 (pposgd_simple.py:50-53, schedule='linear'): anneal both the
    # clip range and the learning rate to 0 over total_updates.
    anneal_updates: int = 0        # 0 = constant (PPO2 default)


def ppo1_config(total_updates: int) -> PPOConfig:
    """The fork's PPO1 surface (pposgd_simple.py:50-53): 256-step actor
    batches, clip 0.2, Adam 1e-3/eps 1e-5, lambda 0.95, 4 optimizer
    epochs, linear annealing, as a PPOConfig."""
    return PPOConfig(n_steps=256, lam=0.95, clip_range=0.2,
                     learning_rate=1e-3, ent_coef=0.01, n_epochs=4,
                     n_minibatches=4, anneal_updates=total_updates)


class PPOState(NamedTuple):
    params: dict
    opt_state: Any
    env_state: Any
    obs: torch.Tensor
    step: torch.Tensor


class PPODraws(NamedTuple):
    rollout: C.RolloutDraws
    perms: torch.Tensor     # [n_epochs, n_steps * B] minibatch shuffles


def make_ppo(env: C.EnvFns, cfg: PPOConfig = PPOConfig(), hidden=(64, 64),
             mesh=None):
    """Returns (init_fn(generator, batch) -> PPOState,
    update_fn(state, generator) -> (state, metrics))."""
    discrete = env.num_actions is not None

    def build(g=None):
        if discrete:
            return nets.CategoricalActorCritic(env.obs_dim, env.num_actions,
                                               hidden, g)
        return nets.GaussianActorCritic(env.obs_dim, env.action_dim, hidden, g)

    net = build()
    if cfg.anneal_updates:
        lr = C.linear_lr_schedule(
            cfg.learning_rate, 0.0,
            cfg.anneal_updates * cfg.n_epochs * cfg.n_minibatches)
    else:
        lr = cfg.learning_rate
    tx = C.chain(C.clip_by_global_norm(cfg.max_grad_norm),
                 C.adam(lr, eps=1e-5))

    def log_prob_value(params, obs, action):
        if discrete:
            logits, value = nets.apply(net, params, obs)
            return (nets.categorical_log_prob(logits, action),
                    nets.categorical_entropy(logits), value)
        mean, log_std, value = nets.apply(net, params, obs)
        return (nets.gaussian_log_prob(mean, log_std, action),
                nets.gaussian_entropy(log_std), value)

    def sample(params, obs, draw):
        if discrete:
            logits, _ = nets.apply(net, params, obs)
            return C.categorical_sample(logits, draw)
        mean, log_std, _ = nets.apply(net, params, obs)
        return mean + torch.exp(log_std) * draw

    def init_fn(generator: torch.Generator, batch: int) -> PPOState:
        params = nets.init_params(build, generator)
        env_state, obs = env.reset(env.draw((batch,), generator))
        return PPOState(params, tx.init(params), env_state, obs,
                        torch.zeros((), dtype=torch.int32,
                                    device=generator.device))

    def minibatch_loss(params, mb, clip):
        obs, action, old_logp, adv, ret = mb
        logp, ent, value = log_prob_value(params, obs, action)
        ratio = torch.exp(logp - old_logp)
        # population std (ddof 0), as jnp.std
        adv_n = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        pg = -torch.mean(torch.minimum(
            ratio * adv_n, torch.clamp(ratio, 1.0 - clip, 1.0 + clip) * adv_n))
        vf = 0.5 * torch.mean((value - ret) ** 2)
        return pg + cfg.vf_coef * vf - cfg.ent_coef * torch.mean(ent), (pg, vf)

    def draw(state: PPOState, generator: torch.Generator) -> PPODraws:
        b = state.obs.shape[0]
        shape = (env.num_actions,) if discrete else (env.action_dim,)
        n = cfg.n_steps * b
        return PPODraws(
            C.rollout_draws(env, cfg.n_steps, b, shape, generator,
                            "gumbel" if discrete else "normal"),
            torch.stack([torch.randperm(n, generator=generator,
                                        device=generator.device)
                         for _ in range(cfg.n_epochs)]))

    def with_draws(state: PPOState, draws: PPODraws):
        if cfg.anneal_updates:
            frac = torch.clamp(1.0 - state.step.to(torch.float32)
                               / cfg.anneal_updates, min=0.0)
        else:
            frac = torch.ones((), device=state.obs.device)
        clip = cfg.clip_range * frac
        env_state, obs, traj = C.collect_rollout(
            env, lambda o, d: sample(state.params, o, d), state.env_state,
            state.obs, draws.rollout)
        with torch.no_grad():
            old_logp, _, values = log_prob_value(state.params, traj.obs,
                                                 traj.action)
            last_value = nets.apply(net, state.params, obs)[-1]
        adv, ret = C.gae(traj.reward, values, traj.done.to(torch.float32),
                         last_value, cfg.gamma, cfg.lam)

        n = cfg.n_steps * traj.reward.shape[1]
        flat = [a.reshape((n,) + a.shape[2:])
                for a in (traj.obs, traj.action, old_logp, adv, ret)]
        mb_size = n // cfg.n_minibatches
        params, opt_state = state.params, state.opt_state
        pgs, vfs = [], []
        for perm in draws.perms:
            for i in range(cfg.n_minibatches):
                sel = perm[i * mb_size:(i + 1) * mb_size]
                mb = [a[sel] for a in flat]
                grads, (pg, vf) = C.grad(minibatch_loss, params, mb, clip,
                                         has_aux=True)
                grads = C.maybe_pmean(grads, mesh)
                updates, opt_state = tx.update(grads, opt_state, params)
                params = C.apply_updates(params, updates)
                pgs.append(pg)
                vfs.append(vf)

        metrics = {"pg_loss": torch.stack(pgs).mean(),
                   "vf_loss": torch.stack(vfs).mean(),
                   "reward_mean": torch.mean(traj.reward)}
        return PPOState(params, opt_state, env_state, obs,
                        state.step + 1), metrics

    def update_fn(state: PPOState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.net = net
    return init_fn, update_fn
