"""A2C: synchronous advantage actor-critic (``dcarl_tpu/algos/a2c.py``).

The SB fork's ``a2c/a2c.py`` (379 LoC): n-step rollouts from B parallel
envs, policy-gradient + value + entropy loss, RMSprop (decay 0.99, eps
1e-5) behind a global-norm clip.  The SubprocVecEnv worker pool becomes
a batched env on the device; data parallelism is one gradient
all-reduce over ``mesh``.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets


class A2CConfig(NamedTuple):
    n_steps: int = 5
    gamma: float = 0.99
    learning_rate: float = 7e-4
    vf_coef: float = 0.25       # a2c.py defaults
    ent_coef: float = 0.01
    max_grad_norm: float = 0.5


class A2CState(NamedTuple):
    params: dict
    opt_state: Any
    env_state: Any
    obs: torch.Tensor
    step: torch.Tensor


class A2CDraws(NamedTuple):
    rollout: C.RolloutDraws


def make_a2c(env: C.EnvFns, cfg: A2CConfig = A2CConfig(), hidden=(64, 64),
             mesh=None):
    """Returns (init_fn(generator, batch) -> A2CState,
    update_fn(state, generator) -> (state, metrics))."""

    def build(g=None):
        return nets.CategoricalActorCritic(env.obs_dim, env.num_actions,
                                           hidden, g)

    net = build()
    tx = C.chain(C.clip_by_global_norm(cfg.max_grad_norm),
                 C.rmsprop(cfg.learning_rate, decay=0.99, eps=1e-5))

    def init_fn(generator: torch.Generator, batch: int) -> A2CState:
        params = nets.init_params(build, generator)
        env_state, obs = env.reset(env.draw((batch,), generator))
        return A2CState(params, tx.init(params), env_state, obs,
                        torch.zeros((), dtype=torch.int32,
                                    device=generator.device))

    def loss_fn(params, traj, returns):
        logits, values = nets.apply(net, params, traj.obs)
        logp = nets.categorical_log_prob(logits, traj.action)
        adv = returns - values
        pg_loss = -torch.mean(logp * adv.detach())
        vf_loss = torch.mean(adv ** 2)
        ent = torch.mean(nets.categorical_entropy(logits))
        loss = pg_loss + cfg.vf_coef * vf_loss - cfg.ent_coef * ent
        return loss, (pg_loss, vf_loss, ent)

    def draw(state: A2CState, generator: torch.Generator) -> A2CDraws:
        return A2CDraws(C.rollout_draws(env, cfg.n_steps, state.obs.shape[0],
                                        (env.num_actions,), generator))

    def with_draws(state: A2CState, draws: A2CDraws):
        def policy(obs, g):
            logits, _ = nets.apply(net, state.params, obs)
            return C.categorical_sample(logits, g)

        env_state, obs, traj = C.collect_rollout(
            env, policy, state.env_state, state.obs, draws.rollout)
        with torch.no_grad():
            _, last_value = nets.apply(net, state.params, obs)
        returns = C.discounted_returns(traj.reward,
                                       traj.done.to(torch.float32),
                                       last_value, cfg.gamma)
        grads, aux = C.grad(loss_fn, state.params, traj, returns,
                            has_aux=True)
        grads = C.maybe_pmean(grads, mesh)
        updates, opt_state = tx.update(grads, state.opt_state, state.params)
        params = C.apply_updates(state.params, updates)
        metrics = {"pg_loss": aux[0], "vf_loss": aux[1], "entropy": aux[2],
                   "reward_mean": torch.mean(traj.reward)}
        return A2CState(params, opt_state, env_state, obs,
                        state.step + 1), metrics

    def update_fn(state: A2CState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.net = net
    return init_fn, update_fn
