"""GAIL: generative adversarial imitation learning
(``dcarl_tpu/algos/gail.py``).

The SB fork's ``gail/model.py`` + ``gail/adversary.py``: a transition
discriminator D(s, a) trained to separate expert transitions from the
generator's, whose ``-log(1 - D)`` output replaces the environment
reward for a TRPO generator.

* adversary net: 2 x tanh hidden (``hidden_size_adversary=100``) -> 1
  logit over concat(normalized obs, one-hot action)
  (adversary.py build_graph);
* discriminator loss: sigmoid cross-entropy (generator label 0, expert
  label 1) minus ``adversary_entcoeff=1e-3`` times the logit-Bernoulli
  entropy (adversary.py:83-97);
* reward: ``-log(1 - sigmoid(logit) + 1e-8)`` (adversary.py:99);
* schedule: ``g_step=3`` generator (TRPO) updates per ``d_step=1``
  discriminator update (model.py:35-46);
* obs normalization: the adversary's RunningMeanStd obfilter is a
  :class:`~dcarl_tpu_torch.parallel.normalize.RunningMeanStd` in the
  state, on the state's device.

The expert dataset (``gail/dataset``) is a pair of tensors
``(expert_obs[N, obs], expert_act[N])``; minibatches are uniform
gathers at drawn indices.
"""

from __future__ import annotations

from typing import Any, List, NamedTuple

import torch
from torch import nn

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets
from dcarl_tpu_torch.algos.trpo import (TRPOConfig, TRPODraws, TRPOState,
                                        make_trpo)
from dcarl_tpu_torch.models.networks import _dense, _generator
from dcarl_tpu_torch.parallel.normalize import (RunningMeanStd, rms_init,
                                                rms_update)


class GAILConfig(NamedTuple):
    trpo: TRPOConfig = TRPOConfig()
    hidden_size_adversary: int = 100
    adversary_entcoeff: float = 1e-3
    g_step: int = 3
    d_step: int = 1
    d_stepsize: float = 3e-4
    d_batch: int = 256
    normalize: bool = True


class Adversary(nn.Module):
    """TransitionClassifier (adversary.py:34-135). -> logit."""

    FLAX = {"l0": "Dense_0", "l1": "Dense_1", "out": "Dense_2"}

    def __init__(self, obs_dim: int, feat_dim: int, hidden: int = 100,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.l0 = _dense(obs_dim + feat_dim, hidden, g)
        self.l1 = _dense(hidden, hidden, g)
        self.out = _dense(hidden, 1, g)

    def forward(self, obs, act_feat):
        x = torch.cat([obs, act_feat], dim=-1)
        x = torch.tanh(self.l0(x))
        x = torch.tanh(self.l1(x))
        return self.out(x)[..., 0]


def logit_bernoulli_entropy(logits):
    """(1 - sigmoid(x)) x - log sigmoid(x) (adversary.py:23-31)."""
    return (1.0 - torch.sigmoid(logits)) * logits \
        + torch.nn.functional.softplus(-logits)


class GAILState(NamedTuple):
    trpo: TRPOState
    d_params: dict
    d_opt: Any
    obs_rms: RunningMeanStd
    step: torch.Tensor


class GAILDraws(NamedTuple):
    generator_steps: List[TRPODraws]   # g_step rollouts
    gen_index: torch.Tensor            # [d_step, d_batch]
    expert_index: torch.Tensor         # [d_step, d_batch]


def make_gail(env: C.EnvFns, expert_obs: torch.Tensor,
              expert_act: torch.Tensor, cfg: GAILConfig = GAILConfig(),
              hidden=(64, 64), mesh=None):
    """Returns (init_fn(generator, batch) -> GAILState, update_fn(state,
    generator) -> (state, metrics)).  One update = g_step TRPO updates
    on adversary rewards + d_step discriminator updates."""
    discrete = env.num_actions is not None
    obs_dim = env.obs_dim
    feat_dim = env.num_actions if discrete else env.action_dim

    def build(g=None):
        return Adversary(obs_dim, feat_dim, cfg.hidden_size_adversary, g)

    adv_net = build()
    dtx = C.adam(cfg.d_stepsize)
    trpo_init, trpo_update = make_trpo(env, cfg.trpo, hidden, mesh)

    def act_feat(action):
        if discrete:
            return torch.nn.functional.one_hot(
                action.long(), env.num_actions).to(torch.float32)
        return action

    def norm_obs(rms: RunningMeanStd, obs):
        if not cfg.normalize:
            return obs
        return (obs - rms.mean) / torch.sqrt(rms.var + 1e-8)

    def init_fn(generator: torch.Generator, batch: int) -> GAILState:
        trpo_state = trpo_init(generator, batch)
        d_params = nets.init_params(build, generator)
        return GAILState(trpo_state, d_params, dtx.init(d_params),
                         rms_init((obs_dim,), device=generator.device),
                         torch.zeros((), dtype=torch.int32,
                                     device=generator.device))

    def adversary_reward(d_params, rms, obs, action):
        with torch.no_grad():
            logits = nets.apply(adv_net, d_params, norm_obs(rms, obs),
                                act_feat(action))
            # reward_op (adversary.py:99)
            return -torch.log(1.0 - torch.sigmoid(logits) + 1e-8)

    def d_loss_fn(d_params, rms, gen_obs, gen_act, exp_obs, exp_act):
        gen_logits = nets.apply(adv_net, d_params, norm_obs(rms, gen_obs),
                                act_feat(gen_act))
        exp_logits = nets.apply(adv_net, d_params, norm_obs(rms, exp_obs),
                                act_feat(exp_act))
        softplus = torch.nn.functional.softplus
        gen_loss = torch.mean(softplus(gen_logits))          # label 0
        exp_loss = torch.mean(softplus(-exp_logits))         # label 1
        ent = torch.mean(logit_bernoulli_entropy(
            torch.cat([gen_logits, exp_logits])))
        total = gen_loss + exp_loss - cfg.adversary_entcoeff * ent
        gen_acc = torch.mean((torch.sigmoid(gen_logits) < 0.5).float())
        exp_acc = torch.mean((torch.sigmoid(exp_logits) > 0.5).float())
        return total, (gen_loss, exp_loss, gen_acc, exp_acc)

    def draw(state: GAILState, generator: torch.Generator) -> GAILDraws:
        n_gen = cfg.g_step * cfg.trpo.n_steps * state.trpo.obs.shape[0]
        shape = (cfg.d_step, cfg.d_batch)
        dev = generator.device
        return GAILDraws(
            [trpo_update.draw(state.trpo, generator)
             for _ in range(cfg.g_step)],
            torch.randint(0, n_gen, shape, generator=generator, device=dev),
            torch.randint(0, expert_obs.shape[0], shape, generator=generator,
                          device=dev))

    def with_draws(state: GAILState, draws: GAILDraws):
        # --- g_step generator (TRPO) updates on adversary rewards ----
        trpo_state, rms = state.trpo, state.obs_rms
        d_rews, trajs = [], []
        for gd in draws.generator_steps:
            params = trpo_state.params
            env_state, obs, traj = C.collect_rollout(
                env, lambda o, d: trpo_update.sample(params, o, d),
                trpo_state.env_state, trpo_state.obs, gd.rollout)
            traj = traj._replace(reward=adversary_reward(
                state.d_params, rms, traj.obs, traj.action))
            rms = rms_update(rms, traj.obs.reshape(-1, obs_dim))
            trpo_state, m = trpo_update.from_traj(trpo_state, traj, obs,
                                                  env_state)
            d_rews.append(m["reward_mean"])
            trajs.append(traj)

        gen_obs = torch.cat([t.obs.reshape(-1, obs_dim) for t in trajs])
        gen_act = torch.cat([t.action.reshape(
            (-1,) if discrete else (-1, env.action_dim)) for t in trajs])

        # --- d_step discriminator updates -----------------------------
        d_params, d_opt = state.d_params, state.d_opt
        d_aux = []
        for gi, ei in zip(draws.gen_index, draws.expert_index):
            grads, aux = C.grad(d_loss_fn, d_params, rms, gen_obs[gi],
                                gen_act[gi], expert_obs[ei], expert_act[ei],
                                has_aux=True)
            grads = C.maybe_pmean(grads, mesh)
            updates, d_opt = dtx.update(grads, d_opt, d_params)
            d_params = C.apply_updates(d_params, updates)
            d_aux.append(aux)

        mean = lambda xs: torch.stack(list(xs)).mean()
        metrics = {"adversary_reward": mean(d_rews),
                   "gen_loss": mean(a[0] for a in d_aux),
                   "expert_loss": mean(a[1] for a in d_aux),
                   "gen_acc": mean(a[2] for a in d_aux),
                   "expert_acc": mean(a[3] for a in d_aux)}
        return GAILState(trpo_state, d_params, d_opt, rms,
                         state.step + 1), metrics

    def update_fn(state: GAILState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.trpo = trpo_update
    update_fn.adversary = adv_net
    return init_fn, update_fn
