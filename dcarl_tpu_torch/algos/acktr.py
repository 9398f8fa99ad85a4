"""ACKTR: actor-critic with a Kronecker-factored trust region
(``dcarl_tpu/algos/acktr.py``).

The SB fork's ``acktr/acktr.py`` (415 LoC) + ``acktr/kfac.py`` (~1,000
LoC): A2C-style n-step rollouts optimized with a K-FAC natural-gradient
step.  Reference defaults from ``acktr.py:58-61`` (gamma 0.99, n_steps
20, ent_coef 0.01, vf_coef 0.25, vf_fisher_coef 1.0, learning_rate 0.25,
max_grad_norm 0.5, kfac_clip 0.001) and ``kfac.py`` (momentum 0.9,
stats EMA decay 0.99, damping).

* The network is an explicit list of :class:`Dense` blocks (trunk, pi
  head, vf head), so each block's input activations ``a`` and
  pre-activation gradients ``g`` are plain values: ``g`` is the gradient
  with respect to zero perturbations added to each pre-activation.
* Fisher statistics use the reference's sampled Fisher: the policy NLL
  at actions sampled from the model plus the Gaussian value Fisher
  ``0.5 vf_fisher_coef (v - sg(v) - noise)^2``; the categorical's Gumbel
  noise and the value noise are draws.
* Factors A = E[a^T a] (bias folded in) and G = E[g g^T] are EMA
  averaged, Tikhonov-damped with the pi-correction and applied by two
  ``torch.linalg.solve`` calls per block; the step is rescaled so that
  ``lr^2 v^T F v <= 2 kfac_clip`` (kfac.py getKfacPrecondUpdates).

The factor products carry the statistics: run it with TF32 off
(``dcarl_tpu_torch.disable_tf32``), as the card's entry points do.
"""

from __future__ import annotations

import math
from typing import Any, List, NamedTuple, Sequence, Tuple

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets


class ACKTRConfig(NamedTuple):
    n_steps: int = 20
    gamma: float = 0.99
    ent_coef: float = 0.01
    vf_coef: float = 0.25
    vf_fisher_coef: float = 1.0
    learning_rate: float = 0.25
    momentum: float = 0.9
    stats_decay: float = 0.99
    damping: float = 0.01
    kfac_clip: float = 0.001
    max_grad_norm: float = 0.5


class Dense(NamedTuple):
    w: torch.Tensor   # [in, out]
    b: torch.Tensor   # [out]


def _init_dense(n_in, n_out, generator, scale=None):
    scale = math.sqrt(2.0 / n_in) if scale is None else scale
    return Dense(scale * C.normal((n_in, n_out), generator),
                 torch.zeros((n_out,), device=generator.device))


def init_params(obs_dim: int, num_actions: int, hidden: Sequence[int],
                generator: torch.Generator) -> List[Dense]:
    """He-normal trunk, pi head at scale 0.01, vf head at scale 1."""
    layers, n_in = [], obs_dim
    for h in hidden:
        layers.append(_init_dense(n_in, h, generator))
        n_in = h
    return layers + [_init_dense(n_in, num_actions, generator, 0.01),
                     _init_dense(n_in, 1, generator, 1.0)]


def forward(params: List[Dense], obs, deltas=None):
    """(logits, value, per-block input activations).  ``deltas``, when
    given, are added to each block's pre-activation, so their gradients
    are exactly the K-FAC ``g`` statistics."""
    trunk, pi, vf = params[:-2], params[-2], params[-1]
    acts = []
    h = obs
    for i, layer in enumerate(trunk):
        acts.append(h)
        s = h @ layer.w + layer.b
        if deltas is not None:
            s = s + deltas[i]
        h = torch.tanh(s)
    acts.append(h)  # input to the pi head
    logits = h @ pi.w + pi.b
    if deltas is not None:
        logits = logits + deltas[len(trunk)]
    acts.append(h)  # input to the vf head
    value = h @ vf.w + vf.b
    if deltas is not None:
        value = value + deltas[len(trunk) + 1]
    return logits, value[..., 0], acts


class KFACState(NamedTuple):
    factors_a: Tuple[torch.Tensor, ...]   # per block [in+1, in+1]
    factors_g: Tuple[torch.Tensor, ...]   # per block [out, out]
    velocity: List[Dense]
    t: torch.Tensor


def kfac_init(params: List[Dense]) -> KFACState:
    dev = params[0].w.device
    fa = tuple(torch.eye(p.w.shape[0] + 1, device=dev) for p in params)
    fg = tuple(torch.eye(p.w.shape[1], device=dev) for p in params)
    return KFACState(fa, fg, C.tree_map(torch.zeros_like, params),
                     torch.zeros((), dtype=torch.int32, device=dev))


def fisher_stats(params, obs_flat, gumbel_draw, noise, cfg: ACKTRConfig):
    """Sampled-Fisher per-block (A, G) statistics.  obs_flat: [N, obs];
    ``gumbel_draw`` [N, A] samples the actions, ``noise`` [N] the value
    Fisher's target."""
    n = obs_flat.shape[0]
    deltas = [torch.zeros((n, p.w.shape[1]), device=obs_flat.device)
              for p in params]

    def fisher_loss(dl):
        logits, value, _ = forward(params, obs_flat, dl)
        a_samp = C.categorical_sample(logits.detach(), gumbel_draw)
        pg = -torch.mean(nets.categorical_log_prob(logits, a_samp))
        vf = cfg.vf_fisher_coef * 0.5 * torch.mean(
            (value - value.detach() - noise) ** 2)
        return pg + vf

    g_list = C.grad(fisher_loss, deltas)
    with torch.no_grad():
        _, _, acts = forward(params, obs_flat)
    ones = torch.ones((n, 1), device=obs_flat.device)
    stats = []
    for a, g in zip(acts, g_list):
        a_h = torch.cat([a, ones], -1)
        g = g * n       # undo the mean: per-sample gradients
        stats.append(((a_h.T @ a_h) / n, (g.T @ g) / n))
    return stats


def kfac_step(params: List[Dense], grads: List[Dense], kf: KFACState,
              stats, cfg: ACKTRConfig):
    """Precondition ``grads`` by the Kronecker factors, rescale to the
    kfac_clip trust region, apply momentum and SGD."""
    new_fa, new_fg, nat = [], [], []
    d = cfg.stats_decay
    for (A, G), fa, fg, gr in zip(stats, kf.factors_a, kf.factors_g, grads):
        fa = d * fa + (1.0 - d) * A
        fg = d * fg + (1.0 - d) * G
        # pi-corrected Tikhonov damping (Martens & Grosse eq. 15)
        tr_a = torch.trace(fa) / fa.shape[0]
        tr_g = torch.trace(fg) / fg.shape[0]
        pi_c = torch.sqrt(torch.clamp(tr_a, min=1e-8)
                          / torch.clamp(tr_g, min=1e-8))
        eps = math.sqrt(cfg.damping)
        eye_a = torch.eye(fa.shape[0], device=fa.device)
        eye_g = torch.eye(fg.shape[0], device=fg.device)
        fa_d = fa + eps * pi_c * eye_a
        fg_d = fg + eps / pi_c * eye_g
        gw = torch.cat([gr.w, gr.b[None, :]], 0)   # [in+1, out]
        nat_w = torch.linalg.solve(fa_d, torch.linalg.solve(fg_d, gw.T).T)
        nat.append(Dense(nat_w[:-1], nat_w[-1]))
        new_fa.append(fa)
        new_fg.append(fg)

    # Trust-region rescale: lr^2 v^T F v <= 2 kfac_clip
    vfv = sum(torch.sum(nv.w * gr.w) + torch.sum(nv.b * gr.b)
              for nv, gr in zip(nat, grads))
    coeff = torch.clamp(torch.sqrt(
        2.0 * cfg.kfac_clip
        / torch.clamp(cfg.learning_rate ** 2 * vfv, min=1e-12)), max=1.0)
    vel = C.tree_map(lambda v, nv: cfg.momentum * v + coeff * nv,
                     kf.velocity, nat)
    params = C.tree_map(lambda p, v: p - cfg.learning_rate * v, params, vel)
    return params, KFACState(tuple(new_fa), tuple(new_fg), vel, kf.t + 1)


class ACKTRState(NamedTuple):
    params: List[Dense]
    kfac: KFACState
    env_state: Any
    obs: torch.Tensor
    step: torch.Tensor


class ACKTRDraws(NamedTuple):
    rollout: C.RolloutDraws
    fisher_gumbel: torch.Tensor   # [n_steps * B, A]
    fisher_noise: torch.Tensor    # [n_steps * B]


def make_acktr(env: C.EnvFns, cfg: ACKTRConfig = ACKTRConfig(),
               hidden=(64, 64), mesh=None):
    """Returns (init_fn(generator, batch) -> ACKTRState,
    update_fn(state, generator) -> (state, metrics))."""
    assert env.num_actions is not None, "ACKTR here is discrete-action"
    num_actions = env.num_actions

    def init_fn(generator: torch.Generator, batch: int) -> ACKTRState:
        params = init_params(env.obs_dim, num_actions, hidden, generator)
        env_state, obs = env.reset(env.draw((batch,), generator))
        return ACKTRState(params, kfac_init(params), env_state, obs,
                          torch.zeros((), dtype=torch.int32,
                                      device=generator.device))

    def loss_fn(params, obs_flat, act_flat, ret_flat):
        logits, value, _ = forward(params, obs_flat)
        logp = nets.categorical_log_prob(logits, act_flat)
        adv = ret_flat - value
        pg = -torch.mean(logp * adv.detach())
        vf = torch.mean(adv ** 2)
        ent = torch.mean(nets.categorical_entropy(logits))
        return pg + cfg.vf_coef * vf - cfg.ent_coef * ent, (pg, vf, ent)

    def draw(state: ACKTRState, generator: torch.Generator) -> ACKTRDraws:
        b = state.obs.shape[0]
        n = cfg.n_steps * b
        return ACKTRDraws(
            C.rollout_draws(env, cfg.n_steps, b, (num_actions,), generator),
            C.gumbel((n, num_actions), generator), C.normal((n,), generator))

    def with_draws(state: ACKTRState, draws: ACKTRDraws):
        def policy(obs, g):
            logits, _, _ = forward(state.params, obs)
            return C.categorical_sample(logits, g)

        env_state, obs, traj = C.collect_rollout(
            env, policy, state.env_state, state.obs, draws.rollout)
        with torch.no_grad():
            _, last_value, _ = forward(state.params, obs)
        returns = C.discounted_returns(
            traj.reward, traj.done.to(torch.float32), last_value, cfg.gamma)

        n = cfg.n_steps * traj.reward.shape[1]
        obs_flat = traj.obs.reshape(n, -1)
        act_flat = traj.action.reshape(n)
        ret_flat = returns.reshape(n)

        grads, aux = C.grad(loss_fn, state.params, obs_flat, act_flat,
                            ret_flat, has_aux=True)
        grads = C.maybe_pmean(grads, mesh)
        gnorm = torch.sqrt(sum(torch.sum(g.w ** 2) + torch.sum(g.b ** 2)
                               for g in grads))
        scale = torch.clamp(cfg.max_grad_norm / (gnorm + 1e-8), max=1.0)
        grads = C.tree_map(lambda g: g * scale, grads)

        stats = fisher_stats(state.params, obs_flat, draws.fisher_gumbel,
                             draws.fisher_noise, cfg)
        stats = [(C.maybe_pmean(A, mesh), C.maybe_pmean(G, mesh))
                 for A, G in stats]
        params, kfac = kfac_step(state.params, grads, state.kfac, stats, cfg)
        metrics = {"pg_loss": aux[0], "vf_loss": aux[1], "entropy": aux[2],
                   "reward_mean": torch.mean(traj.reward)}
        return ACKTRState(params, kfac, env_state, obs,
                          state.step + 1), metrics

    def update_fn(state: ACKTRState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    return init_fn, update_fn
