"""ACER: actor-critic with experience replay (``dcarl_tpu/algos/acer.py``).

The SB fork's ``acer/acer_simple.py`` (680 LoC): n-step on-policy
segments plus a segment replay buffer, Retrace Q targets with truncated
importance sampling and bias correction, and the efficient trust-region
step against a Polyak-averaged policy network (Wang et al. 2017).
Reference defaults from ``acer_simple.py:108-133`` (gamma 0.99, n_steps
20, q_coef 0.5, ent_coef 0.01, correction_term c=10, trust-region
delta=1, average-net alpha=0.99, RMSprop 7e-4).

* The segment replay buffer (``acer/buffer.py``) is a fixed-capacity
  ring of ``[T, B]`` segments on the device in the state; a replay step
  gathers one segment at a drawn index.
* The Poisson number of replay updates per on-policy update
  (``acer_simple.py learn``) is the fixed expectation ``replay_ratio``.
* The trust region is taken in distribution (f) space, as the reference
  does: the policy-loss gradient with respect to the action
  probabilities is projected against k = -f_avg/f and pulled back
  through the network by one backward with that gradient as its seed.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch
from torch import nn

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.models.networks import _dense, _generator

EPS = 1e-6


class ACERConfig(NamedTuple):
    n_steps: int = 20
    gamma: float = 0.99
    q_coef: float = 0.5
    ent_coef: float = 0.01
    learning_rate: float = 7e-4
    rprop_alpha: float = 0.99
    rprop_epsilon: float = 1e-5
    max_grad_norm: float = 10.0
    buffer_segments: int = 64      # ring capacity in segments
    replay_ratio: int = 4
    replay_start: int = 4          # segments in buffer before replay
    correction_term: float = 10.0  # c
    trust_region: bool = True
    alpha: float = 0.99            # average-net Polyak
    delta: float = 1.0             # trust-region radius


class PolicyQNet(nn.Module):
    """Shared-trunk categorical policy and a per-action Q head (the
    AcerMlpPolicy surface: pi and q over n_actions), hidden (64, 64).
    -> (logits, q)."""

    FLAX = {"trunk": "MLP_0", "pi": "Dense_0", "q": "Dense_1"}

    def __init__(self, obs_dim: int, num_actions: int, hidden=(64, 64),
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.trunk = nets.MLP(obs_dim, hidden, True, g)
        self.pi = _dense(hidden[-1], num_actions, g)
        self.q = _dense(hidden[-1], num_actions, g)

    def forward(self, obs):
        h = self.trunk(obs)
        return self.pi(h), self.q(h)


class SegmentBuffer(NamedTuple):
    """Ring buffer of [T, B] rollout segments (acer/buffer.py)."""

    obs: torch.Tensor       # [C, T, B, obs]
    action: torch.Tensor    # [C, T, B] i32
    reward: torch.Tensor    # [C, T, B]
    done: torch.Tensor      # [C, T, B]
    mu: torch.Tensor        # [C, T, B, A] behaviour probabilities
    next_obs: torch.Tensor  # [C, B, obs]  (obs after the segment)
    size: torch.Tensor
    head: torch.Tensor


def segment_buffer_init(cap: int, t: int, b: int, obs_dim: int,
                        num_actions: int, device=None) -> SegmentBuffer:
    device = resolve_device(device)

    def z(*shape, dt=torch.float32):
        return torch.zeros(shape, dtype=dt, device=device)

    return SegmentBuffer(z(cap, t, b, obs_dim), z(cap, t, b, dt=torch.int32),
                         z(cap, t, b), z(cap, t, b), z(cap, t, b, num_actions),
                         z(cap, b, obs_dim), z(dt=torch.int32),
                         z(dt=torch.int32))


def segment_buffer_push(buf: SegmentBuffer, seg) -> SegmentBuffer:
    obs, action, reward, done, mu, next_obs = seg
    i = buf.head.long()
    cap = buf.obs.shape[0]

    def put(dst, src):
        return dst.index_copy(0, i[None], src[None].to(dst.dtype))

    return SegmentBuffer(
        put(buf.obs, obs), put(buf.action, action), put(buf.reward, reward),
        put(buf.done, done), put(buf.mu, mu), put(buf.next_obs, next_obs),
        torch.clamp(buf.size + 1, max=cap), (buf.head + 1) % cap)


class ACERState(NamedTuple):
    params: dict
    avg_params: dict
    opt_state: Any
    buffer: SegmentBuffer
    env_state: Any
    obs: torch.Tensor
    step: torch.Tensor


class ACERDraws(NamedTuple):
    rollout: C.RolloutDraws
    replay_index: torch.Tensor   # [replay_ratio] segment indices


def make_acer(env: C.EnvFns, cfg: ACERConfig = ACERConfig(), batch: int = 8,
              mesh=None):
    """Returns (init_fn(generator) -> ACERState, update_fn(state,
    generator) -> (state, metrics)); one update = one on-policy and
    ``replay_ratio`` off-policy Retrace steps."""
    assert env.num_actions is not None, "ACER is discrete-action"
    num_actions = env.num_actions

    def build(g=None):
        return PolicyQNet(env.obs_dim, num_actions, generator=g)

    net = build()
    tx = C.chain(C.clip_by_global_norm(cfg.max_grad_norm),
                 C.rmsprop(cfg.learning_rate, decay=cfg.rprop_alpha,
                           eps=cfg.rprop_epsilon))

    def probs_q(params, obs):
        logits, q = nets.apply(net, params, obs)
        return torch.softmax(logits, dim=-1), q

    def init_fn(generator: torch.Generator) -> ACERState:
        params = nets.init_params(build, generator)
        env_state, obs = env.reset(env.draw((batch,), generator))
        buf = segment_buffer_init(cfg.buffer_segments, cfg.n_steps, batch,
                                  env.obs_dim, num_actions, generator.device)
        return ACERState(params, params, tx.init(params), buf, env_state,
                         obs, torch.zeros((), dtype=torch.int32,
                                          device=generator.device))

    # -- Retrace targets + ACER loss over one [T, B] segment ---------------

    def qret_scan(reward, done, rho_bar_a, q_a, v, v_last):
        """Backward recursion (acer_simple q_retrace): qret = r + g qret';
        after consuming step i, qret' = rho_bar_i (qret_i - q_i) + v_i."""
        qret_next, out = v_last, [None] * reward.shape[0]
        for i in reversed(range(reward.shape[0])):
            qret = reward[i] + cfg.gamma * qret_next * (1.0 - done[i])
            qret_next = rho_bar_a[i] * (qret - q_a[i]) + v[i]
            out[i] = qret
        return torch.stack(out)

    def take(x, action):
        return torch.gather(x, -1, action.long()[..., None])[..., 0]

    def segment_loss_f(f, q, seg):
        """Policy part of the loss as a function of the action
        probabilities f (for the f-space trust region), and auxiliaries."""
        _, action, reward, done, mu, v_last = seg
        v_last, q = v_last.detach(), q.detach()
        f_a, q_a = take(f, action), take(q, action)
        v = torch.sum(f * q, -1)
        rho = f / (mu + EPS)
        rho_bar = torch.clamp(take(rho, action), max=cfg.correction_term)
        qret = qret_scan(reward, done, rho_bar.detach(), q_a, v.detach(),
                         v_last)
        adv = qret - v.detach()
        # truncated IS policy gradient (acer_simple loss_policy)
        gain_f = torch.log(f_a + EPS) * rho_bar.detach() * adv
        # bias correction over all actions (loss_bc)
        coef = torch.relu(1.0 - cfg.correction_term / (rho + EPS))
        adv_bc = q - v.detach()[..., None]
        gain_bc = torch.sum(torch.log(f + EPS)
                            * (coef * f * adv_bc).detach(), -1)
        entropy = -torch.sum(f * torch.log(f + EPS), -1)
        loss_policy = -torch.mean(gain_f + gain_bc)
        loss_ent = -cfg.ent_coef * torch.mean(entropy)
        loss_q = cfg.q_coef * 0.5 * torch.mean((qret - q_a) ** 2)
        return loss_policy + loss_ent, (loss_q, qret, torch.mean(entropy))

    def segment_grads(params, avg_params, seg):
        """The trust-region-projected policy gradient in f space pulled
        back through the network, plus the Q-loss gradient."""
        obs, action = seg[0], seg[1]
        leaves = [p.detach().requires_grad_(True)
                  for p in C.tree_leaves(params)]
        with torch.enable_grad():
            f, q = probs_q(C.tree_unflatten(params, leaves), obs)
            with torch.no_grad():
                avg_f, _ = probs_q(avg_params, obs)
            f_in = f.detach().requires_grad_(True)
            loss, aux = segment_loss_f(f_in, q, seg)
            (gf,) = torch.autograd.grad(loss, f_in)
            if cfg.trust_region:
                # gf is the descent direction in f space; project it so
                # the step keeps KL(avg || pi) small: k = -avg_f / f
                fd = f.detach()
                k = -avg_f / (fd + EPS)
                kg = torch.sum(k * gf, -1, keepdim=True)
                k2 = torch.sum(k * k, -1, keepdim=True)
                gf = gf - torch.relu((kg - cfg.delta) / (k2 + EPS)) * k
            qret = aux[1].detach()
            # Q-loss: 0.5 q_coef (qret - q_a)^2 with qret frozen
            qloss = cfg.q_coef * 0.5 * torch.mean((qret - take(q, action)) ** 2)
            g_pi = torch.autograd.grad(f, leaves, grad_outputs=gf,
                                       retain_graph=True, allow_unused=True)
            g_q = torch.autograd.grad(qloss, leaves, allow_unused=True)
        grads = [(torch.zeros_like(p) if a is None else a)
                 + (torch.zeros_like(p) if b is None else b)
                 for p, a, b in zip(leaves, g_pi, g_q)]
        return C.tree_unflatten(params, grads), (aux[0].detach(),
                                                 aux[2].detach())

    def apply_segment(params, avg_params, opt_state, seg):
        grads, aux = segment_grads(params, avg_params, seg)
        grads = C.maybe_pmean(grads, mesh)
        updates, opt_state = tx.update(grads, opt_state, params)
        params = C.apply_updates(params, updates)
        avg_params = C.polyak(avg_params, params, 1.0 - cfg.alpha)
        return params, avg_params, opt_state, aux

    def v_of(params, o):
        with torch.no_grad():
            f, q = probs_q(params, o)
            return torch.sum(f * q, -1)

    def draw(state: ACERState, generator: torch.Generator) -> ACERDraws:
        size_after = torch.clamp(state.buffer.size + 1,
                                 max=cfg.buffer_segments)
        return ACERDraws(
            C.rollout_draws(env, cfg.n_steps, batch, (num_actions,),
                            generator),
            C.below(size_after, (cfg.replay_ratio,), generator))

    def with_draws(state: ACERState, draws: ACERDraws):
        def policy(obs, g):
            f, _ = probs_q(state.params, obs)
            return C.categorical_sample(torch.log(f + EPS), g)

        env_state, obs, traj = C.collect_rollout(
            env, policy, state.env_state, state.obs, draws.rollout)
        with torch.no_grad():
            mu, _ = probs_q(state.params, traj.obs)
        done = traj.done.to(torch.float32)
        seg_on = (traj.obs, traj.action, traj.reward, done, mu,
                  v_of(state.params, obs))
        params, avg_params, opt_state, aux = apply_segment(
            state.params, state.avg_params, state.opt_state, seg_on)
        buf = segment_buffer_push(state.buffer, (traj.obs, traj.action,
                                                 traj.reward, done, mu, obs))

        # Off-policy replay updates (fixed replay_ratio; the reference
        # draws Poisson(replay_ratio), acer_simple.learn); before
        # replay_start segments the step is computed and discarded, as
        # the JAX package's select does
        ok = buf.size >= cfg.replay_start
        for idx in draws.replay_index:
            seg = (buf.obs[idx], buf.action[idx], buf.reward[idx],
                   buf.done[idx], buf.mu[idx], v_of(params, buf.next_obs[idx]))
            new = apply_segment(params, avg_params, opt_state, seg)[:3]
            params, avg_params, opt_state = C.tree_map(
                lambda a, b: torch.where(ok, a, b), new,
                (params, avg_params, opt_state))

        metrics = {"loss_q": aux[0], "entropy": aux[1],
                   "reward_mean": torch.mean(traj.reward)}
        return ACERState(params, avg_params, opt_state, buf, env_state, obs,
                         state.step + 1), metrics

    def update_fn(state: ACERState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.net = net
    return init_fn, update_fn
