"""TRPO: trust-region policy optimization (``dcarl_tpu/algos/trpo.py``).

The fork's ``trpo_mpi/trpo_mpi.py`` (530 LoC): the surrogate gain with a
KL trust region, solved by conjugate gradient on Fisher-vector products
(the Hessian of the mean KL times a vector, by double backward), then a
backtracking line search, and a separate value-function Adam.  The
fork's ``allmean`` MPI reductions are all-reduces over ``mesh``.  The
conjugate gradient runs ``cg_iters`` steps (cg_iters=10, the reference
default); the line search stops at the first accepted step, reading
its accept flag on the host once per candidate.
"""

from __future__ import annotations

from typing import Any, NamedTuple

import torch

from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import nets


class TRPOConfig(NamedTuple):
    n_steps: int = 128
    gamma: float = 0.99
    lam: float = 0.98              # trpo_mpi defaults
    max_kl: float = 0.01
    cg_iters: int = 10
    cg_damping: float = 0.1
    vf_lr: float = 1e-3
    vf_iters: int = 3
    entcoeff: float = 0.0
    backtrack_iters: int = 10
    backtrack_coeff: float = 0.8


class TRPOState(NamedTuple):
    params: dict
    vf_opt: Any
    env_state: Any
    obs: torch.Tensor
    step: torch.Tensor


class TRPODraws(NamedTuple):
    rollout: C.RolloutDraws


def make_trpo(env: C.EnvFns, cfg: TRPOConfig = TRPOConfig(), hidden=(64, 64),
              mesh=None):
    """Returns (init_fn(generator, batch) -> TRPOState,
    update_fn(state, generator) -> (state, metrics)).  ``update_fn.
    from_traj(state, traj, obs, env_state)`` updates from a collected
    trajectory (GAIL's generator step) and ``update_fn.sample(params, obs,
    draw)`` is the policy."""
    discrete = env.num_actions is not None

    def build(g=None):
        if discrete:
            return nets.CategoricalActorCritic(env.obs_dim, env.num_actions,
                                               hidden, g)
        return nets.GaussianActorCritic(env.obs_dim, env.action_dim, hidden, g)

    net = build()
    vtx = C.adam(cfg.vf_lr)

    def dist_and_value(params, obs):
        if discrete:
            logits, value = nets.apply(net, params, obs)
            return (logits,), value
        mean, log_std, value = nets.apply(net, params, obs)
        return (mean, log_std), value

    def log_prob(dist, action):
        if discrete:
            return nets.categorical_log_prob(dist[0], action)
        return nets.gaussian_log_prob(dist[0], dist[1], action)

    def entropy(dist):
        if discrete:
            return nets.categorical_entropy(dist[0])
        return nets.gaussian_entropy(dist[1])

    def kl(dist_old, dist_new):
        if discrete:
            p_old = torch.log_softmax(dist_old[0], dim=-1)
            p_new = torch.log_softmax(dist_new[0], dim=-1)
            return torch.sum(torch.exp(p_old) * (p_old - p_new), dim=-1)
        m0, ls0 = dist_old
        m1, ls1 = dist_new
        v0, v1 = torch.exp(2 * ls0), torch.exp(2 * ls1)
        return torch.sum(ls1 - ls0 + (v0 + (m0 - m1) ** 2) / (2 * v1) - 0.5,
                         dim=-1)

    def sample(params, obs, draw):
        dist, _ = dist_and_value(params, obs)
        if discrete:
            return C.categorical_sample(dist[0], draw)
        return dist[0] + torch.exp(dist[1]) * draw

    def init_fn(generator: torch.Generator, batch: int) -> TRPOState:
        params = nets.init_params(build, generator)
        env_state, obs = env.reset(env.draw((batch,), generator))
        return TRPOState(params, vtx.init(params), env_state, obs,
                         torch.zeros((), dtype=torch.int32,
                                     device=generator.device))

    def update_from_traj(state: TRPOState, traj, obs, env_state):
        """One TRPO policy + value update from a collected trajectory
        (used directly by GAIL, gail/model.py, whose rewards are the
        adversary's)."""
        with torch.no_grad():
            dist_old, values = dist_and_value(state.params, traj.obs)
            _, last_value = dist_and_value(state.params, obs)
        adv, ret = C.gae(traj.reward, values, traj.done.to(torch.float32),
                         last_value, cfg.gamma, cfg.lam)
        # population std (ddof 0), as jnp.std
        adv = (adv - adv.mean()) / (adv.std(correction=0) + 1e-8)
        old_logp = log_prob(dist_old, traj.action)

        def surrogate(params):
            dist, _ = dist_and_value(params, traj.obs)
            ratio = torch.exp(log_prob(dist, traj.action) - old_logp)
            return torch.mean(ratio * adv) + cfg.entcoeff * torch.mean(
                entropy(dist))

        def mean_kl(params):
            dist, _ = dist_and_value(params, traj.obs)
            return torch.mean(kl(dist_old, dist))

        g_flat = C.flat(C.maybe_pmean(C.grad(surrogate, state.params), mesh))

        # Fisher-vector products: the Hessian of the mean KL at the old
        # parameters times v, by a second backward through its gradient
        leaves = [p.detach().requires_grad_(True)
                  for p in C.tree_leaves(state.params)]
        with torch.enable_grad():
            kl_grad = torch.autograd.grad(
                mean_kl(C.tree_unflatten(state.params, leaves)), leaves,
                create_graph=True, allow_unused=True)
            kl_grad = torch.cat([(torch.zeros_like(p) if g is None else g)
                                 .reshape(-1)
                                 for p, g in zip(leaves, kl_grad)])

        def fvp(v_flat):
            with torch.enable_grad():
                hvp = torch.autograd.grad(kl_grad @ v_flat, leaves,
                                          retain_graph=True, allow_unused=True)
            hvp = [torch.zeros_like(p) if h is None else h
                   for p, h in zip(leaves, hvp)]
            hvp = C.maybe_pmean(C.tree_unflatten(state.params, hvp), mesh)
            return C.flat(hvp) + cfg.cg_damping * v_flat

        # Conjugate gradient (trpo_mpi cg())
        x = torch.zeros_like(g_flat)
        r, p, rdotr = g_flat, g_flat, g_flat @ g_flat
        for _ in range(cfg.cg_iters):
            ap = fvp(p)
            alpha = rdotr / (p @ ap + 1e-10)
            x = x + alpha * p
            r = r - alpha * ap
            new_rdotr = r @ r
            p = r + (new_rdotr / (rdotr + 1e-10)) * p
            rdotr = new_rdotr
        step_dir = x

        shs = 0.5 * (step_dir @ fvp(step_dir))
        lm = torch.sqrt(torch.clamp(shs / cfg.max_kl, min=1e-10))
        full_step = step_dir / lm
        expected_improve = g_flat @ full_step
        theta = C.flat(state.params)

        # Backtracking line search (trpo_mpi:298-320)
        with torch.no_grad():
            gain_before = surrogate(state.params)
            frac = torch.ones((), dtype=g_flat.dtype, device=g_flat.device)
            backtrack, accepted = cfg.backtrack_iters, False
            for i in range(cfg.backtrack_iters):
                cand = C.unflat(theta + frac * full_step, state.params)
                ok = (surrogate(cand) > gain_before) \
                    & (mean_kl(cand) <= cfg.max_kl * 1.5)
                if bool(ok):
                    backtrack, accepted = i, True
                    break
                frac = frac * cfg.backtrack_coeff
            if not accepted:
                frac = torch.zeros_like(frac)
            params = C.unflat(theta + frac * full_step, state.params)

        # Value-function regression (separate Adam, vf_iters epochs)
        def vf_loss(p):
            _, v = dist_and_value(p, traj.obs)
            return torch.mean((v - ret) ** 2)

        vf_opt = state.vf_opt
        for _ in range(cfg.vf_iters):
            vg = C.maybe_pmean(C.grad(vf_loss, params), mesh)
            up, vf_opt = vtx.update(vg, vf_opt, params)
            params = C.apply_updates(params, up)

        with torch.no_grad():
            kl_after = mean_kl(params)
        dev = g_flat.device
        metrics = {"gain": gain_before, "kl": kl_after,
                   "accepted": torch.full((), float(accepted), device=dev),
                   "backtrack": torch.full((), backtrack, dtype=torch.int32,
                                           device=dev),
                   "step_frac": frac,
                   "reward_mean": torch.mean(traj.reward),
                   "expected_improve": expected_improve.detach()}
        return TRPOState(params, vf_opt, env_state, obs,
                         state.step + 1), metrics

    def draw(state: TRPOState, generator: torch.Generator) -> TRPODraws:
        shape = (env.num_actions,) if discrete else (env.action_dim,)
        return TRPODraws(C.rollout_draws(
            env, cfg.n_steps, state.obs.shape[0], shape, generator,
            "gumbel" if discrete else "normal"))

    def with_draws(state: TRPOState, draws: TRPODraws):
        env_state, obs, traj = C.collect_rollout(
            env, lambda o, d: sample(state.params, o, d), state.env_state,
            state.obs, draws.rollout)
        return update_from_traj(state, traj, obs, env_state)

    def update_fn(state: TRPOState, generator: torch.Generator):
        return with_draws(state, draw(state, generator))

    update_fn.draw = draw
    update_fn.with_draws = with_draws
    update_fn.from_traj = update_from_traj
    update_fn.sample = sample
    update_fn.net = net
    return init_fn, update_fn
