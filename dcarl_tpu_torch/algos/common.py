"""Shared algorithm machinery (``dcarl_tpu/algos/common.py``):
schedules, returns and advantages, target networks, rollout collection,
the learnability fixtures and the optimizers.

Re-designs of the SB fork's ``common/`` layer
(software/src/tools/DCARL/stable_baselines/common/):

* schedules.py:24-108 -> :func:`linear_schedule`, :func:`constant_schedule`
* the per-algorithm discounted-return / GAE code (a2c/a2c.py,
  ppo2/ppo2.py:330-360) -> :func:`discounted_returns`, :func:`gae`
* target-network Polyak updates (ddpg/td3/sac) -> :func:`polyak`
* BaseRLModel's env interaction loop (base_class.py) ->
  :func:`collect_rollout`, a loop over a batched env on the device.

Random draws are inputs: an env's ``reset`` / ``step`` and a policy take
the raw draws (integers, uniforms, normals, Gumbel noise) as tensors, and
:func:`rollout_draws` makes them from a ``torch.Generator``, so a caller
can feed both packages the same draws.

The optimizers are small functional transforms over trees of tensors
(dicts, NamedTuples, lists), optax's ``GradientTransformation`` with its
formulas and its state layout, so a learner's state is plain tensors
that checkpoint as they are; each formula is one multi-tensor op over
all the leaves: :func:`clip_by_global_norm`,
:func:`scale_by_adam`, :func:`scale_by_rms`, :func:`adam`,
:func:`rmsprop`, :func:`chain`, :func:`linear_lr_schedule` and
:func:`apply_updates`.
"""

from __future__ import annotations

import math
from typing import Any, Callable, List, NamedTuple, Optional, Tuple

import torch

from dcarl_tpu_torch.parallel.collectives import pmean
from dcarl_tpu_torch.parallel.mesh import tree_map

# ---------------------------------------------------------------------------
# Trees of tensors


def tree_leaves(tree: Any) -> List[torch.Tensor]:
    """The tensor leaves of a tree (``parallel.mesh.tree_map``'s nodes:
    dicts, NamedTuples, tuples and lists), in order."""
    out: List[torch.Tensor] = []
    tree_map(out.append, tree)
    return out


def tree_unflatten(tree: Any, leaves) -> Any:
    """``tree``'s structure with ``leaves`` in its leaves' order."""
    it = iter(leaves)
    return tree_map(lambda _: next(it), tree)


def grad(fn: Callable, params: Any, *args, has_aux: bool = False):
    """``jax.grad``: the gradient of the scalar ``fn(params, *args)``
    with respect to every leaf of ``params`` (zeros where a leaf does
    not enter), as a tree like ``params``; with ``has_aux`` ``fn``
    returns ``(loss, aux)`` and this ``(grads, aux)``, aux detached."""
    leaves = [p.detach().requires_grad_(True) for p in tree_leaves(params)]
    with torch.enable_grad():
        out = fn(tree_unflatten(params, leaves), *args)
        loss, aux = out if has_aux else (out, None)
        gs = torch.autograd.grad(loss, leaves, allow_unused=True)
    grads = tree_unflatten(params, [torch.zeros_like(p) if g is None else g
                                    for p, g in zip(leaves, gs)])
    if not has_aux:
        return grads
    return grads, tree_map(torch.Tensor.detach, aux)


def flat(tree: Any) -> torch.Tensor:
    return torch.cat([t.reshape(-1) for t in tree_leaves(tree)])


def unflat(vec: torch.Tensor, like: Any) -> Any:
    """``vec`` cut into ``like``'s leaves (the inverse of :func:`flat`)."""
    out, i = [], 0
    for t in tree_leaves(like):
        out.append(vec[i:i + t.numel()].view_as(t))
        i += t.numel()
    return tree_unflatten(like, out)


# ---------------------------------------------------------------------------
# Schedules (schedules.py)


def constant_schedule(value: float) -> Callable[[torch.Tensor], torch.Tensor]:
    return lambda step: torch.full((), value, dtype=torch.float32,
                                   device=step.device)


def linear_schedule(total_steps: int, initial: float, final: float
                    ) -> Callable[[torch.Tensor], torch.Tensor]:
    """LinearSchedule (schedules.py:78-108): linear interpolation,
    clamped at ``final`` after ``total_steps``."""

    def sched(step):
        frac = torch.clamp(step.to(torch.float32) / total_steps, max=1.0)
        return initial + frac * (final - initial)

    return sched


# ---------------------------------------------------------------------------
# Returns / advantages


def discounted_returns(rewards: torch.Tensor, dones: torch.Tensor,
                       bootstrap: torch.Tensor, gamma: float) -> torch.Tensor:
    """[T, B] n-step discounted returns with episode cuts; the A2C
    target (a2c.py discount_with_dones)."""
    carry, out = bootstrap, [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        carry = rewards[t] + gamma * carry * (1.0 - dones[t])
        out[t] = carry
    return torch.stack(out)


def gae(rewards: torch.Tensor, values: torch.Tensor, dones: torch.Tensor,
        last_value: torch.Tensor, gamma: float, lam: float
        ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Generalized advantage estimation (ppo2.py:330-360).

    rewards/values/dones: [T, B]; last_value: [B].
    Returns (advantages[T, B], returns[T, B])."""
    next_values = torch.cat([values[1:], last_value[None]], dim=0)
    deltas = rewards + gamma * next_values * (1.0 - dones) - values
    carry, out = torch.zeros_like(last_value), [None] * rewards.shape[0]
    for t in reversed(range(rewards.shape[0])):
        carry = deltas[t] + gamma * lam * (1.0 - dones[t]) * carry
        out[t] = carry
    advs = torch.stack(out)
    return advs, advs + values


def polyak(target_params, params, tau):
    """target <- (1-tau) target + tau params (ddpg.py setup_target_updates);
    ``tau`` a float or a 0-d tensor."""
    t = torch._foreach_mul(tree_leaves(target_params), 1.0 - tau)
    return tree_unflatten(target_params, torch._foreach_add(
        t, torch._foreach_mul(tree_leaves(params), tau)))


def maybe_pmean(grads, mesh=None):
    """The MpiAdam Allreduce (mpi_adam.py:51): every leaf averaged over
    ``mesh`` (a ``ProcessMesh``, JAX's ``axis_name``) in one all-reduce
    of one flat bucket; the identity without a mesh."""
    if mesh is None or mesh.size == 1:
        return grads
    return unflat(pmean(flat(grads), mesh), grads)


# ---------------------------------------------------------------------------
# Rollout collection over a batched env on the device


class EnvFns(NamedTuple):
    """A batched environment on the device: the VecEnv ABC
    (common/vec_env/base_vec_env.py) collapsed to pure functions of their
    draws.

    draw(shape, generator) -> the raw draws of one reset or step of
            ``shape[-1]`` envs, with leading axes ``shape[:-1]``
    reset: (draws[B, ...]) -> (state, obs[B, ...])
    step:  (state, action[B, ...], draws[B, ...]) -> (state, obs,
            reward[B], done[B]) with auto-reset (terminal obs replaced,
            as DummyVecEnv does with ``terminal_observation``)."""

    reset: Callable
    step: Callable
    draw: Callable
    num_actions: Optional[int] = None      # discrete envs
    action_dim: Optional[int] = None       # continuous envs
    obs_dim: int = 0


class Transition(NamedTuple):
    obs: torch.Tensor       # [T, B, obs]
    action: torch.Tensor    # [T, B, ...]
    reward: torch.Tensor    # [T, B]
    done: torch.Tensor      # [T, B]
    next_obs: torch.Tensor  # [T, B, obs]


class RolloutDraws(NamedTuple):
    """The draws of ``T`` rollout steps: the policy's (Gumbel noise for a
    categorical sample, unit normals for a Gaussian one) and the env's."""

    policy: torch.Tensor    # [T, B, ...]
    env: Any                # [T, B, ...]


def gumbel(shape, generator: torch.Generator) -> torch.Tensor:
    """Standard Gumbel draws ``-log(-log(U))`` on the generator's device,
    U uniform on (tiny, 1) as ``jax.random.gumbel`` draws it."""
    u = torch.rand(shape, generator=generator, device=generator.device)
    return -torch.log(-torch.log(torch.clamp(u, min=torch.finfo(u.dtype)
                                             .tiny)))


def normal(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.randn(shape, generator=generator, device=generator.device)


def uniform(shape, generator: torch.Generator) -> torch.Tensor:
    return torch.rand(shape, generator=generator, device=generator.device)


def below(n: torch.Tensor, shape, generator: torch.Generator) -> torch.Tensor:
    """Uniform integers in ``[0, max(n, 1))`` for a count ``n`` that lies
    on the device (no host read), as int64."""
    n_f = torch.clamp(n, min=1).to(torch.float32)
    u = uniform(shape, generator)
    return torch.minimum(torch.floor(u * n_f), n_f - 1).to(torch.int64)


def categorical_sample(logits: torch.Tensor, gumbel_draw: torch.Tensor
                       ) -> torch.Tensor:
    """``jax.random.categorical``: ``argmax(gumbel + logits)``, int32."""
    return torch.argmax(gumbel_draw + logits, dim=-1).to(torch.int32)


def rollout_draws(env: EnvFns, n_steps: int, batch: int, policy_shape,
                  generator: torch.Generator,
                  policy: str = "gumbel") -> RolloutDraws:
    """The draws of ``n_steps`` steps of ``batch`` envs: ``policy``
    ("gumbel" or "normal") of trailing shape ``policy_shape`` and the
    env's step draws."""
    make = gumbel if policy == "gumbel" else normal
    return RolloutDraws(make((n_steps, batch) + tuple(policy_shape),
                             generator),
                        env.draw((n_steps, batch), generator))


def collect_rollout(env: EnvFns, policy_fn: Callable, env_state, obs,
                    draws: RolloutDraws) -> Tuple:
    """``T`` steps of policy interaction; ``policy_fn(obs, draw) ->
    action``.  Returns (env_state, obs, Transition[T, B, ...])."""
    rows = []
    with torch.no_grad():
        for t in range(draws.policy.shape[0]):
            act = policy_fn(obs, draws.policy[t])
            env_state, next_obs, rew, done = env.step(
                env_state, act, tree_map(lambda d: d[t], draws.env))
            rows.append(Transition(obs, act, rew, done, next_obs))
            obs = next_obs
    return env_state, obs, Transition(*(torch.stack(x) for x in zip(*rows)))


# ---------------------------------------------------------------------------
# Learnability fixtures (identity_env.py, the SB test pattern)


def identity_env(num_actions: int = 3, ep_len: int = 8) -> EnvFns:
    """IdentityEnv (common/identity_env.py:1-40): obs is a category,
    reward 1 iff action == obs; trivially learnable, used to smoke-test
    every discrete algorithm end to end (tests/test_identity.py).  Its
    draws are the next categories, int32 in ``[0, num_actions)``."""

    def draw(shape, generator):
        return torch.randint(0, num_actions, tuple(shape), generator=generator,
                             device=generator.device, dtype=torch.int32)

    def one_hot(i):   # the default float type, as jax.nn.one_hot's
        return torch.nn.functional.one_hot(i.long(), num_actions).to(
            torch.get_default_dtype())

    def reset(draws):
        state = (draws, torch.zeros_like(draws))
        return state, one_hot(draws)

    def step(state, action, draws):
        obs_id, t = state
        reward = (action == obs_id).to(torch.float32)
        t = t + 1
        done = t >= ep_len
        t = torch.where(done, 0, t)
        return (draws, t), one_hot(draws), reward, done

    return EnvFns(reset=reset, step=step, draw=draw, num_actions=num_actions,
                  obs_dim=num_actions)


def identity_env_box(action_dim: int = 1, ep_len: int = 8) -> EnvFns:
    """IdentityEnvBox: continuous variant, reward 1 iff |a - obs| < 0.05
    (identity_env.py:43-66), relaxed to a dense -|a - obs| reward so
    gradient methods see signal at float32.  Its draws are the next
    targets, uniform on [-1, 1)."""

    def draw(shape, generator):
        return 2.0 * uniform(tuple(shape) + (action_dim,), generator) - 1.0

    def reset(draws):
        t = torch.zeros(draws.shape[:-1], dtype=torch.int32,
                        device=draws.device)
        return (draws, t), draws

    def step(state, action, draws):
        target, t = state
        reward = -torch.mean(torch.abs(action - target), dim=-1)
        t = t + 1
        done = t >= ep_len
        new_target = torch.where(done[:, None], draws, target)
        t = torch.where(done, 0, t)
        return (new_target, t), new_target, reward, done

    return EnvFns(reset=reset, step=step, draw=draw, action_dim=action_dim,
                  obs_dim=action_dim)


# ---------------------------------------------------------------------------
# Optimizers: optax's transforms, formulas and state layout


class Transform(NamedTuple):
    """optax's ``GradientTransformation``: ``init(params) -> state``,
    ``update(grads, state, params) -> (updates, state)``."""

    init: Callable
    update: Callable


class EmptyState(NamedTuple):
    pass


class ScaleByAdamState(NamedTuple):
    count: torch.Tensor   # [] i32
    mu: Any
    nu: Any


class ScaleByRmsState(NamedTuple):
    nu: Any


class ScaleByScheduleState(NamedTuple):
    count: torch.Tensor   # [] i32


def _count0(params) -> torch.Tensor:
    return torch.zeros((), dtype=torch.int32,
                       device=tree_leaves(params)[0].device)


def identity() -> Transform:
    return Transform(lambda params: EmptyState(),
                     lambda g, state, params=None: (g, state))


def clip_by_global_norm(max_norm: float) -> Transform:
    """optax's: ``g`` where the global norm is below ``max_norm``, else
    ``g / norm * max_norm`` (not ``torch.nn.utils.clip_grad_norm_``,
    which scales by ``max_norm / (norm + 1e-6)``)."""

    def update(grads, state, params=None):
        leaves = tree_leaves(grads)
        sq = leaves[0].new_zeros(())
        for g in leaves:
            sq = sq + torch.sum(g * g)
        g_norm = torch.sqrt(sq)
        trigger = g_norm < max_norm
        return tree_map(lambda g: torch.where(trigger, g,
                                              (g / g_norm) * max_norm),
                        grads), state

    return Transform(lambda params: EmptyState(), update)


def _bias_correction(moment: List[torch.Tensor], decay: float,
                     count: torch.Tensor) -> List[torch.Tensor]:
    # decay ** count on the device: no host-to-device copy (a copy of a
    # host value would wait for the card every update)
    corr = 1.0 - torch.pow(decay, count.to(moment[0].dtype))
    return torch._foreach_div(moment, corr)


def _ema(new: List[torch.Tensor], old: List[torch.Tensor], decay: float):
    """optax's moment update, ``(1 - decay) * new + decay * old``."""
    return torch._foreach_add(torch._foreach_mul(new, 1 - decay),
                              torch._foreach_mul(old, decay))


def scale_by_adam(b1: float = 0.9, b2: float = 0.999, eps: float = 1e-8,
                  eps_root: float = 0.0) -> Transform:
    """The formulas of optax's ``scale_by_adam``, each one multi-tensor
    op (``torch._foreach_*``) over every leaf."""

    def init(params):
        return ScaleByAdamState(_count0(params),
                                tree_map(torch.zeros_like, params),
                                tree_map(torch.zeros_like, params))

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        mu = _ema(g, tree_leaves(state.mu), b1)
        nu = _ema(torch._foreach_mul(g, g), tree_leaves(state.nu), b2)
        count = state.count + 1
        mu_hat = _bias_correction(mu, b1, count)
        nu_hat = _bias_correction(nu, b2, count)
        den = torch._foreach_add(torch._foreach_sqrt(
            torch._foreach_add(nu_hat, eps_root)), eps)
        return (tree_unflatten(grads, torch._foreach_div(mu_hat, den)),
                ScaleByAdamState(count, tree_unflatten(grads, mu),
                                 tree_unflatten(grads, nu)))

    return Transform(init, update)


def scale_by_rms(decay: float = 0.9, eps: float = 1e-8,
                 initial_scale: float = 0.0) -> Transform:
    def init(params):
        return ScaleByRmsState(tree_map(
            lambda p: torch.full_like(p, initial_scale), params))

    def update(grads, state, params=None):
        g = tree_leaves(grads)
        nu = _ema(torch._foreach_mul(g, g), tree_leaves(state.nu), decay)
        scale = torch._foreach_rsqrt(torch._foreach_add(nu, eps))
        return (tree_unflatten(grads, torch._foreach_mul(scale, g)),
                ScaleByRmsState(tree_unflatten(grads, nu)))

    return Transform(init, update)


def linear_lr_schedule(init_value: float, end_value: float,
                       transition_steps: int) -> Callable:
    """``optax.linear_schedule``: ``(init - end) * (1 - t / T) + end`` with
    ``t`` the update count clipped to ``[0, T]``."""

    def schedule(count):
        c = torch.clamp(count, 0, transition_steps).to(torch.float32)
        return (init_value - end_value) * (1 - c / transition_steps) \
            + end_value

    return schedule


def scale_by_learning_rate(learning_rate) -> Transform:
    """Multiply by ``-learning_rate`` (a float, or a schedule of the
    update count kept in a ``ScaleByScheduleState``)."""

    def scaled(grads, step):
        return tree_unflatten(grads, torch._foreach_mul(tree_leaves(grads),
                                                        step))

    if not callable(learning_rate):
        return Transform(
            lambda params: EmptyState(),
            lambda g, state, params=None: (scaled(g, -learning_rate), state))

    def update(grads, state, params=None):
        step = -learning_rate(state.count)
        return (scaled(grads, step.to(tree_leaves(grads)[0].dtype)),
                ScaleByScheduleState(state.count + 1))

    return Transform(lambda params: ScaleByScheduleState(_count0(params)),
                     update)


def chain(*transforms: Transform) -> Transform:
    def init(params):
        return tuple(t.init(params) for t in transforms)

    def update(grads, state, params=None):
        new = []
        for t, s in zip(transforms, state):
            grads, s = t.update(grads, s, params)
            new.append(s)
        return grads, tuple(new)

    return Transform(init, update)


def adam(learning_rate, b1: float = 0.9, b2: float = 0.999,
         eps: float = 1e-8) -> Transform:
    return chain(scale_by_adam(b1, b2, eps), scale_by_learning_rate(learning_rate))


def rmsprop(learning_rate, decay: float = 0.9, eps: float = 1e-8) -> Transform:
    """optax's ``rmsprop`` (``eps`` inside the square root); its state is
    optax's layout, the third element the unused momentum trace."""
    return chain(scale_by_rms(decay, eps), scale_by_learning_rate(learning_rate),
                 identity())


def apply_updates(params, updates):
    return tree_unflatten(params, torch._foreach_add(tree_leaves(params),
                                                     tree_leaves(updates)))


LOG_2PI = math.log(2.0 * math.pi)
