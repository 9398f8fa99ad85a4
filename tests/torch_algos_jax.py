"""Helpers of the algorithm-family tests (``tests/test_torch_algos_*.py``):
JAX's draws replayed from its key splits, and JAX states carried into
the port's.

Each ``*_draws(key, ...)`` returns the draws the JAX ``update_fn(state,
key)`` makes, in the port's ``update_fn.draw`` layout, by repeating its
splits: ``collect_rollout`` splits the key into one key a step, each
into (act, env), the env key into one key an env.  The JAX side runs
with 64-bit mode off, the float32 the JAX package was written for.
"""

from __future__ import annotations

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcarl_tpu.models import replay as JRB
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.algos import acer as ACER
from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import ddpg as DDPG
from dcarl_tpu_torch.algos import gail as GAIL
from dcarl_tpu_torch.algos import her as HER
from dcarl_tpu_torch.algos import ppo as PPO
from dcarl_tpu_torch.algos import sac as SAC
from dcarl_tpu_torch.algos import td3 as TD3
from dcarl_tpu_torch.models import replay as RB

CPU = "cpu"


_X64 = [False]


def f32():
    """JAX in float32 (the enclosing test suite turns 64-bit mode on),
    unless inside :func:`x64`."""
    return jax.enable_x64(_X64[0])


@contextlib.contextmanager
def x64():
    """JAX's draws and updates in 64-bit mode (for a float64 comparison)."""
    _X64[0] = True
    try:
        with jax.enable_x64(True):
            yield
    finally:
        _X64[0] = False


def _in_f32(fn):
    """Make ``fn``'s JAX draws in float32 / int32, as the updates do
    (float64 / int64 inside :func:`x64`)."""
    @functools.wraps(fn)
    def wrapped(*args, **kwargs):
        with f32():
            return fn(*args, **kwargs)
    return wrapped


@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """The port's side on one intra-op thread for the module: these
    learners run thousands of tiny ops, which the suite's parallel
    workers would otherwise make spin for each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def t(a):
    """A JAX/numpy array (or a tree of them) as tensors of the same
    dtype on the CPU."""
    if isinstance(a, tuple) and hasattr(a, "_fields"):
        return type(a)(*(t(x) for x in a))
    if isinstance(a, (tuple, list)):
        return type(a)(t(x) for x in a)
    if isinstance(a, dict):
        return {k: t(v) for k, v in a.items()}
    return torch.as_tensor(np.array(a))


@_in_f32
def env_draws(keys, env_kind: str, n: int):
    """The env's step / reset draws from one key an env (``identity``:
    randint in [0, n); ``box``: uniform [-1, 1) of width n)."""
    if env_kind == "identity":
        return jax.vmap(lambda k: jax.random.randint(k, (), 0, n))(keys)
    return jax.vmap(lambda k: jax.random.uniform(k, (n,), minval=-1.0,
                                                 maxval=1.0))(keys)


@_in_f32
def rollout_draws(key, n_steps: int, batch: int, policy_shape,
                  env_kind: str, n: int, policy: str = "gumbel"):
    """``common.collect_rollout``'s draws (``common.py:116-128``)."""
    def one(k):
        k_act, k_env = jax.random.split(k)
        if policy == "gumbel":
            p = jax.random.gumbel(k_act, (batch,) + tuple(policy_shape))
        else:
            p = jax.random.normal(k_act, (batch,) + tuple(policy_shape))
        return p, env_draws(jax.random.split(k_env, batch), env_kind, n)

    p, e = jax.vmap(one)(jax.random.split(key, n_steps))
    return C.RolloutDraws(t(p), t(e))


@_in_f32
def reset_draws(key, batch: int, env_kind: str, n: int):
    """``init_fn``'s env reset draws from its env key."""
    return t(env_draws(jax.random.split(key, batch), env_kind, n))


@_in_f32
def ppo_draws(key, n_steps, batch, shape, env_kind, n, n_epochs,
              policy="gumbel"):
    k_roll, k_perm = jax.random.split(key)
    perms = jax.vmap(lambda k: jax.random.permutation(k, n_steps * batch))(
        jax.random.split(k_perm, n_epochs))
    return PPO.PPODraws(rollout_draws(k_roll, n_steps, batch, shape,
                                      env_kind, n, policy), t(perms))


@_in_f32
def acktr_draws(key, n_steps, batch, num_actions):
    from dcarl_tpu_torch.algos.acktr import ACKTRDraws
    k_roll, k_fisher = jax.random.split(key)
    n = n_steps * batch
    return ACKTRDraws(
        rollout_draws(k_roll, n_steps, batch, (num_actions,), "identity",
                      num_actions),
        t(jax.random.gumbel(k_fisher, (n, num_actions))),
        t(jax.random.normal(jax.random.fold_in(k_fisher, 1), (n,))))


@_in_f32
def acer_draws(key, n_steps, batch, num_actions, replay_ratio, size_after):
    k_roll, k_replay = jax.random.split(key)
    idx = [jax.random.randint(k, (), 0, max(size_after, 1))
           for k in jax.random.split(k_replay, replay_ratio)]
    return ACER.ACERDraws(
        rollout_draws(k_roll, n_steps, batch, (num_actions,), "identity",
                      num_actions), t(jnp.stack(idx)).long())


@_in_f32
def gail_draws(key, cfg, batch, num_actions, n_expert):
    from dcarl_tpu_torch.algos.trpo import TRPODraws
    k_g, k_d = jax.random.split(key)
    gen = [TRPODraws(rollout_draws(k, cfg.trpo.n_steps, batch,
                                   (num_actions,), "identity", num_actions))
           for k in jax.random.split(k_g, cfg.g_step)]
    n_gen = cfg.g_step * cfg.trpo.n_steps * batch
    gi, ei = [], []
    for k in jax.random.split(k_d, cfg.d_step):
        kg, ke = jax.random.split(k)
        gi.append(jax.random.randint(kg, (cfg.d_batch,), 0, n_gen))
        ei.append(jax.random.randint(ke, (cfg.d_batch,), 0, n_expert))
    return GAIL.GAILDraws(gen, t(jnp.stack(gi)).long(),
                          t(jnp.stack(ei)).long())


@_in_f32
def replay_indices(replay_after, key, batch_size):
    """``replay_sample``'s indices: every stored priority is 1, so this
    is the Gumbel argmax over the occupied rows."""
    return t(JRB.replay_sample(replay_after, key, batch_size).indices).long()


@_in_f32
def off_policy_draws(key, n_keys, batch, action_dim, batch_size,
                     replay_after):
    """DDPG (3 keys), TD3 (4) and SAC (5): act noise, env draws, replay
    indices, then TD3's target noise or SAC's two sample normals."""
    ks = jax.random.split(key, n_keys)
    step = DDPG.OffPolicyDraws(
        t(jax.random.normal(ks[0], (batch, action_dim))),
        t(env_draws(jax.random.split(ks[1], batch), "box", action_dim)),
        replay_indices(replay_after, ks[2], batch_size))
    extra = [t(jax.random.normal(k, (batch_size, action_dim)))
             for k in ks[3:]]
    if n_keys == 3:
        return step
    if n_keys == 4:
        return TD3.TD3Draws(step, *extra)
    return SAC.SACDraws(step, *extra)


@_in_f32
def her_draws(key, batch, n_bits, T, n_updates, batch_size, size_after):
    """``make_her_dqn``'s update draws (``her.py:210-262``)."""
    def pair(k):
        k1, k2 = jax.random.split(k)
        return (jax.random.bernoulli(k1, 0.5, (n_bits,)).astype(jnp.float32),
                jax.random.bernoulli(k2, 0.5, (n_bits,)).astype(jnp.float32))

    k_roll, k_train = jax.random.split(key)
    k_r, k_s = jax.random.split(k_roll)
    bits, goal = jax.vmap(pair)(jax.random.split(k_r, batch))
    eps, rand, sb, sg = [], [], [], []
    for k in jax.random.split(k_s, T):
        ke, ka, kv = jax.random.split(k, 3)
        eps.append(jax.random.uniform(ke, (batch,)))
        rand.append(jax.random.randint(ka, (batch,), 0, n_bits))
        b, g = jax.vmap(pair)(jax.random.split(kv, batch))
        sb.append(b)
        sg.append(g)
    samples = []
    for k in jax.random.split(k_train, n_updates):
        k_e, k_t, k_f, k_p = jax.random.split(k, 4)
        samples.append(HER.HERSampleDraws(
            t(jax.random.randint(k_e, (batch_size,), 0, max(size_after, 1))
              ).long(),
            t(jax.random.uniform(k_t, (batch_size,))),
            t(jax.random.uniform(k_f, (batch_size,))),
            t(jax.random.uniform(k_p, (batch_size,)))))
    return HER.HERDQNDraws(
        HER.BitFlipDraws(t(bits), t(goal)), t(jnp.stack(eps)),
        t(jnp.stack(rand)), HER.BitFlipDraws(t(jnp.stack(sb)),
                                            t(jnp.stack(sg))), samples)


# ---------------------------------------------------------------------------
# Carried state


def params(tree, net):
    return interop.algo_params_from_flax(tree, net, CPU)


def opt(state, net):
    return interop.adam_state_from_optax(state, None, net, CPU)


def replay(src):
    f = src._asdict()
    return RB.Replay(**{k: t(v) for k, v in f.items()})


def assert_close(got, want, rtol=1e-5, atol=1e-6, what=""):
    """Two trees of tensors (the port's layout) leaf by leaf; integer and
    bool leaves exactly."""
    g, w = C.tree_leaves(got), C.tree_leaves(want)
    assert len(g) == len(w), what
    for i, (a, b) in enumerate(zip(g, w)):
        a, b = a.detach().cpu().numpy(), b.detach().cpu().numpy()
        if np.issubdtype(b.dtype, np.floating):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"{what} leaf {i}")
        else:
            np.testing.assert_array_equal(a, b, err_msg=f"{what} leaf {i}")


def assert_metrics(got, want, keys, rtol=1e-5, atol=1e-6):
    for k in keys:
        np.testing.assert_allclose(float(got[k]), float(want[k]), rtol=rtol,
                                   atol=atol, err_msg=k)
