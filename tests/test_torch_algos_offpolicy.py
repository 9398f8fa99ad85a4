"""PyTorch port of the algorithm family, off-policy half: DDPG, TD3, SAC
and HER-DQN (with the bit-flipping env and the future-strategy buffer)
against the JAX package (``dcarl_tpu/algos``).

As in ``tests/test_torch_algos_onpolicy.py``: both packages start from
the JAX ``init_fn``'s state, each port update takes the JAX update's
draws (``tests/torch_algos_jax.py``) and three updates are held to rtol
1e-5 / atol 1e-6, integers exactly.  The replay sample's indices are
JAX's: every stored priority is 1, so ``replay_sample`` is a uniform
draw over the occupied rows, which the port takes as given indices.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.algos import common as JC
from dcarl_tpu.algos import ddpg as JDDPG
from dcarl_tpu.algos import her as JHER
from dcarl_tpu.algos import sac as JSAC
from dcarl_tpu.algos import td3 as JTD3
from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import ddpg as DDPG
from dcarl_tpu_torch.algos import her as HER
from dcarl_tpu_torch.algos import sac as SAC
from dcarl_tpu_torch.algos import td3 as TD3

import torch_algos_jax as H
from torch_algos_jax import one_torch_thread  # noqa: F401 (fixture)

STEPS = 3
HID = (16, 16)
B = 8
A = 2


def _keys():
    return [jax.random.PRNGKey(100 + i) for i in range(STEPS)]


def _jax_run(init, update, *init_args):
    with H.f32():
        st = init(jax.random.PRNGKey(0), *init_args)
        step = jax.jit(update)
        states, metrics = [jax.device_get(st)], []
        for k in _keys():
            st, m = step(st, k)
            states.append(jax.device_get(st))
            metrics.append(jax.device_get(m))
    return states, metrics


def _ddpg_like(cls, s, actor, critic):
    return cls(H.params(s.actor_params, actor), H.params(s.critic_params, critic),
               H.params(s.target_actor, actor), H.params(s.target_critic, critic),
               H.opt(s.actor_opt, actor), H.opt(s.critic_opt, critic),
               H.replay(s.replay), H.t(s.env_state), H.t(s.obs), H.t(s.step))


CFG = dict(batch_size=16, replay_capacity=64, train_start=8)


@pytest.mark.parametrize("algo", ["ddpg", "td3", "sac"])
def test_off_policy_matches_jax(algo):
    jenv, tenv = JC.identity_env_box(A), C.identity_env_box(A)
    if algo == "ddpg":
        jfns = JDDPG.make_ddpg(jenv, JDDPG.DDPGConfig(**CFG), HID)
        init, upd, _ = DDPG.make_ddpg(tenv, DDPG.DDPGConfig(**CFG), HID)
        n_keys = 3

        def convert(s):
            return _ddpg_like(DDPG.DDPGState, s, upd.actor, upd.critic)
    elif algo == "td3":
        jfns = JTD3.make_td3(jenv, JTD3.TD3Config(**CFG), HID)
        init, upd, _ = TD3.make_td3(tenv, TD3.TD3Config(**CFG), HID)
        n_keys = 4

        def convert(s):
            return _ddpg_like(TD3.TD3State, s, upd.actor, upd.critic)
    else:
        jfns = JSAC.make_sac(jenv, JSAC.SACConfig(**CFG), HID)
        init, upd, _ = SAC.make_sac(tenv, SAC.SACConfig(**CFG), HID)
        n_keys = 5

        def convert(s):
            return SAC.SACState(
                H.params(s.actor_params, upd.actor),
                H.params(s.critic_params, upd.critic),
                H.params(s.target_critic, upd.critic), H.t(s.log_alpha),
                H.opt(s.actor_opt, upd.actor), H.opt(s.critic_opt, upd.critic),
                H.opt(s.alpha_opt, None), H.replay(s.replay),
                H.t(s.env_state), H.t(s.obs), H.t(s.step))

    js, jm = _jax_run(*jfns[:2], B)
    state = convert(js[0])
    for i, k in enumerate(_keys()):
        draws = H.off_policy_draws(k, n_keys, B, A, CFG["batch_size"],
                                   js[i + 1].replay)
        state, m = upd.with_draws(state, draws)
        H.assert_close(state, convert(js[i + 1]), what=f"update {i}")
        H.assert_metrics(m, jm[i], [k2 for k2 in jm[i]])
    # trained: the replay passed train_start in the second update
    assert int(state.replay.size) == 3 * B


def test_ddpg_learns_identity_box_on_jax_draws():
    """``tests/test_algos.py::test_ddpg_identity_box`` on the port: its
    configuration, init (``PRNGKey(0)``, carried over) and every draw of
    its 800 updates (``PRNGKey(1000 + i)``); the deterministic policy's
    mean error on fresh targets must be below 0.15, as there."""
    cfg = dict(batch_size=64, replay_capacity=4096, actor_lr=1e-3,
               critic_lr=1e-3)
    jenv = JC.identity_env_box(1)
    with H.f32():
        j_init, _, _ = JDDPG.make_ddpg(jenv, JDDPG.DDPGConfig(**cfg))
        s0 = jax.device_get(j_init(jax.random.PRNGKey(0), 32))

        @jax.jit
        def draws(key, size):
            k_act, k_env, k_sample = jax.random.split(key, 3)
            occupied = jnp.arange(4096) < size
            g = jax.random.gumbel(k_sample, (64, 4096))
            idx = jnp.argmax(jnp.where(occupied, 0.0, -jnp.inf)[None] + g, 1)
            env = jax.vmap(lambda k: jax.random.uniform(
                k, (1,), minval=-1.0, maxval=1.0))(jax.random.split(k_env, 32))
            return jax.random.normal(k_act, (32, 1)), env, idx

        all_draws = [jax.device_get(draws(jax.random.PRNGKey(1000 + i),
                                          min(32 * (i + 1), 4096)))
                     for i in range(800)]
    _, upd, act = DDPG.make_ddpg(C.identity_env_box(1),
                                 DDPG.DDPGConfig(**cfg))
    state = _ddpg_like(DDPG.DDPGState, s0, upd.actor, upd.critic)
    for noise, env, idx in all_draws:
        state, _ = upd.with_draws(state, DDPG.OffPolicyDraws(
            H.t(noise), H.t(env), H.t(idx).long()))
    err = float(torch.mean(torch.abs(act(state, state.obs) - state.obs)))
    assert err < 0.15, err


# ---------------------------------------------------------------------------
# HER


def test_bit_flipping_env_matches_jax():
    jreset, jstep, T = JHER.bit_flipping_env(4)
    treset, tstep, T2 = HER.bit_flipping_env(4)
    assert T == T2
    rng = np.random.default_rng(0)
    with H.f32():
        d = H.her_draws(jax.random.PRNGKey(2), B, 4, T, 1, 4, 1)
        k_roll, _ = jax.random.split(jax.random.PRNGKey(2))
        k_r, k_s = jax.random.split(k_roll)
        jst, jobs = jreset(jax.random.split(k_r, B))
        tst, tobs = treset(d.reset)
        for t, k in enumerate(jax.random.split(k_s, T)):
            a = rng.integers(0, 4, B).astype(np.int32)
            _, _, kv = jax.random.split(k, 3)
            jst, jobs, jr, jd = jstep(jst, jnp.asarray(a),
                                      jax.random.split(kv, B))
            tst, tobs, tr, td = tstep(tst, torch.as_tensor(a), C.tree_map(
                lambda x: x[t], d.step_reset))
            for got, want in ((tobs, jobs), (tr, jr), (td, jd),
                              *zip(tst, jst)):
                np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_her_buffer_relabel_matches_jax():
    """``tests/test_algos.py::test_her_buffer_relabel_semantics``'s buffer
    on both packages: the same relabel mask, goals, rewards and done
    flags on JAX's draws, and the test's semantic checks on the port."""
    obs = np.asarray([[[0., 0.], [1., 0.], [1., 1.]]], np.float32)
    act = np.asarray([[0, 1, 0]], np.int32)
    nxt = np.asarray([[[1., 0.], [1., 1.], [0., 1.]]], np.float32)
    goal = np.asarray([[1., 1.]], np.float32)
    with H.f32():
        jb = JHER.her_buffer_push(JHER.her_buffer_init(4, 3, 2),
                                  *(jnp.asarray(a) for a in (obs, act, nxt,
                                                             goal)),
                                  jnp.asarray([3]))
        key = jax.random.PRNGKey(0)
        want = JHER.her_sample(jb, key, 64, relabel_prob=0.5)
        k_e, k_t, k_f, k_p = jax.random.split(key, 4)
        draws = HER.HERSampleDraws(
            H.t(jax.random.randint(k_e, (64,), 0, 1)).long(),
            *(H.t(jax.random.uniform(k, (64,))) for k in (k_t, k_f, k_p)))
    tb = HER.her_buffer_push(HER.her_buffer_init(4, 3, 2, device="cpu"),
                             *(torch.as_tensor(a) for a in (obs, act, nxt,
                                                            goal)),
                             torch.tensor([3]))
    assert int(tb.size) == 1
    got = HER.her_sample(tb, draws, relabel_prob=0.5)
    relabel = draws.u_relabel < 0.5
    assert 0 < int(relabel.sum()) < 64
    for name in HER.HERBatch._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    # relabeled goals are achieved states of the episode; reward 0 exactly
    # where the next state matches the goal
    for g in got.obs[relabel, 2:].numpy():
        assert any((g == nxt[0, i]).all() for i in range(3))
    match = torch.all(got.next_obs[:, :2] == got.obs[:, 2:], dim=-1)
    assert torch.equal(got.reward == 0.0, match)


def test_her_dqn_matches_jax():
    n_bits, T, bs = 4, 4, 16
    jcfg = JHER.HERDQNConfig(batch_size=bs, buffer_episodes=16,
                             target_period=2)
    tcfg = HER.HERDQNConfig(batch_size=bs, buffer_episodes=16,
                            target_period=2)
    with H.f32():
        j_init, j_upd, _, _ = JHER.make_her_dqn(n_bits, jcfg, (32,))
        st = j_init(jax.random.PRNGKey(0))
        step = jax.jit(lambda s, k: j_upd(s, k, batch=B, n_updates=2))
        js = [jax.device_get(st)]
        for k in _keys():
            st = step(st, k)
            js.append(jax.device_get(st))
    _, upd, _, _ = HER.make_her_dqn(n_bits, tcfg, (32,))

    def convert(s):
        return HER.HERDQNState(
            H.params(s.params, upd.net), H.params(s.target_params, upd.net),
            H.opt(s.opt_state, upd.net), HER.HERBuffer(*H.t(tuple(s.buffer))),
            H.t(s.step))

    state = convert(js[0])
    for i, k in enumerate(_keys()):
        size_after = min(int(state.buffer.size) + B, 16)
        state = upd.with_draws(state, H.her_draws(k, B, n_bits, T, 2, bs,
                                                  size_after))
        H.assert_close(state, convert(js[i + 1]), what=f"update {i}")
