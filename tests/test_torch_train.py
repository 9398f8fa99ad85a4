"""PyTorch port: the readable batch-first trainer (``train.py``) and the
sharded lane-major trainer (``train_fast.py`` over a mesh) against the
JAX package, mirroring ``tests/test_train.py`` and
``tests/test_train_fast.py:32-60``.

* ``make_trainer`` against JAX's on a one-device mesh, from JAX's state
  with JAX's draws (``fold_in(key, 0)``), zero reset jitter;
* ``make_trainer_fast`` on two gloo ranks against JAX's on two virtual
  devices, each rank fed its shard's draws (``fold_in(key, rank)``);
* the port's readable trainer against its fast one on two ranks, from
  one seed with the same draws (zero reset jitter: JAX's own contract
  between its two trainers), the replicated parameters bit-equal across
  the ranks after every step.

Tolerances are ``tests/test_torch_train_fast.py``'s (metrics rtol 1e-4 /
atol 1e-5, store values 1e-5, parameters rtol 1e-4 / atol 1e-6; the
attention's saturated ``q_lin`` / ``k_lin`` to ``lr`` a step, for the
reason given there)."""

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu import config as jcfg
from dcarl_tpu.parallel.mesh import make_mesh
from dcarl_tpu.train import make_trainer as j_make_trainer
from dcarl_tpu.train_fast import make_trainer_fast as j_make_trainer_fast
from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.env import driving_env as tde
from dcarl_tpu_torch.models.networks import AttentionQNet
from dcarl_tpu_torch.parallel.launch import run_ranks
from dcarl_tpu_torch.train import TrainState, make_trainer
from dcarl_tpu_torch.train_fast import TrainDraws, make_trainer_fast

import torch_rank_programs as RP

CPU = torch.device("cpu")
S = 2
STEPS = 12  # past the 10-step window, so records flush into the store
KW = dict(batch_per_device=4, store_capacity_per_device=512,
          replay_capacity_per_device=128)
METRIC_TOL = dict(rtol=1e-4, atol=1e-5)


def _cfg(mod):
    return mod.DCARLConfig(
        env=mod.EnvConfig(reset_jitter=0.0),
        dqn=mod.DQNConfig(batch_size=8, replay_capacity=256,
                          target_update_every=3))


def _key(step):
    return jax.random.PRNGKey(100 + step)


def shard_draws(key, cfg, shard) -> TrainDraws:
    """One shard's draws of a JAX trainer step (``train_fast.py:217``,
    ``train.py:207``: ``fold_in(key, axis_index)``, then act / gate /
    env / train)."""
    b = KW["batch_per_device"]
    key = jax.random.fold_in(key, shard)
    k_act, k_gate, _k_env, k_train = jax.random.split(key, 4)
    k_eps, k_a = jax.random.split(k_act)
    out = TrainDraws(
        eps_uniform=jax.random.uniform(k_eps, (b,)),
        random_action=jax.random.randint(k_a, (b,), 0,
                                         cfg.werling.num_paths + 1),
        gate_uniform=jax.random.uniform(k_gate, (b,),
                                        minval=cfg.store.explore_low,
                                        maxval=cfg.store.explore_high),
        gumbel=jax.random.gumbel(
            k_train, (cfg.dqn.batch_size, KW["replay_capacity_per_device"])))
    return TrainDraws(*(torch.as_tensor(np.array(x)) for x in out))


def _load_learner(learner, s):
    interop.qnet_from_flax(s.params, learner.net)
    interop.qnet_from_flax(s.target_params, learner.target_net)
    interop.adam_state_from_optax(s.opt_state, learner.optimizer,
                                  learner.net)


def _train_state_from_numpy(s) -> TrainState:
    """JAX's batch-first ``TrainState`` as the port's (learner apart)."""
    f32 = torch.float32

    def t(a, dt=f32):
        return torch.as_tensor(np.array(a)).to(dt)

    env = tde.EnvState(*(x[None] for x in interop.env_state_from_numpy(
        jax.tree.map(lambda a: np.asarray(a)[0], s.env), CPU)))
    return TrainState(
        env=env, obs_ori=t(s.obs_ori), traj_obs=t(s.traj_obs),
        traj_act=t(s.traj_act), traj_rew=t(s.traj_rew),
        traj_len=t(s.traj_len, torch.int32), store_keys=t(s.store_keys),
        store_actions=t(s.store_actions), store_values=t(s.store_values),
        store_size=t(s.store_size, torch.int32),
        store_head=t(s.store_head, torch.int32),
        replay=interop.replay_from_numpy(s.replay, CPU),
        frame=t(s.frame, torch.int32))


def _assert_params(got: dict, ref_params, steps, name_tol=None):
    lr = _cfg(tcfg).dqn.lr
    ref = interop.qnet_from_flax(ref_params, AttentionQNet(11))
    for (name, r) in ref.named_parameters():
        tol = (dict(rtol=0, atol=steps * lr) if name[:5] in ("q_lin", "k_lin")
               else dict(rtol=1e-4, atol=1e-6))
        np.testing.assert_allclose(got[name], r.detach().numpy(),
                                   err_msg=name, **tol)


def _assert_metrics(got, ref):
    for step, (mt, mj) in enumerate(zip(got, ref)):
        for name in mj._fields:
            np.testing.assert_allclose(
                np.asarray(mt[name] if isinstance(mt, dict)
                           else getattr(mt, name), np.float64),
                np.asarray(getattr(mj, name), np.float64),
                err_msg=f"step {step} metric {name}", **METRIC_TOL)


def test_readable_trainer_matches_jax():
    cfg = _cfg(jcfg)
    mesh = make_mesh("env", jax.devices()[:1])
    init_j, step_j, _ = j_make_trainer(mesh, "env", cfg, **KW)
    s0 = init_j(seed=0)
    _, step_t, learner = make_trainer(_cfg(tcfg), device="cpu", **KW)
    _load_learner(learner, s0)
    s_t = _train_state_from_numpy(s0)
    s_j, m_j, m_t = s0, [], []
    for step in range(STEPS):
        s_j, m = step_j(s_j, _key(step))
        m_j.append(m)
        s_t, m = step_t.with_draws(s_t, shard_draws(_key(step), cfg, 0),
                                   torch.Generator().manual_seed(step))
        m_t.append(m)
    _assert_metrics(m_t, m_j)
    for name in ("store_size", "store_head", "traj_len"):
        np.testing.assert_array_equal(getattr(s_t, name).numpy(),
                                      np.asarray(getattr(s_j, name)), name)
    np.testing.assert_array_equal(s_t.store_keys.numpy(),
                                  np.asarray(s_j.store_keys, np.float32))
    np.testing.assert_allclose(s_t.store_values.numpy(),
                               np.asarray(s_j.store_values), rtol=0,
                               atol=1e-5)
    _assert_params({k: v.detach().numpy()
                    for k, v in learner.net.named_parameters()},
                   s_j.params, STEPS)
    assert int(s_t.store_size[0]) > 0 and int(s_t.frame) == STEPS


@pytest.fixture(scope="module")
def sharded():
    """JAX's fast trainer on two devices, and the port's checks on two
    gloo ranks (one spawn)."""
    cfg = _cfg(jcfg)
    mesh = make_mesh("env", jax.devices()[:S])
    init_j, step_j, _, _ = j_make_trainer_fast(mesh, "env", cfg,
                                               use_pallas=False, **KW)
    s0 = init_j(seed=0)
    s_j, metrics = s0, []
    for step in range(STEPS):
        s_j, m = step_j(s_j, _key(step))
        metrics.append(m)
    _, _, learner, _ = make_trainer_fast(_cfg(tcfg), device="cpu",
                                         use_kernel=False, **KW)
    _load_learner(learner, s0)
    payload = dict(kw=KW, steps=STEPS, jax=dict(
        learner=learner.state_dict(),
        state=interop.fast_train_state_from_numpy(s0, CPU),
        draws=[[tuple(shard_draws(_key(step), cfg, r))
                for step in range(STEPS)] for r in range(S)]))
    outs = run_ranks(RP.trainer_checks, S, "gloo", "cpu", timeout_s=120,
                     args=(payload,))
    return s_j, metrics, outs


def test_sharded_fast_trainer_matches_jax(sharded):
    s_j, metrics, outs = sharded
    for r, o in enumerate(outs):
        _assert_metrics(o["fast_metrics"], metrics)
        st = o["fast_state"]
        for name in ("store_size", "store_head", "store_total", "traj_len"):
            np.testing.assert_array_equal(
                st[name][0], np.asarray(getattr(s_j, name))[r], name)
        np.testing.assert_array_equal(
            st["store_keys"][0], np.asarray(s_j.store_keys, np.float32)[r])
        np.testing.assert_allclose(st["store_values"][0],
                                   np.asarray(s_j.store_values)[r], rtol=0,
                                   atol=1e-5)
        _assert_params(o["fast_params"], s_j.params, STEPS)
    assert sum(int(o["fast_state"]["store_size"][0]) for o in outs) > 0


def test_readable_trainer_matches_fast_trainer_sharded(sharded):
    _, _, outs = sharded
    for o in outs:
        for step, (ma, mb) in enumerate(zip(o["readable_metrics"],
                                            o["fast_metrics_b"])):
            for name in ma:
                np.testing.assert_allclose(
                    np.float64(ma[name]), np.float64(mb[name]),
                    err_msg=f"step {step} metric {name}", **METRIC_TOL)
        (size_a, vals_a), (size_b, vals_b) = (o["readable_store"],
                                              o["fast_store"])
        np.testing.assert_array_equal(size_a, size_b)
        np.testing.assert_allclose(vals_a, vals_b, rtol=1e-5, atol=1e-6)
        for name, p in o["readable_params"].items():
            np.testing.assert_allclose(p, o["fast_params_b"][name],
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        assert all(o["params_equal_across_ranks"])
    # the two ranks hold the same replicated learner
    for name, p in outs[0]["fast_params_b"].items():
        np.testing.assert_array_equal(p, outs[1]["fast_params_b"][name])
