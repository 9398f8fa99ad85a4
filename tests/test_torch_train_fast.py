"""PyTorch port: the lane-major integrated trainer against the JAX
package's, step for step.

Both start from the JAX ``init_fn`` state (reset jitter 0, 4 envs, a
512-row store, a 128-row replay, DQN batch 8, target sync every 3
frames), carried across with ``dcarl_tpu_torch.interop``.  Each step the
port takes the random draws the JAX step makes from the same key
(``fold_in(key, 0)``, ``split(., 4)`` into act / gate / env / train, then
``split(k_act)`` into eps / action), through ``step_fn.with_draws``.  With
jitter 0 the env's auto-reset draws change nothing.

The suite runs JAX with ``jax_enable_x64``: the JAX trainer's store,
trajectory buffers and draws are then float64, while the port runs them
in the env's float32.  The stored keys are float32 observations either
way; values and the learner differ by float32 rounding, which the
tolerances below cover (metrics rtol 1e-4 / atol 1e-5, store values
1e-5, params rtol 1e-4 / atol 1e-6: those of ``tests/test_train_fast.py``).

One exception, with its reason: the attention's ``q_lin`` and ``k_lin``.
On the trainer's world-frame observations (positions near 242 m) the
attention scores lie ~1e3 apart, the softmax is exactly one-hot, and the
true gradient into those two layers is 0.  Eager JAX and the port both
return 0; JAX under ``jit`` returns rounding noise of order 0.1-1 (its
fused softmax backward), and Adam turns any nonzero gradient into a step
of about ``lr``.  So those two layers are held to ``lr`` per step, and
the forward pass (which the one-hot softmax makes blind to them) to the
metrics' tolerance.  ``tests/test_torch_models.py`` holds the rest of
the network to rtol 1e-4 / atol 1e-6 after Adam steps on unsaturated
inputs.
"""

import jax
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu import config as jcfg
from dcarl_tpu.parallel.mesh import make_mesh
from dcarl_tpu.train_fast import make_trainer_fast as j_make_trainer_fast
from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.models.networks import AttentionQNet
from dcarl_tpu_torch.train_fast import TrainDraws, make_trainer_fast

CPU = torch.device("cpu")
STEPS = 12  # past the 10-step window, so records flush into the store
KW = dict(batch_per_device=4, store_capacity_per_device=512,
          replay_capacity_per_device=128)
VARIANTS = {"exact": {},
            "budget_dense": dict(backfill_budget_per_step=60,
                                 dense_store_writes=True)}


def _cfg(mod):
    return mod.DCARLConfig(
        env=mod.EnvConfig(reset_jitter=0.0),
        dqn=mod.DQNConfig(batch_size=8, replay_capacity=256,
                          target_update_every=3))


def _key(step):
    return jax.random.PRNGKey(100 + step)


def jax_draws(key, cfg, kw=KW) -> TrainDraws:
    """The draws of one JAX trainer step (``train_fast.py:217``,
    ``dqn.py:94-99``, ``rls.py:138``, ``replay.py:146``)."""
    b = kw["batch_per_device"]
    key = jax.random.fold_in(key, 0)
    k_act, k_gate, _k_env, k_train = jax.random.split(key, 4)
    k_eps, k_a = jax.random.split(k_act)
    num_actions = cfg.werling.num_paths + 1
    out = TrainDraws(
        eps_uniform=jax.random.uniform(k_eps, (b,)),
        random_action=jax.random.randint(k_a, (b,), 0, num_actions),
        gate_uniform=jax.random.uniform(k_gate, (b,),
                                        minval=cfg.store.explore_low,
                                        maxval=cfg.store.explore_high),
        gumbel=jax.random.gumbel(
            k_train, (cfg.dqn.batch_size, kw["replay_capacity_per_device"])))
    return TrainDraws(*(torch.as_tensor(np.array(x)) for x in out))


@pytest.fixture(scope="module", params=sorted(VARIANTS))
def jax_run(request):
    """One JAX trainer (1-device mesh, the brute ``_raw_moments`` route):
    its initial state, per-step metrics and final state."""
    cfg = _cfg(jcfg)
    mesh = make_mesh("env", jax.devices()[:1])
    init_j, step_j, _, _ = j_make_trainer_fast(
        mesh, "env", cfg, use_pallas=False, **KW, **VARIANTS[request.param])
    s0 = init_j(seed=0)
    s, metrics = s0, []
    for step in range(STEPS):
        s, m = step_j(s, _key(step))
        metrics.append(m)
    return request.param, s0, metrics, s


def _port(variant, s0, use_kernel):
    """A port trainer started from the JAX state ``s0``."""
    init_t, step_t, learner, _ = make_trainer_fast(
        _cfg(tcfg), device="cpu", use_kernel=use_kernel, **KW,
        **VARIANTS[variant])
    interop.qnet_from_flax(s0.params, learner.net)
    interop.qnet_from_flax(s0.target_params, learner.target_net)
    interop.adam_state_from_optax(s0.opt_state, learner.optimizer,
                                  learner.net)
    return step_t, learner, interop.fast_train_state_from_numpy(s0, CPU)


def _run_port(step_t, state, steps=STEPS):
    cfg = _cfg(jcfg)
    metrics = []
    for step in range(steps):
        state, m = step_t.with_draws(state, jax_draws(_key(step), cfg),
                                     torch.Generator().manual_seed(step))
        metrics.append(m)
    return state, metrics


def test_trainer_matches_jax_step_for_step(jax_run):
    variant, s0, metrics_j, s_j = jax_run
    step_t, learner, state = _port(variant, s0, use_kernel=False)
    state, metrics_t = _run_port(step_t, state)
    for step, (mj, mt) in enumerate(zip(metrics_j, metrics_t)):
        for name in mj._fields:
            np.testing.assert_allclose(
                np.asarray(getattr(mt, name), np.float64),
                np.asarray(getattr(mj, name), np.float64),
                rtol=1e-4, atol=1e-5, err_msg=f"step {step} metric {name}")

    for name in ("store_size", "store_head", "store_total", "traj_len"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(s_j, name)), name)
    np.testing.assert_array_equal(state.store_keys.numpy(),
                                  np.asarray(s_j.store_keys, np.float32))
    np.testing.assert_allclose(state.store_values.numpy(),
                               np.asarray(s_j.store_values), rtol=0,
                               atol=1e-5)
    np.testing.assert_array_equal(state.replay.size.numpy(),
                                  np.asarray(s_j.replay.size))
    np.testing.assert_allclose(state.replay.priority.numpy(),
                               np.asarray(s_j.replay.priority), rtol=1e-4,
                               atol=1e-6)
    lr = _cfg(tcfg).dqn.lr
    for tree, net in ((s_j.params, learner.net),
                      (s_j.target_params, learner.target_net)):
        ref = interop.qnet_from_flax(tree, AttentionQNet(11))
        for (name, p), r in zip(net.named_parameters(), ref.parameters()):
            tol = (dict(rtol=0, atol=STEPS * lr) if name[:5] in ("q_lin",
                                                                 "k_lin")
                   else dict(rtol=1e-4, atol=1e-6))
            np.testing.assert_allclose(p.detach().numpy(),
                                       r.detach().numpy(), err_msg=name,
                                       **tol)
    # the store grew with real (non-sentinel) rows and the learner trained
    real = state.store_keys[0, :, 0].abs() < 1e8
    assert int(state.store_size[0]) > 0 and int(real.sum()) > 0
    assert all(np.isfinite(float(m.loss)) for m in metrics_t)
    assert int(state.frame) == STEPS


def test_kernel_route_equals_raw_route(jax_run):
    """use_kernel=True on the CPU (grouped wrapper + the sorted kernel's
    plain version) against the brute route, from the same state with the
    same draws: every integer output and store field equal."""
    variant, s0, _, _ = jax_run
    runs = []
    for use_kernel in (False, True):
        step_t, learner, state = _port(variant, s0, use_kernel)
        runs.append(_run_port(step_t, state))
    (sa, ma), (sb, mb) = runs
    for name in ("done_count", "pass_count", "collision_count", "store_rows",
                 "dropped_records", "rule_fraction"):
        np.testing.assert_array_equal(
            torch.stack([getattr(m, name) for m in ma]).numpy(),
            torch.stack([getattr(m, name) for m in mb]).numpy(), name)
    for name in ("store_keys", "store_actions", "store_values", "store_size",
                 "store_head", "store_total", "traj_len", "traj_act"):
        np.testing.assert_array_equal(getattr(sa, name).numpy(),
                                      getattr(sb, name).numpy(), name)
    np.testing.assert_array_equal(sa.replay.action.numpy(),
                                  sb.replay.action.numpy())


def _rule_column_matches(state) -> int:
    """Contained (query, row) pairs of the rule-column query the next
    step makes: the fleet's observations || action 0 against the valid
    store rows, by a numpy brute force apart from both packages."""
    keys = np.asarray(state.store_keys, np.float32)[0]
    keys = keys[:int(np.asarray(state.store_size)[0])]
    obs = np.asarray(state.obs_ori, np.float32)[0].T
    q = np.concatenate([obs, np.zeros_like(obs[:, :1])], 1)
    hw = np.asarray(tcfg.driving_store_config().half_widths, np.float32)
    return int((np.abs(q[:, None] - keys[None]) <= hw).all(-1).sum())


def test_lockstep_fleet_at_bench_ratio_matches_nothing():
    """At the trainer benchmark's ratios (``bench.py:120-160``: store and
    replay 2 B, backfill budget B / 4, default env with reset jitter
    0.1), lockstep envs find no store row near them: the ring holds only
    the last two steps' flush records, states a 10-step window behind
    the fleet.  Both packages, from the JAX state with JAX's draws, over
    20 warm-up and 20 more steps: every rule-column query matches
    nothing and the gate always takes the rule."""
    b, steps = 64, 40
    kw = dict(batch_per_device=b, store_capacity_per_device=2 * b,
              replay_capacity_per_device=2 * b, backfill_budget_per_step=b // 4)
    cfg = jcfg.DCARLConfig(store=jcfg.driving_store_config())
    mesh = make_mesh("env", jax.devices()[:1])
    init_j, step_j, _, _ = j_make_trainer_fast(mesh, "env", cfg,
                                               use_pallas=False, **kw)
    s_j = init_j(seed=0)
    _, step_t, learner, _ = make_trainer_fast(
        tcfg.DCARLConfig(store=tcfg.driving_store_config()), device="cpu",
        use_kernel=True, **kw)
    interop.qnet_from_flax(s_j.params, learner.net)
    interop.qnet_from_flax(s_j.target_params, learner.target_net)
    interop.adam_state_from_optax(s_j.opt_state, learner.optimizer,
                                  learner.net)
    s_t = interop.fast_train_state_from_numpy(s_j, CPU)
    for step in range(steps):
        assert _rule_column_matches(s_j) == 0, f"JAX step {step}"
        assert _rule_column_matches(s_t) == 0, f"port step {step}"
        s_j, m_j = step_j(s_j, _key(step))
        s_t, m_t = step_t.with_draws(s_t, jax_draws(_key(step), cfg, kw),
                                     torch.Generator().manual_seed(step))
        assert float(m_j.rule_fraction) == float(m_t.rule_fraction) == 1.0
        assert int(m_j.store_rows) == int(m_t.store_rows)
    # the ring is full: the matches above were read against 2 B rows
    assert int(m_t.store_rows) == 2 * b


def test_step_fn_draws_its_own_randomness():
    """``step_fn(state, generator)`` runs on the port's own draws: the
    store grows, the loss stays finite and the draws have the documented
    shapes and ranges."""
    cfg = _cfg(tcfg)
    init_t, step_t, _, run_factory = make_trainer_fast(cfg, device="cpu",
                                                       **KW)
    gen = torch.Generator().manual_seed(3)
    d = step_t.draw(gen)
    assert d.gumbel.shape == (8, 128) and d.random_action.max() < 11
    lo, hi = cfg.store.explore_low, cfg.store.explore_high
    assert ((d.gate_uniform >= lo) & (d.gate_uniform < hi)).all()
    state, ms = run_factory(12)(init_t(seed=1), gen)
    assert ms.loss.shape == (12,) and torch.isfinite(ms.loss).all()
    assert int(ms.store_rows[-1]) > 0 and int(state.frame) == 12


def test_episode_window_validation():
    env = tcfg.EnvConfig(max_episode_steps=10)
    bad = tcfg.DCARLConfig(env=env, store=tcfg.driving_store_config(
        value_mode="episode", n_step_window=5))
    with pytest.raises(ValueError, match="episode"):
        make_trainer_fast(bad, device="cpu", **KW)
    with pytest.raises(ValueError, match="dense_store_writes"):
        make_trainer_fast(_cfg(tcfg), device="cpu", dense_store_writes=True,
                          **KW)


def test_trainer_refuses_a_quiet_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        make_trainer_fast(_cfg(tcfg), **KW)
