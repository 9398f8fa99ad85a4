"""PyTorch port: act-hold segments and the trust-set DQN trainer against
the JAX package (``dcarl_tpu/models/segment.py``).

``segment_push`` takes the JAX tests' inputs (``tests/test_segment.py``)
and must give the same hold and records bit for bit in float32: the
suffix values are a prefix sum, which both packages add sequentially.

The trainer runs at ``tests/test_segment.py:117``'s configuration (8
envs, batch 8, replay and trust set 2^10, ``pass_thres`` 3) with reset
jitter 0, so the env's auto-reset draws change nothing.  The port starts
from the JAX ``init_fn`` carry (``interop.trustset_carry_from_numpy``)
and each step takes the draws the JAX step makes from the same key:
``split(key, 3)`` into act / env / train, ``split(k_act)`` into the
epsilon uniform and the random action, ``split(k_train)[0]`` for the
replay's Gumbel noise.  Integer metrics, held actions, the replay's
actions and done flags and the trust set's counts are compared exactly.
The float32 env state is not bit-equal: XLA's CPU ``tan`` / ``arccos`` /
``atan2`` and PyTorch's differ in the last place, so the ego's velocity
and yaw differ by an ulp after the first step (positions near 242 m),
and the controller's feedback carries that on (3e-6 in a velocity of
0.05 m/s after 8 steps); observations, rewards and segment values are
held to rtol 1e-5 / atol 1e-4.  The loss, priorities and weights as in
``tests/test_torch_train_fast.py`` (the attention's
``q_lin`` / ``k_lin`` to ``lr`` per trained step: the world-frame
observations saturate the softmax, see there).  The trust-set keys are
the attention's ``scores @ v``; with one-hot scores they follow
``v_lin``, which is held to rtol 1e-4, so the keys are held to rtol 1e-5
and the counts they give exactly, after checking that no (query, row)
pair lies within 1e-5 of a box edge.  The warm-free steps also run as a
static run of ``run_fn``'s runner (``tests/test_torch_graphs.py``'s
``static_run``: what a replayed CUDA graph computes, each step eager),
bit-equal to the eager loop and held to JAX the same way.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu import config as jcfg
from dcarl_tpu.models import segment as JSEG
from dcarl_tpu.models import trustset as JTS
from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.models import segment as SEG
from dcarl_tpu_torch.models import trustset as TS
from dcarl_tpu_torch.models.networks import AttentionQNet

CPU = torch.device("cpu")
STEPS = 12


def _t(a):
    return torch.as_tensor(np.array(a))


def _assert_hold_equal(got, ref, what):
    for name in SEG.SegmentHold._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      f"{what}: hold.{name}")


def _assert_hold_close(got, ref, what):
    """Integer fields exact; observations and rewards (from the float32
    env, see the module docstring) within rtol 1e-5 / atol 1e-4."""
    for name in SEG.SegmentHold._fields:
        a, b = getattr(got, name).numpy(), np.asarray(getattr(ref, name))
        if a.dtype.kind == "f":
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-4,
                                       err_msg=f"{what}: hold.{name}")
        else:
            np.testing.assert_array_equal(a, b, f"{what}: hold.{name}")


def _assert_records_equal(got, ref, what):
    for name in SEG.SegmentRecords._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)),
                                      f"{what}: records.{name}")


def _push_inputs(seed):
    rng = np.random.default_rng(seed)
    t_steps, b, d = 60, 3, 4
    return (rng.integers(0, 11, (t_steps, b)),
            rng.normal(0.25, 0.5, (t_steps, b)).astype(np.float32),
            rng.random((t_steps, b)) < 0.08,
            rng.normal(0, 1, (t_steps, b, d)).astype(np.float32),
            rng.normal(0, 1, (t_steps, b, d)).astype(np.float32))


@pytest.mark.parametrize("seed", [0, 1])
def test_segment_push_matches_jax(seed):
    rl, rew, done, obs, nobs = _push_inputs(seed)
    jc = JSEG.SegmentConfig(r_thres=1.0, pass_thres=10)
    tc = SEG.SegmentConfig(r_thres=1.0, pass_thres=10)
    jh = JSEG.segment_init(3, 4, jc)
    th = SEG.segment_init(3, 4, tc, device="cpu")
    _assert_hold_equal(th, jh, "init")
    n_records = 0
    for t in range(rew.shape[0]):
        jh, ja = JSEG.segment_select_action(jh, jnp.asarray(rl[t]))
        th, ta = SEG.segment_select_action(th, _t(rl[t]))
        np.testing.assert_array_equal(ta.numpy(), np.asarray(ja))
        jh, jr = JSEG.segment_push(jh, jnp.asarray(obs[t]), jnp.asarray(rew[t]),
                                   jnp.asarray(nobs[t]), jnp.asarray(done[t]),
                                   jc)
        th, tr = SEG.segment_push(th, _t(obs[t]), _t(rew[t]), _t(nobs[t]),
                                  _t(done[t]), tc)
        _assert_hold_equal(th, jh, f"step {t}")
        _assert_records_equal(tr, jr, f"step {t}")
        n_records += int(tr.valid.sum())
    assert n_records > 20


def test_segment_trigger_on_length_matches_jax():
    """A zero-reward stream triggers on ``pass_thres`` alone (at entry
    pass_thres + 1), with all-zero suffix values."""
    jc = JSEG.SegmentConfig(r_thres=1.0, pass_thres=3)
    tc = SEG.SegmentConfig(r_thres=1.0, pass_thres=3)
    b, d = 2, 3
    jh, th = JSEG.segment_init(b, d, jc), SEG.segment_init(b, d, tc, device="cpu")
    zeros, obs = np.zeros(b, np.float32), np.zeros((b, d), np.float32)
    done = np.zeros(b, bool)
    for step in range(tc.pass_thres + 1):
        jh, _ = JSEG.segment_select_action(jh, jnp.full((b,), 5, jnp.int32))
        th, _ = SEG.segment_select_action(th, torch.full((b,), 5))
        jh, jr = JSEG.segment_push(jh, jnp.asarray(obs), jnp.asarray(zeros),
                                   jnp.asarray(obs), jnp.asarray(done), jc)
        th, tr = SEG.segment_push(th, _t(obs), _t(zeros), _t(obs), _t(done),
                                  tc)
        _assert_hold_equal(th, jh, f"step {step}")
        _assert_records_equal(tr, jr, f"step {step}")
        n_valid = int(tr.valid.sum())
        assert n_valid == (0 if step < tc.pass_thres
                           else b * (tc.pass_thres + 1))
    assert bool(th.tail.all()) and (tr.action[tr.valid] == 5).all()


# ---------------------------------------------------------------------------
# The trainer, step for step
# ---------------------------------------------------------------------------


def _kw(mod, seg):
    return dict(env_cfg=mod.EnvConfig(reset_jitter=0.0),
                dqn_cfg=mod.DQNConfig(batch_size=8, replay_capacity=1 << 10),
                seg_cfg=seg.SegmentConfig(r_thres=1.0, pass_thres=3),
                batch=8, replay_capacity=1 << 10, trustset_capacity=1 << 10)


def _key(step):
    return jax.random.PRNGKey(100 + step)


def jax_draws(key, batch=8, batch_size=8, capacity=1 << 10, num_actions=11):
    """The draws of one JAX ``run_fn(carry, key, 1)`` step
    (``segment.py:332, 255, 263, 307``, ``dqn.py:94-99, 192``)."""
    (key,) = jax.random.split(key, 1)
    k_act, _k_env, k_train = jax.random.split(key, 3)
    k_eps, k_a = jax.random.split(k_act)
    k_s, _ = jax.random.split(k_train)
    return SEG.TrustsetDraws(
        eps_uniform=_t(jax.random.uniform(k_eps, (batch,))),
        random_action=_t(jax.random.randint(k_a, (batch,), 0, num_actions)),
        gumbel=_t(jax.random.gumbel(k_s, (batch_size, capacity))))


@pytest.fixture(scope="module")
def jax_run():
    """The JAX trainer from ``init_fn(0)``, one jitted step per key: the
    initial carry and each step's carry and metrics (host copies)."""
    init_j, run_j = JSEG.make_trustset_trainer(**_kw(jcfg, JSEG))
    carry = init_j(seed=0)
    c0 = jax.device_get(carry)
    carries, metrics = [], []
    for step in range(STEPS):
        carry, m = run_j(carry, _key(step), 1)
        carries.append(jax.device_get(carry))
        metrics.append({k: np.asarray(v)[0] for k, v in m.items()})
    return c0, carries, metrics


def _port(c0, use_kernel=None):
    init_t, run_t = SEG.make_trustset_trainer(**_kw(tcfg, SEG), device="cpu",
                                              use_kernel=use_kernel)
    return run_t, interop.trustset_carry_from_numpy(c0, run_t.learner, CPU)


def _run_port(run_t, carry):
    carries, metrics = [], []
    for step in range(STEPS):
        carry, m = run_t.with_draws(carry, jax_draws(_key(step)),
                                    torch.Generator().manual_seed(step))
        carries.append(carry)
        metrics.append(m)
    return carries, metrics


INT_METRICS = ("pushed", "segments_closed", "replay_size", "ts_rows")


def _near_edge_pairs(keys, queries, w, num_actions):
    """(query, row, action) triples whose containment margin
    ``min_d (w_d - |key_d - q_d|)`` over the encoded dims lies within
    1e-5 of 0 for a row of that action: counts there could flip with
    rounding."""
    obs_margin = (w[:-1] - np.abs(keys[None, :, :-1]
                                  - queries[:, None, :])).min(-1)
    near = np.abs(obs_margin) < 1e-5                        # [Q, N]
    return [(int(i), int(j), int(keys[j, -1])) for i, j in zip(*np.nonzero(near))
            if int(keys[j, -1]) < num_actions]


def test_trainer_matches_jax_step_for_step(jax_run):
    c0, carries_j, metrics_j = jax_run
    run_t, carry = _port(c0)
    carries_t, metrics_t = _run_port(run_t, carry)
    trained = 0
    for step, (cj, ct, mj, mt) in enumerate(zip(carries_j, carries_t,
                                                metrics_j, metrics_t)):
        msg = f"step {step}"
        for k in INT_METRICS:
            assert int(mt[k]) == int(mj[k]), f"{msg} {k}"
        assert float(mt["held_fraction"]) == float(mj["held_fraction"]), msg
        np.testing.assert_allclose(float(mt["reward_mean"]),
                                   float(mj["reward_mean"]), rtol=1e-6,
                                   err_msg=msg)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-4, atol=1e-5, err_msg=msg)
        _assert_hold_close(ct.hold, cj.hold, msg)
        assert int(ct.frame) == int(cj.dqn.frame), msg
        trained += int(mj["ts_rows"] > 0)
    assert trained >= 8 and not carries_t[-1].warm
    assert all(c.warm for c in carries_t[:2])

    ct, cj = carries_t[-1], carries_j[-1]
    rj = cj.dqn.replay
    for name in ("action", "done", "size", "head"):
        np.testing.assert_array_equal(getattr(ct.replay, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)
    for name in ("obs", "reward", "next_obs"):
        np.testing.assert_allclose(getattr(ct.replay, name).numpy(),
                                   np.asarray(getattr(rj, name)), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(ct.replay.priority.numpy(),
                               np.asarray(rj.priority), rtol=1e-4, atol=1e-6)

    st, sj = ct.ts.store, cj.ts.store
    for name in ("actions", "size", "head"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)
    np.testing.assert_allclose(st.values.numpy(), np.asarray(sj.values),
                               rtol=1e-5, atol=1e-4)
    np.testing.assert_allclose(st.keys.numpy(), np.asarray(sj.keys),
                               rtol=1e-5, atol=1e-6)
    # counts of the trust set's own encoded states, exact
    n = int(sj.size)
    q_j = np.asarray(sj.keys)[:n, :-1]
    assert _near_edge_pairs(np.asarray(sj.keys)[:n],
                            q_j, np.asarray(cj.ts.half_widths), 11) == []
    counts_j = np.asarray(JTS.state_action_counts(cj.ts, jnp.asarray(q_j), 11,
                                                  use_pallas=False))
    counts_t = TS.state_action_counts(ct.ts, st.keys[:n, :-1], 11).numpy()
    np.testing.assert_array_equal(counts_t, counts_j)
    assert counts_t.sum() > n

    lr = tcfg.DQNConfig().lr
    for tree, net in ((cj.dqn.params, run_t.learner.net),
                      (cj.dqn.target_params, run_t.learner.target_net)):
        ref = interop.qnet_from_flax(tree, AttentionQNet(11))
        for (name, p), r in zip(net.named_parameters(), ref.parameters()):
            tol = (dict(rtol=0, atol=trained * lr)
                   if name[:5] in ("q_lin", "k_lin")
                   else dict(rtol=1e-4, atol=1e-6))
            np.testing.assert_allclose(p.detach().numpy(),
                                       r.detach().numpy(), err_msg=name,
                                       **tol)


def test_warmup_steps_leave_learner_and_trust_set_untouched(jax_run):
    """Until the replay holds a batch, JAX computes the update and
    discards it; the port skips it: weights, Adam, frame and trust set
    stay as they were, in both packages."""
    c0, carries_j, metrics_j = jax_run
    run_t, carry = _port(c0)
    before = {k: v.clone() for k, v in run_t.learner.net.state_dict().items()}
    warm_steps = [s for s, m in enumerate(metrics_j) if int(m["ts_rows"]) == 0]
    assert warm_steps == list(range(len(warm_steps))) and len(warm_steps) >= 2
    for step in warm_steps:
        carry, _ = run_t.with_draws(carry, jax_draws(_key(step)),
                                    torch.Generator().manual_seed(step))
        cj = carries_j[step]
        assert carry.warm and int(carry.frame) == int(cj.dqn.frame) == 0
        assert int(carry.ts.store.size) == int(cj.ts.store.size) == 0
        assert not carry.ts.store.keys.any() and not np.asarray(
            cj.ts.store.keys).any()
        np.testing.assert_array_equal(np.asarray(cj.dqn.opt_state[0].count),
                                      np.asarray(c0.dqn.opt_state[0].count))
    # Adam as carried over from optax (count 0): no step taken
    assert all(float(st["step"]) == 0 and not st["exp_avg"].any()
               for st in run_t.learner.optimizer.state.values())
    for k, v in run_t.learner.net.state_dict().items():
        assert torch.equal(v, before[k]), k
    ref = interop.qnet_from_flax(carries_j[warm_steps[-1]].dqn.params,
                                 AttentionQNet(11))
    for (name, p), r in zip(run_t.learner.net.named_parameters(),
                            ref.parameters()):
        assert torch.equal(p, r), name


def test_kernel_route_equals_brute_route(jax_run):
    """``use_kernel=True`` on the CPU (the sorted kernel's plain version,
    D = 4) against the brute route, from the same carry with the same
    draws: trust set, replay, held actions and every metric equal."""
    c0, _, _ = jax_run
    runs = []
    for use_kernel in (False, True):
        run_t, carry = _port(c0, use_kernel)
        runs.append(_run_port(run_t, carry))
    (ca, ma), (cb, mb) = runs
    for a, b in zip(ma, mb):
        for k in SEG.METRIC_KEYS:
            assert torch.equal(a[k], b[k]), k
    for a, b in zip(ca, cb):
        assert torch.equal(a.hold.action, b.hold.action)
    for name in ("keys", "actions", "values", "size", "head"):
        assert torch.equal(getattr(ca[-1].ts.store, name),
                           getattr(cb[-1].ts.store, name)), name
    for name in ca[-1].replay._fields:
        assert torch.equal(getattr(ca[-1].replay, name),
                           getattr(cb[-1].replay, name)), name


def _stacked_draws_tick(run_t):
    """A trainer tick that takes the draws of its step from the stacked
    ``draws`` it reads, at the trained-step count (the frame) on the
    device, as JAX's scan takes its step keys."""
    def tick(carry, draws, generator):
        i = carry.frame.reshape(1).to(torch.int64)
        return run_t.with_draws(carry, SEG.TrustsetDraws(
            *(d.index_select(0, i)[0] for d in draws)), generator)
    return tick


def test_trustset_static_run_matches_loop_and_jax(jax_run):
    """JAX's 12 steps on JAX's draws: the warm steps eagerly, then the
    warm-free rest as a static run and as the eager loop of the same
    tick.  The two equal bit for bit (metrics, carry, learner, generator)
    and agree with JAX at ``test_trainer_matches_jax_step_for_step``'s
    tolerances, across the warm boundary."""
    from test_torch_graphs import assert_bit_equal, static_run

    from dcarl_tpu_torch.utils import graphs

    c0, carries_j, metrics_j = jax_run
    run_t, carry = _port(c0)
    warm = sum(int(m["ts_rows"]) == 0 for m in metrics_j)
    assert 2 <= warm < STEPS - 4
    gen = torch.Generator().manual_seed(0)
    metrics = []
    for step in range(warm):
        carry, m = run_t.with_draws(carry, jax_draws(_key(step)), gen)
        metrics.append(m)
    # the step that fills a batch trains: the rest starts warm-free
    assert carry.warm
    carry, m = run_t.with_draws(carry, jax_draws(_key(warm)), gen)
    metrics.append(m)
    assert not carry.warm and int(carry.frame) == 1
    n = STEPS - warm - 1
    draws = [jax_draws(_key(s)) for s in range(warm, STEPS)]
    stacked = SEG.TrustsetDraws(*(torch.stack(f) for f in zip(*draws)))
    tick = _stacked_draws_tick(run_t)
    start = run_t.learner.state_dict()
    routes = []
    for static in (True, False):
        run_t.learner.load_state_dict(start)
        g = torch.Generator().manual_seed(1)
        if static:
            out = static_run(graphs.TickRunner(tick, compiled=False), carry,
                             stacked, n, g)
        else:
            out = graphs.run_loop(tick, carry, stacked, n, g)
        routes.append((out, run_t.learner.state_dict(), g.get_state()))
    assert_bit_equal(routes[0], routes[1], "trust-set static run")
    (end, rest), _, _ = routes[0]
    metrics += [{k: v[i] for k, v in rest.items()} for i in range(n)]

    for step, (mt, mj) in enumerate(zip(metrics, metrics_j)):
        for k in INT_METRICS:
            assert int(mt[k]) == int(mj[k]), f"step {step} {k}"
        assert float(mt["held_fraction"]) == float(mj["held_fraction"])
        np.testing.assert_allclose(float(mt["reward_mean"]),
                                   float(mj["reward_mean"]), rtol=1e-6)
        np.testing.assert_allclose(float(mt["loss"]), float(mj["loss"]),
                                   rtol=1e-4, atol=1e-5)
    cj = carries_j[-1]
    _assert_hold_close(end.hold, cj.hold, "end")
    assert int(end.frame) == int(cj.dqn.frame) == STEPS - warm
    rj = cj.dqn.replay
    for name in ("action", "done", "size", "head"):
        np.testing.assert_array_equal(getattr(end.replay, name).numpy(),
                                      np.asarray(getattr(rj, name)), name)
    for name in ("obs", "reward", "next_obs"):
        np.testing.assert_allclose(getattr(end.replay, name).numpy(),
                                   np.asarray(getattr(rj, name)), rtol=1e-5,
                                   atol=1e-4, err_msg=name)
    np.testing.assert_allclose(end.replay.priority.numpy(),
                               np.asarray(rj.priority), rtol=1e-4, atol=1e-6)
    st, sj = end.ts.store, cj.ts.store
    for name in ("actions", "size", "head"):
        np.testing.assert_array_equal(getattr(st, name).numpy(),
                                      np.asarray(getattr(sj, name)), name)
    np.testing.assert_allclose(st.keys.numpy(), np.asarray(sj.keys),
                               rtol=1e-5, atol=1e-6)
    lr, trained = tcfg.DQNConfig().lr, STEPS - warm
    ref = interop.qnet_from_flax(cj.dqn.params, AttentionQNet(11))
    for (name, p), r in zip(run_t.learner.net.named_parameters(),
                            ref.parameters()):
        tol = (dict(rtol=0, atol=trained * lr) if name[:5] in ("q_lin",
                                                               "k_lin")
               else dict(rtol=1e-4, atol=1e-6))
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(),
                                   err_msg=name, **tol)


def test_run_fn_draws_its_own_randomness():
    """``run_fn(carry, generator, n)`` on the port's own draws: records
    pushed, segments closed, the trust set grows, finite losses, the
    JAX metric keys."""
    init_t, run_t = SEG.make_trustset_trainer(
        **dict(_kw(tcfg, SEG), env_cfg=tcfg.EnvConfig(reset_jitter=0.05)),
        device="cpu")
    carry, m = run_t(init_t(seed=0), torch.Generator().manual_seed(1), STEPS)
    assert tuple(m) == SEG.METRIC_KEYS
    assert all(v.shape == (STEPS,) for v in m.values())
    assert int(m["pushed"].sum()) > 0 and int(m["segments_closed"].sum()) > 0
    assert int(m["ts_rows"][-1]) > 0 and torch.isfinite(m["loss"]).all()
    assert float(m["held_fraction"][-1]) > 0.5


def test_trainer_refuses_a_quiet_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        SEG.make_trustset_trainer(**_kw(tcfg, SEG))
