"""PyTorch port: the Q-networks, the trust set and the trust-set learner
against the JAX package on the same inputs.

Weights and Adam state go across with ``dcarl_tpu_torch.interop``;
random draws (the replay's Gumbel noise, the parameter noise) are JAX's
own, fed in.  Network inputs are unit-scale, so the attention softmax is
not saturated.  Tolerances: network outputs rtol 1e-5 / atol 1e-6;
losses rtol 1e-4; weights after an Adam step rtol 1e-4 / atol 1e-6, and
``k_lin.bias`` (whose true gradient is 0, see
``tests/test_torch_models.py``) to ``lr``; trust-set counts and actions
exact.

The trust set's store queries take both routes on the CPU: the brute
``_raw_moments`` and ``use_kernel=True``, which is the sorted-band
kernel's plain version (the card runs ``csrc/sorted_moments.cu``).  The
D = 4 keys (a 3-wide encoding and the action) are held against the JAX
package's Pallas kernel in interpret mode.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import DQNConfig as JDQNConfig
from dcarl_tpu.models import dqn as JDQ
from dcarl_tpu.models import networks as JNET
from dcarl_tpu.models import replay as JRB
from dcarl_tpu.models import trustset as JTS
from dcarl_tpu.ops.pallas_store import box_query_moments_sorted as j_sorted
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.config import DQNConfig
from dcarl_tpu_torch.core.rls import candidate_keys
from dcarl_tpu_torch.models import dqn as DQ
from dcarl_tpu_torch.models import networks as NET
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models import trustset as TS
from dcarl_tpu_torch.ops import store_kernels

A, D = 11, 20
NET_TOL = dict(rtol=1e-5, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.array(a))


def _obs(seed, n=64):
    return np.random.default_rng(seed).normal(0, 1.5, (n, D)).astype(np.float32)


NETS = {
    "mlp": (lambda: JNET.MLPQNet(num_actions=A),
            lambda: NET.MLPQNet(A, D)),
    "attention": (lambda: JNET.AttentionQNet(num_actions=A),
                  lambda: NET.AttentionQNet(A)),
    "dueling": (lambda: JNET.DuelingQNet(num_actions=5),
                lambda: NET.DuelingQNet(5, D)),
    "bootstrap": (lambda: JNET.BootstrapQNet(num_actions=5, num_heads=10),
                  lambda: NET.BootstrapQNet(5, D, num_heads=10)),
}


@pytest.mark.parametrize("kind", sorted(NETS))
def test_network_matches_flax(kind):
    jmake, tmake = NETS[kind]
    net = jmake()
    params = net.init(jax.random.PRNGKey(3), jnp.zeros((1, D)))
    obs = _obs(1)
    ref = np.asarray(net.apply(params, jnp.asarray(obs)))
    got = interop.qnet_from_flax(params, tmake())(_t(obs)).detach().numpy()
    assert got.shape == ref.shape
    np.testing.assert_allclose(got, ref, **NET_TOL)


def test_encoded_state_and_ego_attention_match_flax():
    net = JNET.AttentionQNet(num_actions=A)
    params = net.init(jax.random.PRNGKey(4), jnp.zeros((1, D)))
    obs = _obs(2)
    tnet = interop.qnet_from_flax(params, NET.AttentionQNet(A))
    for method, shape in (("encoded_state", (64, 3)),
                          ("ego_attention", (64, 4, 3))):
        ref = np.asarray(net.apply(params, jnp.asarray(obs), method=method))
        got = getattr(tnet, method)(_t(obs)).detach().numpy()
        assert got.shape == ref.shape == shape
        np.testing.assert_allclose(got, ref, **NET_TOL, err_msg=method)


def test_network_init_is_flax_dense_default():
    """LeCun-normal truncated kernels and zero biases in every net."""
    g = torch.Generator().manual_seed(1)
    for net in (NET.MLPQNet(A, 256, generator=g),
                NET.DuelingQNet(A, 256, generator=g),
                NET.BootstrapQNet(A, 256, generator=g)):
        w = net.dense[0].weight.detach()                     # [128, 256]
        assert all((lin.bias == 0).all() for lin in net.dense)
        np.testing.assert_allclose(float(w.var()), 1.0 / 256, rtol=0.05)


# ---------------------------------------------------------------------------
# The trust set
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("use_kernel", [False, True])
def test_trustset_gating_and_ucb_match_jax(use_kernel):
    """``tests/test_models.py:142``'s cases, counts exact."""
    enc = np.zeros((5, 3), np.float32)
    acts = np.asarray([0.0, 1.0, 1.0, 2.0, 1.0], np.float32)
    rews = np.asarray([1.0, -1.0, -0.5, 0.3, -0.2], np.float32)
    jts = JTS.add_data(JTS.trustset_init(256, enc_dim=3), jnp.asarray(enc),
                       jnp.asarray(acts), jnp.asarray(rews))
    ts = TS.add_data(TS.trustset_init(256, enc_dim=3, device="cpu"), _t(enc), _t(acts),
                     _t(rews))
    for name in ts.store._fields:
        np.testing.assert_array_equal(getattr(ts.store, name).numpy(),
                                      np.asarray(getattr(jts.store, name)))
    np.testing.assert_array_equal(ts.half_widths.numpy(),
                                  np.asarray(jts.half_widths))
    far = np.full((1, 3), 10.0, np.float32)
    for q in (enc[:1], far):
        jq, tq = jnp.asarray(q), _t(q)
        kw = dict(use_kernel=use_kernel)
        np.testing.assert_array_equal(
            TS.state_action_counts(ts, tq, 4, **kw).numpy(),
            np.asarray(JTS.state_action_counts(jts, jq, 4, use_pallas=False)))
        np.testing.assert_array_equal(
            TS.in_trust_set(ts, tq, 4, **kw).numpy(),
            np.asarray(JTS.in_trust_set(jts, jq, 4, use_pallas=False)))
        np.testing.assert_array_equal(
            TS.in_trust_set_action(ts, tq, 4, **kw).numpy(),
            np.asarray(JTS.in_trust_set_action(jts, jq, 4, use_pallas=False)))
        np.testing.assert_array_equal(
            TS.confidence_values(ts, tq, 4, **kw).numpy(),
            np.asarray(JTS.confidence_values(jts, jq, 4, use_pallas=False)))
        np.testing.assert_array_equal(
            TS.hybrid_act(ts, tq, 4, **kw).numpy(),
            np.asarray(JTS.hybrid_act(jts, jq, 4, use_pallas=False)))
    np.testing.assert_array_equal(TS.state_action_counts(ts, _t(enc[:1]), 4)
                                  .numpy()[0], [1, 3, 1, 0])
    np.testing.assert_array_equal(TS.confidence_values(ts, _t(enc[:1]), 4)
                                  .numpy()[0], [100.0, -50.0, -50.0, -50.0])


def _duplicated_set(seed, n_distinct=64, dup=16):
    """A D = 4 trust set as the trainer fills it: replay samples drawn
    with replacement, so each encoded (state, action) repeats; queries
    are encodings next to stored ones (and a few far away)."""
    rng = np.random.default_rng(seed)
    enc = rng.normal(0, 1.0, (n_distinct, 3)).astype(np.float32)
    act = rng.integers(0, A, n_distinct).astype(np.float32)
    pick = rng.integers(0, n_distinct, n_distinct * dup)
    rows = np.concatenate([enc[pick], act[pick, None]], 1)
    values = rng.normal(0, 3, len(pick)).astype(np.float32)
    q = np.concatenate([enc[rng.integers(0, n_distinct, 48)]
                        + rng.normal(0, 0.15, (48, 3)),
                        rng.normal(0, 4, (16, 3))]).astype(np.float32)
    return rows, act[pick], values, q


def test_d4_kernel_route_matches_pallas_interpret():
    """The trust set's query through ``use_kernel=True`` (on the CPU the
    sorted kernel's plain version) against JAX's
    ``box_query_moments_sorted(..., interpret=True)`` on a set of
    duplicated D = 4 rows: counts exact, sums rtol 1e-4 / atol 1e-3."""
    rows, acts, values, q = _duplicated_set(5)
    ts = TS.trustset_init(2048, 3, device="cpu")
    ts = TS.add_data(ts, _t(rows[:, :3]), _t(acts), _t(values))
    jts = JTS.add_data(JTS.trustset_init(2048, 3), jnp.asarray(rows[:, :3]),
                       jnp.asarray(acts), jnp.asarray(values))
    keys = candidate_keys(_t(q), A).reshape(-1, 4)          # [64 * 11, 4]
    n = ts.store.keys.shape[0]
    valid = torch.arange(n) < ts.store.size
    got = store_kernels.box_query_moments_sorted(
        ts.store.keys, ts.store.values, valid, keys, ts.half_widths)
    ref = np.asarray(j_sorted(jts.store.keys, jts.store.values,
                              jnp.asarray(valid.numpy()), jnp.asarray(keys),
                              jts.half_widths, interpret=True))
    np.testing.assert_array_equal(got[:, 0].numpy(), ref[:, 0])
    np.testing.assert_allclose(got[:, 1:].numpy(), ref[:, 1:], rtol=1e-4,
                               atol=1e-3)
    assert ref[:, 0].max() > 10        # cells past n_thres: real bounds
    # the trust-set functions on the kernel route, against JAX's brute
    jq = jnp.asarray(q)
    np.testing.assert_array_equal(
        TS.state_action_counts(ts, _t(q), A, use_kernel=True).numpy(),
        np.asarray(JTS.state_action_counts(jts, jq, A, use_pallas=False)))
    cv = TS.confidence_values(ts, _t(q), A, use_kernel=True).numpy()
    cv_j = np.asarray(JTS.confidence_values(jts, jq, A, use_pallas=False))
    np.testing.assert_allclose(cv, cv_j, rtol=1e-5, atol=1e-4)
    np.testing.assert_array_equal(
        TS.hybrid_act(ts, _t(q), A, use_kernel=True).numpy(),
        np.asarray(JTS.hybrid_act(jts, jq, A, use_pallas=False)))


# ---------------------------------------------------------------------------
# The learner's trust-set methods
# ---------------------------------------------------------------------------


def _learners(seed, cfg=JDQNConfig(), tcfg=DQNConfig()):
    net = JNET.AttentionQNet(num_actions=A)
    params = net.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)))
    target = net.init(jax.random.PRNGKey(seed + 1), jnp.zeros((1, D)))
    jl = JDQ.DQN(net, obs_dim=D, cfg=cfg)
    tl = DQ.DQN(interop.qnet_from_flax(params, NET.AttentionQNet(A)), cfg=tcfg)
    interop.qnet_from_flax(target, tl.target_net)
    return jl, tl, params, target


def _set_from_obs(net_params, seed):
    """A trust set of the encodings of 32 observations (16 distinct,
    duplicated), with random actions, in both packages."""
    rng = np.random.default_rng(seed)
    obs = _obs(seed, 16)[rng.integers(0, 16, 32)]
    enc = np.asarray(JNET.AttentionQNet(num_actions=A).apply(
        net_params, jnp.asarray(obs), method="encoded_state"))
    act = rng.integers(0, A, 32).astype(np.float32)
    rew = rng.normal(0, 1, 32).astype(np.float32)
    jts = JTS.add_data(JTS.trustset_init(512, 3), jnp.asarray(enc),
                       jnp.asarray(act), jnp.asarray(rew))
    ts = TS.add_data(TS.trustset_init(512, 3, device="cpu"), _t(enc), _t(act), _t(rew))
    return jts, ts, obs


@pytest.mark.parametrize("use_kernel", [False, True])
def test_act_ts_explore_and_hybrid_match_jax(use_kernel):
    jl, tl, params, _ = _learners(11)
    jts, ts, obs_set = _set_from_obs(params, 12)
    obs = np.concatenate([obs_set, _obs(13, 32)])
    enc = np.asarray(jl.net.apply(params, jnp.asarray(obs),
                                  method="encoded_state"))
    state = JDQ.DQNState(params, params, None, None, jnp.asarray(0, jnp.int32))
    jo, je = jnp.asarray(obs), jnp.asarray(enc)
    kw = dict(use_kernel=use_kernel)
    for name, ref in (("act_ts", jl.act_ts(state, jts, jo, je)),
                      ("act_ts_explore", jl.act_ts_explore(state, jts, jo, je))):
        got = getattr(tl, name)(ts, _t(obs), _t(enc), **kw)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref), name)
    got = TS.hybrid_act(ts, _t(enc), A, **kw)
    np.testing.assert_array_equal(got.numpy(),
                                  np.asarray(JTS.hybrid_act(jts, je, A)))
    # the gate matters: some actions are out of the set, some in
    in_ts = TS.in_trust_set_action(ts, _t(enc), A).numpy()
    assert 0 < in_ts.sum() < in_ts.size


def _replay(seed, cap=64, n=40):
    rng = np.random.default_rng(seed)
    obs = rng.normal(0, 1, (n, D)).astype(np.float32)
    nobs = rng.normal(0, 1, (n, D)).astype(np.float32)
    jr = JRB.replay_push(JRB.replay_init(cap, D), jnp.asarray(obs),
                         jnp.asarray(rng.integers(0, A, n).astype(np.int32)),
                         jnp.asarray(rng.normal(0, 1, n).astype(np.float32)),
                         jnp.asarray(nobs),
                         jnp.asarray((rng.random(n) < 0.2).astype(np.float32)))
    prio = np.zeros(cap, np.float32)
    prio[:n] = rng.uniform(0.1, 5.0, n)
    jr = jr._replace(priority=jnp.asarray(prio))
    return jr, RB.Replay(*(_t(x) for x in jr))


def _check_params(tl, jparams, steps, lr=1e-3):
    ref = interop.qnet_from_flax(jparams, NET.AttentionQNet(A))
    for (name, p), r in zip(tl.net.named_parameters(), ref.parameters()):
        tol = (dict(rtol=0, atol=steps * lr) if name == "k_lin.bias"
               else dict(rtol=1e-4, atol=1e-6))
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(),
                                   err_msg=name, **tol)


@pytest.mark.parametrize("punish", [False, True])
def test_train_step_matches_jax(punish):
    """The standalone step with JAX's Gumbel noise (the key goes straight
    to ``replay_sample``), from optax's Adam state after one step."""
    jl, tl, params, target = _learners(21)
    jr, tr = _replay(22)
    opt = jl.tx.init(params)
    mask = np.random.default_rng(23).random(jl.cfg.batch_size) < 0.5
    jmask = jnp.asarray(mask) if punish else None
    s0 = JDQ.DQNState(params, target, opt, jr, jnp.asarray(3, jnp.int32))
    s1, _ = jl.train_step(s0, jax.random.PRNGKey(24), jmask)
    s2, loss_j = jl.train_step(s1, jax.random.PRNGKey(25), jmask)
    interop.qnet_from_flax(s1.params, tl.net)
    interop.adam_state_from_optax(s1.opt_state, tl.optimizer, tl.net)
    tr1 = RB.Replay(*(_t(x) for x in s1.replay))
    gumbel = _t(jax.random.gumbel(jax.random.PRNGKey(25),
                                  (jl.cfg.batch_size, 64)))
    replay, frame, loss = tl.train_step(tr1, torch.tensor(4, dtype=torch.int32),
                                        gumbel, _t(mask) if punish else None)
    assert int(frame) == int(s2.frame) == 5
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    np.testing.assert_allclose(replay.priority.numpy(),
                               np.asarray(s2.replay.priority), rtol=1e-4,
                               atol=1e-6)
    _check_params(tl, s2.params, 2)


def test_train_step_with_trustset_matches_jax():
    """Sample with JAX's Gumbel noise (``split(key)[0]``), encode the
    batch with the pre-step weights, add it to the trust set, punish the
    next states outside it, one Adam step: loss rtol 1e-4, the trust set
    after the step exact but for its keys (encodings, rtol 1e-5), the
    punished share the same."""
    jl, tl, params, target = _learners(31)
    jr, tr = _replay(32)
    jts, ts, _ = _set_from_obs(params, 33)
    s0 = JDQ.DQNState(params, target, jl.tx.init(params), jr,
                      jnp.asarray(0, jnp.int32))
    key = jax.random.PRNGKey(34)
    s1, jts1, loss_j = jl.train_step_with_trustset(s0, jts, key, s0.params)
    k_s, _ = jax.random.split(key)
    gumbel = _t(jax.random.gumbel(k_s, (jl.cfg.batch_size, 64)))
    replay, frame, ts1, loss = tl.train_step_with_trustset(
        tr, torch.zeros((), dtype=torch.int32), ts, gumbel)
    assert int(frame) == int(s1.frame) == 1
    np.testing.assert_allclose(float(loss), float(loss_j), rtol=1e-4)
    for name in ("actions", "values", "size", "head"):
        np.testing.assert_array_equal(getattr(ts1.store, name).numpy(),
                                      np.asarray(getattr(jts1.store, name)))
    np.testing.assert_allclose(ts1.store.keys.numpy(),
                               np.asarray(jts1.store.keys), rtol=1e-5,
                               atol=1e-6)
    np.testing.assert_allclose(replay.priority.numpy(),
                               np.asarray(s1.replay.priority), rtol=1e-4,
                               atol=1e-6)
    _check_params(tl, s1.params, 1)
    # the set grew by the batch, and in the JAX tests' configuration the
    # encoder may be another net (the target's weights)
    assert int(ts1.store.size) == 32 + jl.cfg.batch_size
    jl8 = JDQ.DQN(jl.net, obs_dim=D, cfg=JDQNConfig(batch_size=8,
                                                    replay_capacity=64))
    s8 = JDQ.DQNState(params, target, jl8.tx.init(params), jr,
                      jnp.asarray(0, jnp.int32))
    _, jts8, _ = jl8.train_step_with_trustset(
        s8, JTS.trustset_init(256, 3), key, s8.target_params)
    tl8 = DQ.DQN(interop.qnet_from_flax(params, NET.AttentionQNet(A)),
                 cfg=DQNConfig(batch_size=8, replay_capacity=64))
    _, _, ts8, _ = tl8.train_step_with_trustset(
        tr, torch.zeros((), dtype=torch.int32), TS.trustset_init(256, 3, device="cpu"),
        gumbel[:8], encoder=interop.qnet_from_flax(target,
                                                   NET.AttentionQNet(A)))
    assert int(ts8.store.size) == int(jts8.store.size) == 8
    np.testing.assert_allclose(ts8.store.keys.numpy(),
                               np.asarray(jts8.store.keys), rtol=1e-5,
                               atol=1e-6)


# ---------------------------------------------------------------------------
# Parameter noise
# ---------------------------------------------------------------------------


def _jax_noise(params, key):
    """JAX's unit normals of ``perturb_params`` (one draw per leaf, in
    tree order), as a tree shaped like ``params``."""
    leaves, treedef = jax.tree.flatten(params)
    keys = jax.random.split(key, len(leaves))
    return jax.tree.unflatten(treedef, [jax.random.normal(k, l.shape, l.dtype)
                                        for l, k in zip(leaves, keys)])


@pytest.mark.parametrize("frame", [0, 400_000])
def test_param_noise_matches_jax(frame):
    """Perturbed actions equal, KL rtol 1e-5, the adapted scale exact."""
    net = JNET.MLPQNet(num_actions=A)
    params = net.init(jax.random.PRNGKey(41), jnp.zeros((1, D)))
    cfg = JDQNConfig(epsilon_decay=1e5)
    jl = JDQ.DQN(net, obs_dim=D, cfg=cfg)
    tl = DQ.DQN(interop.qnet_from_flax(params, NET.MLPQNet(A, D)),
                cfg=DQNConfig(epsilon_decay=1e5))
    state = JDQ.DQNState(params, params, None, None,
                         jnp.asarray(frame, jnp.int32))
    obs = _obs(42, 256)
    jpn, tpn = JDQ.DQNParamNoise(jl), DQ.DQNParamNoise(tl)
    noise = dict(interop.qnet_from_flax(
        _jax_noise(params, jax.random.PRNGKey(43)),
        NET.MLPQNet(A, D)).named_parameters())
    noise = {k: v.detach() for k, v in noise.items()}
    for scale in (0.01, 0.3):
        pn_j = JDQ.ParamNoiseState(jnp.asarray(scale, jnp.float32),
                                   jnp.asarray(0.0, jnp.float32))
        pn_t = DQ.param_noise_init(scale, device="cpu")
        act_j = jpn.act(state, pn_j, jnp.asarray(obs), jax.random.PRNGKey(43))
        act_t = tpn.act(pn_t, _t(obs), noise=noise)
        np.testing.assert_array_equal(act_t.numpy(), np.asarray(act_j))
        (new_j, kl_j) = jpn.adapt(state, pn_j, jnp.asarray(obs),
                                  jax.random.PRNGKey(43))
        new_t, kl_t = tpn.adapt(pn_t, _t(obs), torch.tensor(frame), noise=noise)
        np.testing.assert_allclose(float(kl_t), float(kl_j), rtol=1e-5)
        assert float(new_t.scale) == float(new_j.scale)
        np.testing.assert_allclose(float(new_t.threshold),
                                   float(new_j.threshold), rtol=1e-6)
    # the larger scale changes some greedy actions; the scale moved both ways
    clean = torch.argmax(tl.net(_t(obs)), dim=-1)
    assert (act_t != clean).any()
    # with a generator the noise is the port's own
    a1 = tpn.act(pn_t, _t(obs), generator=torch.Generator().manual_seed(0))
    a2 = tpn.act(pn_t, _t(obs), generator=torch.Generator().manual_seed(0))
    assert torch.equal(a1, a2)


def test_perturb_params_adds_scaled_noise():
    net = NET.MLPQNet(A, D)
    noise = {k: torch.ones_like(p) for k, p in net.named_parameters()}
    out = DQ.perturb_params(net, torch.tensor(0.5), noise)
    for k, p in net.named_parameters():
        assert torch.equal(out[k], p.detach() + 0.5)
    np.testing.assert_allclose(
        float(DQ.param_noise_threshold_from_eps(torch.tensor(0.1), A)),
        float(JDQ.param_noise_threshold_from_eps(jnp.asarray(0.1), A)),
        rtol=1e-6)
