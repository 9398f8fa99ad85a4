"""PyTorch port: the learner (Q-network, replay, DQN) against the JAX
package on the same inputs.

Weights and optimizer state go across with ``dcarl_tpu_torch.interop``;
random draws (the replay's Gumbel noise) are JAX's own, fed in.  The
network inputs are unit-scale here, so the attention softmax is not
saturated and every parameter but one gets a real gradient
(``tests/test_torch_train_fast.py`` says what happens when it is).

The one: ``k_lin.bias`` adds the same ``q . b_k`` to every score of a
query's row, and the softmax is invariant to that shift, so its true
gradient is exactly 0.  Both packages return rounding noise there, and
Adam scales any nonzero gradient to a step of about ``lr``; that
parameter is held to ``lr`` per step.
"""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import DQNConfig as JDQNConfig
from dcarl_tpu.models import dqn as JDQ
from dcarl_tpu.models import networks as JNET
from dcarl_tpu.models import replay as JRB
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.config import DQNConfig
from dcarl_tpu_torch.models import dqn as DQ
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models.networks import AttentionQNet

A, D = 11, 20


def _param_tol(name, steps, lr):
    """Tolerance of one parameter after ``steps`` Adam steps (see the
    module docstring for ``k_lin.bias``)."""
    if name == "k_lin.bias":
        return dict(rtol=0, atol=steps * lr)
    return dict(rtol=1e-4, atol=1e-6)


def _t(a):
    return torch.as_tensor(np.array(a))


def _flax_params(seed):
    net = JNET.AttentionQNet(num_actions=A)
    return net, net.init(jax.random.PRNGKey(seed), jnp.zeros((1, D)))


def test_attention_qnet_matches_flax():
    net, params = _flax_params(0)
    obs = np.random.default_rng(0).normal(0, 1.5, (64, D)).astype(np.float32)
    ref = np.asarray(net.apply(params, jnp.asarray(obs)))
    tnet = interop.qnet_from_flax(params, AttentionQNet(A))
    got = tnet(_t(obs)).detach().numpy()
    np.testing.assert_allclose(got, ref, rtol=1e-5, atol=1e-6)


def test_attention_qnet_init_is_flax_dense_default():
    """LeCun-normal truncated kernels (variance 1 / fan_in) and zero
    biases, as flax ``Dense`` initializes them."""
    net = AttentionQNet(A, hidden=256, generator=torch.Generator().manual_seed(1))
    w = net.head[2].weight.detach()                         # [256, 256]
    assert (net.head[2].bias == 0).all() and (net.q_lin.bias == 0).all()
    np.testing.assert_allclose(float(w.var()), 1.0 / 256, rtol=0.05)
    assert float(w.abs().max()) <= 2.0 * np.sqrt(1.0 / 256) / 0.8796 + 1e-6


def _replay_rows(rng, m):
    return (rng.normal(0, 1, (m, D)).astype(np.float32),
            rng.integers(0, A, m).astype(np.int32),
            rng.normal(0, 1, m).astype(np.float32),
            rng.normal(0, 1, (m, D)).astype(np.float32),
            (rng.random(m) < 0.2).astype(np.float32))


def _assert_replay_equal(got: RB.Replay, ref):
    for name in RB.Replay._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


@pytest.mark.parametrize("cap,pushes", [(32, (8, 8, 8, 8, 8)),   # aligned
                                        (30, (8, 8, 8, 8)),      # wraps
                                        (32, (5, 8, 8))])        # unaligned
def test_replay_push_matches_jax(cap, pushes):
    rng = np.random.default_rng(cap + len(pushes))
    jr = JRB.replay_init(cap, D)
    tr = RB.replay_init(cap, D, device="cpu")
    for i, m in enumerate(pushes):
        rows = _replay_rows(rng, m)
        mask = None if i != 1 else rng.random(m) < 0.6
        jr = JRB.replay_push(jr, *(jnp.asarray(a) for a in rows),
                             mask=None if mask is None else jnp.asarray(mask))
        tr = RB.replay_push(tr, *(_t(a) for a in rows),
                            mask=None if mask is None else _t(mask))
        # priorities differ per row from the next push on
        jr = jr._replace(priority=jr.priority * (1.0 + i))
        tr = tr._replace(priority=tr.priority * (1.0 + i))
        _assert_replay_equal(tr, jr)


def test_replay_sample_and_priorities_match_jax():
    rng = np.random.default_rng(4)
    cap, batch = 64, 16
    jr = JRB.replay_init(cap, D)
    jr = JRB.replay_push(jr, *(jnp.asarray(a) for a in _replay_rows(rng, 40)))
    prio = np.zeros(cap, np.float32)
    prio[:40] = rng.uniform(0.1, 5.0, 40)
    jr = jr._replace(priority=jnp.asarray(prio))
    tr = RB.Replay(*(_t(x) for x in jr))
    key = jax.random.PRNGKey(9)
    ref = JRB.replay_sample(jr, key, batch, alpha=0.6, beta=0.55)
    gumbel = _t(jax.random.gumbel(key, (batch, cap)))
    got = RB.replay_sample(tr, gumbel, alpha=0.6, beta=0.55)
    np.testing.assert_array_equal(got.indices.numpy(), np.asarray(ref.indices))
    assert (got.indices.numpy() < 40).all()
    np.testing.assert_allclose(got.weights.numpy(), np.asarray(ref.weights),
                               rtol=1e-6)
    for name in ("obs", "action", "reward", "next_obs", "done"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)

    new_p = rng.uniform(0.0, 3.0, batch).astype(np.float32)
    # a duplicated index gets the same priority from both draws, as the
    # TD loss gives it (same transition)
    idx = np.asarray(ref.indices)
    first = {}
    for i, k in enumerate(idx):
        new_p[i] = first.setdefault(int(k), new_p[i])
    ju = JRB.replay_update_priorities(jr, ref.indices, jnp.asarray(new_p))
    tu = RB.replay_update_priorities(tr, got.indices, _t(new_p))
    _assert_replay_equal(tu, ju)


@pytest.mark.parametrize("frame", [0, 500, 2000, 10 ** 6])
def test_schedules_match_jax(frame):
    jc, tc = JDQNConfig(), DQNConfig()
    f = np.int32(frame)
    np.testing.assert_allclose(
        float(DQ.epsilon_by_frame(torch.tensor(f), tc)),
        float(JDQ.epsilon_by_frame(jnp.asarray(f), jc)), rtol=1e-6)
    np.testing.assert_allclose(
        float(DQ.beta_by_frame(torch.tensor(f), tc)),
        float(JDQ.beta_by_frame(jnp.asarray(f), jc)), rtol=1e-6)


def test_act_epsilon_greedy_matches_jax():
    net, params = _flax_params(3)
    cfg = JDQNConfig(epsilon_decay=50.0)
    jl = JDQ.DQN(net, obs_dim=D, cfg=cfg)
    obs = np.random.default_rng(3).normal(0, 1, (256, D)).astype(np.float32)
    key, frame = jax.random.PRNGKey(5), jnp.asarray(20, jnp.int32)
    state = JDQ.DQNState(params, params, None, None, frame)
    ref = np.asarray(jl.act_epsilon_greedy(state, jnp.asarray(obs), key))
    k_eps, k_act = jax.random.split(key)
    eps_u = _t(jax.random.uniform(k_eps, (256,)))
    rand = _t(jax.random.randint(k_act, (256,), 0, A))
    tl = DQ.DQN(interop.qnet_from_flax(params, AttentionQNet(A)),
                cfg=DQNConfig(epsilon_decay=50.0))
    got = tl.act_epsilon_greedy(_t(obs), torch.tensor(20), eps_u, rand)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert 0.2 < float((eps_u < DQ.epsilon_by_frame(torch.tensor(20),
                                                   tl.cfg)).float().mean()) < 0.9


@pytest.mark.parametrize("double_q", [False, True])
def test_td_loss_and_adam_steps_match_jax(double_q):
    """Two TD + Adam steps: the first from fresh Adam state, the second
    from the optax state carried across with ``adam_state_from_optax``.
    Loss, priorities and params within rtol 1e-4 / atol 1e-6."""
    net, params = _flax_params(7)
    _, target = _flax_params(8)
    cfg = JDQNConfig()  # lr 1e-3
    jl = JDQ.DQN(net, obs_dim=D, cfg=cfg, double_q=double_q)
    rng = np.random.default_rng(7)
    batches = []
    for _ in range(2):
        o, a, r, o2, d = _replay_rows(rng, 32)
        wts = rng.uniform(0.3, 1.0, 32).astype(np.float32)
        batches.append((o, a, r, o2, d, np.arange(32), wts))

    def jax_step(p, opt, b):
        jb = JRB.Batch(*(jnp.asarray(x) for x in b))
        (loss, prios), g = jax.value_and_grad(
            lambda q: jl.td_loss(q, target, jb, jnp.zeros(32, jnp.float32)),
            has_aux=True)(p)
        upd, opt = jl.tx.update(g, opt, p)
        return optax.apply_updates(p, upd), opt, loss, prios

    p1, opt1, _, _ = jax_step(params, jl.tx.init(params), batches[0])
    p2, _, loss2, prios2 = jax_step(p1, opt1, batches[1])

    tl = DQ.DQN(interop.qnet_from_flax(params, AttentionQNet(A)),
                cfg=DQNConfig(), double_q=double_q)
    interop.qnet_from_flax(target, tl.target_net)
    tb = [RB.Batch(*(_t(x) for x in b)) for b in batches]
    tl.train_on(tb[0], torch.zeros(32))
    ref1 = interop.qnet_from_flax(p1, AttentionQNet(A))
    for (name, p), r in zip(tl.net.named_parameters(), ref1.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(),
                                   err_msg=name, **_param_tol(name, 1, 1e-3))

    # second step from JAX's own state after step 1
    tl2 = DQ.DQN(interop.qnet_from_flax(p1, AttentionQNet(A)),
                 cfg=DQNConfig(), double_q=double_q)
    interop.qnet_from_flax(target, tl2.target_net)
    interop.adam_state_from_optax(opt1, tl2.optimizer, tl2.net)
    loss_t, prios_t = tl2.train_on(tb[1], torch.zeros(32))
    np.testing.assert_allclose(float(loss_t), float(loss2), rtol=1e-5)
    np.testing.assert_allclose(prios_t.numpy(), np.asarray(prios2),
                               rtol=1e-5, atol=1e-7)
    ref2 = interop.qnet_from_flax(p2, AttentionQNet(A))
    moved = 0.0
    for (name, p), r, r1 in zip(tl2.net.named_parameters(), ref2.parameters(),
                                ref1.parameters()):
        np.testing.assert_allclose(p.detach().numpy(), r.detach().numpy(),
                                   err_msg=name, **_param_tol(name, 2, 1e-3))
        moved = max(moved, float((r - r1).detach().abs().max()))
    assert moved > 1e-4  # the step really moved the weights

    # update_target: a device-side select, then a plain copy
    tl2.update_target(torch.tensor(False))
    assert not torch.equal(tl2.target_net.head[0].weight, tl2.net.head[0].weight)
    tl2.update_target(torch.tensor(True))
    assert torch.equal(tl2.target_net.head[0].weight, tl2.net.head[0].weight)
