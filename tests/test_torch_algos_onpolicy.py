"""PyTorch port of the algorithm family, on-policy half: ``algos/common``,
``algos/nets``, A2C, PPO (discrete, continuous, PPO1), TRPO, ACKTR,
ACER and GAIL against the JAX package (``dcarl_tpu/algos``).

Both packages start from the JAX ``init_fn``'s state (flax params,
optax states and ACKTR's Dense lists carried over with ``interop``), and
each port update takes the draws the JAX update makes from the same key
(``tests/torch_algos_jax.py`` repeats its splits) through
``update_fn.with_draws``.  JAX runs in float32.  After each of three
updates the parameters, optimizer moments, env state and metrics are
held to rtol 1e-5 / atol 1e-6, integers exactly.  TRPO is held to rtol
1e-4 / atol 1e-5: ten conjugate-gradient steps on Fisher-vector products
(a second backward here, a jvp of the gradient in JAX) and the line
search's step scale amplify rounding.  ACKTR (two linear solves a block
on factors built from float32 products) and ACER (the f-space
projection divides by the action probabilities) are held to the same.
"""

import contextlib
import functools

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.algos import a2c as JA2C
from dcarl_tpu.algos import acer as JACER
from dcarl_tpu.algos import acktr as JACKTR
from dcarl_tpu.algos import common as JC
from dcarl_tpu.algos import gail as JGAIL
from dcarl_tpu.algos import nets as JN
from dcarl_tpu.algos import ppo as JPPO
from dcarl_tpu.algos import trpo as JTRPO
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.algos import a2c as A2C
from dcarl_tpu_torch.algos import acer as ACER
from dcarl_tpu_torch.algos import acktr as ACKTR
from dcarl_tpu_torch.algos import common as C
from dcarl_tpu_torch.algos import gail as GAIL
from dcarl_tpu_torch.algos import nets as N
from dcarl_tpu_torch.algos import ppo as PPO
from dcarl_tpu_torch.algos import trpo as TRPO
from dcarl_tpu_torch.parallel.normalize import RunningMeanStd

import torch_algos_jax as H
from torch_algos_jax import one_torch_thread  # noqa: F401 (fixture)

STEPS = 3
HID = (16, 16)
B = 8
LOOSE = dict(rtol=1e-4, atol=1e-5)


def _keys():
    return [jax.random.PRNGKey(100 + i) for i in range(STEPS)]


def _jax_run(init, update, *init_args, f64=False):
    """The JAX state after init and after each update (host copies) and
    the metrics; ``f64``: the init state cast to float64 (inside
    ``H.x64()``), so the whole update runs in float64."""
    with H.f32():
        st = init(jax.random.PRNGKey(0), *init_args)
        if f64:
            st = jax.tree.map(lambda a: a.astype(jnp.float64)
                              if a.dtype == jnp.float32 else a, st)
        step = jax.jit(update)
        states, metrics = [jax.device_get(st)], []
        for k in _keys():
            st, m = step(st, k)
            states.append(jax.device_get(st))
            metrics.append(jax.device_get(m))
    return states, metrics


# ---------------------------------------------------------------------------
# common


def test_schedules_match_jax():
    steps = np.array([0, 3, 50, 100, 500], np.int32)
    for s in steps:
        want = float(JC.linear_schedule(100, 1.0, 0.1)(jnp.asarray(s)))
        got = float(C.linear_schedule(100, 1.0, 0.1)(torch.tensor(s)))
        assert got == pytest.approx(want, rel=1e-6)
        assert float(C.constant_schedule(0.3)(torch.tensor(s))) == \
            pytest.approx(float(JC.constant_schedule(0.3)(jnp.asarray(s))))
        lr = optax.linear_schedule(1e-3, 0.0, 64)(jnp.asarray(s))
        assert float(C.linear_lr_schedule(1e-3, 0.0, 64)(torch.tensor(s))) \
            == pytest.approx(float(lr), rel=1e-6)


def test_returns_gae_polyak_match_jax():
    rng = np.random.default_rng(0)
    r = rng.normal(size=(6, 5)).astype(np.float32)
    v = rng.normal(size=(6, 5)).astype(np.float32)
    d = (rng.random((6, 5)) < 0.3).astype(np.float32)
    boot = rng.normal(size=(5,)).astype(np.float32)
    with H.f32():
        want = JC.discounted_returns(jnp.asarray(r), jnp.asarray(d),
                                     jnp.asarray(boot), 0.9)
        adv, ret = JC.gae(*(jnp.asarray(a) for a in (r, v, d, boot)),
                          0.99, 0.95)
        pol = JC.polyak({"a": jnp.asarray(r)}, {"a": jnp.asarray(v)}, 0.01)
    np.testing.assert_allclose(
        C.discounted_returns(*(torch.as_tensor(a) for a in (r, d, boot)),
                             0.9).numpy(), np.asarray(want), rtol=1e-6)
    a2, r2 = C.gae(*(torch.as_tensor(a) for a in (r, v, d, boot)), 0.99, 0.95)
    np.testing.assert_allclose(a2.numpy(), np.asarray(adv), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(r2.numpy(), np.asarray(ret), rtol=1e-6,
                               atol=1e-7)
    np.testing.assert_allclose(
        C.polyak({"a": torch.as_tensor(r)}, {"a": torch.as_tensor(v)},
                 0.01)["a"].numpy(), np.asarray(pol["a"]), rtol=1e-6)


@pytest.mark.parametrize("kind", ["identity", "box"])
def test_identity_envs_match_jax(kind):
    n = 3 if kind == "identity" else 2
    jenv = JC.identity_env(n, 4) if kind == "identity" \
        else JC.identity_env_box(n, 4)
    tenv = C.identity_env(n, 4) if kind == "identity" \
        else C.identity_env_box(n, 4)
    rng = np.random.default_rng(1)
    with H.f32():
        keys = jax.random.split(jax.random.PRNGKey(3), 6)
        jst, jobs = jenv.reset(jax.random.split(keys[0], B))
        tst, tobs = tenv.reset(H.reset_draws(keys[0], B, kind, n))
        for k in keys[1:]:
            a = rng.integers(0, n, B).astype(np.int32) if kind == "identity" \
                else rng.uniform(-1, 1, (B, n)).astype(np.float32)
            jst, jobs, jr, jd = jenv.step(jst, jnp.asarray(a),
                                          jax.random.split(k, B))
            tst, tobs, tr, td = tenv.step(
                tst, torch.as_tensor(a),
                H.t(H.env_draws(jax.random.split(k, B), kind, n)))
            for got, want in ((tobs, jobs), (tr, jr), (td, jd),
                              (tst[0], jst[0]), (tst[1], jst[1])):
                np.testing.assert_allclose(got.numpy(), np.asarray(want),
                                           rtol=1e-6)


@pytest.mark.parametrize("policy", ["categorical", "gaussian"])
def test_collect_rollout_bit_equal(policy):
    """Sampled actions, observations, rewards and done flags of a
    rollout on JAX's draws are JAX's, bit for bit."""
    if policy == "categorical":
        jenv, tenv, kind, n = JC.identity_env(3), C.identity_env(3), \
            "identity", 3
        jnet = JN.CategoricalActorCritic(3, HID)
        tnet = N.CategoricalActorCritic(3, 3, HID)
    else:
        jenv, tenv, kind, n = JC.identity_env_box(2), C.identity_env_box(2), \
            "box", 2
        jnet = JN.GaussianActorCritic(2, HID)
        tnet = N.GaussianActorCritic(2, 2, HID)
    with H.f32():
        jp = jnet.init(jax.random.PRNGKey(0), jnp.zeros((1, n)))
        k_env, k_roll = jax.random.split(jax.random.PRNGKey(5))
        jst, jobs = jenv.reset(jax.random.split(k_env, B))

        def jpolicy(o, k):
            out = jnet.apply(jp, o)
            if policy == "categorical":
                return jax.random.categorical(k, out[0])
            return out[0] + jnp.exp(out[1]) * jax.random.normal(
                k, out[0].shape)

        _, _, jtraj = jax.jit(lambda s, o, k: JC.collect_rollout(
            jenv, jpolicy, s, o, k, 6))(jst, jobs, k_roll)
        draws = H.rollout_draws(k_roll, 6, B, (n,), kind, n,
                                "gumbel" if policy == "categorical"
                                else "normal")
    tp = H.params(jp, tnet)

    def tpolicy(o, d):
        out = N.apply(tnet, tp, o)
        if policy == "categorical":
            return C.categorical_sample(out[0], d)
        return out[0] + torch.exp(out[1]) * d

    tst, tobs = tenv.reset(H.reset_draws(k_env, B, kind, n))
    _, _, ttraj = C.collect_rollout(tenv, tpolicy, tst, tobs, draws)
    for name in C.Transition._fields:
        got, want = getattr(ttraj, name).numpy(), np.asarray(
            getattr(jtraj, name))
        if policy == "categorical":
            np.testing.assert_array_equal(got, want, err_msg=name)
        else:
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_optimizers_match_optax():
    """clip_by_global_norm + adam (with and without a schedule) and
    clip + rmsprop, five steps from optax's own state, moments and
    parameters; the clip both below and above its norm."""
    rng = np.random.default_rng(2)
    p0 = {"w": rng.normal(size=(4, 3)).astype(np.float32),
          "b": rng.normal(size=(3,)).astype(np.float32)}
    cases = [
        (optax.chain(optax.clip_by_global_norm(0.5), optax.adam(1e-2, eps=1e-5)),
         C.chain(C.clip_by_global_norm(0.5), C.adam(1e-2, eps=1e-5))),
        (optax.chain(optax.clip_by_global_norm(50.0),
                     optax.adam(optax.linear_schedule(1e-2, 0.0, 4), eps=1e-5)),
         C.chain(C.clip_by_global_norm(50.0),
                 C.adam(C.linear_lr_schedule(1e-2, 0.0, 4), eps=1e-5))),
        (optax.chain(optax.clip_by_global_norm(0.5),
                     optax.rmsprop(7e-4, decay=0.99, eps=1e-5)),
         C.chain(C.clip_by_global_norm(0.5), C.rmsprop(7e-4, 0.99, 1e-5))),
    ]
    for jtx, ttx in cases:
        with H.f32():
            jp = {k: jnp.asarray(v) for k, v in p0.items()}
            js = jtx.init(jp)
        tp = {k: torch.as_tensor(v) for k, v in p0.items()}
        ts = ttx.init(tp)
        for i in range(5):
            g = {k: rng.normal(size=v.shape).astype(np.float32) * (i + 1)
                 for k, v in p0.items()}
            with H.f32():
                up, js = jtx.update({k: jnp.asarray(v) for k, v in g.items()},
                                    js, jp)
                jp = optax.apply_updates(jp, up)
            up, ts = ttx.update({k: torch.as_tensor(v) for k, v in g.items()},
                                ts, tp)
            tp = C.apply_updates(tp, up)
            for k in p0:
                np.testing.assert_allclose(tp[k].numpy(), np.asarray(jp[k]),
                                           rtol=1e-6, atol=1e-7)
        H.assert_close(ts, _opt_like(js, ts), rtol=1e-6, atol=1e-7)


def _opt_like(js, ts):
    """optax's state as the port's of the same layout (a dict of arrays
    for params, so the generic converter's module is not needed)."""
    kind = type(js).__name__

    def like(d, port):
        return H.t({k: d[k] for k in port})

    if kind == "ScaleByAdamState":
        return C.ScaleByAdamState(H.t(js.count), like(js.mu, ts.mu),
                                  like(js.nu, ts.nu))
    if kind == "ScaleByRmsState":
        return C.ScaleByRmsState(like(js.nu, ts.nu))
    if kind == "ScaleByScheduleState":
        return C.ScaleByScheduleState(H.t(js.count))
    if kind == "EmptyState":
        return C.EmptyState()
    return tuple(_opt_like(a, b) for a, b in zip(js, ts))


# ---------------------------------------------------------------------------
# nets


def _nets():
    return [
        ("categorical", JN.CategoricalActorCritic(4, HID),
         N.CategoricalActorCritic(5, 4, HID), 1),
        ("gaussian", JN.GaussianActorCritic(2, HID),
         N.GaussianActorCritic(5, 2, HID), 1),
        ("deterministic", JN.DeterministicActor(2, HID),
         N.DeterministicActor(5, 2, HID), 1),
        ("q", JN.QCritic(HID), N.QCritic(5, 2, HID), 2),
        ("twin_q", JN.TwinQCritic(HID), N.TwinQCritic(5, 2, HID), 2),
        ("squashed", JN.SquashedGaussianActor(2, HID),
         N.SquashedGaussianActor(5, 2, HID), 1),
        ("acer", JACER._PolicyQNet(3), ACER.PolicyQNet(5, 3), 1),
        ("adversary", JGAIL.Adversary(16), GAIL.Adversary(5, 2, 16), 2),
        ("her_mlp", JN.MLP((32, 4)), N.MLP(5, (32, 4)), 1),
    ]


@pytest.mark.parametrize("case", _nets(), ids=lambda c: c[0])
def test_nets_forward_match_flax(case):
    name, jnet, tnet, n_in = case
    rng = np.random.default_rng(3)
    obs = rng.normal(size=(7, 5)).astype(np.float32)
    act = rng.uniform(-1, 1, (7, 2)).astype(np.float32)
    args = (obs,) if n_in == 1 else (obs, act)
    with H.f32():
        jp = jnet.init(jax.random.PRNGKey(1), *(jnp.asarray(a) for a in args))
        if "log_std" in jp["params"]:   # a nonzero state-independent std
            jp = {"params": {**jp["params"],
                             "log_std": jnp.asarray([0.3, -0.2])}}
        want = jnet.apply(jp, *(jnp.asarray(a) for a in args))
    got = N.apply(tnet, H.params(jp, tnet), *(torch.as_tensor(a)
                                              for a in args))
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.detach().numpy(), np.asarray(w),
                                   rtol=1e-6, atol=1e-6, err_msg=name)


def test_distributions_match_jax():
    rng = np.random.default_rng(4)
    logits = rng.normal(size=(9, 4)).astype(np.float32)
    action = rng.integers(0, 4, 9).astype(np.int32)
    mean = rng.normal(size=(9, 2)).astype(np.float32)
    log_std = rng.normal(scale=0.5, size=(9, 2)).astype(np.float32)
    a_c = rng.normal(size=(9, 2)).astype(np.float32)
    with H.f32():
        key = jax.random.PRNGKey(6)
        eps = jax.random.normal(key, mean.shape)
        j_sq = JN.squashed_sample(jnp.asarray(mean), jnp.asarray(log_std), key)
        want = [JN.categorical_log_prob(jnp.asarray(logits),
                                        jnp.asarray(action)),
                JN.categorical_entropy(jnp.asarray(logits)),
                JN.gaussian_log_prob(jnp.asarray(mean), jnp.asarray(log_std),
                                     jnp.asarray(a_c)),
                JN.gaussian_entropy(jnp.asarray(log_std)), *j_sq]
    t = torch.as_tensor
    got = [N.categorical_log_prob(t(logits), t(action)),
           N.categorical_entropy(t(logits)),
           N.gaussian_log_prob(t(mean), t(log_std), t(a_c)),
           N.gaussian_entropy(t(log_std)),
           *N.squashed_sample(t(mean), t(log_std), H.t(eps))]
    for i, (g, w) in enumerate(zip(got, want)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6,
                                   atol=1e-6, err_msg=str(i))


# ---------------------------------------------------------------------------
# The learners, three updates each from JAX's init on JAX's draws


def _ac_state(cls, js, net, opt_field="opt_state"):
    f = js._asdict()
    return cls(H.params(f["params"], net), H.opt(f[opt_field], net),
               H.t(f["env_state"]), H.t(f["obs"]), H.t(f["step"]))


def _check(run_port, js_list, jm_list, convert, metric_keys, **tol):
    state = convert(js_list[0])
    for i, k in enumerate(_keys()):
        state, m = run_port(state, k)
        H.assert_close(state, convert(js_list[i + 1]), what=f"update {i}",
                       **tol)
        H.assert_metrics(m, jm_list[i], metric_keys, **tol)
    return state


def test_a2c_matches_jax():
    jenv, tenv = JC.identity_env(3), C.identity_env(3)
    cfg = JA2C.A2CConfig(n_steps=4)
    js, jm = _jax_run(*JA2C.make_a2c(jenv, cfg, HID), B)
    _, upd = A2C.make_a2c(tenv, A2C.A2CConfig(n_steps=4), HID)

    def convert(s):
        f = s._asdict()
        return A2C.A2CState(
            H.params(f["params"], upd.net),
            interop.rmsprop_state_from_optax(f["opt_state"], upd.net, "cpu"),
            H.t(f["env_state"]), H.t(f["obs"]), H.t(f["step"]))

    _check(lambda s, k: upd.with_draws(s, A2C.A2CDraws(H.rollout_draws(
        k, 4, B, (3,), "identity", 3))), js, jm, convert,
        ["pg_loss", "vf_loss", "entropy", "reward_mean"])


@pytest.mark.parametrize("variant", ["discrete", "continuous", "ppo1"])
def test_ppo_matches_jax(variant):
    if variant == "continuous":
        jenv, tenv, kind, n, pol = JC.identity_env_box(2), \
            C.identity_env_box(2), "box", 2, "normal"
    else:
        jenv, tenv, kind, n, pol = JC.identity_env(3), C.identity_env(3), \
            "identity", 3, "gumbel"
    if variant == "ppo1":
        jcfg = JPPO.ppo1_config(total_updates=4)._replace(n_steps=4)
        tcfg = PPO.ppo1_config(total_updates=4)._replace(n_steps=4)
    else:
        jcfg = JPPO.PPOConfig(n_steps=4, n_epochs=2, n_minibatches=2,
                              learning_rate=1e-3)
        tcfg = PPO.PPOConfig(n_steps=4, n_epochs=2, n_minibatches=2,
                             learning_rate=1e-3)
    js, jm = _jax_run(*JPPO.make_ppo(jenv, jcfg, HID), B)
    _, upd = PPO.make_ppo(tenv, tcfg, HID)
    _check(lambda s, k: upd.with_draws(s, H.ppo_draws(
        k, 4, B, (n,), kind, n, tcfg.n_epochs, pol)), js, jm,
        lambda s: _ac_state(PPO.PPOState, s, upd.net),
        ["pg_loss", "vf_loss", "reward_mean"])


@contextlib.contextmanager
def _default_dtype(dt):
    """torch's default float type, as JAX's follows 64-bit mode."""
    prev = torch.get_default_dtype()
    torch.set_default_dtype(dt)
    try:
        yield
    finally:
        torch.set_default_dtype(prev)


def _trpo_state(s, net):
    return _ac_state(TRPO.TRPOState, s, net, "vf_opt")


@pytest.mark.parametrize("variant", ["discrete", "continuous", "wide_kl"])
def test_trpo_matches_jax(variant):
    """``wide_kl`` (max_kl 200) makes the quadratic model overshoot, so the
    line search backtracks; the accepted index is JAX's, read back from
    the policy head's step (the value regression leaves that head).

    ``continuous`` and ``wide_kl`` run in float64 on both sides (JAX's
    state cast to float64, its draws in 64-bit mode) and are held to
    rtol 1e-9: in float32 the Gaussian's ``log_std`` step is
    ill-conditioned (the port in float32 and in float64 differ by 6e-4
    relative there, as JAX's float32 step differs from the float64 one),
    and after the wide steps a third update's rounding grows past 1e-3,
    which no float32 tolerance of 1e-4 could hold."""
    f64 = variant != "discrete"
    if variant == "continuous":
        jenv, tenv, kind, n, pol = JC.identity_env_box(2), \
            C.identity_env_box(2), "box", 2, "normal"
    else:
        jenv, tenv, kind, n, pol = JC.identity_env(3), C.identity_env(3), \
            "identity", 3, "gumbel"
    max_kl = 200.0 if variant == "wide_kl" else 0.05
    jcfg = JTRPO.TRPOConfig(n_steps=8, max_kl=max_kl)
    tcfg = TRPO.TRPOConfig(n_steps=8, max_kl=max_kl)
    tol = dict(rtol=1e-9, atol=1e-10) if f64 else LOOSE
    dt = torch.float64 if f64 else torch.float32

    def cast(tree):
        return C.tree_map(lambda x: x.to(dt) if x.is_floating_point() else x,
                          tree)

    with H.x64() if f64 else contextlib.nullcontext(), \
            _default_dtype(dt):
        js, jm = _jax_run(*JTRPO.make_trpo(jenv, jcfg, HID), B, f64=f64)
        _, upd = TRPO.make_trpo(tenv, tcfg, HID)
        state = cast(_trpo_state(js[0], upd.net))
        head = "mean" if variant == "continuous" else "pi"
        backtracks = []
        for i, k in enumerate(_keys()):
            old = {k2: v.clone() for k2, v in state.params.items()}
            state, m = upd.with_draws(state, cast(TRPO.TRPODraws(
                H.rollout_draws(k, 8, B, (n,), kind, n, pol))))
            want = cast(_trpo_state(js[i + 1], upd.net))
            H.assert_close(state, want, what=f"update {i}", **tol)
            H.assert_metrics(m, jm[i], ["gain", "kl", "accepted",
                                        "reward_mean", "expected_improve"],
                             **tol)
            # JAX's accepted step fraction along the port's step direction
            dp = torch.cat([(state.params[f"{head}.{w}"] - old[f"{head}.{w}"])
                            .reshape(-1) for w in ("weight", "bias")])
            dj = torch.cat([(want.params[f"{head}.{w}"] - old[f"{head}.{w}"])
                            .reshape(-1) for w in ("weight", "bias")])
            if float(m["accepted"]):
                frac_j = float(m["step_frac"]) * float(dj @ dp) \
                    / float(dp @ dp)
                idx_j = int(round(np.log(frac_j)
                                  / np.log(tcfg.backtrack_coeff)))
            else:
                assert float(dj.abs().max()) == 0.0
                idx_j = tcfg.backtrack_iters
            assert int(m["backtrack"]) == idx_j
            backtracks.append(idx_j)
    if variant == "wide_kl":
        assert max(backtracks) > 0, backtracks


def test_acktr_matches_jax():
    jenv, tenv = JC.identity_env(3), C.identity_env(3)
    js, jm = _jax_run(*JACKTR.make_acktr(jenv, JACKTR.ACKTRConfig(n_steps=4),
                                         HID), B)
    _, upd = ACKTR.make_acktr(tenv, ACKTR.ACKTRConfig(n_steps=4), HID)

    def convert(s):
        kf = s.kfac
        dense = functools.partial(interop.acktr_params_from_numpy,
                                  device="cpu")
        return ACKTR.ACKTRState(
            dense(s.params),
            ACKTR.KFACState(H.t(tuple(kf.factors_a)), H.t(tuple(kf.factors_g)),
                            dense(kf.velocity), H.t(kf.t)),
            H.t(s.env_state), H.t(s.obs), H.t(s.step))

    _check(lambda s, k: upd.with_draws(s, H.acktr_draws(k, 4, B, 3)), js, jm,
           convert, ["pg_loss", "vf_loss", "entropy", "reward_mean"], **LOOSE)


def test_acer_matches_jax():
    jenv, tenv = JC.identity_env(3), C.identity_env(3)
    kw = dict(n_steps=4, buffer_segments=4, replay_start=2, replay_ratio=2)
    js, jm = _jax_run(*JACER.make_acer(jenv, JACER.ACERConfig(**kw), batch=B))
    _, upd = ACER.make_acer(tenv, ACER.ACERConfig(**kw), batch=B)

    def convert(s):
        net = upd.net
        return ACER.ACERState(
            H.params(s.params, net), H.params(s.avg_params, net),
            interop.rmsprop_state_from_optax(s.opt_state, net, "cpu"),
            ACER.SegmentBuffer(*H.t(tuple(s.buffer))), H.t(s.env_state),
            H.t(s.obs), H.t(s.step))

    state = convert(js[0])
    for i, k in enumerate(_keys()):
        size_after = min(int(state.buffer.size) + 1, 4)
        state, m = upd.with_draws(state, H.acer_draws(k, 4, B, 3, 2,
                                                      size_after))
        H.assert_close(state, convert(js[i + 1]), what=f"update {i}", **LOOSE)
        H.assert_metrics(m, jm[i], ["loss_q", "entropy", "reward_mean"],
                         **LOOSE)


def test_gail_matches_jax():
    jenv, tenv = JC.identity_env(3), C.identity_env(3)
    ids = np.random.default_rng(0).integers(0, 3, 32)
    exp_obs = np.eye(3, dtype=np.float32)[ids]
    kw = dict(g_step=2, d_batch=16, hidden_size_adversary=16)
    jcfg = JGAIL.GAILConfig(trpo=JTRPO.TRPOConfig(n_steps=4, entcoeff=0.01),
                            **kw)
    tcfg = GAIL.GAILConfig(trpo=TRPO.TRPOConfig(n_steps=4, entcoeff=0.01),
                           **kw)
    with H.f32():
        jfns = JGAIL.make_gail(jenv, jnp.asarray(exp_obs), jnp.asarray(ids),
                               jcfg, HID)
    js, jm = _jax_run(*jfns, B)
    _, upd = GAIL.make_gail(tenv, torch.as_tensor(exp_obs),
                            torch.as_tensor(ids), tcfg, HID)

    def convert(s):
        return GAIL.GAILState(
            _trpo_state(s.trpo, upd.trpo.net),
            H.params(s.d_params, upd.adversary),
            H.opt(s.d_opt, upd.adversary),
            RunningMeanStd(*H.t(tuple(s.obs_rms))), H.t(s.step))

    _check(lambda s, k: upd.with_draws(s, H.gail_draws(k, tcfg, B, 3, 32)),
           js, jm, convert, ["adversary_reward", "gen_loss", "expert_loss",
                             "gen_acc", "expert_acc"], **LOOSE)


# ---------------------------------------------------------------------------
# Learning smoke (learnability proper runs on the card: chip_smoke.py)


def test_a2c_learns_identity():
    """``tests/test_algos.py::test_a2c_identity``'s configuration and
    threshold (300 updates, 32 envs, n_steps 8), on the port's own
    generator."""
    init, upd = A2C.make_a2c(C.identity_env(3), A2C.A2CConfig(n_steps=8))
    g = torch.Generator().manual_seed(0)
    state = init(g, 32)
    rewards = []
    for _ in range(300):
        state, m = upd(state, g)
        rewards.append(float(m["reward_mean"]))
    assert sum(rewards[-20:]) / 20 > 0.8, rewards[-20:]


# ---------------------------------------------------------------------------
# Two gloo ranks


def test_ppo_over_two_ranks():
    """PPO over a two-rank mesh (``run_ranks``): on the same draws the
    mesh update is the one-rank update bit for bit; on each rank's own
    draws the parameters stay bit-equal across the ranks."""
    from dcarl_tpu_torch.parallel.launch import run_ranks

    import torch_rank_programs as RP
    outs = run_ranks(RP.ppo_mesh_checks, 2, "gloo", "cpu", timeout_s=90)
    for o in outs:
        assert o["same_draws_equal_one_rank"]
    for k in outs[0]["own_draws"]:
        np.testing.assert_array_equal(outs[0]["own_draws"][k],
                                      outs[1]["own_draws"][k], err_msg=k)
        np.testing.assert_array_equal(outs[0]["same_draws"][k],
                                      outs[1]["same_draws"][k], err_msg=k)
    assert any(not np.array_equal(outs[0]["own_draws"][k],
                                  outs[0]["same_draws"][k])
               for k in outs[0]["own_draws"])
