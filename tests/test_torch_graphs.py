"""PyTorch port: the compiled run (``dcarl_tpu_torch/utils/graphs.py``).

On the card each main-path maker (rule driver, collector, gated driver,
trainer) replays one captured CUDA graph a tick, as the JAX package jits
one ``lax.scan`` a run; on the CPU and over a mesh it runs the eager
loop (``graphs.run_loop``).  Here, with no card, :func:`static_run`
runs what a capture records, with every tick eager: the carry and the
inputs copied into the runner's static buffers, each tick's outputs
written at a device-side step index, the new carry written back in
place, the step index advanced.  Each maker's static run must equal its
eager loop bit for bit: outputs, final carry, the generator's state and,
for the trainer, the learner.  It must also stay within the tolerances
of ``tests/test_torch_fast_rollout.py`` and
``tests/test_torch_train_fast.py`` against the JAX package.

The trainer's Adam is ``capturable`` on the card (its state on the
device, its step count in float64).  Torch takes that Adam on CUDA
tensors only; with that device check lifted, the same arithmetic runs
here and holds every check of those two files against JAX.

JAX is imported inside the cases that compare with it, so that the
``cuda``-marked case at the end, graphed against eager on the card, runs
on a machine without JAX: ``python -m pytest --noconftest
tests/test_torch_graphs.py -m cuda``.
"""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.parallel.mesh import make_mesh
from dcarl_tpu_torch.planning import fast_rollout as tfr
from dcarl_tpu_torch.train_fast import TrainDraws, make_trainer_fast
from dcarl_tpu_torch.utils import graphs

CPU = torch.device("cpu")
B = 8
GATE = dict(visited_times_thres=10, rl_visited_times_min=5)
TRAIN_STEPS = 12  # past the 10-step window, so records flush into the store
TRAIN_KW = dict(batch_per_device=4, store_capacity_per_device=512,
                replay_capacity_per_device=128)


@pytest.fixture(scope="module", autouse=True)
def one_torch_thread():
    """Loops of tiny ops on one intra-op thread: on the default count the
    suite's parallel workers spin for each other's cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _leaves(tree):
    out = []
    if isinstance(tree, dict):
        tree = list(tree.values())
    if isinstance(tree, torch.Tensor):
        return [tree]
    if isinstance(tree, (tuple, list)):
        for x in tree:
            out += _leaves(x)
    return out


def assert_bit_equal(a, b, what=""):
    la, lb = _leaves(a), _leaves(b)
    assert la and len(la) == len(lb), what
    for i, (x, y) in enumerate(zip(la, lb)):
        assert x.shape == y.shape and x.dtype == y.dtype, (what, i)
        assert torch.equal(x, y), f"{what}: tensor {i} differs"


def static_run(runner, carry, inputs, n, generator):
    """What a replayed run computes, each tick eager: the runner's static
    buffers loaded with ``carry`` and ``inputs``, ``n`` ticks on them,
    then copies of the final carry and the stacked outputs."""
    cap, specs = runner._load(carry, inputs, n)
    for _ in range(n):
        runner._tick(cap, specs, generator)
    return runner._result(cap, specs)


def _static_and_loop(run_fn, carry, inputs, n, seed):
    """(static run, eager loop), each (carry, outs, generator state), from
    the same carry and generator seed."""
    g_s, g_l = _gen(seed), _gen(seed)
    static = static_run(run_fn.runner, carry, inputs, n, g_s)
    loop = graphs.run_loop(run_fn.runner.tick, carry, inputs, n, g_l)
    return (*static, g_s.get_state()), (*loop, g_l.get_state())


# ---------------------------------------------------------------------------
# The runner's static buffers on a toy tick; the route of each maker
# ---------------------------------------------------------------------------


def _toy_tick(carry, inputs, generator):
    """A carry of two tensors, the second returned as the new first (an
    alias of a static buffer), a draw and an input."""
    a, b = carry
    noise = torch.rand(a.shape, generator=generator)
    return (b, a + b * inputs[0] + noise), (a.sum(), b * 2.0)


def test_static_buffers_on_a_toy_tick():
    """An aliasing carry, a draw and an input through the static buffers
    equal the eager loop; a second run of the same shapes reuses the
    buffers; a run of no ticks raises."""
    runner = graphs.TickRunner(_toy_tick, compiled=False)
    carry = (torch.arange(6.0).reshape(2, 3), torch.ones(2, 3))
    results = []
    for run in (lambda *a: static_run(runner, *a),
                lambda *a: graphs.run_loop(_toy_tick, *a)):
        g = _gen(0)
        results.append((run(carry, (torch.tensor(0.5),), 7, g),
                        g.get_state()))
    assert_bit_equal(results[0], results[1], "toy tick")
    first = runner.last
    static_run(runner, carry, (torch.tensor(2.0),), 7, _gen(1))
    assert runner.last is first
    with pytest.raises(ValueError, match="n_steps"):
        static_run(runner, carry, (torch.tensor(0.5),), 0, _gen(0))


def _make(name, **kw):
    """(run_fn, runner) of one maker on the CPU."""
    sc = t_intersection()
    if name == "trainer":
        run = make_trainer_fast(tcfg.DCARLConfig(), device="cpu", **TRAIN_KW,
                                **kw)[3](2)
    elif name == "gated":
        run = tfr.make_gated_driver_fast(sc, device="cpu", **kw)[1]
    else:
        run = getattr(tfr, f"make_{name}_fast")(sc, device="cpu", **kw)[1]
    return run, run.runner


@pytest.mark.parametrize("name", ("rule_driver", "collector", "gated",
                                  "trainer"))
def test_the_cpu_runs_the_eager_loop(name):
    """Compiled on a CUDA device only: on the CPU a run is the eager
    loop."""
    assert _make(name)[1].compiled is False


@pytest.mark.parametrize("name", ("gated", "trainer"))
def test_a_mesh_stays_eager(name):
    assert _make(name, mesh=make_mesh(device="cpu"))[1].compiled is False


# ---------------------------------------------------------------------------
# The drivers: static run == eager loop bit for bit, and == JAX
# ---------------------------------------------------------------------------


def _jax_carry(jfr, j_sc, dtype, collector=False):
    import jax

    make = jfr.make_collector_fast if collector else jfr.make_rule_driver_fast
    init_j, _ = make(j_sc, dtype=dtype)
    return init_j(jax.random.split(jax.random.PRNGKey(0), B))


def _collector_carry(c, dtype):
    """The JAX collector's carry as the port's."""
    def t(a, dt=None):
        return torch.as_tensor(np.array(a), dtype=dt)

    return tfr.FastCollectorCarry(
        env=interop.fast_env_state_from_numpy(c.env, CPU, dtype),
        triggered=t(c.triggered), locked_x=t(c.locked_x, dtype),
        locked_y=t(c.locked_y, dtype),
        locked_speed_end=t(c.locked_speed_end, dtype),
        recorded_state=t(c.recorded_state, dtype),
        used_action=t(c.used_action, torch.int32))


@pytest.mark.parametrize("collector", [False, True],
                         ids=["rule_driver", "collector"])
def test_driver_static_run_matches_loop_and_jax_f64(collector):
    """20 ticks of 8 envs in f64 from JAX's carry: the static run equals
    the loop bit for bit, and JAX's integer outputs exactly, its reals
    within 1e-9 (no env finishes, so the auto-reset draws never enter)."""
    import jax
    import jax.numpy as jnp

    from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
    from dcarl_tpu.planning import fast_rollout as jfr

    steps, j_sc = 20, j_t_intersection()
    carry_j = _jax_carry(jfr, j_sc, jnp.float64, collector)
    make_j = jfr.make_collector_fast if collector else jfr.make_rule_driver_fast
    _, ref = make_j(j_sc, dtype=jnp.float64)[1](
        carry_j, jax.random.split(jax.random.PRNGKey(1), steps))
    make_t = tfr.make_collector_fast if collector else tfr.make_rule_driver_fast
    _, run_t = make_t(t_intersection(), dtype=torch.float64, device="cpu")
    carry = (_collector_carry(carry_j, torch.float64) if collector else
             interop.fast_env_state_from_numpy(carry_j, CPU, torch.float64))
    static, loop = _static_and_loop(run_t, carry, (), steps, 1)
    assert_bit_equal(static, loop, "static run against the loop")
    for got, want in zip(_leaves(static[1]), _leaves(tuple(ref))):
        want = np.asarray(want)
        if want.dtype.kind == "f":
            np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-9)
        else:
            np.testing.assert_array_equal(got.numpy(), want)
    done = static[1].done if collector else static[1][1]
    assert not done.any() and done.shape == (steps, B)


@pytest.mark.parametrize("name", ("rule_driver", "collector"))
def test_static_run_through_auto_resets(name):
    """Episodes of 8 ticks, so every env resets and the jitter draws
    enter: the static run equals the loop, the generator included.  A
    second run from another carry is copied into the same buffers and
    equals its loop too."""
    make = getattr(tfr, f"make_{name}_fast")
    init_fn, run_fn = make(t_intersection(), tcfg.EnvConfig(
        max_episode_steps=8), device="cpu")
    for seed in (0, 5):
        carry = init_fn(16, _gen(seed))
        static, loop = _static_and_loop(run_fn, carry, (), 20, seed + 1)
        assert_bit_equal(static, loop, f"{name} from seed {seed}")
        done = static[1].done if name == "collector" else static[1][1]
        assert done.sum() >= 16 * 2
        if seed == 0:
            first = run_fn.runner.last
    assert run_fn.runner.last is first


@pytest.fixture(scope="module")
def store():
    """Rows near the start observation (rule action 0 low-valued,
    candidate 3 high-valued) among random rows, and an invalid tail:
    ``tests/test_torch_fast_rollout.py``'s store."""
    import jax
    import jax.numpy as jnp

    from dcarl_tpu.config import EnvConfig as JEnvConfig
    from dcarl_tpu.env import driving_env as jde
    from dcarl_tpu.env.scenario import t_intersection as j_t_intersection

    sc = j_t_intersection()
    sa = jde.scenario_to_device(sc, jnp.float64)
    env0 = jde.reset(sa, jax.random.PRNGKey(0), JEnvConfig())
    _, obs0 = jde.wrap_state(env0, sa, jde.in_state_indices(sc), JEnvConfig())
    obs0 = np.asarray(obs0)
    rng = np.random.default_rng(2)
    rows, vals = [], []
    for _ in range(40):
        base = obs0 + rng.normal(0, 0.05, 20)
        rows += [np.r_[base, 0.0], np.r_[base, 3.0]]
        vals += [-5.0 + rng.normal(0, 0.1), 5.0 + rng.normal(0, 0.1)]
    for _ in range(300):
        rows.append(np.r_[obs0 + rng.normal(0, 1.0, 20), rng.integers(0, 11)])
        vals.append(rng.normal(0, 2.0))
    keys = np.concatenate([np.asarray(rows), np.full((64, 21), 1e6)])
    vals = np.concatenate([np.asarray(vals), np.zeros(64)])
    valid = np.arange(len(keys)) < len(rows)
    return keys.astype(np.float32), vals.astype(np.float32), valid


def test_gated_static_run_matches_loop_and_jax_f64(store):
    """The brute route in f64 with a query offset, 6 ticks: the static
    run equals the loop bit for bit and JAX's outputs (integers exactly,
    rewards within 1e-9)."""
    import jax
    import jax.numpy as jnp

    from dcarl_tpu.config import StoreConfig as JStoreConfig
    from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
    from dcarl_tpu.planning import fast_rollout as jfr

    steps = 6
    offset = np.zeros(20)
    offset[0], offset[6] = 0.4, -0.7
    carry_j = _jax_carry(jfr, j_t_intersection(), jnp.float64)
    _, run_j = jfr.make_gated_driver_fast(
        j_t_intersection(), store_cfg=JStoreConfig(**GATE),
        dtype=jnp.float64, use_pallas=False, with_query_offset=True)
    _, ref = run_j(carry_j, jax.random.split(jax.random.PRNGKey(1), steps),
                   *(jnp.asarray(a) for a in store), jnp.asarray(offset))
    _, run_t = tfr.make_gated_driver_fast(
        t_intersection(), store_cfg=tcfg.StoreConfig(**GATE),
        dtype=torch.float64, device="cpu", use_kernel=False,
        with_query_offset=True)
    carry = interop.fast_env_state_from_numpy(carry_j, CPU, torch.float64)
    inputs = run_t.inputs(*interop.store_from_numpy(*store, CPU),
                          torch.as_tensor(offset))
    static, loop = _static_and_loop(run_t, carry, inputs, steps, 1)
    assert_bit_equal(static, loop, "gated static run against the loop")
    reward, *ints = static[1]
    for name, got, want in zip(("done", "passed", "collided", "executed",
                                "gated"), ints, ref[1:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want), name)
    np.testing.assert_allclose(reward.numpy(), np.asarray(ref[0]), rtol=0,
                               atol=1e-9)
    assert not np.asarray(ref[1]).any()


def test_gated_kernel_route_takes_a_new_store_by_copy(store):
    """The kernel route (the per-action prepare and the kernel's plain
    version), f32: two stores of the same size go through the same
    static buffers, each run equal to its loop bit for bit, and the gate
    fires."""
    _, run_t = tfr.make_gated_driver_fast(
        t_intersection(), store_cfg=tcfg.StoreConfig(**GATE), device="cpu",
        use_kernel=True)
    keys, vals, valid = interop.store_from_numpy(*store, CPU)
    init_fn, _ = tfr.make_rule_driver_fast(t_intersection(), device="cpu")
    carry = init_fn(B, _gen(0))
    runs = []
    for v in (vals, -vals):
        inputs = run_t.inputs(keys, v, valid)
        static, loop = _static_and_loop(run_t, carry, inputs, 5, 1)
        assert_bit_equal(static, loop, "kernel-route static run")
        runs.append((run_t.runner.last, static[1]))
    assert runs[0][0] is runs[1][0]
    assert (runs[0][1][5] > 0).any()
    assert not torch.equal(runs[0][1][5], runs[1][1][5])


# ---------------------------------------------------------------------------
# The trainer: static run == eager loop, learner included, and == JAX
# ---------------------------------------------------------------------------


def _train_cfg(mod):
    return mod.DCARLConfig(
        env=mod.EnvConfig(reset_jitter=0.0),
        dqn=mod.DQNConfig(batch_size=8, replay_capacity=256,
                          target_update_every=3))


def _jax_key(step):
    import jax

    return jax.random.PRNGKey(100 + step)


def _jax_draws(step) -> TrainDraws:
    """The draws of JAX trainer step ``step`` (``train_fast.py:217``),
    as ``tests/test_torch_train_fast.py`` takes them."""
    import jax

    from dcarl_tpu import config as jcfg

    cfg, b = _train_cfg(jcfg), TRAIN_KW["batch_per_device"]
    key = jax.random.fold_in(_jax_key(step), 0)
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
            k_train, (cfg.dqn.batch_size, TRAIN_KW["replay_capacity_per_device"])))
    return TrainDraws(*(torch.as_tensor(np.array(x)) for x in out))


@pytest.fixture(scope="module")
def jax_trainer():
    """The JAX trainer (1-device mesh, brute route) over TRAIN_STEPS steps:
    its start state, metrics and end state, and its draws."""
    import jax

    from dcarl_tpu import config as jcfg
    from dcarl_tpu.parallel.mesh import make_mesh as j_make_mesh
    from dcarl_tpu.train_fast import make_trainer_fast as j_make_trainer_fast

    init_j, step_j, _, _ = j_make_trainer_fast(
        j_make_mesh("env", jax.devices()[:1]), "env", _train_cfg(jcfg),
        use_pallas=False, **TRAIN_KW)
    s0 = s = init_j(seed=0)
    metrics = []
    for step in range(TRAIN_STEPS):
        s, m = step_j(s, _jax_key(step))
        metrics.append(m)
    return s0, metrics, s, [_jax_draws(i) for i in range(TRAIN_STEPS)]


def _port_trainer(s0):
    """A port trainer started from the JAX state ``s0``: (step_fn,
    learner, state)."""
    _, step_t, learner, _ = make_trainer_fast(_train_cfg(tcfg), device="cpu",
                                              use_kernel=False, **TRAIN_KW)
    interop.qnet_from_flax(s0.params, learner.net)
    interop.qnet_from_flax(s0.target_params, learner.target_net)
    interop.adam_state_from_optax(s0.opt_state, learner.optimizer,
                                  learner.net)
    return step_t, learner, interop.fast_train_state_from_numpy(s0, CPU)


def _card_adam(monkeypatch, step_dtype=torch.float64):
    """The card's Adam for every DQN made inside the test: capturable
    (torch's CUDA-only check lifted) and multi-tensor, as torch runs it
    on CUDA tensors; its step count in ``step_dtype``."""
    import torch.optim.adam as adam_mod

    from dcarl_tpu_torch.models import dqn as DQ

    supported = adam_mod._get_capturable_supported_devices
    monkeypatch.setattr(adam_mod, "_get_capturable_supported_devices",
                        lambda *a, **k: [*supported(*a, **k), "cpu"])
    adam, dqn = torch.optim.Adam, DQ.DQN
    monkeypatch.setattr(torch.optim, "Adam",
                        lambda *a, **k: adam(*a, **{**k, "foreach": True}))

    def card_dqn(*a, **k):
        learner = dqn(*a, **{**k, "capturable": True})
        for st in learner.optimizer.state.values():
            st["step"] = st["step"].to(step_dtype)
        return learner

    monkeypatch.setattr(DQ, "DQN", card_dqn)


def _assert_trainer_matches_jax(metrics_t, state, learner, jax_trainer,
                                td_residuals=True):
    """``tests/test_torch_train_fast.py``'s tolerances: metrics rtol 1e-4
    / atol 1e-5, store keys exact and values 1e-5, priorities rtol 1e-4,
    parameters rtol 1e-4 / atol 1e-6 (the attention's saturated q_lin /
    k_lin to lr a step).  ``td_residuals=False`` leaves out the TD
    residuals: the loss metric and the priorities."""
    from dcarl_tpu_torch.models.networks import AttentionQNet

    _, metrics_j, s_j, _ = jax_trainer
    for step, (mj, mt) in enumerate(zip(metrics_j, metrics_t)):
        for name in mj._fields:
            if name == "loss" and not td_residuals:
                continue
            np.testing.assert_allclose(
                np.asarray(getattr(mt, name), np.float64),
                np.asarray(getattr(mj, name), np.float64), rtol=1e-4,
                atol=1e-5, err_msg=f"step {step} metric {name}")
    for name in ("store_size", "store_head", "store_total", "traj_len"):
        np.testing.assert_array_equal(getattr(state, name).numpy(),
                                      np.asarray(getattr(s_j, name)), name)
    np.testing.assert_array_equal(state.store_keys.numpy(),
                                  np.asarray(s_j.store_keys, np.float32))
    np.testing.assert_allclose(state.store_values.numpy(),
                               np.asarray(s_j.store_values), rtol=0,
                               atol=1e-5)
    if td_residuals:
        np.testing.assert_allclose(state.replay.priority.numpy(),
                                   np.asarray(s_j.replay.priority),
                                   rtol=1e-4, atol=1e-6)
    lr = _train_cfg(tcfg).dqn.lr
    for tree, net in ((s_j.params, learner.net),
                      (s_j.target_params, learner.target_net)):
        ref = interop.qnet_from_flax(tree, AttentionQNet(11))
        for (name, p), r in zip(net.named_parameters(), ref.parameters()):
            tol = (dict(rtol=0, atol=TRAIN_STEPS * lr)
                   if name[:5] in ("q_lin", "k_lin")
                   else dict(rtol=1e-4, atol=1e-6))
            np.testing.assert_allclose(p.detach().numpy(),
                                       r.detach().numpy(), err_msg=name,
                                       **tol)
    assert int(state.frame) == TRAIN_STEPS


def _with_jax_draws(step_t):
    """A trainer tick that takes step ``frame``'s draws from the stacked
    ``draws`` it reads, indexed on the device (as JAX's scan takes its
    step keys)."""
    def tick(state, draws, generator):
        i = state.frame.reshape(1).to(torch.int64)
        return step_t.with_draws(
            state, TrainDraws(*(d.index_select(0, i)[0] for d in draws)),
            generator)
    return tick


def test_trainer_static_run_matches_loop_and_jax(jax_trainer):
    """JAX's draws through a static run (stacked, taken at the step index
    on the device) and through the eager loop of ``with_draws``: the same
    bits, learner included, and within JAX's tolerances."""
    s0, _, _, draws = jax_trainer
    stacked = TrainDraws(*(torch.stack(f) for f in zip(*draws)))
    step_t, learner, state0 = _port_trainer(s0)
    start = learner.state_dict()
    state_l, metrics_l = state0, []
    for d in draws:
        state_l, m = step_t.with_draws(state_l, d, _gen(0))
        metrics_l.append(m)
    learner_l = learner.state_dict()
    learner.load_state_dict(start)
    runner = graphs.TickRunner(_with_jax_draws(step_t), compiled=False)
    state_s, metrics_s = static_run(runner, state0, stacked, TRAIN_STEPS,
                                    _gen(0))
    assert_bit_equal((state_s, metrics_s, learner.state_dict()),
                     (state_l, [torch.stack(f) for f in zip(*metrics_l)],
                      learner_l), "trainer static run against the loop")
    _assert_trainer_matches_jax(
        [type(metrics_s)(*(f[i] for f in metrics_s))
         for i in range(TRAIN_STEPS)], state_s, learner, jax_trainer)


@pytest.mark.parametrize("double_q", [False, True])
def test_capturable_adam_steps_match_jax(double_q, monkeypatch):
    """``tests/test_torch_models.py``'s two TD + Adam steps against optax,
    with the card's capturable Adam: loss, priorities and parameters
    within that test's tolerances."""
    import test_torch_models

    _card_adam(monkeypatch)
    test_torch_models.test_td_loss_and_adam_steps_match_jax(double_q)


@pytest.mark.parametrize("step_dtype", [torch.float64, torch.float32],
                         ids=["float64", "float32"])
def test_capturable_adam_trainer_against_jax(jax_trainer, monkeypatch,
                                             step_dtype):
    """The trainer with the card's capturable Adam over JAX's draws holds
    every check of ``tests/test_torch_train_fast.py`` at its tolerance,
    with the port's float64 step count.  The witness of why: with torch's
    float32 step count (its bias corrections ``1 - 0.999 ** t`` lose
    1.3e-5 of themselves to cancellation at t = 1) every check holds
    but the TD residuals' (the loss metric and the priorities: small
    differences of far larger Q-values), which leave their 1e-4."""
    _card_adam(monkeypatch, step_dtype)
    s0, _, _, draws = jax_trainer
    step_t, learner, state = _port_trainer(s0)
    for st in learner.optimizer.state.values():
        st["step"] = st["step"].to(step_dtype)
    assert learner.optimizer.defaults["capturable"]
    metrics = []
    for d in draws:
        state, m = step_t.with_draws(state, d, _gen(0))
        metrics.append(m)
    assert {st["step"].dtype for st in learner.optimizer.state.values()} \
        == {step_dtype}
    if step_dtype == torch.float64:
        _assert_trainer_matches_jax(metrics, state, learner, jax_trainer)
        return
    _assert_trainer_matches_jax(metrics, state, learner, jax_trainer,
                                td_residuals=False)
    with pytest.raises(AssertionError):
        _assert_trainer_matches_jax(metrics, state, learner, jax_trainer)


def test_capturable_learner_keeps_its_adam_tensors(monkeypatch):
    """A capturable learner has Adam's state from the start (a float64
    step count, zero moments), and so after a reset; a load of its state
    dict writes into those tensors, which a captured step goes on
    writing, and the step count stays float64."""
    from dcarl_tpu_torch.models import dqn as DQ
    from dcarl_tpu_torch.models.networks import AttentionQNet

    def adam_tensors(learner):
        return [v for st in learner.optimizer.state.values()
                for v in st.values()]

    _card_adam(monkeypatch)
    learner = DQ.DQN(AttentionQNet(11, generator=_gen(0)), capturable=True)
    tensors = adam_tensors(learner)
    assert len(tensors) == 3 * len(list(learner.net.parameters()))
    assert not any(v.any() for v in tensors)
    saved = learner.state_dict()
    for v in tensors:
        v.add_(1.0)
    learner.load_state_dict(saved)
    now = adam_tensors(learner)
    assert all(a is b for a, b in zip(now, tensors))
    assert not any(v.any() for v in now)
    learner.reset(AttentionQNet(11, generator=_gen(1)))
    assert not any(v.any() for v in adam_tensors(learner))
    assert {st["step"].dtype for st in learner.optimizer.state.values()} \
        == {torch.float64}


def test_trainer_static_run_draws_like_the_loop(monkeypatch):
    """The trainer's own draws (its generator, resets every 6 steps), from
    a fresh capturable learner: static run and loop give the same bits,
    learner and generator included.  A load of the learner's state keeps
    the tensors the static buffers hold, so the next run reuses them."""
    _card_adam(monkeypatch)
    cfg = tcfg.DCARLConfig(env=tcfg.EnvConfig(max_episode_steps=6))
    init_t, _, learner, factory = make_trainer_fast(
        cfg, device="cpu", backfill_budget_per_step=16, **TRAIN_KW)
    runner = factory(8).runner
    state0 = init_t(seed=1)
    start = learner.state_dict()
    results = []
    for route in ("loop", "static"):
        learner.load_state_dict(start)
        g = _gen(3)
        if route == "static":
            out = static_run(runner, state0, (), 8, g)
        else:
            out = graphs.run_loop(runner.tick, state0, (), 8, g)
        results.append((out, learner.state_dict(), g.get_state()))
    assert_bit_equal(results[0], results[1], "trainer static run")
    assert int(results[0][0][1].done_count.sum()) > 0
    first = runner.last
    learner.load_state_dict(start)
    static_run(runner, state0, (), 8, _gen(3))
    assert runner.last is first


# ---------------------------------------------------------------------------
# On the card: graphed runs equal the eager loop
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph is captured and "
                    "replayed only on the card)")
    from dcarl_tpu_torch import disable_tf32

    disable_tf32()
    return torch.device("cuda")


@pytest.mark.cuda
def test_graphed_runs_equal_eager_on_the_card(cuda):
    """64 envs x 8 ticks of each driver and 8 steps of the trainer on a
    2^10-row store: graphed outputs, final carry, generator (and learner)
    bit-equal to the eager loop of the same tick; one store-kernel launch
    a tick."""
    from dcarl_tpu_torch.ops import _cuda

    sc, rng = t_intersection(), np.random.default_rng(0)
    n = 1 << 10
    keys = np.zeros((n, 21), np.float32)
    keys[:, :-1] = rng.normal(0, 1, (n, 20)) * 20 + 100
    keys[:, -1] = rng.integers(0, 11, n)
    store = [torch.as_tensor(a, device=cuda) for a in (
        keys, rng.normal(0, 1, n).astype(np.float32), np.ones(n, bool))]
    kw = dict(batch_per_device=64, store_capacity_per_device=n,
              replay_capacity_per_device=n, backfill_budget_per_step=64)

    def gen(seed):
        return torch.Generator(device=cuda).manual_seed(seed)

    def driver(make, *args):
        """(graphed run, eager run) of a driver from one carry."""
        init_fn, run_fn = make(sc)
        carry = init_fn(64, gen(0))
        inputs = run_fn.inputs(*store) if args else ()

        def graphed():
            return (run_fn(carry, 8, *args, generator=gen(1)) if args
                    else run_fn(carry, 8, gen(1)))

        def eager():
            return graphs.run_loop(run_fn.runner.tick, carry, inputs, 8,
                                   gen(1))
        return graphed, eager

    def trainer():
        init_fn, _, learner, factory = make_trainer_fast(
            tcfg.DCARLConfig(store=tcfg.driving_store_config()), **kw)
        run_fn, state0 = factory(8), init_fn(seed=0)
        start = learner.state_dict()

        def route(graphed):
            learner.load_state_dict(start)
            out = (run_fn(state0, gen(1)) if graphed else
                   graphs.run_loop(run_fn.runner.tick, state0, (), 8, gen(1)))
            return out, learner.state_dict()
        return (lambda: route(True)), (lambda: route(False))

    for label, (graphed, eager), kernel in (
            ("rule", driver(tfr.make_rule_driver_fast), None),
            ("collector", driver(tfr.make_collector_fast), None),
            ("gated", driver(tfr.make_gated_driver_fast, *store),
             "peraction_moments"),
            ("trainer", trainer(), "sorted_moments")):
        outs = []
        for run in (graphed, eager):
            _cuda.LAUNCHES.clear()
            outs.append((run(), dict(_cuda.LAUNCHES)))
            torch.cuda.synchronize()
        assert_bit_equal(outs[0][0], outs[1][0], label)
        assert outs[0][1] == outs[1][1] == ({kernel: 8} if kernel else {}), \
            label
