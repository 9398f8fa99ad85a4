"""PyTorch port: the confidence core, the data generator and the dataset
loader against the JAX package (``dcarl_tpu/core/confidence.py``,
``dcarl_tpu/data/``).

Everything runs in float64 here, as the golden demos do.  The bound
functions are elementwise with the same association as JAX, so they are
compared to the last place: exactly, but for one ulp where a square
root enters (PyTorch's CPU ``sqrt`` is not correctly rounded for every
float64 input, XLA's is; ``sqrt(1.4978661367769954 / 10.0)`` is one
such input).  The golden stream loop (waves of distinct states in the
port, a ``lax.scan`` in JAX) is compared on generated data: decisions
and activation steps equal, values within rtol 1e-10 (the two-pass
moments sum a bucket in another order), on a 20-state stream and on a
one-state stream; the batched run is also held to the port's own
row-by-row ``golden_update``.  The generator's random stream is
torch's, so it is compared with JAX's by distribution, as
``tests/test_confidence.py:187`` checks JAX's against the reference's.
The bundled-dataset loader is run on a small ``.npy`` tree written under
the test's temporary directory.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import ConfidenceConfig as JCC
from dcarl_tpu.core import confidence as JC
from dcarl_tpu.data import sampling as jsampling
from dcarl_tpu_torch.config import ConfidenceConfig
from dcarl_tpu_torch.core import confidence as C
from dcarl_tpu_torch.data import datasets, sampling

CFG, JCFG = ConfidenceConfig(), JCC()


def _t(a):
    return torch.as_tensor(np.array(a))


def test_bound_functions_match_jax_to_the_last_place():
    rng = np.random.default_rng(0)
    n = rng.integers(1, 400, 64).astype(np.float64)
    mean = rng.normal(20, 60, 64)
    dsum = mean * n
    sigma = np.abs(rng.normal(30, 10, 64))
    is_rule = rng.random(64) < 0.3
    pairs = [
        (C.hoeffding_margin(_t(n), 0.05, 150.0),
         JC.hoeffding_margin(jnp.asarray(n), 0.05, 150.0)),
        (C.upper_bound(_t(mean), _t(n), CFG),
         JC.upper_bound(jnp.asarray(mean), jnp.asarray(n), JCFG)),
        (C.lower_bound(_t(mean), _t(n), CFG),
         JC.lower_bound(jnp.asarray(mean), jnp.asarray(n), JCFG)),
        (C.ci_lower_bound(_t(dsum), _t(sigma), _t(n), CFG),
         JC.ci_lower_bound(jnp.asarray(dsum), jnp.asarray(sigma),
                           jnp.asarray(n), JCFG)),
        (C.mean_value(_t(mean * 3), CFG),
         JC.mean_value(jnp.asarray(mean * 3), JCFG)),
        (C.tsrl_bound(_t(mean), _t(dsum), _t(sigma), _t(n), _t(is_rule), CFG),
         JC.tsrl_bound(jnp.asarray(mean), jnp.asarray(dsum),
                       jnp.asarray(sigma), jnp.asarray(n),
                       jnp.asarray(is_rule), JCFG)),
    ]
    for got, ref in pairs:
        assert got.dtype == torch.float64
        np.testing.assert_array_max_ulp(got.numpy(), np.asarray(ref),
                                        maxulp=1)
    # a host count and bool (the golden loop's form) give the same bits
    for i in range(8):
        got = C.tsrl_bound(_t(mean[i]), _t(dsum[i]), _t(sigma[i]), float(n[i]),
                           bool(is_rule[i]), CFG)
        assert float(got) == float(pairs[-1][1][i])


def _stream(seed, n, s, a):
    """JAX-generated data (``sampling.generate``) in float64."""
    ds = jsampling.generate(jax.random.PRNGKey(seed), state_num=s,
                            action_num=a, size=n)
    return (np.asarray(ds.data, np.float64),
            np.asarray(ds.action_values, np.float64))


@pytest.fixture(scope="module")
def golden_pair():
    data, av = _stream(0, 3000, 20, 11)
    cap = JC.required_capacity(data, 20, 11)
    assert cap == C.required_capacity(data, 20, 11)
    table_j, out_j = jax.device_get(JC.golden_run(
        jnp.asarray(data), jnp.asarray(av), action_num=11, capacity=cap,
        cfg=JCFG))
    table_t, out_t = C.golden_run(data, av, action_num=11, capacity=cap,
                                  cfg=CFG, device="cpu")
    return data, table_j, out_j, table_t, out_t


def test_golden_run_matches_jax(golden_pair):
    data, table_j, out_j, table_t, out_t = golden_pair
    np.testing.assert_array_equal(out_t.state_idx.numpy(), out_j.state_idx)
    np.testing.assert_array_equal(out_t.tsrl_action.numpy(), out_j.tsrl_action)
    np.testing.assert_array_equal(table_t.activation_step.numpy(),
                                  table_j.activation_step)
    np.testing.assert_array_equal(table_t.counts, table_j.counts)
    np.testing.assert_array_equal(table_t.seen, table_j.seen)
    for got, ref in ((out_t.step_value, out_j.step_value),
                     (out_t.true_value, out_j.true_value),
                     (out_t.overall_value, out_j.overall_value),
                     (table_t.tsrl, table_j.tsrl),
                     (table_t.values, table_j.values)):
        assert got.dtype == torch.float64
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=0)
    # the stream activates some states and moves off the rule action
    assert (table_t.activation_step.numpy() > 0).any()
    assert (out_t.tsrl_action.numpy() != 0).any()


def test_golden_run_waves_match_the_row_loop(golden_pair):
    """golden_run's batched rows against golden_update applied row by row
    (the JAX scan's body), on the stream's first 1,500 rows."""
    data = golden_pair[0][:1500]
    av = torch.as_tensor(_stream(0, 10, 20, 11)[1])
    cap = C.required_capacity(data, 20, 11)
    table_w, out_w = C.golden_run(data, av, action_num=11, capacity=cap,
                                  cfg=CFG, device="cpu")
    table = C.golden_init(20, 11, cap, CFG, device="cpu")
    outs = []
    for row in torch.as_tensor(data):
        table, out = C.golden_update(table, int(row[0]), int(row[2]), row[3],
                                     av, CFG)
        outs.append(out)
    loop = C.StepOutput(*(torch.stack(f) for f in zip(*outs)))
    np.testing.assert_array_equal(out_w.state_idx, loop.state_idx)
    np.testing.assert_array_equal(out_w.tsrl_action, loop.tsrl_action)
    np.testing.assert_array_equal(table_w.activation_step,
                                  table.activation_step)
    np.testing.assert_array_equal(table_w.counts, table.counts)
    np.testing.assert_array_equal(table_w.seen, table.seen)
    for got, ref in ((out_w.step_value, loop.step_value),
                     (out_w.true_value, loop.true_value),
                     (out_w.overall_value, loop.overall_value),
                     (table_w.tsrl, table.tsrl), (table_w.values, table.values)):
        np.testing.assert_allclose(got.numpy(), ref.numpy(), rtol=1e-12, atol=0)
    assert (table.activation_step.numpy() > 0).any()


def test_golden_run_one_state_stream_matches_jax():
    """A one-state stream (Simulation_1's shape): every row visits the same
    state, so its rows share one table row; decisions equal to JAX's."""
    ds = jsampling.generate(jax.random.PRNGKey(3), state_num=1,
                            action_num=11, size=1500)
    data = np.asarray(ds.data, np.float64)
    av = np.asarray(ds.action_values, np.float64)
    cap = C.required_capacity(data, 1, 11)
    table_j, out_j = jax.device_get(JC.golden_run(
        jnp.asarray(data), jnp.asarray(av), action_num=11, capacity=cap,
        cfg=JCFG))
    table_t, out_t = C.golden_run(data, av, action_num=11, capacity=cap,
                                  cfg=CFG, device="cpu")
    np.testing.assert_array_equal(out_t.tsrl_action.numpy(), out_j.tsrl_action)
    np.testing.assert_array_equal(table_t.activation_step.numpy(),
                                  table_j.activation_step)
    np.testing.assert_array_equal(table_t.counts, table_j.counts)
    for got, ref in ((out_t.step_value, out_j.step_value),
                     (out_t.overall_value, out_j.overall_value),
                     (table_t.tsrl, table_j.tsrl)):
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-10, atol=0)
    assert (out_t.tsrl_action.numpy() != 0).any()
    assert int(table_t.activation_step[0]) > 0


def test_golden_run_refuses_a_quiet_cpu_run(monkeypatch):
    """numpy input with no device asks for the card, and raises without
    one: it does not run on the CPU unasked."""
    data, av = _stream(0, 50, 20, 11)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        C.golden_run(data, av, action_num=11, capacity=16, cfg=CFG)


def test_running_table_matches_jax_and_golden(golden_pair):
    """Sequential running updates: the JAX running table's cells, and the
    golden table's decisions (``tests/test_confidence.py:134``)."""
    data, _, out_j, _, _ = golden_pair
    data = data[:600]
    t = C.running_init((20, 11), CFG, dtype=torch.float64, device="cpu")
    tj = JC.running_init((20, 11), JCFG, dtype=jnp.float64)
    acts = []
    for row in data:
        t = C.running_update(t, int(row[0]), int(row[2]), float(row[3]), CFG)
        tj = JC.running_update(tj, jnp.int32(row[0]), jnp.int32(row[2]),
                               jnp.float64(row[3]), JCFG)
        a, _ = C.select_actions(t.tsrl[int(row[0])])
        acts.append(int(a))
    for name in C.RunningTable._fields:
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(tj, name)),
                                   rtol=1e-10, atol=1e-10, err_msg=name)
    np.testing.assert_array_equal(acts, out_j.tsrl_action[:600])


def test_running_update_batch_matches_jax_and_vmapped_streams():
    rng = np.random.default_rng(2)
    n, s, a, b = 500, 4, 4, 6
    idx = rng.integers(0, s, (b, n))
    act = rng.integers(0, a, (b, n))
    val = rng.normal(10, 30, (b, n))
    one = C.running_update_batch(C.running_init((s, a), CFG, torch.float64, "cpu"),
                                 _t(idx[0]), _t(act[0]), _t(val[0]), CFG)
    ref = JC.running_update_batch(JC.running_init((s, a), JCFG, jnp.float64),
                                  jnp.asarray(idx[0]), jnp.asarray(act[0]),
                                  jnp.asarray(val[0]), JCFG)
    for name in C.RunningTable._fields:
        np.testing.assert_allclose(getattr(one, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-12, atol=1e-9, err_msg=name)
    # b independent streams at once (JAX: vmap over streams)
    many = C.running_update_batch(
        C.running_init((b, s, a), CFG, torch.float64, "cpu"), _t(idx), _t(act),
        _t(val), CFG)
    vm = jax.vmap(lambda i, ac, v: JC.running_update_batch(
        JC.running_init((s, a), JCFG, jnp.float64), i, ac, v, JCFG))(
        jnp.asarray(idx), jnp.asarray(act), jnp.asarray(val))
    for name in C.RunningTable._fields:
        np.testing.assert_allclose(getattr(many, name).numpy(),
                                   np.asarray(getattr(vm, name)),
                                   rtol=1e-12, atol=1e-9, err_msg=name)
    assert int(many.count.sum()) == b * n


def test_argmax_takes_the_first_of_tied_maxima():
    """The priors tie every non-rule action at -50: with the rule's value
    below them the decision is action 1, as np.argmax and jnp.argmax
    pick it."""
    row = np.full((3, 11), -50.0)
    row[0, 0] = -60.0
    row[1, [3, 7]] = 5.0
    row[2, :] = 2.5
    act, val = C.select_actions(_t(row))
    np.testing.assert_array_equal(act.numpy(), np.argmax(row, -1))
    np.testing.assert_array_equal(act.numpy(),
                                  np.asarray(JC.select_actions(
                                      jnp.asarray(row))[0]))
    np.testing.assert_array_equal(act.numpy(), [1, 3, 0])
    np.testing.assert_array_equal(val.numpy(), [-50.0, 5.0, 2.5])
    # in the golden loop: the rule's cell drops below the tied priors
    table = C.golden_init(1, 11, 16, CFG, device="cpu")
    table.tsrl[0, 0] = -60.0
    _, out = C.golden_update(table, 0, 5, torch.tensor(1.0, dtype=torch.float64),
                             torch.zeros((1, 11), dtype=torch.float64), CFG)
    assert int(out.tsrl_action) == 1 and int(table.activation_step[0]) == 1


def test_generate_matches_the_generative_process():
    """``tests/test_confidence.py:187``'s checks on the port's generator,
    beside JAX's."""
    ds = sampling.generate(torch.Generator().manual_seed(0), state_num=20,
                           action_num=11, size=50000)
    data, valid = ds.data.numpy(), ds.valid.numpy()
    assert data.shape == (50000, 4) and data.dtype == np.float32
    kept = data[valid]
    counts = np.bincount(kept[:, 0].astype(int), minlength=20)
    assert counts.argmax() in (9, 10)
    assert valid.mean() > 0.9
    acts = np.bincount(kept[:, 2].astype(int), minlength=11)
    assert acts.min() > 0.7 * acts.max()
    av = ds.action_values.numpy()
    assert -50.0 <= av.min() and av.max() <= 100.0
    resid = kept[:, 3] - av[kept[:, 0].astype(int), kept[:, 2].astype(int)]
    assert abs(resid.mean()) < 2.0 and abs(resid.std() - 50.0) < 2.0
    # the same shares as JAX's stream, within sampling noise
    jds = jsampling.generate(jax.random.PRNGKey(0), state_num=20,
                             action_num=11, size=50000)
    jvalid = np.asarray(jds.valid)
    jcounts = np.bincount(np.asarray(jds.data)[jvalid, 0].astype(int),
                          minlength=20)
    np.testing.assert_allclose(counts / counts.sum(), jcounts / jcounts.sum(),
                               atol=0.01)
    assert abs(valid.mean() - jvalid.mean()) < 0.005
    np.testing.assert_array_equal(data[:, 1], ds.states.numpy()[
        data[:, 0].astype(int)])


def test_generate_state_indices_manual():
    idx = sampling.generate_state_indices_manual(
        torch.Generator().manual_seed(1), 20, 40000, rare_prob=0.1).numpy()
    jidx = np.asarray(jsampling.generate_state_indices_manual(
        jax.random.PRNGKey(1), 20, 40000, rare_prob=0.1))
    assert idx.dtype == np.int32 and idx.min() == 0 and idx.max() == 19
    for x in (idx, jidx):
        assert abs((x == 0).mean() - 0.1) < 0.01
        assert np.bincount(x, minlength=20)[1:].min() > 0.8 * 0.9 / 19 * 40000


def test_dataset_loader_on_a_small_tree(tmp_path):
    sim1 = tmp_path / "Simulation_testing" / "Simulation_1"
    sim2 = tmp_path / "Simulation_testing" / "Simulation_2"
    sim1.mkdir(parents=True)
    sim2.mkdir(parents=True)
    rng = np.random.default_rng(3)
    d1, av1 = rng.normal(0, 1, (50, 4)), rng.normal(0, 1, (1, 11))
    d2, av2 = rng.normal(0, 1, (70, 4)), rng.normal(0, 1, (20, 11))
    np.save(sim1 / "data_carla.npy", d1)
    np.save(sim1 / "action_value_carla.npy", av1)
    np.save(sim2 / "data.npy", d2)
    np.save(sim2 / "action_value.npy", av2)
    assert datasets.reference_available(str(tmp_path))
    assert not datasets.reference_available(str(tmp_path / "absent"))
    s1 = datasets.load_sim1(str(tmp_path))
    np.testing.assert_array_equal(s1.data, d1)
    assert s1.action_values.shape == (1, 30) and s1.action_num == 30
    np.testing.assert_array_equal(s1.action_values[:, :11], av1)
    assert np.isnan(s1.action_values[:, 11:]).all() and s1.stream_len == 20000
    s2 = datasets.load_sim2(str(tmp_path))
    np.testing.assert_array_equal(s2.data, d2)
    np.testing.assert_array_equal(s2.action_values, av2)
    assert (s2.action_num, s2.stream_len, s2.states) == (11, 20000, None)


@pytest.mark.parametrize("env_root", [False, True],
                         ids=["variable_unset", "variable_set"])
def test_default_dataset_root_matches_jax(env_root, tmp_path, monkeypatch):
    """F2: with no ``root`` the port looks where JAX looks, with
    ``DCARL_REFERENCE_ROOT`` unset and set.  JAX reads the variable at
    import, so its module is reloaded under the patched environment (and
    once more after, under the restored one)."""
    import importlib

    from dcarl_tpu.data import datasets as jdatasets

    if env_root:
        monkeypatch.setenv("DCARL_REFERENCE_ROOT", str(tmp_path))
    else:
        monkeypatch.delenv("DCARL_REFERENCE_ROOT", raising=False)
    try:
        importlib.reload(jdatasets)
        for name in ("Simulation_1", "Simulation_2"):
            assert datasets._sim_dir(name, None) == jdatasets._sim_dir(name)
        assert datasets.default_root() == jdatasets.DEFAULT_ROOT
        if env_root:
            assert datasets.default_root() == str(tmp_path)
        assert datasets.reference_available() \
            == jdatasets.reference_available()
    finally:
        monkeypatch.undo()
        importlib.reload(jdatasets)
