"""PyTorch port: the continuous-improvement loop (``dcarl_tpu/improvement.py``).

* ``demo_config`` equals the JAX package's field by field.
* ``evaluate_gated`` against JAX's on the same numpy store (and on the
  empty store), at ``reset_jitter=0`` so both fleets start and reset
  alike, 16 envs x 30 ticks in float64 (both functions' drivers are made
  in float64 here, through their module attribute): episode, pass and
  collision counts and the activation fraction equal, reward per step
  within 1e-9.
* ``train_store``'s shard merge and per-chunk history against JAX's, from
  the same trainer output (both packages' trainers replaced by the same
  recorded states and metrics).
* One port-only closed loop at ``tests/test_improvement.py``'s
  configuration, scale and seed, with its assertions.  The port's random
  streams differ from JAX's, so it is the same loop on other draws.
"""

import dataclasses
import functools
from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu import improvement as jimp
from dcarl_tpu.planning import fast_rollout as jfr
from dcarl_tpu_torch import improvement as timp
from dcarl_tpu_torch.config import DRIVING_HALF_WIDTHS
from dcarl_tpu_torch.env import driving_env as tde
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.planning import fast_rollout as tfr
from dcarl_tpu_torch.train import StepMetrics


def _cfgs(**env):
    j, t = jimp.demo_config(reset_jitter=0.0), timp.demo_config(
        reset_jitter=0.0)
    return (dataclasses.replace(j, env=dataclasses.replace(j.env, **env)),
            dataclasses.replace(t, env=dataclasses.replace(t.env, **env)))


def test_demo_config_matches_jax():
    for kw in ({}, dict(conservative_radius=11.0, value_mode="episode",
                        gamma=1.0, n_step_window=300)):
        assert dataclasses.asdict(timp.demo_config(**kw)) \
            == dataclasses.asdict(jimp.demo_config(**kw))


@pytest.fixture(scope="module")
def gate_store():
    """Rows around the fleet's spawn observation: the rule action low-
    valued, candidate 3 high-valued (the gate fires there), plus random
    rows and an invalid tail."""
    _, cfg = _cfgs()
    sc = t_intersection(cfg.env)
    init, _ = tfr.make_rule_driver_fast(sc, cfg.env, dtype=torch.float64,
                                        device="cpu")
    carry = init(1, torch.Generator().manual_seed(0))
    obs0 = tfr._obs_ori_soa(carry, tde.in_state_indices(sc))[:, 0].numpy()
    rng = np.random.default_rng(4)
    rows, vals = [], []
    for _ in range(40):
        base = obs0 + rng.normal(0, 0.05, 20)
        rows += [np.r_[base, 0.0], np.r_[base, 3.0]]
        vals += [-5.0 + rng.normal(0, 0.1), 5.0 + rng.normal(0, 0.1)]
    for _ in range(200):
        rows.append(np.r_[obs0 + rng.normal(0, 1.0, 20), rng.integers(0, 11)])
        vals.append(rng.normal(0, 2.0))
    keys = np.concatenate([np.asarray(rows), np.full((24, 21), 1e6)])
    return {"keys": keys.astype(np.float32),
            "values": np.r_[vals, np.zeros(24)].astype(np.float32),
            "valid": np.arange(len(keys)) < len(rows)}


@pytest.mark.parametrize("arm", ["gated", "empty_store"])
def test_evaluate_gated_matches_jax_f64(monkeypatch, gate_store, arm):
    monkeypatch.setattr(jimp, "make_gated_driver_fast", functools.partial(
        jfr.make_gated_driver_fast, dtype=jnp.float64))
    monkeypatch.setattr(timp, "make_gated_driver_fast", functools.partial(
        tfr.make_gated_driver_fast, dtype=torch.float64))
    cfg_j, cfg_t = _cfgs(max_episode_steps=12)
    store = gate_store if arm == "gated" else None
    kw = dict(n_envs=16, n_steps=30, seed=5, store_rows_hint=64)
    want = jimp.evaluate_gated(cfg_j, store, use_pallas=False, **kw)
    got = timp.evaluate_gated(cfg_t, store, use_kernel=False, device="cpu",
                              **kw)
    assert got.keys() == want.keys()
    for k in want:
        if k == "mean_step_reward":
            assert abs(got[k] - want[k]) <= 1e-9, (got[k], want[k])
        else:
            assert got[k] == want[k], k
    assert want["episodes"] == 32
    if arm == "gated":
        assert want["activation_fraction"] > 0
    else:
        assert want["activation_fraction"] == 0


class _Run(NamedTuple):
    state: object
    metrics: list


def _recorded_run(chunks=3, chunk=4):
    """A trainer's output (2 store shards, per-chunk stacked metrics) as
    numpy arrays."""
    rng = np.random.default_rng(6)

    class State(NamedTuple):
        store_keys: np.ndarray
        store_values: np.ndarray
        store_size: np.ndarray

    state = State(rng.normal(0, 9, (2, 8, 21)).astype(np.float32),
                  rng.normal(0, 1, (2, 8)).astype(np.float32),
                  np.asarray([5, 8], np.int32))
    metrics = []
    for _ in range(chunks):
        f = dict(reward_mean=rng.random(chunk).astype(np.float32),
                 loss=rng.random(chunk).astype(np.float32),
                 rule_fraction=rng.random(chunk).astype(np.float32))
        for name in StepMetrics._fields:
            f.setdefault(name, rng.integers(0, 50, chunk).astype(np.int32))
        metrics.append(f)
    return _Run(state, metrics)


def _fake_trainer(run: _Run, make):
    def factory(*_args, **_kw):
        def run_factory(_chunk):
            it = iter(run.metrics)

            def run_fn(state, _key):
                return state, StepMetrics(**{k: make(v)
                                             for k, v in next(it).items()})
            return run_fn
        state = type(run.state)(*(make(a) for a in run.state))
        return (lambda seed=0: state), None, None, run_factory
    return factory


def test_train_store_merge_and_history_match_jax(monkeypatch):
    run = _recorded_run()
    monkeypatch.setattr(jimp, "make_trainer_fast",
                        _fake_trainer(run, jnp.asarray))
    monkeypatch.setattr(timp, "make_trainer_fast",
                        _fake_trainer(run, torch.as_tensor))
    cfg_j, cfg_t = _cfgs()
    kw = dict(batch_per_device=4, steps=12, chunk=4)
    store_j, hist_j = jimp.train_store(cfg_j, use_pallas=False, **kw)
    store_t, hist_t = timp.train_store(cfg_t, device="cpu", **kw)
    assert store_t.keys() == store_j.keys()
    for k in ("keys", "values", "valid"):
        assert store_t[k].dtype == store_j[k].dtype, k
        np.testing.assert_array_equal(store_t[k], store_j[k], k)
    assert store_t["rows"] == store_j["rows"] == 13
    assert hist_t == hist_j
    assert set(hist_t) == set(StepMetrics._fields) | {"step"}


@pytest.fixture(scope="module")
def report():
    # tests/test_improvement.py's scale and seed: doubled box
    # half-widths and low visit thresholds, 48 envs x 250 steps
    wide = tuple(min(w * 2, 50.0) for w in DRIVING_HALF_WIDTHS[:-1]) + (0.1,)
    cfg = timp.demo_config(visited_times_thres=4, rl_visited_times_min=2,
                           half_widths=wide)
    return timp.run_improvement(
        cfg, batch_per_device=48, train_steps=250, chunk=50,
        store_capacity_per_device=1 << 14, eval_envs=48, eval_steps=250,
        seed=0, use_kernel=False, device="cpu")


def test_store_grows_and_gate_flips(report):
    assert report["train"]["store_rows"] > 1000
    assert report["train"]["final_rule_fraction"] < 0.95


def test_ztest_activates_candidates(report):
    assert report["eval_rule"]["activation_fraction"] == 0.0
    assert report["eval_gated"]["activation_fraction"] > 0.02


def test_gated_fleet_beats_rule_fleet(report):
    imp = report["improvement"]
    assert imp["reward_rate_ratio"] > 1.0, imp
    assert imp["collision_delta_per_kstep"] <= 0.0
    assert report["eval_gated"]["pass_rate"] >= \
        report["eval_rule"]["pass_rate"] - 1e-9
    # the report keeps the JAX package's keys
    assert set(report) == {"config", "train", "eval_rule", "eval_gated",
                           "improvement"}


def test_improvement_suite_calls_match_jax(monkeypatch, tmp_path):
    """The suite at a tiny scale: its arms call the closed loop with the
    JAX suite's configs and arguments, and its report and summary keep
    the JAX suite's keys.  The JAX suite runs with its closed-loop calls
    answered by the port's reports, so no JAX trainer is built."""
    calls = {"port": [], "jax": []}
    reports = []

    def spy(name, fn):
        def run(*args, **kw):
            calls["port"].append((name, args, kw))
            reports.append(fn(*args, **kw))
            return reports[-1]
        return run

    def stub(name, replies):
        def run(*args, **kw):
            calls["jax"].append((name, args, kw))
            return next(replies)
        return run

    names = ("run_improvement", "run_two_session_improvement")
    for name in names:
        monkeypatch.setattr(timp, name, spy(name, getattr(timp, name)))
    kw = dict(batch_per_device=16, train_steps=20, chunk=10,
              store_capacity_per_device=1 << 10, eval_envs=16,
              eval_steps=20, seed=3)
    got = timp.run_improvement_suite(str(tmp_path / "port"), use_kernel=False,
                                     device="cpu", **kw)
    replies = iter(reports)
    for name in names:
        monkeypatch.setattr(jimp, name, stub(name, replies))
    want = jimp.run_improvement_suite(str(tmp_path / "jax"), use_pallas=False,
                                      **kw)

    assert got.keys() == want.keys()
    assert got["summary"] == want["summary"]
    assert [c[0] for c in calls["port"]] == [c[0] for c in calls["jax"]]
    assert len(calls["port"]) == 6
    for (name, t_args, t_kw), (_, j_args, j_kw) in zip(calls["port"],
                                                      calls["jax"]):
        if name == "run_improvement":
            assert dataclasses.asdict(t_args[0]) \
                == dataclasses.asdict(j_args[0])
        else:
            assert t_args[0] == str(tmp_path / "port" / "two_session")
            assert j_args[0] == str(tmp_path / "jax" / "two_session")
        t_kw = dict(t_kw)
        assert t_kw.pop("device") == "cpu"
        t_kw["use_pallas"] = t_kw.pop("use_kernel")
        assert t_kw == j_kw, name
    for arm in ("main", "reference_default", "negative_control",
                "pass_limited", "pass_limited_episode"):
        assert set(got[arm]) == {"config", "train", "eval_rule",
                                 "eval_gated", "improvement"}, arm
    # the two-session arm runs at 64 envs and a 2^14-row store (the
    # suite's floors); session B imports the newest rows of A's history
    two = got["two_session"]
    assert two["evidence_transferred"]
    assert two["session_b_imported"]["info"]["imported_rows"] \
        == min(two["session_a"]["info"]["history_rows"], 1 << 14) > 0


def test_entry_points_refuse_a_quiet_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, cfg = _cfgs()
    with pytest.raises(RuntimeError, match="device='cpu'"):
        timp.evaluate_gated(cfg, None, n_envs=2, n_steps=1)
    with pytest.raises(ValueError, match="mesh has 1 rank"):
        timp.train_store(cfg, n_devices=2, device="cpu")
