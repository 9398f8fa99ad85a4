"""PyTorch port: the vehicle-life working set (``dcarl_tpu/workingset.py``)
and the value collector it draws its history from.

* ``make_collector_fast`` against JAX's at ``reset_jitter=0`` (both
  fleets start and reset alike), 16 envs x 60 steps in float64, with a
  trigger line and an episode cap that lock candidates and finish
  episodes inside the horizon: integer records bit-equal, recorded
  states and returns within 1e-9.
* ``offset_vector``, ``shift_keys``, ``build_life_history`` and
  ``RegionCache.build`` equal to JAX's.
* ``run_vehicle_life`` at ``tests/test_workingset.py``'s scale with that
  file's assertions, on the brute route as there.
* A failed asynchronous re-center raises in the caller.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu import workingset as JWS
from dcarl_tpu.config import EnvConfig as JEnvConfig
from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.planning import fast_rollout as jfr
from dcarl_tpu_torch import workingset as WS
from dcarl_tpu_torch.config import EnvConfig
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.planning import fast_rollout as tfr

ENV = dict(reset_jitter=0.0, max_episode_steps=40)
B, STEPS, TRIGGER_Y = 16, 60, 105.0


def test_collector_matches_jax_f64():
    env_j = JEnvConfig(**ENV)
    init_j, run_j = jfr.make_collector_fast(j_t_intersection(env_j), env_j,
                                            dtype=jnp.float64,
                                            trigger_y=TRIGGER_Y)
    carry_j = init_j(jax.random.split(jax.random.PRNGKey(0), B))
    _, want = run_j(carry_j, jax.random.split(jax.random.PRNGKey(1), STEPS))

    env_t = EnvConfig(**ENV)
    init_t, run_t = tfr.make_collector_fast(t_intersection(env_t), env_t,
                                            dtype=torch.float64,
                                            trigger_y=TRIGGER_Y, device="cpu")
    carry = init_t(B, torch.Generator().manual_seed(0))
    _, got = run_t(carry, STEPS, torch.Generator().manual_seed(1))

    for name in ("done", "passed", "collided", "used_action", "rule_index"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    for name in ("recorded_state", "episode_return", "reward"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(want, name)), rtol=0,
                                   atol=1e-9, err_msg=name)
    # the horizon exercises what it should: locked candidates, finished
    # episodes, the round robin moving on
    assert got.done.any() and (got.recorded_state[:, 1] != 0).any()
    assert int(got.used_action.max()) >= 1


def test_offset_and_shift_match_jax():
    np.testing.assert_array_equal(WS.offset_vector(8.0),
                                  JWS.offset_vector(8.0))
    assert WS.X_DIMS == JWS.X_DIMS
    keys = np.random.default_rng(0).normal(240, 30, (64, 21)).astype(
        np.float32)
    for dx in (8.0, -3.3, 1e3):
        np.testing.assert_array_equal(WS.shift_keys(keys, dx),
                                      JWS.shift_keys(keys, dx))
    offsets = np.arange(5, dtype=np.float64) * 8.0
    values = np.arange(64, dtype=np.float32)
    for got, want in zip(WS.build_life_history(keys, values, offsets),
                         JWS.build_life_history(keys, values, offsets)):
        np.testing.assert_array_equal(got, want)


def test_region_cache_build_matches_jax():
    rng = np.random.default_rng(1)
    hk = rng.normal(0, 30, (3000, 21)).astype(np.float32)
    hv = rng.normal(0, 1, 3000).astype(np.float32)
    w = np.ones(21, np.float32)
    got = WS.RegionCache(hk, hv, w, capacity=1024).build(4.0, 10.0)
    want = JWS.RegionCache(hk, hv, w, capacity=1024).build(4.0, 10.0)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(g, x)
    assert 0 < got[3] < 1024
    with pytest.raises(ValueError, match="cache"):
        WS.RegionCache(hk, hv, w, capacity=10).build(0.0, 100.0)


def test_failed_recenter_raises_in_the_caller():
    hk = np.zeros((100, 21), np.float32)
    cache = WS.RegionCache(hk, np.zeros(100, np.float32), np.ones(21),
                           capacity=10)
    rec = WS.AsyncRecenter(cache, torch.device("cpu"))
    assert rec.request(0.0, 5.0)
    with pytest.raises(RuntimeError, match="re-center") as info:
        rec.wait()
    assert isinstance(info.value.__cause__, ValueError)
    ok = WS.AsyncRecenter(WS.RegionCache(hk, np.zeros(100, np.float32),
                                         np.ones(21), capacity=128),
                          torch.device("cpu"))
    assert ok.request(0.0, 5.0)
    (keys, vals, valid), n, center, _ = ok.wait()
    assert n == 100 and keys.shape == (128, 21) and int(valid.sum()) == 100


def test_recenter_hands_over_results_in_order_under_thread_churn():
    """Many request / ready cycles with a tiny switch interval: caches
    arrive in request order, none twice, and the last accepted request's
    cache is the one finally handed over (a newer cache may supersede an
    unread one)."""
    import sys
    import time

    hk = np.random.default_rng(2).normal(0, 30, (2000, 21)).astype(np.float32)
    rec = WS.AsyncRecenter(WS.RegionCache(hk, np.zeros(2000, np.float32),
                                          np.ones(21), capacity=2048),
                           torch.device("cpu"))
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        t_end = time.monotonic() + 60
        accepted, handed, i = [], [], 0
        while len(accepted) < 100 and time.monotonic() < t_end:
            i += 1
            if rec.request(float(i), 10.0):
                accepted.append(float(i))
            if i % 3:
                time.sleep(1e-4)
            r = rec.ready()
            if r is not None:
                handed.append(r[2])
        r = rec.wait(timeout=60)
        if r is not None:
            handed.append(r[2])
        assert time.monotonic() < t_end
    finally:
        sys.setswitchinterval(old)
    assert len(accepted) > 1 and handed
    assert handed == sorted(set(handed)) and set(handed) <= set(accepted)
    assert handed[-1] == accepted[-1]


@pytest.fixture(scope="module")
def life_report():
    # collection-stack local records at CPU scale, then the life loop of
    # tests/test_workingset.py: 12 offsets, drift 2 m a chunk, audits at
    # band-aligned offsets 24/48/72
    lk, lv = WS.collect_local_records(48, 400, seed=3, device="cpu")
    assert len(lk) > 20, "collector produced too few episode records"
    return WS.run_vehicle_life(
        n_envs=48, chunk_steps=10, n_chunks=36, n_offsets=12,
        offset_spacing=8.0, cache_capacity=1 << 12, region_radius=25.0,
        recenter_margin=6.0, drift_per_chunk=2.0, checkpoints=3,
        checkpoint_queries=48, use_kernel=False, seed=0, history=(lk, lv),
        device="cpu")


def test_life_run_recenters(life_report):
    r = life_report
    assert r["history_rows"] == 12 * r["local_rows"]
    assert r["recenters"] >= 2, r["recenters"]
    assert all(t["cache_rows"] < r["history_rows"] for t in r["timeline"])
    assert all(t["cache_rows"] <= r["cache_capacity"]
               for t in r["timeline"])


def test_life_run_exactness_audits(life_report):
    cks = life_report["checkpoints"]
    assert len(cks) == 3
    assert sum(c["matched_counts_total"] for c in cks) > 0
    for c in cks:
        assert c["counts_exact_full_vs_masked"]
        assert c["counts_exact_full_vs_cache"]
        assert c["f64_oracle_bitwise_full_vs_region"]
        assert c["max_rel_moment_diff_cache_vs_full"] < 1e-5
        assert c["device_bitwise_full_vs_masked"]


def test_life_run_serves_evidence(life_report):
    assert life_report["activation_fraction_mean"] >= 0.0
    assert life_report["sustained_env_steps_per_s"] > 0
    assert set(life_report) == {
        "history_rows", "local_rows", "n_offsets", "offset_spacing",
        "route_length_m", "cache_capacity", "region_radius", "n_envs",
        "chunk_steps", "n_chunks", "env_steps_total", "wall_seconds",
        "checkpoint_seconds", "sustained_env_steps_per_s", "recenters",
        "recenter_prep_seconds_total", "activation_fraction_mean",
        "checkpoints", "timeline"}
