"""PyTorch port: the sharded lane-major drivers against the JAX package.

The port runs on two gloo ranks (``parallel.launch.run_ranks``,
``tests/torch_rank_programs.py``), one spawn for every test here; the
JAX side on two of the virtual CPU devices of ``tests/conftest.py``.
Mirrors ``tests/test_sharded_driver.py``:

* the sharded rule driver equals the unsharded one, bit for bit;
* the sharded gated driver (f64, the brute route) equals JAX's
  ``make_gated_driver_sharded`` on two devices from JAX's zero-jitter
  and jittered starts (taken across with ``interop``, so envs differ
  across the shards in the second): integer outputs bit-equal, rewards
  within the f64 tolerance of the one-device drivers' test (atol 1e-9),
  and one tick's all-gathered, reduce-scattered moments within rtol
  1e-10 of JAX's ``all_gather`` / ``psum_scatter``.  The horizons end
  before any env finishes, so the auto-reset draws of the two packages'
  generators never enter;
* the kernel route (its plain version here) equals the brute route,
  both sharded."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dcarl_tpu.config import EnvConfig, driving_store_config
from dcarl_tpu.core.rls import candidate_keys
from dcarl_tpu.core.store import _raw_moments
from dcarl_tpu.env import driving_env as jde
from dcarl_tpu.env.scenario import t_intersection
from dcarl_tpu.parallel.mesh import make_mesh
from dcarl_tpu.planning import fast_rollout as JFR
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.config import EnvConfig as TEnvConfig
from dcarl_tpu_torch.env.scenario import t_intersection as t_t_intersection
from dcarl_tpu_torch.parallel.launch import run_ranks
from dcarl_tpu_torch.planning import fast_rollout as TFR

import torch_rank_programs as RP

S = 2
NAMES = ("reward", "done", "passed", "collided", "executed", "gated")


def _seed_store(obs, rows, batch, rng):
    """Evidence at each env's initial state (``test_sharded_driver.py``):
    rule action 0 mediocre, action 3 strong with tight variance."""
    keys = np.zeros((rows, 21), np.float32)
    per = rows // batch
    for i in range(batch):
        blk = keys[i * per:(i + 1) * per]
        blk[:, :-1] = obs[:, i][None, :] + rng.normal(0, 0.05, (per, 20))
        blk[:, -1] = np.where(np.arange(per) % 2 == 0, 0.0, 3.0)
    vals = np.where(keys[:, -1] == 0, 0.05, 3.0).astype(np.float32)
    vals += rng.normal(0, 0.01, rows).astype(np.float32)
    return keys, vals


def _jax_case(jitter, seeds, steps, mesh):
    cfg = EnvConfig(reset_jitter=jitter)
    scfg = driving_store_config(visited_times_thres=5, rl_visited_times_min=3)
    sc = t_intersection(cfg)
    batch, rows = 16, 64
    init_s, run_s = JFR.make_gated_driver_sharded(
        sc, mesh, "env", cfg, store_cfg=scfg, dtype=jnp.float64,
        use_pallas=False)
    carry = init_s(jax.random.split(jax.random.PRNGKey(seeds[0]), batch))
    idx = jde.in_state_indices(sc)
    obs = np.asarray(JFR._obs_ori_soa(carry, idx))           # [20, B]
    keys, vals = _seed_store(obs, rows, batch, np.random.default_rng(3))
    valid = np.ones(rows, bool)
    _, out = run_s(carry, jax.random.split(jax.random.PRNGKey(seeds[1]),
                                           steps),
                   jnp.asarray(keys), jnp.asarray(vals), jnp.asarray(valid))
    out = [np.asarray(o) for o in out]
    assert (out[5] != 0).any(), "the store must trigger activations"
    assert not out[1].any(), "no env may finish inside the horizon"

    # one tick's moments: all-gather, local rows, psum_scatter
    hw = jnp.asarray(scfg.half_widths, jnp.float64)

    def tick(k, v, m, o):
        q = jax.lax.all_gather(o, "env", axis=0, tiled=True)
        flat = candidate_keys(q, 11).reshape(-1, 21)
        part = _raw_moments(k, v, m, flat, hw)
        return jax.lax.psum_scatter(part, "env", scatter_dimension=0,
                                    tiled=True)

    f = shard_map(tick, mesh=mesh, in_specs=(P("env"),) * 4,
                  out_specs=P("env"), check_vma=False)
    moments = np.asarray(f(jnp.asarray(keys, jnp.float64),
                           jnp.asarray(vals, jnp.float64),
                           jnp.asarray(valid), jnp.asarray(obs.T)))
    payload = dict(jitter=jitter, steps=steps, keys=keys, values=vals,
                   valid=valid, in_state=idx,
                   carry=interop.fast_env_state_from_numpy(
                       carry, torch.device("cpu"), torch.float64))
    return payload, out, moments


@pytest.fixture(scope="module")
def runs():
    mesh = make_mesh("env", jax.devices()[:S])
    cases, ref = {}, {}
    for name, jitter, seeds, steps in (("exact", 0.0, (0, 1), 10),
                                       ("jittered", 0.3, (2, 3), 8)):
        cases[name], out, moments = _jax_case(jitter, seeds, steps, mesh)
        ref[name] = (out, moments)
    outs = run_ranks(RP.driver_checks, S, "gloo", "cpu", timeout_s=90,
                     args=(cases,))
    return ref, outs


def _joined(outs, key):
    """The ranks' [T, B_local] outputs side by side: [T, B]."""
    return [np.concatenate([o[key][i] for o in outs], axis=1)
            for i in range(len(NAMES))]


def _assert_same(got, ref, reward_tol):
    for name, g, r in zip(NAMES, got, ref):
        if name == "reward":
            np.testing.assert_allclose(g, r, err_msg=name, **reward_tol)
        else:
            np.testing.assert_array_equal(g, r, err_msg=name)


def test_sharded_rule_driver_matches_unsharded(runs):
    _, outs = runs
    tcfg = TEnvConfig(reset_jitter=0.0)
    init_r, run_r = TFR.make_rule_driver_fast(t_t_intersection(tcfg), tcfg,
                                              device="cpu")
    carry = init_r(16, torch.Generator().manual_seed(0))
    _, ref = run_r(carry, 12, torch.Generator().manual_seed(1))
    got = [np.concatenate([o["rule"][i] for o in outs], axis=1)
           for i in range(4)]
    for name, g, r in zip(NAMES, got, ref):
        np.testing.assert_array_equal(g, r.numpy(), err_msg=name)


@pytest.mark.parametrize("case", ["exact", "jittered"])
def test_sharded_gated_driver_matches_jax(runs, case):
    ref, outs = runs
    out_j, moments_j = ref[case]
    _assert_same(_joined(outs, case), out_j, dict(rtol=0, atol=1e-9))
    got = np.concatenate([o[case + "_moments"] for o in outs])
    np.testing.assert_array_equal(got[:, 0], moments_j[:, 0])
    np.testing.assert_allclose(got, moments_j, rtol=1e-10, atol=0)
    assert got[:, 0].sum() > 0


def test_sharded_kernel_route_matches_brute_route(runs):
    _, outs = runs
    for case in ("exact", "jittered"):
        _assert_same(_joined(outs, case + "_kernel_route"),
                     _joined(outs, case), dict(rtol=0, atol=1e-9))
