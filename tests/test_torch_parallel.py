"""PyTorch port: ``parallel/`` against the JAX package on two ranks.

The JAX side runs on two of the eight virtual CPU devices of
``tests/conftest.py``; the port's side on two gloo ranks started by
``parallel.launch.run_ranks`` (``tests/torch_rank_programs.py``), whose
results come back to this process.  One spawn serves every test here.
Mirrors ``tests/test_parallel.py``: the sharded store (per-shard arrays
bit-equal to JAX's, counts exact, sums within rtol 1e-10 in f64),
striped inserts accumulating, data-parallel Adam (f32 parameters after
3 steps within rtol 1e-6 of JAX's ``make_data_parallel_update``),
``rms_update_distributed`` and the ``VecNormalize`` semantics."""

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)
from jax import shard_map
from jax.sharding import PartitionSpec as P

from dcarl_tpu.parallel import distributed as JD
from dcarl_tpu.parallel import mesh as JM
from dcarl_tpu.parallel import normalize as JN
from dcarl_tpu.parallel import sharded_store as JS
from dcarl_tpu_torch.parallel import normalize as TN
from dcarl_tpu_torch.parallel.launch import run_ranks

import torch_rank_programs as RP

S = 2


def _inputs():
    rng = np.random.default_rng(0)
    n, d = 100, 6
    store = dict(
        keys=rng.normal(0, 3, (n, d)), actions=rng.integers(0, 8, n) * 1.0,
        values=rng.normal(0, 1, n), mask=rng.random(n) < 0.9,
        w=np.abs(rng.normal(1.5, 0.5, d)) + 0.3,
        queries=rng.normal(0, 3, (32, d)))
    rng = np.random.default_rng(1)
    return dict(
        store=store,
        w0=rng.normal(0, 0.1, (8, 4)).astype(np.float32),
        x=rng.normal(0, 1, (S * 16, 8)).astype(np.float32),
        y=rng.normal(0, 1, (S * 16, 4)).astype(np.float32),
        rms=np.random.default_rng(2).normal(3, 2, (S * 32, 5)).astype(
            np.float32))


@pytest.fixture(scope="module")
def ranks():
    p = _inputs()
    return p, run_ranks(RP.parallel_checks, S, "gloo", "cpu", timeout_s=60,
                        args=(p,))


def _mesh():
    return JM.make_mesh("env", jax.devices()[:S])


def test_collectives_and_the_sharded_store_match_jax(ranks):
    p, outs = ranks
    # the collectives, against what lax computes
    for r, o in enumerate(outs):
        assert o["rank"] == r and o["size"] == S
        want = np.concatenate([np.arange(6.0).reshape(3, 2) + 10 * k
                               for k in range(S)])
        np.testing.assert_array_equal(o["all_gather"], want)
        total = np.arange(4.0) * sum(k + 1 for k in range(S))
        np.testing.assert_array_equal(o["reduce_scatter"],
                                      total[2 * r:2 * r + 2])
        np.testing.assert_array_equal(o["pmean"], [1.5])
        np.testing.assert_array_equal(o["replicated"], [7.0])
        assert o["odd_scatter_raised"]
    # the sharded store against JAX's on two devices, f64
    st = p["store"]
    mesh = _mesh()
    js = JS.sharded_store_init(mesh, "env", 256, 6, dtype=jnp.float64)
    js = JS.sharded_insert(js, mesh, "env", jnp.asarray(st["keys"]),
                           jnp.asarray(st["actions"]),
                           jnp.asarray(st["values"]), jnp.asarray(st["mask"]))
    jq = JS.sharded_query_stats(js, mesh, "env", jnp.asarray(st["queries"]),
                                jnp.asarray(st["w"]))
    for r, o in enumerate(outs):
        for name in ("keys", "actions", "values", "size", "head"):
            np.testing.assert_array_equal(
                o["local"][name], np.asarray(getattr(js, name))[r], name)
        np.testing.assert_array_equal(o["stats"]["count"],
                                      np.asarray(jq.count))
        for name in ("mean", "var"):
            np.testing.assert_allclose(o["stats"][name],
                                       np.asarray(getattr(jq, name)),
                                       rtol=1e-10, atol=0, err_msg=name)
    assert int(np.sum([np.asarray(js.size)])) == int(st["mask"].sum())


def test_sharded_insert_accumulates(ranks):
    _, outs = ranks
    assert [o["accumulated_rows"] for o in outs] == [20] * S


def test_data_parallel_update_matches_jax(ranks):
    p, outs = ranks
    mesh = _mesh()
    tx = optax.adam(1e-2)

    def loss_fn(prm, batch):
        x, y = batch
        return jnp.mean((x @ prm["w"] - y) ** 2)

    step = JD.make_data_parallel_update(loss_fn, tx, mesh, "env")
    params = {"w": jnp.asarray(p["w0"])}
    opt = tx.init(params)
    losses = []
    batch = (JM.shard_leading(jnp.asarray(p["x"]), mesh),
             JM.shard_leading(jnp.asarray(p["y"]), mesh))
    for _ in range(3):
        params, opt, loss = step(params, opt, batch)
        losses.append(float(loss))
    for o in outs:
        np.testing.assert_allclose(o["w"], np.asarray(params["w"]),
                                   rtol=1e-6, atol=0)
        np.testing.assert_allclose(o["losses"], losses, rtol=1e-6)
        np.testing.assert_allclose(
            o["w_norm"], float(JD.tree_replicated_norm(params)), rtol=1e-6)
    # every rank applied the same step to the same bits
    assert all(np.array_equal(o["w"], outs[0]["w"]) for o in outs)


def test_rms_distributed_matches_jax(ranks):
    p, outs = ranks
    mesh = _mesh()
    rms0 = JN.rms_init((5,))
    f = shard_map(lambda b: JN.rms_update_distributed(rms0, b, "env"),
                  mesh=mesh, in_specs=P("env"), out_specs=P(),
                  check_vma=False)
    got_j = f(JM.shard_leading(jnp.asarray(p["rms"]), mesh))
    ref = JN.rms_update(rms0, jnp.asarray(p["rms"]))
    for o in outs:
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(o["rms"][name],
                                       np.asarray(getattr(got_j, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
            np.testing.assert_allclose(o["rms"][name],
                                       np.asarray(getattr(ref, name)),
                                       rtol=1e-4, atol=1e-5, err_msg=name)


def test_vec_normalize_semantics():
    obs = np.full((4, 3), 2.0, np.float32)
    rew = np.asarray([1.0, -1.0, 0.5, 0.0], np.float32)
    done = np.asarray([False, True, False, False])
    st_t = TN.vec_normalize_update(
        TN.vec_normalize_init((3,), batch=4, device="cpu"), torch.as_tensor(obs),
        torch.as_tensor(rew), torch.as_tensor(done), gamma=0.9)
    st_j = JN.vec_normalize_update(
        JN.vec_normalize_init((3,), batch=4), jnp.asarray(obs),
        jnp.asarray(rew), jnp.asarray(done), gamma=0.9)
    assert float(st_t.returns[1]) == 0.0           # reset where done
    assert float(st_t.returns[0]) == pytest.approx(1.0)
    np.testing.assert_allclose(st_t.returns.numpy(), np.asarray(st_j.returns),
                               rtol=1e-6)
    for rms_t, rms_j in ((st_t.obs_rms, st_j.obs_rms),
                         (st_t.ret_rms, st_j.ret_rms)):
        for name in ("mean", "var", "count"):
            np.testing.assert_allclose(getattr(rms_t, name).numpy(),
                                       np.asarray(getattr(rms_j, name)),
                                       rtol=1e-5, err_msg=name)
    n_t = TN.normalize_obs(st_t, torch.as_tensor(obs))
    np.testing.assert_allclose(n_t.numpy(),
                               np.asarray(JN.normalize_obs(st_j, obs)),
                               rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        TN.normalize_reward(st_t, torch.as_tensor(rew)).numpy(),
        np.asarray(JN.normalize_reward(st_j, rew)), rtol=1e-5, atol=1e-6)
    assert torch.isfinite(n_t).all()
