"""PyTorch port: store oracle, RLS gate and per-action query against the
JAX package on the same numpy inputs.

The JAX per-action kernel runs in Pallas interpret mode with small tiles
(as ``tests/test_store_rls.py`` runs it); the port runs its prepare step
and the kernel's plain version on the CPU.  Counts must be exact; sums
are held to the tolerance the JAX package's on-chip parity check uses
(``bench.py:232``, rtol 1e-4 / atol 1e-3)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcarl_tpu.config import DRIVING_HALF_WIDTHS, StoreConfig as JStoreConfig
from dcarl_tpu.core import rls as JR
from dcarl_tpu.core import store as JS
from dcarl_tpu.ops import pallas_store as JP
from dcarl_tpu_torch.config import StoreConfig
from dcarl_tpu_torch.core import rls as R
from dcarl_tpu_torch.core import store as S
from dcarl_tpu_torch.ops import store_kernels as K

MOMENT_TOL = dict(rtol=1e-4, atol=1e-3)


def _t(a):
    return torch.as_tensor(np.asarray(a))


def _assert_moments(got, ref):
    got, ref = np.asarray(got), np.asarray(ref)
    assert got.shape == ref.shape
    np.testing.assert_array_equal(got[..., 0], ref[..., 0])  # counts exact
    np.testing.assert_allclose(got[..., 1:], ref[..., 1:], **MOMENT_TOL)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_raw_moments_matches_jax(dtype):
    rng = np.random.default_rng(0)
    n, q, d = 400, 64, 21
    keys = rng.normal(0, 3, (n, d)).astype(dtype)
    keys[:, -1] = rng.integers(0, 8, n)
    values = rng.normal(0, 1, n).astype(dtype)
    valid = rng.random(n) < 0.8
    queries = keys[rng.integers(0, n, q)] + rng.normal(0, 1, (q, d))
    queries[:, -1] = rng.integers(0, 8, q)
    queries = queries.astype(dtype)
    w = (np.abs(rng.normal(2, 1, d)) + 1.0).astype(dtype)
    w[-1] = 0.1

    ref = np.asarray(JS._raw_moments(jnp.asarray(keys), jnp.asarray(values),
                                     jnp.asarray(valid), jnp.asarray(queries),
                                     jnp.asarray(w)))
    got = S._raw_moments(_t(keys), _t(values), _t(valid), _t(queries), _t(w))
    assert got.dtype == torch.float32
    assert ref[:, 0].sum() > 0
    np.testing.assert_array_equal(got.numpy()[:, 0], ref[:, 0])
    np.testing.assert_allclose(got.numpy(), ref, rtol=1e-6, atol=1e-6)


def test_moments_to_stats_matches_jax():
    rng = np.random.default_rng(1)
    q = 200
    count = rng.integers(0, 20, q).astype(np.float64)
    count[:20] = 0  # empty matches -> -1 sentinels
    v = rng.normal(0.2, 0.5, (q, 20))
    s = np.where(np.arange(20) < count[:, None], v, 0.0).sum(1)
    ss = np.where(np.arange(20) < count[:, None], v * v, 0.0).sum(1)
    m = np.stack([count, s, ss], 1)

    ref = JS.moments_to_stats(jnp.asarray(m))
    got = S.moments_to_stats(_t(m))
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    for name in ("mean", "var", "sigma"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-6, atol=0)
    assert (got.mean.numpy()[:20] == -1).all()
    assert (got.sigma.numpy()[:20] == -1).all()


def test_candidate_keys_matches_jax():
    obs = np.random.default_rng(2).normal(0, 1, (3, 4, 20))
    ref = np.asarray(JR.candidate_keys(jnp.asarray(obs), 11))
    got = R.candidate_keys(_t(obs), 11).numpy()
    np.testing.assert_array_equal(got, ref)


def _random_action_stats(rng, b, a):
    """Per-(env, action) stats with every gate branch represented:
    under-explored rule, thin candidates, near-optimal rule, empty
    (-1 sentinel) actions and clear winners."""
    count = rng.integers(0, 60, (b, a)).astype(np.float64)
    count[rng.random((b, a)) < 0.15] = 0
    mean = rng.normal(0.0, 0.4, (b, a))
    var = rng.uniform(0.0, 0.2, (b, a))
    empty = count == 0
    mean[empty] = -1.0
    var[empty] = -1.0
    sigma = np.where(empty, -1.0, np.sqrt(np.abs(var)))
    return count, mean, var, sigma


@pytest.mark.parametrize("select_mode", ["first", "best"])
def test_act_test_matches_jax(select_mode):
    rng = np.random.default_rng(3)
    b, a = 512, 11
    count, mean, var, sigma = _random_action_stats(rng, b, a)
    # the hand-built cases of tests/test_store_rls.py's Welch test
    count[0, :8] = [40, 2, 10, 30, 10, 10, 10, 10]
    mean[0, :8] = [-0.5, 5.0, -0.6, 0.4, -0.55, -0.5, -0.5, -0.5]
    count[1, :8] = [40, 10, 10, 10, 10, 10, 10, 10]
    mean[1, :8] = [-0.5, -0.5, 1.0, 2.0, -0.5, -0.5, -0.5, -0.5]
    var[:2], sigma[:2] = 0.1, np.sqrt(0.1)
    # empty store: every action at the sentinel
    count[2], mean[2], var[2], sigma[2] = 0, -1.0, -1.0, -1.0
    jcfg = JStoreConfig(visited_times_thres=10, rule_good_thres=0.1,
                        select_mode=select_mode)
    cfg = StoreConfig(visited_times_thres=10, rule_good_thres=0.1,
                      select_mode=select_mode)

    ref = np.asarray(JR.act_test(JR.ActionStats(
        jnp.asarray(count.astype(np.int32)), jnp.asarray(mean),
        jnp.asarray(var), jnp.asarray(sigma)), jcfg))
    got = R.act_test(R.ActionStats(_t(count.astype(np.int32)), _t(mean),
                                   _t(var), _t(sigma)), cfg)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert got[2] == 0
    assert (ref > 0).sum() > 20 and (ref == 0).sum() > 20
    if select_mode == "first":
        assert got[0] == 3 and got[1] == 2


def _store_708(off_lattice: bool):
    """The inputs of tests/test_store_rls.py:708 (optionally with 100
    off-lattice action rows)."""
    rng = np.random.default_rng(31)
    d, A, B = 21, 11, 48
    n = 2000
    obs = np.asarray(rng.normal(0, 5, (B, d - 1)), np.float32)
    src = rng.integers(0, B, n)
    keys = np.zeros((n, d), np.float32)
    keys[:, :-1] = obs[src] + rng.normal(0, 1.0, (n, d - 1))
    keys[:, -1] = rng.integers(0, A, n)
    values = np.asarray(rng.normal(0, 1, n), np.float32)
    valid = rng.random(n) < 0.7
    w = (np.abs(rng.normal(2, 1, d)) + 1.5).astype(np.float32)
    w[-1] = 0.1
    if off_lattice:
        keys[:100, -1] = A + 3
    return keys, values, valid, obs, w


def _store_896():
    """The inputs of tests/test_store_rls.py:896: 40 unique keys, each
    repeated 50x with different values, and a stale invalid tail."""
    rng = np.random.default_rng(31)
    uniq, reps, d, A = 40, 50, 21, 11
    base = rng.normal(0, 5, (uniq, d)).astype(np.float32)
    base[:, -1] = rng.integers(0, A, uniq)
    keys = np.repeat(base, reps, axis=0)[rng.permutation(uniq * reps)]
    vals = rng.normal(0, 1, uniq * reps).astype(np.float32)
    n = uniq * reps + 37
    keys = np.concatenate([keys, rng.normal(0, 5, (37, d)).astype(np.float32)])
    vals = np.concatenate([vals, np.ones(37, np.float32)])
    valid = np.arange(n) < uniq * reps
    q = base[rng.integers(0, uniq, 16), :-1] + rng.normal(
        0, 0.2, (16, d - 1)).astype(np.float32)
    return keys, vals, valid, q, np.asarray(DRIVING_HALF_WIDTHS, np.float32)


STORES = {
    "store708": lambda: _store_708(False),
    "store708_off_lattice": lambda: _store_708(True),
    "store896_dedup": _store_896,
}


@pytest.mark.parametrize("store", sorted(STORES))
def test_peraction_query_matches_jax_kernel(store):
    keys, values, valid, obs, w = STORES[store]()
    ref = np.asarray(JP.box_query_moments_peraction(
        jnp.asarray(keys), jnp.asarray(values), jnp.asarray(valid),
        jnp.asarray(obs), jnp.asarray(w), num_actions=11, q_tile=32,
        n_tile=256, interpret=True))
    assert ref[..., 0].sum() > 0
    got = K.box_query_moments_peraction(_t(keys), _t(values), _t(valid),
                                        _t(obs), _t(w), num_actions=11,
                                        n_tile=256)
    _assert_moments(got.numpy(), ref)
    # and the brute oracle over the [B, A] candidate keys agrees
    qg = R.candidate_keys(_t(obs), 11).reshape(-1, keys.shape[1])
    brute = S._raw_moments(_t(keys), _t(values), _t(valid), qg, _t(w))
    _assert_moments(got.numpy(), brute.numpy().reshape(got.shape))


@pytest.mark.parametrize("store", sorted(STORES))
def test_prepared_store_matches_jax(store):
    keys, values, valid, _, w = STORES[store]()
    n = keys.shape[0]
    jp = JP.prepare_peraction_store(jnp.asarray(keys), jnp.asarray(values),
                                    jnp.asarray(valid), jnp.asarray(w),
                                    num_actions=11, n_tile=256)
    tp = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                   num_actions=11, n_tile=256)
    for name in ("kb", "kb2", "kbt"):
        np.testing.assert_array_equal(getattr(tp, name).numpy(),
                                      np.asarray(getattr(jp, name)), name)
    assert int(tp.sdim2) == int(jp.sdim2)
    assert float(tp.cell_w) == float(jp.cell_w)
    assert float(tp.w0[0]) == float(jp.w0[0])
    assert float(tp.w2[0]) == float(jp.w2[0])
    # JAX's rows_cat = [obs keys; feature block; bf16-prefilter key norms].
    # The port keeps the keys and compact per-row (action, moments), from
    # which feature_block() rebuilds the feature operand.
    j_rows = np.asarray(jp.rows_cat)
    n_unique = int(j_rows[20:-1].any(axis=0).sum())
    assert n_unique > 0
    np.testing.assert_array_equal(tp.keys_t.numpy(), j_rows[:20])
    np.testing.assert_allclose(K.feature_block(tp).numpy(), j_rows[20:-1],
                               rtol=1e-6, atol=0)
    assert int((tp.row_act >= 0).sum()) == n_unique
    assert (tp.keys_t[:, n:] == K._PAD).all()
    assert (tp.row_act[n:] == -1).all() and (tp.row_mom[:, n:] == 0).all()


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_kernel_prune_keeps_every_contained_pair(seed):
    """Every truly contained (query, row) pair lies in a (query tile,
    row sub-slice) pair that the kernel's band / second-dim rectangle
    prune keeps, with the prune reading the extrema that the port's
    prepare and query code computes (the kernel itself runs only on the
    card)."""
    rng = np.random.default_rng(seed)
    n, b, d, A = 6000, 700, 21, 11
    centers = rng.normal(0, 1, (24, d - 1)) * np.r_[3.0, 40.0, [3.0] * 18]
    src = rng.integers(0, 24, n)
    keys = np.zeros((n, d), np.float32)
    keys[:, :-1] = centers[src] + rng.normal(0, 1.5, (n, d - 1))
    keys[:, -1] = rng.integers(0, A, n)
    keys[:50, -1] = 2.4  # off-lattice rows
    values = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    obs = (centers[rng.integers(0, 24, b)]
           + rng.normal(0, 1.5, (b, d - 1))).astype(np.float32)
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32) * 1.5
    w[-1] = 0.1

    prep = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                     num_actions=A, n_tile=1024)
    queries = _t(obs)
    qorder, qext = K.query_operands(prep, queries)
    keep = K.prune_keep(prep, qext)                  # [n_qtiles, n_sub]
    assert keep.shape == (-(-b // K._QT), prep.kb.shape[1])
    assert 0 < keep.float().mean() < 0.6  # the prune is doing real work

    # brute containment over the prepared rows that add to some action
    keys_t = prep.keys_t
    mask = torch.ones((b, keys_t.shape[1]), dtype=torch.bool)
    for dd in range(20):
        mask &= (queries[:, dd:dd + 1] - keys_t[dd][None]).abs() <= prep.w_col[dd]
    mask &= (prep.row_act >= 0)[None]
    q_idx, r_idx = torch.nonzero(mask, as_tuple=True)
    assert q_idx.numel() > 100
    pos = torch.empty(b, dtype=torch.long)
    pos[qorder] = torch.arange(b)
    assert keep[pos[q_idx] // K._QT, r_idx // prep.sub_n].all()

    # and the query-side extrema bound each sorted tile's queries
    qs = queries[qorder]
    for t in range(keep.shape[0]):
        blk = qs[t * K._QT:(t + 1) * K._QT]
        assert qext[0, t] == blk[:, prep.band_dim].min()
        assert qext[1, t] == blk[:, prep.band_dim].max()
        assert qext[2, t] == blk[:, int(prep.sdim2)].min()
        assert qext[3, t] == blk[:, int(prep.sdim2)].max()


def test_query_rejects_what_the_kernel_cannot_take():
    keys, values, valid, obs, w = _store_708(False)
    prep = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                     num_actions=11, n_tile=256)
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep, _t(obs).to("meta"))
    with pytest.raises(TypeError):
        K.prepare_peraction_store(_t(keys), _t(values), _t(valid).float(),
                                  _t(w))
    with pytest.raises(ValueError):
        K.prepare_peraction_store(_t(keys), _t(values[:-1]), _t(valid), _t(w))
