"""PyTorch port: store oracle, RLS gate and per-action query against the
JAX package on the same numpy inputs.

The JAX per-action kernel runs in Pallas interpret mode with small tiles
(as ``tests/test_store_rls.py`` runs it); the port runs its prepare step
and the kernel's plain version on the CPU.  Counts must be exact; sums
are held to the tolerance the JAX package's on-chip parity check uses
(``bench.py:232``, rtol 1e-4 / atol 1e-3)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

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
    return torch.as_tensor(np.array(a))


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


def _f64_run_block(tp, keys, values, valid):
    """The feature block an exact prepare gives: for every live prepared
    row, (count, sum v, sum v^2) of the valid store rows with its keys
    (integral actions), summed in f64 and rounded once to f32."""
    runs = {}
    for k, v in zip(keys[valid], values[valid].astype(np.float64)):
        c = runs.setdefault(k.tobytes(), [0.0, 0.0, 0.0])
        c[0] += 1.0
        c[1] += v
        c[2] += v * v
    keys_t, act = tp.keys_t.numpy(), tp.row_act.numpy()
    block = np.zeros((3 * tp.num_actions, keys_t.shape[1]), np.float32)
    for r in np.flatnonzero(act >= 0):
        key = np.append(keys_t[:, r], np.float32(act[r])).astype(np.float32)
        block[3 * act[r]:3 * act[r] + 3, r] = runs[key.tobytes()]
    return block


def test_prepare_dedup_sums_round_once_from_f64():
    """Runs of 400 identical rows whose values span five decades: an f32
    running sum drifts from the exact one, the prepare's f64 sums do not,
    whatever order index_add_ adds them in."""
    rng = np.random.default_rng(7)
    uniq, reps, d = 24, 400, 21
    base = rng.normal(0, 5, (uniq, d)).astype(np.float32)
    base[:, -1] = rng.integers(0, 11, uniq)
    keys = np.repeat(base, reps, axis=0)
    values = (rng.normal(0, 1, len(keys))
              * 10.0 ** rng.integers(-2, 3, len(keys))).astype(np.float32)
    perm = rng.permutation(len(keys))
    keys, values = keys[perm], values[perm]
    valid = rng.random(len(keys)) < 0.9
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32)
    tp = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                   num_actions=11, n_tile=256)
    exact = _f64_run_block(tp, keys, values, valid)
    np.testing.assert_array_equal(K.feature_block(tp).numpy(), exact)
    # the f32 running sums the prepare used to take differ in the last
    # places: the check above can tell the two apart
    f32 = {}
    for k, v in zip(keys[valid], values[valid]):
        f32[k.tobytes()] = f32.get(k.tobytes(), np.float32(0)) + v
    exact_sums = {}
    for k, v in zip(keys[valid], values[valid].astype(np.float64)):
        exact_sums[k.tobytes()] = exact_sums.get(k.tobytes(), 0.0) + v
    assert any(np.float32(exact_sums[k]) != f32[k] for k in f32)


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
    # which feature_block() rebuilds the feature operand.  Its run sums
    # are f64 rounded once (JAX's add in f32), so they are held to the
    # f64 oracle bit for bit and JAX's block to its counts and support.
    j_rows = np.asarray(jp.rows_cat)
    n_unique = int(j_rows[20:-1].any(axis=0).sum())
    assert n_unique > 0
    np.testing.assert_array_equal(tp.keys_t.numpy(), j_rows[:20])
    block = K.feature_block(tp).numpy()
    np.testing.assert_array_equal(block, _f64_run_block(tp, keys, values,
                                                        valid))
    np.testing.assert_array_equal(block[0::3], j_rows[20:-1][0::3])
    np.testing.assert_array_equal(block != 0, j_rows[20:-1] != 0)
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


# ---------------------------------------------------------------------------
# [Q, 3] queries: sorted-band (flat and grouped) and brute, against the
# interpret-mode Pallas kernels on the inputs of tests/test_store_rls.py
# ---------------------------------------------------------------------------


def _flat_inputs(seed, valid_p, n=700, q=40, d=21):
    """tests/test_store_rls.py:57 (seed 1, valid 0.8) and :77 (seed 2,
    valid 0.6), plus ``q`` queries next to stored rows (the random 21-D
    queries there match nothing)."""
    rng = np.random.default_rng(seed)
    keys = np.asarray(rng.normal(0, 5, (n, d)), np.float32)
    values = np.asarray(rng.normal(0, 1, n), np.float32)
    valid = rng.random(n) < valid_p
    queries = np.asarray(rng.normal(0, 5, (q, d)), np.float32)
    w = np.asarray(np.abs(rng.normal(2, 1, d)) + 0.5, np.float32)
    near = keys[rng.integers(0, n, q)] + rng.normal(0, 0.3, (q, d))
    return keys, values, valid, np.concatenate(
        [queries, near.astype(np.float32)]), w


def _grouped_inputs():
    """tests/test_store_rls.py:106: every action of 24 envs, A = 11, plus
    24 envs next to stored rows (the random ones there match nothing)."""
    rng = np.random.default_rng(5)
    d, a, qa, n = 21, 11, 24, 700
    keys = np.asarray(rng.normal(0, 5, (n, d)), np.float32)
    keys[:, -1] = rng.integers(0, a, n)
    values = np.asarray(rng.normal(0, 1, n), np.float32)
    valid = rng.random(n) < 0.6
    obs = np.asarray(rng.normal(0, 5, (qa, d - 1)), np.float32)
    w = np.asarray(np.abs(rng.normal(2, 1, d)) + 0.5, np.float32)
    w[-1] = 0.1
    near = keys[rng.integers(0, n, qa), :-1] + rng.normal(0, 0.3, (qa, d - 1))
    obs = np.concatenate([obs, near.astype(np.float32)])
    return keys, values, valid, _group(obs, a), w


def _group(obs, a):
    b, d1 = obs.shape
    return np.ascontiguousarray(np.concatenate([
        np.broadcast_to(obs[None], (a, b, d1)),
        np.broadcast_to(np.arange(a, dtype=np.float32)[:, None, None],
                        (a, b, 1))], axis=-1))


def _dense_sentinel_inputs(seed=11, waves=8):
    """tests/test_store_rls.py:499: a store written by dense blocks holds
    VALID rows whose keys are the 1e9 sentinel."""
    rng = np.random.default_rng(seed)
    d, a, qa, m, cap = 5, 4, 16, 16, 256
    store = JS.store_init(cap, d)
    for _ in range(waves):
        keys = rng.normal(0, 3, (m, d)).astype(np.float32)
        keys[:, -1] = rng.integers(0, a, m)
        vals = rng.normal(0, 1, m).astype(np.float32)
        mask = rng.random(m) < 0.5
        store = JS.store_insert_dense_block(
            store, jnp.asarray(keys), jnp.asarray(keys[:, -1]),
            jnp.asarray(vals), jnp.asarray(mask))
    valid = np.arange(cap) < int(store.size)
    obs = rng.normal(0, 3, (qa, d - 1)).astype(np.float32)
    w = np.asarray([2.0, 2.0, 2.0, 2.0, 0.1], np.float32)
    return (np.asarray(store.keys), np.asarray(store.values), valid,
            _group(obs, a), w)


@pytest.mark.parametrize("seed,valid_p", [(1, 0.8), (2, 0.6), (2, 0.0)])
def test_sorted_and_brute_queries_match_jax_kernels(seed, valid_p):
    keys, values, valid, queries, w = _flat_inputs(seed, valid_p)
    j = [jnp.asarray(a) for a in (keys, values, valid, queries, w)]
    t = [_t(a) for a in (keys, values, valid, queries, w)]
    ref_sorted = np.asarray(JP.box_query_moments_sorted(
        *j, q_tile=16, n_tile=256, interpret=True))
    ref_brute = np.asarray(JP.box_query_moments_pallas(
        *j, q_tile=16, n_tile=256, interpret=True))
    got_sorted = K.box_query_moments_sorted(*t).numpy()
    got_brute = K.box_query_moments_brute(*t).numpy()
    for got, ref in ((got_sorted, ref_sorted), (got_brute, ref_brute),
                     (got_sorted, ref_brute)):
        _assert_moments(got, ref)
    if valid_p == 0.0:  # the all-invalid store matches nothing
        assert (got_sorted == 0).all() and (got_brute == 0).all()
    else:
        assert ref_sorted[:, 0].sum() > 0


@pytest.mark.parametrize("store", ["grouped106", "dense_sentinel499"])
def test_grouped_query_matches_jax_kernel(store):
    keys, values, valid, qg, w = (_grouped_inputs() if store == "grouped106"
                                  else _dense_sentinel_inputs())
    n_tile = 256 if store == "grouped106" else 64
    ref = np.asarray(JP.box_query_moments_grouped(
        *(jnp.asarray(a) for a in (keys, values, valid, qg, w)),
        q_tile=16, n_tile=n_tile, interpret=True))
    got = K.box_query_moments_grouped(*(_t(a) for a in (keys, values, valid,
                                                        qg, w))).numpy()
    _assert_moments(got, ref)
    assert ref[1:, :, 0].sum() > 0, "needs matches in action groups >= 1"
    brute = S._raw_moments(_t(keys), _t(values), _t(valid),
                           _t(qg.reshape(-1, qg.shape[-1])), _t(w))
    _assert_moments(got, brute.numpy().reshape(got.shape))


def _contained(ops):
    """[Q, n_pad] bool: the contained (query, valid row) pairs of the
    band-ordered operands, by the kernel's f32 test."""
    mask = (ops.valid != 0)[None, :].expand(ops.q_t.shape[1], -1).clone()
    for dd in range(ops.q_t.shape[0]):
        mask &= (ops.q_t[dd][:, None] - ops.keys_t[dd][None, :]).abs() \
            <= ops.w[dd]
    return mask


def _assert_prune_keeps(ops, min_pairs, mask=None):
    """Every contained (query, valid row) pair of the band-ordered
    operands lies in a (query tile, sub-slice) pair the prune keeps."""
    if mask is None:
        mask = _contained(ops)
    q_idx, r_idx = torch.nonzero(mask, as_tuple=True)
    assert q_idx.numel() >= min_pairs
    keep = K.sorted_prune_keep(ops)
    assert keep.shape == (-(-ops.q_t.shape[1] // K._SQT),
                          ops.keys_t.shape[1] // K._SSUB_N)
    assert keep[q_idx // K._SQT, r_idx // K._SSUB_N].all()
    # and the tile extrema bound their queries' band keys
    return keep


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_sorted_prune_keeps_every_contained_pair(seed):
    rng = np.random.default_rng(seed)
    n, q, d = 6000, 700, 21
    centers = rng.normal(0, 1, (24, d)) * np.r_[3.0, 40.0, [3.0] * 19]
    keys = (centers[rng.integers(0, 24, n)]
            + rng.normal(0, 1.5, (n, d))).astype(np.float32)
    keys[:, -1] = rng.integers(0, 11, n)
    values = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32) * 1.5
    w[-1] = 0.1
    t = [_t(a) for a in (keys, values, valid)]
    # flat: the data-chosen band dim
    queries = (centers[rng.integers(0, 24, q)]
               + rng.normal(0, 1.5, (q, d))).astype(np.float32)
    queries[:, -1] = rng.integers(0, 11, q)
    ops, _ = K.sorted_query_operands(*t, _t(queries), _t(w))
    keep = _assert_prune_keeps(ops, 50)
    assert 0 < keep.float().mean() < 0.6  # the prune does real work
    # grouped: the composite (action, ego y) band key, all envs alike in
    # half the queries (the trainer's zero-jitter start)
    obs = queries[:, :-1].copy()
    obs[: q // 2] = obs[0]
    ops, _ = K.grouped_query_operands(*t, _t(_group(obs, 11)), _t(w))
    keep = _assert_prune_keeps(ops, 50)
    assert 0 < keep.float().mean() < 0.6


def _lane_like_inputs(seed, n=12000, q=4096, sentinel=True, middle=False):
    """A lane-shaped store: 20 clustered state dims at the field's
    half-widths (dim 1 the 0/1 ego lane), an integer action 0-7 in dim 20
    at w 0.1, a tenth invalid and (``sentinel``) 3 % valid rows at the
    1e9 sentinel (dense-block writes); queries are candidate keys near
    the rows.  Dim 8 spreads over 40 half-widths of 0.2: the sentinel
    rows' spread swamps every dim's, so the second band dim is the one
    whose half-width is next narrowest.  The third is then one of the
    0.3-wide dims: the ego lane, whose 0 / 1 keys lie in one bucket of
    4 w; with ``middle`` it is dim 4, at w 0.25 and spread over 48 of
    them (12 buckets), so the prepare takes the bucketed middle level."""
    rng = np.random.default_rng(seed)
    d = 21
    w = np.asarray(S.FIELD_HALF_WIDTHS, np.float32)
    w[8] = 0.2
    if middle:
        w[4] = 0.25
    centers = rng.normal(0, 1, (32, d)) * w * 6
    keys = (centers[rng.integers(0, 32, n)]
            + rng.normal(0, 1, (n, d)) * w).astype(np.float32)
    keys[:, 1] = rng.integers(0, 2, n)
    keys[:, 8] = rng.uniform(-4, 4, n)
    if middle:
        keys[:, 4] = rng.uniform(-6, 6, n)
    keys[:, -1] = rng.integers(0, 8, n)
    if sentinel:
        keys[rng.random(n) < 0.03] = S.SENTINEL_KEY
    values = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    near = np.flatnonzero(valid & (keys[:, 0] < 1e8))[rng.integers(0, 500, q)]
    queries = (keys[near] + rng.normal(0, 0.5, (q, d)) * w).astype(np.float32)
    queries[:, 1] = keys[near, 1]
    queries[:, -1] = rng.integers(0, 8, q)
    return keys, values, valid, queries, w


def _flat_key_operands(keys, values, valid, queries, w):
    """The flat key's operands made directly: rows and queries sorted by
    the most selective dim alone (``argmax(spread / w)``), tested last."""
    vf = valid.to(torch.float32)
    cnt = torch.clamp(vf.sum(), min=1.0)
    mean = (vf[:, None] * keys).sum(0) / cnt
    spread = (vf[:, None] * (keys - mean).abs()).sum(0) / cnt
    a = torch.argmax(spread / torch.clamp(w, min=1e-9))
    sk = torch.where(valid, keys[:, a], K._PAD)
    order = torch.argsort(sk, stable=True)
    prep = K._sorted_rows(keys[order], values[order], valid[order], sk[order],
                          w, w[a].reshape(1), K._dim_order(
                              keys[order], valid[order], w, (a,)), sdim=a,
                          sdim2=a, composite=torch.tensor(False),
                          comp_c=torch.tensor(0.0), copies=1,
                          **K._no_level(a))
    qorder = torch.argsort(queries[:, a], stable=True)
    return K._with_queries(prep, queries[qorder].T.contiguous(),
                           queries[qorder, a],
                           prep.w0), qorder


def _assert_operands_equal(got, want):
    for name in got._fields:
        assert torch.equal(getattr(got, name), getattr(want, name)), name


def _assert_holds_one_copy_operands(got, got_order, want, want_order,
                                    n):
    """``got``, operands of a store with the bucket column where the level
    is not taken, hold ``want`` (the operands without it) bit for bit: the
    same rows, records and dim order with the bucket column (0 in each of
    the ``n`` rows) last, the same queries in the same order in the first
    Q copies (bucket 0) and their tiles' extrema, then dead copies (bucket
    NaN) in tiles that keep nothing."""
    d, q = want.q_t.shape
    n_qt = want.qb.shape[1]
    assert got.q_t.shape == (d + 1, 2 * q)
    for name in ("vals", "valid", "kb", "w0"):
        assert torch.equal(getattr(got, name), getattr(want, name)), name
    assert torch.equal(got.keys_t[:d], want.keys_t)
    assert torch.equal(got.w[:d], want.w) and float(got.w[d]) == 0.25
    assert torch.equal(got.perm[:d], want.perm) and int(got.perm[d]) == d
    assert torch.equal(got.rows[:, :d], want.rows[:, :d])
    assert torch.equal(got.rows, K._band_rows(got.keys_t, got.vals,
                                              got.valid, got.perm))
    assert not got.keys_t[d, :n].any() and not got.q_t[d, :q].any()
    assert (got.keys_t[d, n:] == K._PAD).all()
    assert torch.equal(got.q_t[:d, :q], want.q_t)
    assert torch.equal(got_order[:q], want_order)
    assert torch.isnan(got.q_t[d, q:]).all()
    assert torch.equal(got.qb[:, :n_qt], want.qb)
    dead = got.qb[:, -(-q // K._SQT):]
    assert (dead[0] == torch.inf).all() and (dead[1] == -torch.inf).all()


def _walked(ops):
    """(query, valid row) pairs the kernel walks on the operands: each
    tile's query slots times the valid rows of its window."""
    plan = K.sorted_plan(ops)
    rows = (ops.valid != 0).reshape(-1, K._SSUB_N).sum(1).cumsum(0)
    rows = torch.cat([rows.new_zeros(1), rows])
    n_q = ops.q_t.shape[1]
    slots = torch.clamp(n_q - torch.arange(plan.s_lo.shape[0]) * K._SQT,
                        max=K._SQT)
    return int(((rows[plan.s_hi.long()] - rows[plan.s_lo.long()])
                * slots).sum())


@pytest.mark.parametrize("case", ["near", "outside_span", "off_lattice",
                                  "sentinel_queries", "bucket_edge",
                                  "straddle", "below_b", "above_b",
                                  "nan_queries", "one_bucket", "walked"])
@pytest.mark.parametrize("seed", [0, 1])
def test_composite_prune_keeps_every_contained_pair(seed, case):
    """The flat route bands a lane-shaped store with valid sentinel rows
    on (action, second dim) and the bucketed middle level: every
    contained (query copy, row) pair stays in a kept (tile, sub-slice)
    pair and the copies' summed counts equal the brute ``_raw_moments``
    (each pair counted once), for queries near the rows, with the second
    dim outside the rows' span, with non-integer and x.5 actions, at the
    sentinel; with rows on bucket edges and queries a half-width either
    side of them, boxes straddling an edge, below and above the rows'
    span of the level's dim (both copies clamped into one bucket), NaN in
    every dim or in the level's.  The prune keeps under half of what the
    flat key's keeps.  Where no third dim spans two buckets
    (``one_bucket``), the operands are the composite key's bit for bit.
    On 2^16 rows, with (action, bucket) bands of several sub-slices, the
    plan walks fewer pairs than on the composite key alone (``walked``:
    the plans only)."""
    if case == "walked":
        keys, values, valid, queries, w = _lane_like_inputs(
            seed, 1 << 16, 1 << 14, middle=True)
        t = [_t(a) for a in (keys, values, valid, queries, w)]
        prep = K.prepare_sorted_store(*t[:3], t[4])
        assert bool(prep.bucketed) and int(prep.sdim3) == 4
        comp = K._prepare_band(*t[:3], t[4], prep.sdim, prep.sdim2)
        assert _walked(K.prepared_query_operands(prep, t[3])[0]) \
            < 0.9 * _walked(K.prepared_query_operands(comp, t[3])[0])
        return
    old_case = case in ("near", "outside_span", "off_lattice",
                        "sentinel_queries")
    keys, values, valid, queries, w = _lane_like_inputs(
        seed, q=4096 if old_case else 1024, middle=case != "one_bucket")
    if case == "one_bucket":
        # every dim but the band's two within one bucket of 4 w
        squeeze = np.ones(21, np.float32)
        squeeze[:20] = 0.05
        squeeze[8] = 1.0
        keys = np.where(keys < 1e8, keys * squeeze, keys)
        queries = queries * squeeze
    t = [_t(a) for a in (keys, values, valid)]
    prep = K.prepare_sorted_store(*t, _t(w))
    assert bool(prep.composite) and int(prep.sdim) == 20
    s = int(prep.sdim2)
    assert s == 8 and prep.copies == 2
    b = int(prep.sdim3)
    assert bool(prep.bucketed) == (case != "one_bucket")
    assert case == "one_bucket" or b == 4
    rng = np.random.default_rng(seed)
    q = len(queries)
    real = valid & (keys[:, 0] < 1e8)
    lo_b, h_b, n_b = float(prep.lo_b), float(prep.h_b), int(prep.n_b)
    if case == "outside_span":
        span = float(np.abs(keys[real, s]).max())
        queries[: q // 2, s] = span + 300.0 * rng.random(q // 2)
        queries[q // 2:, s] = -span - 3.0 * w[s] * rng.random(q - q // 2)
    elif case == "off_lattice":
        queries[::3, -1] += 0.05
        queries[1::3, -1] += 0.5
    elif case == "sentinel_queries":
        queries[::50] = S.SENTINEL_KEY
    elif case == "bucket_edge":
        # rows exactly on inner edges, queries exactly w_b either side
        on = np.flatnonzero(real)[:200]
        keys[on, b] = lo_b + h_b * rng.integers(1, n_b, 200)
        t = [_t(a) for a in (keys, values, valid)]
        prep = K.prepare_sorted_store(*t, _t(w))
        assert float(prep.lo_b) == lo_b and float(prep.h_b) == h_b
        queries = keys[on[rng.integers(0, 200, q)]].copy()
        queries[:, b] += np.where(rng.random(q) < 0.5, -1.0, 1.0) * w[b]
    elif case == "straddle":
        # rows within w_b / 10 of an inner edge, boxes across that edge
        edge = lo_b + h_b * np.clip(np.round((keys[:, b] - lo_b) / h_b), 1,
                                    n_b - 1)
        by = np.flatnonzero(real & (np.abs(keys[:, b] - edge) < 0.1 * w[b]))
        pick = by[rng.integers(0, len(by), q)]
        queries = keys[pick].copy()
        queries[:, b] = edge[pick] + rng.uniform(-0.9, 0.9, q) * w[b]
    elif case in ("below_b", "above_b"):
        # the rows at the ends of the span, boxes reaching past them
        k_b = np.where(real, keys[:, b], np.nan)
        ends = np.argsort(k_b)[:100] if case == "below_b" \
            else np.argsort(-np.nan_to_num(k_b, nan=-np.inf))[:100]
        queries = keys[ends[rng.integers(0, 100, q)]].copy()
        sign = -1.0 if case == "below_b" else 1.0
        queries[:, b] += sign * w[b] * rng.uniform(0, 1.5, q)
    elif case == "nan_queries":
        queries[::7] = np.nan
        queries[1::7, b] = np.nan
    queries = queries.astype(np.float32)
    ops, qorder = K.prepared_query_operands(prep, _t(queries))
    mask = _contained(ops)
    keep = _assert_prune_keeps(ops, {"outside_span": 0, "nan_queries": 20}
                               .get(case, 50), mask)
    # each contained pair counted by one copy of its query
    counts = torch.zeros(q).index_add_(0, qorder % q,
                                       mask.sum(1, dtype=torch.float32))
    raw = S._raw_moments(*t, _t(queries), _t(w))
    assert torch.equal(counts, raw[:, 0])
    if case == "sentinel_queries":
        # the sentinel rows are valid and matched, from a 1e9-scale key
        assert float(counts.max()) > 50
        return
    if case == "nan_queries":
        assert not counts[::7].any() and not counts[1::7].any()
    if case == "one_bucket":
        comp, comp_order = K.prepared_query_operands(
            K._prepare_band(t[0], t[1], t[2], _t(w), prep.sdim, prep.sdim2),
            _t(queries))
        _assert_holds_one_copy_operands(ops, qorder, comp, comp_order,
                                        len(keys))
        assert torch.equal(K.query_sorted_prepared(prep, _t(queries)),
                           torch.empty((q, 3)).index_copy_(
                               0, comp_order, K.sorted_moments_plain(comp)))
        return
    if not old_case:
        return
    flat, _ = _flat_key_operands(*t, _t(queries), _t(w))
    flat_keep = _assert_prune_keeps(flat, 0 if case == "outside_span"
                                    else 50)
    assert 0 < keep.float().mean() < 0.5 * flat_keep.float().mean()


@pytest.mark.parametrize("change", ["wide_action", "non_integer_action"])
def test_flat_key_where_the_band_dim_is_not_discrete(change):
    """With ``w_a >= 0.5`` or a non-integer valid key in the band dim,
    ``prepare_sorted_store`` keeps the flat key and takes no middle
    level: the operands hold those of the flat key made directly bit for
    bit (:func:`_assert_holds_one_copy_operands`), and so do the
    moments."""
    keys, values, valid, queries, w = _lane_like_inputs(
        2, 6000, 300, sentinel=change != "wide_action", middle=True)
    if change == "wide_action":
        w[-1] = 0.5
        keys[:, -1] *= 40.0  # keep it the band dim
    else:
        keys[np.flatnonzero(valid)[7], -1] += 0.25
    t = [_t(a) for a in (keys, values, valid, queries, w)]
    prep = K.prepare_sorted_store(*t[:3], t[4])
    assert not bool(prep.composite) and int(prep.sdim) == 20
    assert not bool(prep.bucketed) and prep.copies == 2
    got, got_order = K.prepared_query_operands(prep, t[3])
    want, want_order = _flat_key_operands(*t)
    _assert_holds_one_copy_operands(got, got_order, want, want_order,
                                    len(keys))
    assert torch.equal(prep.w0, t[4][20:])
    assert torch.equal(K.query_sorted_prepared(prep, t[3]), torch.empty(
        (300, 3)).index_copy_(0, want_order, K.sorted_moments_plain(want)))


def test_grouped_prune_keeps_pairs_on_dense_sentinel_store():
    keys, values, valid, qg, w = _dense_sentinel_inputs(seed=3, waves=16)
    ops, _ = K.grouped_query_operands(*(_t(a) for a in (keys, values, valid,
                                                        qg, w)))
    _assert_prune_keeps(ops, 20)
    # the sentinel rows are valid, yet stay out of the composite span
    assert bool((_t(keys)[:, 0] > 1e8).any())


def test_grouped_prune_keeps_off_lattice_action_rows():
    """Valid rows whose action lies off the integers, within the action
    half-width of a candidate (0.05 and 0.95 at w 0.1), match their
    candidates' queries: the grouped route takes the plain action band
    there, keeps every contained pair and sums what ``_raw_moments``
    sums.  A composite key on the unrounded action would put those rows
    about four band units from their queries, among the lattice rows
    spread over +-20 in dim 1, in sub-slices the prune drops."""
    rng = np.random.default_rng(21)
    n, qa = 4000, 128
    lattice = rng.normal(0, 3, (2 * n, 5)).astype(np.float32)
    lattice[:, 1] = np.tile(np.linspace(-20, 20, n), 2)
    lattice[:, -1] = np.repeat([0.0, 1.0], n)
    off = np.zeros((6, 5), np.float32)
    off[:, -1] = [0.05] * 3 + [0.95] * 3
    keys = np.concatenate([lattice, off])
    values = rng.normal(0, 1, len(keys)).astype(np.float32)
    valid = np.ones(len(keys), bool)
    obs = rng.uniform(-0.1, 0.1, (qa, 4)).astype(np.float32)
    w = np.asarray([1.0, 0.3, 1.0, 1.0, 0.1], np.float32)
    t = [_t(a) for a in (keys, values, valid, _group(obs, 2), w)]
    ops, _ = K.grouped_query_operands(*t)
    _assert_prune_keeps(ops, 6 * qa)
    got = K.box_query_moments_grouped(*t)
    raw = S._raw_moments(t[0], t[1], t[2], t[3].reshape(-1, 5), t[4])
    assert (raw[:, 0] >= 3).all()  # each query holds its off-lattice rows
    _assert_moments(got.numpy(), raw.numpy().reshape(got.shape))


# The band dims and record orders each prepare chose on the tests' stores
# before the flat and grouped routes shared one band-key core: sdim,
# sdim2, composite and perm of prepare_sorted_store, sdim2 and perm of
# prepare_peraction_store (n_tile 256) and, on the grouped stores, the
# grouped route's record order.  Taken on one torch thread: on the
# sentinel store the 1e9 rows swamp every dim's spread, so the order of
# dims with equal half-widths is that of the sums' rounding, which
# follows the thread count.  With the middle level, prepare_sorted_store
# also picks sdim3 and whether it takes the level (bucketed), and its
# records end in the bucket column; where it takes the level the rows'
# band order changes, and with it on the sentinel store the order of two
# dims of equal half-width (lane_sentinel's 11 and 3).
BAND_DIMS = {
    "flat_random": dict(
        sdim=11, sdim2=3, composite=False, sdim3=0, bucketed=False,
        perm=[3, 0, 8, 19, 13, 9, 14, 17, 4, 1, 20, 12, 6, 16, 7, 10, 2, 18,
              5, 15, 11, 21],
        pa_sdim2=11,
        pa_perm=[3, 0, 8, 19, 13, 9, 14, 17, 4, 12, 6, 16, 7, 10, 2, 18, 5,
                 15, 11, 1]),
    "lane_sentinel": dict(
        sdim=20, sdim2=8, composite=True, sdim3=17, bucketed=True,
        perm=[1, 5, 9, 13, 17, 0, 2, 6, 10, 14, 18, 4, 12, 16, 11, 3, 7, 15,
              19, 8, 20, 21],
        pa_sdim2=8,
        pa_perm=[17, 5, 9, 13, 0, 18, 14, 2, 6, 10, 16, 12, 4, 19, 15, 3, 7,
                 11, 8, 1]),
    "lane_plain": dict(
        sdim=20, sdim2=8, composite=True, sdim3=11, bucketed=True,
        perm=[11, 12, 16, 9, 4, 6, 3, 0, 18, 19, 7, 13, 14, 5, 15, 2, 17, 10,
              1, 8, 20, 21],
        pa_sdim2=8,
        pa_perm=[11, 12, 16, 9, 4, 6, 3, 0, 18, 19, 7, 13, 14, 5, 15, 2, 17,
                 10, 8, 1]),
    "dense_sentinel": dict(
        sdim=4, sdim2=0, composite=True, sdim3=1, bucketed=True,
        perm=[1, 2, 3, 0, 4, 5], pa_sdim2=0,
        pa_perm=[2, 3, 0, 1], grouped_perm=[0, 2, 3, 1, 4]),
    "grouped": dict(
        sdim=20, sdim2=5, composite=True, sdim3=6, bucketed=True,
        perm=[6, 11, 9, 16, 13, 4, 18, 12, 15, 3, 17, 19, 14, 7, 8, 10, 2, 1,
              0, 5, 20, 21],
        pa_sdim2=5,
        pa_perm=[6, 11, 9, 16, 13, 4, 18, 12, 15, 3, 17, 19, 14, 7, 8, 10, 2,
                 0, 5, 1],
        grouped_perm=[5, 6, 11, 9, 16, 13, 4, 18, 12, 15, 3, 17, 19, 14, 7,
                      8, 10, 2, 0, 1, 20]),
}


@pytest.mark.parametrize("store", sorted(BAND_DIMS))
def test_band_dims_as_before(store):
    keys, values, valid, queries, w = {
        "flat_random": lambda: _flat_inputs(1, 0.8),
        "lane_sentinel": lambda: _lane_like_inputs(0),
        "lane_plain": lambda: _lane_like_inputs(0, sentinel=False),
        "dense_sentinel": _dense_sentinel_inputs,
        "grouped": _grouped_inputs}[store]()
    num_actions = {"lane_sentinel": 8, "lane_plain": 8,
                   "dense_sentinel": 4}.get(store, 11)
    t = [_t(a) for a in (keys, values, valid)]
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    try:
        prep = K.prepare_sorted_store(*t, _t(w))
        pa = K.prepare_peraction_store(*t, _t(w), num_actions=num_actions,
                                       n_tile=256)
        got = dict(sdim=int(prep.sdim), sdim2=int(prep.sdim2),
                   composite=bool(prep.composite), sdim3=int(prep.sdim3),
                   bucketed=bool(prep.bucketed), perm=prep.perm.tolist(),
                   pa_sdim2=int(pa.sdim2), pa_perm=pa.perm.tolist())
        if queries.ndim == 3:
            ops, _ = K.grouped_query_operands(*t, _t(queries), _t(w))
            got["grouped_perm"] = ops.perm.tolist()
    finally:
        torch.set_num_threads(threads)
    assert got == BAND_DIMS[store]


# ---------------------------------------------------------------------------
# Store inserts, queries and the train gate against the JAX package
# ---------------------------------------------------------------------------


def _assert_store_equal(got, ref):
    for name in ("keys", "actions", "values", "size", "head"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)


def _j_store(store):
    return JS.ConfidenceStore(*(jnp.asarray(x.numpy()) for x in store))


@pytest.mark.parametrize("policy", ["ring", "reject"])
@pytest.mark.parametrize("cap,sizes", [(4, (1, 1, 1, 1, 1, 1, 1)),  # :137
                                       (4, (2, 5)),                 # :153
                                       (4, (10,)),                  # :182 lap
                                       (8, (3,)),                   # :320
                                       (64, (20, 30, 25, 70, 5))])
def test_store_insert_matches_jax(policy, cap, sizes):
    rng = np.random.default_rng(cap + len(sizes))
    d = 3
    js, ts = JS.store_init(cap, d), S.store_init(cap, d, device="cpu")
    for i, m in enumerate(sizes):
        keys = rng.normal(0, 1, (m, d)).astype(np.float32)
        vals = (np.arange(m) + 100.0 * i).astype(np.float32)
        mask = rng.random(m) < (0.6 if cap == 64 else 1.0)
        if cap == 8:
            mask = np.asarray([True, False, True])
        args = (keys, keys[:, 0], vals, mask)
        js = JS.store_insert(js, *(jnp.asarray(a) for a in args), policy=policy)
        ts = S.store_insert(ts, *(_t(a) for a in args), policy=policy)
        _assert_store_equal(ts, js)
    with pytest.raises(ValueError):
        S.store_insert(ts, _t(keys), _t(vals), _t(vals), _t(mask),
                       policy="lru")


def test_store_dense_block_matches_jax():
    """tests/test_store_rls.py:230: six 8-row blocks through a 32-row
    ring, invalid rows stamped with the sentinel key."""
    rng = np.random.default_rng(9)
    d, m, cap = 4, 8, 32
    js, ts = JS.store_init(cap, d), S.store_init(cap, d, device="cpu")
    for _ in range(6):
        keys = rng.normal(0, 2, (m, d)).astype(np.float32)
        keys[:, -1] = rng.integers(0, 3, m)
        vals = rng.normal(0, 1, m).astype(np.float32)
        mask = rng.random(m) < 0.7
        args = (keys, keys[:, -1], vals, mask)
        js = JS.store_insert_dense_block(js, *(jnp.asarray(a) for a in args))
        ts = S.store_insert_dense_block(ts, *(_t(a) for a in args))
        _assert_store_equal(ts, js)
    assert (ts.keys == S.SENTINEL_KEY).any()
    with pytest.raises(ValueError):
        S.store_insert_dense_block(S.store_init(30, d, device="cpu"), _t(keys), _t(vals),
                                   _t(vals), _t(mask))


@pytest.mark.parametrize("use_kernel", [False, True])
def test_box_query_stats_matches_jax(use_kernel):
    """tests/test_store_rls.py:40: 300 rows in a 512-row store."""
    rng = np.random.default_rng(0)
    d, n = 5, 300
    keys = rng.normal(0, 5, (n, d))
    keys[:, -1] = rng.integers(0, 8, n)
    values = rng.normal(0, 1, n)
    args = (keys.astype(np.float32), keys[:, -1].astype(np.float32),
            values.astype(np.float32), np.ones(n, bool))
    js = JS.store_insert(JS.store_init(512, d),
                         *(jnp.asarray(a) for a in args))
    ts = S.store_insert(S.store_init(512, d, device="cpu"), *(_t(a) for a in args))
    w = np.array([1.0, 2.0, 0.5, 3.0, 0.1], np.float32)
    queries = rng.normal(0, 5, (64, d)).astype(np.float32)
    queries[:, -1] = rng.integers(0, 8, 64)
    ref = JS.box_query_stats(js, jnp.asarray(queries), jnp.asarray(w),
                             use_pallas=False)
    got = S.box_query_stats(ts, _t(queries), _t(w), use_kernel=use_kernel)
    np.testing.assert_array_equal(got.count.numpy(), np.asarray(ref.count))
    assert int(got.count.sum()) > 0
    for name in ("mean", "var", "sigma"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   rtol=1e-4, atol=1e-5, err_msg=name)
    # and the all-action form
    obs = queries[:8, :-1]
    ja = JR.all_action_stats(js, jnp.asarray(obs), jnp.asarray(w), 8,
                             use_pallas=False)
    ta = R.all_action_stats(ts, _t(obs), _t(w), 8, use_kernel=use_kernel)
    np.testing.assert_array_equal(ta.count.numpy(), np.asarray(ja.count))


def test_act_train_matches_jax():
    """The train gate with JAX's own explore draw fed in, on stats with
    every branch (under-explored rule, good rule, poor rule)."""
    rng = np.random.default_rng(12)
    b = 256
    count, mean, var, sigma = _random_action_stats(rng, b, 1)
    mean[:, 0] = rng.uniform(-1.2, 0.2, b)
    rl = rng.integers(0, 11, b).astype(np.int32)
    jcfg = JStoreConfig()
    key = jax.random.PRNGKey(4)
    jstats = JR.ActionStats(*(jnp.asarray(a) for a in (count.astype(np.int32),
                                                       mean, var, sigma)))
    ref = np.asarray(JR.act_train(jstats, jnp.asarray(rl), key, jcfg))
    explore = jax.random.uniform(key, (b,), minval=jcfg.explore_low,
                                 maxval=jcfg.explore_high)
    got = R.act_train(R.ActionStats(_t(count.astype(np.int32)), _t(mean),
                                    _t(var), _t(sigma)),
                      _t(rl), _t(explore), StoreConfig())
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)
    assert (ref == 0).sum() > 20 and (ref > 0).sum() > 20


# ---------------------------------------------------------------------------
# Trajectory buffers: readable and lane-major, in every value mode
# ---------------------------------------------------------------------------

MODES = {"reference": dict(),
         "nstep": dict(value_mode="nstep"),
         "episode": dict(value_mode="episode", gamma=1.0, n_step_window=20)}
DONE_STEPS = {"reference": (24, 42, 47), "nstep": (17, 33),
              "episode": (14, 20, 38, 49)}


def _assert_records(got, ref):
    """Keys, actions and valid flags bit-equal; values within 1e-6 of
    the unit reward scale (the JAX package sums the discounted window as
    a matrix product, the port elementwise: another summation order)."""
    for name in ("keys", "actions", "valid"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    np.testing.assert_allclose(got.values.numpy(), np.asarray(ref.values),
                               rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_traj_buffer_push_and_insert_match_jax(mode):
    """tests/test_store_rls.py:407, :438, :757 and :484: one env's
    window over 50 steps, its records inserted into a store."""
    rng = np.random.default_rng(2)
    jcfg, cfg = JStoreConfig(**MODES[mode]), StoreConfig(**MODES[mode])
    obs_dim = 4
    jb = JR.traj_buffer_init(jcfg.n_step_window, obs_dim)
    tb = R.traj_buffer_init(cfg.n_step_window, obs_dim, device="cpu")
    js, ts = JS.store_init(256, obs_dim + 1), S.store_init(256, obs_dim + 1, device="cpu")
    n_rec = 0
    for step in range(50):
        obs = rng.normal(0, 1, obs_dim).astype(np.float32)
        action = np.float32(rng.integers(0, 8))
        rew = np.float32(rng.normal(0, 1))
        done = step in DONE_STEPS[mode]
        jb, jrec = JR.traj_buffer_push(
            jb, jnp.asarray(obs), jnp.asarray(action), jnp.asarray(rew),
            jnp.asarray(done), jcfg)
        tb, trec = R.traj_buffer_push(tb, _t(obs), _t(action), _t(rew),
                                      _t(done), cfg)
        _assert_records(trec, jrec)
        np.testing.assert_array_equal(tb.length.numpy(), np.asarray(jb.length))
        js = JR.insert_records(js, jrec)
        ts = R.insert_records(ts, trec)
        n_rec += int(trec.valid.sum())
    for name in ("keys", "actions", "size", "head"):
        np.testing.assert_array_equal(getattr(ts, name).numpy(),
                                      np.asarray(getattr(js, name)), name)
    np.testing.assert_allclose(ts.values.numpy(), np.asarray(js.values),
                               rtol=1e-6, atol=1e-6)
    assert int(ts.size) == min(n_rec, 256) and n_rec > 0
    with pytest.raises(ValueError):
        R.traj_buffer_push(R.traj_buffer_init(3, obs_dim, device="cpu"), _t(obs),
                           _t(action), _t(rew), _t(done), cfg)


@pytest.mark.parametrize("mode", sorted(MODES))
def test_traj_push_lane_matches_jax(mode):
    """tests/test_store_rls.py:622 and :797: the lane-major push of six
    envs over 30 steps, random dones (episode mode: never past the
    window)."""
    rng = np.random.default_rng(17)
    kw = dict(MODES[mode], n_step_window=5 if mode != "episode" else 12,
              gamma=0.9 if mode != "episode" else 1.0)
    jcfg, cfg = JStoreConfig(**kw), StoreConfig(**kw)
    w, d, b = cfg.n_step_window, 4, 6
    jbuf = (jnp.zeros((w, d, b), jnp.float32), jnp.zeros((w, b), jnp.float32),
            jnp.zeros((w, b), jnp.float32), jnp.zeros((b,), jnp.int32))
    tbuf = tuple(_t(x) for x in jbuf)
    since = np.zeros(b, int)
    for step in range(30):
        obs = rng.normal(0, 1, (d, b)).astype(np.float32)
        act = rng.integers(0, 5, b).astype(np.float32)
        rew = rng.normal(0, 1, b).astype(np.float32)
        since += 1
        done = (rng.random(b) < 0.15) | (since >= w - 1)
        since[done] = 0
        args = (obs, act, rew, done)
        jbuf, jrec = JR.traj_push_lane(*jbuf, *(jnp.asarray(a) for a in args),
                                       jcfg)
        tbuf, trec = R.traj_push_lane(*tbuf, *(_t(a) for a in args), cfg)
        _assert_records(trec, jrec)
        for g, r in zip(tbuf, jbuf):
            np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert int(trec.valid.sum()) >= 0 and tbuf[3].dtype == torch.int32
