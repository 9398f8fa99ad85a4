"""The store-query kernels' plans and row records, on the CPU.

The kernels (``dcarl_tpu_torch/csrc``) split each query tile's window of
row sub-slices into chunks walked by a persistent grid, read rows from
one fused record per row, and test the key dims in a data-chosen order.
They run only on the card; what decides what they compute is PyTorch and
is checked here: the windows against the band prune, the chunk cover,
the records against the operands the plain versions read, and a CPU
emulation of the chunked walk (partials summed in chunk order) against
the plain versions (counts exact, sums within rtol 1e-4 / atol 1e-3)."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu_torch.config import DRIVING_HALF_WIDTHS
from dcarl_tpu_torch.ops import store_kernels as K
from test_torch_store_rls import (_dense_sentinel_inputs, _flat_inputs,
                                  _group, STORES)

MOMENT_TOL = dict(rtol=1e-4, atol=1e-3)


def _t(a):
    return torch.as_tensor(np.array(a))


def _prune_inputs(seed):
    """The clustered store of test_torch_store_rls.py:417: keys spread
    along dim 1, queries near the clusters."""
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
    queries = (centers[rng.integers(0, 24, q)]
               + rng.normal(0, 1.5, (q, d))).astype(np.float32)
    queries[:, -1] = rng.integers(0, 11, q)
    return keys, values, valid, queries, w


def _sorted_ops(store):
    """Sorted-kernel operands of the named store."""
    if store == "flat_random":
        keys, values, valid, queries, w = _prune_inputs(0)
        return K.sorted_query_operands(*map(_t, (keys, values, valid,
                                                 queries, w)))[0]
    if store == "flat_all_invalid":
        arrs = _flat_inputs(2, 0.0)
        return K.sorted_query_operands(*map(_t, arrs))[0]
    if store == "grouped_lockstep":
        # the trainer's zero-jitter start: half the envs are one state
        keys, values, valid, queries, w = _prune_inputs(1)
        obs = queries[:, :-1].copy()
        obs[: len(obs) // 2] = obs[0]
        return K.grouped_query_operands(*map(_t, (keys, values, valid)),
                                        _t(_group(obs, 11)), _t(w))[0]
    assert store == "dense_sentinel"
    arrs = _dense_sentinel_inputs(seed=3, waves=16)
    return K.grouped_query_operands(*map(_t, arrs))[0]


SORTED_STORES = ["flat_random", "flat_all_invalid", "grouped_lockstep",
                 "dense_sentinel"]


def _windows(plan, n_sub):
    """[n_qt, n_sub] bool: sub-slice s lies in tile t's window."""
    s = torch.arange(n_sub)
    return (s[None] >= plan.s_lo[:, None].long()) \
        & (s[None] < plan.s_hi[:, None].long())


def _assert_chunks_cover(plan, n_sub):
    """Tile t's chunks cover its window exactly once, in order, each at
    most ``chunk`` long, within the shape-only bound."""
    off = plan.off.long()
    n_qt = plan.s_lo.shape[0]
    assert off.shape == (n_qt + 1,) and int(off[0]) == 0
    assert int(off[-1]) <= plan.max_chunks
    assert plan.max_chunks == n_qt * -(-n_sub // plan.chunk)
    for t in range(n_qt):
        lo, hi = int(plan.s_lo[t]), int(plan.s_hi[t])
        assert 0 <= lo <= hi <= n_sub
        covered = []
        for c in range(int(off[t]), int(off[t + 1])):
            s0 = lo + (c - int(off[t])) * plan.chunk
            s1 = min(s0 + plan.chunk, hi)
            assert s0 < s1
            covered.extend(range(s0, s1))
        assert covered == list(range(lo, hi))


@pytest.mark.parametrize("store", SORTED_STORES)
def test_sorted_plan_window_is_the_prune(store):
    ops = _sorted_ops(store)
    keep = K.sorted_prune_keep(ops)
    plan = K.sorted_plan(ops)
    n_sub = ops.kb.shape[1]
    assert torch.equal(_windows(plan, n_sub), keep)
    _assert_chunks_cover(plan, n_sub)
    if store in ("flat_random", "grouped_lockstep"):  # many sub-slices
        assert 0 < keep.float().mean() < 0.6


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_peraction_plan_window_holds_the_prune(seed):
    keys, values, valid, queries, w = _prune_inputs(seed)
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32) * 1.5
    w[-1] = 0.1
    prep = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                     num_actions=11, n_tile=1024)
    _, qext = K.query_operands(prep, _t(queries[:, :-1]))
    keep = K.prune_keep(prep, qext)
    plan = K.peraction_plan(prep, qext)
    win = _windows(plan, prep.kb.shape[1])
    assert keep.any() and not (keep & ~win).any()
    assert win.float().mean() < 1  # the window itself prunes
    _assert_chunks_cover(plan, prep.kb.shape[1])


@pytest.mark.parametrize("chunk", [1, 3, 64])
def test_chunks_cover_windows_at_any_chunk_size(chunk):
    ops = _sorted_ops("grouped_lockstep")
    plan = K.sorted_plan(ops, chunk=chunk)
    assert plan.chunk == chunk
    _assert_chunks_cover(plan, ops.kb.shape[1])
    plan = K.brute_plan(5, 7, torch.device("cpu"), chunk=chunk)
    assert torch.equal(_windows(plan, 7), torch.ones(5, 7, dtype=torch.bool))
    _assert_chunks_cover(plan, 7)


def test_chunk_size_bounds_the_scratch():
    """At the gated driver's shapes (65,536 queries x 2^18 rows, 11
    actions) the scratch stays within a few hundred MB; at the trainer
    fill's (16,384 x 2^18) the sorted kernel keeps its smallest chunk."""
    pa_bytes = 4 * 33 * K._QT
    c = K._chunk_size(512, 1024, pa_bytes, 8, K._PA_MAX_CHUNK)
    assert c == 32 and 512 * (1024 // c) * pa_bytes <= K._SCRATCH_BYTES
    assert K._chunk_size(128, 1024, 8 * 3 * K._SQT, 4, 1 << 20) == 4
    assert K._chunk_size(1, 4, 1 << 40, 8, 64) == 64  # capped


@pytest.mark.parametrize("store", SORTED_STORES)
def test_band_record_unpacks_to_the_operands(store):
    ops = _sorted_ops(store)
    d = ops.q_t.shape[0]
    perm = ops.perm.long()
    assert ops.rows.shape == (ops.keys_t.shape[1], K.record_floats(d))
    assert ops.perm.dtype == torch.int32
    assert sorted(perm.tolist()) == list(range(d))
    assert torch.equal(ops.rows[:, :d], ops.keys_t[perm].T)
    assert torch.equal(ops.rows[:, d], ops.vals)
    assert torch.equal(ops.rows[:, d + 1], ops.valid)
    assert (ops.rows[:, d + 2:] == 0).all()


def test_brute_record_unpacks_to_the_inputs():
    keys, values, valid, queries, w = _flat_inputs(1, 0.8)
    ops = K.brute_operands(*map(_t, (keys, values, valid, queries, w)))
    n, d = keys.shape
    assert torch.equal(ops.perm, torch.arange(d, dtype=torch.int32))
    assert torch.equal(ops.rows[:n, :d], _t(keys))
    assert torch.equal(ops.rows[:n, d], _t(values))
    assert torch.equal(ops.rows[:n, d + 1], _t(valid).float())
    assert (ops.rows[n:] == 0).all()
    assert ops.rows.shape[1] == K.record_floats(d)


@pytest.mark.parametrize("store", sorted(STORES))
def test_peraction_record_unpacks_to_the_operands(store):
    keys, values, valid, _, w = STORES[store]()
    prep = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                     num_actions=11, n_tile=256)
    perm = prep.perm.long()
    assert prep.rows.shape == (prep.keys_t.shape[1], 24)
    assert sorted(perm.tolist()) == list(range(20))
    # the band dim and the second prune dim are tested last
    assert perm[-1] == prep.band_dim and perm[-2] == prep.sdim2
    assert torch.equal(prep.rows[:, :20], prep.keys_t[perm].T)
    assert torch.equal(prep.rows[:, 20].view(torch.int32), prep.row_act)
    assert torch.equal(prep.rows[:, 21:], prep.row_mom.T)


@pytest.mark.parametrize("store", SORTED_STORES)
def test_dim_permutation_leaves_sorted_plain_bit_equal(store):
    ops = _sorted_ops(store)
    perm = ops.perm.long()
    permuted = ops._replace(q_t=ops.q_t[perm].contiguous(),
                            keys_t=ops.keys_t[perm].contiguous(),
                            w=ops.w[perm].contiguous())
    assert torch.equal(K.sorted_moments_plain(permuted),
                       K.sorted_moments_plain(ops))
    # and the band / action dims the rows are sorted by come last
    if store == "grouped_lockstep":
        assert sorted(perm[-2:].tolist()) == [1, 20]


def _band_walk(ops, plan):
    """CPU emulation of band_moments.cuh: per chunk, the f64 partial
    moments of its tile's queries over the chunk's records (keys in
    record order), then each query's partials summed in chunk order."""
    d, q = ops.q_t.shape
    perm = ops.perm.long()
    qp, wp = ops.q_t[perm], ops.w[perm]
    keys, v = ops.rows[:, :d], ops.rows[:, d].double()
    live = ops.rows[:, d + 1] != 0
    feats = torch.stack([torch.ones_like(v), v, v * v], 1)
    out = torch.zeros((q, 3), dtype=torch.float64)
    off = plan.off.long()
    for t in range(plan.s_lo.shape[0]):
        qs = slice(t * K._SQT, min(q, (t + 1) * K._SQT))
        for c in range(int(off[t]), int(off[t + 1])):
            s0 = int(plan.s_lo[t]) + (c - int(off[t])) * plan.chunk
            s1 = min(s0 + plan.chunk, int(plan.s_hi[t]))
            r = slice(s0 * K._SSUB_N, s1 * K._SSUB_N)
            mask = live[r][None].expand(qs.stop - qs.start, -1).clone()
            for dd in range(d):
                mask &= (qp[dd, qs, None] - keys[r, dd][None]).abs() <= wp[dd]
            out[qs] += mask.double() @ feats[r]
    return out.float()


@pytest.mark.parametrize("store,chunk", [("flat_random", 1),
                                         ("grouped_lockstep", 2),
                                         ("dense_sentinel", None)])
def test_chunked_sorted_walk_matches_plain(store, chunk):
    ops = _sorted_ops(store)
    got = _band_walk(ops, K.sorted_plan(ops, chunk=chunk))
    ref = K.sorted_moments_plain(ops)
    assert ref[:, 0].sum() > 0
    assert torch.equal(got[:, 0], ref[:, 0])
    torch.testing.assert_close(got[:, 1:], ref[:, 1:], **MOMENT_TOL)


def test_chunked_brute_walk_matches_plain():
    keys, values, valid, queries, w = _flat_inputs(1, 0.8)
    t = list(map(_t, (keys, values, valid, queries, w)))
    ops = K.brute_operands(*t)
    n_qt, n_sub = ops.q_t.shape[1] // K._SQT, ops.rows.shape[0] // K._SSUB_N
    got = _band_walk(ops, K.brute_plan(n_qt, n_sub, torch.device("cpu"),
                                       chunk=2))[:len(queries)]
    ref = K.brute_moments_plain(*t)
    assert ref[:, 0].sum() > 0
    assert torch.equal(got[:, 0], ref[:, 0])
    torch.testing.assert_close(got[:, 1:], ref[:, 1:], **MOMENT_TOL)


@pytest.mark.parametrize("store", sorted(STORES))
def test_piece_summary_bounds_the_live_rows(store):
    keys, values, valid, _, w = STORES[store]()
    prep = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                     num_actions=11, n_tile=256)
    n_pc = prep.keys_t.shape[1] // 128
    assert prep.piece_box.shape == (n_pc, 40)
    assert prep.piece_mom.shape == (n_pc, 33)
    live = prep.row_act >= 0
    for pc in range(n_pc):
        r = slice(pc * 128, (pc + 1) * 128)
        k = prep.rows[r, :20][live[r]]
        if k.shape[0] == 0:
            assert (prep.piece_box[pc, :20] == torch.inf).all()
            assert (prep.piece_box[pc, 20:] == -torch.inf).all()
        else:
            assert torch.equal(prep.piece_box[pc, :20], k.amin(0))
            assert torch.equal(prep.piece_box[pc, 20:], k.amax(0))
    # the piece sums, recomputed from the row records: the rows' f32
    # moments summed per action in f64, unrounded
    act = prep.rows[:, 20].view(torch.int32).long().reshape(n_pc, 128)
    mom = prep.rows[:, 21:].double().reshape(n_pc, 128, 3)
    onehot = (act[..., None] == torch.arange(11)).double()  # [n_pc, 128, A]
    per = torch.einsum("prm,pra->pam", mom, onehot)          # [n_pc, A, 3]
    assert prep.piece_mom.dtype == torch.float64
    torch.testing.assert_close(prep.piece_mom, per.reshape(n_pc, 33),
                               rtol=1e-15, atol=0)


@pytest.mark.parametrize("seed,chunk", [(0, 1), (1, 3), (2, None),
                                        ("lockstep", 2)])
def test_chunked_peraction_walk_matches_plain(seed, chunk):
    """CPU emulation of peraction_moments.cu: per chunk, the exact
    tile / sub-slice rectangle test picks the sub-slices; a query that
    holds a 128-row piece's live-row box takes its sums, one out of reach
    takes nothing, the others test its records (keys in record order,
    actions, moments); the f32 partials are summed per query in chunk
    order (in f64, rounded once)."""
    keys, values, valid, queries, _ = _prune_inputs(
        3 if seed == "lockstep" else seed)
    if seed == "lockstep":  # a fleet in lockstep: rows and queries packed
        rng = np.random.default_rng(3)
        keys[:, :-1] = keys[0, :-1] + rng.normal(0, 0.2, keys[:, :-1].shape)
        queries[:, :-1] = keys[0, :-1] + rng.normal(0, 0.2,
                                                    queries[:, :-1].shape)
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32) * 1.5
    w[-1] = 0.1
    prep = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                     num_actions=11, n_tile=1024)
    obs = _t(queries[:, :-1])
    qorder, qext = K.query_operands(prep, obs)
    plan = K.peraction_plan(prep, qext, chunk=chunk)
    n_held = 0
    keep = K.prune_keep(prep, qext)
    perm = prep.perm.long()
    qs_all, wp = obs[qorder][:, perm], prep.w_col[perm]
    act = prep.rows[:, 20].view(torch.int32).long()
    onehot = (act[:, None] == torch.arange(11)[None]).float()     # [n, A]
    feats = (onehot[:, :, None] * prep.rows[:, None, 21:]).reshape(-1, 33)
    feats = feats.double()
    b = obs.shape[0]
    out = torch.zeros((b, 33), dtype=torch.float64)
    off = plan.off.long()
    for t in range(plan.s_lo.shape[0]):
        qs = slice(t * K._QT, min(b, (t + 1) * K._QT))
        for c in range(int(off[t]), int(off[t + 1])):
            s0 = int(plan.s_lo[t]) + (c - int(off[t])) * plan.chunk
            s1 = min(s0 + plan.chunk, int(plan.s_hi[t]))
            part = torch.zeros((qs.stop - qs.start, 33), dtype=torch.float64)
            pieces = [pc for s in range(s0, s1) if keep[t, s]
                      for pc in (2 * s, 2 * s + 1)]
            for pc in pieces:
                # whole pieces first: its box held -> its sums, out of
                # reach -> nothing, else row by row
                lo, hi = prep.piece_box[pc, :20], prep.piece_box[pc, 20:]
                a, c = qs_all[qs] - lo, qs_all[qs] - hi
                held = ((a.abs() <= wp) & (c.abs() <= wp)).all(1)
                out_of_reach = ((c > wp) | (a < -wp)).any(1)
                part[held] += prep.piece_mom[pc]
                n_held += int(held.sum())
                undecided = ~held & ~out_of_reach
                r = slice(pc * 128, (pc + 1) * 128)
                mask = (act[r] >= 0)[None].expand(part.shape[0], -1).clone()
                mask &= undecided[:, None]
                for dd in range(20):
                    mask &= (qs_all[qs, dd, None]
                             - prep.rows[r, dd][None]).abs() <= wp[dd]
                part += mask.double() @ feats[r]
            out[qs] += part
    got = torch.empty_like(out).index_copy_(0, qorder, out).float().reshape(
        b, 11, 3)
    ref = K.peraction_moments_plain(prep, obs)
    if seed == "lockstep":  # the whole-sub-slice path is taken
        assert n_held > 0
    assert ref[..., 0].sum() > 0
    assert torch.equal(got[..., 0], ref[..., 0])
    torch.testing.assert_close(got[..., 1:], ref[..., 1:], **MOMENT_TOL)


def test_peraction_plain_sums_in_f64_rounded_once():
    """The per-action plain version (and so the kernel it holds) sums
    the rows' f32 moments in f64 and rounds to f32 once: equal, bit for
    bit, to a float64 recomputation from the row records, and the same
    bits from a store that also holds rows no query reaches (the full
    store against a masked one, the vehicle-life audit's comparison)."""
    keys, values, valid, queries, w = _prune_inputs(4)
    # values over five decades, where f32 running sums round differently
    # in different orders
    rng = np.random.default_rng(4)
    values = (values * 10.0 ** rng.integers(-2, 3, len(values))
              ).astype(np.float32)
    obs = _t(queries[:, :-1])
    prep = K.prepare_peraction_store(_t(keys), _t(values), _t(valid), _t(w),
                                     num_actions=11, n_tile=256)
    got = K.peraction_moments_plain(prep, obs)
    assert got.dtype == torch.float32 and got[..., 0].sum() > 0
    # the f64 output (a sharded caller's, which adds other ranks' sums
    # first) rounds to the same bits
    wide = K.query_peraction_prepared(prep, obs, out_dtype=torch.float64)
    assert wide.dtype == torch.float64 and torch.equal(wide.float(), got)
    mask = np.ones((len(queries), prep.keys_t.shape[1]), bool)
    kt, wc = prep.keys_t.numpy(), prep.w_col.numpy()
    for d in range(20):
        mask &= np.abs(queries[:, d:d + 1] - kt[d][None]) <= wc[d]
    act = prep.row_act.numpy()
    mom = prep.row_mom.numpy().astype(np.float64)          # [3, n_pad]
    want = np.zeros((len(queries), 11, 3))
    for a in range(11):
        sel = mask & (act == a)[None]
        want[:, a] = sel.astype(np.float64) @ mom.T
    np.testing.assert_array_equal(got.numpy(), want.astype(np.float32))
    # the same store with far rows added: the matched rows sit in other
    # pieces and sort positions, the moments keep their bits
    far = keys.copy()
    far[:, 1] += 1.0e4
    both = K.prepare_peraction_store(
        _t(np.concatenate([keys, far])), _t(np.concatenate([values, values])),
        _t(np.concatenate([valid, valid])), _t(w), num_actions=11,
        n_tile=256)
    assert torch.equal(K.peraction_moments_plain(both, obs), got)
