"""The CUDA kernels against their plain versions, on the card.

Marked ``cuda``: without a GPU every test here skips (the kernel has no
CPU or interpret mode).  On a machine with an H100 and ``nvcc``:
``python -m pytest tests/test_torch_kernels_cuda.py -q``."""

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu_torch import disable_tf32
from dcarl_tpu_torch.config import DRIVING_HALF_WIDTHS
from dcarl_tpu_torch.core.store import FIELD_HALF_WIDTHS
from dcarl_tpu_torch.ops import _cuda
from dcarl_tpu_torch.ops import store_kernels as K

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernel runs only on the card)")
    disable_tf32()
    return torch.device("cuda")


def _store(rng, n, b, dup=1, off_lattice=0, A=11):
    d = 21
    centers = rng.normal(0, 4, (32, d - 1)).astype(np.float32)
    keys = np.zeros((n, d), np.float32)
    keys[:, :-1] = centers[rng.integers(0, 32, n)] + rng.normal(0, 1.0, (n, d - 1))
    keys[:, -1] = rng.integers(0, A, n)
    keys[:off_lattice, -1] = 4.5
    keys = np.repeat(keys[: n // dup], dup, axis=0)[:n]
    values = rng.normal(0, 1, len(keys)).astype(np.float32)
    valid = rng.random(len(keys)) < 0.9
    # queries next to valid rows, so that every query matches something
    near = np.flatnonzero(valid)[rng.permutation(int(valid.sum()))[:b]]
    obs = (keys[near, :-1] + rng.normal(0, 0.1, (b, d - 1))).astype(np.float32)
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32)
    return keys, values, valid, obs, w


@pytest.mark.parametrize("n,b,dup,off", [(5000, 300, 1, 100),
                                         (20000, 1000, 50, 0),
                                         (3000, 1, 1, 0)])
def test_kernel_matches_plain(cuda, n, b, dup, off):
    keys, values, valid, obs, w = _store(np.random.default_rng(n), n, b, dup,
                                         off)
    t = [torch.as_tensor(a, device=cuda) for a in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    before = _cuda.LAUNCHES["peraction_moments"]
    got = K.query_peraction_prepared(prep, q)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["peraction_moments"] == before + 1
    _check_grid("peraction_moments")
    ref = K.peraction_moments_plain(prep, q)
    assert ref[..., 0].sum() > 0
    torch.testing.assert_close(got[..., 0], ref[..., 0], rtol=0, atol=0)
    torch.testing.assert_close(got[..., 1:], ref[..., 1:], rtol=1e-4, atol=1e-3)


@pytest.mark.parametrize("actions", [1, 11, 16])
def test_kernel_matches_plain_at_every_action_count(cuda, actions):
    """The main pass is instantiated for each number of actions: at 1, the
    fleet's 11 and the most, 16, on a store whose pieces mix every action
    (rows sorted by band cell and second dim, actions drawn at random)."""
    keys, values, valid, obs, w = _store(np.random.default_rng(actions),
                                         20000, 1500, A=actions)
    t = [torch.as_tensor(a, device=cuda) for a in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3],
                                     num_actions=actions)
    per_piece = (prep.piece_mom[:, 0::3] > 0).sum(1)
    assert int(per_piece.max()) == actions   # a piece holds every action
    q = torch.as_tensor(obs, device=cuda)
    got = K.query_peraction_prepared(prep, q)
    torch.cuda.synchronize()
    assert got.shape == (1500, actions, 3)
    _check_grid("peraction_moments")
    ref = K.peraction_moments_plain(prep, q)
    assert bool((ref[..., 0].sum(0) > 0).all())  # every action matched
    _check(got, ref)


def test_kernel_f64_route_matches_plain(cuda):
    """``out_dtype=float64`` (the sharded gated driver's route): the
    second pass writes the f64 sums unrounded; counts exact, sums to the
    plain version's f64 product, and rounded once they are the f32
    route's bits."""
    keys, values, valid, obs, w = _store(np.random.default_rng(64), 20000,
                                         1000)
    t = [torch.as_tensor(a, device=cuda) for a in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    got = K.query_peraction_prepared(prep, q, out_dtype=torch.float64)
    torch.cuda.synchronize()
    assert got.dtype == torch.float64
    ref = K.peraction_moments_plain(prep, q, out_dtype=torch.float64)
    assert ref[..., 0].sum() > 0
    assert torch.equal(got[..., 0], ref[..., 0])
    torch.testing.assert_close(got[..., 1:], ref[..., 1:], rtol=1e-12,
                               atol=1e-12)
    assert torch.equal(got.float(), K.query_peraction_prepared(prep, q))


def test_kernel_on_a_store_with_no_live_row(cuda):
    """The empty-store rule arm of improvement.evaluate_gated: 1e9 keys,
    none valid.  Every window is empty; the launch still runs and writes
    zeros, bit-equal to the plain version and to a second launch."""
    n = 1 << 14
    w = torch.as_tensor(DRIVING_HALF_WIDTHS, dtype=torch.float32, device=cuda)
    prep = K.prepare_peraction_store(
        torch.full((n, 21), 1e9, device=cuda), torch.zeros(n, device=cuda),
        torch.zeros(n, dtype=torch.bool, device=cuda), w, num_actions=11)
    q = torch.randn((300, 20), device=cuda) * 5 + 100
    before = _cuda.LAUNCHES["peraction_moments"]
    got = K.query_peraction_prepared(prep, q)
    again = K.query_peraction_prepared(prep, q)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["peraction_moments"] == before + 2
    ref = K.peraction_moments_plain(prep, q)
    assert not ref.any()
    assert torch.equal(got, ref) and torch.equal(again, got)


def test_kernel_on_a_sentinel_padded_region_cache(cuda):
    """A RegionCache.build store: the region's history rows, then 1e9 keys
    marked invalid up to the capacity; probes at region rows that lie
    inside the region (the cache is exact for in-region queries only)."""
    from dcarl_tpu_torch.workingset import RegionCache, build_life_history

    rng = np.random.default_rng(9)
    keys, values, _, _, w = _store(rng, 2000, 1)
    keys[:, 0] = 242.0 + rng.normal(0, 1.0, 2000)
    hk, hv = build_life_history(keys, values, np.arange(40) * 8.0)
    ck, cv, cvalid, n, idx = RegionCache(hk, hv, w, 1 << 15).build(400.0,
                                                                   25.0)
    assert 0 < n < (1 << 15) and not cvalid[n:].any()
    t = [torch.as_tensor(a, device=cuda) for a in (ck, cv, cvalid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    probes = hk[idx[rng.integers(0, n, 500)], :-1]
    probes = probes[np.abs(probes[:, 0] - 400.0) <= 25.0]
    q = torch.as_tensor(probes, device=cuda)
    got = K.query_peraction_prepared(prep, q.contiguous())
    torch.cuda.synchronize()
    _check(got, K.peraction_moments_plain(prep, q))
    # counts equal those against the whole history (no in-region row lost)
    full = K.box_query_moments_peraction(
        torch.as_tensor(hk, device=cuda), torch.as_tensor(hv, device=cuda),
        torch.ones(len(hk), dtype=torch.bool, device=cuda), q.contiguous(),
        t[3], num_actions=11)
    assert torch.equal(got[..., 0], full[..., 0])


def test_kernel_rejects_bad_operands(cuda):
    keys, values, valid, obs, w = _store(np.random.default_rng(0), 1000, 10)
    t = [torch.as_tensor(a, device=cuda) for a in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    with pytest.raises(TypeError):
        K.query_peraction_prepared(prep, q.half())
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep, q[:, :10])
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep, q.T.contiguous().T)
    small = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11,
                                      n_tile=128)
    with pytest.raises(ValueError):
        K.query_peraction_prepared(small, q)


# ---------------------------------------------------------------------------
# sorted_moments and box_moments
# ---------------------------------------------------------------------------


def _flat_store(rng, n, q, d, valid_p=0.7):
    keys = rng.normal(0, 5, (n, d)).astype(np.float32)
    values = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < valid_p
    # queries next to rows, so that they match something
    queries = (keys[rng.integers(0, n, q)]
               + rng.normal(0, 0.5, (q, d))).astype(np.float32)
    w = (np.abs(rng.normal(2, 1, d)) + 1.5).astype(np.float32)
    return keys, values, valid, queries, w


def _dense_sentinel_store(rng):
    """The store of tests/test_store_rls.py:499: dense-block writes leave
    VALID rows whose keys are the 1e9 sentinel."""
    d, a, qa = 5, 4, 300
    keys = rng.normal(0, 3, (4096, d)).astype(np.float32)
    keys[:, -1] = rng.integers(0, a, 4096)
    keys[rng.random(4096) < 0.5] = 1.0e9
    values = rng.normal(0, 1, 4096).astype(np.float32)
    obs = rng.normal(0, 3, (qa, d - 1)).astype(np.float32)
    qg = np.concatenate([np.broadcast_to(obs[None], (a, qa, d - 1)),
                         np.broadcast_to(np.arange(a, dtype=np.float32)
                                         [:, None, None], (a, qa, 1))], -1)
    w = np.asarray([2.0, 2.0, 2.0, 2.0, 0.1], np.float32)
    return keys, values, np.ones(4096, bool), np.ascontiguousarray(qg), w


def _check(got, ref):
    assert ref[..., 0].sum() > 0
    torch.testing.assert_close(got[..., 0], ref[..., 0], rtol=0, atol=0)
    torch.testing.assert_close(got[..., 1:], ref[..., 1:], rtol=1e-4,
                               atol=1e-3)


def _check_grid(name):
    """The launch reported its persistent grid: whole blocks per SM."""
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    assert _cuda.GRID[name] > 0 and _cuda.GRID[name] % sms == 0


@pytest.mark.parametrize("n,q,d", [(700, 40, 21), (20000, 3000, 21),
                                   (5000, 129, 5), (300, 1, 32)])
def test_sorted_kernel_matches_plain(cuda, n, q, d):
    arrs = _flat_store(np.random.default_rng(n + q), n, q, d)
    k, v, m, qq, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    before = _cuda.LAUNCHES["sorted_moments"]
    got = K.box_query_moments_sorted(k, v, m, qq, w)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sorted_moments"] == before + 1
    _check_grid("sorted_moments")
    ops, qorder = K.sorted_query_operands(k, v, m, qq, w)
    plain = K.sorted_moments_plain(ops)
    _check(got, torch.empty_like(plain).index_copy_(0, qorder, plain))
    # and the brute oracle
    _check(got, K.brute_moments_plain(k, v, m, qq, w))


def test_grouped_kernel_on_dense_sentinel_store(cuda):
    arrs = _dense_sentinel_store(np.random.default_rng(11))
    k, v, m, qg, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    got = K.box_query_moments_grouped(k, v, m, qg, w)
    torch.cuda.synchronize()
    ref = K.brute_moments_plain(k, v, m, qg.reshape(-1, 5), w).reshape(got.shape)
    _check(got, ref)
    assert ref[1:, :, 0].sum() > 0


@pytest.mark.parametrize("n,q,d", [(700, 40, 21), (9000, 1000, 21),
                                   (1000, 1, 5)])
def test_brute_kernel_matches_plain(cuda, n, q, d):
    arrs = _flat_store(np.random.default_rng(n), n, q, d)
    k, v, m, qq, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    before = _cuda.LAUNCHES["box_moments"]
    got = K.box_query_moments_brute(k, v, m, qq, w)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["box_moments"] == before + 1
    _check_grid("box_moments")
    _check(got, K.brute_moments_plain(k, v, m, qq, w))


def test_sorted_and_brute_reject_bad_operands(cuda):
    arrs = _flat_store(np.random.default_rng(0), 500, 10, 21)
    k, v, m, qq, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    ops, _ = K.sorted_query_operands(k, v, m, qq, w)
    with pytest.raises(TypeError):
        K.sorted_moments(ops._replace(q_t=ops.q_t.half()))
    with pytest.raises(ValueError):
        K.sorted_moments(ops._replace(q_t=ops.q_t.T.contiguous().T))
    with pytest.raises(ValueError):
        K.sorted_moments(ops._replace(keys_t=ops.keys_t[:, :-1].contiguous()))
    with pytest.raises(ValueError):
        K.sorted_moments(ops._replace(qb=ops.qb.cpu()))
    wide = torch.zeros((500, 33), device=cuda)
    with pytest.raises(ValueError):
        K.box_query_moments_brute(wide, v, m, torch.zeros((4, 33),
                                                          device=cuda),
                                  torch.ones(33, device=cuda))
    with pytest.raises(ValueError):
        K.box_query_moments_brute(k, v[:-1], m, qq, w)


# ---------------------------------------------------------------------------
# The chunked design: long windows, every key width, determinism, operands
# ---------------------------------------------------------------------------


def _lockstep_store(rng, n, q, d):
    """Rows packed around one state and ``q`` identical queries at it: a
    tile's window is every sub-slice, so it spreads over many chunks."""
    keys = rng.normal(0, 0.3, (n, d)).astype(np.float32)
    values = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    queries = np.zeros((q, d), np.float32)
    w = np.full(d, 0.5, np.float32)
    return keys, values, valid, queries, w


@pytest.mark.parametrize("q", [1, 129, 4096])
def test_sorted_kernel_long_window_over_few_tiles(cuda, q):
    arrs = _lockstep_store(np.random.default_rng(q), 1 << 16, q, 21)
    k, v, m, qq, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    ops, qorder = K.sorted_query_operands(k, v, m, qq, w)
    plan = K.sorted_plan(ops)
    per_tile = (plan.off[1:] - plan.off[:-1]).max()
    assert int(per_tile) >= 16  # one tile over many chunks
    got = K.sorted_moments(ops)
    torch.cuda.synchronize()
    ref = K.sorted_moments_plain(ops)
    assert float(ref[:, 0].min()) > 1000
    _check(got, ref)


@pytest.mark.parametrize("d", [1, 4, 5, 21, 32])
def test_sorted_and_brute_kernels_every_key_width(cuda, d):
    arrs = _flat_store(np.random.default_rng(100 + d), 6000, 500, d)
    if d == 1:
        arrs = arrs[:4] + (np.full(1, 0.2, np.float32),)
    k, v, m, qq, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    ref = K.brute_moments_plain(k, v, m, qq, w)
    _check(K.box_query_moments_sorted(k, v, m, qq, w), ref)
    _check(K.box_query_moments_brute(k, v, m, qq, w), ref)


def _plain_in_chunks(ops, chunk=1 << 14, out_dtype=torch.float32):
    """sorted_moments_plain over slices of the queries (its [Q, N]
    containment mask would not fit at once)."""
    return torch.cat([K.sorted_moments_plain(ops._replace(
        q_t=ops.q_t[:, i:i + chunk]), out_dtype)
        for i in range(0, ops.q_t.shape[1], chunk)])


def test_sorted_kernel_on_a_trust_set(cuda):
    """The trust-set trainer's query at the fleet's width: 2^14 D = 4 rows
    (a 3-wide encoding and the action) drawn with replacement from 512
    (state, action) pairs, half-widths (0.3, 0.3, 0.3, 0.1), and the
    11 candidate keys of 65,536 encodings (720,896 queries)."""
    rng = np.random.default_rng(14)
    enc = rng.normal(0, 2.0, (512, 3)).astype(np.float32)
    act = rng.integers(0, 11, 512).astype(np.float32)
    pick = rng.integers(0, 512, 1 << 14)
    keys = np.concatenate([enc[pick], act[pick, None]], 1)
    values = rng.normal(0, 10, 1 << 14).astype(np.float32)
    q_enc = (enc[rng.integers(0, 512, 65536)]
             + rng.normal(0, 0.2, (65536, 3))).astype(np.float32)
    queries = np.concatenate([np.repeat(q_enc, 11, 0), np.tile(
        np.arange(11, dtype=np.float32), 65536)[:, None]], 1)
    w = np.asarray([0.3, 0.3, 0.3, 0.1], np.float32)
    k, v, qq, ww = (torch.as_tensor(a, device=cuda)
                    for a in (keys, values, queries, w))
    m = torch.ones(1 << 14, dtype=torch.bool, device=cuda)
    ops, qorder = K.sorted_query_operands(k, v, m, qq, ww)
    before = _cuda.LAUNCHES["sorted_moments"]
    got = K.sorted_moments(ops)
    torch.cuda.synchronize()
    assert _cuda.LAUNCHES["sorted_moments"] == before + 1
    ref = _plain_in_chunks(ops)
    assert float(ref[:, 0].max()) > 32   # duplicated rows: many matches
    _check(got, ref)
    assert torch.equal(K.sorted_moments(ops), got)
    # the flat wrapper un-sorts to the caller's query order
    flat = K.box_query_moments_sorted(k, v, m, qq, ww)
    assert torch.equal(flat[qorder], got)


def test_peraction_kernel_long_window_over_few_tiles(cuda):
    rng = np.random.default_rng(5)
    keys, values, valid, obs, w = _store(rng, 1 << 16, 129)
    keys[:, :-1] = obs[0] + rng.normal(0, 0.1, (1 << 16, 20))
    t = [torch.as_tensor(a, device=cuda) for a in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(np.repeat(obs[:1], 129, 0), device=cuda)
    got = K.query_peraction_prepared(prep, q)
    torch.cuda.synchronize()
    ref = K.peraction_moments_plain(prep, q)
    assert float(ref[..., 0].sum(1).min()) > 1000
    _check(got, ref)


def _held_only_store(rng, n, b):
    """Rows packed within 0.05 of one state along every dim and queries
    within 0.1 of it: every query's box holds every piece's box (the
    narrowest obs half-width is 0.3), so every kept piece is held whole
    and no row is walked."""
    center = rng.normal(0, 4, 20).astype(np.float32)
    keys = np.zeros((n, 21), np.float32)
    keys[:, :-1] = center + rng.uniform(-0.05, 0.05, (n, 20))
    keys[:, -1] = rng.integers(0, 11, n)
    values = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    obs = (center + rng.uniform(-0.1, 0.1, (b, 20))).astype(np.float32)
    return keys, values, valid, obs, np.asarray(DRIVING_HALF_WIDTHS,
                                                np.float32)


@pytest.mark.parametrize("store", ["mixed", "held_only", "walk_heavy"])
def test_kernels_are_deterministic(cuda, store):
    """Two launches give the same bits: the sorted and brute kernels, and
    the per-action kernel on a mixed store, on one whose kept pieces are
    all held whole and on one of runs of 50 duplicates (most pairs
    walked); the counting instantiation gives the same bits too, and its
    counters say which path the store took."""
    from dcarl_tpu_torch.utils import profiling as PR

    arrs = _lockstep_store(np.random.default_rng(3), 1 << 15, 2000, 21)
    k, v, m, qq, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    qq = qq + torch.randn(qq.shape, device=cuda) * 0.2
    for fn in (K.box_query_moments_sorted, K.box_query_moments_brute):
        a, b = fn(k, v, m, qq, w), fn(k, v, m, qq, w)
        assert a[:, 0].sum() > 0 and torch.equal(a, b)
    rng = np.random.default_rng(4)
    if store == "held_only":
        keys, values, valid, obs, w = _held_only_store(rng, 20000, 3000)
    else:
        keys, values, valid, obs, w = _store(
            rng, 20000, 3000, dup=50 if store == "walk_heavy" else 1)
    t = [torch.as_tensor(x, device=cuda) for x in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    a = K.query_peraction_prepared(prep, q)
    b = K.query_peraction_prepared(prep, q)
    assert a[..., 0].sum() > 0 and torch.equal(a, b)
    PR.enable()
    try:
        first = PR.snapshot()["counters"]
        counted = K.query_peraction_prepared(prep, q)
        last = PR.snapshot()["counters"]
    finally:
        PR.enable(False)
    assert torch.equal(counted, a)
    got = {n: last[f"peraction_moments.{n}"] - first.get(
        f"peraction_moments.{n}", 0) for n in ("walked", "held")}
    if store == "held_only":
        assert got["walked"] == 0 and got["held"] == int(a[..., 0].sum())
    else:
        assert got["walked"] > 0


def test_malformed_records_are_rejected(cuda):
    arrs = _flat_store(np.random.default_rng(0), 500, 10, 21)
    k, v, m, qq, w = (torch.as_tensor(a, device=cuda) for a in arrs)
    ops, _ = K.sorted_query_operands(k, v, m, qq, w)
    with pytest.raises(ValueError):
        K.sorted_moments(ops._replace(rows=ops.rows[:, :22].contiguous()))
    with pytest.raises(ValueError):
        K.sorted_moments(ops._replace(rows=ops.rows[:-256].contiguous()))
    with pytest.raises(TypeError):
        K.sorted_moments(ops._replace(perm=ops.perm.long()))
    with pytest.raises(ValueError):
        K.sorted_moments(ops._replace(perm=ops.perm[:-1].contiguous()))
    keys, values, valid, obs, w = _store(np.random.default_rng(0), 1000, 10)
    t = [torch.as_tensor(x, device=cuda) for x in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep._replace(
            rows=prep.rows[:, :20].contiguous()), q)
    with pytest.raises(TypeError):
        K.query_peraction_prepared(prep._replace(perm=prep.perm.long()), q)
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep._replace(rows=prep.rows.T), q)
    with pytest.raises(ValueError):
        K.query_peraction_prepared(prep._replace(
            piece_box=prep.piece_box[:-1].contiguous()), q)
    with pytest.raises(TypeError):
        K.query_peraction_prepared(prep._replace(
            piece_mom=prep.piece_mom.float()), q)


def test_full_and_masked_stores_agree_bit_for_bit(cuda):
    """The kernel sums in f64 and rounds once, so a store and its copy
    with the rows no query reaches masked out give the same bits (the
    vehicle-life audit's device_bitwise_full_vs_masked), though the
    prepare cuts the two into different pieces."""
    rng = np.random.default_rng(7)
    keys, values, valid, obs, w = _store(rng, 20000, 2048)
    values = (values * 10.0 ** rng.integers(-2, 3, len(values))
              ).astype(np.float32)
    q = torch.as_tensor(obs, device=cuda)
    t = [torch.as_tensor(x, device=cuda) for x in (keys, values, valid, w)]
    full = K.prepare_peraction_store(t[0], t[1], t[2], t[3], num_actions=11)
    got = K.query_peraction_prepared(full, q)
    assert got[..., 0].sum() > 0
    reach = (torch.abs(t[0][:, None, :20] - q[None, :, :])
             <= t[3][:20]).all(-1).any(1)
    masked = K.prepare_peraction_store(t[0], t[1], t[2] & reach, t[3],
                                       num_actions=11)
    assert torch.equal(K.query_peraction_prepared(masked, q), got)
    assert torch.equal(got, K.peraction_moments_plain(full, q))
    wide = K.query_peraction_prepared(full, q, out_dtype=torch.float64)
    assert wide.dtype == torch.float64 and torch.equal(wide.float(), got)


def _lane_store(rng, n, b):
    """Lane-shaped rows: 20 clustered state dims at the field's
    half-widths (dim 1 the 0/1 ego lane), an integer action 0-7 in dim 20
    at w 0.1, a tenth invalid, values on a 2^-8 grid (every f64 sum of
    them and of their squares is exact, in any order); and the 8
    candidate keys of ``b`` states near the rows."""
    w = np.asarray(FIELD_HALF_WIDTHS, np.float32)
    centers = rng.normal(0, 1, (64, 21)) * w * 6
    keys = (centers[rng.integers(0, 64, n)]
            + rng.normal(0, 1, (n, 21)) * w).astype(np.float32)
    keys[:, 1] = rng.integers(0, 2, n)
    keys[:, -1] = rng.integers(0, 8, n)
    values = (np.round(rng.normal(0, 1, n) * 256) / 256).astype(np.float32)
    valid = rng.random(n) < 0.9
    near = rng.integers(0, n, b)
    obs = (keys[near, :20] + rng.normal(0, 0.5, (b, 20)) * w[:20])
    obs[:, 1] = keys[near, 1]
    queries = np.concatenate([np.repeat(obs, 8, 0), np.tile(
        np.arange(8), b)[:, None]], 1).astype(np.float32)
    return keys, values, valid, queries, w


def test_sorted_kernel_on_the_composite_band(cuda):
    """Lane-shaped operands (2^15 rows, the 8 candidate keys of 2,048
    states): the prepare bands on (action, second dim) with the bucketed
    middle level, and the kernel's answer, each query's copies added,
    equals the plain route's bit for bit.  With tracing on, the prepare
    counts a composite, bucketed prepare; the query counts the queries it
    asks as two copies; the kernel's matched total is the count it
    returned, and it walks under half the pairs it walks on the flat key
    (one valid row's action off the integers: neither the composite key
    nor the level, no query split).  A CUDA graph of
    ``query_sorted_prepared`` replays bit-equal to the eager call, for its
    captured queries and for new ones copied in, and neither the prepare
    nor the query synchronises with the host."""
    from dcarl_tpu_torch.utils import profiling as PR

    rng = np.random.default_rng(20)
    keys, values, valid, queries, w = _lane_store(rng, 1 << 15, 2048)
    flat_keys = keys.copy()
    flat_keys[np.flatnonzero(valid)[0], -1] += 0.25
    k, fk, v, m, qq, ww = (torch.as_tensor(a, device=cuda) for a in
                           (keys, flat_keys, values, valid, queries, w))
    nq = len(queries)
    runs = []
    PR.enable()
    try:
        for kk in (k, fk):
            first = PR.snapshot()["counters"]
            prep = K.prepare_sorted_store(kk, v, m, ww)
            ops, qorder = K.prepared_query_operands(prep, qq)
            got = K.sorted_moments(ops)
            last = PR.snapshot()["counters"]
            runs.append(({n: last[n] - first.get(n, 0) for n in last}, ops,
                         qorder, got))
    finally:
        PR.enable(False)
    (comp, ops, qorder, got), (flat, *_) = runs
    assert [comp[f"sorted_prepare.{n}"] for n in
            ("prepares", "composite", "bucketed")] == [1, 1, 1]
    assert [flat[f"sorted_prepare.{n}"] for n in
            ("prepares", "composite", "bucketed")] == [1, 0, 0]
    second = int((~torch.isnan(ops.q_t[-1]) & (qorder >= nq)).sum())
    assert comp["sorted_query.split"] == second > 0
    assert flat["sorted_query.split"] == 0
    assert comp["sorted_moments.matched"] == int(got[:, 0].sum()) > 0
    assert 0 < comp["sorted_moments.walked"] < 0.5 * flat["sorted_moments.walked"]

    prep = K.prepare_sorted_store(k, v, m, ww)
    assert bool(prep.composite) and bool(prep.bucketed)
    assert int(prep.sdim) == 20 and prep.copies == 2
    ops, qorder = K.prepared_query_operands(prep, qq)
    got = K.sorted_moments(ops, torch.float64)
    plain = _plain_in_chunks(ops, out_dtype=torch.float64)
    _check(got, plain)
    eager = K.query_sorted_prepared(prep, qq)
    assert torch.equal(eager, K.unsort_moments(got, qorder, nq))
    assert torch.equal(eager, K.unsort_moments(plain, qorder, nq))
    _check(eager, K.brute_moments_plain(k, v, m, qq, ww))

    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        again = K.query_sorted_prepared(K.prepare_sorted_store(k, v, m, ww),
                                        qq)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(again, eager)

    static_q = qq.clone()
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        K.query_sorted_prepared(prep, static_q)          # warm-up
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = K.query_sorted_prepared(prep, static_q)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    other = qq.flip(0) + 0.25 * torch.randn_like(qq) * ww
    static_q.copy_(other)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, K.query_sorted_prepared(prep, other))
