"""PyTorch port: the lane-level gated fleet
(``dcarl_tpu_torch/planning/lane_rollout.py``) and the prepared flat
sorted-band query it asks (``ops/store_kernels.py``).

On the CPU: a store prepared once answers every batch of queries as
``box_query_moments_sorted`` does, bit for bit; ``run_fn`` equals the
eager loop of the port's own lane functions tick by tick; and the
driver's first tick (the 20-D observation and candidate keys, the
moments of all 8 actions, the gate) agrees with the benchmark's plain
reference (``dcarl_bench/reference``).  Marked ``cuda`` (it skips here):
the compiled run equals the eager run bit for bit, one ``moments_main``
and one ``moments_sum`` a replayed tick.  On the card: ``python -m pytest
--noconftest tests/test_torch_lane_gated.py -m cuda``.  Nothing here
imports JAX.
"""

import functools
import hashlib

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_bench.reference import lane as ref_lane
from dcarl_bench.reference import store as ref_store
from dcarl_tpu_torch.config import StoreConfig
from dcarl_tpu_torch.core import rls as RLS
from dcarl_tpu_torch.core import store as ST
from dcarl_tpu_torch.env import multilane_env as ML
from dcarl_tpu_torch.ops import store_kernels as K
from dcarl_tpu_torch.planning import decision as DEC
from dcarl_tpu_torch.planning.lane_rollout import (fill_lane_store,
                                                   make_lane_gated_driver_fast)
from dcarl_tpu_torch.utils import graphs

CPU = torch.device("cpu")
HW = torch.tensor(ST.FIELD_HALF_WIDTHS, dtype=torch.float32)
# the reference's gate constants with thresholds a small store reaches,
# so the gate fires in a few ticks
GATE = StoreConfig(value_mode="nstep", visited_times_thres=1,
                   rl_visited_times_min=1, rule_good_thres=1e9)


@pytest.fixture(autouse=True)
def one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _gen(seed, device=CPU):
    return torch.Generator(device=device).manual_seed(seed)


def _stores():
    """(label, keys, values, valid): invalid rows, sentinel rows (dense
    block writes), and an empty store."""
    rng = np.random.default_rng(0)
    n = 700
    keys = rng.normal(0, 1, (n, 21)).astype(np.float32) \
        * np.asarray(ST.FIELD_HALF_WIDTHS, np.float32) * 3
    keys[:, -1] = rng.integers(0, 8, n)
    vals = rng.normal(5, 2, n).astype(np.float32)
    invalid = rng.random(n) < 0.3
    sentinel = keys.copy()
    sentinel[rng.random(n) < 0.25] = ST.SENTINEL_KEY
    t = torch.as_tensor
    return [("invalid rows", t(keys), t(vals), t(~invalid)),
            ("sentinel rows", t(sentinel), t(vals), t(np.ones(n, bool))),
            ("empty", torch.zeros((0, 21)), torch.zeros(0),
             torch.zeros(0, dtype=torch.bool))]


@pytest.mark.parametrize("store", _stores(), ids=lambda s: s[0])
def test_prepared_store_answers_as_box_query_moments_sorted(store):
    """One prepare, three batches of queries (one a partial tile, one
    empty): each bit-equal to a fresh ``box_query_moments_sorted`` call,
    counts equal to the brute ``_raw_moments``; asking leaves the
    prepared store unchanged."""
    _, keys, vals, valid = store
    prep = K.prepare_sorted_store(keys, vals, valid, HW)
    before = [x.clone() for x in prep if isinstance(x, torch.Tensor)]
    rng = np.random.default_rng(1)
    for q in (300, 128, 0):
        base = keys[rng.integers(0, max(len(keys), 1), q)] if len(keys) \
            else torch.zeros((q, 21))
        queries = base + torch.as_tensor(
            rng.normal(0, 0.5, (q, 21)).astype(np.float32)) * HW
        got = K.query_sorted_prepared(prep, queries)
        want = K.box_query_moments_sorted(keys, vals, valid, queries, HW)
        assert torch.equal(got, want), q
        brute = ST._raw_moments(keys, vals, valid, queries, HW)
        assert torch.equal(got[:, 0], brute[:, 0]), q
    after = [x for x in prep if isinstance(x, torch.Tensor)]
    assert all(torch.equal(a, b) for a, b in zip(before, after))


def _eager_lane_loop(st, keys, values, valid, n_ticks, gen, cfg):
    """The lane gate loop op by op, as ``chip_smoke.py``'s lane phase runs
    it: wrap_state -> all_action_stats -> act_test ->
    decision_from_discrete_action -> step_autoreset."""
    env_cfg = ML.MultiLaneEnvConfig()
    store = ST.ConfidenceStore(keys, torch.zeros_like(values), values,
                               valid.sum().to(torch.int32),
                               torch.zeros((), dtype=torch.int32))
    outs = []
    for _ in range(n_ticks):
        m = ML.to_multilane_state(st, env_cfg)
        a = RLS.act_test(RLS.all_action_stats(
            store, DEC.wrap_state(m), HW, 8, use_kernel=True), cfg)
        d = DEC.decision_from_discrete_action(m, a)
        st, r, done = ML.step_autoreset(st, d.target_lane_index,
                                        d.target_speed, gen, env_cfg)
        outs.append((r, done, st.collided, st.left_road, a))
    return st, [torch.stack(f) for f in zip(*outs)]


def _with_start_rows(store, start):
    """``store`` with a row appended at each candidate key of the envs'
    state ``start``: the rule's value 5, the others' uniform in [0, 9)."""
    cand = RLS.candidate_keys(DEC.wrap_state(ML.to_multilane_state(start)),
                              8).reshape(-1, 21)
    n = cand.shape[0]
    value = torch.where(cand[:, -1] == 0, 5.0, torch.rand(
        n, generator=_gen(7, cand.device), device=cand.device) * 9.0)
    return ST.store_insert(store, cand, cand[:, -1], value,
                           torch.ones(n, dtype=torch.bool, device=cand.device))


def test_run_fn_equals_the_eager_lane_loop():
    """16 envs x 6 ticks against a 512-row store that the fill wrote from
    the same starting envs, with a row for each of their first candidate
    keys appended (the rule's value 5, the others' uniform in [0, 9), so
    that the gate fires): outputs tick by tick, the final state and the
    generator bit-equal to the eager loop (the sorted-band query, the
    kernel's plain version here)."""
    store, written = fill_lane_store(store_cfg=GATE, envs=16, ticks=40,
                                     capacity=512, seed=5, device=CPU)
    assert int(store.size) == int(written) > 256
    store = _with_start_rows(store, ML.reset(16, _gen(5), device=CPU))
    assert int(store.size) == 512
    args = (store.keys, store.values, ST.store_valid(store))
    init_fn, run_fn = make_lane_gated_driver_fast(store_cfg=GATE, device=CPU)
    g1, g2 = _gen(6), _gen(6)
    carry, outs = run_fn(init_fn(16, _gen(5)), 6, *args, generator=g1)
    st, want = _eager_lane_loop(ML.reset(16, _gen(5), device=CPU), *args, 6,
                                g2, GATE)
    for got, ref in zip(outs, want):
        assert torch.equal(got, ref)
    for a, b in zip(carry, st):
        assert torch.equal(a, b)
    assert torch.equal(g1.get_state(), g2.get_state())
    assert (outs[4] > 0).any()


def test_fill_lane_store_wraps_its_ring_with_the_behaviour_policys_records():
    """16 envs x 40 ticks into a 256-row ring: more records written than
    rows, so the ring is full and its head where the count leaves it;
    each row's key ends in its action, about half of them the rule's;
    each value an n-step return of a reward of at most 1 a tick; the same
    seed fills the same store."""
    cfg = StoreConfig(value_mode="nstep")
    store, written = fill_lane_store(store_cfg=cfg, envs=16, ticks=40,
                                     capacity=256, seed=5, device=CPU)
    assert int(written) > 256
    assert int(store.size) == 256 and int(store.head) == int(written) % 256
    assert torch.equal(store.keys[:, -1], store.actions.to(torch.float32))
    assert 0.3 < float((store.actions == 0).float().mean()) < 0.7
    assert int(store.actions.max()) == 7
    most = sum(cfg.gamma ** i for i in range(cfg.n_step_window + 1))
    assert float(store.values.min()) >= 0.0
    assert float(store.values.max()) <= most + 1e-5
    again, _ = fill_lane_store(store_cfg=cfg, envs=16, ticks=40,
                               capacity=256, seed=5, device=CPU)
    assert all(torch.equal(a, b) for a, b in zip(store, again))


# sha256 (first 16 hex digits) of the grouped route's operands and query
# order on the lane fill of the tests below, as the route made them before
# the flat route took the bucketed middle level: the grouped route takes
# none, so they stay the same bits.
GROUPED_LANE_DIGEST = "0ecfb8698636a95e"
# The same of the one-batch flat route's (``sorted_query_operands``)
# operands and query order, and of ``box_query_moments_sorted``'s moments:
# a store prepared for one batch takes no middle level either.
FLAT_LANE_DIGESTS = ("492f48d91e72ac89", "7d790b809c5276b6")


def _digest(tensors) -> str:
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().numpy().tobytes())
    return h.hexdigest()[:16]


@functools.lru_cache(maxsize=1)
def _lane_fill():
    """A lane fill (128 envs x 128 ticks, the cell's fill length, into
    2^12 rows), its valid mask, and the candidate keys of 384 states near
    its rows and of 128 random lane states."""
    store, _ = fill_lane_store(store_cfg=StoreConfig(value_mode="nstep"),
                               envs=128, ticks=128, capacity=1 << 12, seed=7,
                               device=CPU)
    g = _gen(8)
    rows = torch.randint(0, 1 << 12, (384,), generator=g)
    near = store.keys[rows, :20] + torch.randn(384, 20, generator=g) * HW[:20]
    far = DEC.wrap_state(ML.to_multilane_state(_state(128, 9),
                                               ML.MultiLaneEnvConfig()))
    queries = RLS.candidate_keys(torch.cat([near, far]), 8).reshape(-1, 21)
    return store, ST.store_valid(store), queries


def test_prepared_lane_fill_bands_on_the_composite_key():
    """A lane fill (128 envs x 128 ticks, the cell's fill length, into
    2^12 rows): the prepare bands on the composite (action, dim 8) key
    with the bucketed middle level on dim 4 (the lane-0 front vehicle's
    s), and ``query_sorted_prepared`` answers candidate keys near the
    rows and of random lane states as the brute ``_raw_moments`` does:
    counts exact, sums within rtol 1e-4 / atol 1e-3.  The grouped route
    on (action, ego lane) takes no middle level: its operands are those
    it made before, bit for bit (``GROUPED_LANE_DIGEST``)."""
    store, valid, queries = _lane_fill()
    prep = K.prepare_sorted_store(store.keys, store.values, valid, HW)
    assert bool(prep.composite) and bool(prep.bucketed)
    assert (int(prep.sdim), int(prep.sdim2), int(prep.sdim3)) == (20, 8, 4)
    assert prep.copies == 2 and int(prep.n_b) >= 2
    got = K.query_sorted_prepared(prep, queries)
    want = ST._raw_moments(store.keys, store.values, valid, queries, HW)
    assert got[:, 0].sum() > 0
    assert torch.equal(got[:, 0], want[:, 0])
    torch.testing.assert_close(got[:, 1:], want[:, 1:], rtol=1e-4, atol=1e-3)
    ops, qorder = K.grouped_query_operands(store.keys, store.values, valid,
                                           queries[None], HW, -1, 1)
    assert ops.q_t.shape == (21, len(queries))
    assert _digest([*ops, qorder]) == GROUPED_LANE_DIGEST


def test_one_batch_flat_route_keeps_its_operands():
    """On the lane fill, whose prepared store takes the middle level, the
    flat route for one batch (``box_query_moments_sorted``, and
    ``sorted_query_operands``, what it launches) takes none: one copy a
    query, and its operands, query order and moments are those it made
    before the level, bit for bit (``FLAT_LANE_DIGESTS``); its moments
    equal the prepared route's."""
    store, valid, queries = _lane_fill()
    ops, qorder = K.sorted_query_operands(store.keys, store.values, valid,
                                          queries, HW)
    assert ops.q_t.shape == (21, len(queries))
    got = K.box_query_moments_sorted(store.keys, store.values, valid,
                                     queries, HW)
    assert (_digest([*ops, qorder]), _digest([got])) == FLAT_LANE_DIGESTS
    prep = K.prepare_sorted_store(store.keys, store.values, valid, HW)
    assert torch.equal(K.query_sorted_prepared(prep, queries), got)


def _state(b, seed):
    """Seeded random lane states: reset traffic, the ego anywhere on the
    road, between lanes and at any speed."""
    g = _gen(seed)
    st = ML.reset(b, g, device=CPU)
    u = [torch.rand(b, generator=g) for _ in range(4)]
    return st._replace(ego_s=u[0] * 300.0, ego_lane=u[1],
                       ego_speed=u[2] * 15.0, ego_vd=u[3] * 2.0 - 1.0,
                       step_count=torch.full((b,), 3, dtype=torch.int32))


def test_first_tick_agrees_with_the_plain_reference(monkeypatch):
    """The driver's first tick on seeded random envs and store rows (rows
    jittered around the envs' own candidate keys, some invalid, some far
    away): the query's keys equal the reference's observation || a, all
    8 actions' counts exact, sums within 1e-6, the gate's decision equal
    to the reference's Welch test; the gate fired."""
    b = 64
    st = _state(b, 11)
    obs = ref_lane.observation(st.ego_s, st.ego_lane, st.ego_speed,
                               st.ego_vd, st.veh_s, st.veh_lane, st.veh_speed)
    rng = np.random.default_rng(12)
    near = obs[rng.integers(0, b, 3000)]
    jitter = torch.as_tensor(rng.uniform(-1.2, 1.2, near.shape)
                             .astype(np.float32)) * HW[:-1]
    keys = torch.cat([near + jitter, torch.as_tensor(
        rng.integers(0, 8, (3000, 1)).astype(np.float32))], 1)
    keys[:200] += 500.0
    values = torch.as_tensor(rng.uniform(0, 9, 3000).astype(np.float32))
    valid = torch.as_tensor(rng.random(3000) > 0.1)

    seen = {}
    orig = K.query_sorted_prepared

    def probe(prep, queries):
        m = orig(prep, queries)
        seen.setdefault("queries", queries.clone())
        seen.setdefault("moments", m.clone())
        return m
    monkeypatch.setattr(K, "query_sorted_prepared", probe)
    init_fn, run_fn = make_lane_gated_driver_fast(store_cfg=GATE, device=CPU)
    _, outs = run_fn(st, 1, keys, values, valid, generator=_gen(13))

    acts = torch.arange(8, dtype=torch.float32)
    cand = torch.cat([obs[:, None, :].expand(b, 8, 20),
                      acts[None, :, None].expand(b, 8, 1)], 2)
    assert torch.equal(seen["queries"].reshape(b, 8, 21), cand)
    ref = ref_store.box_moments(keys, values, valid, obs, HW, 8, "f64")
    counts, err = ref_store.sum_errors(seen["moments"].reshape(b, 8, 3), ref)
    assert counts == 0 and err <= 1e-6 and ref[..., 0].sum() > 0
    gate = ref_store.gate(ref, dict(
        visited_times_thres=GATE.visited_times_thres,
        rl_visited_times_min=GATE.rl_visited_times_min,
        rule_good_thres=GATE.rule_good_thres,
        confidence_thres=GATE.confidence_thres))
    assert torch.equal(outs[4][0].to(torch.int64), gate)
    assert (gate > 0).any()


@pytest.mark.cuda
def test_compiled_lane_run_equals_eager_on_the_card():
    """1,024 envs x 8 ticks on a 2^14-row filled store (and rows at the
    envs' first candidate keys, so that the gate fires): the graphed run's
    outputs, carry and generator bit-equal to the eager loop of the same
    tick; one ``sorted_moments`` launch a tick by the counters, and one
    ``moments_main`` and one ``moments_sum`` kernel a replayed tick in a
    trace of a call that only replays."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (a CUDA graph is captured and "
                    "replayed only on the card)")
    from dcarl_tpu_torch import disable_tf32
    from dcarl_tpu_torch.ops import _cuda

    disable_tf32()
    cuda = torch.device("cuda")
    store, _ = fill_lane_store(store_cfg=GATE, envs=256, ticks=32,
                               capacity=1 << 14, seed=5, device=cuda)
    init_fn, run_fn = make_lane_gated_driver_fast(store_cfg=GATE,
                                                  device=cuda)
    carry = init_fn(1024, _gen(5, cuda))
    store = _with_start_rows(store, carry)
    args = (store.keys, store.values, ST.store_valid(store))
    runs = []
    for graphed in (True, False):
        g = _gen(6, cuda)
        _cuda.LAUNCHES.clear()
        out = (run_fn(carry, 8, *args, generator=g) if graphed else
               graphs.run_loop(run_fn.runner.tick, carry,
                               run_fn.inputs(*args), 8, g))
        torch.cuda.synchronize()
        runs.append((out, g.get_state(), dict(_cuda.LAUNCHES)))
    (c_g, o_g), gs_g, l_g = runs[0]
    (c_e, o_e), gs_e, l_e = runs[1]
    assert run_fn.runner.last.graph is not None
    assert all(torch.equal(a, b) for a, b in zip(o_g, o_e))
    assert all(torch.equal(a, b) for a, b in zip(c_g, c_e))
    assert torch.equal(gs_g, gs_e)
    assert l_g == l_e == {"sorted_moments": 8}
    assert (o_g[4] > 0).any()

    with torch.profiler.profile(activities=[
            torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]) as prof:
        run_fn(carry, 8, *args, generator=_gen(6, cuda))   # replays only
        torch.cuda.synchronize()
    names = [e.name for e in prof.events()
             if e.device_type == torch.autograd.DeviceType.CUDA]
    assert sum("moments_main" in n for n in names) == 8
    assert sum("moments_sum" in n for n in names) == 8
