"""PyTorch port: its tracing (``dcarl_tpu_torch/utils/profiling.py``) and
the benchmark's reader of it (``dcarl_bench/program_trace.py``).

On the CPU: the switch off is a no-op; on, an eager gated tick and a
train step show their phases as spans, in order, once each; a capture's
key holds the switch; the reader splits a synthetic trace's replays into
phases, drops a runner whose replays do not match its table, gives the
device time under each host span and the idle time by the innermost one;
and the per-action kernel's counts, worked out from its plan and tests
(:func:`peraction_counts_plain`), add up to the counts the query returns.

Marked ``cuda`` (they skip here): a replay's device events number its
phase table's total, the same number as a capture made with tracing off;
the kernels' counters equal the plain counts.  On the card: ``python -m
pytest --noconftest tests/test_torch_profiling.py -m cuda``.  Nothing
here imports JAX.
"""

import json
import os
import tempfile

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_bench import program_trace as P
from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch.config import DRIVING_HALF_WIDTHS
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.ops import store_kernels as K
from dcarl_tpu_torch.planning import fast_rollout as tfr
from dcarl_tpu_torch.train_fast import make_trainer_fast
from dcarl_tpu_torch.utils import graphs
from dcarl_tpu_torch.utils import profiling as PR

GATED_PHASES = ["plan", "query", "gate", "env_step"]
TRAIN_PHASES = ["draw", "plan", "rule_query", "propose_gate", "env_step",
                "store_write", "td_step"]
TRAIN_KW = dict(batch_per_device=4, store_capacity_per_device=512,
                replay_capacity_per_device=128)


@pytest.fixture(autouse=True)
def fresh_tracing(monkeypatch):
    """Each test starts with tracing off, no table and no counter, and
    leaves the module so."""
    monkeypatch.setattr(PR, "_ON", False)
    monkeypatch.setattr(PR, "_TABLES", {})
    monkeypatch.setattr(PR, "_TOTALS", {})
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _profiled(fn):
    """``fn()`` under a CPU ``torch.profiler``; its Chrome-trace events."""
    with torch.profiler.profile(
            activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    return [{"name": e.name, "ts": e.time_range.start} for e in prof.events()]


def _names_in_order(events, names):
    return [e["name"] for e in sorted(events, key=lambda e: e["ts"])
            if e["name"] in names]


def _spanned():
    with PR.span("dcarl.x"), PR.phase("plan"):
        torch.ones(2) + 1


def _store(n=256, seed=0):
    g = torch.Generator().manual_seed(seed)
    keys = torch.randn((n, 21), generator=g) * 5
    keys[:, -1] = torch.randint(0, 11, (n,), generator=g).float()
    return keys, torch.randn(n, generator=g), torch.ones(n, dtype=torch.bool)


# ---------------------------------------------------------------------------
# The switch, spans and phases on the CPU
# ---------------------------------------------------------------------------


def test_off_is_a_no_op():
    """Off: span and phase are one shared no-op context, a profiler sees
    nothing of them, the kernels get no counters, the snapshot is
    empty."""
    assert not PR.enabled()
    assert PR.span("a") is PR.phase("b") is PR.span("c")
    events = _profiled(_spanned)
    assert not _names_in_order(events, {"dcarl.x", "plan"})
    assert PR.counters("peraction_moments", torch.device("cpu")) is None
    assert PR.snapshot() == {"phases": {}, "counters": {}}


def test_on_off_the_card_spans_and_no_counters():
    """On, off a capture: a span and a phase are both profiler spans; no
    counters off the card."""
    PR.enable()
    assert PR.enabled()
    events = _profiled(_spanned)
    assert _names_in_order(events, {"dcarl.x", "plan"}) == ["dcarl.x", "plan"]
    assert PR.counters("sorted_moments", torch.device("cpu")) is None
    PR.enable(False)
    assert not PR.enabled()


def test_eager_gated_tick_shows_its_phases_in_order():
    """A traced CPU call of the gated driver (kernel route: the plain
    version) shows the store prepare, then each phase once, in order."""
    PR.enable()
    init_fn, run_fn = tfr.make_gated_driver_fast(t_intersection(),
                                                 device="cpu", use_kernel=True)
    g = torch.Generator().manual_seed(0)
    carry = init_fn(4, g)
    events = _profiled(lambda: run_fn(carry, 1, *_store(), generator=g))
    assert _names_in_order(events, {"dcarl.store_prepare", *GATED_PHASES}) \
        == ["dcarl.store_prepare"] + GATED_PHASES
    assert run_fn.runner.name == "gated"


def test_eager_train_step_shows_its_phases_in_order():
    PR.enable()
    init_t, step_t, _, factory = make_trainer_fast(tcfg.DCARLConfig(),
                                                   device="cpu", **TRAIN_KW)
    state = init_t(0)
    events = _profiled(lambda: step_t(state, torch.Generator().manual_seed(1)))
    assert _names_in_order(events, set(TRAIN_PHASES)) == TRAIN_PHASES
    assert factory(2).runner.name == "train"


@pytest.mark.parametrize("maker,name", [("rule_driver", "rule"),
                                        ("collector", "collector")])
def test_every_maker_names_its_runner(maker, name):
    run_fn = getattr(tfr, f"make_{maker}_fast")(t_intersection(),
                                                device="cpu")[1]
    assert run_fn.runner.name == name


def test_the_capture_key_holds_the_switch():
    """The same carry, inputs and step count take another capture when
    the switch has flipped, and the first one back when it flips back."""
    runner = graphs.TickRunner(lambda c, i, g: (c, ()), compiled=False)
    carry = (torch.zeros(3),)
    runner._load(carry, (), 4)
    off = runner.last
    PR.enable()
    runner._load(carry, (), 4)
    on = runner.last
    assert on is not off
    assert [k[-1] for k in runner._captures] == [False, True]
    PR.enable(False)
    runner._load(carry, (), 4)
    assert runner.last is off


@pytest.mark.parametrize("devices", [1, 2])
def test_snapshot_reads_the_totals_by_name(monkeypatch, devices):
    """Each counter by its name, in the kernels' layout (the per-action
    kernel's four first, the flat route's prepare and query last), summed
    over the devices that hold totals."""
    tot = torch.arange(PR._N_COUNTERS, dtype=torch.int64)
    totals = {torch.device("cpu"): tot}
    if devices == 2:
        totals[torch.device("cpu", 0)] = tot * 100
    monkeypatch.setattr(PR, "_TOTALS", totals)
    table = PR.PhaseTable((("plan", 0, 2),), 3)
    monkeypatch.setattr(PR, "_TABLES", {"gated": table})
    snap = PR.snapshot()
    assert snap["phases"] == {"gated": table}
    scale = 1 if devices == 1 else 101
    assert snap["counters"] == {k: i * scale for k, i in {
        "peraction_moments.walked": 0, "peraction_moments.matched": 1,
        "peraction_moments.held": 2, "peraction_moments.warp_rows": 3,
        "sorted_moments.walked": 4, "sorted_moments.matched": 5,
        "box_moments.walked": 6, "box_moments.matched": 7,
        "sorted_prepare.prepares": 8,
        "sorted_prepare.composite": 9, "sorted_prepare.bucketed": 10,
        "sorted_query.split": 11}.items()}


# ---------------------------------------------------------------------------
# The benchmark's reader on a synthetic trace
# ---------------------------------------------------------------------------

WINDOW = "dcarl_bench_traced"


def _x(name, cat, ts, dur, corr=None):
    ev = {"ph": "X", "name": name, "cat": cat, "ts": ts, "dur": dur}
    if corr is not None:
        ev["args"] = {"correlation": corr}
    return ev


def _replay(t0, corr, durs, gap=1.0):
    """A graph launch at ``t0`` and its device events, back to back with
    ``gap`` us between them (kernels, and a memcpy third)."""
    evs = [_x("cudaGraphLaunch", "cuda_runtime", t0, 2.0, corr)]
    t = t0 + 5.0
    for i, d in enumerate(durs):
        cat = "gpu_memcpy" if i == 2 else "kernel"
        evs.append(_x(f"k{i}", cat, t, d, corr))
        t += d + gap
    return evs


TABLE = PR.PhaseTable((("plan", 0, 2), ("query", 2, 4), ("writeback", 4, 5)),
                      5)


def _trace(durs_a=(10, 20, 30, 40, 5), durs_b=(12, 20, 34, 40, 5)):
    """A stretch [0, 1000) us: a store prepare launching one kernel, a
    replay span holding two graph launches (their device events overlap
    from 95 us on), and a result copy."""
    return [
        _x(WINDOW, "user_annotation", 0.0, 1000.0),
        _x("dcarl.store_prepare", "user_annotation", 10.0, 48.0),
        _x("cudaLaunchKernel", "cuda_runtime", 20.0, 3.0, 7),
        _x("sort", "kernel", 30.0, 25.0, 7),
        _x("dcarl.replay.gated", "user_annotation", 60.0, 100.0),
        *_replay(70.0, 11, durs_a),
        *_replay(90.0, 12, durs_b),
        _x("dcarl.result", "user_annotation", 600.0, 20.0),
        _x("cudaMemcpyAsync", "cuda_runtime", 605.0, 5.0, 13),
        _x("copy", "gpu_memcpy", 610.0, 10.0, 13),
    ]


def test_summarize_splits_each_replay_into_its_phases():
    out = P.summarize(_trace(), WINDOW, {"gated": TABLE})
    r = out["runners"]["gated"]
    assert r["replays"] == 2
    # plan: k0 start to k1 end = 10 + 1 + 20 (a), 12 + 1 + 20 (b)
    assert r["phases_s"]["plan"] == pytest.approx(np.mean([31, 33]) * 1e-6)
    assert r["phases_s"]["query"] == pytest.approx(np.mean([71, 75]) * 1e-6)
    assert r["phases_s"]["writeback"] == pytest.approx(5e-6)
    assert r["replay_s"] == pytest.approx(np.mean([109, 115]) * 1e-6)
    assert list(r["phases_s"]) == ["plan", "query", "writeback"]
    assert "train" not in out["runners"]


def test_summarize_drops_a_runner_whose_replay_misses_its_table():
    """A replay with one device event fewer than the table's total: no
    phases for that runner, everything else as before."""
    out = P.summarize(_trace(durs_b=(12, 20, 34, 40)), WINDOW,
                      {"gated": TABLE})
    assert out["runners"] == {}
    assert out["spans"]["dcarl.store_prepare"]["count"] == 1


def test_summarize_gives_device_time_under_each_host_span():
    out = P.summarize(_trace(), WINDOW, {"gated": TABLE})
    s = out["spans"]
    assert s["dcarl.store_prepare"] == {"count": 1, "device_s":
                                        pytest.approx(25e-6)}
    assert s["dcarl.replay.gated"]["device_s"] == pytest.approx(
        (105 + 111) * 1e-6)
    assert s["dcarl.result"]["device_s"] == pytest.approx(10e-6)
    assert out["window_s"] == pytest.approx(1e-3)


def test_summarize_puts_idle_time_under_the_innermost_span():
    """The device is busy over [30, 55), [75, 85), [86, 204), [205, 210)
    and [610, 620) us.  Each gap goes to the innermost ``dcarl.*`` span
    running when it began: [0, 30) and [620, 1000) to none, [55, 75) to
    the prepare, [85, 86) to the replay span, [204, 205) to a capture
    span, and [210, 610) to the load span nested inside it."""
    events = _trace() + [
        _x("dcarl.capture", "user_annotation", 200.0, 100.0),
        _x("dcarl.load", "user_annotation", 208.0, 50.0)]
    out = P.summarize(events, WINDOW, {"gated": TABLE})
    want = {"none": 410, "dcarl.store_prepare": 20, "dcarl.replay.gated": 1,
            "dcarl.capture": 1, "dcarl.load": 400}
    assert out["idle_s"] == pytest.approx({k: v * 1e-6
                                           for k, v in want.items()})
    assert out["spans"]["dcarl.load"] == {"count": 1, "device_s": 0.0}


def test_the_readers_read_the_program_part():
    program = P.summarize(_trace(), WINDOW, {"gated": TABLE})
    program["counters"] = {"peraction_moments.walked": 90,
                           "peraction_moments.matched": 20,
                           "peraction_moments.held": 10,
                           "sorted_moments.walked": 50,
                           "sorted_moments.matched": 0}
    m = {"trace": {"program": program}}
    assert P.phase_ms(m, "gated", "query") == pytest.approx(73e-3)
    assert P.phase_ms(m, "gated", "plan") == pytest.approx(32e-3)
    assert P.phase_ms(m, "train", "plan") is None
    assert P.span_ms_per_call(m, "dcarl.store_prepare") == pytest.approx(
        25e-3)
    assert P.walked_per_match(m, "peraction_moments") == pytest.approx(3.0)
    assert P.walked_per_match(m, "sorted_moments") is None
    assert P.idle_pct(m, "dcarl.replay.gated") == pytest.approx(
        100 * program["idle_s"]["dcarl.replay.gated"] / 1e-3)
    assert P.phase_ms({}, "gated", "plan") is None
    assert P.idle_pct({"trace": {}}, "dcarl.replay.gated") is None


@pytest.mark.parametrize("integer_action", [True, False])
def test_sorted_prepare_counts_itself_and_its_composite_key(
        monkeypatch, integer_action):
    """With the switch on, ``prepare_sorted_store`` adds one a call to
    ``sorted_prepare.prepares`` and, where it bands on the composite
    (action, second dim) key, to ``.composite``, and where that key holds
    the bucketed middle level (the third dim spans three buckets of 4 w),
    to ``.bucketed``: an integer action at w 0.1 does, one valid row off
    the integers does neither.  ``prepared_query_operands`` adds the
    queries it asks as two copies (a live second copy each) to
    ``sorted_query.split`` (the totals stand in on the CPU)."""
    tot = torch.zeros(PR._N_COUNTERS, dtype=torch.int64)
    monkeypatch.setattr(PR, "_TOTALS", {torch.device("cpu"): tot})
    monkeypatch.setattr(PR, "counters", lambda kernel, device: tot[
        PR._OFFSET[kernel]:PR._OFFSET[kernel] + len(PR.COUNTERS[kernel])])
    rng = np.random.default_rng(3)
    keys = rng.normal(0, 3, (600, 5)).astype(np.float32)
    keys[:, -1] = rng.integers(0, 8, 600)
    if not integer_action:
        keys[0, -1] += 0.25
    w = torch.tensor([2.0, 2.0, 2.0, 2.0, 0.1])
    queries = torch.as_tensor(keys[:300] + rng.normal(0, 1, (300, 5))
                              .astype(np.float32) * 0.5 * w.numpy())
    split = 0
    for _ in range(2):
        prep = K.prepare_sorted_store(torch.as_tensor(keys), torch.ones(600),
                                      torch.ones(600, dtype=torch.bool), w)
        ops, qorder = K.prepared_query_operands(prep, queries)
        second = qorder >= len(queries)
        split += int((~torch.isnan(ops.q_t[-1]) & second).sum())
    snap = PR.snapshot()["counters"]
    assert snap["sorted_prepare.prepares"] == 2
    assert snap["sorted_prepare.composite"] == (2 if integer_action else 0)
    assert snap["sorted_prepare.bucketed"] == (2 if integer_action else 0)
    assert snap["sorted_query.split"] == split
    assert (split > 0) == integer_action


def test_finish_gives_the_counters_over_the_stretch(monkeypatch):
    tot = torch.zeros(PR._N_COUNTERS, dtype=torch.int64)
    monkeypatch.setattr(PR, "_TOTALS", {torch.device("cpu"): tot})
    monkeypatch.setattr(PR, "_TABLES", {"gated": TABLE})
    first = P.start()
    tot += torch.arange(PR._N_COUNTERS) * 10
    out = P.finish(first, _trace(), WINDOW)
    assert out["counters"]["peraction_moments.held"] == 20
    assert out["counters"]["peraction_moments.warp_rows"] == 30
    assert out["counters"]["box_moments.matched"] == 70
    assert out["runners"]["gated"]["replays"] == 2


# ---------------------------------------------------------------------------
# The per-action kernel's counts, worked out from its plan and tests
# ---------------------------------------------------------------------------


def peraction_counts_plain(prep, queries):
    """(walked, matched, held, warp_rows) that
    ``csrc/peraction_moments.cu`` counts for ``queries``: for each query
    and each piece of a sub-slice its tile keeps inside its window, the
    piece settled whole (its live rows' count moments held) or undecided
    (its live rows walked, the matching ones' count moments matched); the
    tests are the kernel's, in f32.  ``warp_rows``: the live rows of each
    walked piece, once for every warp (32 consecutive sorted queries of a
    128-query tile) that holds a query undecided on it."""
    obs = prep.w_col.shape[0]
    dev = queries.device
    qorder, qext = K.query_operands(prep, queries)
    plan = K.peraction_plan(prep, qext)
    sub = torch.arange(prep.kb.shape[1], device=dev)
    keep = K.prune_keep(prep, qext) & (sub >= plan.s_lo[:, None].long()) \
        & (sub < plan.s_hi[:, None].long())
    per_sub = prep.sub_n // K._PA_PIECE_N
    b = queries.shape[0]
    kept = keep.repeat_interleave(per_sub, dim=1)[
        torch.arange(b, device=dev) // K._QT]                # [B, pieces]
    perm = prep.perm.long()
    q = queries[qorder][:, perm]                             # record order
    w = prep.w_col[perm]
    lo, hi = prep.piece_box[:, :obs], prep.piece_box[:, obs:]
    a = q[:, None, :] - lo[None]
    c = q[:, None, :] - hi[None]
    whole = ((a.abs() <= w) & (c.abs() <= w)).all(-1)
    none = ((c > w) | (a < -w)).any(-1)
    piece_count = prep.piece_mom[:, 0::3].sum(1)
    held = (kept & whole).double() @ piece_count
    open_pc = kept & ~whole & ~none                          # [B, pieces]
    live = prep.row_act >= 0
    walk = open_pc.repeat_interleave(K._PA_PIECE_N, dim=1) \
        & live[None]                                         # [B, n_pad]
    match = torch.ones_like(walk)
    for d in range(obs):
        match &= torch.abs(queries[qorder][:, d:d + 1]
                           - prep.keys_t[d][None]) <= prep.w_col[d]
    matched = (walk & match).double() @ prep.row_mom[0].double()
    pad = -b % K._QT           # dead slots of the last tile: never open
    warp_open = torch.cat([open_pc, open_pc.new_zeros(pad, open_pc.shape[1])]
                          ).reshape(-1, 32, open_pc.shape[1]).any(1)
    warp_rows = warp_open.double() @ live.reshape(-1, K._PA_PIECE_N).sum(
        1).double()
    return (int(walk.sum()), int(matched.sum()), int(held.sum()),
            int(warp_rows.sum()))


def _dup_store(rng, n, b, dup):
    """A store of clustered keys with runs of ``dup`` identical rows, and
    queries next to valid rows (``tests/test_torch_kernels_cuda.py``)."""
    d, a_n = 21, 11
    centers = rng.normal(0, 4, (32, d - 1)).astype(np.float32)
    keys = np.zeros((n, d), np.float32)
    keys[:, :-1] = centers[rng.integers(0, 32, n)] \
        + rng.normal(0, 1.0, (n, d - 1))
    keys[:, -1] = rng.integers(0, a_n, n)
    keys = np.repeat(keys[: n // dup], dup, axis=0)[:n]
    values = rng.normal(0, 1, n).astype(np.float32)
    valid = rng.random(n) < 0.9
    near = np.flatnonzero(valid)[rng.permutation(int(valid.sum()))[:b]]
    obs = (keys[near, :-1] + rng.normal(0, 0.1, (b, d - 1))).astype(np.float32)
    w = np.asarray(DRIVING_HALF_WIDTHS, np.float32)
    return keys, values, valid, obs, w


@pytest.mark.parametrize("dup", [1, 20])
def test_plain_counts_add_up_to_the_returned_counts(dup):
    """Matched by walking plus held whole equals the count moments the
    query returns, exactly, with and without collapsed duplicates; the
    kernel walks at least the rows it matches."""
    rng = np.random.default_rng(dup)
    keys, values, valid, obs, w = _dup_store(rng, 3000, 300, dup)
    t = [torch.as_tensor(x) for x in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(*t, num_actions=11, n_tile=512)
    q = torch.as_tensor(obs)
    walked, matched, held, warp_rows = peraction_counts_plain(prep, q)
    total = K.peraction_moments_plain(prep, q)[..., 0].double().sum()
    assert total > 0 and matched + held == int(total)
    assert walked > 0
    # a warp walks a row for at most its 32 queries, and for at least one
    assert warp_rows <= walked <= 32 * warp_rows
    if dup == 1:    # every live row weighs 1
        assert matched <= walked


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (graph capture and the CUDA "
                    "kernels run only on the card)")
    from dcarl_tpu_torch import disable_tf32

    disable_tf32()
    return torch.device("cuda")


def _replay_events(run):
    """The device events of each graph launch of ``run()`` (profiled,
    synchronised), by launch; and the program's summary of the stretch."""
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        with torch.profiler.record_function(WINDOW):
            run()
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            events = json.load(f)["traceEvents"]
    finally:
        os.unlink(path)
    launches = {P._corr(ev) for ev in events
                if ev.get("name") == "cudaGraphLaunch"}
    per = {c: [] for c in launches}
    for ev in events:
        if ev.get("cat") in ("kernel", "gpu_memcpy", "gpu_memset") \
                and P._corr(ev) in per:
            per[P._corr(ev)].append(ev)
    replays = [[ev["name"] for ev in sorted(evs, key=lambda ev: ev["ts"])]
               for evs in per.values()]
    return replays, P.summarize(events, WINDOW, PR.snapshot()["phases"])


@pytest.mark.cuda
def test_replays_number_their_phase_table_on_the_card(cuda):
    """64 envs x 8 ticks of the gated driver and 8 trainer steps, each run
    a second time (8 replays) under the profiler: each replay's device
    events number its capture's table total, which is the count of a
    capture made with tracing off; the phases come in the makers' order
    and fit inside a replay's span."""
    rng = np.random.default_rng(0)
    n = 1 << 10
    keys = np.zeros((n, 21), np.float32)
    keys[:, :-1] = rng.normal(0, 1, (n, 20)) * 20 + 100
    keys[:, -1] = rng.integers(0, 11, n)
    store = [torch.as_tensor(x, device=cuda) for x in (
        keys, rng.normal(0, 1, n).astype(np.float32), np.ones(n, bool))]
    init_fn, run_fn = tfr.make_gated_driver_fast(t_intersection())
    carry = init_fn(64, torch.Generator(device=cuda).manual_seed(0))
    t_init, _, _, factory = make_trainer_fast(
        tcfg.DCARLConfig(store=tcfg.driving_store_config()),
        batch_per_device=64, store_capacity_per_device=n,
        replay_capacity_per_device=n, backfill_budget_per_step=64)
    train_run, state = factory(8), t_init(seed=0)

    def gated():
        run_fn(carry, 8, *store,
               generator=torch.Generator(device=cuda).manual_seed(1))

    def train():
        train_run(state, torch.Generator(device=cuda).manual_seed(1))

    for name, run, phases, query, kernel in (
            ("gated", gated, GATED_PHASES, "query", "peraction_"),
            ("train", train, TRAIN_PHASES, "rule_query", "moments_")):
        run()                                   # capture, tracing off
        off, _ = _replay_events(run)
        PR.enable()
        run()                                   # capture anew, on
        on, summary = _replay_events(run)
        PR.enable(False)
        table = PR.snapshot()["phases"][name]
        assert [p[0] for p in table.phases] == phases + ["writeback"]
        assert [len(r) for r in off] == [len(r) for r in on] \
            == [table.nodes] * 8, name
        # the store kernel's two passes, and nothing else of it, fall in
        # the query phase's nodes of every replay
        first, end = next((f, e) for p, f, e in table.phases if p == query)
        for names in on:
            inside = [i for i, n in enumerate(names) if kernel in n]
            assert len(inside) == 2 and all(first <= i < end
                                             for i in inside), name
        split = summary["runners"][name]
        assert split["replays"] == 8
        assert sum(split["phases_s"].values()) <= split["replay_s"] * 1.0001


@pytest.mark.cuda
@pytest.mark.parametrize("dup", [1, 50])
def test_kernel_counters_equal_the_plain_counts(cuda, dup):
    """The per-action kernel's walked, matched, held and warp_rows counts
    equal the plain counts at small sizes, and matched plus held equals the
    count moments it returned; the sorted kernel's matched count equals its
    returned count, its walked count the plain one."""
    rng = np.random.default_rng(dup)
    keys, values, valid, obs, w = _dup_store(rng, 20000, 1000, dup)
    t = [torch.as_tensor(x, device=cuda) for x in (keys, values, valid, w)]
    prep = K.prepare_peraction_store(*t, num_actions=11)
    q = torch.as_tensor(obs, device=cuda)
    PR.enable()
    first = PR.snapshot()["counters"]
    got = K.query_peraction_prepared(prep, q)
    last = PR.snapshot()["counters"]
    PR.enable(False)
    diff = {k: last[k] - first.get(k, 0) for k in last}
    plain = peraction_counts_plain(prep, q)
    assert tuple(diff[f"peraction_moments.{k}"] for k in
                 ("walked", "matched", "held", "warp_rows")) == plain
    walked, matched, held, _ = plain
    assert matched + held == int(got[..., 0].double().sum())
    assert matched > 0

    ops, _ = K.sorted_query_operands(
        t[0], t[1], t[2], torch.cat([q, torch.zeros_like(q[:, :1])], 1),
        t[3])
    PR.enable()
    first = PR.snapshot()["counters"]
    out = K.sorted_moments(ops)
    last = PR.snapshot()["counters"]
    PR.enable(False)
    plan = K.sorted_plan(ops)
    live_rows = (ops.valid != 0).reshape(-1, K._SSUB_N).sum(1).cumsum(0)
    live_rows = torch.cat([live_rows.new_zeros(1), live_rows])
    n_q = ops.q_t.shape[1]
    per_tile = torch.clamp(n_q - torch.arange(plan.s_lo.shape[0],
                                              device=cuda) * K._SQT,
                           max=K._SQT)
    walked = int(((live_rows[plan.s_hi.long()] - live_rows[plan.s_lo.long()])
                  * per_tile).sum())
    assert last["sorted_moments.walked"] - first["sorted_moments.walked"] \
        == walked
    assert last["sorted_moments.matched"] - first["sorted_moments.matched"] \
        == int(out[:, 0].double().sum()) > 0
