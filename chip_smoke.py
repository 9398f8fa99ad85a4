#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main paths through the CUDA kernels hand-written for
Hopper, at the sizes the JAX package's benchmark (``bench.py``) and its
closed-loop CLIs (``examples/run_improvement.py``,
``examples/run_vehicle_life.py``) use for them, and checks them:

  device        torch / CUDA versions, the card's name and power limit
  build         nvcc builds every kernel from csrc/, one process per source
  kernels       each kernel against its plain PyTorch version on small
                stores: peraction_moments (random with off-lattice rows,
                50x duplicated), sorted_moments (flat on a random store,
                grouped on a random 11-action store and on a dense-block
                store with valid sentinel rows, D = 5), box_moments
                (random).  Counts exact, sums within rtol 1e-4 / atol 1e-3
  store fill    the rule driver at 16,384 envs x 16 ticks makes a
                2^18-row store from its observations
  gated path    gated driver, 65,536 envs x 50 ticks, against that store:
                one peraction_moments launch per tick, the gate fires; a
                replay times each launch with CUDA events
  gated e2e     256 envs x 10 ticks, kernel route == brute route
  train path    the lane-major trainer at 32,768 envs (store and replay
                2^16, backfill budget 8,192, kernel route): 20 warm-up
                steps, then 20 timed steps from a snapshot; one
                sorted_moments launch per step; a replay from the same
                snapshot times each launch
  train kernels sorted_moments (grouped) and box_moments against their
                plain versions on the trainer-built store, 4,096 queries
  train e2e     256 envs x 40 steps in 20-step episodes, kernel route ==
                brute route from the same state with the same draws: store
                and integer outputs
  trainer store the trainer at 16,384 envs x 300 steps fills a 2^18-row
                store (the store bench.py serves from), each sorted_moments
                launch timed; sorted_moments (grouped) against its plain
                version on that store, 4,096 of the fleet's last
                observations; the gated driver runs 65,536 envs x 50 ticks
                against it
  sharded       world size 1 through NCCL in this process (a one-rank
                group; NCCL's all-gather, reduce-scatter and all-reduce
                checked on the card): the trainer over the mesh from the
                train path's snapshot, 32,768 envs x 20 steps, bit-equal
                to the unsharded steps (store and integer outputs), one
                sorted_moments launch a step; the gated driver over the
                mesh on the trainer-built store, 65,536 envs x 50 ticks,
                bit-equal to the unsharded run on all six outputs, one
                peraction_moments launch a tick; then two gloo ranks on
                the one card (parallel.launch.run_ranks): the gated driver
                at 32,768 envs a rank against its stripe of the same
                store (zero reset jitter from the jittered starts),
                executed and gated actions equal to the one-rank run on
                the whole batch, tick 0's reduced moments against one
                launch on the whole store; the trainer at 2 x 16,384
                envs x 20 steps, parameters bit-equal across the ranks
                after every step, its reduced rule-column moments against
                one sorted_moments launch on the merged store.  Rates of
                the two-rank run are a correctness run, not a scaling
                figure
  empty store   peraction_moments on 2^17 rows of 1e9 keys, none valid
                (the closed loop's rule arm): zeros, bit-equal to its
                plain version and to a second launch
  improvement   improvement.run_improvement at examples/run_improvement.py's
                defaults: train 2,048 envs x 2,000 steps (store 2^17), then
                the empty-store and the gated fleet, 1,024 envs x 400 ticks;
                one sorted_moments launch per step, one peraction_moments
                launch per tick; activation only in the gated arm; in
                each call, the last sorted_moments launch and the
                peraction_moments launch with the most matches (the
                trained store and the fleet's queries) against their
                plain versions; the gated arm 256 envs x 20 ticks, kernel
                route == brute route
  two session   run_two_session_improvement at 2,048 envs, store 2^17,
                backfill budget 4,096, 1,008 steps a session (cut from
                2,000); the evidence transfers and the activation is
                retained; the same launches of each call against their
                plain versions (session B's store rebuilt from text
                included), and the deployment from B's reloaded store
                kernel route == brute route; save -> restore -> 3 steps
                bit-equal to the uninterrupted run, learner included
  vehicle life  run_vehicle_life at WORKINGSET_r05.json's widths (65,536
                envs, 50-tick chunks, a 2^18-row cache over a 4.5 M-row
                history from the collector at 4,096 envs x 2,048 steps),
                24 chunks (cut from 120) and one audit, whose full and
                region-masked histories must give the same bits on the
                card (device_bitwise_full_vs_masked); then
                peraction_moments against its plain version on a
                sentinel-padded region cache
  trustset      models/segment.make_trustset_trainer at the JAX defaults
                (64 envs, batch 32, replay and trust set 2^14) for 1,000
                steps: one sorted_moments launch (D = 4) per trained step,
                none in warm-up, 2^14 trust-set rows; the launch with the
                most matches against its plain version and again
                bit-equal; 20 steps from a step-600 snapshot, kernel route
                == brute route; the trained set served to 65,536 rule-fleet
                observations (720,896 queries a launch) through act_ts,
                act_ts_explore and hybrid_act, each launch timed, 4,096 of
                its queries against the plain version; the golden
                confidence core on a 20,000-row stream, the card against
                the CPU, the golden core on a one-state 20,000-row
                stream on the card against the CPU, and
                running_update_batch over 4,096 streams
  readable      the readable batch-first drivers (planning/rollout.py)
                against the lane-major ones, float64, 1,024 envs x 300
                ticks at reset_jitter 0 from jittered starts: the rule
                drivers (rewards within rtol 1e-9, done / passed /
                collided bit-equal, episodes end) and the collectors
                (used_action, rule_index, recorded_state and
                episode_return too); each collector's records through
                workingset.episode_rows into a per-action store, one
                peraction_moments launch on each (the readable driver's
                tick-300 observations and the rows' own states as
                queries): bit-equal to each other and within tolerance of
                the plain version; the readable and the fast rule driver
                timed in float32 at 65,536 envs x 50 ticks
  lane          the multilane world (MultiLaneEnvConfig(): 2 lanes, 8
                vehicles, 5 Hz): the rule loop at 65,536 envs x 200 ticks;
                StoreConfig()'s 2^17-row store filled by a behaviour
                policy (rule half the time) at 2,048 envs x 128 ticks,
                n-step returns, the ring wrapping once; the gated loop
                (wrap_state -> all_action_stats -> act_test ->
                decision_from_discrete_action) at 65,536 envs x 50 ticks,
                one sorted_moments launch (524,288 queries, D = 21) a
                tick; the first tick's launch against the plain version
                on 4,096 envs (counts exact, sums within rtol 1e-4 / atol
                1e-3, equal gated actions) and again bit-equal; a replay
                times each launch
  field         16,384 egos with 8 tracked objects each on a 2-lane loop
                map, 50 ticks at 5 Hz of window_static_map ->
                update_map_state -> lateral_decision -> wrap_state ->
                get_trajectory -> get_safeguard_speed -> path buffer and
                route hazard; 256 egos of every fifth tick rerun on the
                CPU (integer outputs equal, reals within rtol 1e-5 / atol
                1e-4); an OpenDrive network parsed in the script,
                LocalHdMap -> update_map_state for 1,024 egos, held to
                the CPU the same way
  algos         the algorithm family (algos/): each learner trains at
                tests/test_algos.py's configuration, update count and
                threshold (DDPG and TD3 from each of seeds 0-7, at least
                one clearing it; A2C, PPO, PPO continuous, PPO1, TRPO,
                ACKTR, ACER, GAIL, SAC and HER-DQN from seed 0), timed
                (seconds an update, env-steps/s); three updates of each on
                the card and on the CPU from one init on the same draws
                (integers equal, floats within the CPU tests'
                tolerances) and a 256-env rollout's sampled actions card
                vs CPU; PPO at the published width, 4,096 envs x 32
                steps; PPO over two gloo ranks on the card (bit-equal
                across the ranks, on shared draws equal to one rank).
                No store kernel on this path
  vec           TorchVecEnv at 1,024 T-intersection envs x 50 steps
                through VecCheckNan(VecMonitor(.)), bit-equal to the
                direct step_fn from the same seed; the calibration tables
                and feedforward commands on the card against the CPU; a
                torch.profiler trace of one PPO update (CUDA kernel
                events, the device's busy share); nan_guard over every
                trained learner's state
  host          the C++ host library (utils/native.py) built with g++ from
                csrc/dcarl_host.cpp into build/torch_host/ (its seconds
                reported); a HostBoxStore of the agent's 2^17 rows at
                D = 21: 1,024 single grid-hash queries against the exact
                scan (counts equal, moments within 1e-12) and both against
                box_query_stats on the card (one sorted_moments launch;
                counts exact, means and variances within rtol 1e-4 / atol
                1e-3), microseconds a host query beside milliseconds a card
                call; a 2^17 x 22 f64 array through RecordLog,
                AsyncLogWriter, npy_mmap and NpyStream, byte-equal
  bridge        the DCARL agent (bridge/agent_session.py) at the example's
                widths (StoreConfig(), replay 2^16, MLPQNet 8 x 128)
                served over TCP by bridge/agent_server.py: a cold first
                tick timed on a throwaway session, whose training ticks
                past its first SGD steps wait for the card once each; the
                ported selftest (400 ticks, training) with ticks/s and
                round-trip latency, then its ticks again in its logged
                order on the card (actions equal, losses within rtol 1e-5
                / atol 1e-6) and on the CPU from the card's learner state
                of each tick (the same); then test mode on a full store
                of the agent's rows, 4 concurrent planners x 64 messages,
                equal to a CPU session replaying the card's order of
                arrival, a card replay timing each launch; one
                sorted_moments launch (8 queries, D = 21) a tick in both
                served runs; the tick's launch against the plain version
                and again bit-equal; a traced stretch of ticks (one sync
                a tick, kernels, device busy share).  The clients fall
                back to -1 and the served policy records any exception: a
                fallback, an exception or a tick count other than the
                requests fails the phase

Each rate comes from a run without probes; a replay of the same run then
times each launch and reports its plan (kept and window sub-slices per
query tile, chunks, scratch bytes, the persistent grid) and, for
peraction_moments, how many (query, kept 128-row piece) pairs settle
whole.  The 4,096-query checks repeat the launch (bit-equal outputs) and
report the share of (32-query warp, examined row) pairs in which no
query matches.

Prints one line per phase, a JSON line of kernel numbers, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or without the package beside it.

    python3 chip_smoke.py
    python3 chip_smoke.py --only lane,field   # build, then those phases
    python3 chip_smoke.py --only algos,vec
    python3 chip_smoke.py --only bridge,host  # the host layer and the agent
"""

from __future__ import annotations

import contextlib
import json
import math
import os
import shutil
import subprocess
import sys
import tempfile
import time
from typing import NamedTuple

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
FP64_OPS_PER_S = 34e12        # H100 SXM FP64 outside the tensor cores
MOMENT_TOL = dict(rtol=1e-4, atol=1e-3)
SEED = 0


def fail(msg: str):
    raise SystemExit(f"chip_smoke: FAIL: {msg}")


def emit(phase: str, **fields):
    print(f"[{phase}] " + json.dumps(fields), flush=True)


def gpu_line() -> str:
    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60).stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int = 3) -> float:
    """Mean milliseconds of ``fn()`` on the card, after one warm-up."""
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def compare(got: torch.Tensor, ref: torch.Tensor, what: str) -> float:
    if got.shape != ref.shape:
        fail(f"{what}: shape {tuple(got.shape)} != {tuple(ref.shape)}")
    if not torch.equal(got[..., 0], ref[..., 0]):
        fail(f"{what}: counts differ")
    if not torch.allclose(got[..., 1:], ref[..., 1:], **MOMENT_TOL):
        fail(f"{what}: sums differ beyond rtol 1e-4 / atol 1e-3")
    if ref[..., 0].sum() <= 0:
        fail(f"{what}: no query matched any row")
    return float((got - ref).abs().max())


def bound_ms(n_bytes: float, n_ops: float):
    """(bound in ms, what bounds it): the larger of bytes over the HBM
    rate and FP32 operations over the FP32 peak."""
    b, o = n_bytes / HBM_BYTES_PER_S * 1e3, n_ops / FP32_OPS_PER_S * 1e3
    return max(b, o), ("operations" if o >= b else "bytes")


def small_stores(rng, w_driving):
    """The per-action kernel's small stores: random with off-lattice
    action rows, and 40 keys each repeated 50x with a stale invalid tail."""
    d, a = 21, 11
    obs = rng.normal(0, 5, (48, d - 1)).astype(np.float32)
    keys = np.zeros((2000, d), np.float32)
    keys[:, :-1] = obs[rng.integers(0, 48, 2000)] + rng.normal(0, 1, (2000, d - 1))
    keys[:, -1] = rng.integers(0, a, 2000)
    keys[:100, -1] = a + 3
    w = (np.abs(rng.normal(2, 1, d)) + 1.5).astype(np.float32)
    w[-1] = 0.1
    yield ("random_off_lattice", keys, rng.normal(0, 1, 2000).astype(np.float32),
           rng.random(2000) < 0.7, obs, w)

    base = rng.normal(0, 5, (40, d)).astype(np.float32)
    base[:, -1] = rng.integers(0, a, 40)
    keys = np.repeat(base, 50, axis=0)[rng.permutation(2000)]
    keys = np.concatenate([keys, rng.normal(0, 5, (37, d)).astype(np.float32)])
    vals = np.concatenate([rng.normal(0, 1, 2000), np.ones(37)]).astype(np.float32)
    q = (base[rng.integers(0, 40, 16), :-1]
         + rng.normal(0, 0.2, (16, d - 1))).astype(np.float32)
    yield ("dup50", keys, vals, np.arange(2037) < 2000, q, w_driving)


def _group(obs: np.ndarray, a: int) -> np.ndarray:
    """[A, B, D+1] keys obs || action for every action."""
    b, d1 = obs.shape
    return np.ascontiguousarray(np.concatenate([
        np.broadcast_to(obs[None], (a, b, d1)),
        np.broadcast_to(np.arange(a, dtype=np.float32)[:, None, None],
                        (a, b, 1))], axis=-1))


def band_stores(rng):
    """The sorted kernel's small stores (the inputs of the JAX package's
    tests/test_store_rls.py :77, :106 and :499, with queries next to
    stored rows): (label, keys, values, valid, queries, w, grouped)."""
    d, n = 21, 700
    keys = rng.normal(0, 5, (n, d)).astype(np.float32)
    w = (np.abs(rng.normal(2, 1, d)) + 0.5).astype(np.float32)
    q = (keys[rng.integers(0, n, 80)]
         + rng.normal(0, 0.3, (80, d))).astype(np.float32)
    yield ("flat_random", keys, rng.normal(0, 1, n).astype(np.float32),
           rng.random(n) < 0.6, q, w, False)

    keys = rng.normal(0, 5, (n, d)).astype(np.float32)
    keys[:, -1] = rng.integers(0, 11, n)
    w = w.copy()
    w[-1] = 0.1
    obs = (keys[rng.integers(0, n, 48), :-1]
           + rng.normal(0, 0.3, (48, d - 1))).astype(np.float32)
    yield ("grouped_random", keys, rng.normal(0, 1, n).astype(np.float32),
           rng.random(n) < 0.6, _group(obs, 11), w, True)

    # dense-block writes: half the rows are VALID sentinel rows (key 1e9)
    keys = rng.normal(0, 3, (4096, 5)).astype(np.float32)
    keys[:, -1] = rng.integers(0, 4, 4096)
    keys[rng.random(4096) < 0.5] = 1.0e9
    obs = rng.normal(0, 3, (256, 4)).astype(np.float32)
    yield ("grouped_dense_sentinel", keys,
           rng.normal(0, 1, 4096).astype(np.float32), np.ones(4096, bool),
           _group(obs, 4), np.asarray([2.0, 2.0, 2.0, 2.0, 0.1], np.float32),
           True)


@contextlib.contextmanager
def timed_launches(module, name: str, record: list, probe):
    """Wrap ``module.<name>`` (a kernel's launch function) with CUDA
    events for one run; ``probe(args, out)`` returns a function that
    gives the launch's work (kept pairs, matches, bytes, ops, plan) once
    the run is over.  Launches still count."""
    orig = getattr(module, name)

    def timed(*args):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(*args)
        end.record()
        record.append((start, end, probe(args, out)))
        return out

    setattr(module, name, timed)
    try:
        yield
    finally:
        setattr(module, name, orig)


def summarize(record: list) -> dict:
    """Per-launch times and work of a timed run; the bound is that of the
    mean launch's work (bytes and operations of these inputs).  Also the
    plan: kept sub-slices per query tile (max and mean), the window's
    sub-slices per tile, the chunk count, the scratch bytes and the
    persistent grid of the main pass."""
    torch.cuda.synchronize()
    ms = [s.elapsed_time(e) for s, e, _ in record]
    record = [(s, e) + work() for s, e, work in record]
    pairs = [float(r[2]) for r in record]
    matches = [float(r[3]) for r in record]
    n_ops = float(np.mean([float(r[5]) for r in record]))
    bound, by = bound_ms(float(np.mean([float(r[4]) for r in record])), n_ops)
    plans = [{k: float(v) for k, v in r[6].items()} for r in record]
    chunks = [p["chunks"] for p in plans]
    return dict(kernel_ms_mean=float(np.mean(ms)), kernel_ms_first=ms[0],
                kernel_ms_last=ms[-1], kernel_ms_sum=float(np.sum(ms)),
                pairs_after_prune_mean=float(np.mean(pairs)),
                pairs_first=pairs[0], pairs_last=pairs[-1],
                matches_mean=float(np.mean(matches)),
                ops_mean=n_ops, bound_ms_mean=bound, bound_by=by,
                kept_per_tile_max=max(p["kept_max"] for p in plans),
                kept_per_tile_mean=float(np.mean([p["kept_mean"]
                                                  for p in plans])),
                window_per_tile_mean=float(np.mean([p["window_mean"]
                                                    for p in plans])),
                chunks_mean=float(np.mean(chunks)), chunks_max=max(chunks),
                chunk_subslices=plans[0]["chunk"],
                scratch_bytes=max(p["scratch_bytes"] for p in plans),
                grid=plans[0]["grid"])


def plan_stats(keep, plan, chunk_bytes: int, grid: int) -> dict:
    """Device scalars describing one launch's plan."""
    kept = keep.sum(1).float()
    return dict(kept_max=kept.max(), kept_mean=kept.mean(),
                window_mean=(plan.s_hi - plan.s_lo).float().mean(),
                chunks=plan.off[-1], chunk=plan.chunk,
                scratch_bytes=plan.max_chunks * chunk_bytes, grid=grid)


def peraction_probe(store_kernels, _cuda, settled: list):
    """Keeps each launch's arguments; its work is counted after the run,
    and each launch's whole-piece counts (:func:`piece_settle`) are
    appended to ``settled``."""
    def probe(args, out):
        grid = _cuda.GRID["peraction_moments"]

        def work():
            prep, queries, qorder, qext = args[:4]
            keep = store_kernels.prune_keep(prep, qext)
            tile_q = torch.full((keep.shape[0],), float(store_kernels._QT),
                                device=keep.device)
            tile_q[-1] = queries.shape[0] - store_kernels._QT * (keep.shape[0] - 1)
            pairs = (keep.sum(1) * tile_q).sum() * prep.sub_n
            b = queries.shape[0]
            n_act = prep.num_actions
            # inputs read once: records, piece boxes and (f64) sums,
            # queries (+ order), extrema; output
            n_bytes = (4 * (prep.rows.numel() + prep.piece_box.numel())
                       + 8 * prep.piece_mom.numel()
                       + b * (20 * 4 + 8 + 3 * n_act * 4)
                       + 4 * (prep.kb.numel() + prep.kb2.numel()
                              + prep.kbt.numel() + qext.numel()))
            st = piece_settle(prep, queries, qorder, keep)
            settled.append(st)
            # the box test of every (query, kept piece) pair, 4 operations
            # a dim; the piece's 3A f64 sums for each held pair (the f64
            # adds in f32 time at the two peaks' ratio); 2 a dim for each
            # live row of the pieces a query walks (the adds of its
            # matches there are left out: a lower bound)
            n_ops = (80.0 * st["pairs"]
                     + 3.0 * n_act * FP32_OPS_PER_S / FP64_OPS_PER_S
                     * st["held"] + 40.0 * st["walk_rows"])
            plan = store_kernels.peraction_plan(prep, qext)
            return (pairs, out[..., 0].sum(), n_bytes, n_ops,
                    plan_stats(keep, plan, store_kernels._PA_PART_BYTES
                               * n_act * store_kernels._QT, grid))
        return work
    return probe


def sorted_probe(store_kernels, _cuda):
    """Counts each launch's work at once (its operands are rebuilt every
    step, too large to keep for a 300-step run)."""
    def probe(args, out):
        (ops,) = args
        d, q = ops.q_t.shape
        keep = store_kernels.sorted_prune_keep(ops)
        tile_q = torch.full((keep.shape[0],), float(store_kernels._SQT),
                            device=keep.device)
        tile_q[-1] = q - store_kernels._SQT * (keep.shape[0] - 1)
        pairs = (keep.sum(1) * tile_q).sum() * store_kernels._SSUB_N
        matches = out[:, 0].sum()
        # inputs read once: records, queries, extrema, w; output
        n_bytes = 4 * (ops.rows.numel() + (d + 3) * q + ops.kb.numel()
                       + ops.qb.numel() + 2 * d + 1)
        plan = store_kernels.sorted_plan(ops)
        work = (pairs, matches, n_bytes, 2.0 * d * pairs + 3.0 * matches,
                plan_stats(keep, plan, 8 * 3 * store_kernels._SQT,
                           _cuda.GRID["sorted_moments"]))
        return lambda: work
    return probe


def warp_empty_share(mask: torch.Tensor, keep: torch.Tensor,
                     live_rows: torch.Tensor) -> float:
    """Share of the (32-query warp, live row) pairs a kernel examines
    (rows of the sub-slices its tile keeps) in which no query of the warp
    lies in the row's box: what warp-level skipping, or a prefilter, can
    save at most.  ``mask`` [Q, n_pad] is the containment in tile order."""
    q = mask.shape[0]
    warp_any = mask.reshape(q // 32, 32, -1).any(1)
    per_warp = keep.repeat_interleave(4, 0)[:q // 32]
    examined = per_warp.repeat_interleave(256, 1) & live_rows[None]
    return float((examined & ~warp_any).sum()) / max(float(examined.sum()), 1.0)


def piece_settle(prep, queries, qorder, keep, batch: int = 1 << 14) -> dict:
    """Over the (live query, kept 128-row piece) pairs of one launch:
    ``pairs``, how many a query settles whole from the piece's live-row
    box (``held``: it takes the piece's sums; ``out``: out of reach, it
    takes nothing), and ``walk_rows``, the live rows of the pieces it
    must walk row by row.  Device scalars."""
    perm = prep.perm.long()
    q = queries[qorder][:, perm]
    b, w = q.shape[0], prep.w_col[perm]
    live_rows = (prep.row_act >= 0).reshape(-1, 128).sum(1)
    tiles, subs = torch.nonzero(keep, as_tuple=True)
    tiles = tiles.repeat_interleave(2)
    pcs = (2 * subs[:, None] + torch.arange(2, device=subs.device)).reshape(-1)
    lane = torch.arange(128, device=q.device)
    st = {k: torch.zeros((), dtype=torch.int64, device=q.device)
          for k in ("pairs", "held", "out", "walk_rows")}
    for i in range(0, pcs.shape[0], batch):
        pc = pcs[i:i + batch]
        qi = tiles[i:i + batch, None] * 128 + lane                   # [n, 128]
        ok = qi < b
        qq = q[qi.clamp(max=b - 1)]                                  # [n, 128, 20]
        box = prep.piece_box[pc][:, None]
        a, c = qq - box[..., :20], qq - box[..., 20:]
        held = ((a.abs() <= w) & (c.abs() <= w)).all(-1) & ok
        out = ((c > w) | (a < -w)).any(-1) & ok & ~held
        walk = ok & ~held & ~out
        st["pairs"] += ok.sum()
        st["held"] += held.sum()
        st["out"] += out.sum()
        st["walk_rows"] += (walk.sum(1) * live_rows[pc]).sum()
    return st


def settle_shares(st: dict) -> dict:
    total = max(float(st["pairs"]), 1.0)
    return dict(piece_held_share=float(st["held"]) / total,
                piece_out_of_reach_share=float(st["out"]) / total)


def sorted_mask(ops) -> torch.Tensor:
    """[Q, n_pad] bool containment of the sorted operands (tile order)."""
    mask = (ops.valid != 0)[None, :].expand(ops.q_t.shape[1], -1).clone()
    for d in range(ops.q_t.shape[0]):
        mask &= torch.abs(ops.q_t[d][:, None] - ops.keys_t[d][None, :]) \
            <= ops.w[d]
    return mask


def peraction_mask(prep, queries_sorted) -> torch.Tensor:
    """[B, n_pad] bool containment of sorted queries in live rows."""
    mask = (prep.row_act >= 0)[None, :].expand(queries_sorted.shape[0],
                                               -1).clone()
    for d in range(prep.keys_t.shape[0]):
        mask &= torch.abs(queries_sorted[:, d:d + 1] - prep.keys_t[d][None, :]) \
            <= prep.w_col[d]
    return mask


def brute_work(n_rows: int, n_q: int, d: int, matches: float):
    """(bytes, ops) of the brute kernel: every pair is tested."""
    return (4 * ((d + 2) * n_rows + (d + 3) * n_q + d),
            2.0 * d * n_rows * n_q + 3.0 * matches)


def snapshot(state):
    """A copy of a trainer state (every tensor cloned; host flags kept)."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        return type(state)(*(snapshot(x) for x in state))
    return state


@contextlib.contextmanager
def keep_loop_launches(sk, slot: dict, every_sorted: bool = False):
    """Wrap the kernels' launch functions so that ``slot[name]`` holds
    [(arguments, output)] of the latest ``launch_sorted`` (its operands
    hold the whole store, rebuilt every step; of every one with
    ``every_sorted``, for a store small enough) and of every
    ``launch_peraction`` (small queries; a run's launches share its
    prepared store): the operands the closed loop gave the kernels.
    Launches still count."""
    origs = {n: getattr(sk, n) for n in ("launch_sorted", "launch_peraction")}

    def wrap(name, fn):
        def keep(*args):
            out = fn(*args)
            kept = slot.setdefault(name, [])
            if name == "launch_sorted" and not every_sorted:
                kept.clear()
            kept.append((args, out.clone()))
            return out
        return keep

    for n, fn in origs.items():
        setattr(sk, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in origs.items():
            setattr(sk, n, fn)


@contextlib.contextmanager
def timed_calls(module, names, record: dict, _cuda, slot=None):
    """Wrap ``module.<name>`` for each name: every call is synchronised and
    timed on the host clock, and the kernel launches it made are kept:
    ``record[name]`` gets (seconds, launches, kept, args) per call, with
    ``kept`` what ``slot`` (of :func:`keep_loop_launches`) held of this
    call's launches (empty without a slot) and ``args`` its positional
    arguments (None without a slot)."""
    origs = {n: getattr(module, n) for n in names}

    def wrap(name, fn):
        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            before = dict(_cuda.LAUNCHES)
            if slot is not None:
                slot.clear()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = {k: v - before.get(k, 0)
                        for k, v in _cuda.LAUNCHES.items()
                        if v != before.get(k, 0)}
            record.setdefault(name, []).append(
                (dt, launches, dict(slot or {}),
                 None if slot is None else args))
            return out
        return timed

    for n, fn in origs.items():
        setattr(module, n, wrap(n, fn))
    try:
        yield
    finally:
        for n, fn in origs.items():
            setattr(module, n, fn)


def hold_kept_launches(sk, kept: dict, what: str) -> dict:
    """A main-path call's kept launches against the kernels' plain
    versions on the same operands: the last ``sorted_moments`` launch and
    the ``peraction_moments`` launch with the most matches (a fleet may
    have left the store's rows by its last tick).  {kernel: max |err|}.
    A store with no live row must give zeros, bit-equal to its plain
    version."""
    errs = {}
    if "launch_sorted" in kept:
        ((ops,), out), = kept["launch_sorted"]
        errs["sorted_moments"] = compare(out, sk.sorted_moments_plain(ops),
                                         what + "_sorted")
    if "launch_peraction" in kept:
        launches = kept["launch_peraction"]
        best = int(torch.stack([o[..., 0].sum() for _, o in launches])
                   .argmax())
        (prep, queries, *_), out = launches[best]
        ref = sk.peraction_moments_plain(prep, queries)
        if not bool((prep.row_act >= 0).any()):
            if not (torch.equal(out, ref) and not ref.any()):
                fail(f"{what}: the empty store's moments are not all zero")
            errs["peraction_moments"] = 0.0
        else:
            errs["peraction_moments"] = compare(out, ref, what + "_peraction")
    return errs


def gated_e2e(imp, cfg, store, what: str) -> dict:
    """evaluate_gated on a closed-loop store, 256 envs x 20 ticks, kernel
    route == brute route: equal integer metrics, reward per step within
    rtol 1e-5."""
    runs = [imp.evaluate_gated(cfg, store, n_envs=256, n_steps=20,
                               seed=SEED + 100, use_kernel=k)
            for k in (True, False)]
    for key in runs[1]:
        a, b = runs[0][key], runs[1][key]
        same = (abs(a - b) <= 1e-5 * abs(b) if key == "mean_step_reward"
                else a == b)
        if not same:
            fail(f"{what}: {key} {a} (kernel) != {b} (brute)")
    return dict(envs=256, ticks=20,
                activation_fraction=runs[0]["activation_fraction"],
                episodes=runs[0]["episodes"])


def improvement_phase(sk, _cuda, gpu: str) -> dict:
    """The closed loop at examples/run_improvement.py's defaults: train
    2,048 envs x 2,000 steps from an empty store, then the empty-store
    rule fleet and the gated fleet, 1,024 envs x 400 ticks each.  The
    kept launches of each call (:func:`hold_kept_launches`) are held
    against the plain versions on their own operands (the trained
    2^17-row store and the fleet's queries), and the gated arm's
    deployment is run again on the kernel and the brute route.  Returns
    {kernel: max |err|}."""
    from dcarl_tpu_torch import improvement as imp

    steps, envs, ticks = 2000, 1024, 400
    record: dict = {}
    slot: dict = {}
    cfg = imp.demo_config()
    _cuda.LAUNCHES.clear()
    t0 = time.perf_counter()
    with keep_loop_launches(sk, slot), \
            timed_calls(imp, ("train_store", "evaluate_gated"), record, _cuda,
                        slot):
        rep = imp.run_improvement(
            cfg, batch_per_device=2048, train_steps=steps,
            chunk=100, store_capacity_per_device=1 << 17, eval_envs=envs,
            eval_steps=ticks, seed=SEED, use_kernel=True)
    total_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    (train_s, train_l, train_k, _), = record["train_store"]
    ((rule_s, rule_l, rule_k, _),
     (gated_s, gated_l, gated_k, (_, store))) = record["evaluate_gated"]
    if train_l != {"sorted_moments": steps}:
        fail(f"improvement: train launches {train_l} != {steps} steps")
    for arm, got in (("rule", rule_l), ("gated", gated_l)):
        if got != {"peraction_moments": ticks}:
            fail(f"improvement: {arm} arm launches {got} != {ticks} ticks")
    hist = rep["train"]["history"]
    if not all(np.isfinite(v).all() for v in hist.values()):
        fail("improvement: training history not finite")
    if rep["train"]["store_rows"] <= 0:
        fail("improvement: the store stayed empty")
    if rep["eval_rule"]["activation_fraction"] != 0.0:
        fail("improvement: the empty-store fleet activated a candidate")
    if not rep["eval_gated"]["activation_fraction"] > 0.0:
        fail("improvement: the gated fleet never activated a candidate")
    errs = {"train": hold_kept_launches(sk, train_k, "improvement_train"),
            "rule": hold_kept_launches(sk, rule_k, "improvement_rule"),
            "gated": hold_kept_launches(sk, gated_k, "improvement_gated")}
    e2e = gated_e2e(imp, cfg, store, "improvement e2e")
    imp_ = rep["improvement"]
    emit("improvement", train_envs=2048, train_steps=steps, eval_envs=envs,
         eval_ticks=ticks, seconds=total_s, train_seconds=train_s,
         train_env_steps_per_s=2048 * steps / train_s,
         eval_rule_seconds=rule_s, eval_gated_seconds=gated_s,
         eval_rule_env_steps_per_s=envs * ticks / rule_s,
         eval_gated_env_steps_per_s=envs * ticks / gated_s,
         launches=launches, store_rows=rep["train"]["store_rows"],
         final_rule_fraction=rep["train"]["final_rule_fraction"],
         rule_fraction_by_chunk=[round(x, 4) for x in hist["rule_fraction"]],
         rule_activation=rep["eval_rule"]["activation_fraction"],
         gated_activation=rep["eval_gated"]["activation_fraction"],
         reward_rate_ratio=imp_["reward_rate_ratio"],
         collision_delta_per_kstep=imp_["collision_delta_per_kstep"],
         pass_throughput_ratio=imp_["pass_throughput_ratio"],
         rule_pass_rate=rep["eval_rule"]["pass_rate"],
         gated_pass_rate=rep["eval_gated"]["pass_rate"],
         rule_collision_rate=rep["eval_rule"]["collision_rate"],
         gated_collision_rate=rep["eval_gated"]["collision_rate"],
         kept_launch_vs_plain_max_abs_err=errs, e2e_kernel_eq_brute=e2e,
         gpu=gpu)
    return merge_errs(errs.values())


def merge_errs(errs) -> dict:
    """{kernel: max |err|} over several {kernel: max |err|}."""
    out: dict = {}
    for e in errs:
        for k, v in e.items():
            out[k] = max(out.get(k, 0.0), v)
    return out


def empty_store_phase(sk, queries, hw) -> None:
    """The rule arm's store: 2^17 rows of 1e9 keys, none valid."""
    n = 1 << 17
    dev = queries.device
    prep = sk.prepare_peraction_store(
        torch.full((n, 21), 1e9, device=dev), torch.zeros(n, device=dev),
        torch.zeros(n, dtype=torch.bool, device=dev), hw, 11)
    got = sk.query_peraction_prepared(prep, queries)
    again = sk.query_peraction_prepared(prep, queries)
    ref = sk.peraction_moments_plain(prep, queries)
    torch.cuda.synchronize()
    if not torch.equal(got, again):
        fail("empty store: two peraction_moments launches differ")
    if not (torch.equal(got, ref) and not ref.any()):
        fail("empty store: the kernel's moments are not all zero")
    emit("empty_store", rows=n, queries=queries.shape[0],
         max_abs_err=float((got - ref).abs().max()), bit_equal=True)


def two_session_phase(root: str, sk, _cuda, gpu: str) -> dict:
    """Session A trains and spools, a fresh session B reloads its text
    history and deploys from it; then save -> restore -> continue of 3
    steps against the uninterrupted run.  The kept launches of each
    training session and each deployment are held against the plain
    versions on their own operands (session B's store is the one
    rebuilt from text), and the deployment from session B's reloaded
    store is run again on the kernel and the brute route.  Returns
    {kernel: max |err|}."""
    import shutil

    from dcarl_tpu_torch import improvement as imp
    from dcarl_tpu_torch.session import TrainSession
    from dcarl_tpu_torch.utils import checkpoint as ckpt

    shutil.rmtree(root, ignore_errors=True)
    envs, cap, budget, steps = 2048, 1 << 17, 2 * 2048, 1008
    record: dict = {}
    slot: dict = {}
    t0 = time.perf_counter()
    with timed_calls(ckpt, ("format_rows",), record, _cuda), \
            keep_loop_launches(sk, slot), \
            timed_calls(imp, ("train_store_sessioned", "evaluate_gated"),
                        record, _cuda, slot):
        rep = imp.run_two_session_improvement(
            os.path.join(root, "two_session"), batch_per_device=envs,
            train_steps=steps, chunk=100, store_capacity_per_device=cap,
            eval_envs=1024, eval_steps=400, seed=SEED, use_kernel=True,
            backfill_budget_per_step=budget)
    total_s = time.perf_counter() - t0
    info_a = rep["session_a"]["info"]
    probe = rep["session_b_imported"]["info"]
    if not (rep["evidence_transferred"] and rep["activation_retained"]):
        fail(f"two session: evidence_transferred "
             f"{rep['evidence_transferred']}, activation_retained "
             f"{rep['activation_retained']}")
    # the reload takes the newest `cap` rows of A's history; B's own
    # history holds only what B adds (nothing before it trains)
    if probe["imported_rows"] != min(info_a["history_rows"], cap) \
            or probe["history_rows"] != 0:
        fail(f"two session: imported {probe['imported_rows']} rows of a "
             f"{info_a['history_rows']}-row history")
    write_s = sum(dt for dt, *_ in record["format_rows"])
    labels = {"train_store_sessioned": ("train_a", "train_b_probe",
                                        "train_b"),
              "evaluate_gated": ("eval_rule", "eval_a", "eval_b_imported",
                                 "eval_b")}
    errs = {label: hold_kept_launches(sk, kept, "two_session_" + label)
            for name, names in labels.items()
            for label, (_, _, kept, _) in zip(names, record[name])}
    store_b0 = record["evaluate_gated"][2][3][1]
    e2e = gated_e2e(imp, imp.demo_config(), store_b0,
                    "two session e2e (session B's reloaded store)")

    # save -> restore -> continue, bit for bit, on the card
    kw = dict(batch_per_device=envs, store_capacity_per_device=cap,
              replay_capacity_per_device=cap, use_kernel=True,
              backfill_budget_per_step=budget)
    cfg = imp.demo_config()
    sdir = os.path.join(root, "resume")
    sess = TrainSession(sdir, cfg, **kw)
    run3 = sess.run_factory(3)
    state, _ = sess.init_or_resume(seed=SEED)
    state, _ = run3(state, torch.Generator(device="cuda").manual_seed(1))
    t1 = time.perf_counter()
    sess.save(state, step=3)
    save_s = time.perf_counter() - t1
    cont, _ = run3(state, torch.Generator(device="cuda").manual_seed(2))
    sess2 = TrainSession(sdir, cfg, **kw)
    t1 = time.perf_counter()
    restored, step = sess2.init_or_resume(seed=SEED + 1)
    restore_s = time.perf_counter() - t1
    resumed, _ = sess2.run_factory(3)(
        restored, torch.Generator(device="cuda").manual_seed(2))
    a = ckpt.flatten({"state": cont, "learner": sess.learner.state_dict()})
    b = ckpt.flatten({"state": resumed, "learner": sess2.learner.state_dict()})
    differ = [k for k in a if isinstance(a[k], torch.Tensor)
              and not torch.equal(a[k], b[k])]
    if step != 3 or a.keys() != b.keys() or differ:
        fail(f"two session: resumed run differs from the uninterrupted one "
             f"in {differ[:5]}")
    emit("two_session", envs=envs, store_capacity=cap, train_steps=steps,
         seconds=total_s,
         train_seconds=[round(dt, 3) for dt, *_ in
                        record["train_store_sessioned"]],
         eval_seconds=[round(dt, 3) for dt, *_ in record["evaluate_gated"]],
         history_rows_a=info_a["history_rows"],
         imported_rows=probe["imported_rows"],
         text_write_seconds=write_s,
         activation_rule=rep["eval_rule"]["activation_fraction"],
         activation_a=rep["session_a"]["eval"]["activation_fraction"],
         activation_b_imported=rep["session_b_imported"]["eval"]
         ["activation_fraction"],
         activation_b_final=rep["session_b_final"]["eval"]
         ["activation_fraction"],
         improvement_a=rep["improvement_a"],
         improvement_b=rep["improvement_b"],
         checkpoint_save_seconds=save_s,
         checkpoint_restore_seconds=restore_s,
         resume_bit_equal=True, kept_launch_vs_plain_max_abs_err=errs,
         e2e_kernel_eq_brute=e2e, gpu=gpu)
    shutil.rmtree(root, ignore_errors=True)
    return merge_errs(errs.values())


def vehicle_life_phase(sk, _cuda, hw, gpu: str) -> None:
    """The working set at WORKINGSET_r05.json's widths (chunks cut to 24),
    then the per-action kernel against its plain version on a
    sentinel-padded region cache of the same history (its error, on sums
    of squared episode returns, is reported in this phase's line only)."""
    from dcarl_tpu_torch import workingset as ws

    n_envs, chunk, n_chunks, audits = 65536, 50, 24, 1
    t0 = time.perf_counter()
    lk, lv = ws.collect_local_records(4096, 2048, seed=SEED + 7,
                                      max_rows=10000)
    torch.cuda.synchronize()
    collect_s = time.perf_counter() - t0
    if len(lk) != 10000 or not np.isfinite(lk).all():
        fail(f"vehicle life: the collector gave {len(lk)} rows")
    _cuda.LAUNCHES.clear()
    rep = ws.run_vehicle_life(
        n_envs=n_envs, chunk_steps=chunk, n_chunks=n_chunks,
        local_rows=10000, n_offsets=450, offset_spacing=8.0,
        cache_capacity=1 << 18, region_radius=25.0, recenter_margin=10.0,
        drift_per_chunk=2.0, checkpoints=audits, checkpoint_queries=256,
        use_kernel=True, seed=SEED, history=(lk, lv))
    launches = dict(_cuda.LAUNCHES)
    want = (n_chunks + 1) * chunk + 3 * audits     # + warm-up chunk
    if launches != {"peraction_moments": want}:
        fail(f"vehicle life: launches {launches} != {want}")
    if rep["recenters"] < 1 or len(rep["checkpoints"]) != audits:
        fail(f"vehicle life: {rep['recenters']} re-centers, "
             f"{len(rep['checkpoints'])} audits")
    ck = rep["checkpoints"][0]
    if ck["matched_counts_total"] <= 0:
        fail("vehicle life: the audit matched nothing")
    # the per-action kernel sums in f64 and rounds once: the full history
    # and its region-masked copy give the same bits on the card
    if not ck["device_bitwise_full_vs_masked"]:
        fail(f"vehicle life: full and masked stores differ on the card: {ck}")

    # the kernel on a sentinel-padded region cache (RegionCache.build's
    # 1e9 keys past the region rows), probes at region rows
    hk, hv = ws.build_life_history(lk, lv, np.arange(450) * 8.0)
    center = float(np.median(lk[:, 0])) + 400.0
    keys, vals, valid, n, idx = ws.RegionCache(
        hk, hv, hw.cpu().numpy(), 1 << 18).build(center, 25.0)
    rng = np.random.default_rng(SEED)
    probes = hk[idx[rng.integers(0, n, 4096)], :-1]
    t = [torch.as_tensor(a, device="cuda") for a in (keys, vals, valid)]
    q = torch.as_tensor(probes, device="cuda").contiguous()
    prep = sk.prepare_peraction_store(t[0], t[1], t[2], hw, 11)
    got = sk.query_peraction_prepared(prep, q)
    torch.cuda.synchronize()
    ref = sk.peraction_moments_plain(prep, q)
    err = compare(got, ref, "sentinel_region_cache")
    rel = float(((got - ref).abs() / ref.abs().clamp(min=1.0)).max())
    emit("vehicle_life", envs=n_envs, chunk_ticks=chunk, chunks=n_chunks,
         history_rows=rep["history_rows"], cache_capacity=1 << 18,
         collect_seconds=collect_s,
         collect_env_steps_per_s=4096 * 2048 / collect_s,
         wall_seconds=rep["wall_seconds"],
         audit_seconds=rep["checkpoint_seconds"],
         sustained_env_steps_per_s=rep["sustained_env_steps_per_s"],
         recenters=rep["recenters"],
         recenter_prep_seconds_total=rep["recenter_prep_seconds_total"],
         activation_fraction_mean=rep["activation_fraction_mean"],
         launches=launches, audit=ck, sentinel_cache_rows=int(n),
         sentinel_cache_max_abs_err=err, sentinel_cache_max_rel_err=rel,
         gpu=gpu)


def trustset_phase(sk, _cuda, gpu: str) -> tuple:
    """The trust-set DQN trainer at the JAX package's defaults (64 envs,
    ``DQNConfig()``, replay and trust set 2^14, ``SegmentConfig()``) for
    1,000 steps, one ``sorted_moments`` launch (D = 4) per trained step
    and none in warm-up; the rate from steps 600-1,000 rerun without
    probes from a step-600 snapshot; the launch with the most matches
    against the plain version, and again bit-equal; 20 steps from that
    snapshot on the kernel and the brute route with the same draws; the
    trained trust set served to 65,536 of the rule driver's observations
    through ``act_ts``, ``act_ts_explore`` and ``hybrid_act``; the golden
    confidence core on a 20,000-row stream on the card against the CPU,
    and ``running_update_batch`` over 4,096 streams.  Returns the max
    |err| of the kept launch and of the fleet's launch."""
    from dcarl_tpu_torch.config import EnvConfig
    from dcarl_tpu_torch.core import confidence as C
    from dcarl_tpu_torch.core.rls import candidate_keys
    from dcarl_tpu_torch.core.store import store_valid
    from dcarl_tpu_torch.data import sampling
    from dcarl_tpu_torch.env.driving_env import in_state_indices
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.models import segment as SEG
    from dcarl_tpu_torch.models import trustset as TS
    from dcarl_tpu_torch.planning import fast_rollout as fr

    dev = torch.device("cuda")
    envs, steps, snap_at, e2e_steps = 64, 1000, 600, 20
    sec, t_lap = {}, [time.perf_counter()]

    def lap(name):
        torch.cuda.synchronize()
        now = time.perf_counter()
        sec[name] = now - t_lap[0]
        t_lap[0] = now

    init_s, run_s = SEG.make_trustset_trainer(batch=envs)
    learner = run_s.learner
    carry = init_s(SEED)
    lap("build")
    gen = torch.Generator(device=dev).manual_seed(SEED + 20)

    # the punished share of each trained step's batch (read after the run)
    punished = []
    in_ts_orig = TS.in_trust_set

    def in_ts_recorded(*args, **kwargs):
        out = in_ts_orig(*args, **kwargs)
        punished.append((~out).float().mean())
        return out

    slot: dict = {}
    per_step, warm, ms = [], [], []
    TS.in_trust_set = in_ts_recorded
    try:
        with keep_loop_launches(sk, slot, every_sorted=True):
            _cuda.LAUNCHES.clear()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for i in range(steps):
                if i == snap_at:
                    snap = (snapshot(carry), learner.state_dict(),
                            gen.get_state())
                before = _cuda.LAUNCHES["sorted_moments"]
                carry, m = run_s.step(carry, gen)
                per_step.append(_cuda.LAUNCHES["sorted_moments"] - before)
                warm.append(carry.warm)
                ms.append(m)
            torch.cuda.synchronize()
            probed_sec = time.perf_counter() - t0
    finally:
        TS.in_trust_set = in_ts_orig
    launches = dict(_cuda.LAUNCHES)
    met = {k: torch.stack([m[k] for m in ms]) for k in SEG.METRIC_KEYS}
    n_warm = sum(warm)
    if warm != [True] * n_warm + [False] * (steps - n_warm) \
            or any(per_step[:n_warm]) or set(per_step[n_warm:]) != {1}:
        fail(f"trustset: launches per step {per_step[:n_warm + 3]}... "
             f"({n_warm} warm-up steps)")
    if launches != {"sorted_moments": steps - n_warm}:
        fail(f"trustset: launches {launches} != {steps - n_warm}")
    if int(met["ts_rows"][-1]) != 1 << 14:
        fail(f"trustset: {int(met['ts_rows'][-1])} trust-set rows")
    if not torch.isfinite(met["loss"]).all():
        fail("trustset: loss not finite")
    pun = torch.stack(punished)
    final_state = learner.state_dict()
    lap("train")

    # the rate: the same steps from the snapshot on, without probes
    learner.load_state_dict(snap[1])
    c = snapshot(snap[0])
    tgen = torch.Generator(device=dev)
    tgen.set_state(snap[2])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(snap_at, steps):
        c, _ = run_s.step(c, tgen)
    torch.cuda.synchronize()
    run_sec = time.perf_counter() - t0
    learner.load_state_dict(final_state)
    del c
    lap("rate")

    # the launch with the most matches against the plain version
    kept = slot["launch_sorted"]
    best = int(torch.stack([o[:, 0].sum() for _, o in kept]).argmax())
    (ops,), out = kept[best]
    err = compare(out, sk.sorted_moments_plain(ops), "trustset_kept_launch")
    if not torch.equal(sk.sorted_moments(ops), out):
        fail("trustset: two sorted_moments launches differ")
    kept_matches = int(out[:, 0].sum())
    # that launch timed alone, with its plain version, and its bound
    kept_ms = cuda_ms(lambda: sk.sorted_moments(ops))
    kept_plain_ms = cuda_ms(lambda: sk.sorted_moments_plain(ops))
    _, _, k_bytes, k_ops, _ = sorted_probe(sk, _cuda)((ops,), out)()
    kept_bound = bound_ms(float(k_bytes), float(k_ops))
    del kept, slot
    lap("kept_launch")

    # the fleet's width against the trained trust set
    env_cfg = EnvConfig()
    sc = t_intersection(env_cfg)
    idx = in_state_indices(sc)
    init_r, run_r = fr.make_rule_driver_fast(sc, env_cfg)
    rgen = torch.Generator(device=dev).manual_seed(SEED + 21)
    fleet, _ = run_r(init_r(65536, rgen), 40, rgen)
    obs = fr._obs_ori_soa(fleet, idx).T.contiguous()
    with torch.no_grad():
        enc = learner.net.encoded_state(obs)
    ts = carry.ts
    calls = (("act_ts", lambda: learner.act_ts(ts, obs, enc)),
             ("act_ts_explore", lambda: learner.act_ts_explore(ts, obs, enc)),
             ("hybrid_act", lambda: TS.hybrid_act(ts, enc, 11)))
    _cuda.LAUNCHES.clear()
    call_s = {}
    for name, fn in calls:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        a = fn()
        torch.cuda.synchronize()
        call_s[name] = time.perf_counter() - t0
        if a.shape != (65536,) or int(a.min()) < 0 or int(a.max()) > 10:
            fail(f"trustset fleet: {name} gave actions out of range")
    fleet_launches = dict(_cuda.LAUNCHES)
    if fleet_launches != {"sorted_moments": 3}:
        fail(f"trustset fleet: launches {fleet_launches} != 3")
    record = []
    with timed_launches(sk, "launch_sorted", record, sorted_probe(sk, _cuda)):
        for _, fn in calls:
            fn()
    fleet_summ = summarize(record)
    keys = candidate_keys(enc, 11).reshape(-1, 4)
    ops, _ = sk.sorted_query_operands(ts.store.keys, ts.store.values,
                                      store_valid(ts.store), keys,
                                      ts.half_widths)
    full = sk.sorted_moments(ops)
    matched = full[:, 0] > 0
    fgen = torch.Generator(device=dev).manual_seed(SEED + 22)
    top = torch.argsort(full[:, 0], descending=True)[:2048]
    sel = torch.cat([top, torch.randint(0, keys.shape[0], (2048,),
                                        generator=fgen, device=dev)])
    sub = ops._replace(q_t=ops.q_t[:, sel].contiguous())
    f_err = compare(full[sel], sk.sorted_moments_plain(sub), "trustset_fleet")
    fleet_plain_ms = cuda_ms(lambda: sk.sorted_moments_plain(sub))
    del ops, sub, full
    lap("fleet")

    # kernel route == brute route from the step-600 snapshot
    dgen = torch.Generator(device=dev).manual_seed(SEED + 23)
    draws = [run_s.draw(dgen) for _ in range(e2e_steps)]
    routes = []
    for use_kernel in (True, False):
        if use_kernel:
            run_e = run_s
        else:
            _, run_e = SEG.make_trustset_trainer(batch=envs, use_kernel=False)
        run_e.learner.load_state_dict(snap[1])
        c = snapshot(snap[0])
        egen = torch.Generator(device=dev).manual_seed(SEED + 24)
        held, mets = [], []
        for d in draws:
            c, m = run_e.with_draws(c, d, egen)
            held.append(c.hold.action)
            mets.append(m)
        routes.append((c, torch.stack(held), mets))
    (ca, ha, ma), (cb, hb, mb) = routes
    same = [torch.equal(getattr(ca.ts.store, f), getattr(cb.ts.store, f))
            for f in ("keys", "values", "size")]
    same += [torch.equal(getattr(ca.replay, f), getattr(cb.replay, f))
             for f in ca.replay._fields]
    same.append(torch.equal(ha, hb))
    for x, y in zip(ma, mb):
        same += [torch.equal(x[k], y[k]) for k in
                 ("pushed", "segments_closed", "replay_size", "ts_rows")]
        same.append(bool(torch.allclose(x["loss"], y["loss"], rtol=1e-6,
                                        atol=0)))
    if not all(same):
        fail("trustset e2e: kernel route differs from the brute route")
    learner.load_state_dict(final_state)
    lap("e2e")

    # the golden confidence core: the card against the CPU, float64
    ggen = torch.Generator(device=dev).manual_seed(SEED + 25)
    ds = sampling.generate(ggen, size=20_000)
    cap = C.required_capacity(ds.data.cpu().numpy(), 20, 11)
    golden = {}
    for where in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tab, gout = C.golden_run(ds.data, ds.action_values, action_num=11,
                                 capacity=cap, device=where)
        torch.cuda.synchronize()
        golden[where] = (time.perf_counter() - t0, tab, gout)
    (_, tab_g, out_g), (_, tab_c, out_c) = golden["cuda"], golden["cpu"]
    if not (torch.equal(out_g.tsrl_action.cpu(), out_c.tsrl_action)
            and torch.equal(tab_g.activation_step.cpu(), tab_c.activation_step)
            and torch.allclose(tab_g.tsrl.cpu(), tab_c.tsrl, rtol=1e-10,
                               atol=0)
            and torch.allclose(out_g.step_value.cpu(), out_c.step_value,
                               rtol=1e-10, atol=0)):
        fail("trustset golden: the card's golden run differs from the CPU's")
    lap("golden")
    # a one-state stream (Simulation_1's shape): every row shares one
    # table row; the card against the CPU
    ds1 = sampling.generate(torch.Generator(device=dev).manual_seed(SEED + 27),
                            state_num=1, size=20_000)
    cap1 = C.required_capacity(ds1.data.cpu().numpy(), 1, 11)
    one_state = {}
    for where in ("cuda", "cpu"):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out1 = C.golden_run(ds1.data, ds1.action_values, action_num=11,
                               capacity=cap1, device=where)
        torch.cuda.synchronize()
        one_state[where] = (time.perf_counter() - t0, out1)
    one_state_s = one_state["cuda"][0]
    out1, out1_c = one_state["cuda"][1], one_state["cpu"][1]
    if out1.tsrl_action.shape != (20_000,) or not torch.equal(
            out1.tsrl_action.cpu(), out1_c.tsrl_action):
        fail("trustset golden: the one-state stream's decisions differ "
             "between the card and the CPU")
    lap("golden_one_state")
    sgen = torch.Generator(device=dev).manual_seed(SEED + 26)
    streams = sampling.generate(sgen, size=4096 * 1000).data.reshape(4096,
                                                                    1000, 4)
    batch_s = {}
    tables = {}
    for where in ("cuda", "cpu"):
        x = streams.to(where, torch.float64)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tables[where] = C.running_update_batch(
            C.running_init((4096, 20, 11), dtype=torch.float64, device=where),
            x[..., 0], x[..., 2], x[..., 3])
        torch.cuda.synchronize()
        batch_s[where] = time.perf_counter() - t0
    tg, tc = tables["cuda"], tables["cpu"]
    if not (torch.equal(tg.count.cpu(), tc.count)
            and torch.allclose(tg.tsrl.cpu(), tc.tsrl, rtol=1e-10, atol=1e-9)):
        fail("trustset running table: the card differs from the CPU")
    lap("running_batch")

    emit("trustset", envs=envs, steps=steps, warmup_steps=n_warm,
         trained_steps=steps - n_warm, probed_seconds=probed_sec,
         timed_steps=steps - snap_at, seconds=run_sec,
         env_steps_per_s=envs * (steps - snap_at) / run_sec,
         launches=launches,
         launches_per_trained_step=launches["sorted_moments"] / (steps - n_warm),
         ts_rows=int(met["ts_rows"][-1]), replay_rows=int(met["replay_size"][-1]),
         pushed=int(met["pushed"].sum()),
         segments_closed=int(met["segments_closed"].sum()),
         held_fraction_mean=float(met["held_fraction"].mean()),
         held_fraction_last=float(met["held_fraction"][-1]),
         punished_share_first100=float(pun[:100].mean()),
         punished_share_last100=float(pun[-100:].mean()),
         loss_first100=float(met["loss"][n_warm:n_warm + 100].mean()),
         loss_last100=float(met["loss"][-100:].mean()),
         reward_mean=float(met["reward_mean"].mean()),
         kept_launch_max_abs_err=err, kept_launch_matches=kept_matches,
         kept_launch_queries=int(out.shape[0]), kept_launch_bit_equal=True,
         kept_launch_ms=kept_ms, kept_launch_plain_ms=kept_plain_ms,
         kept_launch_bound_ms=kept_bound[0], kept_launch_bound_by=kept_bound[1],
         e2e_steps_from=snap_at, e2e_steps=e2e_steps,
         e2e_kernel_eq_brute=True, section_seconds=sec,
         phase_seconds=sum(sec.values()), gpu=gpu)
    emit("trustset_fleet", envs=65536, queries=int(keys.shape[0]),
         ts_rows=int(ts.store.size), launches=fleet_launches,
         call_seconds=call_s, matched_query_share=float(matched.float().mean()),
         matches=float(fleet_summ["matches_mean"]),
         held_queries=4096, max_abs_err=f_err,
         plain_ms_4096=fleet_plain_ms,
         **fleet_summ, gpu=gpu)
    emit("golden", rows=20_000, capacity=cap,
         cuda_seconds=golden["cuda"][0], cpu_seconds=golden["cpu"][0],
         one_state_rows=20_000, one_state_cuda_seconds=one_state_s,
         one_state_cpu_seconds=one_state["cpu"][0],
         one_state_activation_row=int(torch.argmax(
             (out1_c.tsrl_action != 0).to(torch.uint8))),
         activated_states=int((tab_c.activation_step >= 0).sum()),
         decisions_equal=True,
         max_rel_tsrl_diff=float(((tab_g.tsrl.cpu() - tab_c.tsrl).abs()
                                  / tab_c.tsrl.abs().clamp(min=1e-300)).max()),
         running_batch_streams=4096, running_batch_samples=1000,
         running_batch_cuda_seconds=batch_s["cuda"],
         running_batch_cpu_seconds=batch_s["cpu"], gpu=gpu)
    return err, f_err


def readable_phase(sk, _cuda, hw, gpu: str) -> float:
    """The readable batch-first drivers against the lane-major ones on the
    card, their records through the per-action kernel, and the readable
    driver's rate; returns the kernel's max |err| against its plain
    version."""
    from dcarl_tpu_torch import workingset as ws
    from dcarl_tpu_torch.config import EnvConfig
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.planning import fast_rollout as fr
    from dcarl_tpu_torch.planning import rollout as rd

    dev = torch.device("cuda")
    envs, ticks, rate_envs = 1024, 300, 65536
    # the drivers reset to the spawn (jitter 0, so the two layouts' reset
    # draws never enter); the starts are jittered, so the envs differ
    cfg, start = EnvConfig(reset_jitter=0.0), EnvConfig()
    sc = t_intersection(cfg)
    secs = {}

    def run(name, make, dtype=torch.float64, b=envs, n=ticks,
            run_cfg=cfg):
        init_fn, _ = make(sc, start, dtype=dtype, device=dev)
        _, run_fn = make(sc, run_cfg, dtype=dtype, device=dev)
        carry = init_fn(b, torch.Generator(device=dev).manual_seed(SEED + 30))
        gen = torch.Generator(device=dev).manual_seed(SEED + 31)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        carry, out = run_fn(carry, n, gen)
        torch.cuda.synchronize()
        secs[name] = time.perf_counter() - t0
        return carry, out

    def same_ints(pairs, what):
        for label, a, b in pairs:
            if not torch.equal(a, b):
                fail(f"readable {what}: {label} differs between the readable "
                     "and the fast driver")

    def close(pairs, what):
        for label, a, b in pairs:
            if not torch.allclose(a, b, rtol=1e-9, atol=1e-9):
                fail(f"readable {what}: {label} beyond rtol 1e-9")
        return all(torch.equal(a, b) for _, a, b in pairs)

    # (a) the rule drivers, [B, S] against [S, B]
    (_, tick300), (r_r, d_r, p_r, c_r) = run("rule_readable",
                                             rd.make_rule_driver)
    _, f_out = run("rule_fast", fr.make_rule_driver_fast)
    r_f, d_f, p_f, c_f = (a.T for a in f_out)
    same_ints((("done", d_r, d_f), ("passed", p_r, p_f),
               ("collided", c_r, c_f)), "rule driver")
    rule_bits = close((("reward", r_r, r_f),), "rule driver")
    if not (d_r.any() and torch.isfinite(r_r).all()):
        fail("readable rule driver: no episode ended in the window")

    # (b) the collectors
    _, rc = run("collector_readable", rd.make_collector)
    _, fc = run("collector_fast", fr.make_collector_fast)
    same_ints([(f, getattr(rc, f), getattr(fc, f).T) for f in
               ("done", "collided", "passed", "used_action", "rule_index")],
              "collector")
    coll_bits = close([("reward", rc.reward, fc.reward.T),
                       ("episode_return", rc.episode_return,
                        fc.episode_return.T),
                       ("recorded_state", rc.recorded_state,
                        fc.recorded_state.permute(2, 0, 1))], "collector")

    # (c) each collector's records as a per-action store, one launch each
    k_r, v_r = ws.episode_rows(rc.done.T, rc.recorded_state.transpose(0, 1),
                               rc.used_action.T, rc.episode_return.T)
    k_f, v_f = ws.episode_rows(fc.done, fc.recorded_state.transpose(1, 2),
                               fc.used_action, fc.episode_return)
    if k_r.shape[0] < envs or k_r.shape != k_f.shape:
        fail(f"readable stores: {k_r.shape[0]} and {k_f.shape[0]} rows")
    # the fleet's tick-300 observations lie between trigger points and
    # match few rows; the rows' own states add probes that do
    q = torch.cat([tick300, k_r[:envs, :-1]]).float().contiguous()
    preps = [sk.prepare_peraction_store(
        k.float().contiguous(), v.float().contiguous(),
        torch.ones(k.shape[0], dtype=torch.bool, device=dev), hw, 11)
        for k, v in ((k_r, v_r), (k_f, v_f))]
    _cuda.LAUNCHES.clear()
    outs = [sk.query_peraction_prepared(p, q) for p in preps]
    torch.cuda.synchronize()
    launches = dict(_cuda.LAUNCHES)
    if launches != {"peraction_moments": 2}:
        fail(f"readable stores: launches {launches} != 2")
    if not torch.equal(outs[0], outs[1]):
        fail("readable stores: the two launches differ")
    errs = [compare(o, sk.peraction_moments_plain(p, q), f"readable_{w}")
            for o, p, w in zip(outs, preps, ("readable", "fast"))]

    # (d) the rate of each rule driver in f32 at the gated path's width,
    # with the default jitter
    run("rate_readable", rd.make_rule_driver, torch.float32, rate_envs, 50,
        start)
    run("rate_fast", fr.make_rule_driver_fast, torch.float32, rate_envs, 50,
        start)
    rates = {k: rate_envs * 50 / secs[k] for k in ("rate_readable",
                                                   "rate_fast")}
    emit("readable", envs=envs, ticks=ticks, dtype="float64",
         episodes_ended=int(d_r.sum()), passed=int(p_r.sum()),
         rule_rewards_bit_equal=rule_bits, collector_bit_equal=coll_bits,
         store_rows=int(k_r.shape[0]), queries=int(q.shape[0]),
         tick300_matches=float(outs[0][:envs, :, 0].sum()),
         matches=float(outs[0][..., 0].sum()), launches=launches,
         max_abs_err=max(errs), seconds=secs, gpu=gpu)
    for k, what in (("rate_readable", "readable"), ("rate_fast", "fast")):
        print(f"{what} rule driver, float32, {rate_envs} envs x 50 ticks: "
              f"{rates[k]:.6g} env-steps/s ({gpu})", flush=True)
    return max(errs)


# ---------------------------------------------------------------------------
# The sharded phase: every sharded path at world size 1 through NCCL in this
# process, then two gloo ranks sharing the one card (parallel.launch)
# ---------------------------------------------------------------------------

RANKS_TIMEOUT_S = 240


def sync(dev) -> None:
    """Wait for ``dev`` (a rank program runs on the card, or on the CPU
    in a rehearsal)."""
    if torch.device(dev).type == "cuda":
        torch.cuda.synchronize(dev)


def nccl_world_of_one(dev, tmp: str):
    """Join a one-rank NCCL group at a ``file://`` rendezvous in ``tmp``,
    check NCCL's all-gather, reduce-scatter and all-reduce on the card,
    and return the group's mesh."""
    import datetime

    import torch.distributed as dist

    from dcarl_tpu_torch.parallel.mesh import make_mesh

    dist.init_process_group("nccl", init_method=f"file://{tmp}/rendezvous",
                            world_size=1, rank=0,
                            timeout=datetime.timedelta(seconds=120))
    x = torch.arange(12, dtype=torch.float32, device=dev)
    gathered, scattered, reduced = (torch.empty_like(x), torch.empty_like(x),
                                    x.clone())
    dist.all_gather_into_tensor(gathered, x)
    dist.reduce_scatter_tensor(scattered, x)
    dist.all_reduce(reduced)
    torch.cuda.synchronize()
    if not all(torch.equal(t, x) for t in (gathered, scattered, reduced)):
        fail("sharded: NCCL collectives at world size 1 changed their input")
    return make_mesh("env", dist.group.WORLD, dev)


def _rank_gated(mesh, p):
    """Rank program: this rank's half of the fleet and its stripe of the
    store's rows through the sharded gated driver (kernel route, zero
    reset jitter), launches counted; then tick 0's moments, the whole
    batch against this rank's rows, reduce-scattered in f64 as the driver
    does."""
    from dcarl_tpu_torch import disable_tf32
    from dcarl_tpu_torch.config import EnvConfig, driving_store_config
    from dcarl_tpu_torch.env.driving_env import in_state_indices
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.ops import _cuda, store_kernels as sk
    from dcarl_tpu_torch.parallel import collectives as coll
    from dcarl_tpu_torch.parallel.sharded_store import stripe
    from dcarl_tpu_torch.planning import fast_rollout as fr

    disable_tf32()
    dev = mesh.device
    env_cfg, scfg = EnvConfig(reset_jitter=0.0), driving_store_config()
    sc = t_intersection(env_cfg)
    keys, vals, valid = (stripe(t.to(dev), mesh)
                         for t in (p["keys"], p["values"], p["valid"]))
    carry = fr.shard_lanes(fr.FastEnvState(*(t.to(dev) for t in p["carry"])),
                           mesh)
    _, run = fr.make_gated_driver_sharded(sc, mesh, env_cfg, store_cfg=scfg,
                                          use_kernel=True)
    _cuda.LAUNCHES.clear()
    sync(dev)
    t0 = time.perf_counter()
    _, out = run(carry, p["ticks"], keys, vals, valid,
                 generator=torch.Generator(device=dev).manual_seed(p["seed"]))
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    hw = torch.as_tensor(scfg.half_widths, dtype=torch.float32, device=dev)
    prep = sk.prepare_peraction_store(keys, vals, valid, hw, 11)
    obs = fr._obs_ori_soa(carry, in_state_indices(sc)).T.contiguous()
    part = sk.query_peraction_prepared(
        prep, coll.all_gather(obs, mesh).contiguous(),
        out_dtype=torch.float64).reshape(-1, 3)
    return dict(rank=mesh.rank, executed=out[4].cpu(), gated=out[5].cpu(),
                moments=coll.reduce_scatter(part, mesh).float().cpu(),
                launches=launches, seconds=seconds,
                rows=int(valid.sum()), envs=int(carry.ego.shape[-1]))


def _rank_trainer(mesh, p):
    """Rank program: the sharded trainer (kernel route) on this rank's
    envs, store and replay, its own generator; the replicated parameters
    compared across the ranks after every step; then the next step's
    rule-column moments of the whole batch (the fleet's observations and
    512 probes at the rank's stored rows), reduce-scattered."""
    from dcarl_tpu_torch import disable_tf32
    from dcarl_tpu_torch.config import DCARLConfig, driving_store_config
    from dcarl_tpu_torch.ops import _cuda, store_kernels as sk
    from dcarl_tpu_torch.parallel import collectives as coll
    from dcarl_tpu_torch.train_fast import make_trainer_fast, rank_seed

    disable_tf32()
    dev = mesh.device
    scfg = driving_store_config()
    init_fn, step_fn, learner, _ = make_trainer_fast(
        DCARLConfig(store=scfg), batch_per_device=p["envs"],
        store_capacity_per_device=p["capacity"],
        replay_capacity_per_device=p["capacity"],
        backfill_budget_per_step=p["budget"], use_kernel=True, mesh=mesh)
    state = init_fn(p["seed"])
    gen = torch.Generator(device=dev).manual_seed(
        rank_seed(p["seed"] + 1, mesh.rank))
    equal_steps, losses = 0, []
    _cuda.LAUNCHES.clear()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(p["steps"]):
        state, m = step_fn(state, gen)
        losses.append(m.loss)
        flat = torch.cat([t.reshape(-1) for t in
                          learner.net.state_dict().values()])[None]
        every = coll.all_gather(flat, mesh)
        equal_steps += int(all(torch.equal(every[0], x) for x in every))
    sync(dev)
    seconds = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    hw = torch.as_tensor(scfg.half_widths, dtype=torch.float32, device=dev)
    obs = torch.cat([state.obs_ori[0].T, state.store_keys[0][:512, :-1]])
    obs_q = coll.all_gather(obs.contiguous(), mesh)
    q = torch.cat([obs_q, torch.zeros_like(obs_q[:, :1])], 1)[None]
    n = int(state.store_size[0])
    valid = torch.arange(state.store_keys.shape[1], device=dev) < n
    part = sk.box_query_moments_grouped(state.store_keys[0],
                                        state.store_values[0], valid, q,
                                        hw)[0]
    return dict(rank=mesh.rank, moments=coll.reduce_scatter(part, mesh).cpu(),
                obs=obs.cpu(), keys=state.store_keys[0][:n].cpu(),
                values=state.store_values[0][:n].cpu(), launches=launches,
                seconds=seconds, equal_steps=equal_steps,
                loss=torch.stack(losses).cpu())


def two_rank_phase(sk, hw, carry0, store, ref_out, main_t: int,
                   train_envs: int = 16384, train_steps: int = 20,
                   train_capacity: int = 1 << 16):
    """Two gloo ranks on the one card (``parallel.launch.run_ranks``):
    the gated driver on 32,768 envs a rank against its stripe of the
    2^18-row store, held to the one-rank run on the whole batch; the
    trainer on 16,384 envs a rank for 20 steps, its parameters bit-equal
    across the ranks after every step, its reduced rule-column moments
    held to one sorted_moments launch on the merged store.  A one-card
    correctness run: its rates are no scaling figure."""
    from dcarl_tpu_torch.parallel.launch import run_ranks

    keys, vals, valid = (t.cpu() for t in store)
    rank_dev = "cuda:0" if hw.device.type == "cuda" else "cpu"
    t0 = time.perf_counter()
    gated = run_ranks(_rank_gated, 2, "gloo", rank_dev,
                      timeout_s=RANKS_TIMEOUT_S,
                      args=({"carry": tuple(t.cpu() for t in carry0),
                             "keys": keys, "values": vals, "valid": valid,
                             "ticks": main_t, "seed": SEED + 9},))
    gated_wall = time.perf_counter() - t0
    for name, i in (("executed", 4), ("gated", 5)):
        got = torch.cat([g[name] for g in gated], dim=1)
        want = ref_out[i].cpu()
        if not torch.equal(got, want):
            tick, env = (int(x) for x in (got != want).nonzero()[0])
            fail(f"sharded, two ranks: {name} actions differ from the "
                 f"one-rank run on the whole batch, first at tick {tick}, "
                 f"env {env}: {int(got[tick, env])} != "
                 f"{int(want[tick, env])}")
    on_card = rank_dev != "cpu"   # a CPU rehearsal runs the plain versions
    for g in gated:
        if on_card and g["launches"] != {"peraction_moments": main_t}:
            fail(f"sharded, two ranks: rank {g['rank']} launches "
                 f"{g['launches']} != {main_t} ticks")
    from dcarl_tpu_torch.env.driving_env import in_state_indices
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.planning.fast_rollout import _obs_ori_soa

    prep = sk.prepare_peraction_store(*store, hw, 11)
    q0 = _obs_ori_soa(carry0, in_state_indices(t_intersection())).T
    ref_m = sk.query_peraction_prepared(prep, q0.contiguous()).reshape(-1, 3)
    got_m = torch.cat([g["moments"] for g in gated]).to(ref_m.device)
    gated_err = compare(got_m, ref_m, "sharded_two_rank_gated_moments")

    envs, steps = train_envs, train_steps
    t0 = time.perf_counter()
    tr = run_ranks(_rank_trainer, 2, "gloo", rank_dev,
                   timeout_s=RANKS_TIMEOUT_S,
                   args=({"envs": envs, "capacity": train_capacity,
                          "budget": envs // 4, "steps": steps,
                          "seed": SEED + 11},))
    train_wall = time.perf_counter() - t0
    for t in tr:
        if on_card and t["launches"] != {"sorted_moments": steps}:
            fail(f"sharded, two ranks: trainer rank {t['rank']} launches "
                 f"{t['launches']} != {steps} steps")
        if t["equal_steps"] != steps:
            fail(f"sharded, two ranks: parameters differ across ranks "
                 f"after {steps - t['equal_steps']} of {steps} steps")
        if not torch.isfinite(t["loss"]).all():
            fail("sharded, two ranks: trainer loss not finite")
    dev = hw.device
    if sum(len(t["keys"]) for t in tr) == 0:
        fail("sharded, two ranks: the trainer's stores stayed empty")
    m_keys = torch.cat([t["keys"] for t in tr]).to(dev)
    m_vals = torch.cat([t["values"] for t in tr]).to(dev)
    obs = torch.cat([t["obs"] for t in tr]).to(dev)
    q = torch.cat([obs, torch.zeros_like(obs[:, :1])], 1)[None].contiguous()
    ref_t = sk.box_query_moments_grouped(
        m_keys, m_vals, torch.ones(len(m_keys), dtype=torch.bool, device=dev),
        q, hw)[0]
    got_t = torch.cat([t["moments"] for t in tr]).to(dev)
    if ref_t[:, 0].sum() > 0:
        train_err = compare(got_t, ref_t, "sharded_two_rank_trainer_moments")
    elif torch.equal(got_t, ref_t):
        train_err = 0.0
    else:
        fail("sharded, two ranks: the trainer's reduced moments are not the "
             "merged store's (no match)")
    return dict(
        note="two gloo ranks on one card: a correctness run, not a scaling "
             "figure",
        gated_envs=2 * gated[0]["envs"], gated_ticks=main_t,
        gated_rows_per_rank=[g["rows"] for g in gated],
        gated_launches=[g["launches"].get("peraction_moments", 0)
                        for g in gated],
        gated_rank_seconds=[g["seconds"] for g in gated],
        gated_env_steps_per_s=2 * gated[0]["envs"] * main_t
        / max(g["seconds"] for g in gated),
        gated_wall_seconds=gated_wall, gated_moments_max_abs_err=gated_err,
        gated_actions_equal=True,
        train_envs=2 * envs, train_steps=steps,
        train_launches=[t["launches"].get("sorted_moments", 0) for t in tr],
        train_rank_seconds=[t["seconds"] for t in tr],
        train_env_steps_per_s=2 * envs * steps
        / max(t["seconds"] for t in tr),
        train_wall_seconds=train_wall, params_equal_every_step=True,
        train_merged_rows=int(len(m_keys)),
        train_matches=int(ref_t[:, 0].sum()),
        train_moments_max_abs_err=train_err)


# ---------------------------------------------------------------------------
# The lane-level field stack: the multilane world, the RLS gate through
# sorted_moments at D = 21, cognition -> decision -> trajectory ->
# safeguard on a loop map, and an OpenDrive map
# ---------------------------------------------------------------------------

# MultiLaneEnvConfig()'s world at these fleet sizes
LANE_SIZES = dict(rule_envs=65536, rule_ticks=200, fill_envs=2048,
                  fill_ticks=128, capacity=1 << 17, gate_envs=65536,
                  gate_ticks=50, check_envs=4096)
FIELD_SIZES = dict(egos=16384, objects=8, ticks=50, window=256,
                   check_egos=256, check_every=5, hd_egos=1024)


def lane_phase(sk, _cuda, gpu: str, dev, sizes=LANE_SIZES) -> dict:
    """The multilane world (``env/multilane_env.py``) and its RLS gate:

    1. rule run: ``to_multilane_state -> lateral_decision ->
       step_autoreset`` (the field loop of tests/test_lane_stack.py:152);
    2. store fill: ``StoreConfig()``'s 2^17-row store from a behaviour
       policy (action 0, the rule, with probability 0.5, else uniform in
       1-7), records ``wrap_state || action`` with their n-step returns
       (``traj_push_lane``, reward 1 a surviving tick), the ring wrapping
       once;
    3. gated run: ``wrap_state -> all_action_stats -> act_test ->
       decision_from_discrete_action -> step_autoreset``, one
       ``sorted_moments`` launch a tick at D = 21; the first tick's
       launch held against the plain version on ``check_envs`` envs
       (counts exact, sums within rtol 1e-4 / atol 1e-3, equal gated
       actions under ``StoreConfig()`` and with the gate opened wide),
       and again bit-equal; a replay times each launch.

    On a CPU ``dev`` (a rehearsal at small sizes) the gate takes the
    kernel's plain version and no launch is counted.  Returns the kernel
    numbers of the gate."""
    from dcarl_tpu_torch.config import StoreConfig
    from dcarl_tpu_torch.core import rls as RLS
    from dcarl_tpu_torch.core import store as ST
    from dcarl_tpu_torch.env import multilane_env as ML
    from dcarl_tpu_torch.planning import decision as DEC
    from dcarl_tpu_torch.planning.lane_utility import lateral_decision

    cuda = dev.type == "cuda"
    cfg, scfg = ML.MultiLaneEnvConfig(), StoreConfig()
    hw = torch.tensor(ST.FIELD_HALF_WIDTHS, dtype=torch.float32, device=dev)
    n_act = scfg.num_candidate_actions
    gen = torch.Generator(device=dev).manual_seed(SEED + 30)
    t_phase = time.perf_counter()

    def counters():
        return {k: torch.zeros((), dtype=torch.int64, device=dev)
                for k in ("done", "collided", "left_road", "gated")}

    def tally(c, st, a=None):
        c["done"] += st.done.sum()
        c["collided"] += st.collided.sum()
        c["left_road"] += st.left_road.sum()
        if a is not None:
            c["gated"] += (a > 0).sum()

    def rates(c, n):
        return {f"{k}_rate": float(v) / n for k, v in c.items()}

    # 1. the rule run
    b, t = sizes["rule_envs"], sizes["rule_ticks"]
    st = ML.reset(b, gen, cfg, device=dev)
    c_rule = counters()
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(t):
        lane, speed = lateral_decision(ML.to_multilane_state(st, cfg))
        st, _, _ = ML.step_autoreset(st, lane, speed, gen, cfg)
        tally(c_rule, st)
    sync(dev)
    rule_s = time.perf_counter() - t0
    if not torch.isfinite(st.ego_s).all() or int(c_rule["done"]) == 0:
        fail("lane rule run: non-finite state or no episode ended")

    # 2. the store fill
    fb, ft = sizes["fill_envs"], sizes["fill_ticks"]
    ncfg = StoreConfig(value_mode="nstep")
    w = ncfg.n_step_window
    cap = sizes["capacity"]          # StoreConfig().capacity at full size
    store = ST.store_init(cap, scfg.key_dim, device=dev)
    st = ML.reset(fb, gen, cfg, device=dev)
    buf = (torch.zeros((w, scfg.key_dim - 1, fb), device=dev),
           torch.zeros((w, fb), device=dev), torch.zeros((w, fb), device=dev),
           torch.zeros((fb,), dtype=torch.int32, device=dev))
    inserted = torch.zeros((), dtype=torch.int64, device=dev)
    rule_taken = torch.zeros((), dtype=torch.int64, device=dev)
    sync(dev)
    t0 = time.perf_counter()
    for _ in range(ft):
        m = ML.to_multilane_state(st, cfg)
        obs = DEC.wrap_state(m)
        rule = torch.rand((fb,), generator=gen, device=dev) < 0.5
        a = torch.where(rule, 0, torch.randint(1, n_act, (fb,), generator=gen,
                                               device=dev))
        d = DEC.decision_from_discrete_action(m, a)
        st, r, done = ML.step_autoreset(st, d.target_lane_index,
                                        d.target_speed, gen, cfg)
        buf, recs = RLS.traj_push_lane(*buf, obs.T, a, r, done, ncfg)
        store = ST.store_insert(
            store, recs.keys.permute(0, 2, 1).reshape(-1, scfg.key_dim),
            recs.actions.reshape(-1), recs.values.reshape(-1),
            recs.valid.reshape(-1))
        inserted += recs.valid.sum()
        rule_taken += rule.sum()
    sync(dev)
    fill_s = time.perf_counter() - t0
    valid = ST.store_valid(store)
    if int(store.size) != cap or not cap < int(inserted) < 2 * cap \
            or not torch.isfinite(store.values).all():
        fail(f"lane store fill: {int(inserted)} records for a {cap}-row ring "
             "(it must wrap once) or non-finite values")
    vals = store.values[valid]

    # 3. the gated run; first the first tick's launch against the plain
    # version
    gb, gt, ce = sizes["gate_envs"], sizes["gate_ticks"], sizes["check_envs"]
    st0 = ML.reset(gb, torch.Generator(device=dev).manual_seed(SEED + 31),
                   cfg, device=dev)
    keys0 = RLS.candidate_keys(DEC.wrap_state(ML.to_multilane_state(st0, cfg)),
                               n_act).reshape(-1, scfg.key_dim).contiguous()
    ops, qorder = sk.sorted_query_operands(store.keys, store.values, valid,
                                           keys0, hw)
    out = sk.sorted_moments(ops)
    sync(dev)
    if not torch.equal(sk.sorted_moments(ops), out):
        fail("lane gate: two sorted_moments launches differ")
    pos = torch.empty_like(qorder)
    pos[qorder] = torch.arange(qorder.shape[0], device=dev)
    sub = pos[:ce * n_act]                       # band positions, env order
    chunk = 2048

    def plain_sub():
        return torch.cat([sk.sorted_moments_plain(ops._replace(
            q_t=ops.q_t[:, sub[i:i + chunk]].contiguous()))
            for i in range(0, sub.shape[0], chunk)])

    ref = plain_sub()
    got = out[sub]
    err = compare(got, ref, "lane_gate")
    gates = {}
    for label, gcfg in (("store_config", scfg),
                        ("open", StoreConfig(rule_good_thres=float("inf")))):
        acts = [RLS.act_test(RLS.ActionStats(*(f.reshape(ce, n_act) for f in
                                               ST.moments_to_stats(mom))),
                             gcfg) for mom in (got, ref)]
        if not torch.equal(acts[0], acts[1]):
            fail(f"lane gate ({label}): the kernel's moments and the plain "
                 "version's gate different actions")
        gates[label] = float((acts[0] > 0).float().mean())
    if cuda:
        ms = cuda_ms(lambda: sk.sorted_moments(ops))
        plain_ms = cuda_ms(plain_sub, reps=1)
        sub_ops, _ = sk.sorted_query_operands(store.keys, store.values, valid,
                                              keys0[:ce * n_act], hw)
        sub_ms = cuda_ms(lambda: sk.sorted_moments(sub_ops))
    else:
        ms = plain_ms = sub_ms = float("nan")
    keep = sk.sorted_prune_keep(ops)

    def gated_run(seed):
        g = torch.Generator(device=dev).manual_seed(seed)
        s, c = st0, counters()
        for _ in range(gt):
            m = ML.to_multilane_state(s, cfg)
            a = RLS.act_test(RLS.all_action_stats(
                store, DEC.wrap_state(m), hw, n_act, use_kernel=True), scfg)
            d = DEC.decision_from_discrete_action(m, a)
            s, _, _ = ML.step_autoreset(s, d.target_lane_index,
                                        d.target_speed, g, cfg)
            tally(c, s, a)
        return s, c

    _cuda.LAUNCHES.clear()
    sync(dev)
    t0 = time.perf_counter()
    st_g, c_gate = gated_run(SEED + 32)
    sync(dev)
    gate_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    if cuda and launches != {"sorted_moments": gt}:
        fail(f"lane gate: kernel launches {launches} != {gt} ticks")
    if not torch.isfinite(st_g.ego_s).all():
        fail("lane gate: non-finite state")
    summ = {}
    if cuda:
        record = []
        with timed_launches(sk, "launch_sorted", record,
                            sorted_probe(sk, _cuda)):
            sync(dev)
            t0 = time.perf_counter()
            st_r, c_r = gated_run(SEED + 32)
            sync(dev)
            replay_s = time.perf_counter() - t0
        if not torch.equal(st_r.ego_s, st_g.ego_s):
            fail("lane gate: the replay differs from the counted run")
        summ = summarize(record)
        summ["replay_env_steps_per_s"] = gb * gt / replay_s
        summ["kernel_share_of_replay"] = summ["kernel_ms_sum"] / (replay_s * 1e3)
    emit("lane", rule=dict(envs=b, ticks=t, seconds=rule_s,
                           env_steps_per_s=b * t / rule_s,
                           **rates(c_rule, b * t)),
         fill=dict(envs=fb, ticks=ft, seconds=fill_s, records=int(inserted),
                   store_rows=int(store.size), capacity=cap,
                   rule_share=float(rule_taken) / (fb * ft),
                   value_mean=float(vals.mean()), value_min=float(vals.min()),
                   value_max=float(vals.max())),
         gate=dict(envs=gb, ticks=gt, queries_per_launch=int(keys0.shape[0]),
                   key_dim=scfg.key_dim, store_rows=int(valid.sum()),
                   seconds=gate_s, env_steps_per_s=gb * gt / gate_s,
                   launches=launches, activation_share=rates(
                       c_gate, gb * gt)["gated_rate"],
                   **{k: v for k, v in rates(c_gate, gb * gt).items()
                      if k != "gated_rate"}),
         first_tick=dict(check_envs=ce, queries=int(sub.shape[0]),
                         max_abs_err=err, matches=int(ref[:, 0].sum()),
                         matched_query_share=float((ref[:, 0] > 0).float()
                                                   .mean()),
                         counts_exact=True, bit_equal_repeat=True,
                         activation_share=gates, actions_equal=True,
                         kernel_ms=ms, kernel_ms_check_queries=sub_ms,
                         plain_ms_check_queries=plain_ms,
                         kept_subslice_share=float(keep.float().mean()),
                         band_dim_w=float(ops.w0)),
         **summ, seconds=time.perf_counter() - t_phase, gpu=gpu)
    return dict(launches=launches.get("sorted_moments", 0), max_abs_err=err,
                ms=summ.get("kernel_ms_mean", ms), plain_ms=plain_ms,
                plain_queries=int(sub.shape[0]),
                bound_ms=summ.get("bound_ms_mean"),
                bound_by=summ.get("bound_by"))


XODR = """<?xml version="1.0"?>
<OpenDRIVE>
  <road id="1" length="100" junction="-1">
    <link><successor elementType="junction" elementId="10"/></link>
    <planView><geometry s="0" x="0" y="0" hdg="0" length="100"/></planView>
    <lanes><laneSection s="0"><right>
      <lane id="-1" type="driving"><width sOffset="0" a="3.5"/></lane>
      <lane id="-2" type="driving"><width sOffset="0" a="3.5"/></lane>
    </right></laneSection></lanes>
    <type s="0" type="town"><speed max="54" unit="km/h"/></type>
  </road>
  <road id="5" length="10" junction="10">
    <link><successor elementType="road" elementId="2"/></link>
    <planView><geometry s="0" x="100" y="0" hdg="0" length="10"/></planView>
    <lanes><laneSection s="0"><right>
      <lane id="-1" type="driving"><width sOffset="0" a="3.5"/></lane>
    </right></laneSection></lanes>
  </road>
  <road id="2" length="100" junction="-1">
    <link><predecessor elementType="junction" elementId="10"/></link>
    <planView><geometry s="0" x="110" y="0" hdg="0" length="100"/></planView>
    <lanes><laneSection s="0">
      <right><lane id="-1" type="driving"><width sOffset="0" a="3.5"/></lane></right>
      <left><lane id="1" type="driving"><width sOffset="0" a="3.5"/></lane></left>
    </laneSection></lanes>
  </road>
  <junction id="10">
    <connection id="0" incomingRoad="1" connectingRoad="5">
      <laneLink from="-1" to="-1"/>
    </connection>
  </junction>
</OpenDRIVE>
"""


class FieldWorld(NamedTuple):
    """The field phase's simulated world on the loop map: each ego and
    each tracked object drives around the loop at a continuous lane
    index (0 = outer lane) and an angle."""

    theta: torch.Tensor      # [B] ego angle on the loop
    lane: torch.Tensor       # [B] continuous lane index
    v: torch.Tensor          # [B] speed
    obj_theta: torch.Tensor  # [B, K]
    obj_lane: torch.Tensor   # [B, K] (integer lanes)
    obj_v: torch.Tensor      # [B, K]
    obj_valid: torch.Tensor  # [B, K] bool


def field_world(b: int, k: int, gen, dev) -> FieldWorld:
    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=gen, device=dev)

    theta = u((b,), 0.0, 2 * math.pi)
    return FieldWorld(
        theta=theta,
        lane=torch.randint(0, 2, (b,), generator=gen, device=dev).float(),
        v=u((b,), 5.0, 12.0),
        obj_theta=theta[:, None] + u((b, k), -0.15, 0.15),
        obj_lane=torch.randint(0, 2, (b, k), generator=gen, device=dev).float(),
        obj_v=u((b, k), 4.0, 12.0),
        obj_valid=torch.rand((b, k), generator=gen, device=dev) < 0.9)


def field_poses(wd: FieldWorld, radius: float, lane_sep: float):
    """The ego pose and the tracked-object table of a world."""
    from dcarl_tpu_torch.cognition.locator import EgoPose, TrackedObjects

    def pose(theta, lane, v):
        r = radius - lane_sep * lane
        c, s = torch.cos(theta), torch.sin(theta)
        return r * c, r * s, -v * s, v * c, theta + math.pi / 2

    ego = EgoPose(*pose(wd.theta, wd.lane, wd.v))
    return ego, TrackedObjects(*pose(wd.obj_theta, wd.obj_lane, wd.obj_v),
                               valid=wd.obj_valid)


def field_tick(lmap, route_line, route, pb, ego, objs, window: int):
    """One 5 Hz tick of the field stack for a batch of egos: the local map
    (``window_static_map``), the world model (``update_map_state``), the
    rule decision (``lateral_decision``), the RL state (``wrap_state``),
    the local trajectory on the target lane's window (``get_trajectory``),
    the reachable-set speed cap (``get_safeguard_speed``, 8 scales), the
    reference-path buffer and the route's lead-vehicle hazard.  Returns
    (outputs, path buffer', route')."""
    from dcarl_tpu_torch.cognition.locator import update_map_state
    from dcarl_tpu_torch.cognition.path_buffer import path_buffer_update
    from dcarl_tpu_torch.navigation import route as R
    from dcarl_tpu_torch.navigation.map_provider import window_static_map
    from dcarl_tpu_torch.planning.decision import wrap_state
    from dcarl_tpu_torch.planning.lane_utility import lateral_decision
    from dcarl_tpu_torch.planning.local_trajectory import get_trajectory
    from dcarl_tpu_torch.planning.safeguard import get_safeguard_speed

    smap = window_static_map(lmap, ego.x, ego.y, window=window)
    mmap, model, behaviors = update_map_state(smap, ego, objs)
    lane, speed = lateral_decision(mmap)
    obs = wrap_state(mmap)
    tgt = torch.clamp(lane, 0, smap.num_lanes - 1).to(torch.int64)
    center = torch.gather(smap.lanes, 1, tgt[:, None, None, None].expand(
        -1, 1, window, 2))[:, 0]
    traj = get_trajectory(center, ego.x, ego.y, ego.yaw, speed,
                          mmap.ego_lane_index, tgt.to(speed.dtype), n_out=64)
    obstacles = torch.stack([objs.x, objs.y, objs.vx, objs.vy, objs.yaw], -1)
    v_safe = get_safeguard_speed(traj.points,
                                 speed[:, None].expand(-1, 64).contiguous(),
                                 obstacles, objs.valid)
    pb, _, _, junction = path_buffer_update(pb, route_line, ego.x, ego.y,
                                            torch.hypot(ego.vx, ego.vy))
    route = R.advance(route, ego.x, ego.y)
    hazard = R.hazard_vehicle_ahead(route, ego.x, ego.y,
                                    torch.stack([objs.x, objs.y], -1),
                                    objs.valid)
    out = dict(model=model, lane_rounded=torch.round(mmap.ego_lane_index),
               target_lane=lane, lane_change=traj.lane_change,
               behaviors=behaviors, front_exists=mmap.front.exists,
               stopped=v_safe[:, 0] == 0, hazard=hazard, junction=junction,
               cursor=pb.cursor, route_cursor=route.cursor,
               ego_lane_index=mmap.ego_lane_index, front_s=mmap.front.s,
               rear_s=mmap.rear.s, target_speed=speed, obs=obs,
               points=traj.points, v_safe=v_safe)
    return out, pb, route


FIELD_INTEGER = ("model", "lane_rounded", "target_lane", "lane_change",
                 "behaviors", "front_exists", "stopped", "hazard", "junction",
                 "cursor", "route_cursor")


def field_move(wd: FieldWorld, v_cmd, lane_cmd, radius, lane_sep,
               dt: float = 0.2) -> FieldWorld:
    """The world one tick on: each ego tracks its speed command and slews
    toward its target lane at one lane a second; the objects keep their
    lane and speed."""
    v = torch.clamp(wd.v + torch.clamp(v_cmd - wd.v, -4.0 * dt, 2.5 * dt),
                    0.0, 30.0)
    lane = torch.clamp(wd.lane + torch.clamp(lane_cmd.to(wd.lane.dtype)
                                             - wd.lane, -dt, dt), 0.0, 1.0)
    return wd._replace(
        theta=wd.theta + v * dt / (radius - lane_sep * lane), lane=lane, v=v,
        obj_theta=wd.obj_theta + wd.obj_v * dt
        / (radius - lane_sep * wd.obj_lane))


def _field_compare(got: dict, ref: dict, what: str) -> float:
    """Integer outputs equal, real ones within rtol 1e-5 / atol 1e-4;
    returns the largest real difference."""
    worst = 0.0
    for k, r in ref.items():
        g = got[k].cpu()
        if k in FIELD_INTEGER:
            if not torch.equal(g, r):
                n = int((g != r).sum())
                fail(f"{what}: {k} differs from the CPU run in {n} entries")
        else:
            if not torch.allclose(g, r, rtol=1e-5, atol=1e-4):
                fail(f"{what}: {k} differs from the CPU run beyond "
                     "rtol 1e-5 / atol 1e-4")
            worst = max(worst, float((g - r).abs().max()))
    return worst


def field_phase(gpu: str, dev, sizes=FIELD_SIZES) -> None:
    """Cognition -> decision -> trajectory -> safeguard for a fleet of
    egos on ``synthetic_loop_map(n_lanes=2, n_points=1024, radius=200)``,
    each with ``objects`` tracked objects, ``ticks`` ticks at 5 Hz
    (:func:`field_tick`), timed without probes; a replay keeps the first
    ``check_egos`` egos' inputs and outputs every ``check_every`` ticks and
    the same ticks rerun on the CPU must give equal integer outputs and
    real ones within rtol 1e-5 / atol 1e-4.  Then the OpenDrive leg:
    ``parse_opendrive`` of a two-road-and-junction network,
    ``LocalHdMap`` -> ``update_map_state`` for ``hd_egos`` egos, held
    against the CPU the same way."""
    from dcarl_tpu_torch.cognition.locator import (EgoPose, TrackedObjects,
                                                   update_map_state)
    from dcarl_tpu_torch.cognition.path_buffer import path_buffer_init
    from dcarl_tpu_torch.navigation import route as R
    from dcarl_tpu_torch.navigation.map_provider import synthetic_loop_map
    from dcarl_tpu_torch.navigation.opendrive import LocalHdMap, parse_opendrive

    radius, sep = 200.0, 3.5
    b, k, t, win = (sizes[x] for x in ("egos", "objects", "ticks", "window"))
    nc, every = sizes["check_egos"], sizes["check_every"]
    cpu = torch.device("cpu")
    t_phase = time.perf_counter()

    def setup(where, n):
        lmap = synthetic_loop_map(n_lanes=2, n_points=1024, radius=radius,
                                  lane_sep=sep, device=where)
        line = torch.cat([lmap.loops[0], lmap.loops[0][:1]])   # closed
        route = R.make_route(line.cpu().numpy(), batch_shape=(n,),
                             device=where)
        return lmap, line, route

    lmap, line, route0 = setup(dev, b)
    world0 = field_world(b, k, torch.Generator(device=dev).manual_seed(
        SEED + 40), dev)
    pb0 = path_buffer_init((b,), device=dev)

    def cut(nt):
        return type(nt)(*(x[:nc].cpu() for x in nt))

    def run(keep: bool):
        wd, pb, route = world0, pb0, route0
        kept = []
        for i in range(t):
            ego, objs = field_poses(wd, radius, sep)
            inputs = (cut(ego), cut(objs), cut(pb), route.cursor[:nc].cpu())
            out, pb, route = field_tick(lmap, line, route, pb, ego, objs, win)
            if keep and i % every == 0:
                kept.append(inputs + ({key: v[:nc] for key, v in
                                       out.items()},))
            # the reference's safeguard node passes the decision through
            # (reachable_set:17-69): the world follows the decision's
            # speed, the cap is computed and reported
            wd = field_move(wd, out["target_speed"], out["target_lane"],
                            radius, sep)
        return wd, out, kept

    sync(dev)
    t0 = time.perf_counter()
    wd_end, out_end, _ = run(False)
    sync(dev)
    run_s = time.perf_counter() - t0
    if not all(torch.isfinite(v).all() for v in (out_end["v_safe"],
                                                 out_end["obs"],
                                                 out_end["points"])):
        fail("field: non-finite outputs")
    _, _, kept = run(True)

    # the same ticks on the CPU from the kept inputs
    lmap_c, line_c, route_c = setup(cpu, nc)
    worst = 0.0
    t0 = time.perf_counter()
    for ego, objs, pb, cursor, got in kept:
        ref, _, _ = field_tick(lmap_c, line_c, route_c._replace(cursor=cursor),
                               pb, ego, objs, win)
        worst = max(worst, _field_compare(got, ref, "field"))
    cpu_s = time.perf_counter() - t0
    share = {key: float(out_end[key].float().mean())
             for key in ("lane_change", "stopped", "hazard", "junction")}

    # the OpenDrive leg: one parsed network, a fleet of egos on road 1
    roads, junctions = parse_opendrive(XODR)
    hb = sizes["hd_egos"]
    g = torch.Generator(device=dev).manual_seed(SEED + 41)

    def u(shape, lo, hi):
        return lo + (hi - lo) * torch.rand(shape, generator=g, device=dev)

    lane_y = torch.where(torch.rand((hb,), generator=g, device=dev) < 0.5,
                         -1.75, -5.25)
    ex = u((hb,), 5.0, 95.0)
    ego = EgoPose(ex, lane_y + u((hb,), -0.4, 0.4), u((hb,), 4.0, 10.0),
                  u((hb,), -0.3, 0.3), u((hb,), -0.05, 0.05))
    oy = torch.where(torch.rand((hb, k), generator=g, device=dev) < 0.5,
                     -1.75, -5.25)
    objs = TrackedObjects(ex[:, None] + u((hb, k), -30.0, 30.0), oy,
                          u((hb, k), 0.0, 12.0), u((hb, k), -1.0, 1.0),
                          u((hb, k), -0.4, 0.4),
                          torch.rand((hb, k), generator=g, device=dev) < 0.9)
    hd = []
    for where, n in ((dev, hb), (cpu, nc)):
        smap = LocalHdMap(XODR, route=["1", "2"], device=where).update(
            20.0, -1.75)
        if smap is None:
            fail("field hdmap: no map published on road 1")
        hd.append(update_map_state(
            smap, EgoPose(*(f[:n].to(where) for f in ego)),
            TrackedObjects(*(f[:n].to(where) for f in objs))))
    (mm_d, model_d, beh_d), (mm_c, model_c, beh_c) = hd
    hd_got = dict(model=model_d[:nc], lane_rounded=torch.round(
        mm_d.ego_lane_index[:nc]), behaviors=beh_d[:nc],
        front_exists=mm_d.front.exists[:nc],
        ego_lane_index=mm_d.ego_lane_index[:nc], front_s=mm_d.front.s[:nc],
        rear_s=mm_d.rear.s[:nc])
    hd_ref = dict(model=model_c, lane_rounded=torch.round(mm_c.ego_lane_index),
                  behaviors=beh_c, front_exists=mm_c.front.exists,
                  ego_lane_index=mm_c.ego_lane_index, front_s=mm_c.front.s,
                  rear_s=mm_c.rear.s)
    hd_worst = _field_compare(hd_got, hd_ref, "field hdmap")
    emit("field", egos=b, objects=k, ticks=t, window=win, seconds=run_s,
         ticks_per_s=t / run_s, ego_ticks_per_s=b * t / run_s,
         check_egos=nc, checked_ticks=len(kept), cpu_check_seconds=cpu_s,
         integer_outputs_equal=True, max_real_abs_diff=worst,
         shares_last_tick=share,
         safeguard_stop_share=float(out_end["stopped"].float().mean()),
         mean_speed_last_tick=float(wd_end.v.mean()),
         hdmap=dict(roads=len(roads), junctions=len(junctions), egos=hb,
                    junction_model_share=float((model_d == 0).float().mean()),
                    front_exists_share=float(mm_d.front.exists.float().mean()),
                    integer_outputs_equal=True, max_real_abs_diff=hd_worst),
         seconds_total=time.perf_counter() - t_phase, gpu=gpu)


# ---------------------------------------------------------------------------
# The algorithm family (algos/) and the vec-env wrappers (parallel/vec_env,
# control/calibration, utils/profiling, utils/nan_guard)

# DDPG and TD3 clear tests/test_algos.py's threshold from some seeds and not
# others, in the JAX package too (2 and 3 of seeds 0-7 on the CPU:
# tools/algo_seed_rates.py);
# the card runs these seeds, fixed before the first run, and each must
# clear it from one of them at least
OFF_POLICY_SEEDS = tuple(range(8))
ALGO_CHECK_UPDATES = 3


def _algo_cases(dev):
    """name -> (make() -> (init, update[, act]), init args, updates, env
    steps an update): tests/test_algos.py's configurations."""
    from dcarl_tpu_torch.algos import (a2c, acer, acktr, common as C, ddpg,
                                       gail, ppo, sac, td3, trpo)

    env, box = C.identity_env(3), C.identity_env_box(1)
    ids = np.random.default_rng(0).integers(0, 3, 512)
    exp_obs = torch.as_tensor(np.eye(3, dtype=np.float32)[ids], device=dev)
    exp_act = torch.as_tensor(ids, device=dev)
    off = dict(batch_size=64, replay_capacity=4096)
    return {
        "a2c": (lambda: a2c.make_a2c(env, a2c.A2CConfig(n_steps=8)),
                (32,), 300, 8 * 32),
        "ppo": (lambda: ppo.make_ppo(env, ppo.PPOConfig(
            n_steps=32, n_epochs=4, n_minibatches=4)), (32,), 40, 32 * 32),
        "ppo_continuous": (lambda: ppo.make_ppo(box, ppo.PPOConfig(
            n_steps=32, learning_rate=1e-3)), (32,), 150, 32 * 32),
        "ppo1": (lambda: ppo.make_ppo(env, ppo.ppo1_config(60)._replace(
            n_steps=16)), (16,), 60, 16 * 16),
        "trpo": (lambda: trpo.make_trpo(env, trpo.TRPOConfig(
            n_steps=64, max_kl=0.05)), (32,), 40, 64 * 32),
        "acktr": (lambda: acktr.make_acktr(env, acktr.ACKTRConfig(n_steps=8)),
                  (16,), 150, 8 * 16),
        "acer": (lambda: acer.make_acer(env, acer.ACERConfig(
            n_steps=8, buffer_segments=16, replay_start=2), batch=16),
            (), 150, 8 * 16),
        "gail": (lambda: gail.make_gail(env, exp_obs, exp_act, gail.GAILConfig(
            trpo=trpo.TRPOConfig(n_steps=16, entcoeff=0.01))),
            (32,), 150, 3 * 16 * 32),
        "ddpg": (lambda: ddpg.make_ddpg(box, ddpg.DDPGConfig(
            actor_lr=1e-3, critic_lr=1e-3, **off)), (32,), 800, 32),
        "td3": (lambda: td3.make_td3(box, td3.TD3Config(
            actor_lr=1e-3, critic_lr=1e-3, **off)), (32,), 800, 32),
        "sac": (lambda: sac.make_sac(box, sac.SACConfig(lr=1e-3, **off)),
                (32,), 800, 32),
    }


def _train_algo(name, case, gen):
    """Train one learner on ``gen``'s device; (state, score, seconds)."""
    from dcarl_tpu_torch.algos import nets

    make, init_args, n, _ = case
    fns = make()
    init, upd = fns[0], fns[1]
    state = init(gen, *init_args)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    rewards = []
    key = "adversary_reward" if name == "gail" else "reward_mean"
    for _ in range(n):
        state, m = upd(state, gen)
        rewards.append(m[key])
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    r = torch.stack(rewards).cpu().numpy()
    if name in ("ddpg", "td3", "sac"):
        score = float(torch.mean(torch.abs(fns[2](state, state.obs)
                                           - state.obs)))
    elif name == "gail":
        logits, _ = nets.apply(upd.trpo.net, state.trpo.params,
                               torch.eye(3, device=gen.device))
        score = torch.argmax(logits, -1).tolist()
    else:
        last = {"a2c": 20, "acktr": 20, "acer": 20, "ppo1": 10}.get(name, 5)
        score = float(np.mean(r[-last:]))
    return state, score, secs


ALGO_PASS = {
    "a2c": lambda s: s > 0.8, "ppo": lambda s: s > 0.8,
    "ppo_continuous": lambda s: s > -0.15, "ppo1": lambda s: s > 0.8,
    "trpo": lambda s: s > 0.7, "acktr": lambda s: s > 0.9,
    "acer": lambda s: s > 0.9, "gail": lambda s: s == [0, 1, 2],
    "ddpg": lambda s: s < 0.15, "td3": lambda s: s < 0.15,
    "sac": lambda s: s < 0.2, "her_dqn": lambda s: s > 0.55,
}


def _her_learn(dev, gen):
    """tests/test_algos.py::test_her_dqn_bitflip: 300 updates (16
    episodes, 8 sampled batches each), then the greedy policy on 64
    fresh boards; (state, solved share, seconds)."""
    from dcarl_tpu_torch.algos import her

    n_bits = 5
    init, upd, q_fn, (reset_fn, step_fn, T) = her.make_her_dqn(
        n_bits, her.HERDQNConfig(buffer_episodes=256))
    state = init(gen)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(300):
        state = upd(state, gen)
    torch.cuda.synchronize()
    secs = time.perf_counter() - t0
    st, obs = reset_fn(her.bitflip_draws((64,), n_bits, gen))
    solved = torch.zeros((64,), dtype=torch.bool, device=dev)
    for _ in range(T):
        a = torch.argmax(q_fn(state, obs), dim=-1)
        st, obs, rew, _ = step_fn(st, a, her.bitflip_draws((64,), n_bits, gen))
        solved = solved | (rew == 0.0)
    return state, float(solved.float().mean()), secs


def _small_algos(dev):
    """name -> (fns made for ``dev``, init args, draw extra args, loose):
    the CPU tests' configurations (tests/test_torch_algos_*.py)."""
    from dcarl_tpu_torch.algos import (a2c, acer, acktr, common as C, ddpg,
                                       gail, her, ppo, sac, td3, trpo)

    env, box, hid = C.identity_env(3), C.identity_env_box(2), (16, 16)
    small_ppo = ppo.PPOConfig(n_steps=4, n_epochs=2, n_minibatches=2,
                              learning_rate=1e-3)
    off = dict(batch_size=16, replay_capacity=64, train_start=8)
    ids = np.random.default_rng(0).integers(0, 3, 32)
    return {
        "a2c": (a2c.make_a2c(env, a2c.A2CConfig(n_steps=4), hid), (8,), (),
                False),
        "ppo": (ppo.make_ppo(env, small_ppo, hid), (8,), (), False),
        "ppo_continuous": (ppo.make_ppo(box, small_ppo, hid), (8,), (), False),
        "ppo1": (ppo.make_ppo(env, ppo.ppo1_config(4)._replace(n_steps=4),
                              hid), (8,), (), False),
        "trpo": (trpo.make_trpo(env, trpo.TRPOConfig(n_steps=8, max_kl=0.05),
                                hid), (8,), (), True),
        "acktr": (acktr.make_acktr(env, acktr.ACKTRConfig(n_steps=4), hid),
                  (8,), (), True),
        "acer": (acer.make_acer(env, acer.ACERConfig(
            n_steps=4, buffer_segments=4, replay_start=2, replay_ratio=2),
            batch=8), (), (), True),
        "gail": (gail.make_gail(
            env, torch.as_tensor(np.eye(3, dtype=np.float32)[ids],
                                 device=dev),
            torch.as_tensor(ids, device=dev), gail.GAILConfig(
                trpo=trpo.TRPOConfig(n_steps=4, entcoeff=0.01), g_step=2,
                d_batch=16, hidden_size_adversary=16), hid), (8,), (), True),
        "ddpg": (ddpg.make_ddpg(box, ddpg.DDPGConfig(**off), hid), (8,), (),
                 False),
        "td3": (td3.make_td3(box, td3.TD3Config(**off), hid), (8,), (), False),
        "sac": (sac.make_sac(box, sac.SACConfig(**off), hid), (8,), (), False),
        "her_dqn": (her.make_her_dqn(4, her.HERDQNConfig(
            batch_size=16, buffer_episodes=16, target_period=2), (32,)),
            (), (8, 2), False),
    }


def _to(tree, dev):
    from dcarl_tpu_torch.parallel.mesh import tree_map
    return tree_map(lambda x: x.to(dev), tree)


def _card_vs_cpu(dev) -> dict:
    """Each learner ALGO_CHECK_UPDATES updates on the card and on the CPU
    from the same init on the same draws (made on the CPU): integer and
    bool state (env categories, step counters, replay and buffer
    indices) and TRPO's accepted backtrack index equal, floats within
    the CPU tests' tolerances (rtol 1e-5 / atol 1e-6; TRPO, ACKTR, ACER
    and GAIL's TRPO rtol 1e-4 / atol 1e-5)."""
    from dcarl_tpu_torch.algos.common import tree_leaves

    cpu = torch.device("cpu")
    cpu_fns, card_fns = _small_algos(cpu), _small_algos(dev)
    out = {}
    for name, (fns, init_args, draw_args, loose) in cpu_fns.items():
        upd_c, upd_g = fns[1], card_fns[name][0][1]
        gc = torch.Generator().manual_seed(SEED)
        s_c = fns[0](gc, *init_args)
        s_g = _to(s_c, dev)
        worst, backtracks = 0.0, []
        rtol, atol = (1e-4, 1e-5) if loose else (1e-5, 1e-6)
        for _ in range(ALGO_CHECK_UPDATES):
            d = upd_c.draw(s_c, gc, *draw_args)
            out_c = upd_c.with_draws(s_c, d)
            out_g = upd_g.with_draws(s_g, _to(d, dev))
            if name == "her_dqn":
                (s_c, m_c), (s_g, m_g) = (out_c, {}), (out_g, {})
            else:
                (s_c, m_c), (s_g, m_g) = out_c, out_g
            if "backtrack" in m_c:
                if int(m_c["backtrack"]) != int(m_g["backtrack"]):
                    fail(f"algos: {name} card backtrack "
                         f"{int(m_g['backtrack'])} != CPU "
                         f"{int(m_c['backtrack'])}")
                backtracks.append(int(m_g["backtrack"]))
            for a, b in zip(tree_leaves(s_g), tree_leaves(s_c)):
                a = a.cpu()
                if not b.is_floating_point():
                    if not torch.equal(a, b):
                        fail(f"algos: {name} card integer state != CPU")
                    continue
                err = (a - b).abs()
                if bool((err > atol + rtol * b.abs()).any()):
                    fail(f"algos: {name} card vs CPU beyond rtol {rtol} / "
                         f"atol {atol}: {float(err.max())}")
                worst = max(worst, float(err.max()) if err.numel() else 0.0)
        out[name] = {"max_abs_err": worst, "rtol": rtol, "atol": atol,
                     **({"backtracks": backtracks} if backtracks else {})}
    return out


def _rollout_actions_vs_cpu(dev) -> dict:
    """A categorical and a Gaussian policy's 16-step rollouts of 256 envs
    on the same draws: the card's sampled actions equal the CPU's."""
    from dcarl_tpu_torch.algos import common as C
    from dcarl_tpu_torch.algos import nets

    out = {}
    for kind in ("categorical", "gaussian"):
        env = C.identity_env(3) if kind == "categorical" \
            else C.identity_env_box(2)
        net = nets.CategoricalActorCritic(3, 3) if kind == "categorical" \
            else nets.GaussianActorCritic(2, 2)
        g = torch.Generator().manual_seed(SEED)
        params = nets.init_params(lambda gg: type(net)(
            env.obs_dim, 3 if kind == "categorical" else 2, generator=gg), g)
        st, obs = env.reset(env.draw((256,), g))
        draws = C.rollout_draws(env, 16, 256, (3,) if kind == "categorical"
                                else (2,), g, "gumbel" if kind ==
                                "categorical" else "normal")

        def run(p, st, obs, d):
            def policy(o, x):
                out = nets.apply(net, p, o)
                if kind == "categorical":
                    return C.categorical_sample(out[0], x)
                return out[0] + torch.exp(out[1]) * x
            return C.collect_rollout(env, policy, st, obs, d)[2]

        tc = run(params, st, obs, draws)
        tg = run(*_to((params, st, obs, draws), dev))
        if kind == "categorical":
            diff = int((tg.action.cpu() != tc.action).sum())
            if diff:
                fail(f"algos: {diff} sampled actions differ card vs CPU")
            out[kind] = {"actions": tc.action.numel(), "differ": 0}
        else:
            err = float((tg.action.cpu() - tc.action).abs().max())
            if err > 1e-5:
                fail(f"algos: Gaussian actions card vs CPU differ by {err}")
            out[kind] = {"actions": tc.action.numel(), "max_abs_err": err}
    return out


def _rank_ppo(mesh, p=None):
    """Rank program: PPO on the identity env over the mesh (8 envs a
    rank, n_steps 4, 2 x 2 minibatches) from one init: on the same draws
    as a one-rank update, and on this rank's own draws."""
    from dcarl_tpu_torch.algos import common as C
    from dcarl_tpu_torch.algos import ppo as PPO

    dev = mesh.device
    env = C.identity_env(3)
    cfg = PPO.PPOConfig(n_steps=4, n_epochs=2, n_minibatches=2)
    init, upd_mesh = PPO.make_ppo(env, cfg, (16, 16), mesh=mesh)
    _, upd_one = PPO.make_ppo(env, cfg, (16, 16))
    state = init(torch.Generator(device=dev).manual_seed(0), 8)
    draws = upd_one.draw(state, torch.Generator(device=dev).manual_seed(1))
    same, _ = upd_mesh.with_draws(state, draws)
    one, _ = upd_one.with_draws(state, draws)
    own, _ = upd_mesh.with_draws(state, upd_one.draw(
        state, torch.Generator(device=dev).manual_seed(10 + mesh.rank)))
    sync(dev)
    return {"same_equals_one_rank": all(torch.equal(same.params[k],
                                                    one.params[k])
                                        for k in one.params),
            "same": {k: v.cpu() for k, v in same.params.items()},
            "own": {k: v.cpu() for k, v in own.params.items()}}


def algos_phase(gpu: str, dev) -> dict:
    """The algorithm family on the card: learnability at
    tests/test_algos.py's configurations and thresholds (DDPG and TD3
    from each of OFF_POLICY_SEEDS), the card against the CPU, rates
    (PPO also at the published width, 4,096 envs x 32 steps) and PPO over
    two gloo ranks on the card.  Returns the trained states."""
    from dcarl_tpu_torch.algos import common as C
    from dcarl_tpu_torch.algos import ppo
    from dcarl_tpu_torch.parallel.launch import run_ranks

    t_phase = time.perf_counter()
    learn, states = {}, {}
    for name, case in _algo_cases(dev).items():
        seeds = OFF_POLICY_SEEDS if name in ("ddpg", "td3") else (SEED,)
        runs = []
        for seed in seeds:
            state, score, secs = _train_algo(
                name, case, torch.Generator(device=dev).manual_seed(seed))
            runs.append((seed, score, secs, ALGO_PASS[name](score)))
            states.setdefault(name, state)
            if ALGO_PASS[name](score):
                states[name] = state
        n_up, steps = case[2], case[3]
        secs = float(np.mean([r[2] for r in runs]))
        learn[name] = {
            "scores": [r[1] for r in runs], "seeds": list(seeds),
            "cleared": sum(r[3] for r in runs), "updates": n_up,
            "s_per_update": secs / n_up,
            "env_steps_per_s": steps * n_up / secs}
        if not learn[name]["cleared"]:
            fail(f"algos: {name} missed tests/test_algos.py's threshold "
                 f"from every seed: {learn[name]['scores']}")
    state, score, secs = _her_learn(dev, torch.Generator(device=dev)
                                    .manual_seed(SEED))
    states["her_dqn"] = state
    learn["her_dqn"] = {"scores": [score], "seeds": [SEED],
                        "cleared": int(ALGO_PASS["her_dqn"](score)),
                        "updates": 300, "s_per_update": secs / 300,
                        "env_steps_per_s": 16 * 5 * 300 / secs}
    if not learn["her_dqn"]["cleared"]:
        fail(f"algos: HER-DQN solved {score} <= 0.55")
    learn_s = time.perf_counter() - t_phase

    t0 = time.perf_counter()
    versus = _card_vs_cpu(dev)
    actions = _rollout_actions_vs_cpu(dev)
    versus_s = time.perf_counter() - t0

    # PPO at the published width (64, 64), 4,096 envs x 32 steps
    init, upd = ppo.make_ppo(C.identity_env(3), ppo.PPOConfig(n_steps=32))
    g = torch.Generator(device=dev).manual_seed(SEED)
    st = init(g, 4096)
    st, _ = upd(st, g)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(3):
        st, m = upd(st, g)
    torch.cuda.synchronize()
    wide = (time.perf_counter() - t0) / 3
    ppo_wide = {"envs": 4096, "n_steps": 32, "s_per_update": wide,
                "env_steps_per_s": 4096 * 32 / wide,
                "reward_mean": float(m["reward_mean"])}

    # two gloo ranks on the one card
    t0 = time.perf_counter()
    ranks = run_ranks(_rank_ppo, 2, "gloo",
                      "cuda:0" if torch.device(dev).type == "cuda" else "cpu",
                      timeout_s=RANKS_TIMEOUT_S)
    for r in ranks:
        if not r["same_equals_one_rank"]:
            fail("algos: PPO over two ranks on the same draws != one rank")
    for k in ranks[0]["own"]:
        if not (torch.equal(ranks[0]["own"][k], ranks[1]["own"][k])
                and torch.equal(ranks[0]["same"][k], ranks[1]["same"][k])):
            fail(f"algos: PPO parameter {k} differs across the two ranks")
    two_ranks = {"bit_equal_across_ranks": True,
                 "same_draws_equal_one_rank": True,
                 "seconds": time.perf_counter() - t0}
    emit("algos", learn=learn, learn_seconds=learn_s, card_vs_cpu=versus,
         rollout_actions=actions, card_vs_cpu_seconds=versus_s,
         ppo_published_width=ppo_wide, two_ranks=two_ranks,
         seconds=time.perf_counter() - t_phase, gpu=gpu)
    return states


def vec_phase(gpu: str, dev, algo_states=None) -> None:
    """TorchVecEnv over the T-intersection at 1,024 envs x 50 steps
    through VecCheckNan(VecMonitor(.)), bit-equal to a direct step_fn run
    from the same generator seed; the calibration tables on the card
    against the CPU; a torch.profiler trace of one PPO update holding
    CUDA kernel events; nan_guard over every trained learner's state."""
    from dcarl_tpu_torch.algos import common as C
    from dcarl_tpu_torch.algos import ppo
    from dcarl_tpu_torch.config import EnvConfig
    from dcarl_tpu_torch.control import calibration as CAL
    from dcarl_tpu_torch.env.driving_env import make_vec_env
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.parallel import vec_env as V
    from dcarl_tpu_torch.utils import nan_guard as NG
    from dcarl_tpu_torch.utils import profiling as PR

    t_phase = time.perf_counter()
    b, steps = 1024, 50
    reset_fn, step_fn = make_vec_env(t_intersection(), EnvConfig(), device=dev)
    rng = np.random.default_rng(SEED)
    acts = [np.clip([1.0, 0.0] + rng.normal(0.0, 0.3, (b, 2)), -1.0, 1.0)
            .astype(np.float32) for _ in range(steps)]
    venv = V.VecCheckNan(V.VecMonitor(V.TorchVecEnv(
        reset_fn, step_fn, b, seed=SEED, device=dev)))
    obs0 = venv.reset()
    got = []
    t0 = time.perf_counter()
    for a in acts:
        got.append(venv.step(a)[:3])
    api_s = time.perf_counter() - t0
    episodes = len(venv.venv.get_episode_lengths())
    venv.close()

    g = torch.Generator(device=dev).manual_seed(SEED)
    st, obs, _ = reset_fn(b, g)
    want = [obs.cpu().numpy()]
    dev_acts = [torch.as_tensor(a, device=dev) for a in acts]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    outs = []
    for a in dev_acts:
        st, obs, rew, done, _ = step_fn(st, a, g)
        outs.append((obs, rew, done))
    torch.cuda.synchronize()
    direct_s = time.perf_counter() - t0
    if not np.array_equal(obs0, want[0]):
        fail("vec: TorchVecEnv reset != direct reset_fn")
    for (o, r, d), (wo, wr, wd) in zip(got, outs):
        if not (np.array_equal(o, wo.cpu().numpy())
                and np.array_equal(r, wr.cpu().double().numpy())
                and np.array_equal(d, wd.cpu().numpy())):
            fail("vec: TorchVecEnv step != direct step_fn from the same seed")

    # calibration: the card against the CPU
    cal = {}
    v = np.linspace(-1.0, 22.0, 93).astype(np.float32)
    want_a = np.linspace(-9.0, 6.0, 61).astype(np.float32)
    vv, aa = np.meshgrid(v, want_a, indexing="ij")
    for name, brake in (("acc", False), ("dec", True)):
        tg = CAL.measure_table(brake=brake, device=dev)
        tc = CAL.measure_table(brake=brake, device="cpu")
        err = float((tg.acc.cpu() - tc.acc).abs().max())
        if err > 1e-6:
            fail(f"vec: {name} table card vs CPU differs by {err}")
        cg = CAL.feedforward_command(tg, torch.as_tensor(vv, device=dev),
                                     torch.as_tensor(aa, device=dev))
        cc = CAL.feedforward_command(tc, torch.as_tensor(vv),
                                     torch.as_tensor(aa))
        if not torch.equal(cg.cpu(), cc):
            fail(f"vec: feedforward_command on the {name} table card != CPU")
        cal[name] = {"table_max_abs_err": err,
                     "table_bit_equal": bool(torch.equal(tg.acc.cpu(), tc.acc)),
                     "commands_equal": int(cc.numel())}

    # a torch.profiler trace of one PPO update (tests/test_algos.py config)
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    init, upd = ppo.make_ppo(C.identity_env(3), ppo.PPOConfig(
        n_steps=32, n_epochs=4, n_minibatches=4))
    g = torch.Generator(device=dev).manual_seed(SEED)
    pst = init(g, 32)
    pst, _ = upd(pst, g)
    with PR.trace(trace_dir):
        with PR.annotate("ppo_update"):
            pst, _ = upd(pst, g)
        torch.cuda.synchronize()
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    if len(files) != 1:
        fail(f"vec: profiling.trace wrote {files}")
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    kernel_us = [ev.get("dur", 0.0) for ev in events
                 if ev.get("cat") == "kernel"]
    span_us = [ev.get("dur", 0.0) for ev in events
               if ev.get("name") == "ppo_update"]
    kernels = len(kernel_us)
    if kernels < 1 or not span_us:
        fail(f"vec: the trace holds {kernels} CUDA kernel events and "
             f"{len(span_us)} ppo_update spans")
    # the device's busy share of the update: kernel time over the span
    busy = sum(kernel_us) / max(span_us)

    # nan_guard over every learner's final state
    guarded = dict(algo_states or {}, ppo_traced=pst)
    for name, s in guarded.items():
        NG.assert_finite(s, f"{name} final state")
        if not bool(NG.check_finite(s)):
            fail(f"vec: check_finite({name}) is False")
    emit("vec", envs=b, steps=steps, episodes_ended=episodes,
         api_env_steps_per_s=b * steps / api_s,
         direct_env_steps_per_s=b * steps / direct_s, bit_equal=True,
         calibration=cal, trace_kernel_events=kernels,
         ppo_update_span_ms=max(span_us) / 1e3,
         ppo_update_kernel_ms=sum(kernel_us) / 1e3,
         ppo_update_device_busy_share=busy,
         trace_events=len(events), nan_guard_states=sorted(guarded),
         seconds=time.perf_counter() - t_phase, gpu=gpu)


# ---------------------------------------------------------------------------
# The host layer and the DCARL agent served over TCP (bridge/, utils/native)
# ---------------------------------------------------------------------------

# The agent's store: StoreConfig()'s 2^17 rows at D = 21 near 256 planner
# states drawn as the example's selftest draws them; 400 selftest ticks;
# 4 planners x 64 messages in test mode; 1,024 single host queries
AGENT_ROWS, AGENT_ANCHORS = 1 << 17, 256
SELFTEST_TICKS = 400
AGENT_CLIENTS, AGENT_MESSAGES = 4, 64
HOST_QUERIES = 1024


class AgentData(NamedTuple):
    keys: np.ndarray     # [N, 21] f32 state || action
    actions: np.ndarray  # [N] f32
    values: np.ndarray   # [N] f32
    anchors: np.ndarray  # [K, 20] f64 planner states


def agent_data(rng) -> AgentData:
    """Store rows near ``anchors`` planner states (ego lane 0 / 1, speed
    in [0, 12], 16 object floats ~ N(0, 5): the example selftest's
    states), each within a fifth of the half-widths of its anchor, the
    actions spread evenly, values drawn around a mean in [-1, 0] for
    each (anchor, action)."""
    from dcarl_tpu_torch.bridge.agent_session import HALF_WIDTHS, NUM_ACTIONS

    n, k = AGENT_ROWS, AGENT_ANCHORS
    hw = np.asarray(HALF_WIDTHS)
    anchors = np.zeros((k, 20))
    anchors[:, 1] = rng.integers(0, 2, k)
    anchors[:, 2] = rng.uniform(0, 12, k)
    anchors[:, 4:] = rng.normal(0, 5, (k, 16))
    mu = rng.uniform(-1.0, 0.0, (k, NUM_ACTIONS))
    idx = rng.integers(0, k, n)
    act = np.arange(n) % NUM_ACTIONS
    keys = np.empty((n, 21), np.float32)
    keys[:, :20] = anchors[idx] + rng.uniform(-0.2, 0.2, (n, 20)) * hw[:20]
    keys[:, 20] = act
    vals = (mu[idx, act] + rng.normal(0, 0.1, n)).astype(np.float32)
    return AgentData(keys, act.astype(np.float32), vals, anchors)


def agent_traffic(rng, anchors: np.ndarray, n: int) -> list:
    """``n`` planner messages near the anchors: 20 floats, then the
    collision flag (2 %) and the leave flag (0)."""
    from dcarl_tpu_torch.bridge.agent_session import HALF_WIDTHS

    hw = np.asarray(HALF_WIDTHS[:20])
    pick = rng.integers(0, len(anchors), n)
    states = anchors[pick] + rng.uniform(-0.2, 0.2, (n, 20)) * hw
    return [[float(x) for x in s] + [int(rng.random() < 0.02), 0]
            for s in states]


def agent_store(data: AgentData, dev):
    from dcarl_tpu_torch.core.store import ConfidenceStore

    n = data.keys.shape[0]
    return ConfidenceStore(
        torch.as_tensor(data.keys, device=dev),
        torch.as_tensor(data.actions, device=dev),
        torch.as_tensor(data.values, device=dev),
        torch.full((), n, dtype=torch.int32, device=dev),
        torch.zeros((), dtype=torch.int32, device=dev))


def guarded(policy, log: list, errors: list):
    """``policy`` serialised under its own lock, each call's (message,
    reply) logged in the order the calls ran, and any exception recorded
    before it propagates (the bridge would turn it into a closed socket
    and the client into its fallback)."""
    import threading

    lock = threading.Lock()

    def wrapped(msg):
        with lock:
            try:
                reply = policy(msg)
            except Exception as e:
                errors.append(repr(e))
                raise
            log.append((msg, reply))
            return reply
    return wrapped


def host_phase(gpu: str, dev, data: AgentData) -> dict:
    """The C++ host library (``utils/native.py``) built from
    ``csrc/dcarl_host.cpp``: a ``HostBoxStore`` of the agent's rows, its
    grid-hash queries against ``exact=True`` (counts equal, means and
    variances within 1e-12: the two sum in another order) and both
    against ``core/store.box_query_stats`` on the card (one
    ``sorted_moments`` launch; counts exact, means and variances within
    rtol 1e-4 / atol 1e-3); a 2^17 x 22 f64 array through ``RecordLog``,
    ``AsyncLogWriter``, ``npy_mmap`` and ``NpyStream``, byte-equal."""
    from dcarl_tpu_torch.bridge.agent_session import HALF_WIDTHS, NUM_ACTIONS
    from dcarl_tpu_torch.core import store as ST
    from dcarl_tpu_torch.ops import _cuda
    from dcarl_tpu_torch.utils import native as NV

    t_phase = time.perf_counter()
    t0 = time.perf_counter()
    NV.load_library()
    build_s = time.perf_counter() - t0

    n, d = data.keys.shape
    host = NV.HostBoxStore(np.asarray(HALF_WIDTHS))
    keys64 = data.keys.astype(np.float64)
    t0 = time.perf_counter()
    for i in range(n):
        host.insert(keys64[i], data.actions[i], data.values[i])
    insert_s = time.perf_counter() - t0
    if len(host) != n:
        fail(f"host: {len(host)} rows in the host store, {n} inserted")

    rng = np.random.default_rng(SEED + 60)
    nq = HOST_QUERIES
    states = np.array(agent_traffic(rng, data.anchors, nq))[:, :20]
    q = np.concatenate([states, rng.integers(0, NUM_ACTIONS, (nq, 1))], 1)
    q = q.astype(np.float32).astype(np.float64)   # the card's f32 queries
    t0 = time.perf_counter()
    grid = np.array([host.query(x) for x in q])
    grid_s = time.perf_counter() - t0
    t0 = time.perf_counter()
    exact = np.array([host.query(x, exact=True) for x in q])
    exact_s = time.perf_counter() - t0
    if not np.array_equal(grid[:, 0], exact[:, 0]):
        fail("host: grid-hash counts differ from the exact scan")
    grid_err = float(np.abs(grid[:, 1:] - exact[:, 1:]).max())
    if grid_err > 1e-12:
        fail(f"host: grid-hash moments differ from the exact scan by "
             f"{grid_err}")

    store = agent_store(data, dev)
    hw = torch.tensor(HALF_WIDTHS, dtype=torch.float32, device=dev)
    q_dev = torch.as_tensor(q.astype(np.float32), device=dev)
    _cuda.LAUNCHES.clear()
    stats = ST.box_query_stats(store, q_dev, hw, use_kernel=True)
    sync(dev)
    launches = dict(_cuda.LAUNCHES)
    if launches != {"sorted_moments": 1}:
        fail(f"host: the card's query launched {launches}")
    card = np.stack([stats.count.cpu().numpy(), stats.mean.cpu().numpy(),
                     stats.var.cpu().numpy()], 1).astype(np.float64)
    errs = {}
    for label, ref in (("grid", grid), ("exact", exact)):
        if not np.array_equal(card[:, 0], ref[:, 0]):
            fail(f"host: the card's counts differ from the host {label} query")
        if not np.allclose(card[:, 1:], ref[:, 1:], **MOMENT_TOL):
            fail(f"host: the card's means and variances differ from the host "
                 f"{label} query beyond rtol 1e-4 / atol 1e-3")
        errs[label] = float(np.abs(card[:, 1:] - ref[:, 1:]).max())
    if not (card[:, 0] > 0).any():
        fail("host: no query matched any row")
    card_ms = cuda_ms(lambda: ST.box_query_stats(store, q_dev, hw,
                                                 use_kernel=True))
    card_ms_8 = cuda_ms(lambda: ST.box_query_stats(
        store, q_dev[:NUM_ACTIONS], hw, use_kernel=True))

    # the file formats: a 2^17 x 22 f64 array
    arr = np.random.default_rng(SEED + 61).normal(0, 3, (n, 22))
    tmp = tempfile.mkdtemp(prefix="chip_smoke_host_")
    files = {}
    try:
        t0 = time.perf_counter()
        log = NV.RecordLog(os.path.join(tmp, "records.bin"), 22)
        log.append(arr)
        log.close()
        back = NV.RecordLog.read(os.path.join(tmp, "records.bin"), 22,
                                 max_records=n)
        files["record_log"] = back.tobytes() == arr.tobytes()
        path = os.path.join(tmp, "records.txt")
        with NV.AsyncLogWriter(path) as w:
            for row in arr.tolist():
                w.append(" ".join(map(repr, row)))
            w.flush()
            lines = w.lines_written
        with open(path) as f:
            text = np.array(f.read().split(), dtype=np.float64)
        files["async_log_writer"] = lines == n \
            and text.reshape(n, 22).tobytes() == arr.tobytes()
        path = os.path.join(tmp, "records.npy")
        np.save(path, arr)
        files["npy_mmap"] = NV.npy_mmap(path).tobytes() == arr.tobytes()
        with NV.NpyStream(path, chunk_rows=4096) as st:
            chunks = list(st)
        files["npy_stream"] = np.concatenate(chunks).tobytes() \
            == arr.tobytes() and len(chunks) == -(-n // 4096)
        files_s = time.perf_counter() - t0
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    if not all(files.values()):
        fail(f"host: a file round trip differs: {files}")
    emit("host", build_seconds=build_s, rows=n, key_dim=d,
         insert_seconds=insert_s, queries=nq,
         matched_queries=int((grid[:, 0] > 0).sum()),
         matches=int(grid[:, 0].sum()),
         host_grid_us_per_query=grid_s / nq * 1e6,
         host_exact_us_per_query=exact_s / nq * 1e6,
         grid_vs_exact_max_abs_err=grid_err,
         grid_vs_exact_bit_equal=bool(np.array_equal(grid, exact)),
         card_vs_host_max_abs_err=errs, card_launches=launches,
         card_ms_per_call=card_ms, card_queries_per_call=nq,
         card_ms_per_tick_call=card_ms_8, tick_queries=NUM_ACTIONS,
         files_byte_equal=files, file_rows=n, file_seconds=files_s,
         seconds=time.perf_counter() - t_phase, gpu=gpu)
    return dict(max_abs_err=max(errs.values()))


def count_syncs(sess, msgs: list) -> dict:
    """``msgs`` through ``sess.decide`` (no sockets) under CUDA's sync
    debug mode: the calls that wait for the card, per tick, and where."""
    import warnings

    torch.cuda.set_sync_debug_mode("warn")
    try:
        with warnings.catch_warnings(record=True) as caught:
            warnings.simplefilter("always")
            for m in msgs:
                sess.decide(m)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    syncs = [f"{os.path.relpath(w.filename)}:{w.lineno}" for w in caught
             if "synchroniz" in str(w.message).lower()]
    return dict(syncs_per_tick=len(syncs) / len(msgs),
                sync_sites=sorted(set(syncs))[:8])


def agent_tick_profile(sess, msgs: list) -> dict:
    """Where a tick's time goes: ``msgs`` through ``sess.decide`` once
    under :func:`count_syncs`, then under ``torch.profiler``: a tick's
    span, its CUDA kernels (``sorted_moments`` apart) and the device's
    busy share of the span."""
    from dcarl_tpu_torch.utils import profiling as PR

    syncs = count_syncs(sess, msgs)
    trace_dir = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                             "build", "chip_smoke_agent_trace")
    shutil.rmtree(trace_dir, ignore_errors=True)
    sync("cuda")
    with PR.trace(trace_dir):
        for m in msgs:
            with PR.annotate("agent_tick"):
                sess.decide(m)
        sync("cuda")
    files = [f for f in os.listdir(trace_dir) if f.endswith(".json")]
    with open(os.path.join(trace_dir, files[0])) as f:
        events = json.load(f)["traceEvents"]
    shutil.rmtree(trace_dir, ignore_errors=True)
    kernels = [ev for ev in events if ev.get("cat") == "kernel"]
    spans = [ev["dur"] for ev in events if ev.get("name") == "agent_tick"
             and ev.get("cat") != "gpu_user_annotation"]
    ops = [ev for ev in events if ev.get("cat") == "cpu_op"]
    n = len(msgs)
    band = [ev["dur"] for ev in kernels if "moments_" in ev.get("name", "")]
    if not kernels or len(spans) != n:
        fail(f"bridge: the tick trace holds {len(kernels)} kernel events and "
             f"{len(spans)} tick spans for {n} ticks")
    busy = sum(ev["dur"] for ev in kernels)
    return dict(ticks=n, **syncs,
                span_ms_mean=float(np.mean(spans)) / 1e3,
                kernel_events_per_tick=len(kernels) / n,
                kernel_ms_per_tick=busy / n / 1e3,
                sorted_kernel_events_per_tick=len(band) / n,
                sorted_kernel_ms_per_tick=sum(band) / n / 1e3,
                cpu_ops_per_tick=len(ops) / n,
                device_busy_share=busy / sum(spans))


def recorded_losses(sess) -> list:
    """Each of ``sess``'s tick losses, appended as the tick returns it (a
    device scalar: the recording reads nothing back)."""
    losses, tick = [], sess._tick

    def recorded(*args):
        out = tick(*args)
        losses.append(out[1])
        return out

    sess._tick = recorded
    return losses


# one training tick on the card against the CPU from the same learner
# state: the per-tick tolerance of tests/test_torch_bridge.py
TICK_LOSS_TOL = dict(rtol=1e-5, atol=1e-6)


def training_replay(dev, order: list, served: list,
                    served_losses: list) -> dict:
    """The selftest's ticks again, in the order the served session logged
    them, on a second card session of the served one's seed (the same
    draws in the same order) and on a CPU session (plain route) that
    takes, before each tick, the card session's learner state (nets,
    Adam, replay, frame) and that tick's card draws.  The card replay's
    actions equal the served run's and its losses are within
    ``TICK_LOSS_TOL`` of them; the CPU's actions equal the card's, and
    its losses are within ``TICK_LOSS_TOL`` of the card's."""
    from dcarl_tpu_torch.bridge import agent_session as AS
    from dcarl_tpu_torch.parallel.mesh import tree_map

    def to_cpu(tree):
        return tree_map(lambda x: x.detach().to("cpu", copy=True), tree)

    card = AS.AgentSession(seed=SEED, is_training=True, device=dev)
    cpu = AS.AgentSession(seed=SEED, is_training=True, device="cpu")
    card_l, cpu_l = recorded_losses(card), recorded_losses(cpu)
    card_a, cpu_a = [], []
    t0 = time.perf_counter()
    for m in order:
        d = card.draw()
        cpu.load_state(to_cpu(card.checkpoint_state()))
        card_a.append(card.with_draws(m, d))
        cpu_a.append(cpu.with_draws(m, to_cpu(d)))
    seconds = time.perf_counter() - t0
    if card_a != served:
        fail("bridge selftest: the card replay's actions differ from the "
             "served run's")
    if cpu_a != card_a:
        i = next(i for i, (a, b) in enumerate(zip(cpu_a, card_a)) if a != b)
        fail(f"bridge selftest: the CPU decides {cpu_a[i]} where the card "
             f"decided {card_a[i]} (tick {i})")
    card_l = torch.stack(card_l).cpu().numpy().astype(np.float64)
    cpu_l = torch.stack(cpu_l).numpy().astype(np.float64)
    served_l = torch.stack(served_losses).cpu().numpy().astype(np.float64)
    if not np.allclose(card_l, served_l, **TICK_LOSS_TOL):
        fail("bridge selftest: the card replay's losses differ from the "
             "served run's beyond rtol 1e-5 / atol 1e-6")
    if not np.allclose(cpu_l, card_l, **TICK_LOSS_TOL):
        i = int(np.argmax(np.abs(cpu_l - card_l)))
        fail(f"bridge selftest: tick {i}'s loss is {cpu_l[i]} on the CPU and "
             f"{card_l[i]} on the card, from the same learner state")
    if not torch.equal(cpu.replay.obs, card.replay.obs.cpu()):
        fail("bridge selftest: the CPU replay's rows differ from the card's")
    steps = card_l != 0.0
    if not steps.any():
        fail("bridge selftest: no SGD step in the replay")
    rel = np.abs(cpu_l - card_l)[steps] / np.abs(card_l)[steps]
    return dict(ticks=len(order), sgd_steps=int(steps.sum()),
                card_replay_actions_equal=True,
                card_replay_losses_bit_equal=bool(
                    np.array_equal(card_l, served_l)),
                card_replay_vs_served_loss_max_abs_err=float(
                    np.abs(card_l - served_l).max()),
                cpu_actions_equal=True,
                cpu_vs_card_loss_max_abs_err=float(
                    np.abs(cpu_l - card_l).max()),
                cpu_vs_card_loss_max_rel_err=float(rel.max()),
                seconds=seconds)


def bridge_phase(sk, _cuda, gpu: str, dev, data: AgentData) -> dict:
    """The DCARL agent (``bridge/agent_session.py``) served over TCP
    (``bridge/agent_server.py``, the port's msgpack codec) at the
    example's widths:

    0. a cold start: a throwaway training session's first tick timed (it
       loads the CUDA modules), then 63 ticks more, the last 16 past its
       first SGD steps under CUDA's sync debug mode;
    1. the ported selftest, 400 ticks of the synthetic planner, against
       a training session on the card: ticks/s, round-trip latency, one
       ``sorted_moments`` launch (D = 21, 8 queries) a tick; then its
       ticks again in its logged order on the card and, from the card's
       learner state of each tick, on the CPU (:func:`training_replay`);
    2. test mode on a full store (the agent's 2^17 rows): 4 concurrent
       planners x 64 messages; the card's replies against a CPU session
       (plain route) replaying the messages in the order the card
       session took them, from the same start; a card replay of that
       order times each launch with CUDA events; the tick's launch
       against the plain version (counts exact, sums within rtol 1e-4 /
       atol 1e-3) and again bit-equal; 32 ticks more under CUDA's sync
       debug mode and ``torch.profiler`` (:func:`agent_tick_profile`).

    The clients' fallback is -1, which no policy returns, and the served
    policy records any exception: a sentinel reply, an exception, a tick
    count other than the requests sent, a launch count other than the
    ticks, or a training or test-mode tick that waits for the card other
    than once (the reply's action) fails the phase."""
    import threading

    from dcarl_tpu_torch.bridge import AgentServer, PlannerClient
    from dcarl_tpu_torch.bridge import agent_session as AS
    from dcarl_tpu_torch.core import rls as RLS
    from dcarl_tpu_torch.core import store as ST
    from dcarl_tpu_torch.utils import nan_guard as NG

    t_phase = time.perf_counter()

    def launches(n_ticks: int, what: str) -> dict:
        got = dict(_cuda.LAUNCHES)
        if got != {"sorted_moments": n_ticks}:
            fail(f"bridge {what}: kernel launches {got} != {n_ticks} ticks")
        return got

    def one_sync(syncs: dict, what: str) -> None:
        if syncs["syncs_per_tick"] != 1:
            fail(f"bridge {what}: {syncs['syncs_per_tick']} host syncs a "
                 f"tick, at {syncs['sync_sites']}")

    # 0. a cold start: a throwaway training session's first tick loads
    # the CUDA modules of every op the tick runs, which can outlast the
    # planner client's 2 s timeout (the first request then falls back to
    # the rule); then ticks past its first SGD steps
    warm = AS.AgentSession(seed=SEED + 2, is_training=True, device=dev)
    warm_msgs = agent_traffic(np.random.default_rng(SEED + 63), data.anchors,
                              64)
    sync(dev)
    t0 = time.perf_counter()
    warm.decide(warm_msgs[0])
    sync(dev)
    first_tick_s = time.perf_counter() - t0
    for m in warm_msgs[1:48]:
        warm.decide(m)
    if warm.replay_rows < warm.dcfg.batch_size:
        fail("bridge warm-up: no SGD step in 48 ticks")
    train_syncs = count_syncs(warm, warm_msgs[48:])
    one_sync(train_syncs, "training tick")
    del warm

    # 1. the training selftest
    sess = AS.AgentSession(seed=SEED, is_training=True, device=dev)
    served_losses = recorded_losses(sess)
    log, errors = [], []
    _cuda.LAUNCHES.clear()
    sync(dev)
    t0 = time.perf_counter()
    with AgentServer(guarded(sess.decide, log, errors)) as srv:
        out = AS.selftest(sess, srv.address[1], n_ticks=SELFTEST_TICKS)
    sync(dev)
    self_s = time.perf_counter() - t0
    if errors or sess.ticks != SELFTEST_TICKS or len(log) != SELFTEST_TICKS \
            or -1 in out["actions"]:
        fail(f"bridge selftest: {sess.ticks} ticks and {len(log)} replies "
             f"for {SELFTEST_TICKS} requests, errors {errors[:3]}")
    self_launches = launches(SELFTEST_TICKS, "selftest")
    NG.assert_finite(sess.checkpoint_state(), "agent DQN state")
    lat = np.asarray(out["latency_s"]) * 1e3
    selftest = dict(
        cold_first_tick_seconds=first_tick_s,
        training_tick_syncs=train_syncs,
        ticks=SELFTEST_TICKS, seconds=self_s,
        ticks_per_s=SELFTEST_TICKS / self_s,
        latency_ms_p50=float(np.percentile(lat, 50)),
        latency_ms_p99=float(np.percentile(lat, 99)),
        latency_ms_max=float(lat.max()), launches=self_launches,
        store_rows=int(sess.store.size), replay_rows=sess.replay_rows,
        frame=sess.frame, episodes=sess.episodes,
        action_hist=np.bincount(out["actions"],
                                minlength=AS.NUM_ACTIONS).tolist(),
        nan_guard_finite=True)
    del sess
    selftest["replay"] = training_replay(
        dev, [m for m, _ in log], [r for _, r in log], served_losses)

    # 2. test mode on the full store
    def fresh(device):
        s = AS.AgentSession(seed=SEED + 1, is_training=False, device=device)
        if s.store.keys.shape[0] != data.keys.shape[0]:
            fail("bridge: the agent rows do not fill the session's store")
        s.store = agent_store(data, torch.device(device))
        return s

    rng = np.random.default_rng(SEED + 62)
    traffic = [agent_traffic(rng, data.anchors, AGENT_MESSAGES)
               for _ in range(AGENT_CLIENTS)]
    card = fresh(dev)
    log, errors, replies, lat_ms = [], [], {}, {}

    def planner(i):
        c = PlannerClient(port=srv.address[1], timeout=60.0,
                          fallback_action=-1)
        replies[i], lat_ms[i] = [], []
        for m in traffic[i]:
            t1 = time.perf_counter()
            replies[i].append(c.decide(m[:20], collision=m[20],
                                       leave_mmap=m[21]))
            lat_ms[i].append((time.perf_counter() - t1) * 1e3)
        c.close()

    _cuda.LAUNCHES.clear()
    sync(dev)
    t0 = time.perf_counter()
    with AgentServer(guarded(card.decide, log, errors)) as srv:
        threads = [threading.Thread(target=planner, args=(i,))
                   for i in range(AGENT_CLIENTS)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=600)
    sync(dev)
    serve_s = time.perf_counter() - t0
    n_req = AGENT_CLIENTS * AGENT_MESSAGES
    sent = [a for i in range(AGENT_CLIENTS) for a in replies.get(i, [])]
    if any(t.is_alive() for t in threads) or len(sent) != n_req \
            or -1 in sent or errors or card.ticks != n_req \
            or len(log) != n_req:
        fail(f"bridge test mode: {card.ticks} ticks, {len(log)} logged and "
             f"{len(sent)} replies ({sent.count(-1)} fallbacks) for {n_req} "
             f"requests, errors {errors[:3]}")
    serve_launches = launches(n_req, "test mode")
    order = [m for m, _ in log]
    want = [r for _, r in log]

    cpu = fresh("cpu")
    t0 = time.perf_counter()
    got = [cpu.decide(m) for m in order]
    cpu_s = time.perf_counter() - t0
    if got != want:
        i = next(i for i, (a, b) in enumerate(zip(got, want)) if a != b)
        fail(f"bridge test mode: the CPU replay decides {got[i]} where the "
             f"card decided {want[i]} (message {i} in arrival order)")

    again, record = fresh(dev), []
    with timed_launches(sk, "launch_sorted", record,
                        sorted_probe(sk, _cuda)):
        sync(dev)
        t0 = time.perf_counter()
        got = [again.decide(m) for m in order]
        sync(dev)
        replay_s = time.perf_counter() - t0
    if got != want:
        fail("bridge test mode: the card replay differs from the served run")
    summ = summarize(record)
    summ["tick_profile"] = agent_tick_profile(again, order[:32])
    one_sync(summ["tick_profile"], "test-mode tick")

    # the tick's launch against the plain version, on the final store
    obs = torch.tensor(order[-1][:20], dtype=torch.float32, device=dev)
    keys = RLS.candidate_keys(obs[None], AS.NUM_ACTIONS).reshape(-1, 21)
    valid = ST.store_valid(card.store)
    ops, _ = sk.sorted_query_operands(card.store.keys, card.store.values,
                                      valid, keys.contiguous(),
                                      card.half_widths)
    out = sk.sorted_moments(ops)
    sync(dev)
    err = compare(out, sk.sorted_moments_plain(ops), "agent_tick")
    if not torch.equal(sk.sorted_moments(ops), out):
        fail("agent tick: two sorted_moments launches differ")
    kernel_ms = cuda_ms(lambda: sk.sorted_moments(ops))
    plain_ms = cuda_ms(lambda: sk.sorted_moments_plain(ops))
    wrapper_ms = cuda_ms(lambda: sk.box_query_moments_sorted(
        card.store.keys, card.store.values, valid, keys, card.half_widths))
    lat = np.concatenate([np.asarray(v) for v in lat_ms.values()])
    emit("bridge", selftest=selftest,
         test_mode=dict(
             clients=AGENT_CLIENTS, messages_per_client=AGENT_MESSAGES,
             requests=n_req, store_rows=int(card.store.size),
             seconds=serve_s, ticks_per_s=n_req / serve_s,
             latency_ms_p50=float(np.percentile(lat, 50)),
             latency_ms_p99=float(np.percentile(lat, 99)),
             launches=serve_launches,
             gated_share=float(np.mean(np.asarray(want) > 0)),
             action_hist=np.bincount(want, minlength=AS.NUM_ACTIONS).tolist(),
             cpu_replay_equal=True, cpu_replay_seconds=cpu_s,
             card_replay_ticks_per_s=n_req / replay_s),
         tick_launch=dict(queries=int(keys.shape[0]), key_dim=21,
                          rows=int(valid.sum()), max_abs_err=err,
                          matches=int(out[:, 0].sum()), bit_equal_repeat=True,
                          kernel_ms=kernel_ms, plain_ms=plain_ms,
                          wrapper_ms=wrapper_ms, band_dim_w=float(ops.w0)),
         **summ, seconds=time.perf_counter() - t_phase, gpu=gpu)
    return dict(launches=serve_launches["sorted_moments"],
                selftest_launches=self_launches["sorted_moments"],
                max_abs_err=err, ms=summ["kernel_ms_mean"],
                plain_ms=plain_ms, wrapper_ms=wrapper_ms,
                bound_ms=summ["bound_ms_mean"], bound_by=summ["bound_by"])


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    only = None
    if argv:
        only = set(argv[1].split(",")) if len(argv) == 2 \
            and argv[0] == "--only" else None
        if not only or not only <= {"lane", "field", "vec", "algos", "host",
                                    "bridge"}:
            print("usage: chip_smoke.py [--only "
                  "lane,field,algos,vec,host,bridge]", file=sys.stderr)
            return 2
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; this script runs on the GPU only",
              file=sys.stderr)
        return 2
    here = os.path.dirname(os.path.abspath(__file__))
    if not os.path.isdir(os.path.join(here, "dcarl_tpu_torch")):
        print("chip_smoke: dcarl_tpu_torch/ not found beside the script",
              file=sys.stderr)
        return 2
    sys.path.insert(0, here)

    from dcarl_tpu_torch import disable_tf32
    from dcarl_tpu_torch.config import (DCARLConfig, EnvConfig,
                                        driving_store_config)
    from dcarl_tpu_torch.env.driving_env import in_state_indices
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.ops import _cuda, store_kernels
    from dcarl_tpu_torch.planning import fast_rollout as fr
    from dcarl_tpu_torch.train_fast import make_trainer_fast

    t_start = time.perf_counter()
    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)
    sk = store_kernels

    # --- device
    disable_tf32()
    gpu = gpu_line()
    emit("device", torch=torch.__version__, cuda=torch.version.cuda,
         name=name, count=torch.cuda.device_count(),
         tf32_matmul=torch.backends.cuda.matmul.allow_tf32,
         tf32_cudnn=torch.backends.cudnn.allow_tf32)
    print(gpu, flush=True)

    # --- build (one nvcc per source, started together)
    t0 = time.perf_counter()
    reports = _cuda.build()
    for k in _cuda.SIGNATURES:
        _cuda.load(k)
    build_s = time.perf_counter() - t0
    ptxas = {k: [ln.strip() for ln in log.splitlines()
                 if "registers" in ln or "spill" in ln]
             for k, log in reports.items()}
    emit("build", seconds=round(build_s, 3), ptxas=ptxas)
    if only:
        if "lane" in only:
            lane_phase(store_kernels, _cuda, gpu, dev)
        if "field" in only:
            field_phase(gpu, dev)
        states = algos_phase(gpu, dev) if "algos" in only else None
        if "vec" in only:
            vec_phase(gpu, dev, states)
        if only & {"host", "bridge"}:
            agent = agent_data(np.random.default_rng(SEED))
            if "host" in only:
                host_phase(gpu, dev, agent)
            if "bridge" in only:
                bridge_phase(store_kernels, _cuda, gpu, dev, agent)
        return 0

    env_cfg = EnvConfig()
    scfg = driving_store_config()
    sc = t_intersection(env_cfg)
    idx = in_state_indices(sc)
    gen = torch.Generator(device=dev).manual_seed(SEED)
    hw = torch.as_tensor(scfg.half_widths, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(SEED)
    max_err = {"peraction_moments": 0.0, "sorted_moments": 0.0,
               "box_moments": 0.0}

    def note_err(kernel, err):
        max_err[kernel] = max(max_err[kernel], err)

    # --- every kernel against its plain version on small stores
    for label, k, v, m, q, w in small_stores(rng, scfg.half_widths):
        t = [torch.as_tensor(np.asarray(a), device=dev) for a in (k, v, m, q, w)]
        prep = sk.prepare_peraction_store(t[0], t[1], t[2], t[4].float(), 11)
        got = sk.query_peraction_prepared(prep, t[3].contiguous())
        torch.cuda.synchronize()
        err = compare(got, sk.peraction_moments_plain(prep, t[3]), label)
        note_err("peraction_moments", err)
        emit("kernel_vs_plain", kernel="peraction_moments", store=label,
             rows=k.shape[0], queries=q.shape[0], max_abs_err=err)
    for label, k, v, m, q, w, grouped in band_stores(rng):
        t = [torch.as_tensor(np.asarray(a), device=dev) for a in (k, v, m, q, w)]
        if grouped:
            ops, _ = sk.grouped_query_operands(*t)
        else:
            ops, _ = sk.sorted_query_operands(*t)
        got = sk.sorted_moments(ops)
        torch.cuda.synchronize()
        err = compare(got, sk.sorted_moments_plain(ops), label)
        note_err("sorted_moments", err)
        flat_q = t[3].reshape(-1, t[3].shape[-1])
        if grouped:
            got_api = sk.box_query_moments_grouped(*t).reshape(-1, 3)
        else:
            got_api = sk.box_query_moments_sorted(*t)
        compare(got_api, sk.brute_moments_plain(t[0], t[1], t[2], flat_q,
                                                t[4]), label + "_vs_raw")
        emit("kernel_vs_plain", kernel="sorted_moments", store=label,
             rows=k.shape[0], queries=flat_q.shape[0], max_abs_err=err,
             matches=int(got[:, 0].sum()))
        if label == "flat_random":
            got = sk.box_query_moments_brute(*t)
            torch.cuda.synchronize()
            err = compare(got, sk.brute_moments_plain(*t), label)
            note_err("box_moments", err)
            emit("kernel_vs_plain", kernel="box_moments", store=label,
                 rows=k.shape[0], queries=q.shape[0], max_abs_err=err)

    # --- store fill: 16,384 rule-driven envs x 16 ticks = 2^18 rows
    fill_b, fill_t = 16384, 16
    init_r, run_r = fr.make_rule_driver_fast(sc, env_cfg)
    carry = init_r(fill_b, gen)
    obs_ticks, rew_ticks = [], []
    t0 = time.perf_counter()
    for _ in range(fill_t):
        obs_ticks.append(fr._obs_ori_soa(carry, idx).T)
        carry, (reward, *_rest) = run_r(carry, 1, gen)
        rew_ticks.append(reward[0])
    obs_all = torch.cat(obs_ticks)                            # [2^18, 20]
    rew_all = torch.cat(rew_ticks)
    n_rows = obs_all.shape[0]
    act = torch.randint(0, 11, (n_rows,), generator=gen, device=dev)
    # candidates outscore the rule action (0) by 0.05 per index, so the
    # Welch gate has something to find wherever the store is dense
    values = (rew_all + 0.05 * act
              + 0.02 * torch.randn(n_rows, generator=gen, device=dev))
    s_keys = torch.cat([obs_all, act[:, None].float()], 1).contiguous()
    s_vals = values.float().contiguous()
    s_valid = torch.ones(n_rows, dtype=torch.bool, device=dev)
    torch.cuda.synchronize()
    n_unique = torch.unique(s_keys, dim=0).shape[0]
    emit("store_fill", envs=fill_b, ticks=fill_t, rows=n_rows,
         unique_rows=n_unique, seconds=round(time.perf_counter() - t0, 3))
    if n_rows != 1 << 18 or not torch.isfinite(s_keys).all():
        fail("store fill")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = sk.prepare_peraction_store(s_keys, s_vals, s_valid, hw, 11)
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    init_g, run_g = fr.make_gated_driver_fast(sc, env_cfg, store_cfg=scfg,
                                              use_kernel=True)
    main_b, main_t = 65536, 50
    carry0 = init_g(main_b, gen)
    q_main = fr._obs_ori_soa(carry0, idx).T.contiguous()      # tick-0 queries
    q_sub = q_main[:4096].contiguous()
    got = sk.query_peraction_prepared(prep, q_sub)
    torch.cuda.synchronize()
    ref = sk.peraction_moments_plain(prep, q_sub)
    err = compare(got, ref, "main_store")
    note_err("peraction_moments", err)
    if not torch.equal(sk.query_peraction_prepared(prep, q_sub), got):
        fail("main store: two peraction_moments launches differ")
    pa_plain_ms = cuda_ms(lambda: sk.peraction_moments_plain(prep, q_sub))
    pa_sub_ms = cuda_ms(lambda: sk.query_peraction_prepared(prep, q_sub))
    qorder_sub, qext_sub = sk.query_operands(prep, q_sub)
    keep_sub = sk.prune_keep(prep, qext_sub)
    pa_warp_empty = warp_empty_share(
        peraction_mask(prep, q_sub[qorder_sub]), keep_sub, prep.row_act >= 0)
    pa_settle = settle_shares(piece_settle(prep, q_sub, qorder_sub, keep_sub))
    emit("kernel_vs_plain", kernel="peraction_moments", store="main_path",
         rows=n_rows, queries=4096, max_abs_err=err,
         matches=int(ref[..., 0].sum()), kernel_ms=pa_sub_ms,
         plain_ms=pa_plain_ms, prepare_ms=prepare_ms,
         warp_row_empty_share=pa_warp_empty, **pa_settle)

    def gated_path(label, keys, vals, valid, seed):
        """The gated driver at 65,536 envs x 50 ticks, counted, then a
        replay of the same run with each launch timed."""
        torch.cuda.reset_peak_memory_stats()
        _cuda.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, out = run_g(carry0, main_t, keys, vals, valid,
                       generator=torch.Generator(device=dev).manual_seed(seed))
        torch.cuda.synchronize()
        run_s = time.perf_counter() - t0
        peak_gib = torch.cuda.max_memory_allocated() / 2 ** 30
        launches = dict(_cuda.LAUNCHES)
        reward, done, passed, collided, executed, gated = out
        gate_share = float((gated > 0).float().mean())
        if launches != {"peraction_moments": main_t}:
            fail(f"{label}: kernel launches {launches} != {main_t} ticks")
        if reward.shape != (main_t, main_b) or not torch.isfinite(reward).all():
            fail(f"{label}: rewards not finite or misshapen")
        record, settled = [], []
        with timed_launches(sk, "launch_peraction", record,
                            peraction_probe(sk, _cuda, settled)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            run_g(carry0, main_t, keys, vals, valid,
                  generator=torch.Generator(device=dev).manual_seed(seed))
            torch.cuda.synchronize()
            replay_s = time.perf_counter() - t0
        summ = summarize(record)
        for when, st in (("first", settled[0]), ("last", settled[-1])):
            summ.update({f"{k}_{when}_tick": v
                         for k, v in settle_shares(st).items()})
        summ["piece_held_share_mean"] = settle_shares(
            {k: sum(st[k] for st in settled) for k in settled[0]}
        )["piece_held_share"]
        emit(label, envs=main_b, ticks=main_t, store_rows=int(valid.sum()),
             env_steps_per_s=main_b * main_t / run_s, seconds=run_s,
             replay_env_steps_per_s=main_b * main_t / replay_s,
             kernel_share_of_replay=summ["kernel_ms_sum"] / (replay_s * 1e3),
             launches=launches, gate_share=gate_share,
             done_share=float(done.float().mean()),
             pairs_total=float(main_b) * float(keys.shape[0]), **summ,
             peak_mem_gib=peak_gib, gpu=gpu)
        return launches, summ, gate_share

    # --- gated main path on the rule-filled store
    pa_launches, pa_summ, _ = gated_path("main_path", s_keys, s_vals, s_valid,
                                         SEED + 1)
    if pa_summ["kernel_ms_mean"] <= 0:
        fail("gated path: no kernel time")

    # --- gated end-to-end check: kernel route == brute reference route
    outs = []
    for use_kernel in (True, False):
        init_c, run_c = fr.make_gated_driver_fast(sc, env_cfg, store_cfg=scfg,
                                                  use_kernel=use_kernel)
        c0 = init_c(256, torch.Generator(device=dev).manual_seed(SEED + 2))
        _, o = run_c(c0, 10, s_keys, s_vals, s_valid,
                     generator=torch.Generator(device=dev).manual_seed(SEED + 3))
        outs.append(o)
    for label, i in (("done", 1), ("passed", 2), ("collided", 3),
                     ("executed", 4), ("gated", 5)):
        if not torch.equal(outs[0][i], outs[1][i]):
            fail(f"e2e: {label} differs between kernel and reference routes")
    if not torch.allclose(outs[0][0], outs[1][0], rtol=1e-5, atol=1e-6):
        fail("e2e: rewards differ between kernel and reference routes")
    emit("e2e_check", envs=256, ticks=10, gate_share=float(
        (outs[0][5] > 0).float().mean()), integer_outputs_equal=True)
    empty_store_phase(sk, q_sub, hw)
    del prep, s_keys, s_vals, s_valid, obs_all, obs_ticks
    torch.cuda.empty_cache()

    # --- train path: the trainer at bench.py's width, kernel route
    dcfg = DCARLConfig(store=scfg)
    tr_b, tr_cap, warm, timed = 32768, 1 << 16, 20, 20
    torch.cuda.reset_peak_memory_stats()
    init_tr, step_tr, learner, factory = make_trainer_fast(
        dcfg, batch_per_device=tr_b, store_capacity_per_device=tr_cap,
        replay_capacity_per_device=tr_cap, backfill_budget_per_step=8192,
        use_kernel=True)
    t0 = time.perf_counter()
    state = init_tr(SEED)
    state, _ = factory(warm)(state, torch.Generator(device=dev).manual_seed(7))
    torch.cuda.synchronize()
    warm_s = time.perf_counter() - t0
    snap, snap_learner = snapshot(state), learner.state_dict()
    run_timed = factory(timed)
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_end, ms = run_timed(snap, torch.Generator(device=dev).manual_seed(8))
    torch.cuda.synchronize()
    train_s = time.perf_counter() - t0
    tr_launches = dict(_cuda.LAUNCHES)
    if tr_launches != {"sorted_moments": timed}:
        fail(f"train path: kernel launches {tr_launches} != {timed} steps")
    loss = ms.loss
    if not torch.isfinite(loss).all():
        fail("train path: loss not finite")
    # the 2^16-row ring fills during warm-up; growth is read from the
    # cumulative slots written
    grown = int(st_end.store_total[0]) - int(snap.store_total[0])
    if not (grown > 0 and int(ms.store_rows[-1]) > 0):
        fail("train path: the store did not grow")
    learner.load_state_dict(snap_learner)
    record = []
    with timed_launches(sk, "launch_sorted", record, sorted_probe(sk, _cuda)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_timed(snap, torch.Generator(device=dev).manual_seed(8))
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    so_summ = summarize(record)
    emit("train_path", envs=tr_b, warmup_steps=warm, steps=timed,
         store_capacity=tr_cap, warmup_seconds=warm_s, seconds=train_s,
         train_env_steps_per_s=tr_b * timed / train_s,
         replay_env_steps_per_s=tr_b * timed / replay_s,
         kernel_share_of_replay=so_summ["kernel_ms_sum"] / (replay_s * 1e3),
         launches=tr_launches, loss_last=float(loss[-1]),
         loss_mean=float(loss.mean()),
         store_rows_start=int(snap.store_size[0]),
         store_rows=int(ms.store_rows[-1]), store_slots_written=grown,
         rule_fraction=float(ms.rule_fraction.mean()),
         dropped_records=int(ms.dropped_records.sum()),
         reward_mean=float(ms.reward_mean.mean()),
         done_count=int(ms.done_count.sum()), **so_summ,
         pairs_total_per_launch=float(tr_b) * tr_cap,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, gpu=gpu)

    # --- sharded, world size 1 (NCCL): the trainer over a one-rank mesh
    # from the same snapshot and generator, bit-equal to the steps above
    nccl_tmp = tempfile.mkdtemp(prefix="chip_smoke_nccl_")
    mesh1 = nccl_world_of_one(dev, nccl_tmp)
    _, _, learner_s, factory_s = make_trainer_fast(
        dcfg, batch_per_device=tr_b, store_capacity_per_device=tr_cap,
        replay_capacity_per_device=tr_cap, backfill_budget_per_step=8192,
        use_kernel=True, mesh=mesh1)
    learner_s.load_state_dict(snap_learner)
    run_sh = factory_s(timed)
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_sh, ms_sh = run_sh(snapshot(snap),
                          torch.Generator(device=dev).manual_seed(8))
    torch.cuda.synchronize()
    sh_train_s = time.perf_counter() - t0
    sh_train_launches = dict(_cuda.LAUNCHES)
    if sh_train_launches != {"sorted_moments": timed}:
        fail(f"sharded trainer: launches {sh_train_launches} != {timed}")
    for field in ("store_keys", "store_actions", "store_values",
                  "store_size", "store_head", "store_total", "traj_len",
                  "traj_act"):
        if not torch.equal(getattr(st_sh, field), getattr(st_end, field)):
            fail(f"sharded trainer: {field} differs from the unsharded run")
    for field in ("done_count", "pass_count", "collision_count",
                  "rule_fraction", "store_rows", "dropped_records"):
        if not torch.equal(getattr(ms_sh, field), getattr(ms, field)):
            fail(f"sharded trainer: {field} differs from the unsharded run")
    sharded_world1 = dict(
        backend=mesh1.backend, size=mesh1.size, train_envs=tr_b,
        train_steps=timed, train_launches=sh_train_launches,
        train_env_steps_per_s=tr_b * timed / sh_train_s,
        unsharded_train_env_steps_per_s=tr_b * timed / train_s,
        train_bit_equal=True)
    del learner_s, factory_s, run_sh, st_sh, ms_sh

    # --- the sorted and brute kernels on the trainer-built store
    valid_tr = torch.arange(tr_cap, device=dev) < st_end.store_size[0]
    k_tr, v_tr = st_end.store_keys[0], st_end.store_values[0]
    # in lockstep the ring holds records from a window behind the fleet,
    # which the fleet's own observations do not meet: half the queries
    # are the fleet's, half sit next to stored rows (action 0)
    obs_q = torch.cat([st_end.obs_ori[0].T[:2048],
                       k_tr[:2048, :-1] + 0.1 * torch.randn(
                           2048, 20, generator=gen, device=dev)])
    q_tr = torch.cat([obs_q, torch.zeros_like(obs_q[:, :1])], 1).contiguous()
    ops, _ = sk.grouped_query_operands(k_tr, v_tr, valid_tr, q_tr[None], hw)
    got = sk.sorted_moments(ops)
    torch.cuda.synchronize()
    ref = sk.sorted_moments_plain(ops)
    err = compare(got, ref, "trainer_store_sorted")
    note_err("sorted_moments", err)
    so_plain_ms = cuda_ms(lambda: sk.sorted_moments_plain(ops))
    so_sub_ms = cuda_ms(lambda: sk.sorted_moments(ops))
    keep = sk.sorted_prune_keep(ops)
    emit("kernel_vs_plain", kernel="sorted_moments", store="trainer_store",
         rows=int(valid_tr.sum()), queries=4096, max_abs_err=err,
         matches=int(ref[:, 0].sum()), kernel_ms=so_sub_ms,
         plain_ms=so_plain_ms, kept_subslice_share=float(keep.float().mean()),
         warp_row_empty_share=warp_empty_share(sorted_mask(ops), keep,
                                               ops.valid != 0))
    got = sk.box_query_moments_brute(k_tr, v_tr, valid_tr, q_tr, hw)
    torch.cuda.synchronize()
    ref = sk.brute_moments_plain(k_tr, v_tr, valid_tr, q_tr, hw)
    err = compare(got, ref, "trainer_store_brute")
    note_err("box_moments", err)
    bx_ms = cuda_ms(lambda: sk.box_query_moments_brute(k_tr, v_tr, valid_tr,
                                                       q_tr, hw))
    bx_plain_ms = cuda_ms(lambda: sk.brute_moments_plain(k_tr, v_tr, valid_tr,
                                                         q_tr, hw))
    # and the sorted kernel through its wrapper on the same queries
    compare(sk.box_query_moments_grouped(k_tr, v_tr, valid_tr, q_tr[None],
                                         hw)[0], ref, "trainer_store_grouped")
    bx_bound = bound_ms(*brute_work(tr_cap, 4096, 21, float(ref[:, 0].sum())))
    emit("kernel_vs_plain", kernel="box_moments", store="trainer_store",
         rows=tr_cap, queries=4096, max_abs_err=err,
         matches=int(ref[:, 0].sum()), kernel_ms=bx_ms, plain_ms=bx_plain_ms,
         bound_ms=bx_bound[0], bound_by=bx_bound[1])
    del snap, state, st_end, ops, got, ref
    torch.cuda.empty_cache()

    # --- train end-to-end check: kernel route == brute route, same draws.
    # 20-step episodes, so the second episode's queries meet the first
    # one's records and the gate sees real statistics
    small = dict(batch_per_device=256, store_capacity_per_device=1 << 13,
                 replay_capacity_per_device=1 << 12,
                 backfill_budget_per_step=512)
    e2e_cfg = DCARLConfig(store=scfg, env=EnvConfig(max_episode_steps=20))
    e2e_steps = 40
    runs = []
    shared = None
    for use_kernel in (True, False):
        init_e, step_e, learner_e, _ = make_trainer_fast(
            e2e_cfg, use_kernel=use_kernel, **small)
        st = init_e(SEED + 4)
        if shared is None:
            shared = learner_e.state_dict()
            dgen = torch.Generator(device=dev).manual_seed(SEED + 5)
            draws = [step_e.draw(dgen) for _ in range(e2e_steps)]
        learner_e.load_state_dict(shared)
        egen = torch.Generator(device=dev).manual_seed(SEED + 6)
        ms_e = []
        for d in draws:
            st, m = step_e.with_draws(st, d, egen)
            ms_e.append(m)
        runs.append((st, ms_e))
    (sa, ma), (sb, mb) = runs
    for field in ("store_keys", "store_size", "store_head", "store_total",
                  "traj_len", "traj_act"):
        if not torch.equal(getattr(sa, field), getattr(sb, field)):
            fail(f"train e2e: {field} differs between kernel and brute routes")
    for field in ("done_count", "pass_count", "collision_count",
                  "rule_fraction", "store_rows", "dropped_records"):
        if not all(torch.equal(getattr(x, field), getattr(y, field))
                   for x, y in zip(ma, mb)):
            fail(f"train e2e: {field} differs between kernel and brute routes")
    if not torch.allclose(sa.store_values, sb.store_values, rtol=1e-5,
                          atol=1e-6):
        fail("train e2e: store values differ")
    rule_frac = torch.stack([m.rule_fraction for m in ma])
    if not float(rule_frac.min()) < 1.0:
        fail("train e2e: the gate never let the learner act (no matches)")
    emit("train_e2e_check", envs=256, steps=e2e_steps, episode_steps=20,
         store_rows=int(sa.store_size[0]),
         rule_fraction_mean=float(rule_frac.mean()),
         rule_fraction_min=float(rule_frac.min()),
         integer_outputs_equal=True)

    # --- the gated driver on a trainer-built store (bench.py:169-210)
    fill_tb, fill_steps, fill_cap = 16384, 300, 1 << 18
    init_f, _, learner_f, factory_f = make_trainer_fast(
        dcfg, batch_per_device=fill_tb, store_capacity_per_device=fill_cap,
        replay_capacity_per_device=1 << 14, backfill_budget_per_step=4096,
        use_kernel=True)
    run_fill = factory_f(fill_steps)
    fill_learner = learner_f.state_dict()
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    st_f, ms_f = run_fill(init_f(SEED + 7),
                          torch.Generator(device=dev).manual_seed(SEED + 8))
    torch.cuda.synchronize()
    fill_s = time.perf_counter() - t0
    fill_launches = dict(_cuda.LAUNCHES)
    if fill_launches != {"sorted_moments": fill_steps}:
        fail(f"trainer fill: launches {fill_launches} != {fill_steps}")
    learner_f.load_state_dict(fill_learner)
    fill_record = []
    with timed_launches(sk, "launch_sorted", fill_record, sorted_probe(sk, _cuda)):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_fill(init_f(SEED + 7),
                 torch.Generator(device=dev).manual_seed(SEED + 8))
        torch.cuda.synchronize()
        fill_replay_s = time.perf_counter() - t0
    fill_summ = summarize(fill_record)
    f_rows = int(st_f.store_size[0])
    f_keys, f_vals = st_f.store_keys[0], st_f.store_values[0]
    f_valid = torch.arange(fill_cap, device=dev) < f_rows
    n_unique_f = torch.unique(f_keys[f_valid], dim=0).shape[0]
    emit("trainer_store_fill", envs=fill_tb, steps=fill_steps,
         store_rows=f_rows, unique_rows=n_unique_f, seconds=fill_s,
         train_env_steps_per_s=fill_tb * fill_steps / fill_s,
         dropped_records=int(ms_f.dropped_records.sum()),
         loss_last=float(ms_f.loss[-1]),
         rule_fraction_last=float(ms_f.rule_fraction[-1]),
         replay_env_steps_per_s=fill_tb * fill_steps / fill_replay_s,
         kernel_share_of_replay=fill_summ["kernel_ms_sum"]
         / (fill_replay_s * 1e3),
         **{"sorted_" + k: v for k, v in fill_summ.items()})
    if not torch.isfinite(ms_f.loss).all() or f_rows <= 0:
        fail("trainer fill: loss not finite or empty store")
    # the sorted kernel against its plain version on the fill's own
    # store and 4,096 of its fleet's last observations (action 0)
    q_f = st_f.obs_ori[0].T[:4096]
    q_f = torch.cat([q_f, torch.zeros_like(q_f[:, :1])], 1).contiguous()
    ops, _ = sk.grouped_query_operands(f_keys, f_vals, f_valid, q_f[None], hw)
    got = sk.sorted_moments(ops)
    torch.cuda.synchronize()
    ref = sk.sorted_moments_plain(ops)
    err = compare(got, ref, "trainer_fill_store_sorted")
    note_err("sorted_moments", err)
    if not torch.equal(sk.sorted_moments(ops), got):
        fail("trainer fill: two sorted_moments launches differ")
    fill_q_ms = cuda_ms(lambda: sk.sorted_moments(ops))
    emit("kernel_vs_plain", kernel="sorted_moments", store="trainer_fill",
         rows=f_rows, queries=4096, max_abs_err=err,
         matches=int(ref[:, 0].sum()),
         max_matches_per_query=int(ref[:, 0].max()), kernel_ms=fill_q_ms,
         deterministic=True,
         warp_row_empty_share=warp_empty_share(
             sorted_mask(ops), sk.sorted_prune_keep(ops), ops.valid != 0))
    del st_f, init_f, factory_f, run_fill, ops, got, ref
    torch.cuda.empty_cache()
    ts_launches, ts_summ, ts_gate = gated_path(
        "gated_on_trainer_store", f_keys, f_vals, f_valid, SEED + 9)

    # --- sharded: the gated driver over the one-rank NCCL mesh against
    # the unsharded one on the trainer-built store, then two gloo ranks
    t_sh = time.perf_counter()
    _, run_gs = fr.make_gated_driver_sharded(sc, mesh1, env_cfg,
                                             store_cfg=scfg, use_kernel=True)
    runs = {}
    for label, fn in (("unsharded", run_g), ("sharded", run_gs)):
        _cuda.LAUNCHES.clear()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, o = fn(carry0, main_t, f_keys, f_vals, f_valid,
                  generator=torch.Generator(device=dev).manual_seed(SEED + 9))
        torch.cuda.synchronize()
        runs[label] = (o, time.perf_counter() - t0, dict(_cuda.LAUNCHES))
    if runs["sharded"][2] != {"peraction_moments": main_t}:
        fail(f"sharded gated: launches {runs['sharded'][2]} != {main_t}")
    for field, a, b in zip(("reward", "done", "passed", "collided",
                           "executed", "gated"), runs["sharded"][0],
                          runs["unsharded"][0]):
        if not torch.equal(a, b):
            fail(f"sharded gated: {field} differs from the unsharded run")
    sharded_world1.update(
        gated_envs=main_b, gated_ticks=main_t,
        gated_launches=runs["sharded"][2],
        gated_env_steps_per_s=main_b * main_t / runs["sharded"][1],
        unsharded_gated_env_steps_per_s=main_b * main_t
        / runs["unsharded"][1], gated_bit_equal=True)
    # the one-rank reference of the two-rank run: zero reset jitter from
    # the same (jittered) starts, so the ranks' reset draws never enter
    _, run_z = fr.make_gated_driver_fast(sc, EnvConfig(reset_jitter=0.0),
                                         store_cfg=scfg, use_kernel=True)
    _, ref_z = run_z(carry0, main_t, f_keys, f_vals, f_valid,
                     generator=torch.Generator(device=dev).manual_seed(
                         SEED + 9))
    del runs, run_gs, run_z
    torch.distributed.destroy_process_group()
    shutil.rmtree(nccl_tmp, ignore_errors=True)
    two_ranks = two_rank_phase(sk, hw, carry0, (f_keys, f_vals, f_valid),
                               ref_z, main_t)
    emit("sharded", world_size_1=sharded_world1, two_ranks=two_ranks,
         seconds=time.perf_counter() - t_sh, gpu=gpu)
    del f_keys, f_vals, f_valid, ref_z
    torch.cuda.empty_cache()

    # --- the closed loop: train -> deploy, persist -> reload, vehicle life
    loop_errs = merge_errs([
        improvement_phase(sk, _cuda, gpu),
        two_session_phase(os.path.join(here, "build", "chip_smoke_sessions"),
                          sk, _cuda, gpu)])
    for kernel, err in loop_errs.items():
        note_err(kernel, err)
    vehicle_life_phase(sk, _cuda, hw, gpu)

    # --- the trust-set DQN trainer, the fleet's trust-set queries, the
    # golden confidence core
    for err in trustset_phase(sk, _cuda, gpu):
        note_err("sorted_moments", err)

    # --- the readable batch-first drivers against the lane-major ones
    note_err("peraction_moments", readable_phase(sk, _cuda, hw, gpu))

    # --- the lane-level field stack: the multilane world and its RLS gate
    # (sorted_moments at D = 21), then cognition -> decision -> trajectory
    # -> safeguard on a loop map and an OpenDrive map
    lane = lane_phase(sk, _cuda, gpu, dev)
    note_err("sorted_moments", lane["max_abs_err"])
    field_phase(gpu, dev)

    # --- the algorithm family, then the vec-env wrappers and utilities
    # (no store kernel on this path)
    vec_phase(gpu, dev, algos_phase(gpu, dev))

    # --- the host layer and the DCARL agent served over TCP: the C++ host
    # library, then the agent tick through sorted_moments at D = 21
    agent_rows = agent_data(np.random.default_rng(SEED))
    host_phase(gpu, dev, agent_rows)
    agent = bridge_phase(sk, _cuda, gpu, dev, agent_rows)
    note_err("sorted_moments", agent["max_abs_err"])

    emit("done", seconds=time.perf_counter() - t_start,
         gated_on_trainer_store_gate_share=ts_gate)
    print(json.dumps({"kernels": [
        {"name": "peraction_moments", "route": "cuda",
         "source": "dcarl_tpu_torch/csrc/peraction_moments.cu",
         "replaces": "dcarl_tpu/ops/pallas_store.py:490",
         "launches": pa_launches["peraction_moments"],
         "max_abs_err": max_err["peraction_moments"],
         "ms": pa_summ["kernel_ms_mean"], "plain_ms": pa_plain_ms,
         "bound_ms": pa_summ["bound_ms_mean"],
         "bound_by": pa_summ["bound_by"], "library_ms": None},
        {"name": "sorted_moments", "route": "cuda",
         "source": "dcarl_tpu_torch/csrc/sorted_moments.cu",
         "replaces": "dcarl_tpu/ops/pallas_store.py:71",
         "launches": tr_launches["sorted_moments"],
         "max_abs_err": max_err["sorted_moments"],
         "ms": so_summ["kernel_ms_mean"], "plain_ms": so_plain_ms,
         "bound_ms": so_summ["bound_ms_mean"],
         "bound_by": so_summ["bound_by"], "library_ms": None,
         # the lane gate's flat D = 21 launch, its own path
         "lane_gate_launches": lane["launches"], "lane_gate_ms": lane["ms"],
         "lane_gate_max_abs_err": lane["max_abs_err"],
         "lane_gate_plain_ms": lane["plain_ms"],
         "lane_gate_plain_queries": lane["plain_queries"],
         "lane_gate_bound_ms": lane["bound_ms"],
         "lane_gate_bound_by": lane["bound_by"],
         # the agent tick's launch (8 queries, D = 21, 2^17 rows), its
         # own path: the served test-mode run's launches
         "agent_tick_launches": agent["launches"],
         "agent_selftest_launches": agent["selftest_launches"],
         "agent_tick_ms": agent["ms"],
         "agent_tick_wrapper_ms": agent["wrapper_ms"],
         "agent_tick_max_abs_err": agent["max_abs_err"],
         "agent_tick_plain_ms": agent["plain_ms"],
         "agent_tick_bound_ms": agent["bound_ms"],
         "agent_tick_bound_by": agent["bound_by"]},
        {"name": "box_moments", "route": "cuda",
         "source": "dcarl_tpu_torch/csrc/box_moments.cu",
         "replaces": "dcarl_tpu/ops/pallas_store.py:32",
         # off both main paths: no launch in the counted runs
         "launches": tr_launches.get("box_moments", 0)
         + pa_launches.get("box_moments", 0),
         "max_abs_err": max_err["box_moments"],
         "ms": bx_ms, "plain_ms": bx_plain_ms, "bound_ms": bx_bound[0],
         "bound_by": bx_bound[1], "library_ms": None},
    ]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
