"""The lane-level gated fleet: ``make_lane_gated_driver_fast`` runs a
lockstep fleet in the multilane world behind the confidence gate, against
a fixed store that the port's ``fill_lane_store`` filled from the
traffic's own seed.  Each ``run_fn`` call prepares the store once for
the flat sorted-band query and replays one captured graph a tick (on the
CPU, the eager loop).

Compared, in each compared call's first tick, for the sampled envs: the
20-D observation and the 8 candidate keys the query was asked with, all
8 actions' counts (exact), sums and sums of squares (``sum_err``) and the
gate's decision, each against the plain reference worked out from the
envs' state at the call's start and the store's rows; that the
reference's gate picked another action than the rule in at least
``limits.gate_fired`` of the compared decisions (a shut gate compares no
decision worth comparing); and that every sampled env advanced or was
reset over the call (its ego position, step count and traffic positions
not all the same after it).  The store's fill is timed as set-up's
``store_fill_s``.

With ``--trace 1`` the port's own tracing is switched on before the
driver is built; the traced call's phases, host spans and kernel
counters are read into the trace's summary (``program_trace``).
"""

from __future__ import annotations

import os
import tempfile
import time

import torch

from dcarl_bench import harness as H
from dcarl_bench import program_trace, spec
from dcarl_bench import trace as T
from dcarl_bench.entries import common
from dcarl_bench.reference import lane as L
from dcarl_bench.reference import store as R

SORTED_KERNELS = ("moments_main", "moments_sum")
STATE = ("ego_s", "ego_lane", "ego_speed", "ego_vd", "veh_s", "veh_lane",
         "veh_speed", "step_count")


class ProgramTracer(H.Tracer):
    """The harness's tracer, with the port's tracing of the stretch
    (``program_trace.start`` before it, ``finish`` after) put into the
    summary as ``program``."""

    def start(self) -> None:
        self._first = program_trace.start()
        super().start()

    def stop(self) -> None:
        H.sync(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            events = T.load_events(path)
            self.summary = T.summarize(events, H.TRACE_WINDOW)
            self.summary["program"] = program_trace.finish(
                self._first, events, H.TRACE_WINDOW)
        finally:
            os.unlink(path)
        self._prof = None


def port_configs(cfg: dict):
    """The port's ``(MultiLaneEnvConfig, StoreConfig)`` holding the
    configuration file's values."""
    from dcarl_tpu_torch.config import StoreConfig
    from dcarl_tpu_torch.env.multilane_env import MultiLaneEnvConfig

    store = {k: tuple(v) if isinstance(v, list) else v
             for k, v in cfg["store"].items()}
    return MultiLaneEnvConfig(**cfg["env"]), StoreConfig(**store)


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, control: str = "") -> dict:
    from dcarl_tpu_torch.utils import profiling

    was = profiling.enabled()
    if trace:
        profiling.enable()
    try:
        return _run(cell, seed, seconds, trace, device, t_start, control)
    finally:
        profiling.enable(was)


def _run(cell, seed, seconds, trace, device, t_start, control) -> dict:
    from dcarl_tpu_torch.planning.lane_rollout import (
        fill_lane_store, make_lane_gated_driver_fast)
    from dcarl_tpu_torch.core.store import store_valid
    from dcarl_tpu_torch.ops import _cuda, store_kernels

    cfg, tr = cell.config, cell.traffic
    if device.type == "cuda":
        _cuda.build()
    env_cfg, store_cfg = port_configs(cfg)
    f = tr["fill"]
    t_fill = time.perf_counter()
    store, written = fill_lane_store(env_cfg, store_cfg, int(f["envs"]),
                                     int(f["ticks"]), int(tr["store_rows"]),
                                     int(f["seed"]), device)
    keys, values, valid = store.keys, store.values, store_valid(store)
    H.sync(device)
    store_fill_s = time.perf_counter() - t_fill

    b, s_ticks = int(tr["envs"]), int(tr["ticks_per_call"])
    a_n = store_cfg.num_candidate_actions
    envs = spec.compared_envs(seed, b, tr)
    envs_t = torch.tensor(envs, dtype=torch.int64, device=device)
    calls = spec.compared_calls(seed, tr)
    traced = range(int(tr["trace"]["first_call"]),
                   int(tr["trace"]["first_call"]) + int(tr["trace"]["calls"]))
    rec = H.Recorder(device)

    def probe(orig):
        def query(prep, queries):
            m = orig(prep, queries)                           # [B * A, 3]
            rec.keep("queries", queries.reshape(b, a_n, -1)
                     .index_select(0, envs_t))
            rec.keep("moments", m.reshape(b, a_n, 3).index_select(0, envs_t))
            rec.add("matched", m[:, 0].sum(dtype=torch.float64))
            rec.disarm()
            return m
        return query

    kept, totals = {}, {}
    with H.patched(store_kernels, "query_sorted_prepared", probe):
        init_fn, run_fn = make_lane_gated_driver_fast(
            env_cfg, store_cfg, device=device)
        run_gen = common.generator(device, seed, "lane-run")
        state = {"carry": init_fn(b, common.generator(device, seed,
                                                      "lane-init"))}

        def one():
            rec.arm()
            state["carry"], outs = run_fn(state["carry"], s_ticks, keys,
                                          values, valid, generator=run_gen)
            return outs

        for _ in range(int(tr["warmup_calls"])):
            one()
        H.sync(device)
        setup_s = time.perf_counter() - t_start

        def call(k: int) -> None:
            before = state["carry"]
            if trace and k == traced.start:
                totals["start"] = rec.totals["matched"].clone()
            outs = one()
            if trace and k == traced.stop - 1:
                totals["stop"] = rec.totals["matched"].clone()
            if k in calls:
                after = state["carry"]
                kept[k] = dict(
                    {n: getattr(before, n).index_select(0, envs_t)
                     for n in STATE},
                    ego_s_after=after.ego_s.index_select(0, envs_t),
                    veh_s_after=after.veh_s.index_select(0, envs_t),
                    step_count_after=after.step_count.index_select(0, envs_t),
                    gated=outs[4][0].index_select(0, envs_t),   # g, tick 0
                    **rec.taken())

        tracer = ProgramTracer(device) if trace else None
        w = H.window(device, seconds, max(int(tr["compare"]
                                              ["within_first_calls"]),
                                          traced.stop),
                     call, traced, tracer)
    dev_line = H.device_line(device, cell.chips)
    del run_fn, init_fn, state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sample, checks = compare(cfg, keys, values, valid, kept, calls, control)
    sample["store_records_written"] = int(written)
    env_steps = w["calls"] * s_ticks * b
    measured = None
    if trace:
        measured = dict(
            trace=tracer.summary, spans=dict(store_fill_s=store_fill_s),
            counters=dict(
                matched=float(totals["stop"] - totals["start"]),
                ticks=len(traced) * s_ticks, rows=int(valid.sum()),
                key_dim=int(keys.shape[1]), queries=b * a_n,
                query_dim=int(keys.shape[1]), answers=b * a_n),
            kernels=dict(sorted_moments=SORTED_KERNELS))
    return H.result(cell, checks, sample, env_steps, 0,
                    dict(gated_env_steps_per_s=env_steps / w["seconds"],
                         setup_s=setup_s),
                    measured, dev_line)


def compare(cfg: dict, keys, values, valid, kept: dict, calls, control: str
            ) -> dict:
    """The checks of the compared calls against the plain reference (with
    ``control="tf32"``, the reference in TF32 stands in the port's
    place)."""
    lim = cfg["limits"]
    a_n = int(cfg["store"]["num_candidate_actions"])
    gate_cfg = cfg["store"]
    n = obs_bad = counts_bad = gate_bad = unmoved = fired = 0
    matched = 0.0
    sum_err = 0.0
    for k in calls:
        r = kept.get(k)
        if r is None:
            continue
        obs = L.observation(*(r[s] for s in STATE[:-1]),
                            num_lanes=int(cfg["env"]["num_lanes"]))
        e = obs.shape[0]
        acts = torch.arange(a_n, dtype=obs.dtype, device=obs.device)
        cand = torch.cat([obs[:, None, :].expand(e, a_n, obs.shape[1]),
                          acts[None, :, None].expand(e, a_n, 1)], dim=2)
        hw = torch.tensor(cfg["store"]["half_widths"], dtype=torch.float32,
                          device=obs.device)
        ref = R.box_moments(keys, values, valid, obs, hw, a_n, "f64")
        port_m, port_g = r["moments"], r["gated"]
        if control == "tf32":
            port_m = R.box_moments(keys, values, valid, obs, hw, a_n,
                                   "tf32")[..., :3].to(torch.float32)
            port_g = R.gate(port_m, gate_cfg)
        obs_bad += int((r["queries"] != cand).reshape(e, -1).any(dim=1).sum())
        c, err = R.sum_errors(port_m, ref)
        counts_bad += c
        sum_err = max(sum_err, err)
        g_ref = R.gate(ref, gate_cfg)
        gate_bad += int((port_g.to(torch.int64) != g_ref).sum())
        fired += int((g_ref != 0).sum())
        matched += float(ref[..., 0].sum())
        unmoved += int(((r["ego_s_after"] == r["ego_s"])
                        & (r["step_count_after"] == r["step_count"])
                        & (r["veh_s_after"] == r["veh_s"]).all(dim=1)).sum())
        n += e
    sample = dict(calls=[k for k in calls if k in kept],
                  store_rows_valid=int(valid.sum()) if n else 0, envs=n,
                  matched_pairs=matched, gate_fired=fired)
    return sample, {
        "compared": spec.check(n, 1, at_least=True),
        "obs_mismatch": spec.check(obs_bad, lim["obs_mismatch"]),
        "count_mismatch": spec.check(counts_bad, lim["count_mismatch"]),
        "sum_err": spec.check(sum_err, lim["sum_err"]),
        "gate_mismatch": spec.check(gate_bad, lim["gate_mismatch"]),
        "unmoved_envs": spec.check(unmoved, lim["unmoved_envs"]),
        "gate_fired": spec.check(fired, lim["gate_fired"], at_least=True),
    }
