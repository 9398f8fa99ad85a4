"""The gated fleet: ``make_gated_driver_fast`` runs a lockstep fleet on
the T-intersection against a fixed store that the port's trainer filled
from the seed.  Each ``run_fn`` call prepares the store once and replays
one captured graph a tick (on the CPU, the eager loop).

Compared, in each compared call's first tick, for the sampled envs: the
observation the query was asked with, the per-action moments (count,
sum, sum of squares for all actions) and the gate's decision, each
against the plain reference worked out from the envs' state at the
call's start and the store's rows; and that every sampled env moved
over the call (a stopped env is reset by the stuck rule within 41 ticks,
so over 50 ticks none stays put).
"""

from __future__ import annotations

import time

import torch

from dcarl_bench import harness as H
from dcarl_bench import spec
from dcarl_bench.entries import common
from dcarl_bench.reference import store as R

PERACTION_KERNELS = ("peraction_main", "peraction_sum")


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, control: str = "") -> dict:
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.ops import _cuda, store_kernels
    from dcarl_tpu_torch.planning.fast_rollout import make_gated_driver_fast

    cfg, tr = cell.config, cell.traffic
    if device.type == "cuda":
        _cuda.build()
    t_fill = time.perf_counter()
    keys, values, valid = common.fill_store(cfg, tr, device)
    H.sync(device)
    store_fill_s = time.perf_counter() - t_fill

    b, s_ticks = int(tr["envs"]), int(tr["ticks_per_call"])
    a_n = int(cfg["env"]["action_dim"])
    envs = spec.compared_envs(seed, b, tr)
    envs_t = torch.tensor(envs, dtype=torch.int64, device=device)
    calls = spec.compared_calls(seed, tr)
    traced = range(int(tr["trace"]["first_call"]),
                   int(tr["trace"]["first_call"]) + int(tr["trace"]["calls"]))
    rec = H.Recorder(device)

    def probe(orig):
        def query(prep, queries, out_dtype=torch.float32):
            m = orig(prep, queries, out_dtype=out_dtype)      # [B, A, 3]
            rec.keep("queries", queries.index_select(0, envs_t))
            rec.keep("moments", m.index_select(0, envs_t))
            rec.add("matched", m[..., 0].sum(dtype=torch.float64))
            rec.disarm()
            return m
        return query

    kept, totals = {}, {}
    with H.patched(store_kernels, "query_peraction_prepared", probe):
        env_cfg, store_cfg, _ = common.port_configs(cfg)
        init_fn, run_fn = make_gated_driver_fast(
            t_intersection(env_cfg), env_cfg, store_cfg=store_cfg,
            device=device, use_kernel=True)
        run_gen = common.generator(device, seed, "fleet-run")
        state = {"carry": init_fn(b, common.generator(device, seed,
                                                      "fleet-init"))}

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
                kept[k] = dict(
                    ego=before.ego.index_select(1, envs_t),
                    walker=before.walker.index_select(1, envs_t),
                    vehicles=before.vehicles.index_select(2, envs_t),
                    ego_after=state["carry"].ego.index_select(1, envs_t),
                    gated=outs[5][0].index_select(0, envs_t),  # g, tick 0
                    **rec.taken())

        tracer = H.Tracer(device) if trace else None
        w = H.window(device, seconds, max(int(tr["compare"]
                                              ["within_first_calls"]),
                                          traced.stop),
                     call, traced, tracer)
    dev_line = H.device_line(device, cell.chips)
    del run_fn, init_fn, state
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sample, checks = compare(cfg, keys, values, valid, kept, calls, control)
    env_steps = w["calls"] * s_ticks * b
    measured = None
    if trace:
        measured = dict(
            trace=tracer.summary, spans=dict(store_fill_s=store_fill_s),
            counters=dict(
                matched=float(totals["stop"] - totals["start"]),
                ticks=len(traced) * s_ticks, rows=int(valid.sum()),
                key_dim=int(keys.shape[1]), queries=b,
                query_dim=int(keys.shape[1]) - 1, answers=b * a_n),
            kernels=dict(peraction=PERACTION_KERNELS))
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
    a_n = int(cfg["env"]["action_dim"])
    gate_cfg = cfg["store"]
    n = obs_bad = counts_bad = gate_bad = unmoved = fired = 0
    matched = 0.0
    sum_err = 0.0
    for k in calls:
        r = kept.get(k)
        if r is None:
            continue
        obs = R.observation(r["ego"], r["walker"], r["vehicles"],
                            cfg["in_state_vehicles"])
        hw = torch.tensor(cfg["store"]["half_widths"], dtype=torch.float32,
                          device=obs.device)
        ref = R.box_moments(keys, values, valid, obs, hw, a_n, "f64")
        port_m, port_g = r["moments"], r["gated"]
        if control == "tf32":
            port_m = R.box_moments(keys, values, valid, obs, hw, a_n,
                                   "tf32")[..., :3].to(torch.float32)
            port_g = R.gate(port_m, gate_cfg)
        obs_bad += int((r["queries"] != obs).any(dim=1).sum())
        c, e = R.sum_errors(port_m, ref)
        counts_bad += c
        sum_err = max(sum_err, e)
        g_ref = R.gate(ref, gate_cfg)
        gate_bad += int((port_g.to(torch.int64) != g_ref).sum())
        fired += int((g_ref != 0).sum())
        matched += float(ref[..., 0].sum())
        unmoved += int((r["ego_after"][:2] == r["ego"][:2]).all(dim=0).sum())
        n += obs.shape[0]
    sample = dict(calls=[k for k in calls if k in kept],
                  store_rows_valid=int(valid.sum()) if n else 0, envs=n,
                  matched_triples=matched, gate_fired=fired)
    return sample, {
        "compared": spec.check(n, 1, at_least=True),
        "obs_mismatch": spec.check(obs_bad, lim["obs_mismatch"]),
        "count_mismatch": spec.check(counts_bad, lim["count_mismatch"]),
        "sum_err": spec.check(sum_err, lim["sum_err"]),
        "gate_mismatch": spec.check(gate_bad, lim["gate_mismatch"]),
        "unmoved_envs": spec.check(unmoved, lim["unmoved_envs"]),
    }
