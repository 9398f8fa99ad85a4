"""The port's benchmark (the JAX package's ``bench.py``).

Four measurements, each the best of N timed runs on the host clock
between two ``torch.cuda.synchronize()`` calls, after a warm-up:

  env steps     the lane-major rule driver (``make_rule_driver_fast``)
  store query   ``box_query_moments_sorted`` at D = 21, ``inner``
                launches a timed run, checked against the oracle
                ``core/store._raw_moments`` first
  train steps   the integrated trainer (``make_trainer_fast``), every
                timed run from one post-warm-up snapshot
  gated steps   the gated driver (``make_gated_driver_fast``) against a
                store the trainer built, the per-action query checked
                against the oracle first

Prints ONE JSON line with the keys of the JAX bench's line, its
``pallas_parity_checked`` renamed ``kernel_parity_checked``, plus
``device``: the card's name and power limit (null on the CPU).
``vs_baseline`` is null: no baseline has been recorded for the card.

    python -m dcarl_tpu_torch.bench                  # the card's widths
    python -m dcarl_tpu_torch.bench --device cpu     # the CPU smoke widths

Both oracle checks are hard failures on either device; the line says
``kernel_parity_checked: true`` only when both went through the CUDA
kernels.  The kernels are built before the first warm-up, so no timed
run holds a compile.
"""

from __future__ import annotations

import argparse
import json
import math
import time

import numpy as np
import torch

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.config import DCARLConfig, EnvConfig, driving_store_config
from dcarl_tpu_torch.core.store import FIELD_HALF_WIDTHS, _raw_moments
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.ops import _cuda, store_kernels
from dcarl_tpu_torch.planning.fast_rollout import (make_gated_driver_fast,
                                                   make_rule_driver_fast)
from dcarl_tpu_torch.train_fast import make_trainer_fast, snapshot

# The JAX bench's widths (bench.py:260-268): the accelerator's, and the
# CPU smoke run's.
CARD_WIDTHS = dict(batch=32768, steps=300, store_rows=1 << 16,
                   store_queries=4096, train_batch=32768, train_steps=20,
                   train_store=1 << 16, gated_batch=65536, gated_steps=50,
                   gated_rows=1 << 18)
CPU_WIDTHS = dict(batch=64, steps=50, store_rows=4096, store_queries=256,
                  train_batch=16, train_steps=3, train_store=512,
                  gated_batch=32, gated_steps=5, gated_rows=1024)
# Oracle tolerances: counts exact, sums as below (bench.py:232).
SUM_TOL = dict(rtol=1e-4, atol=1e-3)
# Seeds of the trainer run that builds the gated bench's store
# (bench.py:206): init_fn(FILL_SEED), generator FILL_SEED + 1.
FILL_SEED = 7


def check_moments(got: torch.Tensor, ref: torch.Tensor, what: str) -> None:
    """Raise unless ``got`` holds the oracle's counts exactly and its sums
    within :data:`SUM_TOL`."""
    if got.shape != ref.shape:
        raise RuntimeError(f"{what}: shape {tuple(got.shape)} != oracle's "
                           f"{tuple(ref.shape)}")
    if not torch.equal(got[..., 0], ref[..., 0]):
        raise RuntimeError(f"{what}: counts differ from the oracle's")
    if not torch.allclose(got[..., 1:], ref[..., 1:], **SUM_TOL):
        err = float((got[..., 1:] - ref[..., 1:]).abs().max())
        raise RuntimeError(f"{what}: sums differ from the oracle's beyond "
                           f"rtol 1e-4 / atol 1e-3 (max |err| {err})")


def bench_env_steps(batch: int, steps: int, device: torch.device,
                    repeats: int = 3) -> float:
    """Env-steps/s of the lane-major rule driver (bench.py:38)."""
    init_fn, run_fn = make_rule_driver_fast(t_intersection(), device=device)
    carry = init_fn(batch, cli.generator(device, 0))
    carry, _ = run_fn(carry, steps, cli.generator(device, 1))   # warm-up
    best = math.inf
    for i in range(repeats):
        gen = cli.generator(device, 2 + i)
        cli.sync(device)
        t0 = time.perf_counter()
        carry, _ = run_fn(carry, steps, gen)
        cli.sync(device)
        best = min(best, time.perf_counter() - t0)
    return batch * steps / best


def confidence_inputs(n_rows: int, n_queries: int):
    """The store query's inputs as the JAX bench draws them
    (bench.py:72-82): keys, values, valid, queries, half-widths (numpy)."""
    rng = np.random.default_rng(0)
    d = len(FIELD_HALF_WIDTHS)
    keys = rng.normal(0, 5, (n_rows, d)).astype(np.float32)
    keys[:, -1] = rng.integers(0, 8, n_rows)
    values = rng.normal(0, 1, n_rows).astype(np.float32)
    valid = np.ones((n_rows,), bool)
    queries = rng.normal(0, 5, (n_queries, d)).astype(np.float32)
    queries[:, -1] = rng.integers(0, 8, n_queries)
    return keys, values, valid, queries, np.asarray(FIELD_HALF_WIDTHS,
                                                    np.float32)


def bench_confidence_evals(n_rows: int, n_queries: int, device: torch.device,
                           repeats: int = 5) -> "tuple[float, bool]":
    """(queries/s of ``box_query_moments_sorted``, whether its oracle
    check ran through the CUDA kernel) (bench.py:64).  The check holds
    512 queries to the oracle and raises on a difference."""
    args = [torch.as_tensor(a, device=device)
            for a in confidence_inputs(n_rows, n_queries)]
    keys, values, valid, queries, w = args
    launched = _cuda.LAUNCHES["sorted_moments"]
    got = store_kernels.box_query_moments_sorted(keys, values, valid,
                                                 queries[:512], w)
    through_kernel = _cuda.LAUNCHES["sorted_moments"] > launched
    check_moments(got, _raw_moments(keys, values, valid, queries[:512], w),
                  "store query (512 queries)")
    inner = 128 if device.type == "cuda" else 4
    store_kernels.box_query_moments_sorted(*args)                   # warm-up

    def launches():
        for _ in range(inner):
            store_kernels.box_query_moments_sorted(*args)

    best = min(cli.seconds(launches, device) for _ in range(repeats))
    return n_queries * inner / best, through_kernel


def bench_train_steps(batch: int, steps: int, store_capacity: int,
                      device: torch.device, repeats: int = 3) -> float:
    """Env-steps/s of the integrated trainer (bench.py:120); every timed
    run restarts from one post-warm-up snapshot (state and learner), so
    each measures the same store fill."""
    init_fn, _, learner, factory = make_trainer_fast(
        DCARLConfig(store=driving_store_config()),
        batch_per_device=batch, store_capacity_per_device=store_capacity,
        replay_capacity_per_device=store_capacity,
        backfill_budget_per_step=max(2048, batch // 4), device=device)
    run_fn = factory(steps)
    state, _ = run_fn(init_fn(0), cli.generator(device, 0))      # warm-up
    snap, snap_learner = snapshot(state), learner.state_dict()
    best = math.inf
    for i in range(repeats):
        learner.load_state_dict(snap_learner)
        start, gen = snapshot(snap), cli.generator(device, 1 + i)
        best = min(best, cli.seconds(lambda: run_fn(start, gen), device))
    return batch * steps / best


def trainer_store_fill(store_rows: int, batch: int, steps: int,
                       device: torch.device, store_cfg=None):
    """The trainer run that builds the gated bench's store
    (bench.py:196-206): ``(init_fn, learner, run_fn)``, where
    ``run_fn(init_fn(FILL_SEED), generator(FILL_SEED + 1))`` takes
    ``steps`` steps of ``batch`` envs into a ``store_rows``-row ring."""
    init_fn, _, learner, factory = make_trainer_fast(
        DCARLConfig(store=store_cfg or driving_store_config()),
        batch_per_device=batch, store_capacity_per_device=store_rows,
        replay_capacity_per_device=1 << 14,
        backfill_budget_per_step=max(512, batch // 4), device=device)
    return init_fn, learner, factory(steps)


def trainer_store(state, store_rows: int):
    """(keys [N, 21], values [N], valid [N]) of a one-device trainer
    state's store; a row is valid below the store's size."""
    valid = torch.arange(store_rows, device=state.store_size.device) \
        < state.store_size[0]
    return state.store_keys[0], state.store_values[0], valid


def bench_gated_steps(batch: int, steps: int, store_rows: int,
                      device: torch.device, repeats: int = 3
                      ) -> "tuple[float, bool]":
    """(env-steps/s of the gated driver against a trainer-built store,
    whether the oracle check ran through the CUDA kernel)
    (bench.py:163).  The check holds the per-action query of 32 probes
    near stored rows to the oracle and raises on a difference."""
    scfg = driving_store_config()
    env_cfg = EnvConfig()
    sc = t_intersection(env_cfg)
    init_fn, run_fn = make_gated_driver_fast(sc, env_cfg, store_cfg=scfg,
                                             device=device)
    on_card = device.type == "cuda"
    init_t, _, run_t = trainer_store_fill(
        store_rows, 16384 if on_card else 32, 300 if on_card else 8, device,
        scfg)
    t_state, _ = run_t(init_t(FILL_SEED), cli.generator(device, FILL_SEED + 1))
    s_keys, s_vals, s_valid = trainer_store(t_state, store_rows)
    del t_state

    a_n, d = env_cfg.action_dim, env_cfg.state_dim + 1
    hw = torch.as_tensor(scfg.half_widths, dtype=torch.float32, device=device)
    obs_probe = (s_keys[:32, :-1] + 0.5).contiguous()       # near-data probes
    qg = torch.cat([
        obs_probe[None].expand(a_n, 32, d - 1),
        torch.arange(a_n, dtype=torch.float32, device=device)[:, None, None]
        .expand(a_n, 32, 1)], -1).reshape(-1, d)
    ref = _raw_moments(s_keys, s_vals, s_valid, qg, hw) \
        .reshape(a_n, 32, 3).transpose(0, 1)
    launched = _cuda.LAUNCHES["peraction_moments"]
    got = store_kernels.box_query_moments_peraction(
        s_keys, s_vals, s_valid, obs_probe, hw, num_actions=a_n)
    through_kernel = _cuda.LAUNCHES["peraction_moments"] > launched
    check_moments(got, ref, "per-action query (32 probes)")

    carry = init_fn(batch, cli.generator(device, 0))
    run_fn(carry, steps, s_keys, s_vals, s_valid,
           generator=cli.generator(device, 1))                  # warm-up
    best = math.inf
    for i in range(repeats):
        gen = cli.generator(device, 2 + i)
        best = min(best, cli.seconds(lambda: run_fn(
            carry, steps, s_keys, s_vals, s_valid, generator=gen), device))
    return batch * steps / best, through_kernel


def run(device: torch.device) -> dict:
    """The four measurements at the card's widths (the CPU smoke widths
    on the CPU), as the JSON line's dict."""
    w = CARD_WIDTHS if device.type == "cuda" else CPU_WIDTHS
    if device.type == "cuda":
        _cuda.build()             # one nvcc per source, before any timing
    env_rate = bench_env_steps(w["batch"], w["steps"], device)
    conf_rate, conf_kernel = bench_confidence_evals(
        w["store_rows"], w["store_queries"], device)
    train_rate = bench_train_steps(w["train_batch"], w["train_steps"],
                                   w["train_store"], device)
    gated_rate, gated_kernel = bench_gated_steps(
        w["gated_batch"], w["gated_steps"], w["gated_rows"], device)
    return {
        "metric": "env-steps/s per device (vectorized driving env)",
        "value": round(env_rate, 1),
        "unit": "env-steps/s",
        "vs_baseline": None,
        "confidence_evals_per_s": round(conf_rate, 1),
        "confidence_store_rows": w["store_rows"],
        "kernel_parity_checked": device.type == "cuda" and conf_kernel
        and gated_kernel,
        "train_env_steps_per_s": round(train_rate, 1),
        "train_batch": w["train_batch"],
        "train_store_rows": w["train_store"],
        "gated_env_steps_per_s": round(gated_rate, 1),
        "gated_batch": w["gated_batch"],
        "gated_store_rows": w["gated_rows"],
        "env_batch": w["batch"],
        "backend": device.type,
        "device": cli.card_line(device),
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    cli.add_device_flag(p)
    args = p.parse_args(argv)
    print(json.dumps(run(cli.device_of(args))), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
