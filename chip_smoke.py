#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port on one NVIDIA GPU.

Drives the port's main path, the confidence-gated deployment driver, at
the size the JAX package's benchmark uses for it (65,536 lockstep envs,
50 ticks, a 2^18-row store), through the CUDA kernel hand-written for
Hopper, and checks it:

  device      torch / CUDA versions, the card's name and power limit
  build       nvcc builds every kernel of the path from csrc/
  store fill  the rule driver at 16,384 envs x 16 ticks; its world-frame
              observations, keyed with seeded actions and valued from the
              tick's reward, make the 2^18-row store
  kernel      kernel against its plain PyTorch version on three stores:
              random with off-lattice rows, 50x duplicated, and the
              main-path store against 4,096 of the main path's queries.
              Counts exact, sums within rtol 1e-4 / atol 1e-3
  main path   gated driver, kernel route; launches must equal the ticks
              and the gate must fire; then a replay of the same run with
              CUDA events around each launch times the kernel
  e2e check   256 envs x 10 ticks through the kernel route and the brute
              reference route: integer outputs equal

Prints one line per phase, a JSON line of kernel numbers, and last
``{"ok": true, "device": {...}}``.  Exits non-zero, printing no result,
without a CUDA device or without the package beside it.

    python3 chip_smoke.py
"""

from __future__ import annotations

import contextlib
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

HBM_BYTES_PER_S = 3.35e12     # H100 SXM device memory
FP32_OPS_PER_S = 67e12        # H100 SXM FP32 outside the tensor cores
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


def small_stores(rng, w_driving):
    """The two small test stores: random with off-lattice action rows,
    and 40 keys each repeated 50x with a stale invalid tail."""
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


@contextlib.contextmanager
def timed_launches(store_kernels, record: list):
    """Wrap the kernel launch with CUDA events (and the operands the
    bound is computed from) for one run; launches still count."""
    orig = store_kernels.launch_peraction

    def timed(prep, queries, qorder, qext):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = orig(prep, queries, qorder, qext)
        end.record()
        keep = store_kernels.prune_keep(prep, qext)
        tile_q = torch.full((keep.shape[0],), float(store_kernels._QT),
                            device=keep.device)
        tile_q[-1] = queries.shape[0] - store_kernels._QT * (keep.shape[0] - 1)
        pairs = (keep.sum(1) * tile_q).sum() * prep.sub_n
        record.append((start, end, pairs, out[..., 0].sum(),
                       queries.shape[0]))
        return out

    store_kernels.launch_peraction = timed
    try:
        yield
    finally:
        store_kernels.launch_peraction = orig


def main() -> int:
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
    from dcarl_tpu_torch.config import EnvConfig, driving_store_config
    from dcarl_tpu_torch.env.driving_env import in_state_indices
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.ops import _cuda, store_kernels
    from dcarl_tpu_torch.planning import fast_rollout as fr

    dev = torch.device("cuda")
    name = torch.cuda.get_device_name(0)

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

    env_cfg = EnvConfig()
    scfg = driving_store_config()
    sc = t_intersection(env_cfg)
    idx = in_state_indices(sc)
    gen = torch.Generator(device=dev).manual_seed(SEED)

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

    # --- kernel against its plain version
    hw = torch.as_tensor(scfg.half_widths, dtype=torch.float32, device=dev)
    rng = np.random.default_rng(SEED)
    max_err = 0.0
    for label, k, v, m, q, w in small_stores(rng, scfg.half_widths):
        t = [torch.as_tensor(np.asarray(a), device=dev) for a in (k, v, m, q, w)]
        prep = store_kernels.prepare_peraction_store(t[0], t[1], t[2],
                                                     t[4].float(), 11)
        got = store_kernels.query_peraction_prepared(prep, t[3].contiguous())
        torch.cuda.synchronize()
        err = compare(got, store_kernels.peraction_moments_plain(prep, t[3]),
                      label)
        max_err = max(max_err, err)
        emit("kernel_vs_plain", store=label, rows=k.shape[0], queries=q.shape[0],
             max_abs_err=err)

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    prep = store_kernels.prepare_peraction_store(s_keys, s_vals, s_valid, hw, 11)
    torch.cuda.synchronize()
    prepare_ms = (time.perf_counter() - t0) * 1e3
    init_g, run_g = fr.make_gated_driver_fast(sc, env_cfg, store_cfg=scfg,
                                              use_kernel=True)
    main_b, main_t = 65536, 50
    carry0 = init_g(main_b, gen)
    q_main = fr._obs_ori_soa(carry0, idx).T.contiguous()      # tick-0 queries
    q_sub = q_main[:4096].contiguous()
    got = store_kernels.query_peraction_prepared(prep, q_sub)
    torch.cuda.synchronize()
    ref = store_kernels.peraction_moments_plain(prep, q_sub)
    err = compare(got, ref, "main_store")
    max_err = max(max_err, err)
    plain_ms = cuda_ms(lambda: store_kernels.peraction_moments_plain(prep, q_sub))
    kern_sub_ms = cuda_ms(lambda: store_kernels.query_peraction_prepared(prep, q_sub))
    emit("kernel_vs_plain", store="main_path", rows=n_rows, queries=4096,
         max_abs_err=err, matches=int(ref[..., 0].sum()),
         kernel_ms=kern_sub_ms, plain_ms=plain_ms, prepare_ms=prepare_ms)

    # --- main path: gated driver, kernel route, counted
    _cuda.LAUNCHES.clear()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    _, out = run_g(carry0, main_t, s_keys, s_vals, s_valid,
                   generator=torch.Generator(device=dev).manual_seed(SEED + 1))
    torch.cuda.synchronize()
    run_s = time.perf_counter() - t0
    launches = dict(_cuda.LAUNCHES)
    reward, done, passed, collided, executed, gated = out
    gate_share = float((gated > 0).float().mean())
    if launches.get("peraction_moments", 0) != main_t:
        fail(f"kernel launches {launches} != {main_t} ticks")
    if gate_share <= 0:
        fail("the gate never fired on the main path")
    if reward.shape != (main_t, main_b) or not torch.isfinite(reward).all():
        fail("main-path rewards not finite or misshapen")

    # replay of the same run, each launch timed by CUDA events
    record = []
    with timed_launches(store_kernels, record):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        run_g(carry0, main_t, s_keys, s_vals, s_valid,
              generator=torch.Generator(device=dev).manual_seed(SEED + 1))
        torch.cuda.synchronize()
        replay_s = time.perf_counter() - t0
    kern_ms = [s.elapsed_time(e) for s, e, *_ in record]
    pairs = [float(p) for _, _, p, _, _ in record]
    matches = [float(m) for _, _, _, m, _ in record]
    ops = [40.0 * p + 3.0 * m for p, m in zip(pairs, matches)]
    n_pad = prep.keys_t.shape[1]
    bytes_ = (n_pad * 24 * 4 + main_b * (20 * 4 + 8 + 33 * 4)
              + 4 * (prep.kb.numel() + prep.kb2.numel() + prep.kbt.numel()))
    bound_bytes_ms = bytes_ / HBM_BYTES_PER_S * 1e3
    bound_ops_ms = float(np.mean(ops)) / FP32_OPS_PER_S * 1e3
    bound_ms = max(bound_bytes_ms, bound_ops_ms)
    emit("main_path", envs=main_b, ticks=main_t, store_rows=n_rows,
         env_steps_per_s=main_b * main_t / run_s, seconds=run_s,
         replay_env_steps_per_s=main_b * main_t / replay_s,
         prepare_ms=prepare_ms, kernel_ms_mean=float(np.mean(kern_ms)),
         kernel_ms_first=kern_ms[0], kernel_ms_last=kern_ms[-1],
         kernel_share_of_replay=sum(kern_ms) / (replay_s * 1e3),
         launches=launches, gate_share=gate_share,
         done_share=float(done.float().mean()),
         pairs_after_prune_mean=float(np.mean(pairs)),
         pairs_total=float(main_b) * n_pad, matches_mean=float(np.mean(matches)),
         bound_bytes_ms=bound_bytes_ms, bound_ops_ms=bound_ops_ms,
         peak_mem_gib=torch.cuda.max_memory_allocated() / 2 ** 30, gpu=gpu)

    # --- end-to-end check: kernel route == brute reference route
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

    print(json.dumps({"kernels": [{
        "name": "peraction_moments", "route": "cuda",
        "source": "dcarl_tpu_torch/csrc/peraction_moments.cu",
        "replaces": "dcarl_tpu/ops/pallas_store.py:490",
        "launches": launches["peraction_moments"],
        "max_abs_err": max_err,
        "ms": float(np.mean(kern_ms)),
        "plain_ms": plain_ms,
        "bound_ms": bound_ms,
        "bound_by": "operations" if bound_ops_ms >= bound_bytes_ms else "bytes",
        "library_ms": None,
    }]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
