#!/usr/bin/env python3
"""Per-launch time of the per-action kernel on the gated driver's two
stores, on one GPU, for the checkout at ``--root``.

Builds the two stores ``chip_smoke.py`` serves the gated driver from:
the rule store (the rule driver at 16,384 envs x 16 ticks, 2^18 rows)
and the trainer-built store (the trainer at 16,384 envs x 300 steps,
capacity 2^18), then drives the gated driver at 65,536 envs x 50 ticks
against each, timing every ``peraction_moments`` launch with CUDA
events.  Prints one JSON line with the per-launch times (mean, min,
max), the card's name and power limit.  Comparing two versions of the
kernel: run it on each checkout in one call, in turns (A, B, B, A).

    python3 tools/torch_peraction_ab.py --root . --label change
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np
import torch


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--root", default=os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    p.add_argument("--label", default="")
    p.add_argument("--seed", type=int, default=0)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, os.path.abspath(args.root))
    from dcarl_tpu_torch import disable_tf32
    from dcarl_tpu_torch.config import (DCARLConfig, EnvConfig,
                                        driving_store_config)
    from dcarl_tpu_torch.env.scenario import t_intersection
    from dcarl_tpu_torch.ops import _cuda, store_kernels as sk
    from dcarl_tpu_torch.planning import fast_rollout as fr
    from dcarl_tpu_torch.train_fast import make_trainer_fast

    disable_tf32()
    dev = torch.device("cuda")
    gpu = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip().splitlines()[0]
    t_start = time.perf_counter()
    ptxas = [ln.strip() for ln in _cuda.build(["peraction_moments"]).get(
        "peraction_moments", "").splitlines()
        if "registers" in ln or "spill" in ln]
    seed = args.seed
    env_cfg, scfg = EnvConfig(), driving_store_config()
    sc = t_intersection(env_cfg)
    hw = torch.as_tensor(scfg.half_widths, dtype=torch.float32, device=dev)
    gen = torch.Generator(device=dev).manual_seed(seed)

    # the rule store (chip_smoke.py's store fill)
    init_r, run_r = fr.make_rule_driver_fast(sc, env_cfg)
    carry = init_r(16384, gen)
    idx = tuple(int(i) for i in np.flatnonzero(sc.vehicle_in_state))
    obs, rew = [], []
    for _ in range(16):
        obs.append(fr._obs_ori_soa(carry, idx).T)
        carry, (reward, *_rest) = run_r(carry, 1, gen)
        rew.append(reward[0])
    obs_all, rew_all = torch.cat(obs), torch.cat(rew)
    n = obs_all.shape[0]
    act = torch.randint(0, 11, (n,), generator=gen, device=dev)
    vals = rew_all + 0.05 * act + 0.02 * torch.randn(n, generator=gen,
                                                     device=dev)
    stores = {"rule_store": (torch.cat([obs_all, act[:, None].float()], 1),
                             vals.float(),
                             torch.ones(n, dtype=torch.bool, device=dev))}

    # the trainer-built store (chip_smoke.py's trainer fill)
    init_f, _, _, factory = make_trainer_fast(
        DCARLConfig(store=scfg), batch_per_device=16384,
        store_capacity_per_device=1 << 18, replay_capacity_per_device=1 << 14,
        backfill_budget_per_step=4096, use_kernel=True)
    st, _ = factory(300)(init_f(seed + 7),
                         torch.Generator(device=dev).manual_seed(seed + 8))
    rows = int(st.store_size[0])
    stores["trainer_store"] = (st.store_keys[0], st.store_values[0],
                               torch.arange(1 << 18, device=dev) < rows)
    del st

    init_g, run_g = fr.make_gated_driver_fast(sc, env_cfg, store_cfg=scfg,
                                              use_kernel=True)
    carry0 = init_g(65536, torch.Generator(device=dev).manual_seed(seed + 2))
    orig = sk.launch_peraction
    out = {"label": args.label, "root": args.root, "gpu": gpu,
           "ptxas": ptxas, "grid": None}
    for name, (k, v, m) in stores.items():
        events = []

        def timed(*a):
            s, e = (torch.cuda.Event(enable_timing=True) for _ in range(2))
            s.record()
            res = orig(*a)
            e.record()
            events.append((s, e))
            return res

        sk.launch_peraction = timed
        try:
            for rep in range(2):      # the first run warms up
                events.clear()
                run_g(carry0, 50, k, v, m,
                      generator=torch.Generator(device=dev).manual_seed(
                          seed + 1))
        finally:
            sk.launch_peraction = orig
        torch.cuda.synchronize()
        ms = [s.elapsed_time(e) for s, e in events]
        out["grid"] = _cuda.GRID.get("peraction_moments")
        out[name] = dict(rows=int(m.sum()), launches=len(ms),
                         ms_mean=float(np.mean(ms)), ms_min=float(np.min(ms)),
                         ms_max=float(np.max(ms)))
    out["seconds"] = time.perf_counter() - t_start
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
