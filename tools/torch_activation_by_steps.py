#!/usr/bin/env python3
"""Gated-fleet activation against training length, on one GPU.

Trains the port's lane-major trainer with the closed loop's demo
configuration (``improvement.demo_config()``, 2,048 envs, store and
replay 2^17, backfill budget 4,096: the settings of ``chip_smoke.py``'s
two-session phase, and session A's seed) and, every 200 steps from step
400 on, deploys the gated fleet (1,024 envs x 400 ticks) against the
store trained so far.  Prints one JSON line per chunk of 100
steps: the rule fraction, the store's cumulative writes and, at the
evaluation points, the activation fraction and reward per step.  It
shows how many training steps a session needs before the gate can fire.

    python3 tools/torch_activation_by_steps.py --steps 1000
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from dcarl_tpu_torch import disable_tf32, improvement as imp  # noqa: E402
from dcarl_tpu_torch.train_fast import make_trainer_fast  # noqa: E402


def main() -> int:
    p = argparse.ArgumentParser()
    p.add_argument("--steps", type=int, default=1000)
    args = p.parse_args()
    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    disable_tf32()
    cfg = imp.demo_config()
    init_fn, _, _, factory = make_trainer_fast(
        cfg, batch_per_device=2048, store_capacity_per_device=1 << 17,
        replay_capacity_per_device=1 << 17, backfill_budget_per_step=4096,
        use_kernel=True)
    run = factory(100)
    state = init_fn(seed=0)
    gen = torch.Generator(device="cuda").manual_seed(1)
    for i in range(args.steps // 100):
        t0 = time.perf_counter()
        state, m = run(state, gen)
        torch.cuda.synchronize()
        step = (i + 1) * 100
        out = dict(step=step, seconds=time.perf_counter() - t0,
                   rule_fraction=float(m.rule_fraction.float().mean()),
                   store_slots_written=int(state.store_total[0]))
        if step >= 400 and step % 200 == 0:
            ev = imp.evaluate_gated(cfg, imp.merged_store(state), n_envs=1024,
                                    n_steps=400, seed=100, use_kernel=True)
            out.update(activation=ev["activation_fraction"],
                       mean_step_reward=ev["mean_step_reward"])
        print(json.dumps(out), flush=True)
    print(torch.cuda.get_device_name(0), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
