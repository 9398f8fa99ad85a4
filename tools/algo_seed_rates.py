#!/usr/bin/env python3
"""How often DDPG and TD3 clear ``tests/test_algos.py``'s threshold, by
seed, in the JAX package and in the port, on the CPU.

Each learner trains at the learnability test's configuration (the box
identity env of 1 dimension, 32 envs, batch 64, replay 4,096, both
learning rates 1e-3, 800 updates) from each seed, and prints the
deterministic policy's mean error on fresh targets; the test's threshold
is 0.15.  The JAX side runs as the test suite runs it (CPU, 64-bit mode
on), from ``PRNGKey(seed)`` with update keys ``PRNGKey(1000 + i)``; the
port from ``torch.Generator().manual_seed(seed)``.  Prints one JSON
line per learner and package.

    JAX_PLATFORMS=cpu python3 tools/algo_seed_rates.py --seeds 8
"""

from __future__ import annotations

import argparse
import json
import os
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

CFG = dict(batch_size=64, replay_capacity=4096, actor_lr=1e-3, critic_lr=1e-3)
THRESHOLD = 0.15


def jax_errors(name: str, seeds: int):
    import jax
    import jax.numpy as jnp

    jax.config.update("jax_platforms", "cpu")
    jax.config.update("jax_enable_x64", True)
    from dcarl_tpu.algos import common, ddpg, td3

    make, cfg = ((ddpg.make_ddpg, ddpg.DDPGConfig(**CFG)) if name == "ddpg"
                 else (td3.make_td3, td3.TD3Config(**CFG)))
    out = []
    for seed in range(seeds):
        init, update, act = make(common.identity_env_box(1), cfg)
        state = init(jax.random.PRNGKey(seed), 32)
        step = jax.jit(update)
        for i in range(800):
            state, _ = step(state, jax.random.PRNGKey(1000 + i))
        out.append(float(jnp.mean(jnp.abs(act(state, state.obs)
                                          - state.obs))))
    return out


def torch_errors(name: str, seeds: int):
    import torch

    from dcarl_tpu_torch.algos import common, ddpg, td3

    torch.set_num_threads(1)
    make, cfg = ((ddpg.make_ddpg, ddpg.DDPGConfig(**CFG)) if name == "ddpg"
                 else (td3.make_td3, td3.TD3Config(**CFG)))
    out = []
    for seed in range(seeds):
        init, update, act = make(common.identity_env_box(1), cfg)
        g = torch.Generator().manual_seed(seed)
        state = init(g, 32)
        for _ in range(800):
            state, _ = update(state, g)
        out.append(float(torch.mean(torch.abs(act(state, state.obs)
                                              - state.obs))))
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--seeds", type=int, default=8)
    args = ap.parse_args()
    for name in ("ddpg", "td3"):
        for package, fn in (("jax", jax_errors), ("torch", torch_errors)):
            errs = fn(name, args.seeds)
            print(json.dumps({"learner": name, "package": package,
                              "device": "cpu", "errors": errs,
                              "cleared": sum(e < THRESHOLD for e in errs),
                              "seeds": args.seeds}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
