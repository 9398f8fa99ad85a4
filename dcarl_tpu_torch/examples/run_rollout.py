"""Closed-loop rollout demo (the JAX package's ``examples/run_rollout.py``):
the vectorized T-intersection env, the Werling planner and the
controller, with round-robin value collection (the reference's
test_value_collect.py loop).

    python -m dcarl_tpu_torch.examples.run_rollout [--envs 8] [--steps 1200]
        [--readable] [--device cpu | --cpu]

The lane-major collector (``make_collector_fast``) by default; the
batch-first one (``planning/rollout.make_collector``) with
``--readable``.  ``--cpu`` is an alias of ``--device cpu``.
"""

from __future__ import annotations

import argparse
import time

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.env.scenario import t_intersection


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--envs", type=int, default=8)
    p.add_argument("--steps", type=int, default=1200)
    p.add_argument("--readable", action="store_true",
                   help="the batch-first readable collector (the default "
                        "is the lane-major one)")
    cli.add_device_flag(p, cpu_alias=True)
    args = p.parse_args(argv)
    dev = cli.device_of(args)

    sc = t_intersection()
    b, s = args.envs, args.steps
    if args.readable:
        from dcarl_tpu_torch.planning.rollout import make_collector
    else:
        from dcarl_tpu_torch.planning.fast_rollout import \
            make_collector_fast as make_collector
    init_fn, run_fn = make_collector(sc, device=dev)
    carry = init_fn(b, cli.generator(dev, 0))
    cli.sync(dev)
    t0 = time.perf_counter()
    carry, rec = run_fn(carry, s, cli.generator(dev, 1))
    cli.sync(dev)
    dt = time.perf_counter() - t0
    # the lane-major records are [S, B]: flatten like the readable [B, S]
    fields = [rec.done, rec.episode_return, rec.used_action, rec.collided,
              rec.passed]
    done, ret, act, coll, passed = (
        (f if args.readable else f.T).cpu().numpy() for f in fields)

    n_ep = int(done.sum())
    print(f"{b} envs x {s} steps in {dt:.2f}s "
          f"({b * s / dt:,.0f} env-steps/s, first run)")
    print(f"episodes: {n_ep}, passes: {int(passed[done].sum())}, "
          f"collisions: {int(coll[done].sum())}")
    # collected {state, action, return} tuples, like collected_data.txt
    rows = [(int(a), float(r)) for a, r in zip(act[done], ret[done])]
    print("sample (action, return) records:", rows[:10], flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
