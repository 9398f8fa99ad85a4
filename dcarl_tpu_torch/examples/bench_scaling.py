"""Weak-scaling harness (the JAX package's ``examples/bench_scaling.py``):
env-steps/s of the lane-major rule driver on one rank against the whole
world of ranks, each rank one process on one device.

The driver couples no envs (``shard_rule_driver``: each rank steps its
block, no collective), so the expected efficiency is ~1.0; the harness
measures it.  The world comes from ``parallel.distributed.
initialize_from_env``: one process alone without ``DCARL_NUM_PROCESSES``,
else one process a rank, on its card (NCCL) or the CPU (gloo):

    python -m dcarl_tpu_torch.examples.bench_scaling
    DCARL_NUM_PROCESSES=4 DCARL_PROCESS_ID=<rank> \\
        python -m dcarl_tpu_torch.examples.bench_scaling     # each rank

A world-wide run is as slow as its slowest rank.  Rank 0 prints the
JSON line.
"""

from __future__ import annotations

import argparse
import json

import torch

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel.distributed import (host_device_mesh,
                                                  initialize_from_env)
from dcarl_tpu_torch.parallel.mesh import ProcessMesh
from dcarl_tpu_torch.planning.fast_rollout import (make_rule_driver_fast,
                                                   shard_rule_driver)


def measure(mesh: "ProcessMesh | None", batch_per_device: int, steps: int,
            device: torch.device, repeats: int = 3) -> float:
    """Env-steps/s of ``batch_per_device`` envs on each rank of ``mesh``
    (this rank alone when None), the best of ``repeats`` runs of
    ``steps`` ticks after a warm-up; a run lasts as long as its slowest
    rank."""
    n = 1 if mesh is None else mesh.size
    init_fn, run_fn = make_rule_driver_fast(t_intersection(), device=device)
    if mesh is not None:
        init_fn, run_fn = shard_rule_driver(init_fn, run_fn, mesh)
    batch = n * batch_per_device
    carry = init_fn(batch, cli.generator(device, 0))
    carry, _ = run_fn(carry, steps, cli.generator(device, 1))   # warm-up
    best = float("inf")
    for i in range(repeats):
        out = []
        gen = cli.generator(device, 2 + i)
        s = cli.seconds(lambda: out.append(run_fn(carry, steps, gen)), device)
        carry = out[0][0]
        if n > 1:
            s = float(coll.all_gather(torch.tensor([s], device=device),
                                      mesh).max())
        best = min(best, s)
    return batch * steps / best


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--devices", type=int, default=0,
                   help="world size to measure (0 = every rank)")
    p.add_argument("--batch-per-device", type=int, default=0,
                   help="envs per device (0 = the device's default)")
    p.add_argument("--steps", type=int, default=0)
    cli.add_device_flag(p)
    args = p.parse_args(argv)
    dev = cli.device_of(args)
    world = initialize_from_env(device=dev)
    mesh = host_device_mesh("env", dev)
    n = args.devices or world
    if n != world:
        raise ValueError(f"--devices {n}: each rank is one device, so the "
                         f"world of {world} ranks is what is measured")
    dev = mesh.device
    on_card = dev.type == "cuda"
    bpd = args.batch_per_device or (32768 if on_card else 64)
    steps = args.steps or (300 if on_card else 30)

    rate_1 = measure(None, bpd, steps, dev)
    rate_n = measure(mesh, bpd, steps, dev) if n > 1 else rate_1
    eff = rate_n / (n * rate_1) if n > 1 else 1.0
    if mesh.rank == 0:
        print(json.dumps({
            "metric": "weak-scaling efficiency (rule driver)",
            "devices": n,
            "batch_per_device": bpd,
            "steps_per_s_1dev": round(rate_1, 1),
            "steps_per_s_ndev": round(rate_n, 1),
            "efficiency": round(eff, 4),
            "backend": dev.type,
        }), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
