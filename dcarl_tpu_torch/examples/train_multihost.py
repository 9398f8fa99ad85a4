"""Multi-process integrated DCARL training launcher (the JAX package's
``examples/train_multihost.py``).

The reference scales learning with mpirun and an allreduce Adam
(common/mpi_adam.py:8-121).  Here each process is one rank on one
device: the env batch and the confidence store shard over the ranks,
the rule column's moments cross with an all-gather and a
reduce-scatter, and the gradients with one all-reduce
(``make_trainer_fast(mesh=)``).  The same command on every rank:

    DCARL_NUM_PROCESSES=4 DCARL_PROCESS_ID=<rank> \\
    DCARL_COORDINATOR=<rank-0 host>:8476 \\
    python -m dcarl_tpu_torch.examples.train_multihost --steps 1000 \\
        --batch-per-device 4096

Without ``DCARL_NUM_PROCESSES`` the process runs alone.  ``--smoke``
sets small widths only; the device is ``--device``'s (NCCL between
cards, gloo with ``--device cpu``).  Rank 0 prints a JSON line a chunk.
"""

from __future__ import annotations

import argparse
import json

import torch

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.config import DCARLConfig, DQNConfig, driving_store_config
from dcarl_tpu_torch.parallel.distributed import (host_device_mesh,
                                                  initialize_from_env)
from dcarl_tpu_torch.train_fast import make_trainer_fast, rank_seed

# The widths --smoke sets (the JAX CLI's).
SMOKE = dict(batch_per_device=2, store_capacity=256, steps=8, chunk=4)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--steps", type=int, default=200)
    p.add_argument("--chunk", type=int, default=50)
    p.add_argument("--batch-per-device", type=int, default=1024)
    p.add_argument("--store-capacity", type=int, default=1 << 15)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--smoke", action="store_true",
                   help="small widths (the device is --device's)")
    cli.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = cli.device_of(args)
    n_proc = initialize_from_env(device=dev)
    if args.smoke:
        vars(args).update(SMOKE)
    mesh = host_device_mesh("env", dev)
    cfg = DCARLConfig(
        dqn=DQNConfig(batch_size=4 if args.smoke else 32,
                      replay_capacity=args.store_capacity),
        store=driving_store_config())
    init_fn, _, _, run_factory = make_trainer_fast(
        cfg, batch_per_device=args.batch_per_device,
        store_capacity_per_device=args.store_capacity,
        replay_capacity_per_device=args.store_capacity, mesh=mesh)
    run_fn = run_factory(args.chunk)
    state = init_fn(args.seed)
    gen = cli.generator(mesh.device, rank_seed(args.seed + 1, mesh.rank))
    for i in range(args.steps // args.chunk):
        state, metrics = run_fn(state, gen)
        if mesh.rank == 0:
            # one host copy a chunk: every metric's last step at once
            tail = torch.stack([v[-1].to(torch.float64)
                                for v in metrics]).tolist()
            print(json.dumps({
                "processes": n_proc, "devices": mesh.size,
                "step": (i + 1) * args.chunk,
                **dict(zip(metrics._fields, tail))}), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
