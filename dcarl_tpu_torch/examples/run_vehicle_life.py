"""Vehicle-life working-set run (the JAX package's
``examples/run_vehicle_life.py``).

The reference vehicle's store grows for its whole life while serving
every decision tick (deepq/RLS.py:34-76 reload, :185-215 append).  This
run keeps a multi-million-row history on the host, serves the gated
fleet from an active-region cache on the device, re-centers it
asynchronously as the fleet drifts along its route, and audits the
cache against the full history during the run (see
``dcarl_tpu_torch/workingset.py``).

    python -m dcarl_tpu_torch.examples.run_vehicle_life           # full size
    python -m dcarl_tpu_torch.examples.run_vehicle_life --smoke   # small

``--smoke`` sets the widths only (and writes nothing); the device is
``--device``'s.  A full run writes ``--out`` (default
``build/torch_runs/WORKINGSET.json``).
"""

from __future__ import annotations

import argparse
import json

from dcarl_tpu_torch import cli
from dcarl_tpu_torch import workingset as WS

# The widths --smoke sets (the JAX CLI's): the collection, then the run.
SMOKE_COLLECT = dict(n_envs=48, n_steps=400, seed=3)
SMOKE_LIFE = dict(n_envs=48, chunk_steps=10, n_chunks=36, n_offsets=12,
                  cache_capacity=1 << 12, recenter_margin=6.0,
                  checkpoints=3, checkpoint_queries=48)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--smoke", action="store_true",
                   help="small widths, no artifact (the device is "
                        "--device's)")
    p.add_argument("--out", default=str(cli.RUNS_DIR / "WORKINGSET.json"))
    # 450 route positions x 10k episode records each = 4.5M rows
    p.add_argument("--envs", type=int, default=65536)
    p.add_argument("--chunks", type=int, default=120)
    p.add_argument("--local-rows", type=int, default=10000)
    p.add_argument("--offsets", type=int, default=450)
    cli.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = cli.device_of(args)
    if args.smoke:
        history = WS.collect_local_records(**SMOKE_COLLECT, device=dev)
        rep = WS.run_vehicle_life(**SMOKE_LIFE, history=history, device=dev)
    else:
        rep = WS.run_vehicle_life(
            n_envs=args.envs, chunk_steps=50, n_chunks=args.chunks,
            local_rows=args.local_rows, n_offsets=args.offsets,
            offset_spacing=8.0, cache_capacity=1 << 18, region_radius=25.0,
            recenter_margin=10.0, drift_per_chunk=2.0, checkpoints=3,
            checkpoint_queries=256, collect_envs=4096, collect_steps=2048,
            device=dev)
    print(json.dumps({k: v for k, v in rep.items() if k != "timeline"},
                     indent=2), flush=True)
    if not args.smoke:
        with open(cli.make_parent(args.out), "w") as f:
            json.dump(rep, f, indent=1)
        print(f"wrote {args.out}", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
