"""Simulation-2 demo (the JAX package's ``examples/run_simulation2.py``;
reference: Simulation_testing/Simulation_2/test_DCARL.py): 20 states x
11 actions through the golden confidence table in float64, with the
improvement accounting.  Prints each state's data volume, its
activation step and the final overall value; ``--plot`` draws the
per-state confidence curves sorted by data volume (4 x 5 panels).

    python -m dcarl_tpu_torch.examples.run_simulation2 [--plot]
        [--root DIR] [--out-dir DIR] [--device cpu | --cpu]

The dataset is read under ``--root`` (default: ``data/datasets``'s
root).  The golden core runs in float64 on ``--device`` (the card by
default).  The panels go to ``--out-dir`` (default
``build/torch_runs/``).
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.core import confidence as C
from dcarl_tpu_torch.data import datasets


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--plot", action="store_true")
    p.add_argument("--root", default=None,
                   help="the reference's root (default: datasets' default)")
    p.add_argument("--out-dir", default=str(cli.RUNS_DIR))
    cli.add_device_flag(p, cpu_alias=True)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = cli.device_of(args)
    ds = datasets.load_sim2(args.root)
    data = ds.data[: ds.stream_len]
    state_num = ds.action_values.shape[0]
    cap = C.required_capacity(data, state_num, ds.action_num)
    table, out = C.golden_run(data, ds.action_values,
                              action_num=ds.action_num, capacity=cap,
                              device=dev)

    states = out.state_idx.cpu().numpy()
    values = out.step_value.cpu().numpy()
    activation = table.activation_step.cpu().numpy()
    seen = np.asarray(table.seen)

    print("per-state data volume:", seen.tolist())
    print("activation steps:", activation.tolist())
    print("final overall value:", float(out.overall_value[-1]), flush=True)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        order = np.argsort(-seen)
        max_len = seen[order[0]]
        for i, sid in enumerate(order):
            if i % 5 == 0:
                plt.figure(i // 5 + 1, figsize=(6, 10))
            plt.subplot(5, 1, i % 5 + 1)
            curve = values[states == sid]
            a = activation[sid]
            if a == -1:
                plt.plot(curve, color="darkgray")
            else:
                plt.plot(curve[:a], color="darkgray")
                plt.plot(range(a, len(curve)), curve[a:], color="black")
            plt.xlim((0, max_len))
        for f in range(1, (state_num + 4) // 5 + 1):
            plt.figure(f)
            plt.savefig(cli.make_parent(os.path.join(
                args.out_dir, f"simulation2_panel_{f}.png")), dpi=150)
        plt.close("all")
        print("wrote", os.path.join(args.out_dir, "simulation2_panel_*.png"),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
