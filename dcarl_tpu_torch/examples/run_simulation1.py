"""Simulation-1 demo (the JAX package's ``examples/run_simulation1.py``;
reference: Simulation_testing/Simulation_1/test_DCARL.py): confidence
values of the bundled CARLA stream, 20k {state, action, value} rows
through the golden confidence table (1 state x 30 actions) in float64.
Prints the decision every 2,000 rows and the activation step; ``--plot``
draws the confidence-value curve.

    python -m dcarl_tpu_torch.examples.run_simulation1 [--plot]
        [--root DIR] [--out-dir DIR] [--device cpu | --cpu]

The dataset is read under ``--root`` (default: ``data/datasets``'s
root).  The golden core runs in float64 on ``--device`` (the card by
default).  The plot goes to ``--out-dir`` (default
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
    ds = datasets.load_sim1(args.root)
    data = ds.data[: ds.stream_len]
    cap = C.required_capacity(data, ds.action_values.shape[0], ds.action_num)
    table, out = C.golden_run(data, ds.action_values,
                              action_num=ds.action_num, capacity=cap,
                              device=dev)
    step_values = out.step_value.cpu().numpy()
    tsrl_action = out.tsrl_action.cpu().numpy()
    true_value = out.true_value.cpu().numpy()
    for k in range(2000, ds.stream_len + 1, 2000):
        print(k, int(tsrl_action[k - 1]), step_values[k - 1],
              float(true_value[k - 1]))
    print("activation step:", int(table.activation_step[0]), flush=True)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        path = cli.make_parent(os.path.join(
            args.out_dir, "simulation1_confidence_curve.png"))
        plt.figure()
        plt.plot(np.asarray(step_values), color="black")
        plt.xlim((0, ds.stream_len))
        plt.savefig(path, dpi=150)
        plt.close()
        print("wrote", path, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
