"""Continuous-improvement experiment CLI (the JAX package's
``examples/run_improvement.py``).

Runs the closed loop of ``dcarl_tpu_torch/improvement.py``: the
integrated trainer from an empty confidence store fills the store with
executed (state, action, value) records, the Welch z-test lets learned
candidates act where the data shows they beat the rule, and the gated
fleet is compared with the rule fleet on matched seeds.

    python -m dcarl_tpu_torch.examples.run_improvement             # full size
    python -m dcarl_tpu_torch.examples.run_improvement --smoke     # small widths
    python -m dcarl_tpu_torch.examples.run_improvement --suite     # every arm

``--smoke`` sets the widths only; the device is ``--device`` (the card
unless ``--device cpu``).  Writes ``<out>.json`` and, with matplotlib,
``<out>.png`` (default ``build/torch_runs/IMPROVEMENT``).
"""

from __future__ import annotations

import argparse
import json

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.improvement import (demo_config, run_improvement,
                                         run_improvement_suite)

# The widths --smoke sets (the JAX CLI's).
SMOKE = dict(batch=64, train_steps=250, chunk=50, store_capacity=1 << 14,
             eval_envs=64, eval_steps=250)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--batch", type=int, default=2048)
    p.add_argument("--train-steps", type=int, default=2000)
    p.add_argument("--chunk", type=int, default=100)
    p.add_argument("--store-capacity", type=int, default=1 << 17)
    p.add_argument("--eval-envs", type=int, default=1024)
    p.add_argument("--eval-steps", type=int, default=400)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--out", default=str(cli.RUNS_DIR / "IMPROVEMENT"))
    p.add_argument("--smoke", action="store_true",
                   help="small widths (the device is --device's)")
    p.add_argument("--suite", action="store_true",
                   help="run every arm of the experiment suite (main, "
                        "reference default, negative control, pass-limited, "
                        "two-session lifecycle)")
    p.add_argument("--session-root",
                   default=str(cli.RUNS_DIR / "improvement_sessions"))
    cli.add_device_flag(p)
    return p


def plot(rep: dict, path: str) -> None:
    """The store growth, the trainer's rule fraction and both fleets'
    reward rates (matplotlib, imported here)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    h = rep["train"]["history"]
    fig, axes = plt.subplots(1, 3, figsize=(13, 3.6))
    axes[0].plot(h["step"], h["store_rows"], color="#3f51b5")
    axes[0].set_title("confidence store rows")
    axes[0].set_xlabel("train step")
    axes[1].plot(h["step"], h["rule_fraction"], color="#3f51b5")
    axes[1].set_ylim(0, 1.05)
    axes[1].set_title("trainer rule fraction (gate flips)")
    axes[1].set_xlabel("train step")
    rates = [rep["eval_rule"]["mean_step_reward"],
             rep["eval_gated"]["mean_step_reward"]]
    bars = axes[2].bar(["rule fleet", "gated fleet"], rates,
                       color=["#9e9e9e", "#3f51b5"])
    act = rep["eval_gated"]["activation_fraction"]
    ratio = rep["improvement"]["reward_rate_ratio"]
    ratio_s = "n/a" if ratio is None else f"{ratio:.3f}"
    axes[2].set_title(f"deployment reward rate (x{ratio_s}, "
                      f"activation {act:.1%})")
    axes[2].bar_label(bars, fmt="%.4f")
    fig.suptitle("DCARL continuous improvement: store growth -> "
                 "z-test activation -> fleet beats the rule")
    fig.tight_layout()
    fig.savefig(path, dpi=120)
    plt.close(fig)


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = cli.device_of(args)
    if args.smoke:
        vars(args).update(SMOKE)
    kw = dict(batch_per_device=args.batch, train_steps=args.train_steps,
              chunk=args.chunk, store_capacity_per_device=args.store_capacity,
              eval_envs=args.eval_envs, eval_steps=args.eval_steps,
              seed=args.seed, device=dev)
    cli.make_parent(args.out)
    if args.suite:
        rep = run_improvement_suite(args.session_root, **kw)
        with open(args.out + ".json", "w") as f:
            json.dump(rep, f, indent=1)
        print(json.dumps(rep["summary"]), flush=True)
        return 0

    cfg = demo_config(visited_times_thres=6, rl_visited_times_min=3) \
        if args.smoke else demo_config()
    rep = run_improvement(cfg, **kw)
    with open(args.out + ".json", "w") as f:
        json.dump(rep, f, indent=1)
    print(json.dumps({"improvement": rep["improvement"],
                      "store_rows": rep["train"]["store_rows"],
                      "final_rule_fraction":
                      rep["train"]["final_rule_fraction"]}), flush=True)
    try:
        plot(rep, args.out + ".png")
    except ImportError as e:                     # matplotlib is optional
        print(f"wrote {args.out}.json (no plot: {e})", flush=True)
    else:
        print(f"wrote {args.out}.json, {args.out}.png", flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
