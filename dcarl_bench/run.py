"""Run one cell of the benchmark of ``dcarl_tpu_torch`` on the card.

    python3 dcarl_bench/run.py --workload fleet-gated-256k --seed 7 \\
        --seconds 20 --trace 0

Prints the result as one JSON line, the last line of standard output,
after each number compared beside its limit on standard error.  With
``--trace 0`` the metrics are the cell's end-to-end metrics, with
``--trace 1`` its per-layer ones (a short stretch of the window traced).
``--control tf32`` puts the plain reference, computed in TF32, in the
port's place for the answers compared (the control that has to come out
not correct); the benchmark's own runs never pass it.

Exits with 2 when the port cannot be imported, 3 when there is no CUDA
device (or fewer than the cell needs), 4 when JAX or the JAX package
was loaded; it then prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", choices=("", "tf32"), default="")
    args = p.parse_args(argv)
    if ROOT not in sys.path:
        sys.path.insert(0, ROOT)
    try:
        import torch
        from dcarl_bench import harness, spec
        from dcarl_tpu_torch import disable_tf32
    except ImportError as e:
        print(f"dcarl_bench: cannot import the system under test: {e}",
              file=sys.stderr)
        return 2
    cell = spec.load_cell(args.workload)
    if not torch.cuda.is_available() \
            or torch.cuda.device_count() < cell.chips:
        print(f"dcarl_bench: {cell.name} needs {cell.chips} CUDA device(s); "
              f"{torch.cuda.device_count()} available", file=sys.stderr)
        return 3
    disable_tf32()
    line = spec.entry_module(cell.config["entry"]).run(
        cell, args.seed, args.seconds, bool(args.trace),
        torch.device("cuda"), T_START, args.control)
    bad = harness.forbidden_modules()
    if bad:
        print(f"dcarl_bench: forbidden modules loaded: {bad}",
              file=sys.stderr)
        return 4
    sys.stderr.write("\n".join(harness.check_lines(line["checks"])) + "\n")
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
