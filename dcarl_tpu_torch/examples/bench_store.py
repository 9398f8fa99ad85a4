"""Microbenchmark of the confidence-store box queries (the JAX package's
``examples/bench_store.py``).

Times the brute-force kernel (``box_moments``), the sorted-band kernel
(``sorted_moments``) and the plain oracle (``core/store._raw_moments``)
across store sizes, then the sorted kernel on a 1/8-full store, and
checks on the way that the sorted query agrees with the oracle and with
the brute one (counts exact, sums within rtol 1e-4 / atol 1e-3), on
the benched queries and on probes next to stored rows.  On the
CPU the two kernels' wrappers take their plain versions.

    python -m dcarl_tpu_torch.examples.bench_store [--device cpu]
"""

from __future__ import annotations

import argparse

import numpy as np
import torch

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.bench import check_moments
from dcarl_tpu_torch.core.store import FIELD_HALF_WIDTHS, _raw_moments
from dcarl_tpu_torch.ops import _cuda, store_kernels


def timeit(fn, args, dev: torch.device, repeats: int = 3,
           inner: int = 64) -> float:
    """Seconds a call of ``fn(*args)``: the best of ``repeats`` runs of
    ``inner`` calls between two synchronizations, after one warm-up."""
    fn(*args)
    best = float("inf")
    for _ in range(repeats):
        best = min(best, cli.seconds(
            lambda: [fn(*args) for _ in range(inner)], dev))
    return best / inner


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--rows", type=int, nargs="+", default=[1 << 16, 1 << 17],
                   help="store sizes")
    p.add_argument("--queries", type=int, default=4096)
    p.add_argument("--inner", type=int, default=64,
                   help="calls a timed run")
    cli.add_device_flag(p)
    args = p.parse_args(argv)
    dev = cli.device_of(args)
    if dev.type == "cuda":
        _cuda.build()

    rng = np.random.default_rng(0)
    d = len(FIELD_HALF_WIDTHS)
    w = torch.as_tensor(FIELD_HALF_WIDTHS, dtype=torch.float32, device=dev)
    n_queries = args.queries
    q = rng.normal(0, 5, (n_queries, d)).astype(np.float32)
    q[:, -1] = rng.integers(0, 8, n_queries)
    queries = torch.as_tensor(q, device=dev)

    for n_rows in args.rows:
        k = rng.normal(0, 5, (n_rows, d)).astype(np.float32)
        k[:, -1] = rng.integers(0, 8, n_rows)
        keys = torch.as_tensor(k, device=dev)
        values = torch.as_tensor(rng.normal(0, 1, n_rows).astype(np.float32),
                                 device=dev)
        valid = torch.ones((n_rows,), dtype=torch.bool, device=dev)
        args_q = (keys, values, valid, queries, w)

        # the random queries meet almost no row: probes next to 256
        # stored rows make the agreement checks bite
        near = keys[:256] + 0.05
        near[:, -1] = keys[:256, -1]
        for label, qs in (("queries", queries), ("near-row probes", near)):
            sorted_q = store_kernels.box_query_moments_sorted(
                keys, values, valid, qs, w)
            check_moments(sorted_q[:256],
                          _raw_moments(keys, values, valid, qs[:256], w),
                          f"N={n_rows}, {label}: sorted against the oracle")
            check_moments(store_kernels.box_query_moments_brute(
                keys, values, valid, qs, w), sorted_q,
                f"N={n_rows}, {label}: brute against sorted")
        if not bool((sorted_q[:, 0] >= 1).all()):
            raise RuntimeError(f"N={n_rows}: a near-row probe matched no row")

        t_brute = timeit(store_kernels.box_query_moments_brute, args_q, dev,
                         inner=args.inner)
        t_sorted = timeit(store_kernels.box_query_moments_sorted, args_q, dev,
                          inner=args.inner)
        t_oracle = timeit(_raw_moments, args_q, dev, inner=args.inner)
        print(f"N={n_rows}: brute {n_queries/t_brute:,.0f} q/s | "
              f"sorted {n_queries/t_sorted:,.0f} q/s | "
              f"plain {n_queries/t_oracle:,.0f} q/s "
              f"(speedup sorted/brute {t_brute/t_sorted:.2f}x)", flush=True)

        # 1/8-full store: the band prune skips the invalid tail
        valid_8 = torch.arange(n_rows, device=dev) < (n_rows // 8)
        t_sorted_8 = timeit(store_kernels.box_query_moments_sorted,
                            (keys, values, valid_8, queries, w), dev,
                            inner=args.inner)
        print(f"  1/8-full store: sorted {n_queries/t_sorted_8:,.0f} q/s",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
