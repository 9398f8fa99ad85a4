"""Store scale: query throughput against row count (the repository's
``tools/bench_store_scale.py``).

The reference's store grows for a vehicle's lifetime (append-only text
and an R-tree, RLS.py:185-215); this sweep shows the port's scaling law
past a comfortable store size.  It times the action-grouped query
(``box_query_moments_grouped``, ``sorted_moments`` on the card) at 11 x
B queries against 2^18 to 2^23 rows, and the gated deployment driver
(``make_gated_driver_fast``, ``peraction_moments`` on the card) at
65,536 envs against 2^18 to 2^22 rows.  Every size is first held to the
oracle (``core/store._raw_moments``, over row chunks of 2^16 so no
[queries, rows] mask is built whole; counts exact, sums within rtol 1e-4
/ atol 1e-3): a slice of the grouped queries, and 32 probes of the
per-action query on the gated sweep's store.

The rows are synthetic corridor noise that almost nothing matches; the
point is the cost's growth with rows and the parity at every size.

    python -m dcarl_tpu_torch.tools.bench_store_scale [--device cpu]

Writes ``--out`` (default ``build/torch_runs/STORE_SCALE.json``).
"""

from __future__ import annotations

import argparse
import json

import numpy as np
import torch

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.bench import check_moments
from dcarl_tpu_torch.config import (DRIVING_HALF_WIDTHS, EnvConfig,
                                    driving_store_config)
from dcarl_tpu_torch.core.store import _raw_moments
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.ops import _cuda, store_kernels
from dcarl_tpu_torch.planning.fast_rollout import make_gated_driver_fast

ORACLE_CHUNK = 1 << 16      # rows an oracle call sees


def corridor_store(rng, rows: int, d: int, n_actions: int = 11) -> np.ndarray:
    """[rows, d] keys spread along the T-intersection's corridor."""
    s = np.zeros((rows, d), np.float32)
    s[:, 0] = rng.normal(242.0, 1.0, rows)
    s[:, 1] = rng.uniform(70.0, 112.0, rows)
    s[:, 2] = rng.normal(0.0, 2.0, rows)
    s[:, 3] = rng.normal(-5.0, 3.0, rows)
    s[:, 4] = rng.normal(-1.57, 0.2, rows)
    s[:, 5:-1] = rng.normal(0.0, 8.0, (rows, d - 6))
    s[:, -1] = rng.integers(0, n_actions, rows)
    return s


def chunked_oracle(keys, values, valid, queries, hw,
                   chunk: int = ORACLE_CHUNK) -> torch.Tensor:
    """[Q, 3] oracle moments summed over row chunks (in f64, rounded to
    f32 once)."""
    out = torch.zeros((queries.shape[0], 3), dtype=torch.float64,
                      device=queries.device)
    for c0 in range(0, keys.shape[0], chunk):
        out += _raw_moments(keys[c0:c0 + chunk], values[c0:c0 + chunk],
                            valid[c0:c0 + chunk], queries, hw).double()
    return out.float()


def _store(rng, rows: int, d: int, dev):
    keys = torch.as_tensor(corridor_store(rng, rows, d), device=dev)
    vals = torch.as_tensor(rng.normal(1.5, 0.5, rows).astype(np.float32),
                           device=dev)
    return keys, vals, torch.ones((rows,), dtype=torch.bool, device=dev)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--sizes", type=int, nargs="+",
                   help="grouped-query store rows (default: 2^18 .. 2^23 "
                        "on the card, 2^12 2^13 on the CPU)")
    p.add_argument("--gated-sizes", type=int, nargs="+",
                   help="gated-driver store rows (default: 2^18 2^20 2^22 "
                        "on the card, 2^12 on the CPU)")
    p.add_argument("--out", default=str(cli.RUNS_DIR / "STORE_SCALE.json"))
    cli.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = cli.device_of(args)
    on_card = dev.type == "cuda"
    if on_card:
        _cuda.build()
    d, A = 21, 11
    B = 16384 if on_card else 256
    sizes = args.sizes or ([1 << 18, 1 << 20, 1 << 21, 1 << 22, 1 << 23]
                           if on_card else [1 << 12, 1 << 13])
    gated_sizes = args.gated_sizes or ([1 << 18, 1 << 20, 1 << 22]
                                       if on_card else [1 << 12])
    g_batch, g_steps = (65536, 20) if on_card else (64, 5)

    rng = np.random.default_rng(0)
    hw = torch.as_tensor(DRIVING_HALF_WIDTHS, dtype=torch.float32, device=dev)
    obs = torch.as_tensor(corridor_store(rng, B, d)[:, :-1], device=dev)
    qg = torch.cat([obs[None].expand(A, B, d - 1),
                    torch.arange(A, dtype=torch.float32, device=dev)
                    [:, None, None].expand(A, B, 1)], -1).contiguous()
    results = {"backend": dev.type, "device": cli.card_line(dev),
               "kernel": [], "gated": []}

    for rows in sizes:
        keys, vals, valid = _store(rng, rows, d, dev)
        q4 = qg[:, :4].contiguous()
        check_moments(store_kernels.box_query_moments_grouped(
            keys, vals, valid, q4, hw),
            chunked_oracle(keys, vals, valid, q4.reshape(-1, d), hw)
            .reshape(A, 4, 3), f"grouped query at {rows} rows")

        def query():
            store_kernels.box_query_moments_grouped(keys, vals, valid, qg, hw)

        query()
        best = min(cli.seconds(query, dev) for _ in range(3))
        results["kernel"].append({
            "rows": rows, "queries": A * B, "ms": best * 1e3,
            "queries_per_s": A * B / best, "parity_checked": True})
        print(f"kernel rows={rows:>8}: {best * 1e3:8.2f} ms "
              f"({A * B / best / 1e6:.2f} M queries/s)", flush=True)
        del keys, vals, valid

    scfg = driving_store_config()
    env_cfg = EnvConfig()
    init_fn, run_fn = make_gated_driver_fast(
        t_intersection(env_cfg), env_cfg, store_cfg=scfg, device=dev)
    for rows in gated_sizes:
        keys, vals, valid = _store(rng, rows, d, dev)
        probe = (keys[:32, :-1] + 0.5).contiguous()
        check_moments(store_kernels.box_query_moments_peraction(
            keys, vals, valid, probe, hw, num_actions=A),
            chunked_oracle(keys, vals, valid, torch.cat([
                probe[None].expand(A, 32, d - 1),
                torch.arange(A, dtype=torch.float32, device=dev)
                [:, None, None].expand(A, 32, 1)], -1).reshape(-1, d), hw)
            .reshape(A, 32, 3).transpose(0, 1),
            f"per-action query at {rows} rows")
        carry = init_fn(g_batch, cli.generator(dev, 0))
        carry, _ = run_fn(carry, g_steps, keys, vals, valid,
                          generator=cli.generator(dev, 1))      # warm-up
        best = float("inf")
        for i in range(3):
            out, gen = [], cli.generator(dev, 2 + i)
            best = min(best, cli.seconds(lambda: out.append(run_fn(
                carry, g_steps, keys, vals, valid, generator=gen)), dev))
            carry = out[0][0]
        rate = g_batch * g_steps / best
        results["gated"].append({"rows": rows, "envs": g_batch,
                                 "env_steps_per_s": rate,
                                 "parity_checked": True})
        print(f"gated  rows={rows:>8}: {rate / 1e3:8.1f} k env-steps/s "
              f"at {g_batch} envs", flush=True)
        del keys, vals, valid

    cli.make_parent(args.out)
    with open(args.out, "w") as f:
        json.dump(results, f, indent=1)
    print("wrote", args.out, flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
