"""Finding a cell's files by name, and what a seed fixes.

``BENCHMARK.json`` names each cell's configuration, traffic and metrics;
this module loads them from the files named after them, so a later cell,
traffic mix or metric is added as files and entries alone.  Nothing here
imports torch or the port.
"""

from __future__ import annotations

import importlib.util
import json
import os
from dataclasses import dataclass
from typing import Callable, Dict, List, Optional

import numpy as np

BENCH_DIR = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(BENCH_DIR)


@dataclass(frozen=True)
class Cell:
    """One entry of ``workloads`` with everything it names loaded."""

    name: str
    chips: int
    config: dict
    traffic: dict
    end_to_end: List[dict]
    per_layer: List[dict]


def load_json(path: str) -> dict:
    with open(path) as f:
        return json.load(f)


def load_benchmark(root: str = ROOT) -> dict:
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _applies(metric: dict, cell: str) -> bool:
    return "workloads" not in metric or cell in metric["workloads"]


def load_cell(name: str, root: str = ROOT, bench: Optional[dict] = None
              ) -> Cell:
    """The cell ``name`` of ``BENCHMARK.json`` under ``root``: its
    configuration and traffic files and the metrics it reports."""
    bench = bench if bench is not None else load_benchmark(root)
    entries = [w for w in bench["workloads"] if w["name"] == name]
    if len(entries) != 1:
        raise KeyError(f"no workload named {name!r} in BENCHMARK.json")
    w = entries[0]
    configs = {c["name"]: c for c in bench["configs"]}
    config = dict(load_json(os.path.join(root, configs[w["config"]]["file"])))
    traffic = load_json(os.path.join(root, "dcarl_bench", "workloads",
                                     f"{w['traffic']}.json"))
    return Cell(name=name, chips=int(w["chips"]), config=config,
                traffic=traffic,
                end_to_end=[m for m in bench["end_to_end"]
                            if _applies(m, name)],
                per_layer=[m for m in bench["per_layer"]
                           if _applies(m, name)])


def metric_reader(name: str, root: str = ROOT) -> Callable[[dict], object]:
    """``read(measured) -> float | None`` of ``metrics/<name>.py``."""
    path = os.path.join(root, "dcarl_bench", "metrics", f"{name}.py")
    spec = importlib.util.spec_from_file_location(
        "dcarl_bench_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def entry_module(entry: str):
    """The module ``entries/<entry>.py`` that builds and runs the cell."""
    return importlib.import_module(f"dcarl_bench.entries.{entry}")


def rng(seed: int, purpose: str) -> np.random.Generator:
    """A numpy generator for one purpose of a run's seed: the same seed
    and purpose give the same draws in every run, traced or not."""
    tag = int.from_bytes(purpose.encode(), "little") % (1 << 63)
    return np.random.default_rng([int(seed) % (1 << 64), tag])


def torch_seed(seed: int, purpose: str) -> int:
    """A 63-bit seed for a ``torch.Generator`` (or the port's
    ``init_fn``) for one purpose of the run's seed."""
    return int(rng(seed, purpose).integers(0, 1 << 62))


def compared_calls(seed: int, traffic: dict) -> List[int]:
    """Indices of the window's calls whose first tick or step is held to
    the reference: ``compare.calls`` distinct indices below
    ``compare.within_first_calls``, drawn from the seed alone.  The
    window always runs at least that many calls."""
    c = traffic["compare"]
    n, within = int(c["calls"]), int(c["within_first_calls"])
    if not 0 < n <= within:
        raise ValueError(f"compare.calls {n} must lie in 1..{within}")
    return sorted(int(i) for i in
                  rng(seed, "compared-calls").choice(within, n,
                                                     replace=False))


def compared_envs(seed: int, n_envs: int, traffic: dict) -> List[int]:
    """Indices of the envs whose answers are compared in each compared
    call: ``compare.envs`` distinct envs drawn from the seed alone."""
    k = min(int(traffic["compare"]["envs"]), n_envs)
    return sorted(int(i) for i in
                  rng(seed, "compared-envs").choice(n_envs, k, replace=False))


def check(value: float, limit: float, at_least: bool = False) -> dict:
    """One number compared and its limit: it holds at or under the limit
    (at or over it where ``at_least``)."""
    c = {"value": float(value), "limit": float(limit)}
    if at_least:
        c["at_least"] = True
    return c


def holds(c: dict) -> bool:
    """Whether one check holds (a NaN holds nothing)."""
    if c.get("at_least"):
        return c["value"] >= c["limit"]
    return c["value"] <= c["limit"]


def judge(checks: Dict[str, dict]) -> bool:
    """``correct``: the run compared at least one answer and every number
    is within its limit.  An empty set of checks, or one without the
    count of answers compared, is not correct."""
    if "compared" not in checks:
        return False
    return all(holds(c) for c in checks.values())
