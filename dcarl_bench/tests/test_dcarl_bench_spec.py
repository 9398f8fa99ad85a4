"""Finding cells, configurations, traffic and metrics by name; what a
seed fixes; when a run is correct."""

from __future__ import annotations

import json
import os
import shutil

import pytest

from dcarl_bench import spec
from dcarl_bench.entries import gated_fleet, trainer

BENCH = spec.load_benchmark()
CELLS = [w["name"] for w in BENCH["workloads"]]


@pytest.mark.parametrize("name", CELLS)
def test_cell_files_load_by_name(name):
    cell = spec.load_cell(name)
    assert cell.config["name"] == [w for w in BENCH["workloads"]
                                   if w["name"] == name][0]["config"]
    assert spec.entry_module(cell.config["entry"]).run
    assert any(m["name"] == "setup_s" for m in cell.end_to_end)
    assert len(cell.end_to_end) >= 2 and cell.per_layer
    for m in cell.per_layer:
        assert callable(spec.metric_reader(m["name"]))
        assert spec.metric_reader(m["name"])({}) is None


def test_every_metric_file_loads():
    for m in BENCH["per_layer"]:
        assert spec.metric_reader(m["name"])({}) is None
    for c in BENCH["configs"]:
        cfg = spec.load_json(os.path.join(spec.ROOT, c["file"]))
        assert cfg["name"] == c["name"] and cfg["source"] == c["source"]


def test_new_cell_added_as_files_is_found(tmp_path):
    """A later cell, traffic mix and metric are files and entries alone."""
    root = tmp_path / "checkout"
    (root / "dcarl_bench").mkdir(parents=True)
    for d in ("configs", "workloads", "metrics"):
        shutil.copytree(os.path.join(spec.BENCH_DIR, d),
                        root / "dcarl_bench" / d)
    bench = json.loads(json.dumps(BENCH))
    cfg = spec.load_json(os.path.join(spec.BENCH_DIR, "configs",
                                      "tjunction-fleet.json"))
    cfg["name"] = "tjunction-fleet-b"
    (root / "dcarl_bench" / "configs" / "tjunction-fleet-b.json").write_text(
        json.dumps(cfg))
    traffic = spec.load_json(os.path.join(spec.BENCH_DIR, "workloads",
                                          "fleet-gated-256k.json"))
    traffic["envs"] = 8192
    (root / "dcarl_bench" / "workloads" / "fleet-gated-8k.json").write_text(
        json.dumps(traffic))
    (root / "dcarl_bench" / "metrics" / "new_metric.py").write_text(
        "def read(m):\n    return m.get('x')\n")
    bench["configs"].append(dict(bench["configs"][0], name="tjunction-fleet-b",
                                 file="dcarl_bench/configs/"
                                      "tjunction-fleet-b.json"))
    bench["workloads"].append(dict(name="fleet-gated-8k",
                                   config="tjunction-fleet-b",
                                   traffic="fleet-gated-8k", chips=1,
                                   why="a new cell"))
    bench["per_layer"].append(dict(bench["per_layer"][0], name="new_metric",
                                   workloads=["fleet-gated-8k"]))
    (root / "BENCHMARK.json").write_text(json.dumps(bench))
    cell = spec.load_cell("fleet-gated-8k", root=str(root))
    assert cell.traffic["envs"] == 8192
    assert cell.config["name"] == "tjunction-fleet-b"
    assert [m["name"] for m in cell.per_layer] == ["new_metric"]
    assert spec.metric_reader("new_metric", root=str(root))({"x": 3}) == 3


def test_compared_set_depends_on_seed_alone():
    tr = spec.load_cell("fleet-gated-256k").traffic
    seed = 2 ** 31 + 12345                  # more than 32 signed bits
    a = spec.compared_calls(seed, tr)
    assert a == spec.compared_calls(seed, tr)
    assert len(a) == tr["compare"]["calls"] and len(set(a)) == len(a)
    assert all(0 <= k < tr["compare"]["within_first_calls"] for k in a)
    envs = spec.compared_envs(seed, tr["envs"], tr)
    assert envs == spec.compared_envs(seed, tr["envs"], tr)
    assert len(set(envs)) == tr["compare"]["envs"]
    assert spec.torch_seed(seed, "x") == spec.torch_seed(seed, "x")
    assert spec.torch_seed(seed, "x") != spec.torch_seed(seed, "y")
    assert spec.torch_seed(seed, "x") != spec.torch_seed(seed + 1, "x")


def test_empty_compared_set_is_not_correct():
    assert not spec.judge({})
    cfg = spec.load_cell("fleet-gated-256k").config
    sample, checks = gated_fleet.compare(cfg, None, None, None, {}, [0, 1],
                                         "")
    assert checks["compared"]["value"] == 0 and not spec.judge(checks)
    cfg = spec.load_cell("trainer-32k").config
    sample, checks = trainer.compare(cfg, {}, None, {}, [0, 1], "")
    assert not spec.judge(checks)


def test_judge_holds_every_limit():
    ok = {"compared": spec.check(3, 1, at_least=True),
          "err": spec.check(1e-7, 1e-6)}
    assert spec.judge(ok)
    assert not spec.judge(dict(ok, err=spec.check(2e-6, 1e-6)))
    assert not spec.judge(dict(ok, err=spec.check(float("nan"), 1e-6)))
    assert not spec.judge(dict(ok, compared=spec.check(0, 1, at_least=True)))
