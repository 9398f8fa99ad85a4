"""What the benchmark may import and when it refuses to run."""

from __future__ import annotations

import ast
import os
import shutil
import subprocess
import sys

import pytest
import torch

from dcarl_bench import spec

FORBIDDEN = {"jax", "jaxlib", "flax", "dcarl_tpu"}
RUN = os.path.join(spec.BENCH_DIR, "run.py")


def _top_imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(sub=""):
    top = os.path.join(spec.BENCH_DIR, sub)
    for d, _, files in os.walk(top):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: ``dcarl_tpu_torch`` is allowed,
    ``dcarl_tpu`` is not."""
    for path in _sources():
        bad = set(_top_imports(path)) & FORBIDDEN
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_port():
    for path in _sources("reference"):
        names = set(_top_imports(path))
        assert not names & (FORBIDDEN | {"dcarl_tpu_torch"}), (path, names)


def test_forbidden_modules_compares_whole_names(monkeypatch):
    from dcarl_bench import harness

    monkeypatch.setitem(sys.modules, "dcarl_tpu_torch_fake", sys)
    assert "dcarl_tpu" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "dcarl_tpu.core", sys)
    assert "dcarl_tpu" in harness.forbidden_modules()


def _run(cwd, env=None):
    return subprocess.run(
        [sys.executable, os.path.join(cwd, "dcarl_bench", "run.py"),
         "--workload", "trainer-32k", "--seed", "3000000019", "--seconds",
         "1", "--trace", "0"], cwd=cwd, capture_output=True, text=True,
        timeout=120, env=env)


def test_refuses_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = _run(spec.ROOT)
    assert out.returncode == 3 and not out.stdout.strip(), out


def test_refuses_without_the_port(tmp_path):
    """In a directory that holds only BENCHMARK.json and the benchmark's
    own files, the run exits with an error and prints no result."""
    shutil.copy(os.path.join(spec.ROOT, "BENCHMARK.json"), tmp_path)
    shutil.copytree(spec.BENCH_DIR, tmp_path / "dcarl_bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = _run(str(tmp_path), env)
    assert out.returncode != 0 and not out.stdout.strip(), out
