"""A cell end to end on the card (skips without one): the result line's
keys, ``correct``, and the control coming out not correct."""

from __future__ import annotations

import json
import os
import subprocess
import sys

import pytest
import torch

from dcarl_bench import spec


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: run on the card")


def _line(*extra):
    out = subprocess.run(
        [sys.executable, os.path.join(spec.BENCH_DIR, "run.py"), "--workload",
         "trainer-32k", "--seed", "2147483659", "--seconds", "2", *extra],
        cwd=spec.ROOT, capture_output=True, text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-4000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


@pytest.mark.cuda
def test_trainer_cell_on_the_card(card):
    line = _line("--trace", "0")
    assert line["correct"], line["checks"]
    assert line["device"]["platform"] == "gpu" and line["device"]["count"] == 1
    assert set(line["metrics"]) == {"train_env_steps_per_s", "setup_s"}
    assert list(line)[-1] == "checks"


@pytest.mark.cuda
def test_control_on_the_card(card):
    assert not _line("--trace", "0", "--control", "tf32")["correct"]
