"""Per-step metrics of the integrated trainer (``dcarl_tpu/train.py``).
The readable batch-first trainer itself is not ported yet; the
lane-major trainer is ``train_fast.py``."""

from __future__ import annotations

from typing import NamedTuple

import torch


class StepMetrics(NamedTuple):
    reward_mean: torch.Tensor
    done_count: torch.Tensor
    pass_count: torch.Tensor
    collision_count: torch.Tensor
    loss: torch.Tensor
    rule_fraction: torch.Tensor
    store_rows: torch.Tensor
    # terminal-backfill records dropped by the fixed compaction budget
    # (0 when the budget is disabled or sufficient)
    dropped_records: torch.Tensor


N_METRICS = len(StepMetrics._fields)
