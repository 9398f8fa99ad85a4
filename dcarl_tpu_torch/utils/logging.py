"""Key-value metrics logging with CSV / JSONL / TensorBoard-style sinks.

Re-design of the SB fork's ``logger.py`` (743 LoC: logkv/dumpkvs with
HumanOutput/CSV/JSON writers) plus the reference's ad-hoc text logs —
``record.txt`` episode rates (TestScenario_Town03.py:321-343),
``collected_data.txt`` (dqn_value_collect.py:128-137) and
``driving_record.txt`` per-step confidence diagnostics
(RLS.py:217-241).  One logger, multiple sinks, host-side only (device
code returns metrics pytrees; the trainer dumps them here).
"""

from __future__ import annotations

import csv
import json
import os
import time
from typing import Dict, Iterable, Optional

import numpy as np


class KVWriter:
    def writekvs(self, kvs: Dict) -> None:
        raise NotImplementedError

    def close(self) -> None:
        pass


class HumanWriter(KVWriter):
    def __init__(self, stream=None):
        import sys

        self.stream = stream or sys.stdout

    def writekvs(self, kvs):
        if not kvs:
            return
        width = max(len(str(k)) for k in kvs)
        lines = ["-" * (width + 24)]
        for k in sorted(kvs):
            v = kvs[k]
            vs = f"{v:.5g}" if isinstance(v, float) else str(v)
            lines.append(f"| {str(k):<{width}} | {vs:<17} |")
        lines.append(lines[0])
        self.stream.write("\n".join(lines) + "\n")
        self.stream.flush()


class CSVWriter(KVWriter):
    """Schema-growing CSV like SB's (logger.py CSVOutputFormat)."""

    def __init__(self, path: str):
        self.path = path
        self.keys: list = []
        self.file = open(path, "w", newline="")
        self.writer = None

    def writekvs(self, kvs):
        new_keys = [k for k in kvs if k not in self.keys]
        if new_keys:
            self.keys.extend(new_keys)
            # rewrite with the extended header
            self.file.close()
            rows = []
            if os.path.getsize(self.path) > 0:
                with open(self.path) as f:
                    rows = list(csv.DictReader(f))
            self.file = open(self.path, "w", newline="")
            self.writer = csv.DictWriter(self.file, fieldnames=self.keys)
            self.writer.writeheader()
            for r in rows:
                self.writer.writerow(r)
        if self.writer is None:
            self.writer = csv.DictWriter(self.file, fieldnames=self.keys)
            self.writer.writeheader()
        self.writer.writerow({k: kvs.get(k, "") for k in self.keys})
        self.file.flush()

    def close(self):
        self.file.close()


class JSONLWriter(KVWriter):
    def __init__(self, path: str):
        self.file = open(path, "w")

    def writekvs(self, kvs):
        self.file.write(json.dumps(kvs, default=float) + "\n")
        self.file.flush()

    def close(self):
        self.file.close()


class TensorBoardWriter(KVWriter):
    """TensorBoard sink — the fork's logger exports KVs to TB
    (stable_baselines/logger.py TensorBoardOutputFormat); here via
    torch.utils.tensorboard (baked in), gated so it stays optional."""

    def __init__(self, log_dir: str):
        from torch.utils.tensorboard import SummaryWriter

        self.writer = SummaryWriter(log_dir=log_dir)
        self.step = 0

    def writekvs(self, kvs):
        step = int(kvs.get("step", self.step))
        for k, v in kvs.items():
            try:
                self.writer.add_scalar(k, float(v), step)
            except (TypeError, ValueError):
                pass  # non-scalar values are for the CSV/JSON sinks
        self.step = step + 1
        self.writer.flush()

    def close(self):
        self.writer.close()


class MetricsLogger:
    """logkv / dumpkvs accumulator (SB logger.py API surface)."""

    def __init__(self, sinks: Optional[Iterable[KVWriter]] = None):
        self.sinks = list(sinks) if sinks is not None else [HumanWriter()]
        self._kvs: Dict = {}
        self._counts: Dict = {}

    def logkv(self, key, value):
        if hasattr(value, "item"):
            value = value.item()
        self._kvs[key] = value

    def logkv_mean(self, key, value):
        if hasattr(value, "item"):
            value = value.item()
        n = self._counts.get(key, 0)
        old = self._kvs.get(key, 0.0)
        self._kvs[key] = old * n / (n + 1) + value / (n + 1)
        self._counts[key] = n + 1

    def dumpkvs(self) -> Dict:
        out = dict(self._kvs)
        for s in self.sinks:
            s.writekvs(out)
        self._kvs.clear()
        self._counts.clear()
        return out

    def close(self):
        for s in self.sinks:
            s.close()


class EpisodeStats:
    """record.txt semantics (TestScenario_Town03.py:321-343): cumulative
    task/stuck/collision counts and rates, appended per reset."""

    def __init__(self, path: Optional[str] = None):
        self.path = path
        self.task_num = 0
        self.stuck_num = 0
        self.collision_num = 0

    def update(self, dones, stucks, collisions) -> Optional[Dict]:
        d = int(np.sum(dones))
        if d == 0:
            return None
        self.task_num += d
        self.stuck_num += int(np.sum(stucks))
        self.collision_num += int(np.sum(collisions))
        stuck_rate = self.stuck_num / self.task_num
        collision_rate = self.collision_num / self.task_num
        pass_rate = 1.0 - (self.stuck_num + self.collision_num) / self.task_num
        row = {
            "task_num": self.task_num,
            "stuck_num": self.stuck_num,
            "collision_num": self.collision_num,
            "stuck_rate": stuck_rate,
            "collision_rate": collision_rate,
            "pass_rate": pass_rate,
        }
        if self.path:
            with open(self.path, "a") as f:
                f.write(f"{self.task_num}, {self.stuck_num}, "
                        f"{self.collision_num}, {stuck_rate}, "
                        f"{collision_rate}, {pass_rate}\n")
        return row


def driving_record_row(state, action, reward, done, stats_rule, stats_rl
                       ) -> np.ndarray:
    """One driving_record.txt row (RLS.py:217-241): state||action,
    reward, done, rule visited/mean/var, RL visited/mean/var."""
    return np.concatenate([
        np.asarray(state, dtype=np.float64).ravel(),
        [float(action), float(reward), float(done)],
        [float(stats_rule[0]), float(stats_rule[1]), float(stats_rule[2])],
        [float(stats_rl[0]), float(stats_rl[1]), float(stats_rl[2])],
    ])
