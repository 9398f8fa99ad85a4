"""Profiling hooks (``dcarl_tpu/utils/profiling.py``).

The reference records TF1 ``FULL_TRACE`` run metadata every 100 train
steps into TensorBoard (SW/tools/DCARL/stable_baselines/deepq/
dqn.py:273-286).  Here: ``torch.profiler`` traces of the host and the
card, written as Chrome/Perfetto trace files, plus wall-clock timers for
host code.  Everything is a no-op when profiling is off, so the hooks can
stay in production loops.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Optional

import torch


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the enclosed block (CPU ops, and CUDA kernels when a card is
    present) into ``log_dir/trace_<pid>_<ns>.json``, a Chrome trace that
    Perfetto opens; no-op when ``log_dir`` is None (the every-N-steps
    gating knob)."""
    if log_dir is None:
        yield
        return
    acts = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        acts.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=acts) as prof:
        yield
    prof.export_chrome_trace(os.path.join(
        log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """Named region inside a trace (a ``record_function`` span)."""
    return torch.profiler.record_function(name)


class StepTimer:
    """Host-side wall-clock accumulator for coarse step breakdowns
    (warm-up vs steady state, env vs learn).  CUDA work is asynchronous:
    a section that times work on the card must end with
    ``torch.cuda.synchronize()`` (the caller's job, as
    ``block_until_ready`` was under JAX), or it times the launches."""

    def __init__(self):
        self.totals: Dict[str, float] = {}
        self.counts: Dict[str, int] = {}

    @contextlib.contextmanager
    def section(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            dt = time.perf_counter() - t0
            self.totals[name] = self.totals.get(name, 0.0) + dt
            self.counts[name] = self.counts.get(name, 0) + 1

    def summary(self) -> Dict[str, Dict[str, float]]:
        return {k: {"total_s": v, "count": self.counts[k],
                    "mean_s": v / self.counts[k]}
                for k, v in self.totals.items()}
