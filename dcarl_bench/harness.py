"""What every cell's run shares: the recorders that copy answers out of
the timed tick, the measured window, the traced stretch, the device's
line and the result line.

A run: set-up (the entry builds the system under test and warms up every
shape it uses), then the window (calls of the entry's ``run_fn`` for
``--seconds``, at least as many as the compared set needs), then, with
the window closed and the memory peak read, the comparison with the
plain reference.  Nothing here imports the port.
"""

from __future__ import annotations

import contextlib
import os
import sys
import tempfile
import time
from typing import Callable, Dict, List, Optional

import torch

from dcarl_bench import spec
from dcarl_bench import trace as T

FORBIDDEN = ("jax", "jaxlib", "flax", "dcarl_tpu")
TRACE_WINDOW = "dcarl_bench_traced"


class Recorder:
    """Copies of values from inside the timed tick.

    ``keep(name, x)`` copies ``x`` into a buffer of its own while the
    recorder is armed (a flag on the device, so it works inside a
    replayed CUDA graph as in the eager loop); ``add(name, x)`` adds
    ``x`` to a float64 total on every tick.  The harness arms the
    recorder before each call and the tick's last probe disarms it, so
    the buffers hold the call's first tick."""

    def __init__(self, device: torch.device):
        self.device = device
        self.armed = torch.zeros((), dtype=torch.bool, device=device)
        self.bufs: Dict[str, torch.Tensor] = {}
        self.totals: Dict[str, torch.Tensor] = {}

    def keep(self, name: str, x: torch.Tensor) -> None:
        x = x.detach()
        buf = self.bufs.get(name)
        if buf is None:
            buf = self.bufs[name] = torch.zeros_like(x)
        torch.where(self.armed, x, buf, out=buf)      # one kernel

    def add(self, name: str, x: torch.Tensor) -> None:
        tot = self.totals.get(name)
        if tot is None:
            tot = self.totals[name] = torch.zeros(
                (), dtype=torch.float64, device=self.device)
        tot.add_(x.detach().to(torch.float64))

    def arm(self) -> None:
        self.armed.fill_(True)

    def disarm(self) -> None:
        self.armed.fill_(False)

    def taken(self) -> Dict[str, torch.Tensor]:
        """Copies of the buffers (of the last armed tick)."""
        return {k: v.clone() for k, v in self.bufs.items()}


@contextlib.contextmanager
def patched(obj, name: str, wrap: Callable):
    """``obj.name`` replaced by ``wrap(original)`` inside the block."""
    orig = getattr(obj, name)
    setattr(obj, name, wrap(orig))
    try:
        yield orig
    finally:
        setattr(obj, name, orig)


def sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


class Tracer:
    """``torch.profiler`` over a stretch of calls; its trace goes to a
    temporary file under ``TMPDIR`` and is summarized and deleted."""

    def __init__(self, device: torch.device):
        self.device = device
        self.summary: Optional[dict] = None
        self._prof = None
        self._span = None

    def start(self) -> None:
        acts = [torch.profiler.ProfilerActivity.CPU]
        if self.device.type == "cuda":
            acts.append(torch.profiler.ProfilerActivity.CUDA)
        sync(self.device)
        self._prof = torch.profiler.profile(activities=acts)
        self._prof.__enter__()
        self._span = torch.profiler.record_function(TRACE_WINDOW)
        self._span.__enter__()

    def stop(self) -> None:
        sync(self.device)
        self._span.__exit__(None, None, None)
        self._prof.__exit__(None, None, None)
        fd, path = tempfile.mkstemp(suffix=".json")
        os.close(fd)
        try:
            self._prof.export_chrome_trace(path)
            self.summary = T.summarize(T.load_events(path), TRACE_WINDOW)
        finally:
            os.unlink(path)
        self._prof = None


def window(device: torch.device, seconds: float, min_calls: int,
           call: Callable[[int], None], traced: Optional[range] = None,
           tracer: Optional[Tracer] = None) -> dict:
    """Calls ``call(k)`` for k = 0, 1, ... until ``seconds`` have passed
    and at least ``min_calls`` calls were made, keeping at most one call
    queued ahead of the device.  With ``tracer``, the calls of
    ``traced`` run under the profiler.  Returns the calls made and the
    window's seconds, from an idle device to an idle device."""
    sync(device)
    t0 = time.perf_counter()
    prev = None
    k = 0
    while True:
        if tracer is not None and traced is not None and k == traced.start:
            tracer.start()
        call(k)
        if tracer is not None and traced is not None and k == traced.stop - 1:
            tracer.stop()
        if device.type == "cuda":
            ev = torch.cuda.Event()
            ev.record()
            if prev is not None:
                prev.synchronize()
            prev = ev
        k += 1
        if k >= min_calls and time.perf_counter() - t0 >= seconds:
            break
    sync(device)
    return dict(calls=k, seconds=time.perf_counter() - t0)


def device_line(device: torch.device, chips: int = 1) -> dict:
    if device.type == "cuda":
        return dict(platform="gpu", kind=torch.cuda.get_device_name(device),
                    count=chips,
                    memory_peak_bytes=int(torch.cuda.max_memory_allocated(
                        device)))
    return dict(platform="cpu", kind="cpu", count=1, memory_peak_bytes=0)


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is one that must not be
    loaded (JAX, its libraries, the JAX package), compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def per_layer(cell: spec.Cell, measured: dict) -> Dict[str, dict]:
    """The cell's per-layer metrics from what the traced run measured;
    a reader that finds nothing leaves its metric out."""
    out = {}
    for m in cell.per_layer:
        value = spec.metric_reader(m["name"])(measured)
        if value is not None:
            out[m["name"]] = {"value": float(value), "unit": m["unit"]}
    return out


def result(cell: spec.Cell, checks: Dict[str, dict], sample: dict,
           attempted: int, failed: int, e2e: Dict[str, float],
           measured: Optional[dict], device: dict) -> dict:
    """The result line.  ``sample`` says what the compared answers held
    (matches, decisions, records); ``checks`` comes last."""
    line = {"correct": spec.judge(checks), "attempted": int(attempted),
            "failed": int(failed)}
    if measured is None:
        line["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                       "unit": m["unit"]}
                           for m in cell.end_to_end}
    else:
        line["metrics"] = per_layer(cell, measured)
        tr = measured.get("trace") or {}
        if tr:
            device = dict(device, busy_s=tr["busy_s"],
                          window_s=tr["window_s"])
            line["breakdown"] = {"device_ops": tr["device_ops"],
                                 "idle_gaps": tr["idle_gaps"]}
    line["device"] = device
    line["sample"] = sample
    line["checks"] = checks
    return line


def check_lines(checks: Dict[str, dict]) -> List[str]:
    """One line a number compared, beside its limit."""
    out = []
    for k, c in checks.items():
        rel = ">=" if c.get("at_least") else "<="
        ok = "ok" if spec.holds(c) else "FAILS"
        out.append(f"check {k} {c['value']!r} {rel} {c['limit']!r} {ok}")
    return out
