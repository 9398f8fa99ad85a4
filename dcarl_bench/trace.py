"""Reading a ``torch.profiler`` Chrome trace: which kernels the replayed
graphs ran, the device's busy and idle time, and what the host was doing
in the device's idle gaps.

The arithmetic is ``chip_smoke.py``'s traced replays' (kernels a replay,
busy share, kernel time by name), with the device's intervals merged
before they are summed, so overlapping work on two streams counts once.
"""

from __future__ import annotations

import bisect
import collections
import json
from typing import Dict, Iterable, List, Optional, Tuple

GPU_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver", "user_annotation",
             "python_function")
GRAPH_LAUNCH = "cudaGraphLaunch"


def load_events(path: str) -> List[dict]:
    with open(path) as f:
        return json.load(f)["traceEvents"]


def merge(intervals: Iterable[Tuple[float, float]]
          ) -> List[Tuple[float, float]]:
    """The union of [start, end) intervals, as disjoint sorted ones."""
    out: List[List[float]] = []
    for s, e in sorted(intervals):
        if out and s <= out[-1][1]:
            out[-1][1] = max(out[-1][1], e)
        else:
            out.append([s, e])
    return [(s, e) for s, e in out]


def _clip(iv, lo, hi):
    return [(max(s, lo), min(e, hi)) for s, e in iv if e > lo and s < hi]


def _host_labeller(host: List[dict]):
    """``label(t)``: the innermost host event running at time ``t`` (of
    nested events, the latest started that still runs), or ``idle
    host``."""
    host = sorted(host, key=lambda ev: ev["ts"])
    starts = [ev["ts"] for ev in host]

    def label(t: float) -> str:
        i = bisect.bisect_right(starts, t) - 1
        for j in range(i, max(-1, i - 5000), -1):
            if host[j]["ts"] + host[j].get("dur", 0) > t:
                return host[j]["name"]
        return "idle host"

    return label


def summarize(events: List[dict], window: str, top: int = 10) -> dict:
    """What one traced stretch shows.  ``window`` names the host
    annotation that spans it; times in seconds.

    * ``replays``: graph launches in the window;
    * ``replay_kernels``: kernels those launches ran (matched by the
      launch's correlation id), and ``replay_kernel_s``: their seconds by
      kernel name;
    * ``busy_s``, ``window_s``: seconds with a kernel, copy or fill on the
      device (merged), and the window's length;
    * ``device_ops``: the ``top`` names by device seconds;
    * ``idle_gaps``: the ``top`` host events by the device's idle seconds
      that began while they ran."""
    spans = [ev for ev in events if ev.get("name") == window
             and ev.get("ph") == "X"
             and ev.get("cat") != "gpu_user_annotation"]
    if not spans:
        return {}
    lo = spans[0]["ts"]
    hi = lo + spans[0]["dur"]
    gpu = [ev for ev in events if ev.get("ph") == "X"
           and ev.get("cat") in GPU_CATS and ev["ts"] < hi
           and ev["ts"] + ev.get("dur", 0) > lo]
    launches = [ev for ev in events if ev.get("cat") == "cuda_runtime"
                and ev.get("name") == GRAPH_LAUNCH and lo <= ev["ts"] < hi]
    corr = {ev.get("args", {}).get("correlation") for ev in launches}
    corr.discard(None)
    replay_kernels = [ev for ev in gpu if ev.get("cat") == "kernel"
                      and ev.get("args", {}).get("correlation") in corr]
    by_name: Dict[str, float] = collections.Counter()
    for ev in replay_kernels:
        by_name[ev["name"]] += ev["dur"] * 1e-6
    ops: Dict[str, float] = collections.Counter()
    for ev in gpu:
        ops[ev["name"]] += ev["dur"] * 1e-6
    busy = merge(_clip([(ev["ts"], ev["ts"] + ev["dur"]) for ev in gpu],
                       lo, hi))
    busy_s = sum(e - s for s, e in busy) * 1e-6
    host = [ev for ev in events if ev.get("ph") == "X"
            and ev.get("cat") in HOST_CATS and ev.get("name") != window
            and ev["ts"] < hi and ev["ts"] + ev.get("dur", 0) > lo]
    label = _host_labeller(host)
    gaps: Dict[str, float] = collections.Counter()
    t = lo
    for s, e in busy + [(hi, hi)]:
        if s > t:
            gaps[label(t)] += (s - t) * 1e-6
        t = max(t, e)
    return dict(
        replays=len(launches), replay_kernels=len(replay_kernels),
        replay_kernel_s=dict(by_name), busy_s=busy_s,
        window_s=(hi - lo) * 1e-6,
        device_ops=[[k, v] for k, v in ops.most_common(top)],
        idle_gaps=[[k, v] for k, v in gaps.most_common(top)])


def kernel_seconds(summary: dict, parts: Iterable[str]) -> Optional[float]:
    """Seconds of the replayed kernels whose names hold any of ``parts``
    (None when none ran)."""
    names = [n for n in summary.get("replay_kernel_s", {})
             if any(p in n for p in parts)]
    if not names:
        return None
    return sum(summary["replay_kernel_s"][n] for n in names)
