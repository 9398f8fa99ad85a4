"""Reading the port's own tracing (``dcarl_tpu_torch/utils/profiling``)
out of a ``torch.profiler`` Chrome trace: each graph replay split into
the phases its capture recorded, the device time of the work launched
inside each ``dcarl.*`` host span, the device's idle time by the
innermost ``dcarl.*`` span open when it began, and the store-query
kernels' counters over the stretch.

``first = start()`` before the traced stretch and ``finish(first,
events, window)`` after it give the ``program`` part of a trace's
summary; :func:`summarize` is its arithmetic, and the other functions
read a per-layer metric from it.  The port's ``profiling`` is imported
inside :func:`start` and :func:`finish` only; a port without its
``snapshot`` gives no tables and no counters, so every reader returns
None.
"""

from __future__ import annotations

import bisect
import collections
import statistics
from typing import Callable, Dict, List, Optional

from dcarl_bench import trace as T

SPAN_PREFIX = "dcarl."
REPLAY_SPAN = "dcarl.replay."
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")


def _corr(ev: dict):
    return ev.get("args", {}).get("correlation")


def _innermost(spans: List[dict]) -> Callable[[float], Optional[dict]]:
    """``at(t)``: the innermost of ``spans`` running at time ``t`` (of
    nested spans, the latest started that still runs), or None."""
    spans = sorted(spans, key=lambda ev: ev["ts"])
    starts = [ev["ts"] for ev in spans]

    def at(t: float) -> Optional[dict]:
        for j in range(bisect.bisect_right(starts, t) - 1, -1, -1):
            if spans[j]["ts"] + spans[j].get("dur", 0) > t:
                return spans[j]
        return None

    return at


def _phase_spans(launches: List[dict], device: Dict[object, List[dict]],
                 table) -> Optional[dict]:
    """Mean device seconds of each phase over the replays of one runner
    (a phase from its first node's start to its last node's end), and of
    a replay from its first node's start to its last node's end; None
    when a replay's device events do not number the table's total.  The
    mean, as the per-tick kernel times: a fleet's ticks differ many times
    over within a call (on an H100 the per-action query took 0.04 to 34 ms
    a tick in one stretch of 65,536 envs), so a median tick is no share of
    the rate."""
    per_phase: Dict[str, List[float]] = collections.defaultdict(list)
    whole: List[float] = []
    for launch in launches:
        evs = sorted(device.get(_corr(launch), []), key=lambda ev: ev["ts"])
        if len(evs) != table.nodes or not evs:
            return None
        secs: Dict[str, float] = collections.Counter()
        for name, first, end in table.phases:
            if end > first:
                secs[name] += (evs[end - 1]["ts"] + evs[end - 1]["dur"]
                               - evs[first]["ts"]) * 1e-6
        for name, _, _ in table.phases:
            per_phase[name].append(secs[name])
        whole.append((evs[-1]["ts"] + evs[-1]["dur"] - evs[0]["ts"]) * 1e-6)
    if not whole:
        return None
    return dict(replays=len(whole), replay_s=statistics.fmean(whole),
                phases_s={k: statistics.fmean(v)
                          for k, v in per_phase.items()})


def summarize(events: List[dict], window: str, tables: dict) -> dict:
    """What the program's tracing shows in one traced stretch (``window``
    names the host annotation that spans it; times in seconds):

    * ``runners``: for each runner with a phase table in ``tables``
      (runner -> ``profiling.PhaseTable``) and graph launches inside its
      ``dcarl.replay.<runner>`` spans, :func:`_phase_spans`; a runner whose
      replays do not match its table is left out;
    * ``spans``: for each ``dcarl.*`` host span name, its count and the
      device seconds of the work launched while it was the innermost
      ``dcarl.*`` span (runtime launches matched to device events by
      correlation id);
    * ``idle_s``: the device's idle seconds by the innermost ``dcarl.*``
      span open when each gap began (``none`` outside every one);
    * ``window_s``: the stretch's length."""
    win = [ev for ev in events if ev.get("name") == window
           and ev.get("ph") == "X" and ev.get("cat") != "gpu_user_annotation"]
    if not win:
        return {}
    lo = win[0]["ts"]
    hi = lo + win[0]["dur"]

    def inside(ev):
        return ev.get("ph") == "X" and ev["ts"] < hi \
            and ev["ts"] + ev.get("dur", 0) > lo

    gpu = [ev for ev in events if ev.get("cat") in T.GPU_CATS and inside(ev)]
    device: Dict[object, List[dict]] = collections.defaultdict(list)
    for ev in gpu:
        device[_corr(ev)].append(ev)
    spans = [ev for ev in events if ev.get("cat") == "user_annotation"
             and str(ev.get("name", "")).startswith(SPAN_PREFIX)
             and inside(ev)]
    at = _innermost(spans)
    launches = [ev for ev in events if ev.get("cat") in LAUNCH_CATS
                and inside(ev) and _corr(ev) is not None]

    by_runner: Dict[str, List[dict]] = collections.defaultdict(list)
    span_s: Dict[str, float] = collections.Counter()
    for ev in launches:
        owner = at(ev["ts"])
        if owner is None:
            continue
        span_s[owner["name"]] += sum(d["dur"] for d in
                                     device.get(_corr(ev), [])) * 1e-6
        if ev.get("name") == T.GRAPH_LAUNCH \
                and owner["name"].startswith(REPLAY_SPAN):
            by_runner[owner["name"][len(REPLAY_SPAN):]].append(ev)
    runners = {}
    for runner, evs in by_runner.items():
        if runner in tables:
            split = _phase_spans(evs, device, tables[runner])
            if split is not None:
                runners[runner] = split

    counts = collections.Counter(ev["name"] for ev in spans)
    busy = T.merge([(max(ev["ts"], lo), min(ev["ts"] + ev["dur"], hi))
                    for ev in gpu])
    idle: Dict[str, float] = collections.Counter()
    t = lo
    for s, e in busy + [(hi, hi)]:
        if s > t:
            owner = at(t)
            idle["none" if owner is None else owner["name"]] += (s - t) * 1e-6
        t = max(t, e)
    return dict(
        runners=runners,
        spans={k: dict(count=n, device_s=span_s.get(k, 0.0))
               for k, n in counts.items()},
        idle_s=dict(idle), window_s=(hi - lo) * 1e-6)


def _snapshot() -> dict:
    """The port's tracing snapshot; empty for a port without one."""
    from dcarl_tpu_torch.utils import profiling

    snap = getattr(profiling, "snapshot", None)
    return snap() if snap is not None else {"phases": {}, "counters": {}}


def start() -> dict:
    """The port's tracing snapshot at a stretch's start."""
    return _snapshot()


def finish(first: dict, events: List[dict], window: str) -> dict:
    """:func:`summarize` of the stretch, with ``counters``: what the
    store-query kernels counted in it (the totals' change since
    ``first``)."""
    last = _snapshot()
    out = summarize(events, window, last["phases"])
    out["counters"] = {k: v - first["counters"].get(k, 0)
                       for k, v in last["counters"].items()}
    return out


# ---------------------------------------------------------------------------
# Readers: a per-layer metric from a run's ``measured`` dict, whose trace
# summary holds the ``program`` part; None where it has nothing to read.


def _program(m: dict) -> dict:
    return (m.get("trace") or {}).get("program") or {}


def phase_ms(m: dict, runner: str, phase: str) -> Optional[float]:
    """Milliseconds of ``phase`` a replay of ``runner`` (mean)."""
    r = _program(m).get("runners", {}).get(runner)
    if not r or phase not in r["phases_s"]:
        return None
    return 1e3 * r["phases_s"][phase]


def span_ms_per_call(m: dict, span: str) -> Optional[float]:
    """Device milliseconds of the work launched under host span ``span``,
    over the number of such spans."""
    s = _program(m).get("spans", {}).get(span)
    if not s or not s["count"]:
        return None
    return 1e3 * s["device_s"] / s["count"]


def walked_per_match(m: dict, kernel: str) -> Optional[float]:
    """(query, row) pairs ``kernel`` walked over the rows it matched by
    walking plus, for the per-action kernel, those it held whole."""
    c = _program(m).get("counters", {})
    found = c.get(f"{kernel}.matched", 0) + c.get(f"{kernel}.held", 0)
    if not c.get(f"{kernel}.walked") or not found:
        return None
    return c[f"{kernel}.walked"] / found


def idle_pct(m: dict, span: str) -> Optional[float]:
    """The device's idle time under ``span`` (innermost ``dcarl.*`` span
    when the gap began), % of the stretch."""
    p = _program(m)
    if not p.get("window_s") or "idle_s" not in p:
        return None
    return 100.0 * p["idle_s"].get(span, 0.0) / p["window_s"]
