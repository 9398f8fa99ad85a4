"""Tracing of the port (``dcarl_tpu/utils/profiling.py``): one switch,
host spans, device phases of the captured ticks and counters in the
store-query kernels.

The reference records TF1 ``FULL_TRACE`` run metadata every 100 train
steps into TensorBoard (SW/tools/DCARL/stable_baselines/deepq/
dqn.py:273-286).  Here the operator's API is:

* :func:`enable` / :func:`enabled`: the switch, off by default.  Off,
  the program is what it is without this module: :func:`span` and
  :func:`phase` return one shared no-op context, the captured graphs hold
  the same nodes and the store-query kernels run their instantiation
  without counters.  Switch it on before the runners capture:
  ``utils/graphs.TickRunner`` keys its captures by the switch, so the
  first run after it flips captures anew instead of replaying a graph
  made without it.
* :func:`span`: a ``torch.profiler.record_function`` span when on, on
  the host, in the same Kineto trace (and on the same clock) as the
  kernels.  ``TickRunner`` opens ``dcarl.load`` (the copy into its static
  buffers), ``dcarl.capture`` (the warm-up tick and the capture),
  ``dcarl.replay.<runner>`` (a call's whole replay loop) and
  ``dcarl.result`` (the result's copies); the gated drivers (runners
  ``gated`` and ``lane``) open ``dcarl.store_prepare`` around a call's
  store prepare.
* :func:`phase`: a named part of a tick function (``plan``, ``query``,
  ...).  While a ``TickRunner`` captures, entering and leaving a phase
  records how many device-activity nodes (kernel, memcpy, memset) the
  capturing graph holds, so each capture keeps a table ``[(phase,
  first_node, end_node), ...]`` and its total, registered under the
  runner's name.  The graph itself is not changed.  A tick is captured on
  one stream as a chain, so a replay's device events in start order are
  its nodes in capture order: the table splits every replay in a device
  trace into phases, on the trace's own clock, at no cost to the replay.
  Outside a capture (the eager route, a warm-up tick) a phase is a span.
* Counters: with the switch on, ``csrc/peraction_moments.cu`` adds up the
  (query, record) pairs it walks, the rows it matches by walking and the
  live rows it settles whole from piece sums (the last two weighted by
  the count moment, so their sum is the count the kernel returned) and
  the (warp, live row) iterations of its walk (walked / (32 warp_rows)
  is the walk's lane occupancy), and
  ``csrc/band_moments.cuh`` (``sorted_moments``, ``box_moments``) the
  pairs it walks and matches, into int64 totals on the device
  (:data:`COUNTERS`).  Off, each launch passes no pointer and runs the
  instantiation without counters.  ``ops/store_kernels.py``'s
  flat route's prepare (``prepare_sorted_store``,
  ``box_query_moments_sorted``) adds one to ``sorted_prepare.prepares`` a
  call, to ``sorted_prepare.composite`` when it bands on the composite
  (action, second dim) key and to ``sorted_prepare.bucketed`` when that
  key holds the bucketed middle level; ``prepared_query_operands`` adds
  the queries it asks as two copies to ``sorted_query.split``; all with
  device adds.
* :func:`snapshot`: the registered phase tables and the counter totals
  (one host read, made only when asked).
* :func:`trace`: a ``torch.profiler`` Chrome trace of a block, written
  to a directory (the operator's exporter).
"""

from __future__ import annotations

import contextlib
import ctypes
import os
import threading
import time
from typing import Dict, List, NamedTuple, Optional, Tuple

import torch

from dcarl_tpu_torch.ops import _cuda

# What each store-query kernel counts, in the order its C entry point
# writes the totals, and last what the flat route's store prepare and
# query count.
COUNTERS: Dict[str, Tuple[str, ...]] = {
    "peraction_moments": ("walked", "matched", "held", "warp_rows"),
    "sorted_moments": ("walked", "matched"),
    "box_moments": ("walked", "matched"),
    "sorted_prepare": ("prepares", "composite", "bucketed"),
    "sorted_query": ("split",),
}
_OFFSET: Dict[str, int] = {}   # kernel -> its first slot in the totals
_N_COUNTERS = 0
for _kernel, _names in COUNTERS.items():
    _OFFSET[_kernel] = _N_COUNTERS
    _N_COUNTERS += len(_names)

_NOOP = contextlib.nullcontext()
_ON = False
_TABLES: Dict[str, "PhaseTable"] = {}
_TOTALS: Dict[torch.device, torch.Tensor] = {}
_CAPTURE = threading.local()   # .phases: the table of the capture in flight


class PhaseTable(NamedTuple):
    """One capture's phases: ``(name, first_node, end_node)`` in capture
    order (nodes ``[first_node, end_node)`` of the graph's device-activity
    nodes) and the graph's total of such nodes."""

    phases: Tuple[Tuple[str, int, int], ...]
    nodes: int


def enable(on: bool = True) -> None:
    """Switch tracing on (or off).  Do it before the runners capture.
    On a machine with a card it makes the current device's counter totals
    and loads ``csrc/capture_nodes.cu`` (building it if missing) here,
    outside any capture."""
    global _ON
    _ON = bool(on)
    if _ON and torch.cuda.is_available():
        dev = torch.device("cuda", torch.cuda.current_device())
        _totals(dev)
        capture_nodes(torch.cuda.current_stream(dev))


def enabled() -> bool:
    return _ON


def span(name: str):
    """A host span named ``name`` in a profiler trace when on; the shared
    no-op context when off."""
    return torch.profiler.record_function(name) if _ON else _NOOP


def phase(name: str):
    """A named part of a tick function: recorded into the phase table of
    the capture in flight, a :func:`span` outside a capture, nothing when
    off."""
    if not _ON:
        return _NOOP
    rec = getattr(_CAPTURE, "phases", None)
    if rec is None:
        return torch.profiler.record_function(name)
    return _captured_phase(rec, name)


@contextlib.contextmanager
def _captured_phase(rec: List[Tuple[str, int, int]], name: str):
    stream = torch.cuda.current_stream()
    first = capture_nodes(stream)
    yield
    rec.append((name, first, capture_nodes(stream)))


@contextlib.contextmanager
def capturing(runner: Optional[str]):
    """The block captures a graph of ``runner``'s tick on the current
    stream: when on, its phases are recorded and the table registered
    under ``runner`` (the last capture of a name wins).  No-op when off or
    for a runner with no name."""
    if not _ON or runner is None:
        yield
        return
    rec: List[Tuple[str, int, int]] = []
    _CAPTURE.phases = rec
    try:
        yield
        total = capture_nodes(torch.cuda.current_stream())
        _TABLES[runner] = PhaseTable(tuple(rec), total)
    finally:
        _CAPTURE.phases = None


def capture_nodes(stream: "torch.cuda.Stream") -> int:
    """Kernel, memcpy and memset nodes of the graph ``stream`` is
    capturing into, 0 when it is not capturing (``csrc/capture_nodes.cu``)."""
    n = ctypes.c_ulonglong(0)
    err = _cuda.load("capture_nodes").capture_nodes(
        ctypes.c_void_p(stream.cuda_stream), ctypes.byref(n))
    if err != 0:
        raise RuntimeError(f"capture_nodes failed: CUDA error {err}")
    return n.value


def counters(kernel: str, device: torch.device) -> Optional[torch.Tensor]:
    """The int64 device totals a launch of ``kernel`` (or the step named
    so in :data:`COUNTERS`) on ``device`` adds its counts to
    (:data:`COUNTERS` ``[kernel]``, in order); None when off or off a
    CUDA device (the launch then counts nothing)."""
    if not _ON or device.type != "cuda":
        return None
    if device.index is None:
        device = torch.device("cuda", torch.cuda.current_device())
    at = _OFFSET[kernel]
    return _totals(device)[at:at + len(COUNTERS[kernel])]


def _totals(device: torch.device) -> torch.Tensor:
    """The int64 totals of every counter on ``device`` (made if missing)."""
    tot = _TOTALS.get(device)
    if tot is None:
        if torch.cuda.is_current_stream_capturing():
            # a capture would take the fill into its graph and its pool
            raise RuntimeError(f"no counters on {device} yet: a capture "
                               "cannot make them; switch tracing on before "
                               "the runners capture")
        tot = _TOTALS[device] = torch.zeros(_N_COUNTERS, dtype=torch.int64,
                                            device=device)
    return tot


def snapshot() -> dict:
    """``{"phases": {runner: PhaseTable}, "counters": {"<kernel>.<name>":
    int}}``: the phase tables registered so far and the counters' totals
    summed over devices (one host read a device)."""
    totals: Dict[str, int] = {}
    for tot in _TOTALS.values():
        vals = tot.tolist()
        for kernel, names in COUNTERS.items():
            for i, name in enumerate(names):
                key = f"{kernel}.{name}"
                totals[key] = totals.get(key, 0) + vals[_OFFSET[kernel] + i]
    return {"phases": dict(_TABLES), "counters": totals}


@contextlib.contextmanager
def trace(log_dir: Optional[str]):
    """Trace the enclosed block (CPU ops, and CUDA kernels when a card is
    present) into ``log_dir/trace_<pid>_<ns>.json``, a Chrome trace that
    Perfetto opens; no-op when ``log_dir`` is None (the every-N-steps
    gating knob).  The program's spans show in it when tracing is on."""
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
