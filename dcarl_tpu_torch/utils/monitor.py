"""Module health monitoring — heartbeats, status, guarded execution.

The reference defines a monitor protocol (``ModuleStatus``,
``ModuleBeat``, ``DiagnosticInfo`` msgs — SW/monitor/protocol/msg/) that
nothing consumes, and handles failures ad hoc: bare
try/except-continue around decision updates (nodes/idm_lane_utility),
fallback to the rule action when the RL socket fails
(learning.py:88-89, VEG_planner.py:134-136), and ROS ``respawn``.

This module implements that capability surface properly for the
stack's host side:

- ``Monitor``        registry of modules with expected beat rates;
                     ``beat()`` + ``check()`` -> per-module ``ModuleStatus``
                     (OK / WARN on missed beats / STALE on silence /
                     ERROR on raised exceptions).
- ``Monitor.guard``  context manager replacing try/except-continue:
                     failures are counted, recorded with the traceback,
                     and optionally re-raised after a threshold instead
                     of being silently swallowed forever.
- ``with_fallback``  the socket->rule-action pattern as a combinator.
"""

from __future__ import annotations

import contextlib
import enum
import time
import traceback
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, Optional


class Status(enum.Enum):
    OK = 0
    WARN = 1        # beats arriving slower than declared rate
    STALE = 2       # no beat for >= stale_factor missed periods
    ERROR = 3       # module raised inside guard()


@dataclass
class ModuleStatus:
    """Per-module snapshot (ModuleStatus.msg / ModuleBeat.msg analog)."""
    name: str
    status: Status
    last_beat: float
    beat_count: int
    failure_count: int
    last_error: Optional[str] = None


@dataclass
class _Module:
    rate_hz: float
    last_beat: float = 0.0
    beat_count: int = 0
    failure_count: int = 0
    consecutive_failures: int = 0
    last_error: Optional[str] = None


class Monitor:
    def __init__(self, clock: Callable[[], float] = time.monotonic,
                 warn_factor: float = 1.5, stale_factor: float = 4.0):
        self._clock = clock
        self._warn = warn_factor
        self._stale = stale_factor
        self._modules: Dict[str, _Module] = {}

    def register(self, name: str, rate_hz: float = 1.0) -> None:
        """Declare a module and its expected beat rate (the reference's
        20 Hz cognition / 5 Hz planning declarations)."""
        self._modules[name] = _Module(rate_hz=rate_hz,
                                      last_beat=self._clock())

    def beat(self, name: str) -> None:
        m = self._modules[name]
        m.last_beat = self._clock()
        m.beat_count += 1
        m.consecutive_failures = 0

    def record_failure(self, name: str, err: BaseException) -> None:
        m = self._modules[name]
        m.failure_count += 1
        m.consecutive_failures += 1
        m.last_error = "".join(traceback.format_exception_only(err)).strip()

    @contextlib.contextmanager
    def guard(self, name: str, reraise_after: int = 0):
        """Run one module tick: success beats, failure is recorded and
        suppressed — unless ``reraise_after`` consecutive failures have
        accumulated, at which point the error propagates (so a
        permanently broken module cannot fail silently forever the way
        the reference's bare ``except: pass`` loops can)."""
        try:
            yield
        except BaseException as e:  # noqa: BLE001 — this IS the handler
            self.record_failure(name, e)
            m = self._modules[name]
            if reraise_after and m.consecutive_failures >= reraise_after:
                raise
        else:
            self.beat(name)

    def check(self, name: Optional[str] = None) -> Dict[str, ModuleStatus]:
        now = self._clock()
        names = [name] if name else list(self._modules)
        out = {}
        for n in names:
            m = self._modules[n]
            period = 1.0 / m.rate_hz
            silent = now - m.last_beat
            if m.consecutive_failures > 0:
                s = Status.ERROR
            elif silent >= self._stale * period:
                s = Status.STALE
            elif silent >= self._warn * period:
                s = Status.WARN
            else:
                s = Status.OK
            out[n] = ModuleStatus(n, s, m.last_beat, m.beat_count,
                                  m.failure_count, m.last_error)
        return out

    def healthy(self) -> bool:
        return all(st.status == Status.OK for st in self.check().values())


def with_fallback(fn: Callable[..., Any], fallback: Callable[..., Any],
                  monitor: Optional[Monitor] = None,
                  name: str = "fallback") -> Callable[..., Any]:
    """Combinator for the reference's degrade-to-rule pattern
    (learning.py:88-89): call ``fn``; on any exception call
    ``fallback`` with the same arguments, recording the failure."""
    if monitor is not None and name not in monitor._modules:
        monitor.register(name, rate_hz=1.0)

    def wrapped(*args, **kwargs):
        try:
            out = fn(*args, **kwargs)
        except BaseException as e:  # noqa: BLE001
            if monitor is not None:
                monitor.record_failure(name, e)
            return fallback(*args, **kwargs)
        if monitor is not None:
            monitor.beat(name)
        return out

    return wrapped
