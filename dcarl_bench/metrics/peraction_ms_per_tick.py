"""Milliseconds of ``peraction_moments`` (its main and sum passes) a
replayed gated tick, from the trace."""

from dcarl_bench.metrics._replays import kernel_s


def read(m):
    s = kernel_s(m, "peraction")
    ticks = (m.get("counters") or {}).get("ticks")
    return None if not s or not ticks else 1e3 * s / ticks
