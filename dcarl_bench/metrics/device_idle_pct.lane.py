"""Share of the traced stretch of lane ticks in which no kernel, copy or
fill ran on the device (intervals merged), in %."""

from dcarl_bench.metrics._replays import idle_pct


def read(m):
    return idle_pct(m)
