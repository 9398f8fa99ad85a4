"""(query, row) pairs ``sorted_moments`` walked per pair it matched over
the traced lane ticks (the kernel's own counters, read with tracing
on)."""

from dcarl_bench import program_trace as P


def read(m):
    return P.walked_per_match(m, "sorted_moments")
