"""Milliseconds of a replayed lane tick's ``query`` phase (the candidate
keys' band sort, the plan, both passes of ``sorted_moments`` and the
un-sort), mean over the traced replays, from the device trace split by
the capture's phase table (``program_trace``)."""

from dcarl_bench import program_trace as P


def read(m):
    return P.phase_ms(m, "lane", "query")
