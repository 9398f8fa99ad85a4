"""``peraction_moments``' share of its roofline: the least time of the
per-action query (store rows and queries read once, moments written
once; four float64 operations a matched (query, action, row) triple, the
triples being the counts the port returned) over its traced time, %."""

from dcarl_bench.metrics._replays import query_roofline_pct


def read(m):
    return query_roofline_pct(m, "peraction")
