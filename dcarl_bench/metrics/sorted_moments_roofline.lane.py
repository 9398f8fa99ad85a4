"""``sorted_moments``' share of its roofline on the lane gate's flat
query (the 2^17 store rows and the B x 8 candidate keys read once,
moments written once; four float64 operations a matched (query, row)
pair, the pairs being the counts the port returned) over its traced
time, in %."""

from dcarl_bench.metrics._replays import query_roofline_pct


def read(m):
    return query_roofline_pct(m, "sorted_moments")
