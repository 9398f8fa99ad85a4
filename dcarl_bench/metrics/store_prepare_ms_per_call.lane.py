"""Device milliseconds of the work a lane ``run_fn`` call launches under
the host span ``dcarl.store_prepare`` (the flat store's band sort and
row records, made once a call), over the traced calls."""

from dcarl_bench import program_trace as P


def read(m):
    return P.span_ms_per_call(m, "dcarl.store_prepare")
