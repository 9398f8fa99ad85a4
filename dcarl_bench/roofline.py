"""The least time the card could take for a store query, from its inputs
and its answer alone (never from a kernel's plan).

Bytes: every store row (its key and value) and every query read once,
the moments written once, at the card's memory bandwidth.  Operations:
each matched (query, row) pair, or (query, action, row) triple, needs
its count and its two sums: one add to the count, one to the sum, one
multiply and one add to the sum of squares, at the published rate of
the precision they are summed in.  The bound is the larger of the two.
"""

from __future__ import annotations

import json
import os
from typing import Dict

_PEAKS = os.path.join(os.path.dirname(os.path.abspath(__file__)),
                      "peaks.json")
OPS_PER_MATCH = 4


def peaks(card: str = "H100_SXM") -> Dict[str, float]:
    with open(_PEAKS) as f:
        return json.load(f)[card]


def query_bound(rows: int, key_dim: int, queries: int, query_dim: int,
                answers: int, matches: float, sum_precision: str,
                peak: Dict[str, float]) -> Dict[str, float]:
    """The least seconds of one query launch: ``rows`` stored rows of
    ``key_dim`` floats and a value, ``queries`` queries of ``query_dim``
    floats, ``answers`` (count, sum, sum of squares) written as float32,
    ``matches`` matched pairs or triples summed in ``sum_precision``.
    Returns the bytes' time, the operations' time and the bound."""
    nbytes = 4 * (rows * (key_dim + 1) + queries * query_dim + answers * 3)
    bytes_s = nbytes / peak["hbm_bytes_per_s"]
    ops_s = OPS_PER_MATCH * matches / peak[f"{sum_precision}_flops_per_s"]
    return dict(bytes_s=bytes_s, ops_s=ops_s, bound_s=max(bytes_s, ops_s),
                binds="bytes" if bytes_s >= ops_s else "operations")


def share_pct(bound_s: float, kernel_s: float) -> float:
    """The bound as a share of the kernel's measured time, in %."""
    return 100.0 * bound_s / kernel_s
