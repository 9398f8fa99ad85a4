"""Confidence store queries: the R-tree replacement's moment oracle.

A box query asks, for each query point, how many stored boxes
``[key - w, key + w]`` contain it and the (sum, sum of squares) of their
values (deepq/RLS.py:161-181).  ``_raw_moments`` answers it by brute
force and is the oracle every faster path is held against; the gated
driver's kernel route lives in ``ops/store_kernels.py``.

Semantics: containment is ``all(|key_d - q_d| <= w_d)``, variance is the
population variance, and an empty match reports mean/var/sigma = -1
(RLS.py:168-169).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

# Half-widths of the 21-D (20-D obs + action) query box, from
# deepq/RLS.py:68.  Action half-width 0.1 => action matches exactly.
FIELD_HALF_WIDTHS = (
    1.0, 0.3, 2.0, 50.0,
    10.0, 0.3, 2.0, 50.0,
    10.0, 0.3, 2.0, 50.0,
    10.0, 0.3, 2.0, 50.0,
    10.0, 0.3, 2.0, 50.0,
    0.1,
)

# Key of rows that must match no query (far outside any real state).
SENTINEL_KEY = 1.0e9


class QueryStats(NamedTuple):
    count: torch.Tensor  # [Q] i32 visited times
    mean: torch.Tensor   # [Q] (-1 where count == 0)
    var: torch.Tensor    # [Q] (-1 where count == 0)
    sigma: torch.Tensor  # [Q] (-1 where count == 0)


def _raw_moments(keys: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor, queries: torch.Tensor,
                 half_widths: torch.Tensor) -> torch.Tensor:
    """[Q, 3] f32 moments (count, sum, sumsq) of the values whose keys
    contain each query.

    The containment mask is built one dimension at a time (the same
    elementwise tests as a [Q, N, D] broadcast, without its memory), and
    the reduction is one ``mask @ [1, v, v^2]`` product in the inputs'
    dtype, rounded to f32 at the end as the JAX oracle does.  With TF32
    off (``dcarl_tpu_torch.disable_tf32``) the product runs in full
    precision on the card."""
    mask = valid[None, :].expand(queries.shape[0], -1).clone()
    for d in range(keys.shape[1]):
        mask &= torch.abs(keys[None, :, d] - queries[:, None, d]) \
            <= half_widths[d]
    feats = torch.stack([torch.ones_like(values), values, values * values],
                        dim=1)                               # [N, 3]
    return (mask.to(values.dtype) @ feats).to(torch.float32)


def moments_to_stats(moments: torch.Tensor) -> QueryStats:
    """(count, sum, sumsq) -> (count, mean, var, sigma) with the
    empty-match sentinel of -1."""
    count = moments[:, 0]
    nf = torch.clamp(count, min=1.0)
    mean = moments[:, 1] / nf
    var = torch.clamp(moments[:, 2] / nf - mean * mean, min=0.0)
    empty = count == 0
    return QueryStats(
        count=count.to(torch.int32),
        mean=torch.where(empty, -1.0, mean),
        var=torch.where(empty, -1.0, var),
        sigma=torch.where(empty, -1.0, torch.sqrt(var)),
    )
