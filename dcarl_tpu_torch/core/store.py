"""Confidence store: the R-tree replacement's dataset and its queries.

The store is a fixed-capacity structure of arrays (keys, actions,
values, size, head) with masked ring inserts (RLS.py:185-215 under a
finite budget).  A box query asks, for each query point, how many stored
boxes ``[key - w, key + w]`` contain it and the (sum, sum of squares) of
their values (deepq/RLS.py:161-181).  ``_raw_moments`` answers it by
brute force and is the oracle every faster path is held against; the
kernel routes live in ``ops/store_kernels.py``.

Every function here is functional (new tensors out, inputs untouched)
and runs on the device of its inputs with no host synchronisation: the
insert scatters through one spare "dump" row instead of a data-dependent
selection.

Semantics: containment is ``all(|key_d - q_d| <= w_d)``, variance is the
population variance, and an empty match reports mean/var/sigma = -1
(RLS.py:168-169).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import numpy as np
import torch

from dcarl_tpu_torch.device import resolve_device

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

# Half-widths of the 13-D lane_models variant (12-D obs + action),
# lane_models/src/deepq/RLS.py:53.
LANE_HALF_WIDTHS = (
    2.0, 5.0, 10.0, 1.0, 6.0, 10.0, 1.0, 6.0, 10.0, 6.0, 10.0, 6.0,
    0.1,
)

# Key of rows that must match no query (far outside any real state).
SENTINEL_KEY = 1.0e9


class ConfidenceStore(NamedTuple):
    """Fixed-capacity {key, action, value} dataset (SoA layout)."""

    keys: torch.Tensor     # [N, D] state||action keys
    actions: torch.Tensor  # [N] recorded action
    values: torch.Tensor   # [N] recorded return
    size: torch.Tensor     # [] i32 valid rows (== min(total, N))
    head: torch.Tensor     # [] i32 next write slot (ring overwrite when full)


def store_init(capacity: int, key_dim: int, dtype=torch.float32,
               device=None) -> ConfidenceStore:
    """An empty ring of ``capacity`` rows on ``device`` (``cuda`` unless
    the caller passes ``device="cpu"``)."""
    device = resolve_device(device)

    def z(*shape):
        return torch.zeros(shape, dtype=dtype, device=device)

    zi = torch.zeros((), dtype=torch.int32, device=device)
    return ConfidenceStore(keys=z(capacity, key_dim), actions=z(capacity),
                           values=z(capacity), size=zi, head=zi.clone())


def _exclusive_cumsum(m: torch.Tensor) -> torch.Tensor:
    """Position of each row among the rows before it (i64)."""
    return torch.cumsum(m, 0) - m


def _scatter_rows(buf: torch.Tensor, slots: torch.Tensor,
                  rows: torch.Tensor) -> torch.Tensor:
    """``buf`` with ``rows[i]`` written at ``slots[i]``; a slot equal to
    ``len(buf)`` drops its row (it lands in a spare dump row that is cut
    off).  The real slots must be distinct."""
    ext = torch.cat([buf, buf[:1]])
    ext.index_copy_(0, slots, rows.to(buf.dtype))
    return ext[:-1]


def store_insert(store: ConfidenceStore, keys: torch.Tensor,
                 actions: torch.Tensor, values: torch.Tensor,
                 mask: torch.Tensor, policy: str = "ring") -> ConfidenceStore:
    """Masked batched append (``core/store.py::store_insert``).

    ``policy="ring"`` overwrites the oldest rows once full;
    ``"reject"`` drops new rows once full.  A batch larger than the
    capacity keeps only its newest ``capacity`` valid rows, so no two
    rows share a slot."""
    if policy not in ("ring", "reject"):
        raise ValueError(f"unknown store policy {policy!r}")
    capacity = store.keys.shape[0]
    if policy == "reject":
        offs0 = _exclusive_cumsum(mask.to(torch.int64))
        mask = mask & (store.size + offs0 < capacity)
    m = mask.to(torch.int64)
    offsets = _exclusive_cumsum(m)
    if keys.shape[0] > capacity:
        # one batch can lap the ring: keep the newest `capacity` rows
        mask = mask & (offsets >= m.sum() - capacity)
        m = mask.to(torch.int64)
        offsets = _exclusive_cumsum(m)
    slots = (store.head + offsets) % capacity
    safe = torch.where(mask, slots, capacity)
    n_added = m.sum()
    return ConfidenceStore(
        keys=_scatter_rows(store.keys, safe, keys),
        actions=_scatter_rows(store.actions, safe, actions),
        values=_scatter_rows(store.values, safe, values),
        size=torch.clamp(store.size + n_added, max=capacity).to(torch.int32),
        head=((store.head + n_added) % capacity).to(torch.int32))


def store_insert_dense_block(store: ConfidenceStore, keys: torch.Tensor,
                             actions: torch.Tensor, values: torch.Tensor,
                             mask: torch.Tensor) -> ConfidenceStore:
    """Contiguous block append at ``head``
    (``core/store.py::store_insert_dense_block``): invalid rows are
    stamped with :data:`SENTINEL_KEY` keys, occupy capacity and match no
    query.  Needs ``capacity % M == 0`` (every block write keeps ``head``
    aligned, so a block never wraps mid-write)."""
    capacity = store.keys.shape[0]
    m = keys.shape[0]
    if capacity % m != 0:
        raise ValueError(f"capacity {capacity} must be a multiple of the "
                         f"block size {m} for dense block writes")
    dt = store.keys.dtype
    keys_w = torch.where(mask[:, None], keys.to(dt), SENTINEL_KEY)
    actions_w = torch.where(mask, actions.to(store.actions.dtype), 0.0)
    values_w = torch.where(mask, values.to(store.values.dtype), 0.0)
    # block rows head .. head+m-1, as slot indices on the device
    slots = store.head.to(torch.int64) + torch.arange(m, device=keys.device)
    return ConfidenceStore(
        keys=store.keys.index_copy(0, slots, keys_w),
        actions=store.actions.index_copy(0, slots, actions_w),
        values=store.values.index_copy(0, slots, values_w),
        size=torch.clamp(store.size + m, max=capacity).to(torch.int32),
        head=((store.head + m) % capacity).to(torch.int32))


class QueryStats(NamedTuple):
    count: torch.Tensor  # [Q] i32 visited times
    mean: torch.Tensor   # [Q] (-1 where count == 0)
    var: torch.Tensor    # [Q] (-1 where count == 0)
    sigma: torch.Tensor  # [Q] (-1 where count == 0)


def _raw_moments(keys: torch.Tensor, values: torch.Tensor,
                 valid: torch.Tensor, queries: torch.Tensor,
                 half_widths: torch.Tensor,
                 num_actions: Optional[int] = None) -> torch.Tensor:
    """[Q, 3] f32 moments (count, sum, sumsq) of the values whose keys
    contain each query.

    The containment mask is built one dimension at a time (the same
    elementwise tests as a [Q, N, D] broadcast, without its memory), and
    the reduction is one ``mask @ [1, v, v^2]`` product in the inputs'
    dtype, rounded to f32 at the end as the JAX oracle does.  With TF32
    off (``dcarl_tpu_torch.disable_tf32``) the product runs in full
    precision on the card.

    With ``num_actions``, ``queries`` are [B, D-1] observations and the
    result is [B * A, 3], the moments of the candidate keys ``obs || a``
    for a = 0..A-1 (``rls.candidate_keys`` order): the obs dims are
    tested once per observation, which every candidate shares."""
    d_obs = keys.shape[1] if num_actions is None else keys.shape[1] - 1
    mask = valid[None, :].expand(queries.shape[0], -1).clone()
    for d in range(d_obs):
        mask &= torch.abs(keys[None, :, d] - queries[:, None, d]) \
            <= half_widths[d]
    if num_actions is not None:
        cand = torch.arange(num_actions, dtype=queries.dtype,
                            device=queries.device)
        act = torch.abs(keys[None, :, -1] - cand[:, None]) <= half_widths[-1]
        mask = (mask[:, None, :] & act[None]).reshape(-1, keys.shape[0])
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


def store_valid(store: ConfidenceStore) -> torch.Tensor:
    """[N] bool: rows below ``size`` (the rows a query may match)."""
    n = store.keys.shape[0]
    return torch.arange(n, device=store.keys.device) < store.size


def active_region_mask(keys, half_widths, region_dims, center, radius):
    """[N] bool numpy mask of the rows that can affect ANY query inside
    the operating region ``|q[dim] - center| <= radius`` (per region dim):
    the vehicle-life working set's host-side selection
    (``workingset.py``).  A row matches a query only if ``|key_d - q_d|
    <= w_d``, so a row with ``|key_d - center_d| > radius_d + w_d`` on
    some region dim matches no in-region query, and dropping it is
    exact.  ``keys`` [N, D] and ``half_widths`` [D] are host arrays."""
    keys = np.asarray(keys)
    half_widths = np.asarray(half_widths)
    mask = np.ones(keys.shape[0], bool)
    for i, dim in enumerate(region_dims):
        reach = float(radius[i]) + float(half_widths[dim])
        mask &= np.abs(keys[:, dim] - float(center[i])) <= reach
    return mask


def box_query_stats(store: ConfidenceStore, queries: torch.Tensor,
                    half_widths: torch.Tensor,
                    use_kernel: Optional[bool] = None) -> QueryStats:
    """Visited times and value statistics of a batch of query points
    (RLS.py:161-181).  ``use_kernel`` (None = on CUDA) answers through
    the flat sorted-band query (``store_kernels.box_query_moments_sorted``,
    the CUDA kernel on the card, its plain version on the CPU); False
    through the brute ``_raw_moments``."""
    valid = store_valid(store)
    if use_kernel is None:
        use_kernel = queries.device.type == "cuda"
    if use_kernel:
        from dcarl_tpu_torch.ops.store_kernels import box_query_moments_sorted

        moments = box_query_moments_sorted(store.keys, store.values, valid,
                                           queries, half_widths)
    else:
        moments = _raw_moments(store.keys, store.values, valid, queries,
                               half_widths)
    return moments_to_stats(moments)
