"""Store queries: the counterparts of ``dcarl_tpu/ops/pallas_store.py``.

Three kernels answer box queries against the confidence store, each a
CUDA kernel for Hopper with a plain PyTorch version beside it (the
wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises):

* ``peraction_moments`` (gated driver, below);
* ``sorted_moments``, ``[Q, 3]`` moments against band-sorted rows with
  a sub-slice band prune.  One route, :func:`_prepare_band` then
  :func:`query_sorted_prepared`, bands on a composite (primary dim,
  second dim) key where the primary dim is discrete (half-width < 0.5,
  integer keys in every valid row: a candidate action), else on the
  primary dim alone.  Its callers: the flat route, on dims it picks
  from the data, as :func:`prepare_sorted_store` for a store that many
  batches ask (the lane gate's), whose composite key also holds a
  bucketed middle level on a third dim where the rows span two buckets
  or more (each query asked as two copies, one a bucket its box
  reaches), and as :func:`box_query_moments_sorted`
  (``core/store.py::box_query_stats``) for a store prepared for one
  batch, without the level; and the action-grouped
  :func:`box_query_moments_grouped` (the trainer's rule-column query),
  on the fixed dims (action, ``band_dim``), without the level;
* ``box_moments``, the unpruned brute-force ``[Q, 3]`` baseline
  (:func:`box_query_moments_brute`).

The per-action query: the gated driver needs (count, sum v, sum v^2) for every candidate
action of every env.  With an integer action lattice and an action
half-width < 0.5 each stored row matches exactly one action, so one
20-D containment test per (env, row) plus a scatter of the row's
moments into its action's slots answers all A actions at once.

* :func:`prepare_peraction_store` (torch, on the device of its inputs)
  sorts the store by (band cell, second dim, row hash), collapses
  bitwise-identical rows into weighted moments, and builds the kernel's
  row records, the sub-slice extrema it prunes with and the per-piece
  boxes and sums it settles whole pieces with.  A deployment loop whose
  store is fixed runs it once per run.
* :func:`query_peraction_prepared` answers B queries against a prepared
  store: for CUDA tensors it launches ``csrc/peraction_moments.cu``
  (or raises); for CPU tensors it takes the plain version,
  :func:`peraction_moments_plain`, a brute containment followed by an
  f64 feature product rounded to f32 once, as the kernel sums.

Every kernel launch first builds a :class:`Plan` on the device, with no
host synchronisation (:func:`peraction_plan`, :func:`sorted_plan`,
:func:`brute_plan`): each 128-query tile's window of 256-row sub-slices,
cut into chunks that a persistent grid walks; a second pass in the same
launch adds each query's chunk partials in chunk order.  With tracing on
(``utils/profiling``) a launch also adds its counts (pairs walked, rows
matched, and for the per-action kernel rows held whole and the walk's
(warp, row) iterations) to the device totals ``profiling.counters``
gives.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from dcarl_tpu_torch.core.store import _raw_moments
from dcarl_tpu_torch.ops import _cuda
from dcarl_tpu_torch.utils import profiling

# Finite padding key: far outside any real key range (same value as the
# JAX package's pallas_store._PAD and core/store.py SENTINEL_KEY).
_PAD = 1.0e9
_QT = 128     # queries per tile (csrc/chunk_ring.cuh QT)
_SUB_N = 256  # rows per sub-slice (csrc/chunk_ring.cuh SUB_N)
_MAX_ACTIONS = 16
_PA_REC = 24  # floats in a per-action row record: 20 keys, action, 3 moments
_PA_MAX_CHUNK = 64  # sub-slices a per-action chunk may hold (one per thread)
_PA_PIECE_N = 128   # rows per summarised piece (csrc/peraction_moments.cu)
# Bound on a launch's partial-sum scratch: the chunk size C doubles until
# the most chunks the shapes allow fit (about 280 MB at 65,536 queries x
# 2^18 rows with 11 actions for sorted_moments).
_SCRATCH_BYTES = 320 << 20
# The per-action kernel's partials are three f64 sums a (query, action),
# twice the f32 design's bytes, so its bound is twice as large and leaves
# the chunk size where it was (C = 32 and about 550 MB at 65,536 queries
# x 2^18 rows).
_PA_SCRATCH_BYTES = 2 * _SCRATCH_BYTES
_PA_PART_BYTES = 3 * 8  # partial bytes a (query, action)


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class Plan(NamedTuple):
    """How a launch splits its work: query tile t examines the row
    sub-slices ``[s_lo[t], s_hi[t])``, cut into chunks of ``chunk``; the
    tile owns chunks ``[off[t], off[t + 1])``.  ``max_chunks`` bounds
    ``off[-1]`` from the shapes alone (it sizes the scratch)."""

    s_lo: torch.Tensor  # [n_qt] i32
    s_hi: torch.Tensor  # [n_qt] i32, >= s_lo
    off: torch.Tensor   # [n_qt + 1] i32 chunk offsets
    chunk: int
    max_chunks: int


def _chunk_size(n_qt: int, n_sub: int, chunk_bytes: int, c_min: int,
                c_max: int, scratch_bytes: int = _SCRATCH_BYTES) -> int:
    c = c_min
    while c < c_max and n_qt * -(-n_sub // c) * chunk_bytes > scratch_bytes:
        c *= 2
    return c


def _chunk_plan(s_lo: torch.Tensor, s_hi: torch.Tensor, n_sub: int,
                chunk: int) -> Plan:
    """Cut the windows into chunks, on the device of the windows (no
    host synchronisation).  A tile's window is at most ``n_sub`` long, so
    it takes at most ``ceil(n_sub / chunk)`` chunks."""
    s_lo = s_lo.to(torch.int32)
    length = torch.clamp(s_hi.to(torch.int32) - s_lo, min=0)
    n_chunks = torch.div(length + (chunk - 1), chunk, rounding_mode="floor")
    off = torch.cat([torch.zeros(1, dtype=torch.int32, device=s_lo.device),
                     torch.cumsum(n_chunks, 0, dtype=torch.int32)])
    return Plan(s_lo=s_lo, s_hi=s_lo + length, off=off, chunk=chunk,
                max_chunks=s_lo.shape[0] * -(-n_sub // chunk))


def _selectivity(keys: torch.Tensor, valid: torch.Tensor, w: torch.Tensor
                 ) -> torch.Tensor:
    """[D] f32 how selective each key dim is: the spread of the valid
    rows (mean |x - mean|) over the half-width, >= 0."""
    vf = valid.to(torch.float32)
    cnt = torch.clamp(vf.sum(), min=1.0)
    mean = (vf @ keys) / cnt
    sel = (vf @ torch.abs(keys - mean)) / cnt / torch.clamp(w, min=1e-9)
    return torch.nan_to_num(sel, nan=0.0, posinf=3e38)


def _dim_order(keys: torch.Tensor, valid: torch.Tensor, w: torch.Tensor,
               last: tuple) -> torch.Tensor:
    """[D] i32 key dims, most selective first (:func:`_selectivity`), the
    dims in ``last`` (ints or device scalars) at the end: the rows a tile
    examines are already near its queries along those, so they reject
    least there.  The per-dim tests are AND-ed, so any order gives the
    same result."""
    sel = _selectivity(keys, valid, w)
    for i, dim in enumerate(last):
        if isinstance(dim, int):
            # a fill: ``sel[dim] = x`` would copy a host scalar to the
            # device, which waits for it and cannot be graph-captured
            sel[dim:dim + 1].fill_(-1.0 - i)
        else:
            sel = sel.index_fill(0, dim.reshape(1).to(torch.int64), -1.0 - i)
    return torch.argsort(sel, descending=True, stable=True).to(torch.int32)


def _index_dim(x: torch.Tensor, dim: torch.Tensor) -> torch.Tensor:
    """``x[:, dim]`` for a device-resident index (no host round trip)."""
    return x.index_select(1, dim.reshape(1))[:, 0]


class PreparedPerActionStore(NamedTuple):
    """Store-side operands of the per-action query.  Rows are sorted and
    deduplicated; columns past the unique rows (and up to ``n_pad``) are
    padding that matches nothing."""

    keys_t: torch.Tensor    # [OBS, n_pad] f32 obs keys, padding = _PAD
    row_act: torch.Tensor   # [n_pad] i32 action of the row; -1 adds nothing
    row_mom: torch.Tensor   # [3, n_pad] f32 (count, sum v, sum v^2) of
    #                         the row's run of identical keys, summed in
    #                         f64 and rounded once
    rows: torch.Tensor      # [n_pad, 24] f32 the kernel's row records:
    #                         keys_t[perm], row_act's int bits, row_mom
    perm: torch.Tensor      # [OBS] i32 obs dim of record slot d
    piece_box: torch.Tensor  # [n_pad/128, 2 OBS] f32 per 128-row piece:
    #                          min, then max, of its live rows' keys
    #                          (record order); +inf / -inf with none live
    piece_mom: torch.Tensor  # [n_pad/128, 3A] f64 per piece: the feature
    #                          block summed over its rows in f64, unrounded
    kb: torch.Tensor        # [2, n_pad/sub_n] band extrema per sub-slice
    kb2: torch.Tensor       # [2, n_pad/sub_n] second-dim extrema
    kbt: torch.Tensor       # [2, n_pad/n_tile] band extrema per tile
    w_col: torch.Tensor     # [OBS] f32 box half-widths
    w0: torch.Tensor        # [1] band half-width
    w2: torch.Tensor        # [1] second-dim half-width
    sdim2: torch.Tensor     # [] i64 second prune dim (data-chosen)
    cell_w: torch.Tensor    # [] band cell width of the sort
    band_dim: int
    num_actions: int
    n_tile: int
    sub_n: int


def _extrema(vals: torch.Tensor, width: int) -> torch.Tensor:
    r = vals.reshape(-1, width)
    return torch.stack([r.amin(dim=1), r.amax(dim=1)])


def _lexsort(keys_minor_to_major) -> torch.Tensor:
    """``jnp.lexsort`` order: stable sorts from the least significant key
    up (``torch.argsort`` is stable only when asked)."""
    order = None
    for k in keys_minor_to_major:
        if order is None:
            order = torch.argsort(k, stable=True)
        else:
            order = order[torch.argsort(k[order], stable=True)]
    return order


def _row_hashes(keys: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """The JAX package's two uint32 row hashes, in int64 masked to 32
    bits after every multiply-add (the int64 product may wrap; its low
    32 bits survive)."""
    m32 = 0xFFFFFFFF
    bits = keys.contiguous().view(torch.int32).to(torch.int64) & m32
    h1 = torch.zeros(keys.shape[0], dtype=torch.int64, device=keys.device)
    h2 = torch.zeros_like(h1)
    for d in range(keys.shape[1]):
        h1 = (h1 * 0x9E3779B1 + bits[:, d]) & m32
        h2 = (h2 * 0x85EBCA77 + (bits[:, d] ^ d)) & m32
    return h1, h2


def prepare_peraction_store(
    keys: torch.Tensor,         # [N, D] (last column = integer action)
    values: torch.Tensor,       # [N]
    valid: torch.Tensor,        # [N] bool
    half_widths: torch.Tensor,  # [D] (action half-width last, < 0.5)
    num_actions: int = 11,
    n_tile: int = 2048,
    band_dim: int = 1,
) -> PreparedPerActionStore:
    """Sort, dedup, feature block and prune extrema of a store
    (``pallas_store.py:679``), as torch ops on the inputs' device."""
    if keys.ndim != 2 or values.shape != keys.shape[:1] \
            or valid.shape != keys.shape[:1]:
        raise ValueError(f"keys [N, D], values [N], valid [N] expected; got "
                         f"{tuple(keys.shape)}, {tuple(values.shape)}, "
                         f"{tuple(valid.shape)}")
    if valid.dtype != torch.bool:
        raise TypeError(f"valid must be bool, got {valid.dtype}")
    n, d = keys.shape
    obs_dim = d - 1
    dev = keys.device
    keys = keys.to(torch.float32)
    values = values.to(dev, torch.float32)
    valid = valid.to(dev)
    w = half_widths.to(dev, torch.float32)

    # Second prune dim: the most selective obs dim other than the band
    # dim, measured from the data.
    sel0 = _selectivity(keys, valid, w)[:obs_dim]
    sel0[band_dim:band_dim + 1].fill_(-1.0)
    sdim2 = torch.argmax(sel0)
    w2 = w.index_select(0, sdim2.reshape(1))

    # Lexicographic sort: band cell of width 2*w0, second dim, then the
    # 64-bit row hash (brings bitwise-identical rows together for the
    # dedup).  Invalid rows sort last (cell = +inf).  Sub-slice bounds
    # below are true extrema, so any order is correct; this one keeps
    # both ranges of a sub-slice tight.
    cell_w = 2.0 * torch.clamp(w[band_dim], min=1e-9)
    cells_k = torch.where(valid, torch.floor(keys[:, band_dim] / cell_w),
                          torch.inf)
    d2k = _index_dim(keys, sdim2)
    h1, h2 = _row_hashes(keys)
    zero = torch.zeros_like(h1)
    order = _lexsort((torch.where(valid, h2, zero),
                      torch.where(valid, h1, zero),
                      torch.where(valid, d2k, _PAD), cells_k))
    keys_s = keys[order]
    vals_s = values[order]
    valid_s = valid[order]

    # Dedup: moments are additive, so a run of identical valid rows
    # collapses into one row carrying (count, sum v, sum v^2).  The sums
    # are taken in f64 (index_add_ on the card adds in no fixed order;
    # the f32 values and their exact f64 squares sum without rounding in
    # f64 at these run lengths) and rounded to f32 once, so a row's
    # record is the same bits on every run and in every store that holds
    # its run.
    same = (keys_s[1:] == keys_s[:-1]).all(dim=1) & valid_s[1:] & valid_s[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1          # run ids
    ones = valid_s.to(torch.float64)
    v64 = vals_s.to(torch.float64) * ones

    def run_sums(x):
        return torch.zeros(n, dtype=torch.float64,
                           device=dev).index_add_(0, seg, x)

    cnt_r, sum_r, ssq_r = run_sums(ones), run_sums(v64), run_sums(v64 * v64)
    # compact: unique rows keep their order at the front, collapsed
    # duplicates fall to the back as invalid slots
    iota = torch.arange(n, device=dev)
    corder = torch.argsort(torch.where(first, iota, n + 1 + iota), stable=True)
    keys_s = keys_s[corder]
    valid_s = (valid_s & first)[corder]
    run_id = seg[corder]
    wmom = torch.stack([cnt_r[run_id], sum_r[run_id], ssq_r[run_id]])
    wmom = (wmom * valid_s[None, :]).to(torch.float32)        # [3, N]
    sk_s = torch.where(valid_s, keys_s[:, band_dim], _PAD)
    s2_s = torch.where(valid_s, _index_dim(keys_s, sdim2), _PAD)

    n_pad = _round_up(max(n, n_tile), n_tile)
    sub_n = min(_SUB_N, n_tile)

    # An off-lattice action (|a - round(a)| > half-width) matches no
    # candidate query, so it adds to no action: containment, not
    # nearest-lattice snapping.  torch.round rounds half to even, as
    # jnp.round does.
    act_f = keys_s[:, -1]
    act = torch.round(act_f).to(torch.int64)
    on_lattice = torch.abs(act_f - torch.round(act_f)) <= w[-1]
    live = valid_s & on_lattice & (act >= 0) & (act < num_actions)

    keys_t = torch.full((obs_dim, n_pad), _PAD, dtype=torch.float32,
                        device=dev)
    keys_t[:, :n] = keys_s[:, :obs_dim].T
    row_act = torch.full((n_pad,), -1, dtype=torch.int32, device=dev)
    row_act[:n] = torch.where(live, act, -1).to(torch.int32)
    row_mom = torch.zeros((3, n_pad), dtype=torch.float32, device=dev)
    row_mom[:, :n] = wmom

    ks_p = torch.full((n_pad,), _PAD, dtype=torch.float32, device=dev)
    ks_p[:n] = sk_s
    k2_p = torch.full((n_pad,), _PAD, dtype=torch.float32, device=dev)
    k2_p[:n] = s2_s
    # the band and second dims go last: the prune has already bounded them
    perm = _dim_order(keys[:, :obs_dim], valid, w[:obs_dim],
                      (sdim2, band_dim))
    keys_r = keys_t.index_select(0, perm.to(torch.int64)).T   # [n_pad, OBS]
    rows = torch.cat([keys_r, row_act.view(torch.float32)[:, None],
                      row_mom.T], 1)
    piece_box, piece_mom = _piece_summary(keys_r, row_act, row_mom,
                                          num_actions)
    return PreparedPerActionStore(
        keys_t=keys_t, row_act=row_act, row_mom=row_mom,
        rows=rows.contiguous(), perm=perm, piece_box=piece_box,
        piece_mom=piece_mom,
        kb=_extrema(ks_p, sub_n), kb2=_extrema(k2_p, sub_n),
        kbt=_extrema(ks_p, n_tile), w_col=w[:obs_dim].contiguous(),
        w0=w[band_dim].reshape(1), w2=w2.reshape(1), sdim2=sdim2,
        cell_w=cell_w, band_dim=band_dim, num_actions=num_actions,
        n_tile=n_tile, sub_n=sub_n)


def _feature_block(row_act: torch.Tensor, row_mom: torch.Tensor,
                   num_actions: int) -> torch.Tensor:
    a = torch.arange(num_actions, device=row_act.device)
    onehot = (row_act[None, :] == a[:, None]).to(torch.float32)   # [A, n]
    return (onehot[:, None, :] * row_mom[None]).reshape(3 * num_actions, -1)


def feature_block(prep: PreparedPerActionStore) -> torch.Tensor:
    """[3A, n_pad] f32 ``feats[a*3 + m, r] = 1[action_r == a] *
    moment_m(r)``: the JAX kernel's feature operand (its ``rows_cat``
    below the keys), the row moments scattered to their action's slots."""
    return _feature_block(prep.row_act, prep.row_mom, prep.num_actions)


def _piece_summary(keys_r, row_act, row_mom, num_actions):
    """Per 128-row piece: the bounding box of its live rows' keys
    ([n_pieces, 2 OBS], min then max) and its feature block summed over
    its rows in f64 ([n_pieces, 3A], not rounded: the kernel adds it to
    its f64 sums as it is).  A query whose box holds the whole bounding
    box matches every live row of the piece, so the kernel adds the sums
    and skips the rows."""
    n_pad, obs_dim = keys_r.shape
    n_pc = n_pad // _PA_PIECE_N
    k = keys_r.reshape(n_pc, _PA_PIECE_N, obs_dim)
    live = (row_act >= 0).reshape(n_pc, _PA_PIECE_N, 1)
    box = torch.cat([torch.where(live, k, torch.inf).amin(1),
                     torch.where(live, k, -torch.inf).amax(1)], 1)
    mom = _feature_block(row_act, row_mom, num_actions).to(
        torch.float64).reshape(3 * num_actions, n_pc, _PA_PIECE_N).sum(-1).T
    return box.contiguous(), mom.contiguous()


def query_operands(prep: PreparedPerActionStore, queries: torch.Tensor,
                   q_tile: int = _QT) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query side of the kernel: ``qorder`` [B] i64, the queries in
    (band cell, second dim) order, and ``qext`` [4, ceil(B / q_tile)]
    f32, each sorted tile's (band lo, band hi, second-dim lo, hi)."""
    qbv = queries[:, prep.band_dim]
    d2q = _index_dim(queries, prep.sdim2)
    qorder = _lexsort((d2q, torch.floor(qbv / prep.cell_w)))
    b = queries.shape[0]
    pad = _round_up(b, q_tile) - b
    # pad by repeating the last sorted query: the extrema stay exact
    qk = torch.cat([qbv[qorder], qbv[qorder[-1:]].expand(pad)])
    q2 = torch.cat([d2q[qorder], d2q[qorder[-1:]].expand(pad)])
    qb, qb2 = _extrema(qk, q_tile), _extrema(q2, q_tile)
    return qorder, torch.cat([qb, qb2]).contiguous()


def prune_keep(prep: PreparedPerActionStore, qext: torch.Tensor) -> torch.Tensor:
    """[n_qtiles, n_sub] bool: the (query tile, row sub-slice) pairs the
    kernel examines, by the same tests it runs (tile band early-out,
    then the sub-slice band and second-dim rectangle)."""
    q_lo, q_hi, q2_lo, q2_hi = (x[:, None] for x in qext)
    w0, w2 = prep.w0, prep.w2
    tile_ov = (prep.kbt[0] - w0 <= q_hi) & (prep.kbt[1] + w0 >= q_lo)
    sub_ov = ((prep.kb[0] - w0 <= q_hi) & (prep.kb[1] + w0 >= q_lo)
              & (prep.kb2[0] - w2 <= q2_hi) & (prep.kb2[1] + w2 >= q2_lo))
    per_tile = prep.n_tile // prep.sub_n
    return sub_ov & tile_ov.repeat_interleave(per_tile, dim=1)


def peraction_moments_plain(prep: PreparedPerActionStore,
                            queries: torch.Tensor,
                            out_dtype: torch.dtype = torch.float32
                            ) -> torch.Tensor:
    """Plain version of the kernel: [B, A, 3] moments by a brute
    containment over every prepared row, then ``mask @ feats^T`` in f64,
    rounded to ``out_dtype`` once, as the kernel sums."""
    mask = torch.ones((queries.shape[0], prep.keys_t.shape[1]),
                      dtype=torch.bool, device=queries.device)
    for d in range(prep.keys_t.shape[0]):
        mask &= torch.abs(queries[:, d:d + 1] - prep.keys_t[d][None, :]) \
            <= prep.w_col[d]
    out = mask.to(torch.float64) @ feature_block(prep).to(torch.float64).T
    return out.to(out_dtype).reshape(queries.shape[0], prep.num_actions, 3)


def _check_cuda_operands(prep: PreparedPerActionStore, queries: torch.Tensor):
    obs_dim = prep.w_col.shape[0]
    if queries.dtype != torch.float32:
        raise TypeError(f"queries must be float32, got {queries.dtype}")
    if queries.ndim != 2 or queries.shape[1] != obs_dim or obs_dim != 20:
        raise ValueError(f"queries [B, 20] expected (the kernel's key width),"
                         f" got {tuple(queries.shape)} against a "
                         f"{obs_dim}-D store")
    if not queries.is_contiguous():
        raise ValueError("queries must be contiguous")
    if prep.sub_n != _SUB_N or prep.n_tile % _SUB_N:
        raise ValueError(f"the kernel takes n_tile a multiple of {_SUB_N}; "
                         f"the store was prepared with n_tile={prep.n_tile}")
    if not 1 <= prep.num_actions <= _MAX_ACTIONS:
        raise ValueError(f"the kernel takes 1..{_MAX_ACTIONS} actions")
    for name in ("keys_t", "row_act", "row_mom", "rows", "perm", "piece_box",
                 "piece_mom", "kb", "kb2", "kbt", "w_col", "w0", "w2"):
        t = getattr(prep, name)
        if t.device != queries.device:
            raise ValueError(f"prepared {name} is on {t.device}, queries on "
                             f"{queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"prepared {name} must be contiguous")
    if prep.row_act.dtype != torch.int32 or prep.perm.dtype != torch.int32:
        raise TypeError("prepared row_act and perm must be int32")
    for name in ("rows", "piece_box"):
        if getattr(prep, name).dtype != torch.float32:
            raise TypeError(f"prepared {name} must be float32")
    if prep.piece_mom.dtype != torch.float64:
        raise TypeError("prepared piece_mom must be float64")
    n_pad = prep.keys_t.shape[1]
    n_pc = n_pad // _PA_PIECE_N
    if prep.rows.shape != (n_pad, _PA_REC) \
            or prep.perm.shape != (obs_dim,) \
            or prep.piece_box.shape != (n_pc, 2 * obs_dim) \
            or prep.piece_mom.shape != (n_pc, 3 * prep.num_actions):
        raise ValueError(f"prepared rows must be [n_pad, {_PA_REC}], perm "
                         f"[{obs_dim}], piece_box [n_pad / {_PA_PIECE_N}, "
                         f"{2 * obs_dim}] and piece_mom [n_pad / "
                         f"{_PA_PIECE_N}, 3A]; got {tuple(prep.rows.shape)}, "
                         f"{tuple(prep.perm.shape)}, "
                         f"{tuple(prep.piece_box.shape)}, "
                         f"{tuple(prep.piece_mom.shape)}")


def peraction_plan(prep: PreparedPerActionStore, qext: torch.Tensor,
                   chunk: "int | None" = None) -> Plan:
    """The per-action kernel's plan.  Rows are sorted by band cell, then
    by the second dim, so the sub-slice band extrema are monotone only
    cell by cell; their running max (of ``kb[1]``) and suffix min (of
    ``kb[0]``) are monotone, and the window they give each tile holds
    every sub-slice :func:`prune_keep` keeps (the kernel repeats the
    exact tests inside it)."""
    n_sub = prep.kb.shape[1]
    n_qt = qext.shape[1]
    if chunk is None:
        chunk = _chunk_size(n_qt, n_sub, _PA_PART_BYTES * prep.num_actions
                            * _QT, 8, _PA_MAX_CHUNK, _PA_SCRATCH_BYTES)
    env_hi = torch.cummax(prep.kb[1], 0).values + prep.w0
    env_lo = torch.flip(torch.cummin(torch.flip(prep.kb[0], (0,)), 0).values,
                        (0,)) - prep.w0
    s_lo = torch.searchsorted(env_hi, qext[0].contiguous(), out_int32=True)
    s_hi = torch.searchsorted(env_lo, qext[1].contiguous(), out_int32=True,
                              right=True)
    return _chunk_plan(s_lo, s_hi, n_sub, chunk)


def launch_peraction(prep: PreparedPerActionStore, queries: torch.Tensor,
                     qorder: torch.Tensor, qext: torch.Tensor,
                     out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plan, then launch ``csrc/peraction_moments.cu`` (both passes) on
    the current stream: [B, A, 3] moments of the (checked) queries, the
    f64 sums rounded to ``out_dtype`` (float32 or float64).  The launch
    zeroes a one-int ticket on the device and hands its chunks out with
    it."""
    b = queries.shape[0]
    num_actions = prep.num_actions
    dev = queries.device
    plan = peraction_plan(prep, qext)
    partial = torch.empty((plan.max_chunks, 3 * num_actions, _QT),
                          dtype=torch.float64, device=dev)
    ticket = torch.empty(1, dtype=torch.int32, device=dev)
    out = torch.empty((b, 3 * num_actions), dtype=out_dtype, device=dev)
    fn = _cuda.load("peraction_moments").peraction_moments
    counts = profiling.counters("peraction_moments", dev)
    p, grid = ctypes.c_void_p, ctypes.c_int(0)
    err = fn(p(queries.data_ptr()), p(qorder.data_ptr()), p(qext.data_ptr()),
             p(prep.rows.data_ptr()), p(prep.perm.data_ptr()),
             p(prep.piece_box.data_ptr()), p(prep.piece_mom.data_ptr()),
             p(prep.kb.data_ptr()), p(prep.kb2.data_ptr()),
             p(prep.kbt.data_ptr()), p(prep.w_col.data_ptr()),
             p(prep.w0.data_ptr()), p(prep.w2.data_ptr()),
             p(plan.s_lo.data_ptr()), p(plan.s_hi.data_ptr()),
             p(plan.off.data_ptr()), b, prep.keys_t.shape[1], prep.n_tile,
             num_actions, plan.chunk, int(out_dtype == torch.float64),
             p(partial.data_ptr()), p(ticket.data_ptr()), p(out.data_ptr()),
             None if counts is None else p(counts.data_ptr()),
             p(torch.cuda.current_stream(dev).cuda_stream), ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"peraction_moments launch failed: CUDA error {err}")
    _cuda.LAUNCHES["peraction_moments"] += 1
    _cuda.GRID["peraction_moments"] = grid.value
    return out.reshape(b, num_actions, 3)


def query_peraction_prepared(prep: PreparedPerActionStore,
                             queries: torch.Tensor,
                             out_dtype: torch.dtype = torch.float32
                             ) -> torch.Tensor:
    """[B, A, 3] per-action moments of B observation queries [B, OBS]
    against a prepared store, summed in f64 and rounded to ``out_dtype``
    once (float64 for a caller that adds several stores' moments before
    it rounds: the sharded gated driver).  CUDA tensors go through the
    kernel (no fallback); CPU tensors through
    :func:`peraction_moments_plain`."""
    if out_dtype not in (torch.float32, torch.float64):
        raise TypeError(f"out_dtype must be float32 or float64, got "
                        f"{out_dtype}")
    if queries.device.type == "cpu":
        return peraction_moments_plain(prep, queries.to(torch.float32),
                                       out_dtype)
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    _check_cuda_operands(prep, queries)
    if queries.shape[0] == 0:
        return torch.zeros((0, prep.num_actions, 3), dtype=out_dtype,
                           device=queries.device)
    qorder, qext = query_operands(prep, queries)
    return launch_peraction(prep, queries, qorder, qext, out_dtype)


def box_query_moments_peraction(
    keys: torch.Tensor,         # [N, D] (last column = integer action)
    values: torch.Tensor,       # [N]
    valid: torch.Tensor,        # [N] bool
    obs_queries: torch.Tensor,  # [B, D-1]
    half_widths: torch.Tensor,  # [D]
    num_actions: int = 11,
    n_tile: int = 2048,
    band_dim: int = 1,
) -> torch.Tensor:
    """[B, A, 3] moments for every action of every query in one call:
    prepare, then query.  Equal to the brute reduction over the [B, A]
    candidate keys when the action lattice is integral and the action
    half-width is < 0.5."""
    prep = prepare_peraction_store(keys, values, valid, half_widths,
                                   num_actions=num_actions, n_tile=n_tile,
                                   band_dim=band_dim)
    return query_peraction_prepared(prep, obs_queries)



# ---------------------------------------------------------------------------
# [Q, 3] moments against band-sorted rows (csrc/sorted_moments.cu)
# ---------------------------------------------------------------------------

_SQT = 128      # queries per tile (csrc/chunk_ring.cuh QT)
_SSUB_N = 256   # rows per sub-slice (csrc/chunk_ring.cuh SUB_N)
_MAX_D = 32     # widest key both kernels take


def record_floats(d: int) -> int:
    """Floats in a [Q, 3] kernel's row record: d keys, v, valid, padded
    to a multiple of 4 (csrc/band_moments.cuh record_floats)."""
    return _round_up(d + 2, 4)


def _band_rows(keys_t: torch.Tensor, vals: torch.Tensor, valid: torch.Tensor,
               perm: torch.Tensor) -> torch.Tensor:
    """[n_pad, record_floats(D)] f32 row records: ``keys_t[perm]``,
    then v, then the valid flag, then zeros."""
    d, n_pad = keys_t.shape
    rows = torch.zeros((n_pad, record_floats(d)), dtype=torch.float32,
                       device=keys_t.device)
    rows[:, :d] = keys_t.index_select(0, perm.to(torch.int64)).T
    rows[:, d] = vals
    rows[:, d + 1] = valid
    return rows


class SortedOperands(NamedTuple):
    """Operands of the sorted-band kernel.  Rows are sorted by their band
    key (invalid rows last) and padded to a whole number of sub-slices;
    queries (or their copies, :func:`prepared_query_operands`) are sorted
    by their band key."""

    q_t: torch.Tensor     # [D, Q] f32 queries, band order
    keys_t: torch.Tensor  # [D, n_pad] f32 rows, band order; padding _PAD
    vals: torch.Tensor    # [n_pad] f32 (0 on padding)
    valid: torch.Tensor   # [n_pad] f32 1 / 0 (0 on padding)
    rows: torch.Tensor    # [n_pad, record_floats(D)] f32 the kernel's row
    #                       records (_band_rows of the three above)
    perm: torch.Tensor    # [D] i32 key dim of record slot d
    kb: torch.Tensor      # [2, n_pad / 256] band-key extrema per sub-slice
    qb: torch.Tensor      # [2, ceil(Q / 128)] band-key extrema per query
    #                       tile, over its queries whose key is not NaN
    w: torch.Tensor       # [D] f32 half-widths
    w0: torch.Tensor      # [1] f32 band half-width of the prune


class PreparedSortedStore(NamedTuple):
    """Store side of the sorted-band query (:func:`_prepare_band`):
    everything that depends on the rows alone, made once for a store that
    many batches of queries ask.  The band key is ``key[sdim]``, or, where
    ``composite`` holds, ``round(key[sdim]) * comp_c + key[sdim2]``, or,
    where ``bucketed`` holds too, ``(round(key[sdim]) * n_b + bucket) *
    comp_c + key[sdim2]`` (:func:`_composite_key`).

    With ``copies`` 2 (:func:`prepare_sorted_store`'s stores of 3 to 31
    key dims) the rows carry one key column more, last, at half-width 0.25: the bucket
    of ``key[sdim3]`` (:func:`_bucket`; 0 in every row where the level is
    not taken), and each query is asked as two copies, one a bucket its
    box reaches."""

    sdim: torch.Tensor    # [] i64 primary band dim
    keys_t: torch.Tensor  # [D', n_pad] f32 rows, band order; padding _PAD
    vals: torch.Tensor    # [n_pad] f32 (0 on padding)
    valid: torch.Tensor   # [n_pad] f32 1 / 0 (0 on padding)
    rows: torch.Tensor    # [n_pad, record_floats(D')] f32 row records
    perm: torch.Tensor    # [D'] i32 key dim of record slot d
    kb: torch.Tensor      # [2, n_pad / 256] band-key extrema per sub-slice
    w: torch.Tensor       # [D'] f32 half-widths
    w0: torch.Tensor      # [1] f32 band half-width of the prune (on the
    #                       composite key, before the queries' share)
    sdim2: torch.Tensor      # [] i64 composite key's second dim
    composite: torch.Tensor  # [] bool: band on the composite key
    comp_c: torch.Tensor     # [] f32 its c
    sdim3: torch.Tensor      # [] i64 the bucketed middle level's dim
    bucketed: torch.Tensor   # [] bool: the band key holds the level
    lo_b: torch.Tensor       # [] f64 the level's origin (0 where not taken)
    h_b: torch.Tensor        # [] f64 its bucket width (1 where not taken)
    n_b: torch.Tensor        # [] f32 its bucket count (1 where not taken)
    copies: int              # copies a query is asked as: 1, or 2 where
    #                          the rows carry the bucket column (D' = D + 1)


def _sorted_rows(keys_s, vals_s, valid_s, sk_s, w, w0, perm, **band
                 ) -> PreparedSortedStore:
    """Pad and lay out rows already in band order; the extrema are taken
    over the same f32 values the kernel compares.  ``perm`` is the
    records' dim order (:func:`_dim_order`); ``band`` holds the band-key
    fields."""
    n, d = keys_s.shape
    dev = keys_s.device
    n_pad = _round_up(max(n, _SSUB_N), _SSUB_N)
    keys_t = torch.full((d, n_pad), _PAD, dtype=torch.float32, device=dev)
    keys_t[:, :n] = keys_s.T
    vals = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    vals[:n] = vals_s
    valid = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    valid[:n] = valid_s.to(torch.float32)
    ks_p = torch.full((n_pad,), _PAD, dtype=torch.float32, device=dev)
    ks_p[:n] = sk_s
    return PreparedSortedStore(
        keys_t=keys_t, vals=vals, valid=valid,
        rows=_band_rows(keys_t, vals, valid, perm), perm=perm,
        kb=_extrema(ks_p, _SSUB_N), w=w.contiguous(),
        w0=w0.reshape(1).contiguous(), **band)


def _with_queries(prep: PreparedSortedStore, q_t, qk_s, w0
                  ) -> SortedOperands:
    """The operands of queries already in band order (``q_t`` [D, Q],
    ``qk_s`` their band keys) against prepared rows, with the band
    half-width ``w0`` [1].  A query whose band key is NaN matches
    nothing, so a tile's extrema leave it out, and a tile of such queries
    (the dead copies at the end of the order, the padding) keeps no
    sub-slice."""
    q = q_t.shape[1]
    pad = _round_up(q, _SQT) - q
    qk_p = torch.cat([qk_s, qk_s.new_full((pad,), torch.nan)])
    inf = torch.inf
    qb = torch.stack([
        torch.nan_to_num(qk_p, nan=inf, posinf=inf, neginf=-inf)
        .reshape(-1, _SQT).amin(1),
        torch.nan_to_num(qk_p, nan=-inf, posinf=inf, neginf=-inf)
        .reshape(-1, _SQT).amax(1)])
    return SortedOperands(
        q_t=q_t, keys_t=prep.keys_t, vals=prep.vals,
        valid=prep.valid, rows=prep.rows, perm=prep.perm, kb=prep.kb,
        qb=qb, w=prep.w, w0=w0)


def sorted_prune_keep(ops: SortedOperands) -> torch.Tensor:
    """[n_qtiles, n_sub] bool: the (query tile, row sub-slice) pairs the
    band-overlap test keeps (the kernel visits exactly these, through
    :func:`sorted_plan`)."""
    q_lo, q_hi = ops.qb[0][:, None], ops.qb[1][:, None]
    return (ops.kb[0] - ops.w0 <= q_hi) & (ops.kb[1] + ops.w0 >= q_lo)


def sorted_plan(ops: SortedOperands, chunk: "int | None" = None) -> Plan:
    """The sorted kernel's plan.  The rows are in band order, so both
    ``kb[1] + w0`` and ``kb[0] - w0`` are non-decreasing (f32 rounding is
    monotone) and the sub-slices :func:`sorted_prune_keep` keeps for a
    tile are the one window that two searchsorted calls find."""
    n_sub = ops.kb.shape[1]
    n_qt = ops.qb.shape[1]
    if chunk is None:
        chunk = _chunk_size(n_qt, n_sub, 8 * 3 * _SQT, 4, 1 << 20)
    s_lo = torch.searchsorted(ops.kb[1] + ops.w0, ops.qb[0].contiguous(),
                              out_int32=True)
    s_hi = torch.searchsorted(ops.kb[0] - ops.w0, ops.qb[1].contiguous(),
                              out_int32=True, right=True)
    return _chunk_plan(s_lo, s_hi, n_sub, chunk)


def sorted_moments_plain(ops: SortedOperands,
                         out_dtype: torch.dtype = torch.float32
                         ) -> torch.Tensor:
    """Plain version of the kernel: [Q, 3] moments in band order, by a
    brute f32 containment over the same sorted, padded operands, then a
    float64 ``mask @ [1, v, v^2]`` product rounded to ``out_dtype`` (the
    kernel keeps its sums in f64 too: an f32 sum over tens of thousands of
    matched rows drifts past the oracle's rtol 1e-4)."""
    mask = (ops.valid != 0)[None, :].expand(ops.q_t.shape[1], -1).clone()
    for d in range(ops.q_t.shape[0]):
        mask &= torch.abs(ops.q_t[d][:, None] - ops.keys_t[d][None, :]) \
            <= ops.w[d]
    v = ops.vals.to(torch.float64)
    feats = torch.stack([torch.ones_like(v), v, v * v], dim=1)   # [n_pad, 3]
    return (mask.to(torch.float64) @ feats).to(out_dtype)


def _check_cuda(tensors: dict, dev: torch.device) -> None:
    """Device, type (int32 for ``perm``, float32 otherwise) and
    contiguity of a kernel's operands."""
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        want = torch.int32 if name == "perm" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} must be {want}, got {t.dtype}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")


def _check_sorted_operands(ops: SortedOperands) -> None:
    d, q = ops.q_t.shape
    n_pad = ops.keys_t.shape[1]
    _check_cuda(ops._asdict(), ops.q_t.device)
    if not 1 <= d <= _MAX_D or ops.keys_t.shape[0] != d \
            or ops.w.shape != (d,):
        raise ValueError(f"the kernel takes 1..{_MAX_D} key dims; got queries "
                         f"{tuple(ops.q_t.shape)}, rows "
                         f"{tuple(ops.keys_t.shape)}, w {tuple(ops.w.shape)}")
    if n_pad % _SSUB_N or ops.vals.shape != (n_pad,) \
            or ops.valid.shape != (n_pad,) \
            or ops.kb.shape != (2, n_pad // _SSUB_N):
        raise ValueError(f"rows must be padded to a multiple of {_SSUB_N} "
                         "with matching vals, valid and kb")
    if ops.rows.shape != (n_pad, record_floats(d)) or ops.perm.shape != (d,):
        raise ValueError(f"rows must be [{n_pad}, {record_floats(d)}] and "
                         f"perm [{d}]; got {tuple(ops.rows.shape)}, "
                         f"{tuple(ops.perm.shape)}")
    if ops.qb.shape != (2, -(-q // _SQT)) or ops.w0.shape != (1,):
        raise ValueError("qb must be [2, ceil(Q / 128)] and w0 [1]")


def _launch_band(name: str, q_t, rows, perm, w, plan: Plan,
                 out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Both passes of ``csrc/<name>.cu`` (band_moments.cuh) on the current
    stream: [Q, 3] moments of the tile-ordered queries ``q_t`` [D, Q],
    the f64 sums rounded to ``out_dtype`` (float32, or for
    ``sorted_moments`` float64)."""
    d, q = q_t.shape
    dev = q_t.device
    partial = torch.empty((plan.max_chunks, 3, _SQT), dtype=torch.float64,
                          device=dev)
    out = torch.empty((q, 3), dtype=out_dtype, device=dev)
    fn = getattr(_cuda.load(name), name)
    counts = profiling.counters(name, dev)
    p, grid = ctypes.c_void_p, ctypes.c_int(0)
    err = fn(p(q_t.data_ptr()), p(rows.data_ptr()), p(perm.data_ptr()),
             p(w.data_ptr()), p(plan.s_lo.data_ptr()), p(plan.s_hi.data_ptr()),
             p(plan.off.data_ptr()), q, d, plan.s_lo.shape[0], plan.chunk,
             *(() if name == "box_moments"
               else (int(out_dtype == torch.float64),)),
             p(partial.data_ptr()), p(out.data_ptr()),
             None if counts is None else p(counts.data_ptr()),
             p(torch.cuda.current_stream(dev).cuda_stream), ctypes.byref(grid))
    if err != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {err}")
    _cuda.LAUNCHES[name] += 1
    _cuda.GRID[name] = grid.value
    return out


def launch_sorted(ops: SortedOperands,
                  out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """Plan, then launch ``csrc/sorted_moments.cu`` on the current
    stream: [Q, 3] moments in band order (operands checked by the
    caller)."""
    return _launch_band("sorted_moments", ops.q_t, ops.rows, ops.perm, ops.w,
                        sorted_plan(ops), out_dtype)


def sorted_moments(ops: SortedOperands,
                   out_dtype: torch.dtype = torch.float32) -> torch.Tensor:
    """[Q, 3] moments in band order, summed in f64 and rounded to
    ``out_dtype`` (float32 or float64) once: the kernel for CUDA tensors
    (no fallback), :func:`sorted_moments_plain` for CPU tensors."""
    dev = ops.q_t.device
    if dev.type == "cpu":
        return sorted_moments_plain(ops, out_dtype)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_sorted_operands(ops)
    return launch_sorted(ops, out_dtype)


def prepare_sorted_store(keys: torch.Tensor,         # [N, D]
                         values: torch.Tensor,       # [N]
                         valid: torch.Tensor,        # [N] bool
                         half_widths: torch.Tensor,  # [D]
                         ) -> PreparedSortedStore:
    """The store side of the flat query for a store that many batches of
    queries ask: a loop whose store is fixed makes it once and asks it
    with :func:`query_sorted_prepared`.  Banded on dims chosen from the
    data (:func:`_prepare_flat`) and, with 3 to 31 key dims, with the
    bucketed middle level where the data take it (:func:`_prepare_band`).
    The level's prepare and each query's two copies are paid back only
    over many query tiles a band: a store prepared for one batch
    (:func:`box_query_moments_sorted`) goes without it."""
    return _prepare_flat(keys, values, valid, half_widths, middle=True)


def _prepare_flat(keys, values, valid, half_widths, middle: bool
                  ) -> PreparedSortedStore:
    """The flat route's store side (:func:`_prepare_band`) on dims chosen
    from the data: the primary dim is the most selective one
    (:func:`_selectivity`), the second the most selective other one and,
    with ``middle`` and 3 to 31 key dims, the middle level's dim the most
    selective of the rest.  The choice is made on the device, with no
    host synchronisation.  With tracing on (``utils/profiling``) it counts
    itself, whether it took the composite key and whether it took the
    middle level into ``sorted_prepare``."""
    keys = keys.to(torch.float32)
    d = keys.shape[1]
    w = half_widths.to(keys.device, torch.float32)
    sel = _selectivity(keys, valid, w)
    sdim = torch.argmax(sel)
    sel = sel.index_fill(0, sdim.reshape(1), -1.0)
    sdim2 = torch.argmax(sel)
    sdim3 = (torch.argmax(sel.index_fill(0, sdim2.reshape(1), -1.0))
             if middle and 3 <= d < _MAX_D else None)
    prep = _prepare_band(keys, values, valid, w, sdim, sdim2, sdim3)
    counts = profiling.counters("sorted_prepare", keys.device)
    if counts is not None:
        counts[:1].add_(1)
        counts[1:2].add_(prep.composite.to(torch.int64))
        counts[2:].add_(prep.bucketed.to(torch.int64))
    return prep


def _prepare_band(keys, values, valid, w, sdim, sdim2, sdim3=None
                  ) -> PreparedSortedStore:
    """The rows of f32 ``keys`` [N, D] sorted by their band key on the
    dims ``sdim`` and ``sdim2`` ([] i64, on the device of ``keys`` as
    ``w`` is) and, given ``sdim3``, the middle level on it; invalid rows
    last, padded and laid out as the kernel reads them.

    Where ``a = sdim`` is discrete (``w[a] < 0.5`` and every valid row's
    key in ``a`` an integer; tested on the device) the band key is the
    composite ``round(k_a) * c + k_s`` (:func:`_composite_key`), with
    ``s = sdim2`` and ``c = 4 (max |k_s| + w_s + 1)`` over the valid
    rows' real ``s`` keys (sentinel-scale ones, ``|k| >= _PAD / 2``, left
    out); otherwise it is ``k_a``.  The composite prune is exact for any
    query: a row can match ``q`` only if ``k_a = round(q_a)``, so every
    contained pair lies within ``w_s`` of its query on the composite key,
    and the band half-width adds the f32 rounding of the largest
    composite key the rows and each batch of queries reach
    (:func:`_composite_w0`, :func:`prepared_query_operands`).

    Given ``sdim3`` (``b``), the rows carry their bucket of ``k_b``
    (:func:`_middle_level`, :func:`_bucket`) as one more key column, and
    where the composite key is taken and the valid rows span two buckets
    or more, the key is ``(round(k_a) * n_b + bucket) * c + k_s``: a
    contained pair then also shares the bucket (the query's copy that
    asks it), so the same argument holds."""
    d = keys.shape[1]
    w0 = w.index_select(0, sdim.reshape(1))
    w_s = w.index_select(0, sdim2.reshape(1))
    k_a, k_s = _index_dim(keys, sdim), _index_dim(keys, sdim2)
    composite = ((w0[0] < 0.5) & ((torch.round(k_a) == k_a) | ~valid).all()
                 & (d > 1))
    real_s = valid & (torch.abs(k_s) < _PAD / 2)
    c = 4.0 * (_max0(torch.where(real_s, torch.abs(k_s), 0.0)) + w_s[0]
               + 1.0)
    if sdim3 is None:
        level, bucket = _no_level(sdim), k_a.new_zeros(())
    else:
        k_b = _index_dim(keys, sdim3)
        level = dict(sdim3=sdim3, **_middle_level(
            k_b, valid, w.index_select(0, sdim3.reshape(1))[0], composite))
        # a row whose key is NaN matches nothing: bucket 0 keeps its band
        # key, and so the sub-slice extrema, free of NaN
        bucket = torch.nan_to_num(_bucket(
            k_b.to(torch.float64), level["lo_b"], level["h_b"],
            level["n_b"]), nan=0.0).to(torch.float32)
    comp = _composite_key(k_a, k_s, c, bucket, level["n_b"])
    reach = _max0(torch.where(real_s & (torch.abs(k_a) < _PAD / 2),
                              torch.abs(comp), 0.0))
    sk = torch.where(valid, torch.where(composite, comp, k_a), _PAD)
    order = torch.argsort(sk, stable=True)
    keys_s, valid_s = keys[order], valid[order]
    # the band dims are tested last: the prune has already bounded them
    perm = _dim_order(keys_s, valid_s, w,
                      (torch.where(composite, sdim2, sdim), sdim))
    if sdim3 is not None:
        # the bucket column after them: equal in every pair the band keeps
        keys_s = torch.cat([keys_s, bucket[order, None]], 1)
        w = torch.cat([w, w.new_full((1,), 0.25)])
        perm = torch.cat([perm, perm.new_full((1,), d)])
    return _sorted_rows(keys_s, values.to(keys.device, torch.float32)[order],
                        valid_s, sk[order], w,
                        torch.where(composite, _composite_w0(w_s, reach), w0),
                        perm, sdim=sdim, sdim2=sdim2, composite=composite,
                        comp_c=c, copies=1 if sdim3 is None else 2, **level)


def _no_level(sdim: torch.Tensor) -> dict:
    """The level fields of a store without the middle level."""
    one = torch.ones((), dtype=torch.float64, device=sdim.device)
    return dict(sdim3=sdim, bucketed=torch.zeros_like(one, dtype=torch.bool),
                lo_b=torch.zeros_like(one), h_b=one,
                n_b=one.to(torch.float32))


def _middle_level(k_b, valid, w_b, composite) -> dict:
    """The bucketed middle level on the f32 keys ``k_b`` [N]: buckets of
    width ``h = max(4 w_b, 2^-16 max |k|)`` from ``lo_b``, the smallest of
    the valid rows' real keys (sentinel-scale ones left out); ``n_b`` the
    number of buckets they span.  Taken (``bucketed``) where ``composite``
    holds and ``n_b >= 2``; elsewhere the fields are those of no level
    (one bucket, 0), so every row's bucket is 0.

    A query box of half-width ``w_b``, widened for rounding
    (:func:`_query_buckets`), is shorter than ``h`` wherever it reaches a
    bucket inside the span, so it reaches at most two buckets; ``n_b``
    stays under ``2^17 + 2``, so every bucket is an exact f32 integer."""
    real = valid & (torch.abs(k_b) < _PAD / 2)
    kb = k_b.to(torch.float64)
    inf = kb.new_full((1,), torch.inf)
    lo = torch.cat([torch.where(real, kb, torch.inf), inf]).amin()
    hi = torch.cat([torch.where(real, kb, -torch.inf), -inf]).amax()
    h = torch.maximum(4.0 * w_b.to(torch.float64),
                      torch.maximum(lo.abs(), hi.abs()) * 2.0 ** -16)
    n_b = torch.floor((hi - lo) / h) + 1.0
    bucketed = composite & (n_b >= 2.0)
    return dict(bucketed=bucketed, lo_b=torch.where(bucketed, lo, 0.0),
                h_b=torch.where(bucketed, h, 1.0),
                n_b=torch.where(bucketed, n_b, 1.0).to(torch.float32))


def _bucket(x: torch.Tensor, lo_b: torch.Tensor, h_b: torch.Tensor,
            n_b: torch.Tensor) -> torch.Tensor:
    """f64 bucket of the f64 keys ``x`` on the middle level:
    ``floor((x - lo_b) / h_b)`` clamped into ``[0, n_b)`` (NaN for NaN).
    Rows and queries take this one function: it is monotone in ``x``, so
    a row key between two query bounds lies in a bucket between theirs."""
    return torch.minimum(torch.clamp(torch.floor((x - lo_b) / h_b),
                                     min=0.0), n_b - 1.0)


def _max0(x: torch.Tensor) -> torch.Tensor:
    """[] the largest of ``x`` and 0 (0 for an empty ``x``)."""
    return torch.cat([x.reshape(-1), x.new_zeros(1)]).amax()


def _composite_key(k_a: torch.Tensor, k_s: torch.Tensor, c: torch.Tensor,
                   bucket: torch.Tensor, n_b: torch.Tensor) -> torch.Tensor:
    """The composite band key ``(round(k_a) * n_b + bucket) * c + k_s`` in
    f32, rows and queries alike: a row and a query with the same
    ``round(k_a)`` and bucket share the product bit for bit.  Without the
    middle level (``n_b`` 1, every bucket 0) it is ``round(k_a) * c +
    k_s``, the same bits but for the sign of a zero."""
    return (torch.round(k_a) * n_b + bucket) * c + k_s


_ROUND_PAD = 2.0 ** -21  # 8x f32's half ulp, relative
# How far a query's bucket bounds reach past its box, relative to its
# |key| and half-width: past the f32 test's and the f64 bounds' rounding.
_BUCKET_PAD = 2.0 ** -20


def _composite_w0(w_s: torch.Tensor, reach: torch.Tensor) -> torch.Tensor:
    """[1] the rows' part of the composite prune's band half-width:
    ``w_s`` plus ``_ROUND_PAD`` of the largest magnitude a contained
    pair's keys and the band test's sum reach, the rows' ``reach`` plus
    ``2 w_s + 1``; each batch of queries adds its own reach
    (:func:`prepared_query_operands`).  That covers the half-ulp roundings
    of both keys and of the sum, so rounding only loosens the prune."""
    return w_s + (reach + 2.0 * w_s + 1.0) * _ROUND_PAD


def _query_buckets(prep: PreparedSortedStore, q_b: torch.Tensor
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """The buckets the two copies of each query ask, [2, Q] f32, from the
    queries' f32 keys ``q_b`` [Q] in the level's dim; and ``split`` [Q]
    bool.  Copy 0 asks the bucket of ``q_b - r``, copy 1 the next one,
    live only where the bucket of ``q_b + r`` is past copy 0's
    (``split``); a dead copy asks NaN, so it matches nothing.  ``r`` is
    ``w_b`` widened by ``_BUCKET_PAD``: every row key that passes the f32
    test ``|q_b - k_b| <= w_b`` lies in ``[q_b - r, q_b + r]``, so its
    bucket is one of the copies', and it matches only that copy on the
    bucket column."""
    q_b = q_b.to(torch.float64)
    w_b = prep.w.index_select(0, prep.sdim3.reshape(1)).to(torch.float64)
    r = w_b * (1.0 + _BUCKET_PAD) + torch.abs(q_b) * _BUCKET_PAD
    b = _bucket(torch.stack([q_b - r, q_b + r]), prep.lo_b, prep.h_b,
                prep.n_b)
    split = b[1] > b[0]
    b[1].masked_fill_(~split, torch.nan)
    return b.to(torch.float32), split


def prepared_query_operands(prep: PreparedSortedStore, queries: torch.Tensor
                            ) -> Tuple[SortedOperands, torch.Tensor]:
    """The operands of the flat queries [Q, D] against a prepared store,
    in band order, and ``qorder`` (band position -> query row; with
    ``prep.copies`` 2 the band orders the [2Q] copies, copy ``k`` of query
    ``i`` at ``k Q + i``, so ``qorder % Q`` is the query, and each copy
    holds the query and, last, the bucket it asks, :func:`_query_buckets`).
    On the composite key the band half-width adds ``_ROUND_PAD`` of the
    queries' largest |key| to the store's (a contained pair's row key
    lies within ``w_s`` of its query's); a NaN query matches nothing and
    adds nothing, and dead copies (NaN keys) sort last.  With tracing on
    (``utils/profiling``) it counts the queries asked as two copies into
    ``sorted_query.split``."""
    q, d = queries.shape
    q_t = queries.to(torch.float32).T.contiguous()               # [D, Q]
    qk, qs = (q_t.index_select(0, dim.reshape(1))[0]
              for dim in (prep.sdim, prep.sdim2))
    bucket = qk.new_zeros(())
    if prep.copies == 2:
        bucket, split = _query_buckets(
            prep, q_t.index_select(0, prep.sdim3.reshape(1))[0])
        counts = profiling.counters("sorted_query", queries.device)
        if counts is not None:
            counts.add_(split.sum())
    comp = _composite_key(qk, qs, prep.comp_c, bucket, prep.n_b)  # [(2,) Q]
    reach = torch.nan_to_num(torch.abs(comp), nan=0.0).amax()
    w0 = prep.w0 + torch.where(prep.composite, reach, 0.0) * _ROUND_PAD
    qk = torch.where(prep.composite, comp, qk)
    if prep.copies == 2:
        qk = torch.where(torch.isnan(bucket), torch.nan, qk).reshape(-1)
    qorder = torch.argsort(qk, stable=True)
    ops_q = torch.empty((d + prep.copies - 1, qorder.shape[0]),
                        dtype=torch.float32, device=queries.device)
    torch.index_select(q_t, 1, qorder if prep.copies == 1
                       else torch.remainder(qorder, q), out=ops_q[:d])
    if prep.copies == 2:
        torch.index_select(bucket.reshape(-1), 0, qorder, out=ops_q[d])
    return _with_queries(prep, ops_q, qk[qorder], w0), qorder


def sorted_query_operands(keys, values, valid, queries, half_widths
                          ) -> Tuple[SortedOperands, torch.Tensor]:
    """Band order of the flat query as :func:`box_query_moments_sorted`
    asks it (:func:`_prepare_flat` without the middle level, then
    :func:`prepared_query_operands`).  Returns the operands and
    ``qorder`` [Q] (band position -> query row)."""
    return prepared_query_operands(
        _prepare_flat(keys, values, valid, half_widths, middle=False),
        queries)


def unsort_moments(out: torch.Tensor, qorder: torch.Tensor, q: int
                   ) -> torch.Tensor:
    """[Q, 3] f32 moments of ``q`` queries in their own order from the
    band-ordered moments ``out`` of their operands and ``qorder``
    (:func:`prepared_query_operands`).  Where each query was asked as two
    copies, ``out`` holds f64 sums: a query's copies are added in f64,
    then rounded to f32 once."""
    full = torch.empty_like(out).index_copy_(0, qorder, out)
    if out.shape[0] != q:
        full = full.reshape(2, q, 3)
        full = full[0] + full[1]
    return full.to(torch.float32)


def query_sorted_prepared(prep: PreparedSortedStore, queries: torch.Tensor
                          ) -> torch.Tensor:
    """[Q, 3] f32 moments of the flat queries [Q, D] against a prepared
    store, in the queries' own order: their band sort, the plan, the
    launch (the plain version for CPU tensors) and the un-sort
    (:func:`unsort_moments`), with no host synchronisation (a captured
    tick can hold it)."""
    if queries.shape[0] == 0:
        return torch.zeros((0, 3), device=queries.device)
    ops, qorder = prepared_query_operands(prep, queries)
    out = sorted_moments(ops, torch.float32 if prep.copies == 1
                         else torch.float64)
    return unsort_moments(out, qorder, queries.shape[0])


def box_query_moments_sorted(keys: torch.Tensor,         # [N, D]
                             values: torch.Tensor,       # [N]
                             valid: torch.Tensor,        # [N] bool
                             queries: torch.Tensor,      # [Q, D]
                             half_widths: torch.Tensor,  # [D]
                             ) -> torch.Tensor:
    """[Q, 3] f32 moments (count, sum v, sum v^2) of the valid rows whose
    boxes contain each query, through the sorted-band kernel
    (``pallas_store.py::box_query_moments_sorted``): the store prepared
    for this batch (:func:`_prepare_flat`, without the middle level),
    then queried."""
    if queries.shape[0] == 0:
        return torch.zeros((0, 3), device=queries.device)
    return query_sorted_prepared(
        _prepare_flat(keys, values, valid, half_widths, middle=False),
        queries)


def _grouped_store(keys, values, valid, half_widths, action_dim: int,
                   band_dim: int) -> PreparedSortedStore:
    """The store banded on the fixed dims (``action_dim``, ``band_dim``):
    the composite key where the action column is integral."""
    keys = keys.to(torch.float32)
    d = keys.shape[1]
    sdim, sdim2 = (torch.full((), x % d, dtype=torch.int64,
                              device=keys.device)
                   for x in (action_dim, band_dim))
    return _prepare_band(keys, values, valid,
                         half_widths.to(keys.device, torch.float32),
                         sdim, sdim2)


def grouped_query_operands(keys, values, valid, queries, half_widths,
                           action_dim: int = -1, band_dim: int = 1
                           ) -> Tuple[SortedOperands, torch.Tensor]:
    """Band order of the action-grouped query [A, Qa, D]: the flat
    route's query (:func:`prepared_query_operands`) of the [A Qa, D]
    queries against the store banded on (action, ``band_dim``).  Returns
    the operands and ``qorder`` [A Qa] (band position -> query row)."""
    return prepared_query_operands(
        _grouped_store(keys, values, valid, half_widths, action_dim,
                       band_dim), queries.reshape(-1, queries.shape[-1]))


def box_query_moments_grouped(keys: torch.Tensor,         # [N, D]
                              values: torch.Tensor,       # [N]
                              valid: torch.Tensor,        # [N] bool
                              queries: torch.Tensor,      # [A, Qa, D]
                              half_widths: torch.Tensor,  # [D]
                              action_dim: int = -1,
                              band_dim: int = 1) -> torch.Tensor:
    """[A, Qa, 3] moments of action-grouped queries through the
    sorted-band kernel (``pallas_store.py::box_query_moments_grouped``):
    :func:`query_sorted_prepared` against the store banded on (action,
    ``band_dim``)."""
    a, qa, d = queries.shape
    return query_sorted_prepared(
        _grouped_store(keys, values, valid, half_widths, action_dim,
                       band_dim), queries.reshape(a * qa, d)
    ).reshape(a, qa, 3)


# ---------------------------------------------------------------------------
# Brute-force [Q, 3] moments (csrc/box_moments.cu)
# ---------------------------------------------------------------------------


class BruteOperands(NamedTuple):
    q_t: torch.Tensor     # [D, q_pad] f32 queries, padding +inf
    rows: torch.Tensor    # [n_pad, record_floats(D)] f32 row records (keys
    #                       in key order, padding 0; v; valid, 0 on padding)
    perm: torch.Tensor    # [D] i32 identity: record slot d holds key dim d
    w: torch.Tensor       # [D] f32


def brute_operands(keys, values, valid, queries, half_widths) -> BruteOperands:
    n, d = keys.shape
    q = queries.shape[0]
    dev = keys.device
    n_pad = _round_up(max(n, _SSUB_N), _SSUB_N)
    q_pad = _round_up(max(q, _SQT), _SQT)
    keys_t = torch.zeros((d, n_pad), dtype=torch.float32, device=dev)
    keys_t[:, :n] = keys.T
    vals = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    vals[:n] = values
    valid_f = torch.zeros(n_pad, dtype=torch.float32, device=dev)
    valid_f[:n] = valid.to(torch.float32)
    perm = torch.arange(d, dtype=torch.int32, device=dev)
    # padded queries are +inf: they match nothing
    q_t = torch.full((d, q_pad), torch.inf, dtype=torch.float32, device=dev)
    q_t[:, :q] = queries.T
    return BruteOperands(q_t=q_t, rows=_band_rows(keys_t, vals, valid_f, perm),
                         perm=perm,
                         w=half_widths.to(dev, torch.float32).contiguous())


def brute_plan(n_qt: int, n_sub: int, dev: torch.device,
               chunk: "int | None" = None) -> Plan:
    """The brute kernel's plan: every tile's window is every sub-slice."""
    if chunk is None:
        chunk = _chunk_size(n_qt, n_sub, 8 * 3 * _SQT, 4, 1 << 20)
    return _chunk_plan(torch.zeros(n_qt, dtype=torch.int32, device=dev),
                       torch.full((n_qt,), n_sub, dtype=torch.int32,
                                  device=dev), n_sub, chunk)


def launch_brute(ops: BruteOperands) -> torch.Tensor:
    """Plan, then launch ``csrc/box_moments.cu`` on the current stream:
    [q_pad, 3] moments (operands checked by the caller)."""
    return _launch_band("box_moments", ops.q_t, ops.rows, ops.perm, ops.w,
                        brute_plan(ops.q_t.shape[1] // _SQT,
                                   ops.rows.shape[0] // _SSUB_N,
                                   ops.q_t.device))


def brute_moments_plain(keys, values, valid, queries, half_widths
                        ) -> torch.Tensor:
    """Plain version of the brute kernel: ``core/store.py::_raw_moments``
    with the f32 containment test and, as in the kernel, the moments
    summed in f64 (returned as f32)."""
    return _raw_moments(keys.to(torch.float32), values.to(torch.float64),
                        valid, queries.to(torch.float32),
                        half_widths.to(torch.float32))


def box_query_moments_brute(keys: torch.Tensor,         # [N, D]
                            values: torch.Tensor,       # [N]
                            valid: torch.Tensor,        # [N] bool
                            queries: torch.Tensor,      # [Q, D]
                            half_widths: torch.Tensor,  # [D]
                            ) -> torch.Tensor:
    """[Q, 3] f32 moments by brute force over every row
    (``pallas_store.py::box_query_moments_pallas``): the CUDA kernel for
    CUDA tensors (no fallback), :func:`brute_moments_plain` for CPU
    tensors."""
    dev = queries.device
    if dev.type == "cpu":
        return brute_moments_plain(keys, values, valid, queries, half_widths)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    d = queries.shape[1]
    if not 1 <= d <= _MAX_D or keys.ndim != 2 or keys.shape[1] != d \
            or half_widths.shape != (d,):
        raise ValueError(f"the kernel takes 1..{_MAX_D} key dims; got keys "
                         f"{tuple(keys.shape)}, queries {tuple(queries.shape)}")
    if values.shape != keys.shape[:1] or valid.shape != keys.shape[:1]:
        raise ValueError("values and valid must be [N]")
    if queries.shape[0] == 0:
        return torch.zeros((0, 3), device=dev)
    ops = brute_operands(keys, values, valid, queries, half_widths)
    _check_cuda(ops._asdict(), dev)
    return launch_brute(ops)[:queries.shape[0]]
