"""Store queries: the counterparts of ``dcarl_tpu/ops/pallas_store.py``.

Three kernels answer box queries against the confidence store, each a
CUDA kernel for Hopper with a plain PyTorch version beside it (the
wrapper takes the plain version for CPU tensors only; for CUDA tensors
it launches the kernel or raises):

* ``peraction_moments`` (gated driver, below);
* ``sorted_moments``, ``[Q, 3]`` moments against band-sorted rows with
  a sub-slice band prune: the flat :func:`box_query_moments_sorted`
  (``core/store.py::box_query_stats``) and the action-grouped
  :func:`box_query_moments_grouped` (the trainer's rule-column query);
* ``box_moments``, the unpruned brute-force ``[Q, 3]`` baseline
  (:func:`box_query_moments_brute`).

The per-action query: the gated driver needs (count, sum v, sum v^2) for every candidate
action of every env.  With an integer action lattice and an action
half-width < 0.5 each stored row matches exactly one action, so one
20-D containment test per (env, row) plus a scatter of the row's
moments into its action's slots answers all A actions at once.

* :func:`prepare_peraction_store` (torch, on the device of its inputs)
  sorts the store by (band cell, second dim, row hash), collapses
  bitwise-identical rows into weighted moments, and builds the feature
  block and the sub-slice extrema the kernel prunes with.  A deployment
  loop whose store is fixed runs it once per run.
* :func:`query_peraction_prepared` answers B queries against a prepared
  store: for CUDA tensors it launches ``csrc/peraction_moments.cu``
  (or raises); for CPU tensors it takes the plain version,
  :func:`peraction_moments_plain`, a brute containment followed by a
  full-FP32 feature product.
"""

from __future__ import annotations

import ctypes
from typing import NamedTuple, Tuple

import torch

from dcarl_tpu_torch.core.store import _raw_moments
from dcarl_tpu_torch.ops import _cuda

# Finite padding key: far outside any real key range (same value as the
# JAX package's pallas_store._PAD and core/store.py SENTINEL_KEY).
_PAD = 1.0e9
_QT = 128     # queries per kernel block (csrc/peraction_moments.cu QT)
_SUB_N = 256  # rows per kernel sub-slice (csrc/peraction_moments.cu SUB_N)
_MAX_ACTIONS = 16


def _round_up(x: int, m: int) -> int:
    return (x + m - 1) // m * m


class PreparedPerActionStore(NamedTuple):
    """Store-side operands of the per-action query.  Rows are sorted and
    deduplicated; columns past the unique rows (and up to ``n_pad``) are
    padding that matches nothing."""

    keys_t: torch.Tensor    # [OBS, n_pad] f32 obs keys, padding = _PAD
    row_act: torch.Tensor   # [n_pad] i32 action of the row; -1 adds nothing
    row_mom: torch.Tensor   # [3, n_pad] f32 (count, sum v, sum v^2) of
    #                         the row's run of identical keys
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

    # Second prune dim: the most selective obs dim (spread over
    # half-width) other than the band dim, measured from the data.
    vf0 = valid.to(torch.float32)
    cnt0 = torch.clamp(vf0.sum(), min=1.0)
    mean0 = (vf0 @ keys) / cnt0
    spread0 = (vf0 @ torch.abs(keys - mean0)) / cnt0
    sel0 = spread0[:obs_dim] / torch.clamp(w[:obs_dim], min=1e-9)
    sel0[band_dim] = -1.0
    sdim2 = torch.argmax(sel0)
    w2 = w[sdim2]

    # Lexicographic sort: band cell of width 2*w0, second dim, then the
    # 64-bit row hash (brings bitwise-identical rows together for the
    # dedup).  Invalid rows sort last (cell = +inf).  Sub-slice bounds
    # below are true extrema, so any order is correct; this one keeps
    # both ranges of a sub-slice tight.
    cell_w = 2.0 * torch.clamp(w[band_dim], min=1e-9)
    cells_k = torch.where(valid, torch.floor(keys[:, band_dim] / cell_w),
                          torch.inf)
    d2k = keys[:, sdim2]
    h1, h2 = _row_hashes(keys)
    zero = torch.zeros_like(h1)
    order = _lexsort((torch.where(valid, h2, zero),
                      torch.where(valid, h1, zero),
                      torch.where(valid, d2k, _PAD), cells_k))
    keys_s = keys[order]
    vals_s = values[order]
    valid_s = valid[order]

    # Dedup: moments are additive, so a run of identical valid rows
    # collapses into one row carrying (count, sum v, sum v^2).
    same = (keys_s[1:] == keys_s[:-1]).all(dim=1) & valid_s[1:] & valid_s[:-1]
    first = torch.cat([torch.ones(1, dtype=torch.bool, device=dev), ~same])
    seg = torch.cumsum(first.to(torch.int64), 0) - 1          # run ids
    ones = valid_s.to(torch.float32)
    cnt_r = torch.zeros(n, device=dev).index_add_(0, seg, ones)
    sum_r = torch.zeros(n, device=dev).index_add_(0, seg, vals_s * ones)
    ssq_r = torch.zeros(n, device=dev).index_add_(0, seg,
                                                  vals_s * vals_s * ones)
    # compact: unique rows keep their order at the front, collapsed
    # duplicates fall to the back as invalid slots
    iota = torch.arange(n, device=dev)
    corder = torch.argsort(torch.where(first, iota, n + 1 + iota), stable=True)
    keys_s = keys_s[corder]
    valid_s = (valid_s & first)[corder]
    run_id = seg[corder]
    wmom = torch.stack([cnt_r[run_id], sum_r[run_id], ssq_r[run_id]])
    wmom = wmom * valid_s[None, :].to(torch.float32)          # [3, N]
    sk_s = torch.where(valid_s, keys_s[:, band_dim], _PAD)
    s2_s = torch.where(valid_s, keys_s[:, sdim2], _PAD)

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
    return PreparedPerActionStore(
        keys_t=keys_t, row_act=row_act, row_mom=row_mom,
        kb=_extrema(ks_p, sub_n), kb2=_extrema(k2_p, sub_n),
        kbt=_extrema(ks_p, n_tile), w_col=w[:obs_dim].contiguous(),
        w0=w[band_dim].reshape(1), w2=w2.reshape(1), sdim2=sdim2,
        cell_w=cell_w, band_dim=band_dim, num_actions=num_actions,
        n_tile=n_tile, sub_n=sub_n)


def feature_block(prep: PreparedPerActionStore) -> torch.Tensor:
    """[3A, n_pad] f32 ``feats[a*3 + m, r] = 1[action_r == a] *
    moment_m(r)``: the JAX kernel's feature operand (its ``rows_cat``
    below the keys), the row moments scattered to their action's slots."""
    a = torch.arange(prep.num_actions, device=prep.row_act.device)
    onehot = (prep.row_act[None, :] == a[:, None]).to(torch.float32)  # [A, n]
    return (onehot[:, None, :] * prep.row_mom[None]).reshape(
        3 * prep.num_actions, -1)


def query_operands(prep: PreparedPerActionStore, queries: torch.Tensor,
                   q_tile: int = _QT) -> Tuple[torch.Tensor, torch.Tensor]:
    """Query side of the kernel: ``qorder`` [B] i64, the queries in
    (band cell, second dim) order, and ``qext`` [4, ceil(B / q_tile)]
    f32, each sorted tile's (band lo, band hi, second-dim lo, hi)."""
    qbv = queries[:, prep.band_dim]
    d2q = queries[:, prep.sdim2]
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
                            queries: torch.Tensor) -> torch.Tensor:
    """Plain version of the kernel: [B, A, 3] moments by a brute
    containment over every prepared row, then ``mask @ feats^T`` in full
    FP32 (TF32 must be off on the card)."""
    mask = torch.ones((queries.shape[0], prep.keys_t.shape[1]),
                      dtype=torch.bool, device=queries.device)
    for d in range(prep.keys_t.shape[0]):
        mask &= torch.abs(queries[:, d:d + 1] - prep.keys_t[d][None, :]) \
            <= prep.w_col[d]
    out = mask.to(torch.float32) @ feature_block(prep).T
    return out.reshape(queries.shape[0], prep.num_actions, 3)


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
    for name in ("keys_t", "row_act", "row_mom", "kb", "kb2", "kbt",
                 "w_col", "w0", "w2"):
        t = getattr(prep, name)
        if t.device != queries.device:
            raise ValueError(f"prepared {name} is on {t.device}, queries on "
                             f"{queries.device}")
        if not t.is_contiguous():
            raise ValueError(f"prepared {name} must be contiguous")
    if prep.row_act.dtype != torch.int32:
        raise TypeError("prepared row_act must be int32")


def launch_peraction(prep: PreparedPerActionStore, queries: torch.Tensor,
                     qorder: torch.Tensor, qext: torch.Tensor) -> torch.Tensor:
    """Launch ``csrc/peraction_moments.cu`` on the current stream:
    [B, A, 3] moments of the (checked) queries."""
    b = queries.shape[0]
    num_actions = prep.num_actions
    out = torch.empty((b, 3 * num_actions), dtype=torch.float32,
                      device=queries.device)
    fn = _cuda.load("peraction_moments").peraction_moments
    p = ctypes.c_void_p
    err = fn(p(queries.data_ptr()), p(qorder.data_ptr()), p(qext.data_ptr()),
             p(prep.keys_t.data_ptr()), p(prep.row_act.data_ptr()),
             p(prep.row_mom.data_ptr()), p(prep.kb.data_ptr()),
             p(prep.kb2.data_ptr()), p(prep.kbt.data_ptr()),
             p(prep.w_col.data_ptr()), p(prep.w0.data_ptr()),
             p(prep.w2.data_ptr()), b, prep.keys_t.shape[1], prep.n_tile,
             num_actions, p(out.data_ptr()),
             p(torch.cuda.current_stream(queries.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"peraction_moments launch failed: CUDA error {err}")
    _cuda.LAUNCHES["peraction_moments"] += 1
    return out.reshape(b, num_actions, 3)


def query_peraction_prepared(prep: PreparedPerActionStore,
                             queries: torch.Tensor) -> torch.Tensor:
    """[B, A, 3] per-action moments of B observation queries [B, OBS]
    against a prepared store.  CUDA tensors go through the kernel (no
    fallback); CPU tensors through :func:`peraction_moments_plain`."""
    if queries.device.type == "cpu":
        return peraction_moments_plain(prep, queries.to(torch.float32))
    if queries.device.type != "cuda":
        raise ValueError(f"unsupported device {queries.device}")
    _check_cuda_operands(prep, queries)
    if queries.shape[0] == 0:
        return torch.zeros((0, prep.num_actions, 3), device=queries.device)
    qorder, qext = query_operands(prep, queries)
    return launch_peraction(prep, queries, qorder, qext)


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

_SQT = 128      # queries per block (csrc/sorted_moments.cu, box_moments.cu QT)
_SSUB_N = 256   # rows per staged sub-slice (both kernels' SUB_N)
_MAX_D = 32     # widest key both kernels take


class SortedOperands(NamedTuple):
    """Operands of the sorted-band kernel.  Rows are sorted by their band
    key (invalid rows last) and padded to a whole number of sub-slices;
    queries are sorted by their band key."""

    q_t: torch.Tensor     # [D, Q] f32 queries, band order
    keys_t: torch.Tensor  # [D, n_pad] f32 rows, band order; padding _PAD
    vals: torch.Tensor    # [n_pad] f32 (0 on padding)
    valid: torch.Tensor   # [n_pad] f32 1 / 0 (0 on padding)
    kb: torch.Tensor      # [2, n_pad / 256] band-key extrema per sub-slice
    qb: torch.Tensor      # [2, ceil(Q / 128)] band-key extrema per query tile
    w: torch.Tensor       # [D] f32 half-widths
    w0: torch.Tensor      # [1] f32 band half-width of the prune


def _sorted_operands(keys_s, vals_s, valid_s, sk_s, q_s, qk_s, w, w0
                     ) -> SortedOperands:
    """Pad and lay out rows and queries already in band order; the
    extrema are taken over the same f32 values the kernel compares."""
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
    q = q_s.shape[0]
    pad = _round_up(q, _SQT) - q
    # pad by repeating the last sorted query: the extrema stay exact
    qk_p = torch.cat([qk_s, qk_s[-1:].expand(pad)])
    return SortedOperands(
        q_t=q_s.T.contiguous(), keys_t=keys_t, vals=vals, valid=valid,
        kb=_extrema(ks_p, _SSUB_N), qb=_extrema(qk_p, _SQT),
        w=w.contiguous(), w0=w0.reshape(1).contiguous())


def sorted_prune_keep(ops: SortedOperands) -> torch.Tensor:
    """[n_qtiles, n_sub] bool: the (query tile, row sub-slice) pairs the
    kernel examines, by the band-overlap test it runs."""
    q_lo, q_hi = ops.qb[0][:, None], ops.qb[1][:, None]
    return (ops.kb[0] - ops.w0 <= q_hi) & (ops.kb[1] + ops.w0 >= q_lo)


def sorted_moments_plain(ops: SortedOperands) -> torch.Tensor:
    """Plain version of the kernel: [Q, 3] f32 moments in band order, by
    a brute f32 containment over the same sorted, padded operands, then a
    float64 ``mask @ [1, v, v^2]`` product (the kernel keeps its sums in
    f64 too: an f32 sum over tens of thousands of matched rows drifts
    past the oracle's rtol 1e-4)."""
    mask = (ops.valid != 0)[None, :].expand(ops.q_t.shape[1], -1).clone()
    for d in range(ops.q_t.shape[0]):
        mask &= torch.abs(ops.q_t[d][:, None] - ops.keys_t[d][None, :]) \
            <= ops.w[d]
    v = ops.vals.to(torch.float64)
    feats = torch.stack([torch.ones_like(v), v, v * v], dim=1)   # [n_pad, 3]
    return (mask.to(torch.float64) @ feats).to(torch.float32)


def _check_cuda(tensors: dict, dev: torch.device) -> None:
    for name, t in tensors.items():
        if t.device != dev:
            raise ValueError(f"{name} is on {t.device}, expected {dev}")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} must be float32, got {t.dtype}")
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
    if ops.qb.shape != (2, -(-q // _SQT)) or ops.w0.shape != (1,):
        raise ValueError("qb must be [2, ceil(Q / 128)] and w0 [1]")


def launch_sorted(ops: SortedOperands) -> torch.Tensor:
    """Launch ``csrc/sorted_moments.cu`` on the current stream: [Q, 3]
    moments in band order (operands checked by the caller)."""
    d, q = ops.q_t.shape
    out = torch.empty((q, 3), dtype=torch.float32, device=ops.q_t.device)
    fn = _cuda.load("sorted_moments").sorted_moments
    p = ctypes.c_void_p
    err = fn(p(ops.q_t.data_ptr()), p(ops.keys_t.data_ptr()),
             p(ops.vals.data_ptr()), p(ops.valid.data_ptr()),
             p(ops.kb.data_ptr()), p(ops.qb.data_ptr()), p(ops.w.data_ptr()),
             p(ops.w0.data_ptr()), q, ops.keys_t.shape[1], d,
             p(out.data_ptr()),
             p(torch.cuda.current_stream(ops.q_t.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"sorted_moments launch failed: CUDA error {err}")
    _cuda.LAUNCHES["sorted_moments"] += 1
    return out


def sorted_moments(ops: SortedOperands) -> torch.Tensor:
    """[Q, 3] moments in band order: the kernel for CUDA tensors (no
    fallback), :func:`sorted_moments_plain` for CPU tensors."""
    dev = ops.q_t.device
    if dev.type == "cpu":
        return sorted_moments_plain(ops)
    if dev.type != "cuda":
        raise ValueError(f"unsupported device {dev}")
    _check_sorted_operands(ops)
    return launch_sorted(ops)


def _index_dim(x: torch.Tensor, dim: torch.Tensor) -> torch.Tensor:
    """``x[:, dim]`` for a device-resident index (no host round trip)."""
    return x.index_select(1, dim.reshape(1))[:, 0]


def sorted_query_operands(keys, values, valid, queries, half_widths
                          ) -> Tuple[SortedOperands, torch.Tensor]:
    """Band order of the flat query: the band dim is the most selective
    one, ``argmax(spread / w)`` with spread the mean |x - mean| of the
    valid rows.  Returns the operands and ``qorder`` [Q] (band position
    -> query row)."""
    keys = keys.to(torch.float32)
    values = values.to(keys.device, torch.float32)
    queries = queries.to(torch.float32)
    w = half_widths.to(keys.device, torch.float32)
    vf = valid.to(torch.float32)
    cnt = torch.clamp(vf.sum(), min=1.0)
    mean_d = (vf[:, None] * keys).sum(0) / cnt
    spread = (vf[:, None] * torch.abs(keys - mean_d)).sum(0) / cnt
    sdim = torch.argmax(spread / torch.clamp(w, min=1e-9))
    w0 = w.index_select(0, sdim.reshape(1))

    sk = torch.where(valid, _index_dim(keys, sdim), _PAD)
    order = torch.argsort(sk, stable=True)
    qk = _index_dim(queries, sdim)
    qorder = torch.argsort(qk, stable=True)
    ops = _sorted_operands(keys[order], values[order], valid[order],
                           sk[order], queries[qorder], qk[qorder], w, w0)
    return ops, qorder


def box_query_moments_sorted(keys: torch.Tensor,         # [N, D]
                             values: torch.Tensor,       # [N]
                             valid: torch.Tensor,        # [N] bool
                             queries: torch.Tensor,      # [Q, D]
                             half_widths: torch.Tensor,  # [D]
                             ) -> torch.Tensor:
    """[Q, 3] f32 moments (count, sum v, sum v^2) of the valid rows whose
    boxes contain each query, through the sorted-band kernel
    (``pallas_store.py::box_query_moments_sorted``)."""
    if queries.shape[0] == 0:
        return torch.zeros((0, 3), device=queries.device)
    ops, qorder = sorted_query_operands(keys, values, valid, queries,
                                        half_widths)
    out = sorted_moments(ops)
    return torch.empty_like(out).index_copy_(0, qorder, out)   # un-sort


def grouped_query_operands(keys, values, valid, queries, half_widths,
                           action_dim: int = -1, band_dim: "int | None" = 1
                           ) -> Tuple[SortedOperands, "torch.Tensor | None"]:
    """Band order of the action-grouped query [A, Qa, D]: the composite
    key ``action * c + key[band_dim]`` (c = 4 span, so actions never
    band-overlap), one stable [Qa] sort shared by every group.  Returns
    the operands and ``qorder`` [Qa] (None with ``band_dim=None``)."""
    a, qa, d = queries.shape
    keys = keys.to(torch.float32)
    values = values.to(keys.device, torch.float32)
    queries = queries.to(torch.float32)
    w = half_widths.to(keys.device, torch.float32)
    sdim = action_dim % d
    qorder = None
    if band_dim is None:
        w0 = w[sdim]
        row_band = keys[:, sdim]
        q_band = queries.reshape(a * qa, d)[:, sdim]
    else:
        w0 = w[band_dim]
        bvals = keys[:, band_dim]
        qb = queries[0, :, band_dim]              # same envs in every group
        # sentinel rows (dense-block writes, |key| ~ 1e9) stay out of the
        # span, or c would quantize the f32 composite key to steps >> w0
        real = valid & (torch.abs(bvals) < _PAD / 2)
        span = torch.maximum(torch.where(real, torch.abs(bvals), 0.0).amax(),
                             torch.abs(qb).amax()) + w0 + 1.0
        c = 4.0 * span
        row_band = keys[:, sdim] * c + bvals
        qorder = torch.argsort(qb, stable=True)
        queries = queries[:, qorder]
        q_band = (queries[:, :, sdim] * c
                  + queries[:, :, band_dim]).reshape(a * qa)
        # composite keys reach ~A*c: pad the band test by their f32
        # rounding so quantization only loosens the prune
        w0 = w0 + 32.0 * c * 1.2e-7
    sk = torch.where(valid, row_band, _PAD)
    order = torch.argsort(sk, stable=True)
    ops = _sorted_operands(keys[order], values[order], valid[order],
                           sk[order], queries.reshape(a * qa, d), q_band,
                           w, w0)
    return ops, qorder


def box_query_moments_grouped(keys: torch.Tensor,         # [N, D]
                              values: torch.Tensor,       # [N]
                              valid: torch.Tensor,        # [N] bool
                              queries: torch.Tensor,      # [A, Qa, D]
                              half_widths: torch.Tensor,  # [D]
                              action_dim: int = -1,
                              band_dim: "int | None" = 1) -> torch.Tensor:
    """[A, Qa, 3] moments of action-grouped queries (every group holds
    the same envs) through the sorted-band kernel
    (``pallas_store.py::box_query_moments_grouped``)."""
    a, qa, _ = queries.shape
    if a * qa == 0:
        return torch.zeros((a, qa, 3), device=queries.device)
    ops, qorder = grouped_query_operands(keys, values, valid, queries,
                                         half_widths, action_dim, band_dim)
    out = sorted_moments(ops).reshape(a, qa, 3)
    if qorder is not None:
        out = torch.empty_like(out).index_copy_(1, qorder, out)
    return out


# ---------------------------------------------------------------------------
# Brute-force [Q, 3] moments (csrc/box_moments.cu)
# ---------------------------------------------------------------------------


class BruteOperands(NamedTuple):
    q_t: torch.Tensor     # [D, q_pad] f32 queries, padding +inf
    keys_t: torch.Tensor  # [D, n_pad] f32 rows, padding 0
    vals: torch.Tensor    # [n_pad] f32
    valid: torch.Tensor   # [n_pad] f32 1 / 0 (0 on padding)
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
    # padded queries are +inf: they match nothing
    q_t = torch.full((d, q_pad), torch.inf, dtype=torch.float32, device=dev)
    q_t[:, :q] = queries.T
    return BruteOperands(q_t=q_t, keys_t=keys_t, vals=vals, valid=valid_f,
                         w=half_widths.to(dev, torch.float32).contiguous())


def launch_brute(ops: BruteOperands) -> torch.Tensor:
    """Launch ``csrc/box_moments.cu`` on the current stream: [q_pad, 3]
    moments (operands checked by the caller)."""
    d, q_pad = ops.q_t.shape
    out = torch.empty((q_pad, 3), dtype=torch.float32, device=ops.q_t.device)
    fn = _cuda.load("box_moments").box_moments
    p = ctypes.c_void_p
    err = fn(p(ops.q_t.data_ptr()), p(ops.keys_t.data_ptr()),
             p(ops.vals.data_ptr()), p(ops.valid.data_ptr()),
             p(ops.w.data_ptr()), q_pad, ops.keys_t.shape[1], d,
             p(out.data_ptr()),
             p(torch.cuda.current_stream(ops.q_t.device).cuda_stream))
    if err != 0:
        raise RuntimeError(f"box_moments launch failed: CUDA error {err}")
    _cuda.LAUNCHES["box_moments"] += 1
    return out


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
