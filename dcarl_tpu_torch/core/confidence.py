"""Confidence bounds and tables: the algorithmic core of DCARL
(``dcarl_tpu/core/confidence.py``).

Per (state, action) cell DCARL keeps value samples and scores the cell
with an optimistic upper Hoeffding bound for the rule action and a
pessimistic min(lower, CI-lower) bound for every other action; the
policy is the argmax over the bounds (the "TSRL value").  The reference
demos are Simulation_testing/Simulation_1/test_DCARL.py:10-28 (the
estimators) and :73-102 (the stream loop).

``GoldenTable`` keeps every sample and recomputes the visited cell's
two-pass mean and std each step, as the reference's ``np.mean`` /
``np.std`` over Python lists do; run it in float64 for golden fidelity.
:func:`golden_update` is one step of the stream loop; :func:`golden_run`
(the JAX package's ``lax.scan`` of it) runs the whole stream in a few
batched launches: every row's bound at once, then each row's decision
by a gather.

``RunningTable`` keeps (count, sum, sum of squares) per cell, the O(1)
form of the batched paths.

``torch.argmax`` returns the first of tied maxima, as ``np.argmax`` and
``jnp.argmax`` do; the priors tie every non-rule action at
``other_prior``, so this decides actions.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import ConfidenceConfig
from dcarl_tpu_torch.device import resolve_device


# ---------------------------------------------------------------------------
# Bound functions (elementwise on sufficient statistics)
# ---------------------------------------------------------------------------


def _sqrt_ratio(c: float, n):
    """sqrt(c / n) of a tensor ``n``, or of a host float (the golden
    loop's counts).  ``c / tensor`` in PyTorch multiplies by the
    reciprocal, which rounds differently: divide a tensor instead."""
    if isinstance(n, torch.Tensor):
        return torch.sqrt(torch.full_like(n, c) / n)
    return math.sqrt(c / n)


def hoeffding_margin(n, alpha: float, scale: float):
    """scale * sqrt(log(1/alpha) / (2 n)): the Hoeffding deviation of a
    value supported on an interval of width ``scale``."""
    log_term = math.log(1.0 / alpha)
    return scale * _sqrt_ratio(log_term / 2.0, n)


def upper_bound(mean, n, cfg: ConfidenceConfig = ConfidenceConfig()):
    """Optimistic bound capped at ``value_max`` (test_DCARL.py:10-12)."""
    return torch.clamp(mean + hoeffding_margin(n, cfg.alpha, cfg.scale),
                       max=cfg.value_max)


def lower_bound(mean, n, cfg: ConfidenceConfig = ConfidenceConfig()):
    """Pessimistic Hoeffding bound (test_DCARL.py:14-16)."""
    return mean - hoeffding_margin(n, cfg.alpha, cfg.scale)


def ci_lower_bound(dsum, sigma, n, cfg: ConfidenceConfig = ConfidenceConfig()):
    """Empirical-Bernstein-style lower bound, term for term as the
    reference writes it (test_DCARL.py:18-24):
    dsum/n/(n+1) - 4 sigma/(n+1) + dsum/(n+1) - scale sqrt(log(1/a)/2/(n+1))."""
    log_term = math.log(1.0 / cfg.alpha)
    return (dsum / n / (n + 1.0)
            - 4.0 * sigma / (n + 1.0)
            + dsum / (n + 1.0)
            - cfg.scale * _sqrt_ratio(log_term / 2.0, n + 1.0))


def mean_value(mean, cfg: ConfidenceConfig = ConfidenceConfig()):
    """Capped empirical mean (test_DCARL.py:26-28)."""
    return torch.clamp(mean, max=cfg.value_max)


def tsrl_bound(mean, dsum, sigma, n, action_is_rule, cfg: ConfidenceConfig):
    """The TSRL value of a cell: the upper bound for the rule action,
    min(lower, CI-lower) otherwise (test_DCARL.py:86-90).
    ``action_is_rule`` is a bool tensor, or a host bool (then only the
    bound it picks is computed)."""
    if isinstance(action_is_rule, bool) and action_is_rule:
        return upper_bound(mean, n, cfg)
    lb = torch.minimum(lower_bound(mean, n, cfg),
                       ci_lower_bound(dsum, sigma, n, cfg))
    if isinstance(action_is_rule, bool):
        return lb
    return torch.where(action_is_rule, upper_bound(mean, n, cfg), lb)


# ---------------------------------------------------------------------------
# Golden table: exact per-step recomputation over sample buffers
# ---------------------------------------------------------------------------


class GoldenTable(NamedTuple):
    """Full-sample confidence table.  ``counts`` and ``seen`` are host
    arrays (they follow from the stream's indices alone); the rest are
    tensors on the table's device."""

    values: torch.Tensor           # [S, A, CAP] sample buffers
    counts: np.ndarray             # [S, A] i32 samples per cell (host)
    tsrl: torch.Tensor             # [S, A] confidence values
    seen: np.ndarray               # [S] i32 per-state stream counter (host)
    activation_step: torch.Tensor  # [S] i32, -1 until the first non-rule argmax
    activation_value: torch.Tensor  # [S] (the reference keeps it at -1)


def golden_init(state_num: int, action_num: int, capacity: int,
                cfg: ConfidenceConfig = ConfidenceConfig(),
                dtype=torch.float64, device=None) -> GoldenTable:
    """Rule action optimistic (``rule_prior``), the others
    ``other_prior`` (test_DCARL.py:47-53)."""
    device = resolve_device(device)
    tsrl = torch.full((state_num, action_num), cfg.other_prior, dtype=dtype,
                      device=device)
    tsrl[:, cfg.rule_action] = cfg.rule_prior
    return GoldenTable(
        values=torch.zeros((state_num, action_num, capacity), dtype=dtype,
                           device=device),
        counts=np.zeros((state_num, action_num), np.int32),
        tsrl=tsrl,
        seen=np.zeros((state_num,), np.int32),
        activation_step=torch.full((state_num,), -1, dtype=torch.int32,
                                   device=device),
        activation_value=torch.full((state_num,), -1.0, dtype=dtype,
                                    device=device))


class StepOutput(NamedTuple):
    state_idx: torch.Tensor      # i32
    step_value: torch.Tensor     # max TSRL value at the visited state
    tsrl_action: torch.Tensor    # i32 argmax action at the visited state
    true_value: torch.Tensor     # ground-truth value of the selected action
    overall_value: torch.Tensor  # Sim-2 improvement accounting


def _masked_moments(buffer: torch.Tensor, n: int):
    """Two-pass mean and std of the first ``n`` entries, as ``np.mean``
    and ``np.std`` over a bucket of length n: (mean, sum, sigma)."""
    bucket = buffer[:n]
    dsum = bucket.sum()
    mean = dsum / n
    sigma = torch.sqrt(((bucket - mean) ** 2).sum() / n)
    return mean, dsum, sigma


def golden_update(table: GoldenTable, state_idx: int, action: int,
                  value: torch.Tensor, true_action_values: torch.Tensor,
                  cfg: ConfidenceConfig = ConfidenceConfig()
                  ) -> Tuple[GoldenTable, StepOutput]:
    """Ingest one (state, action, value) sample (host ints and a 0-d
    tensor), refresh the visited cell's value once its bucket exceeds
    ``n_thres``, and pick the TSRL action of the visited state
    (test_DCARL.py:73-105).  Updates ``table`` in place and returns it."""
    s, a = int(state_idx), int(action)
    c = int(table.counts[s, a])
    table.values[s, a, c] = value
    n = c + 1
    table.counts[s, a] = n
    if n > cfg.n_thres:
        mean, dsum, sigma = _masked_moments(table.values[s, a], n)
        table.tsrl[s, a] = tsrl_bound(mean, dsum, sigma, float(n),
                                      a == cfg.rule_action, cfg)

    row = table.tsrl[s]
    tsrl_action = torch.argmax(row)            # the first of tied maxima
    step_value = row.amax()
    true_value = true_action_values[s].index_select(0, tsrl_action[None])[0]

    table.seen[s] += 1
    act = table.activation_step
    activated_now = (act[s] == -1) & (tsrl_action != cfg.rule_action)
    act[s] = torch.where(activated_now, int(table.seen[s]), act[s])

    # Sim-2 overall-value accounting (Simulation_2/test_DCARL.py:99-105)
    active = act != -1
    overall = torch.where(active, table.tsrl.amax(dim=1)
                          - table.activation_value * 0.9, 0.0).sum()
    out = StepOutput(torch.full((), s, dtype=torch.int32, device=act.device),
                     step_value,
                     tsrl_action.to(torch.int32), true_value, overall)
    return table, out


def _occurrence(x: np.ndarray) -> np.ndarray:
    """For each entry, how many earlier entries hold the same value."""
    order = np.argsort(x, kind="stable")
    xs = x[order]
    start = np.r_[0, np.flatnonzero(xs[1:] != xs[:-1]) + 1]
    rank = np.arange(len(x)) - np.repeat(start, np.diff(np.r_[start, len(x)]))
    out = np.empty_like(rank)
    out[order] = rank
    return out


def golden_run(data, true_action_values, action_num: Optional[int] = None,
               capacity: Optional[int] = None,
               cfg: ConfidenceConfig = ConfidenceConfig(),
               device=None) -> Tuple[GoldenTable, StepOutput]:
    """The demo stream loop: ``data`` [N, 4] rows [state_idx,
    state_scalar, action_idx, sampled_value], ``true_action_values``
    [S, A_true], as numpy arrays or tensors.  Runs in float64 on
    ``device`` (``cuda`` unless the caller passes ``device="cpu"``);
    returns the final table and the per-step outputs stacked to [N].

    The result is that of :func:`golden_update` applied row by row (the
    JAX package's ``lax.scan``), computed for all rows at once.  A row
    writes only its own cell, whose bound reads only the prefix of the
    cell's bucket that the rows before it filled: every sample goes into
    its slot first, and each row's masked two-pass moments are one
    ``[rows, CAP]`` computation.  A row's decision reads its state's
    table row, whose cells hold the bound of each cell's latest update
    up to that row: a running maximum over the rows sorted by state
    finds it, and the decision is a gather.  The stream's indices are
    read to the host once, so the buckets' fill counts and the visit
    counters are known before any work on the device.  Activation steps
    and the overall value follow from the per-row decisions."""
    device = resolve_device(device)
    data = torch.as_tensor(data).to(device, torch.float64)
    tav = torch.as_tensor(true_action_values).to(device, torch.float64)
    state_num = tav.shape[0]
    if action_num is None:
        action_num = tav.shape[1]
    if capacity is None:
        raise ValueError("capacity must be provided (max per-cell bucket size)")
    table = golden_init(state_num, action_num, capacity, cfg, device=device)
    prior = table.tsrl[0].clone()
    n_rows = data.shape[0]
    idx = data[:, [0, 2]].to(torch.int64).cpu().numpy()
    st, ac = idx[:, 0], idx[:, 1]
    slot = _occurrence(st * action_num + ac)   # the row's place in its bucket
    visit = _occurrence(st)                    # the row's visit of its state
    np.add.at(table.counts, (st, ac), 1)
    table.seen[:] = np.bincount(st, minlength=state_num)

    def up(a, dt=torch.int64):
        return torch.as_tensor(np.ascontiguousarray(a)).to(device, dt)

    s_t, a_t, c_t = up(st), up(ac), up(slot)
    n_t = up(slot + 1, torch.float64)
    table.values[s_t, a_t, c_t] = data[:, 3]

    # each row's bound of its own cell, in blocks of about 2^22 entries
    bound = torch.empty(n_rows, dtype=torch.float64, device=device)
    iota = torch.arange(capacity, device=device)
    block = max(1, (1 << 22) // capacity)
    for lo in range(0, n_rows, block):
        s, a, n = s_t[lo:lo + block], a_t[lo:lo + block], n_t[lo:lo + block]
        bucket = table.values[s, a]                          # [W, CAP]
        mask = iota < n[:, None]
        dsum = torch.where(mask, bucket, 0.0).sum(1)
        mean = dsum / n
        sigma = torch.sqrt(torch.where(mask, (bucket - mean[:, None]) ** 2,
                                       0.0).sum(1) / n)
        bound[lo:lo + block] = tsrl_bound(mean, dsum, sigma, n,
                                          a == cfg.rule_action, cfg)

    # rows sorted by state: position p of the sorted stream; hit[p, a] = p
    # where the row refreshes its cell (s, a), and the running maximum is
    # the latest refresh of each cell at or before p (within the state's
    # segment, else the cell still holds its prior)
    order = np.argsort(st, kind="stable")
    seg_start = np.searchsorted(st[order], st[order])
    refresh = up((slot + 1 > cfg.n_thres)[order], torch.bool)
    pos = torch.arange(n_rows, device=device)
    hit = torch.where((a_t[up(order)][:, None]
                       == torch.arange(action_num, device=device))
                      & refresh[:, None], pos[:, None], -1)
    last = hit.cummax(0).values                              # [N, A]
    held = last >= up(seg_start)[:, None]
    rows_sorted = torch.where(
        held, bound[up(order)][last.clamp(min=0)], prior)    # [N, A]
    rows = torch.empty_like(rows_sorted).index_copy_(0, up(order),
                                                     rows_sorted)
    step_value = rows.amax(1)
    tsrl_action = torch.argmax(rows, 1)                     # first of ties
    seg_last = np.r_[np.flatnonzero(np.diff(st[order])), n_rows - 1]
    table.tsrl[up(st[order][seg_last])] = rows_sorted[up(seg_last)]

    # activation: a state's first visit whose decision leaves the rule
    # action; act_rows[k, s] is the row of state s's k-th visit (n_rows
    # past its last)
    n_visits = int(visit.max()) + 1
    act_rows = np.full((n_visits, state_num), n_rows, np.int64)
    act_rows[visit, st] = np.arange(n_rows)
    act_rows = up(act_rows)
    left_rule = torch.cat([tsrl_action != cfg.rule_action,
                           torch.zeros(1, dtype=torch.bool, device=device)])
    flags = left_rule[act_rows]                              # [K, S]
    first = torch.argmax(flags.to(torch.uint8), 0)
    activated = flags.any(0)
    table.activation_step.copy_(torch.where(activated, first + 1, -1))
    act_row = torch.where(activated, act_rows.gather(0, first[None])[0],
                          n_rows)

    # the Sim-2 overall value after each row: the active states' current
    # maxima, each from the state's latest visit
    rows_i = torch.arange(n_rows, device=device)
    latest = torch.where(s_t[:, None] == torch.arange(state_num,
                                                      device=device),
                         rows_i[:, None], 0).cummax(0).values   # [N, S]
    active = act_row[None, :] <= rows_i[:, None]
    overall = torch.where(active, step_value[latest]
                          - table.activation_value * 0.9, 0.0).sum(1)

    out = StepOutput(s_t.to(torch.int32), step_value,
                     tsrl_action.to(torch.int32), tav[s_t, tsrl_action],
                     overall)
    return table, out


def required_capacity(data, state_num: int, action_num: int) -> int:
    """The largest per-(state, action) bucket of a dataset, rounded up
    to a multiple of 8."""
    arr = np.asarray(data)
    flat = arr[:, 0].astype(np.int64) * action_num + arr[:, 2].astype(np.int64)
    counts = np.bincount(flat, minlength=state_num * action_num)
    return (int(counts.max()) + 7) // 8 * 8


# ---------------------------------------------------------------------------
# Running table: O(1)-memory sufficient statistics
# ---------------------------------------------------------------------------


class RunningTable(NamedTuple):
    """Per-cell running (count, sum, sum of squares); mean and variance
    in closed form."""

    count: torch.Tensor  # [..., S, A] i32
    total: torch.Tensor  # [..., S, A]
    sumsq: torch.Tensor  # [..., S, A]
    tsrl: torch.Tensor   # [..., S, A]


def running_init(shape, cfg: ConfidenceConfig = ConfidenceConfig(),
                 dtype=torch.float32, device=None) -> RunningTable:
    """``shape`` = (..., state_num, action_num)."""
    device = resolve_device(device)
    tsrl = torch.full(tuple(shape), cfg.other_prior, dtype=dtype, device=device)
    tsrl[..., cfg.rule_action] = cfg.rule_prior
    return RunningTable(
        count=torch.zeros(tuple(shape), dtype=torch.int32, device=device),
        total=torch.zeros(tuple(shape), dtype=dtype, device=device),
        sumsq=torch.zeros(tuple(shape), dtype=dtype, device=device),
        tsrl=tsrl)


def running_update(table: RunningTable, state_idx, action, value,
                   cfg: ConfidenceConfig = ConfidenceConfig()) -> RunningTable:
    """Add one sample to an [S, A] table and refresh the visited cell's
    bound (new tensors; ``state_idx`` and ``action`` are ints or 0-d
    tensors)."""
    s = torch.as_tensor(state_idx, device=table.count.device).to(torch.int64)
    a = torch.as_tensor(action, device=table.count.device).to(torch.int64)
    v = torch.as_tensor(value, device=table.total.device).to(table.total.dtype)
    count = table.count.index_put((s, a), torch.ones((), dtype=torch.int32,
                                                     device=s.device),
                                  accumulate=True)
    total = table.total.index_put((s, a), v, accumulate=True)
    sumsq = table.sumsq.index_put((s, a), v * v, accumulate=True)

    n = count[s, a]
    nf = n.to(total.dtype)
    dsum = total[s, a]
    mean = dsum / nf
    sigma = torch.sqrt(torch.clamp(sumsq[s, a] / nf - mean * mean, min=0.0))
    bound = tsrl_bound(mean, dsum, sigma, nf, a == cfg.rule_action, cfg)
    cell = torch.where(n > cfg.n_thres, bound, table.tsrl[s, a])
    return RunningTable(count, total, sumsq, table.tsrl.index_put((s, a), cell))


def running_update_batch(table: RunningTable, state_idx, action, value,
                         cfg: ConfidenceConfig = ConfidenceConfig()
                         ) -> RunningTable:
    """Add a whole batch of samples at once (order-free), then refresh
    every cell's bound.  ``table`` is [*lead, S, A] and the samples
    [*lead, N]: each leading index is an independent stream (the JAX
    package's ``vmap`` over streams)."""
    lead = table.count.shape[:-2]
    s_n, a_n = table.count.shape[-2:]
    dev, dtype = table.total.device, table.total.dtype
    state_idx = torch.as_tensor(state_idx, device=dev).to(torch.int64)
    action = torch.as_tensor(action, device=dev).to(torch.int64)
    value = torch.as_tensor(value, device=dev).to(dtype)
    n_streams = math.prod(lead)
    stream = torch.arange(n_streams, device=dev).reshape(*lead, 1)
    flat = ((stream * s_n + state_idx) * a_n + action).reshape(-1)
    value = value.reshape(-1)

    def add(buf, x):
        return buf.reshape(-1).index_add(0, flat, x).reshape(buf.shape)

    count = add(table.count, torch.ones_like(flat, dtype=torch.int32))
    total = add(table.total, value)
    sumsq = add(table.sumsq, value * value)
    tsrl = refresh_all_bounds(RunningTable(count, total, sumsq, table.tsrl),
                              cfg)
    return RunningTable(count, total, sumsq, tsrl)


def refresh_all_bounds(table: RunningTable,
                       cfg: ConfidenceConfig = ConfidenceConfig()
                       ) -> torch.Tensor:
    """Every cell's bound; cells at or below ``n_thres`` samples keep
    their prior or previous value."""
    nf = torch.clamp(table.count, min=1).to(table.total.dtype)
    mean = table.total / nf
    sigma = torch.sqrt(torch.clamp(table.sumsq / nf - mean * mean, min=0.0))
    is_rule = torch.arange(table.tsrl.shape[-1],
                           device=table.tsrl.device) == cfg.rule_action
    bound = tsrl_bound(mean, table.total, sigma, nf, is_rule, cfg)
    return torch.where(table.count > cfg.n_thres, bound, table.tsrl)


def select_actions(tsrl: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """argmax (the first of tied maxima) and max over the action axis:
    the TSRL policy."""
    return torch.argmax(tsrl, dim=-1).to(torch.int32), tsrl.amax(dim=-1)
