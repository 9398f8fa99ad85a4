"""Plain reference of the confidence store: the box query, the Welch
z-test gate, the trajectory records and the ring insert.

Semantics (zhcao92/DCARL ``RLS.py``): a stored row (key, value) counts
for a query when ``|key_d - q_d| <= w_d`` in every dimension, tested in
float32 as the configuration states; the moments are the count, the sum
and the sum of squares of the matched values, summed here in float64
(``precision="f64"``) or, for the control, in float32 over values
rounded to TF32 (``precision="tf32"``: what a TF32 matrix product of
the containment mask and ``[1, v, v^2]`` gives).  A fourth column, the
sum of ``|v|``, is the scale the sums' errors are measured against.
"""

from __future__ import annotations

import math
from typing import Dict, Tuple

import torch


def tf32(x: torch.Tensor) -> torch.Tensor:
    """``x`` (float32) rounded to TF32's 10 explicit mantissa bits,
    to nearest, ties to even."""
    i = x.to(torch.float32).contiguous().view(torch.int32)
    lsb = (i >> 13) & 1
    i = (i + 0xFFF + lsb) & -8192
    return i.view(torch.float32)


def observation(ego: torch.Tensor, walker: torch.Tensor,
                vehicles: torch.Tensor, in_state) -> torch.Tensor:
    """[K, 20] world-frame observation of K envs from their state
    (``ego`` [5, K], ``walker`` [5, K], ``vehicles`` [V, 5, K]): the ego,
    the walker, then the in-state vehicles in index order
    (``TestScenario_Town03.py``'s spawn order)."""
    rows = [ego, walker] + [vehicles[i] for i in in_state]
    return torch.cat(rows, dim=0).T.contiguous()


def _features(values: torch.Tensor, valid: torch.Tensor, precision: str):
    v = values.to(torch.float32)
    if precision == "f64":
        v = v.to(torch.float64)
        f = torch.stack([torch.ones_like(v), v, v * v, v.abs()], dim=1)
    elif precision == "tf32":
        f = torch.stack([torch.ones_like(v), tf32(v), tf32(v * v),
                         v.abs()], dim=1)
    else:
        raise ValueError(f"unknown precision {precision!r}")
    return f * valid[:, None].to(f.dtype)                       # [N, 4]


def box_moments(keys: torch.Tensor, values: torch.Tensor,
                valid: torch.Tensor, queries: torch.Tensor,
                half_widths: torch.Tensor, num_actions: int = 0,
                precision: str = "f64", block: int = 16) -> torch.Tensor:
    """Moments (count, sum, sum of squares, sum of |v|) of the rows whose
    boxes contain each query.

    ``num_actions == 0``: ``queries`` [Q, D] are whole keys, result
    [Q, 4].  Otherwise ``queries`` [Q, D - 1] are observations and the
    result [Q, A, 4] holds the moments of each candidate key ``obs || a``
    for a = 0..A-1.  Computed ``block`` queries at a time."""
    keys = keys.to(torch.float32)
    hw = half_widths.to(device=keys.device, dtype=torch.float32)
    d_test = keys.shape[1] if num_actions == 0 else keys.shape[1] - 1
    feats = _features(values, valid, precision)
    if num_actions:
        cand = torch.arange(num_actions, dtype=torch.float32,
                            device=keys.device)
        act = (keys[:, -1:] - cand[None, :]).abs() <= hw[-1]    # [N, A]
        feats = (act[:, :, None].to(feats.dtype) * feats[:, None, :]
                 ).reshape(keys.shape[0], -1)                    # [N, 4A]
    keys_t = keys.T.contiguous()                                 # [D, N]
    q = queries.to(torch.float32)
    out = []
    for s in range(0, q.shape[0], block):
        qb = q[s:s + block]
        mask = torch.ones((qb.shape[0], keys.shape[0]), dtype=torch.bool,
                          device=keys.device)
        for d in range(d_test):
            mask &= (keys_t[d][None, :] - qb[:, d, None]).abs() <= hw[d]
        out.append(mask.to(feats.dtype) @ feats)
    m = torch.cat(out) if out else feats.new_zeros((0, feats.shape[1]))
    m = m.to(torch.float64)
    return m if num_actions == 0 else m.reshape(q.shape[0], num_actions, 4)


def sum_errors(port: torch.Tensor, ref: torch.Tensor) -> Tuple[int, float]:
    """(count mismatches, largest sum error) of the port's moments
    ``port`` [..., 3] against ``ref`` [..., 4]: counts must be equal; the
    error of the sum is taken against the sum of |v| and that of the sum
    of squares against itself (0 where both are 0, inf where only the
    port's is not)."""
    port = port.to(torch.float64)
    counts = int((port[..., 0] != ref[..., 0]).sum())
    worst = 0.0
    for col, scale in ((1, ref[..., 3]), (2, ref[..., 2])):
        diff = (port[..., col] - ref[..., col]).abs()
        err = torch.where(scale > 0, diff / scale.clamp(min=1e-300),
                          torch.where(diff > 0, math.inf, 0.0))
        if err.numel():
            worst = max(worst, float(err.max()))
    return counts, worst


def gate(moments: torch.Tensor, cfg: Dict) -> torch.Tensor:
    """[Q] the Welch z-test gate of ``RLS.act_test`` in float32 on
    per-action moments ``moments`` [Q, A, >=3] (rounded to float32 first,
    as a float32 answer is): 0 follows the rule; else the lowest action
    that is well enough visited, whose rule is not already good enough,
    and whose mean beats the rule's with ``Phi(z) > confidence_thres``."""
    m = moments[..., :3].to(torch.float32)
    count = m[..., 0]
    n = count.clamp(min=1.0)
    mean = m[..., 1] / n
    var = (m[..., 2] / n - mean * mean).clamp(min=0.0)
    empty = count == 0
    mean = torch.where(empty, -1.0, mean)
    var = torch.where(empty, -1.0, var)
    r_count, r_mean, r_var = count[:, :1], mean[:, :1], var[:, :1]
    eligible = ((r_count >= cfg["visited_times_thres"])
                & (count >= cfg["rl_visited_times_min"])
                & (r_mean <= cfg["rule_good_thres"]))
    var_diff = r_var / r_count.clamp(min=1.0) + var / count.clamp(min=1.0)
    z = (mean - r_mean) / var_diff.clamp(min=1e-12).sqrt()
    passes = eligible & (torch.special.ndtr(z) > cfg["confidence_thres"])
    passes[:, 0] = False
    first = torch.argmax(passes.to(torch.uint8), dim=1)
    return torch.where(passes.any(dim=1), first, 0)


# ---------------------------------------------------------------------------
# Trajectory records and the ring insert (RLS.py:185-215, value_mode
# "reference": a flushed entry keeps its own reward; at an episode's end
# every entry of the window is recorded with the terminal reward
# discounted back to it)
# ---------------------------------------------------------------------------


def records(traj_obs, traj_act, traj_rew, traj_len, obs, action, reward,
            done, gamma: float):
    """The records one step writes, from each env's window before the
    step (``traj_obs`` [W, D, B], ``traj_act`` / ``traj_rew`` [W, B],
    ``traj_len`` [B]) and the step's (obs [D, B], action, reward, done).

    Returns ``(flush, backfill)``: ``flush`` = (keys [B, D+1], actions
    [B], values [B], valid [B]); ``backfill`` the same with [B, W] rows,
    env-major."""
    w, d, b = traj_obs.shape
    length = traj_len.to(torch.int64)
    full = length >= w
    dev = traj_obs.device
    new_obs = traj_obs.clone()
    new_act = traj_act.to(torch.float64).clone()
    new_rew = traj_rew.to(torch.float64).clone()
    shifted = full.nonzero()[:, 0]
    new_obs[:, :, shifted] = torch.roll(traj_obs[:, :, shifted], -1, 0)
    new_act[:, shifted] = torch.roll(new_act[:, shifted], -1, 0)
    new_rew[:, shifted] = torch.roll(new_rew[:, shifted], -1, 0)
    at = length.clamp(max=w - 1)
    envs = torch.arange(b, device=dev)
    new_obs[at, :, envs] = obs.T.to(new_obs.dtype)
    new_act[at, envs] = action.to(torch.float64)
    new_rew[at, envs] = reward.to(torch.float64)
    length2 = (length + 1).clamp(max=w)

    flush = (torch.cat([traj_obs[0].T, traj_act[0][:, None].to(
                 traj_obs.dtype)], dim=1),
             traj_act[0].to(torch.float64), traj_rew[0].to(torch.float64),
             full)
    terminal = new_rew[length2 - 1, envs]                       # [B]
    i = torch.arange(w, device=dev)[None, :]                    # [1, W]
    expo = (length2[:, None] - 1 - i).clamp(min=0)
    back_values = terminal[:, None] * torch.tensor(
        gamma, dtype=torch.float64, device=dev) ** expo         # [B, W]
    back_keys = torch.cat([new_obs.permute(2, 0, 1),
                           new_act.T[:, :, None].to(new_obs.dtype)], dim=2)
    back_valid = done.to(torch.bool)[:, None] & (i < length2[:, None])
    return flush, (back_keys, new_act.T, back_values, back_valid)


def compact(rows, budget: int):
    """The valid rows of ``rows`` = (keys [M, D], actions, values, valid
    [M]) moved to the front of a ``budget``-row block, in order; rows past
    the budget are dropped."""
    keys, actions, values, valid = rows
    idx = valid.nonzero()[:, 0][:budget]
    n = idx.numel()
    out_k = keys.new_zeros((budget,) + tuple(keys.shape[1:]))
    out_a = actions.new_zeros((budget,))
    out_v = values.new_zeros((budget,))
    out_k[:n], out_a[:n], out_v[:n] = keys[idx], actions[idx], values[idx]
    mask = torch.arange(budget, device=keys.device) < n
    return out_k, out_a, out_v, mask


def ring_insert(store, rows):
    """The store (keys [N, D], actions [N], values [N], size, head) after
    appending the valid rows of ``rows`` = (keys, actions, values, valid)
    at ``head`` onwards, oldest rows overwritten once full; a batch of
    more valid rows than the capacity keeps its newest."""
    keys, actions, values, size, head = store
    cap = keys.shape[0]
    nk, na, nv, valid = rows
    idx = valid.nonzero()[:, 0]
    idx = idx[max(0, idx.numel() - cap):]
    n = idx.numel()
    slots = (head + torch.arange(n, device=keys.device)) % cap
    keys, actions, values = keys.clone(), actions.clone(), values.clone()
    keys[slots] = nk[idx].to(keys.dtype)
    actions[slots] = na[idx].to(actions.dtype)
    values[slots] = nv[idx].to(values.dtype)
    return keys, actions, values, min(size + n, cap), (head + n) % cap
