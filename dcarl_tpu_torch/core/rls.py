"""RLS: the confidence gate and the dataset builder.

* test mode (``act_test``, RLS.py:120-157): for candidates 1..A-1 of
  every env, a Welch z-test of the candidate's stored value distribution
  against the rule action's;
* train mode (``act_train``, RLS.py:84-118): force the rule action when
  it is under-explored or performing well against an explore draw;
* dataset building (``traj_buffer_push`` and its lane-major twin
  ``traj_push_lane``, RLS.py:185-215): an n-step window whose oldest
  entry flushes with its own reward, and a terminal backfill.

Randomness comes in as draws (the explore uniform of the train gate), so
a caller can feed both packages the same numbers.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import torch

from dcarl_tpu_torch.config import StoreConfig
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.core.store import (ConfidenceStore, _raw_moments,
                                        box_query_stats, moments_to_stats,
                                        store_insert, store_valid)


def state_with_action(obs: torch.Tensor, action) -> torch.Tensor:
    """state || action key (RLS.py:96-98), batched over leading dims."""
    a = torch.as_tensor(action, device=obs.device).to(obs.dtype)
    return torch.cat([obs, a.expand(obs.shape[:-1])[..., None]], dim=-1)


def candidate_keys(obs: torch.Tensor, num_actions: int) -> torch.Tensor:
    """[..., A, D+1] keys ``obs || a`` for actions 0..A-1."""
    a = torch.arange(num_actions, dtype=obs.dtype, device=obs.device)
    obs_b = obs[..., None, :].expand(*obs.shape[:-1], num_actions,
                                     obs.shape[-1])
    a_b = a.expand(*obs.shape[:-1], num_actions)
    return torch.cat([obs_b, a_b[..., None]], dim=-1)


class ActionStats(NamedTuple):
    """Per-(env, action) store statistics."""

    count: torch.Tensor  # [..., A]
    mean: torch.Tensor
    var: torch.Tensor
    sigma: torch.Tensor


def all_action_stats(store: ConfidenceStore, obs: torch.Tensor,
                     half_widths: torch.Tensor, num_actions: int,
                     use_kernel: Optional[bool] = None) -> ActionStats:
    """One store query for every action of every env ([B, A] stats)."""
    if use_kernel is None:
        use_kernel = obs.device.type == "cuda"
    if use_kernel:
        keys = candidate_keys(obs, num_actions)      # [B, A, D]
        stats = box_query_stats(store, keys.reshape(-1, keys.shape[-1]),
                                half_widths, use_kernel=True)
    else:
        stats = moments_to_stats(_raw_moments(
            store.keys, store.values, store_valid(store),
            obs.reshape(-1, obs.shape[-1]), half_widths, num_actions))
    shape = (*obs.shape[:-1], num_actions)
    return ActionStats(*(f.reshape(shape) for f in stats))


def act_test(stats: ActionStats, cfg: StoreConfig = StoreConfig()) -> torch.Tensor:
    """[B] i32 selected actions (0 = follow the rule pick).

    A candidate is eligible when the rule is well explored, the
    candidate has at least ``rl_visited_times_min`` visits and the rule
    is not already near-optimal; it passes when ``Phi(z) >
    confidence_thres``.  ``select_mode="first"`` returns the lowest
    passing index (the reference's ascending loop), ``"best"`` the
    highest z."""
    count = stats.count.to(stats.mean.dtype)
    rule_count = count[..., 0:1]
    rule_mean = stats.mean[..., 0:1]
    rule_var = stats.var[..., 0:1]

    eligible = ((rule_count >= cfg.visited_times_thres)
                & (count >= cfg.rl_visited_times_min)
                & (rule_mean <= cfg.rule_good_thres))

    var_diff = rule_var / torch.clamp(rule_count, min=1.0) \
        + stats.var / torch.clamp(count, min=1.0)
    sigma_diff = torch.sqrt(torch.clamp(var_diff, min=1e-12))
    z = (stats.mean - rule_mean) / sigma_diff
    passes = eligible & (torch.special.ndtr(z) > cfg.confidence_thres)
    passes[..., 0] = False  # action 0 is the fallback

    any_pass = passes.any(dim=-1)
    if cfg.select_mode == "best":
        pick = torch.argmax(torch.where(passes, z, -torch.inf), dim=-1)
    else:
        pick = torch.argmax(passes.to(torch.uint8), dim=-1)
    return torch.where(any_pass, pick, 0).to(torch.int32)


def should_use_rule(stats: ActionStats, explore: torch.Tensor,
                    cfg: StoreConfig = StoreConfig()) -> torch.Tensor:
    """Train-mode gate (RLS.py:100-118): the rule is under-explored, or
    performing well against ``explore``, the caller's U(explore_low,
    explore_high) draw of shape ``stats.mean[..., 0]``."""
    under_explored = stats.count[..., 0] < cfg.visited_times_thres
    return under_explored | (explore < stats.mean[..., 0])


def act_train(stats: ActionStats, rl_action: torch.Tensor,
              explore: torch.Tensor,
              cfg: StoreConfig = StoreConfig()) -> torch.Tensor:
    """act_train (RLS.py:84-90): 0 where the rule is used, else the RL
    action (i32)."""
    use_rule = should_use_rule(stats, explore, cfg)
    return torch.where(use_rule, 0, rl_action).to(torch.int32)


# ---------------------------------------------------------------------------
# Trajectory buffer: n-step flush + terminal backfill (RLS.py:185-215)
# ---------------------------------------------------------------------------


class TrajectoryBuffer(NamedTuple):
    """One env's window of the last <= ``window`` transitions."""

    obs: torch.Tensor     # [W, D_obs]
    action: torch.Tensor  # [W]
    reward: torch.Tensor  # [W]
    length: torch.Tensor  # [] i32


def traj_buffer_init(window: int, obs_dim: int, dtype=torch.float32,
                     device=None) -> TrajectoryBuffer:
    device = resolve_device(device)
    return TrajectoryBuffer(
        obs=torch.zeros((window, obs_dim), dtype=dtype, device=device),
        action=torch.zeros((window,), dtype=dtype, device=device),
        reward=torch.zeros((window,), dtype=dtype, device=device),
        length=torch.zeros((), dtype=torch.int32, device=device))


class FlushRecords(NamedTuple):
    """Slot 0 is the steady-state flush, slots 1..W the terminal
    backfill."""

    keys: torch.Tensor     # [W+1, D_obs + 1]
    actions: torch.Tensor  # [W+1]
    values: torch.Tensor   # [W+1]
    valid: torch.Tensor    # [W+1] bool


def _suffix_discount(w: int, gamma: float, dtype, device) -> torch.Tensor:
    """[W, W] ``gamma^(j-i)`` for j >= i, else 0."""
    idx = torch.arange(w, device=device)
    e = torch.clamp(idx[None, :] - idx[:, None], min=0).to(dtype)
    return torch.full((), gamma, dtype=dtype, device=device) ** e \
        * (idx[None, :] >= idx[:, None])


def traj_buffer_push(buf: TrajectoryBuffer, obs: torch.Tensor,
                     action: torch.Tensor, reward: torch.Tensor,
                     done: torch.Tensor, cfg: StoreConfig = StoreConfig()
                     ) -> Tuple[TrajectoryBuffer, FlushRecords]:
    """Append one transition and emit records (one env; the readable
    twin of :func:`traj_push_lane`): while the window is over-full its
    oldest entry flushes; on ``done`` every remaining entry is recorded
    with the backfill value of ``cfg.value_mode``."""
    w = buf.obs.shape[0]
    if w != cfg.n_step_window:
        raise ValueError("buffer window must match cfg.n_step_window")
    dt = buf.reward.dtype
    full = buf.length >= w
    obs_shift = torch.where(full, torch.roll(buf.obs, -1, 0), buf.obs)
    act_shift = torch.where(full, torch.roll(buf.action, -1), buf.action)
    rew_shift = torch.where(full, torch.roll(buf.reward, -1), buf.reward)
    flushed_obs, flushed_action = buf.obs[0], buf.action[0]
    flushed_reward = buf.reward[0]

    idx = torch.arange(w, device=buf.obs.device)
    oh = idx == torch.clamp(buf.length, max=w - 1)
    new_obs = torch.where(oh[:, None], obs.to(obs_shift.dtype), obs_shift)
    new_action = torch.where(oh, torch.as_tensor(action).to(act_shift.dtype),
                             act_shift)
    new_reward = torch.where(oh, torch.as_tensor(reward).to(dt), rew_shift)
    length = torch.clamp(buf.length + 1, max=w)

    flush_valid = full & (cfg.value_mode != "episode")
    if cfg.value_mode in ("nstep", "episode"):
        g = torch.full((), cfg.gamma, dtype=dt, device=idx.device)
        in_ep = (idx < length).to(dt)
        flushed_reward = flushed_reward + torch.sum(
            g ** (idx + 1).to(dt) * new_reward * in_ep)
        disc = _suffix_discount(w, cfg.gamma, dt, idx.device) * in_ep[None, :]
        # elementwise products and a sum: full precision whatever the
        # TF32 switches say
        backfill_values = (disc * new_reward[None, :]).sum(1)
    else:
        # a gather, not ``new_reward[length - 1]``: indexing with a device
        # scalar reads it back to the host
        terminal_reward = new_reward.gather(
            0, (length - 1).reshape(1).to(torch.int64))[0]
        exponent = torch.clamp(length - 1 - idx, min=0).to(dt)
        backfill_values = terminal_reward * cfg.gamma ** exponent
    backfill_valid = done & (idx < length)

    keys = torch.cat([state_with_action(flushed_obs, flushed_action)[None],
                      state_with_action(new_obs, new_action)])
    recs = FlushRecords(
        keys=keys,
        actions=torch.cat([flushed_action[None], new_action]),
        values=torch.cat([flushed_reward[None], backfill_values]),
        valid=torch.cat([flush_valid.reshape(1), backfill_valid]))
    length = torch.where(torch.as_tensor(done), 0, length).to(torch.int32)
    return TrajectoryBuffer(new_obs, new_action, new_reward, length), recs


def insert_records(store: ConfidenceStore, recs: FlushRecords
                   ) -> ConfidenceStore:
    """Append a (possibly batched) set of flush records to the store."""
    return store_insert(store, recs.keys.reshape(-1, recs.keys.shape[-1]),
                        recs.actions.reshape(-1), recs.values.reshape(-1),
                        recs.valid.reshape(-1))


class LaneRecords(NamedTuple):
    """Lane-major twin of :class:`FlushRecords`: row 0 is the steady
    flush, rows 1..W the terminal backfill, batch on the LAST axis."""

    keys: torch.Tensor     # [W+1, D_obs + 1, B]
    actions: torch.Tensor  # [W+1, B]
    values: torch.Tensor   # [W+1, B]
    valid: torch.Tensor    # [W+1, B] bool


def traj_push_lane(buf_obs: torch.Tensor,   # [W, D_obs, B]
                   buf_act: torch.Tensor,   # [W, B]
                   buf_rew: torch.Tensor,   # [W, B]
                   length: torch.Tensor,    # [B] i32
                   obs: torch.Tensor,       # [D_obs, B]
                   action: torch.Tensor,    # [B]
                   reward: torch.Tensor,    # [B]
                   done: torch.Tensor,      # [B] bool
                   cfg: StoreConfig = StoreConfig()):
    """Lane-major (batch-last) :func:`traj_buffer_push` for B envs at
    once, with the same record order (slot 0 flush, slots 1..W the
    window oldest first).  The window roll is one batch-shared slice
    concat and the write a one-hot select.

    Returns ``((buf_obs, buf_act, buf_rew, length), LaneRecords)``."""
    w, d_obs, b = buf_obs.shape
    if w != cfg.n_step_window:
        raise ValueError("buffer window must match cfg.n_step_window")
    dt = buf_rew.dtype
    dev = buf_obs.device
    action = action.to(buf_act.dtype)

    full = length >= w                                    # [B]
    if cfg.value_mode == "episode":
        # the window covers whole episodes (trainer-validated), so the
        # buffer is never full at a push: no roll
        obs_shift, act_shift, rew_shift = buf_obs, buf_act, buf_rew
    else:
        obs_shift = torch.where(full[None, None, :],
                                torch.cat([buf_obs[1:], buf_obs[:1]]), buf_obs)
        act_shift = torch.where(full[None, :],
                                torch.cat([buf_act[1:], buf_act[:1]]), buf_act)
        rew_shift = torch.where(full[None, :],
                                torch.cat([buf_rew[1:], buf_rew[:1]]), buf_rew)

    flushed_obs = buf_obs[0]                              # [D, B]
    flushed_action = buf_act[0]
    flushed_reward = buf_rew[0]

    iota = torch.arange(w, device=dev)
    oh = iota[:, None] == torch.clamp(length, max=w - 1)[None, :]   # [W, B]
    new_obs = torch.where(oh[:, None, :], obs[None].to(obs_shift.dtype),
                          obs_shift)
    new_act = torch.where(oh, action[None, :], act_shift)
    new_rew = torch.where(oh, reward[None, :].to(rew_shift.dtype), rew_shift)
    length2 = torch.clamp(length + 1, max=w)

    flush_valid = full & (cfg.value_mode != "episode")
    idx = iota[:, None]                                   # [W, 1]
    if cfg.value_mode in ("nstep", "episode"):
        g = torch.full((), cfg.gamma, dtype=dt, device=dev)
        in_ep = (idx < length2[None, :]).to(dt)           # [W, B]
        flushed_reward = flushed_reward + torch.sum(
            g ** (idx + 1).to(dt) * new_rew * in_ep, dim=0)
        # the values written to the store: elementwise products and a
        # sum over the window, full precision (never TF32)
        disc = _suffix_discount(w, cfg.gamma, dt, dev)    # [W, W]
        backfill_values = (disc[:, :, None]
                           * (new_rew * in_ep)[None, :, :]).sum(1)
    else:
        # terminal backfill: the newest entry's reward, discounted back
        oh_t = (iota[:, None] == (length2 - 1)[None, :]).to(dt)
        terminal_reward = torch.sum(new_rew * oh_t, dim=0)         # [B]
        exponent = torch.clamp(length2[None, :] - 1 - idx, min=0).to(dt)
        backfill_values = terminal_reward[None, :] * cfg.gamma ** exponent
    backfill_valid = done[None, :] & (idx < length2[None, :])

    flush_key = torch.cat([flushed_obs, flushed_action[None, :]])  # [D+1, B]
    entry_keys = torch.cat([new_obs, new_act[:, None, :]], dim=1)  # [W, D+1, B]
    recs = LaneRecords(
        keys=torch.cat([flush_key[None], entry_keys]),
        actions=torch.cat([flushed_action[None], new_act]),
        values=torch.cat([flushed_reward[None], backfill_values]),
        valid=torch.cat([flush_valid[None], backfill_valid]))
    length3 = torch.where(done, 0, length2).to(torch.int32)
    return (new_obs, new_act, new_rew, length3), recs
