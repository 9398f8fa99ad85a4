"""RLS test mode: the confidence gate of the deployment driver.

For candidates 1..A-1 of every env, a Welch z-test of the candidate's
stored value distribution against the rule action's (RLS.act_test,
RLS.py:120-157); batched over a leading env axis.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from dcarl_tpu_torch.config import StoreConfig


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
