"""Trust set over encoded states (``dcarl_tpu/models/trustset.py``).

The reference imports a trust-set module that its repository lacks
(drl dqn.py:13); its call sites define the API: ``add_data(encoded
state, action, reward)``, ``in_TS(state[, act])``, per-action visit
counts for UCB exploration (dqn.py:114-131) and a confidence value per
action for hybrid action scoring (dqn.py:56-66).

It is a confidence store keyed by the encoded state (the attention
embedding) and the action, box-queried with fixed half-widths (0.1 on
the action: an exact match).  The confidence value reuses the DCARL
bounds: optimistic for the rule action, pessimistic otherwise.

Every query is one store query for all actions of every state
(``core/rls.all_action_stats``): on CUDA tensors through the sorted-band
kernel (``csrc/sorted_moments.cu``), one launch a call; ``use_kernel``
(None = on CUDA) picks the route as ``box_query_stats`` does.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dcarl_tpu_torch.config import ConfidenceConfig
from dcarl_tpu_torch.core import confidence as C
from dcarl_tpu_torch.core.rls import all_action_stats
from dcarl_tpu_torch.core.store import ConfidenceStore, store_init, store_insert
from dcarl_tpu_torch.device import resolve_device


class TrustSet(NamedTuple):
    store: ConfidenceStore
    half_widths: torch.Tensor  # [enc_dim + 1]


def trustset_init(capacity: int, enc_dim: int, state_half_width: float = 0.3,
                  device=None) -> TrustSet:
    device = resolve_device(device)
    w = torch.full((enc_dim + 1,), state_half_width, dtype=torch.float32,
                   device=device)
    w[-1] = 0.1  # exact action match
    return TrustSet(store=store_init(capacity, enc_dim + 1, device=device),
                    half_widths=w)


def add_data(ts: TrustSet, enc_state: torch.Tensor, action: torch.Tensor,
             reward: torch.Tensor, mask: Optional[torch.Tensor] = None
             ) -> TrustSet:
    """Batched: enc_state [M, E], action [M], reward [M]."""
    keys = torch.cat([enc_state, action.to(enc_state.dtype)[:, None]], dim=1)
    m = torch.ones(keys.shape[0], dtype=torch.bool, device=keys.device) \
        if mask is None else mask
    return ts._replace(store=store_insert(
        ts.store, keys, action.to(torch.float32), reward, m))


def state_action_counts(ts: TrustSet, enc_state: torch.Tensor,
                        num_actions: int, use_kernel: Optional[bool] = None
                        ) -> torch.Tensor:
    """N_a per action: [B, A] i32 visit counts."""
    return all_action_stats(ts.store, enc_state, ts.half_widths, num_actions,
                            use_kernel=use_kernel).count


def in_trust_set(ts: TrustSet, enc_state: torch.Tensor, num_actions: int,
                 use_kernel: Optional[bool] = None) -> torch.Tensor:
    """in_TS(state): any recorded data near the encoded state, the
    no-data-punishment gate (dqn.py:191-196).  [B] bool."""
    return state_action_counts(ts, enc_state, num_actions,
                               use_kernel).sum(dim=-1) > 0


def in_trust_set_action(ts: TrustSet, enc_state: torch.Tensor,
                        num_actions: int, use_kernel: Optional[bool] = None
                        ) -> torch.Tensor:
    """in_TS(state, act) per action (act_ts gating, dqn.py:101-112):
    [B, A] bool."""
    return state_action_counts(ts, enc_state, num_actions, use_kernel) > 0


def confidence_values(ts: TrustSet, enc_state: torch.Tensor, num_actions: int,
                      ccfg: ConfidenceConfig = ConfidenceConfig(),
                      use_kernel: Optional[bool] = None) -> torch.Tensor:
    """TS_ConfidenceValue per action: the DCARL bounds (upper for the
    rule action, min(lower, CI-lower) otherwise), the priors where a
    cell holds ``n_thres`` samples or fewer.  [B, A]."""
    stats = all_action_stats(ts.store, enc_state, ts.half_widths,
                             num_actions, use_kernel=use_kernel)
    seen = stats.count > 0
    nf = torch.clamp(stats.count, min=1).to(torch.float32)
    mean = torch.where(seen, stats.mean, 0.0)
    sigma = torch.where(seen, stats.sigma, 0.0)
    is_rule = torch.arange(num_actions, device=nf.device) == ccfg.rule_action
    bound = C.tsrl_bound(mean, mean * nf, sigma, nf, is_rule, ccfg)
    prior = torch.where(is_rule, ccfg.rule_prior, ccfg.other_prior)
    return torch.where(stats.count > ccfg.n_thres, bound, prior)


def hybrid_act(ts: TrustSet, enc_state: torch.Tensor, num_actions: int,
               ccfg: ConfidenceConfig = ConfidenceConfig(),
               use_kernel: Optional[bool] = None) -> torch.Tensor:
    """act_hybrid (dqn.py:56-66): the argmax of the per-action
    confidence values.  [B] i32."""
    return torch.argmax(confidence_values(ts, enc_state, num_actions, ccfg,
                                          use_kernel), dim=-1).to(torch.int32)
