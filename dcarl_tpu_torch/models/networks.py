"""Q-networks (``dcarl_tpu/models/networks.py``).

``AttentionQNet`` is the ego-attention Q-network of the reference
(drl_library/dqn/dqn.py:24-54): the flat observation is cut into
``token_dim``-wide vehicle tokens, one single-head QKV self-attention
of width ``width`` runs over them, and the ego token's attended
embedding feeds a 2 x ``hidden`` ReLU head.  Parameters are float32.

Initialization follows flax ``nn.Dense``'s default: LeCun-normal
kernels (a normal truncated at two standard deviations, scaled so its
variance is ``1 / fan_in``) and zero biases, so a learner started here
trains like the JAX package's, though not bit for bit.
"""

from __future__ import annotations

import math

import torch
from torch import nn

# std of a unit normal truncated to [-2, 2] (jax.nn.initializers'
# truncated-normal correction)
_TRUNC_STD = 0.87962566103423978


def _dense(fan_in: int, fan_out: int, generator: torch.Generator) -> nn.Linear:
    lin = nn.Linear(fan_in, fan_out)
    std = math.sqrt(1.0 / fan_in) / _TRUNC_STD
    with torch.no_grad():
        nn.init.trunc_normal_(lin.weight, std=std, a=-2.0 * std, b=2.0 * std,
                              generator=generator)
        lin.bias.zero_()
    return lin


class AttentionQNet(nn.Module):
    """Input ``[..., n_tokens * token_dim]`` flat observation; output
    ``[..., num_actions]`` Q-values (float32)."""

    def __init__(self, num_actions: int, token_dim: int = 5, width: int = 3,
                 hidden: int = 128, generator: "torch.Generator | None" = None):
        super().__init__()
        if generator is None:
            generator = torch.Generator().manual_seed(0)
        self.token_dim = token_dim
        self.q_lin = _dense(token_dim, width, generator)
        self.k_lin = _dense(token_dim, width, generator)
        self.v_lin = _dense(token_dim, width, generator)
        self.head = nn.Sequential(
            _dense(width, hidden, generator), nn.ReLU(),
            _dense(hidden, hidden, generator), nn.ReLU(),
            _dense(hidden, num_actions, generator))

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        n = x.shape[-1] // self.token_dim
        t = x.reshape(*x.shape[:-1], n, self.token_dim).to(torch.float32)
        q, k, v = self.q_lin(t), self.k_lin(t), self.v_lin(t)
        # the score scale is 1/sqrt of the FLAT input width (20), not of
        # the token or attention width, as in the reference network
        scale = 1.0 / math.sqrt(x.shape[-1])
        scores = torch.softmax(q @ k.transpose(-1, -2) * scale, dim=-1)
        return scores @ v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Q-values from the ego token's attended embedding."""
        return self.head(self._attend(x)[..., 0, :])
