"""Q-networks (``dcarl_tpu/models/networks.py``).

* ``MLPQNet``: the 2 x ``hidden`` ReLU MLP of the value-collection agent
  (dqn_value_collect.py:21-35).
* ``AttentionQNet``: the ego-attention Q-network of the reference
  (drl_library/dqn/dqn.py:24-54): the flat observation is cut into
  ``token_dim``-wide vehicle tokens, one single-head QKV self-attention
  of width ``width`` runs over them, and the ego token's attended
  embedding feeds a 2 x ``hidden`` ReLU head.  ``encoded_state`` is that
  embedding (the trust-set key, dqn.py:87-99), ``ego_attention`` the ego
  query's attention over every token (dqn.py:68-83).
* ``DuelingQNet`` and ``BootstrapQNet``: the TF1 builders
  (Data_From_Carla/Agent/model.py:6-62), value/advantage composition and
  a ``num_heads``-head ensemble over a shared torso (``[..., K, A]``).

Parameters are float32.  Initialization follows flax ``nn.Dense``'s
default: LeCun-normal kernels (a normal truncated at two standard
deviations, scaled so its variance is ``1 / fan_in``) and zero biases,
so a learner started here trains like the JAX package's, though not bit
for bit.  Each net's ``dense`` lists its layers in the order flax's
``@nn.compact`` names them (``Dense_0``, ``Dense_1``, ...), which
``interop.qnet_from_flax`` follows.
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


def _generator(generator: "torch.Generator | None") -> torch.Generator:
    return torch.Generator().manual_seed(0) if generator is None else generator


def _torso(obs_dim: int, hidden: int, generator: torch.Generator):
    return [_dense(obs_dim, hidden, generator), _dense(hidden, hidden, generator)]


class MLPQNet(nn.Module):
    """``[..., obs_dim]`` -> ``[..., num_actions]``."""

    def __init__(self, num_actions: int, obs_dim: int, hidden: int = 128,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.num_actions = num_actions
        self.dense = nn.ModuleList(_torso(obs_dim, hidden, g)
                                   + [_dense(hidden, num_actions, g)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dense[0](x.to(torch.float32)))
        return self.dense[2](torch.relu(self.dense[1](h)))


class AttentionQNet(nn.Module):
    """Input ``[..., n_tokens * token_dim]`` flat observation; output
    ``[..., num_actions]`` Q-values (float32)."""

    def __init__(self, num_actions: int, token_dim: int = 5, width: int = 3,
                 hidden: int = 128, generator: "torch.Generator | None" = None):
        super().__init__()
        generator = _generator(generator)
        self.num_actions = num_actions
        self.token_dim = token_dim
        self.q_lin = _dense(token_dim, width, generator)
        self.k_lin = _dense(token_dim, width, generator)
        self.v_lin = _dense(token_dim, width, generator)
        self.head = nn.Sequential(
            _dense(width, hidden, generator), nn.ReLU(),
            _dense(hidden, hidden, generator), nn.ReLU(),
            _dense(hidden, num_actions, generator))

    def _qkv(self, x: torch.Tensor):
        n = x.shape[-1] // self.token_dim
        t = x.reshape(*x.shape[:-1], n, self.token_dim).to(torch.float32)
        return self.q_lin(t), self.k_lin(t), self.v_lin(t)

    @staticmethod
    def _scale(x: torch.Tensor) -> float:
        # the score scale is 1/sqrt of the FLAT input width (20), not of
        # the token or attention width, as in the reference network
        return 1.0 / math.sqrt(x.shape[-1])

    def _attend(self, x: torch.Tensor) -> torch.Tensor:
        q, k, v = self._qkv(x)
        scores = torch.softmax(q @ k.transpose(-1, -2) * self._scale(x), dim=-1)
        return scores @ v

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """Q-values from the ego token's attended embedding."""
        return self.head(self._attend(x)[..., 0, :])

    def encoded_state(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., width]`` the ego token's attended embedding: the
        trust-set key."""
        return self._attend(x)[..., 0, :]

    def ego_attention(self, x: torch.Tensor) -> torch.Tensor:
        """``[..., n_tokens, width]`` each token's value weighted by the
        ego query's softmax attention over the tokens."""
        q, k, v = self._qkv(x)
        ego = torch.softmax((k @ q[..., 0, :, None])[..., 0] * self._scale(x),
                            dim=-1)
        return ego[..., None] * v


class DuelingQNet(nn.Module):
    """Q = V + A - mean(A) over a 2 x ``hidden`` torso (model.py:24-44)."""

    def __init__(self, num_actions: int, obs_dim: int, hidden: int = 128,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.num_actions = num_actions
        self.dense = nn.ModuleList(_torso(obs_dim, hidden, g)
                                   + [_dense(hidden, 1, g),
                                      _dense(hidden, num_actions, g)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dense[0](x.to(torch.float32)))
        h = torch.relu(self.dense[1](h))
        adv = self.dense[3](h)
        return self.dense[2](h) + adv - adv.mean(dim=-1, keepdim=True)


class BootstrapQNet(nn.Module):
    """``num_heads`` independent heads over a shared torso
    (model.py:46-62): ``[..., num_heads, num_actions]``."""

    def __init__(self, num_actions: int, obs_dim: int, num_heads: int = 10,
                 hidden: int = 128, generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.num_actions = num_actions
        self.dense = nn.ModuleList(
            _torso(obs_dim, hidden, g)
            + [_dense(hidden, num_actions, g) for _ in range(num_heads)])

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = torch.relu(self.dense[0](x.to(torch.float32)))
        h = torch.relu(self.dense[1](h))
        return torch.stack([head(h) for head in self.dense[2:]], dim=-2)
