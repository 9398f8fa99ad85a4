"""Policy and value networks of the algorithm family
(``dcarl_tpu/algos/nets.py``).

The SB fork's ``common/policies.py`` (MlpPolicy and friends) defines
shared-trunk actor-critic MLPs; here they are small ``nn.Module``s used
functionally: a learner's parameters are a dict of tensors in its state
(``named_parameters`` names), and :func:`apply` runs a module on them
(``torch.func.functional_call``), so gradients, optimizer moments and
checkpoints are plain tensors.  Continuous policies use tanh-squashed
Gaussians (SAC, sac/policies.py) or tanh-deterministic actors
(DDPG/TD3).

Initialization is flax ``nn.Dense``'s default through
``models/networks._dense``: LeCun-normal kernels and zero biases
(``log_std`` zeros); hidden widths default to the published MlpPolicy's
(64, 64).  Each module names its children for
``interop.algo_params_from_flax`` in ``FLAX``: flax's ``@nn.compact``
names (``MLP_0``, ``Dense_0``, ...).
"""

from __future__ import annotations

import math
from typing import Callable, Dict, Sequence, Tuple

import torch
from torch import nn

from dcarl_tpu_torch.algos.common import LOG_2PI
from dcarl_tpu_torch.models.networks import _dense, _generator

LOG_STD_MIN, LOG_STD_MAX = -20.0, 2.0
LOG_2 = math.log(2.0)
Params = Dict[str, torch.Tensor]


class MLP(nn.Module):
    """Dense layers with tanh between them (and after the last with
    ``activate_last``); flax names ``Dense_0``, ``Dense_1``, ..."""

    def __init__(self, in_dim: int, features: Sequence[int],
                 activate_last: bool = False,
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        dims = [in_dim, *features]
        self.layers = nn.ModuleList(_dense(a, b, g)
                                    for a, b in zip(dims[:-1], dims[1:]))
        self.activate_last = activate_last

    def flax_key(self, name: str) -> str:
        return "Dense_" + name      # "layers.<i>" -> "Dense_<i>"

    def forward(self, x):
        n = len(self.layers)
        for i, layer in enumerate(self.layers):
            x = layer(x)
            if i < n - 1 or self.activate_last:
                x = torch.tanh(x)
        return x


class CategoricalActorCritic(nn.Module):
    """MlpPolicy (common/policies.py): shared trunk, categorical pi and a
    value head (A2C / PPO / TRPO discrete).  -> (logits, value)."""

    FLAX = {"trunk": "MLP_0", "pi": "Dense_0", "vf": "Dense_1"}

    def __init__(self, obs_dim: int, num_actions: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.trunk = MLP(obs_dim, hidden, True, g)
        self.pi = _dense(hidden[-1], num_actions, g)
        self.vf = _dense(hidden[-1], 1, g)

    def forward(self, obs) -> Tuple[torch.Tensor, torch.Tensor]:
        h = self.trunk(obs)
        return self.pi(h), self.vf(h)[..., 0]


class GaussianActorCritic(nn.Module):
    """Continuous MlpPolicy: diagonal Gaussian with a state-independent
    ``log_std`` (common/distributions.py DiagGaussian) and a value head.
    -> (mean, log_std broadcast to mean, value)."""

    FLAX = {"trunk": "MLP_0", "mean": "Dense_0", "vf": "Dense_1",
            "log_std": "log_std"}

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.trunk = MLP(obs_dim, hidden, True, g)
        self.mean = _dense(hidden[-1], action_dim, g)
        self.log_std = nn.Parameter(torch.zeros(action_dim))
        self.vf = _dense(hidden[-1], 1, g)

    def forward(self, obs):
        h = self.trunk(obs)
        mean = self.mean(h)
        return mean, self.log_std.expand(mean.shape), self.vf(h)[..., 0]


class DeterministicActor(nn.Module):
    """DDPG/TD3 actor (ddpg/policies.py): tanh-bounded action."""

    FLAX = {"trunk": "MLP_0", "out": "Dense_0"}

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.trunk = MLP(obs_dim, hidden, True, g)
        self.out = _dense(hidden[-1], action_dim, g)

    def forward(self, obs):
        return torch.tanh(self.out(self.trunk(obs)))


class QCritic(nn.Module):
    """State-action critic Q(s, a)."""

    FLAX = {"mlp": "MLP_0"}

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: "torch.Generator | None" = None):
        super().__init__()
        self.mlp = MLP(obs_dim + action_dim, (*hidden, 1), False,
                       _generator(generator))

    def forward(self, obs, action):
        return self.mlp(torch.cat([obs, action], dim=-1))[..., 0]


class TwinQCritic(nn.Module):
    """TD3/SAC twin critics (td3/policies.py). -> (q1, q2)."""

    FLAX = {"q1": "QCritic_0", "q2": "QCritic_1"}

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.q1 = QCritic(obs_dim, action_dim, hidden, g)
        self.q2 = QCritic(obs_dim, action_dim, hidden, g)

    def forward(self, obs, action):
        return self.q1(obs, action), self.q2(obs, action)


class SquashedGaussianActor(nn.Module):
    """SAC actor (sac/policies.py): tanh-squashed Gaussian with a
    state-dependent log-std. -> (mean, log_std clipped to [-20, 2])."""

    FLAX = {"trunk": "MLP_0", "mean": "Dense_0", "log_std": "Dense_1"}

    def __init__(self, obs_dim: int, action_dim: int,
                 hidden: Sequence[int] = (64, 64),
                 generator: "torch.Generator | None" = None):
        super().__init__()
        g = _generator(generator)
        self.trunk = MLP(obs_dim, hidden, True, g)
        self.mean = _dense(hidden[-1], action_dim, g)
        self.log_std = _dense(hidden[-1], action_dim, g)

    def forward(self, obs):
        h = self.trunk(obs)
        return (self.mean(h),
                torch.clamp(self.log_std(h), LOG_STD_MIN, LOG_STD_MAX))


# ---------------------------------------------------------------------------
# Functional use


def apply(net: nn.Module, params: Params, *args):
    """``net``'s forward with ``params`` in place of its own."""
    return torch.func.functional_call(net, params, args)


def init_params(build: Callable[[torch.Generator], nn.Module],
                generator: torch.Generator) -> Params:
    """Fresh parameters of the module ``build(g)`` makes, on
    ``generator``'s device: ``g`` is a host generator seeded from
    ``generator`` (one read of the device at initialization)."""
    seed = int(torch.randint(0, 2 ** 62, (), generator=generator,
                             device=generator.device))
    net = build(torch.Generator().manual_seed(seed))
    return {k: v.detach().to(generator.device)
            for k, v in net.named_parameters()}


# ---------------------------------------------------------------------------
# Distributions


def squashed_sample(mean, log_std, eps):
    """a = tanh(mean + std * eps) and its log-prob (sac/policies.py
    gaussian_likelihood + squash correction); ``eps`` unit normals."""
    std = torch.exp(log_std)
    pre = mean + std * eps
    act = torch.tanh(pre)
    logp = -0.5 * (eps ** 2 + 2.0 * log_std + LOG_2PI)
    # tanh change of variables, numerically stable form
    logp = logp - 2.0 * (LOG_2 - pre
                         - torch.nn.functional.softplus(-2.0 * pre))
    return act, torch.sum(logp, dim=-1)


def categorical_log_prob(logits, action):
    logp = torch.log_softmax(logits, dim=-1)
    return torch.gather(logp, -1, action.long()[..., None])[..., 0]


def categorical_entropy(logits):
    logp = torch.log_softmax(logits, dim=-1)
    return -torch.sum(torch.exp(logp) * logp, dim=-1)


def gaussian_log_prob(mean, log_std, action):
    var = torch.exp(2.0 * log_std)
    return torch.sum(-0.5 * ((action - mean) ** 2 / var + 2.0 * log_std
                             + LOG_2PI), dim=-1)


def gaussian_entropy(log_std):
    return torch.sum(log_std + 0.5 * (LOG_2PI + 1.0), dim=-1)

