"""DQN learner (``dcarl_tpu/models/dqn.py``): epsilon-greedy proposals,
the prioritized TD loss (single or double Q) and an Adam step.

The learner is an object that owns the online network, the target
network and a ``torch.optim.Adam(lr)`` over the online parameters; each
update changes them in place.  Its random inputs (the epsilon uniform
and the random action) come in as tensors, so a caller can feed both
packages the same draws.

``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) and
``torch.optim.Adam(lr)`` apply the same update up to rounding: optax
divides the bias-corrected moments, torch folds the corrections into
the step size and the denominator.
"""

from __future__ import annotations

import copy
from typing import Tuple

import torch
from torch import nn

from dcarl_tpu_torch.config import DQNConfig
from dcarl_tpu_torch.models.replay import Batch


def epsilon_by_frame(frame: torch.Tensor, cfg: DQNConfig = DQNConfig()
                     ) -> torch.Tensor:
    """eps_final + (eps_start - eps_final) * exp(-frame / decay)
    (dqn.py:253-258), float32."""
    return cfg.epsilon_final + (cfg.epsilon_start - cfg.epsilon_final) \
        * torch.exp(-frame.to(torch.float32) / cfg.epsilon_decay)


def beta_by_frame(frame: torch.Tensor, cfg: DQNConfig = DQNConfig()
                  ) -> torch.Tensor:
    """min(1, beta0 + frame * (1 - beta0) / beta_frames)
    (dqn.py:260-263), float32."""
    return torch.clamp(cfg.beta_start + frame.to(torch.float32)
                       * (1.0 - cfg.beta_start) / cfg.beta_frames, max=1.0)


class DQN:
    """Online net, target net and Adam; all three change in place."""

    def __init__(self, network: nn.Module, cfg: DQNConfig = DQNConfig(),
                 double_q: bool = False):
        self.net = network
        self.target_net = copy.deepcopy(network).requires_grad_(False)
        self.cfg = cfg
        self.double_q = double_q
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=cfg.lr)

    def reset(self, network: nn.Module) -> None:
        """Take ``network``'s weights as online and target weights and
        start Adam afresh."""
        self.net.load_state_dict(network.state_dict())
        self.target_net.load_state_dict(network.state_dict())
        self.optimizer.state.clear()

    def state_dict(self) -> dict:
        """Copies of the online and target weights and Adam's state."""
        return copy.deepcopy({"net": self.net.state_dict(),
                              "target": self.target_net.state_dict(),
                              "optimizer": self.optimizer.state_dict()})

    def load_state_dict(self, state: dict) -> None:
        self.net.load_state_dict(state["net"])
        self.target_net.load_state_dict(state["target"])
        self.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))

    # ------------------------------------------------------------------
    def act_epsilon_greedy(self, obs: torch.Tensor, frame: torch.Tensor,
                           eps_uniform: torch.Tensor,
                           random_action: torch.Tensor) -> torch.Tensor:
        """[B] epsilon-greedy actions (Q_network.act, dqn.py:133-151):
        ``random_action`` where ``eps_uniform < epsilon(frame)``, else
        the greedy action.  i32."""
        with torch.no_grad():
            greedy = torch.argmax(self.net(obs), dim=-1)
        explore = eps_uniform < epsilon_by_frame(frame, self.cfg)
        return torch.where(explore, random_action.to(greedy.dtype),
                           greedy).to(torch.int32)

    def td_loss(self, batch: Batch, punishment: torch.Tensor
                ) -> Tuple[torch.Tensor, torch.Tensor]:
        """Weighted TD loss (compute_td_loss, dqn.py:176-213): target =
        r + gamma * max_a' Q_target(s', a') * (1 - done) + punishment.
        Returns (loss with its graph, priorities = per-sample loss +
        1e-5, detached)."""
        q = self.net(batch.obs)
        q_sa = q.gather(1, batch.action.to(torch.int64)[:, None])[:, 0]
        with torch.no_grad():
            next_target = self.target_net(batch.next_obs)
            if self.double_q:
                # online net picks a', target net evaluates it
                a_star = torch.argmax(self.net(batch.next_obs), dim=-1)
                next_q = next_target.gather(1, a_star[:, None])[:, 0]
            else:
                next_q = next_target.max(dim=-1).values
            target = batch.reward + self.cfg.gamma * next_q \
                * (1.0 - batch.done) + punishment
        per_elem = (q_sa - target) ** 2 * batch.weights
        return per_elem.mean(), per_elem.detach() + 1e-5

    def train_on(self, batch: Batch, punishment: torch.Tensor
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on :meth:`td_loss`; returns (loss, priorities),
        both detached and computed with the pre-step weights."""
        loss, prios = self.td_loss(batch, punishment)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        self.optimizer.step()
        return loss.detach(), prios

    def update_target(self, sync: torch.Tensor) -> None:
        """Hard target sync (update_target, dqn.py:248-249) where the
        bool tensor ``sync`` holds: a select on the device, so the caller
        need not read the frame counter back to the host."""
        with torch.no_grad():
            for t, p in zip(self.target_net.parameters(),
                            self.net.parameters()):
                t.copy_(torch.where(sync, p, t))
