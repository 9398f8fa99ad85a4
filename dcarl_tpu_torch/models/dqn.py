"""DQN learner (``dcarl_tpu/models/dqn.py``): epsilon-greedy, trust-set
gated and UCB action selection, the prioritized TD loss (single or
double Q) with the trust set's no-data punishment, an Adam step, and
parameter-space noise exploration.

The learner is an object that owns the online network, the target
network and a ``torch.optim.Adam(lr)`` over the online parameters; each
update changes them in place.  What the JAX package's ``DQNState`` holds
besides (the replay and the frame counter) goes in and out of the
training steps explicitly.  Random inputs (the epsilon uniform, the
random action, the replay's Gumbel noise, the parameter noise) come in
as tensors, so a caller can feed both packages the same draws.

``optax.adam(lr)`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0) and
``torch.optim.Adam(lr)`` apply the same update up to rounding: optax
divides the bias-corrected moments, torch folds the corrections into
the step size and the denominator.  A learner makes Adam's state when
it is built (zero moments, a float64 step count), so a checkpoint always
holds it.  ``capturable=True`` (CUDA only, for a step captured in a CUDA
graph) keeps that state on the device, the step count too, and computes
the corrections there.  The step count is float64 because in float32,
``1 - 0.999 ** t`` loses 1.3e-5 of itself to cancellation at t = 1, and
the trainer's TD residuals then leave their tolerance against optax
(``tests/test_torch_graphs.py``).
"""

from __future__ import annotations

import copy
from typing import Dict, NamedTuple, Optional, Tuple

import torch
from torch import nn

from dcarl_tpu_torch.config import DQNConfig
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models import trustset as TS
from dcarl_tpu_torch.models.replay import Batch
from dcarl_tpu_torch.parallel.collectives import pmean
from dcarl_tpu_torch.parallel.distributed import pmean_gradients
from dcarl_tpu_torch.parallel.mesh import ProcessMesh


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
                 double_q: bool = False, capturable: bool = False):
        self.net = network
        self.target_net = copy.deepcopy(network).requires_grad_(False)
        self.cfg = cfg
        self.double_q = double_q
        self.optimizer = torch.optim.Adam(self.net.parameters(), lr=cfg.lr,
                                          capturable=capturable)
        self._start_adam()

    def _start_adam(self) -> None:
        """Adam afresh, its state made now (as torch makes it at a first
        step, but with a float64 step count), so a checkpoint always
        holds it and a captured step finds it.  The step count lies on
        the parameter's device where Adam is capturable, else on the
        host, where torch reads it as a number."""
        self.optimizer.state.clear()
        capturable = self.optimizer.defaults["capturable"]
        for p in self.net.parameters():
            self.optimizer.state[p] = {
                "step": torch.zeros((), dtype=torch.float64,
                                    device=p.device if capturable else "cpu"),
                "exp_avg": torch.zeros_like(p),
                "exp_avg_sq": torch.zeros_like(p)}

    def reset(self, network: nn.Module) -> None:
        """Take ``network``'s weights as online and target weights and
        start Adam afresh."""
        self.net.load_state_dict(network.state_dict())
        self.target_net.load_state_dict(network.state_dict())
        self._start_adam()

    def state_tensors(self) -> list:
        """What a training step updates in place: the weights, the target
        weights and Adam's state (a captured step's static state)."""
        opt_state = self.optimizer.state
        return [*self.net.parameters(), *self.target_net.parameters(),
                *(v for p in self.net.parameters()
                  for v in opt_state.get(p, {}).values()
                  if isinstance(v, torch.Tensor))]

    def state_dict(self) -> dict:
        """Copies of the online and target weights and Adam's state."""
        return copy.deepcopy({"net": self.net.state_dict(),
                              "target": self.target_net.state_dict(),
                              "optimizer": self.optimizer.state_dict()})

    def load_state_dict(self, state: dict) -> None:
        """Copy ``state`` in: the weights in place, and Adam's state into
        the tensors it already has where their shapes, dtypes and devices
        agree (a captured step goes on writing those).  Adam keeps its
        own ``capturable``."""
        self.net.load_state_dict(state["net"])
        self.target_net.load_state_dict(state["target"])
        capturable = self.optimizer.defaults["capturable"]
        held = {p: dict(s) for p, s in self.optimizer.state.items()}
        self.optimizer.load_state_dict(copy.deepcopy(state["optimizer"]))
        for group in self.optimizer.param_groups:
            group["capturable"] = capturable
        for p, loaded in self.optimizer.state.items():
            if capturable and "step" in loaded:
                # torch's load makes a capturable step float32
                loaded["step"] = loaded["step"].to(p.device, torch.float64)
            old = held.get(p, {})
            if old.keys() == loaded.keys() and all(
                    isinstance(v, torch.Tensor) and v.shape == old[k].shape
                    and v.dtype == old[k].dtype and v.device == old[k].device
                    for k, v in loaded.items()):
                for k, v in loaded.items():
                    old[k].copy_(v)
                    loaded[k] = old[k]

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

    def act_ts(self, ts: TS.TrustSet, obs: torch.Tensor,
               enc_obs: torch.Tensor, num_actions: Optional[int] = None,
               use_kernel: Optional[bool] = None) -> torch.Tensor:
        """Trust-set gated argmax (act_ts, dqn.py:101-112): actions with
        no trust-set data near ``enc_obs`` score -1000.  [B] i32."""
        with torch.no_grad():
            q = self.net(obs)
        a = num_actions or q.shape[-1]
        in_ts = TS.in_trust_set_action(ts, enc_obs, a, use_kernel)
        q = torch.where(in_ts, q[..., :a], -1000.0)
        return torch.argmax(q, dim=-1).to(torch.int32)

    def act_ts_explore(self, ts: TS.TrustSet, obs: torch.Tensor,
                       enc_obs: torch.Tensor, num_actions: Optional[int] = None,
                       use_kernel: Optional[bool] = None) -> torch.Tensor:
        """UCB exploration (act_ts_explore, dqn.py:114-131):
        argmax q + c sqrt(log sum(N) / N_a), N_a the trust-set counts
        (at least 1).  [B] i32."""
        with torch.no_grad():
            q = self.net(obs)
        a = num_actions or q.shape[-1]
        n_a = torch.clamp(TS.state_action_counts(ts, enc_obs, a, use_kernel),
                          min=1).to(torch.float32)
        total = n_a.sum(dim=-1, keepdim=True)
        bonus = self.cfg.ucb_c * torch.sqrt(torch.log(total) / n_a)
        return torch.argmax(q[..., :a] + bonus, dim=-1).to(torch.int32)

    # ------------------------------------------------------------------
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

    def train_on(self, batch: Batch, punishment: torch.Tensor,
                 mesh: "ProcessMesh | None" = None
                 ) -> Tuple[torch.Tensor, torch.Tensor]:
        """One Adam step on :meth:`td_loss`; returns (loss, priorities),
        both detached and computed with the pre-step weights.  Over a
        ``mesh`` (each rank its own batch) the gradients are averaged
        over the ranks before the step (one ``all_reduce``,
        ``parallel.distributed.pmean_gradients``) and the returned loss
        is the ranks' mean: every rank applies the same step."""
        loss, prios = self.td_loss(batch, punishment)
        self.optimizer.zero_grad(set_to_none=True)
        loss.backward()
        loss = loss.detach()
        if mesh is not None:
            pmean_gradients([p.grad for p in self.net.parameters()
                             if p.grad is not None], mesh)
            loss = pmean(loss, mesh)
        self.optimizer.step()
        return loss, prios

    def _sample(self, replay: RB.Replay, frame: torch.Tensor,
                gumbel: torch.Tensor) -> Batch:
        return RB.replay_sample(replay, gumbel, alpha=self.cfg.priority_alpha,
                                beta=beta_by_frame(frame, self.cfg))

    def train_step(self, replay: RB.Replay, frame: torch.Tensor,
                   gumbel: torch.Tensor,
                   punishment_mask: Optional[torch.Tensor] = None
                   ) -> Tuple[RB.Replay, torch.Tensor, torch.Tensor]:
        """One prioritized-replay step (the JAX ``DQN.train_step``):
        sample with ``gumbel`` [batch_size, capacity], one Adam step, new
        priorities.  ``punishment_mask`` [batch_size] marks samples whose
        next state is outside the trust set (no_data_punishment,
        dqn.py:191-196).  Returns (replay, frame + 1, loss)."""
        batch = self._sample(replay, frame, gumbel)
        if punishment_mask is None:
            punishment = torch.zeros_like(batch.reward)
        else:
            punishment = torch.where(punishment_mask,
                                     self.cfg.no_data_punishment, 0.0)
        loss, prios = self.train_on(batch, punishment)
        return (RB.replay_update_priorities(replay, batch.indices, prios),
                (frame + 1).to(torch.int32), loss)

    def train_step_with_trustset(
            self, replay: RB.Replay, frame: torch.Tensor, ts: TS.TrustSet,
            gumbel: torch.Tensor, encoder: Optional[nn.Module] = None,
            use_kernel: Optional[bool] = None
    ) -> Tuple[RB.Replay, torch.Tensor, TS.TrustSet, torch.Tensor]:
        """The reference's full update (compute_td_loss, dqn.py:176-213):
        sample, add the encoded batch to the trust set, punish targets
        whose next encoded state has no trust-set data, one Adam step.
        ``encoder`` (default: the online net, as the JAX trainer passes
        its params) encodes ``obs`` and ``next_obs`` with its weights from
        before the step.  Returns (replay, frame + 1, trust set, loss)."""
        batch = self._sample(replay, frame, gumbel)
        encoder = self.net if encoder is None else encoder
        with torch.no_grad():
            enc = encoder.encoded_state(batch.obs)
            enc_next = encoder.encoded_state(batch.next_obs)
        ts = TS.add_data(ts, enc, batch.action.to(torch.float32), batch.reward)
        in_ts = TS.in_trust_set(ts, enc_next, self.net.num_actions, use_kernel)
        punishment = torch.where(in_ts, 0.0, self.cfg.no_data_punishment)
        loss, prios = self.train_on(batch, punishment)
        return (RB.replay_update_priorities(replay, batch.indices, prios),
                (frame + 1).to(torch.int32), ts, loss)

    def update_target(self, sync: torch.Tensor) -> None:
        """Hard target sync (update_target, dqn.py:248-249) where the
        bool tensor ``sync`` holds: a select on the device, so the caller
        need not read the frame counter back to the host."""
        with torch.no_grad():
            for t, p in zip(self.target_net.parameters(),
                            self.net.parameters()):
                t.copy_(torch.where(sync, p, t))


# ---------------------------------------------------------------------------
# Parameter-space noise exploration (SB deepq/build_graph.py param_noise:
# perturbed-network action selection with the adaptive scale rule of
# Plappert et al., as build_act_with_param_noise implements it)
# ---------------------------------------------------------------------------


class ParamNoiseState(NamedTuple):
    """The adaptive noise's scale (perturbation stddev) and its KL
    target (build_graph.py's param_noise_scale / _threshold)."""

    scale: torch.Tensor
    threshold: torch.Tensor


def param_noise_init(initial_scale: float = 0.01, device=None
                     ) -> ParamNoiseState:
    device = resolve_device(device)
    return ParamNoiseState(
        scale=torch.full((), initial_scale, dtype=torch.float32, device=device),
        threshold=torch.zeros((), dtype=torch.float32, device=device))


def perturb_params(net: nn.Module, scale: torch.Tensor,
                   noise: Optional[Dict[str, torch.Tensor]] = None,
                   generator: Optional[torch.Generator] = None
                   ) -> Dict[str, torch.Tensor]:
    """``{name: p + scale * N(0, 1)}`` for every parameter of ``net``
    (build_graph.py perturb_vars), for ``torch.func.functional_call``.
    The unit normals are ``noise[name]`` where given, else drawn from
    ``generator``."""
    out = {}
    for name, p in net.named_parameters():
        z = noise[name] if noise is not None else torch.randn(
            p.shape, generator=generator, dtype=p.dtype, device=p.device)
        out[name] = p.detach() + scale * z
    return out


def param_noise_threshold_from_eps(eps: torch.Tensor, num_actions: int
                                   ) -> torch.Tensor:
    """build_act_with_param_noise ties the KL target to the epsilon
    schedule: -log(1 - eps + eps / |A|)."""
    return -torch.log(1.0 - eps + eps / num_actions)


class DQNParamNoise:
    """Perturbed action selection and the 1.01-factor adaptive scale
    update, bound to a :class:`DQN`.  The noise is ``noise`` (unit
    normals by parameter name) where given, else drawn from
    ``generator``."""

    def __init__(self, dqn: DQN):
        self.dqn = dqn

    def _perturbed_q(self, pn: ParamNoiseState, obs, noise, generator):
        params = perturb_params(self.dqn.net, pn.scale, noise, generator)
        return torch.func.functional_call(self.dqn.net, params, (obs,))

    def act(self, pn: ParamNoiseState, obs: torch.Tensor,
            noise: Optional[Dict[str, torch.Tensor]] = None,
            generator: Optional[torch.Generator] = None) -> torch.Tensor:
        """Greedy actions of the perturbed network
        (build_act_with_param_noise).  [B] i32."""
        with torch.no_grad():
            q = self._perturbed_q(pn, obs, noise, generator)
        return torch.argmax(q, dim=-1).to(torch.int32)

    def adapt(self, pn: ParamNoiseState, obs: torch.Tensor,
              frame: torch.Tensor,
              noise: Optional[Dict[str, torch.Tensor]] = None,
              generator: Optional[torch.Generator] = None
              ) -> Tuple[ParamNoiseState, torch.Tensor]:
        """Scale adaption (build_graph.py update_scale): the mean KL
        between the clean and perturbed action distributions on ``obs``;
        the scale grows by 1.01 while the KL is under the threshold
        (which follows epsilon at ``frame``), else shrinks.
        Returns (new state, KL)."""
        with torch.no_grad():
            q = self.dqn.net(obs)
            q_pert = self._perturbed_q(pn, obs, noise, generator)
        logp = torch.log_softmax(q, dim=-1)
        logq = torch.log_softmax(q_pert, dim=-1)
        kl = (torch.exp(logp) * (logp - logq)).sum(dim=-1).mean()
        eps = epsilon_by_frame(frame, self.dqn.cfg)
        thresh = param_noise_threshold_from_eps(eps, q.shape[-1])
        scale = torch.where(kl < thresh, pn.scale * 1.01, pn.scale / 1.01)
        return ParamNoiseState(scale=scale, threshold=thresh), kl
