"""Act-hold segment pushes and the trust-set DQN trainer
(``dcarl_tpu/models/segment.py``).

The reference's CARLA trust-set trainer does not push one transition a
step.  It samples one DQN action and HOLDS it across env ticks while the
planner re-plans around it, accumulating the segment
(drl_library/dqn/dqn.py:353-393):

* the DQN action is sampled only when none is held (:362-364);
* every tick appends (obs, reward) and adds the reward to the segment's
  sum (:376-377);
* when ``sum_reward > r_thres or len > pass_thres or done`` (:381), the
  whole segment is pushed: entry i gets the sum less the rewards of the
  entries before it (the suffix sum), with the segment's final
  next_obs / done shared by every entry (:382-385);
* one extra tick then pushes a single ordinary transition with the same
  held action (:388-393), after which a new action is sampled.

Here that is a fixed-shape batched state machine: the segment buffer is
[B, L, D] with ``L = pass_thres + 1`` (the trigger fires at the latest
when the length exceeds ``pass_thres``), the suffix sum a masked prefix
subtraction, the extra push a ``tail`` flag.

:func:`make_trustset_trainer` runs the whole loop on the lane-major
driving stack (``planning/fast_rollout.py``): epsilon-greedy proposal,
act-hold, the held Werling candidate followed by pure pursuit and PID,
segment pushes into prioritized replay, and the TD step that adds the
sampled batch's encoded states to the trust set and punishes targets
outside it.  On CUDA the trust-set query is one ``sorted_moments``
launch per trained step (``csrc/sorted_moments.cu``, D = 4 keys: the
3-wide attended ego embedding and the action).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, NamedTuple, Optional, Tuple

import torch

from dcarl_tpu_torch.config import DQNConfig, EnvConfig, WerlingConfig
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.env.scenario import Scenario, t_intersection
from dcarl_tpu_torch.models import dqn as DQ
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models import trustset as TS
from dcarl_tpu_torch.models.networks import AttentionQNet
from dcarl_tpu_torch.planning import fast_rollout as FR
from dcarl_tpu_torch.utils import graphs


@dataclasses.dataclass(frozen=True)
class SegmentConfig:
    """Trigger thresholds (drl_library/dqn/dqn.py:275-276)."""

    r_thres: float = 1.0
    pass_thres: int = 10

    @property
    def max_len(self) -> int:
        # len > pass_thres triggers right after the append that made the
        # length pass_thres + 1
        return self.pass_thres + 1


class SegmentHold(NamedTuple):
    """Per-env act-hold state (batch-first: L is small)."""

    obs: torch.Tensor         # [B, L, D] held segment observations
    reward: torch.Tensor      # [B, L] held segment rewards
    length: torch.Tensor      # [B] i32 entries held
    action: torch.Tensor      # [B] i32 the held DQN action
    sum_reward: torch.Tensor  # [B] running segment reward sum
    fresh: torch.Tensor       # [B] bool: the next select samples a new action
    tail: torch.Tensor        # [B] bool: the post-segment extra step


class SegmentRecords(NamedTuple):
    """Fixed-shape push: up to L records per env per step."""

    obs: torch.Tensor       # [B, L, D]
    action: torch.Tensor    # [B, L] i32 (the held action, broadcast)
    value: torch.Tensor     # [B, L] suffix-sum shared return (tail: reward)
    next_obs: torch.Tensor  # [B, L, D] (the segment's final next_obs)
    done: torch.Tensor      # [B, L] (the segment's final done)
    valid: torch.Tensor     # [B, L] bool


def segment_init(batch: int, obs_dim: int,
                 cfg: SegmentConfig = SegmentConfig(),
                 dtype=torch.float32, device=None) -> SegmentHold:
    device = resolve_device(device)
    l = cfg.max_len

    def z(*shape, dt=dtype):
        return torch.zeros(shape, dtype=dt, device=device)

    return SegmentHold(obs=z(batch, l, obs_dim), reward=z(batch, l),
                       length=z(batch, dt=torch.int32),
                       action=z(batch, dt=torch.int32),
                       sum_reward=z(batch),
                       fresh=torch.ones((batch,), dtype=torch.bool,
                                        device=device),
                       tail=z(batch, dt=torch.bool))


def segment_select_action(hold: SegmentHold, rl_action: torch.Tensor
                          ) -> Tuple[SegmentHold, torch.Tensor]:
    """The act-hold gate (dqn.py:362-364): envs with an open segment (or
    in the tail step) keep their held action; fresh envs take this
    step's proposal.  Returns (hold, executed action)."""
    action = torch.where(hold.fresh, rl_action.to(torch.int32), hold.action)
    return hold._replace(action=action,
                         fresh=torch.zeros_like(hold.fresh)), action


def _prefix_sum(x: torch.Tensor) -> torch.Tensor:
    """Inclusive prefix sum along the L axis of [B, L], added one column
    at a time in x's dtype: the JAX reference's ``cumsum`` on the CPU
    adds up to 16 entries sequentially, and ``torch.cumsum`` on the CPU
    would accumulate float32 in double."""
    acc = x[:, 0]
    cols = [acc]
    for i in range(1, x.shape[1]):
        acc = acc + x[:, i]
        cols.append(acc)
    return torch.stack(cols, dim=1)


def segment_push(hold: SegmentHold, obs: torch.Tensor, reward: torch.Tensor,
                 next_obs: torch.Tensor, done: torch.Tensor,
                 cfg: SegmentConfig = SegmentConfig()
                 ) -> Tuple[SegmentHold, SegmentRecords]:
    """Advance the state machine after one env tick.  ``obs`` is the
    observation the held action was executed from (dqn.py:376).  Per
    env exactly one of: the segment grows (no records); it triggers
    (dqn.py:381-385: every held entry with its suffix-sum value, the
    final next_obs / done shared; ``tail`` set); or the tail step
    (dqn.py:388-393: one ordinary transition with the held action and
    this tick's reward; ``fresh`` set)."""
    b, l, d = hold.obs.shape
    idx = torch.arange(l, device=obs.device)
    in_tail = hold.tail

    # segment append (meaningful for non-tail envs only)
    oh = idx[None, :] == torch.clamp(hold.length, max=l - 1)[:, None]   # [B, L]
    obs_buf = torch.where(oh[:, :, None], obs[:, None, :], hold.obs)
    rew_buf = torch.where(oh, reward[:, None], hold.reward)
    length = hold.length + 1
    sum_reward = hold.sum_reward + reward

    trigger = ~in_tail & ((sum_reward > cfg.r_thres)
                          | (length > cfg.pass_thres) | done)

    # suffix values the reference's way: entry i gets the sum less the
    # rewards of the entries before it (dqn.py:382-385)
    in_seg = idx[None, :] < length[:, None]
    rew_m = torch.where(in_seg, rew_buf, 0.0)
    suffix = sum_reward[:, None] - (_prefix_sum(rew_m) - rew_m)

    tail_valid = in_tail[:, None] & (idx[None, :] == 0)
    records = SegmentRecords(
        obs=torch.where(tail_valid[:, :, None], obs[:, None, :], obs_buf),
        action=hold.action[:, None].expand(b, l),
        value=torch.where(tail_valid, reward[:, None], suffix),
        next_obs=next_obs[:, None, :].expand(b, l, d),
        done=done[:, None].to(rew_buf.dtype).expand(b, l),
        valid=(trigger[:, None] & in_seg) | tail_valid)

    # trigger -> tail; tail -> fresh; else keep growing
    closed = trigger | in_tail
    new_hold = SegmentHold(
        obs=obs_buf, reward=rew_buf,
        length=torch.where(closed, 0, length).to(torch.int32),
        action=hold.action,
        sum_reward=torch.where(closed, 0.0, sum_reward),
        fresh=in_tail, tail=trigger)
    return new_hold, records


# ---------------------------------------------------------------------------
# The integrated trust-set DQN trainer (dqn.py:353-415)
# ---------------------------------------------------------------------------


class TrustsetCarry(NamedTuple):
    env: FR.FastEnvState
    hold: SegmentHold
    replay: RB.Replay
    frame: torch.Tensor  # [] i32 trained steps (the epsilon / beta frame)
    ts: TS.TrustSet
    # host flag: the replay may still hold fewer rows than a batch
    warm: bool


class TrustsetDraws(NamedTuple):
    """The random inputs of one step (the env's auto-reset aside)."""

    eps_uniform: torch.Tensor    # [B] U(0, 1): explore where < epsilon
    random_action: torch.Tensor  # [B] uniform in 0..A-1
    gumbel: torch.Tensor         # [batch_size, replay_capacity] Gumbel(0, 1)


METRIC_KEYS = ("loss", "reward_mean", "pushed", "segments_closed",
               "replay_size", "ts_rows", "held_fraction")


def make_trustset_trainer(
    scenario: Optional[Scenario] = None,
    env_cfg: Optional[EnvConfig] = None,
    wcfg: Optional[WerlingConfig] = None,
    dqn_cfg: Optional[DQNConfig] = None,
    seg_cfg: SegmentConfig = SegmentConfig(),
    batch: int = 64,
    replay_capacity: int = 1 << 14,
    trustset_capacity: int = 1 << 14,
    enc_half_width: float = 0.3,
    dtype: torch.dtype = torch.float32,
    device: "str | torch.device | None" = None,
    use_kernel: Optional[bool] = None,
):
    """The trust-set DQN training loop end to end: the attention Q-net
    proposes epsilon-greedy, the act-hold machine holds the action while
    the lattice candidate it names is followed (the held index picks the
    candidate, 0 = the brake backup: the cheapest path at zero speed),
    segments push into prioritized replay with suffix-sum shared
    returns, and the TD step punishes targets whose next encoded state
    is outside the trust set (train_step_with_trustset, dqn.py:176-213).

    Returns ``(init_fn, run_fn)``:

      init_fn(seed)                    -> TrustsetCarry (and re-initializes
                                          the learner from ``seed``)
      run_fn(carry, generator, n_steps) -> (carry, {metric: [n_steps]})
      run_fn.step(carry, generator)    -> (carry, {metric: []})
      run_fn.with_draws(carry, draws, generator) -> the same step with the
                                          given :class:`TrustsetDraws`
      run_fn.draw(generator)           -> the draws ``run_fn`` uses
      run_fn.learner                   -> the ``DQN`` (weights and Adam,
                                          changed in place)
      run_fn.runner                    -> the ``graphs.TickRunner`` of the
                                          warm-free steps

    The metrics have the JAX trainer's keys (:data:`METRIC_KEYS`).  The
    reference trains only once the replay can fill a batch (dqn.py:405);
    the JAX trainer computes the update and discards it until then, the
    port skips it: while ``carry.warm`` each step reads the replay's size
    back to the host (one wait on the device), and from the first full
    batch on none.  ``run_fn`` runs the warm steps eagerly and the rest
    through ``run_fn.runner``: on CUDA one captured CUDA graph replayed a
    step (as JAX jits its ``lax.scan`` of steps), elsewhere the eager
    loop, ``graphs.run_loop(run_fn.runner.tick, ...)``, the same bits;
    the learner's Adam is ``capturable`` on CUDA.  ``use_kernel`` (None =
    on CUDA) picks the trust-set query route (``trustset.py``).
    ``device=None`` runs on ``cuda`` (which must exist)."""
    env_cfg = env_cfg or EnvConfig()
    wcfg = wcfg or WerlingConfig()
    dq = dqn_cfg or DQNConfig()
    sc = scenario or t_intersection(env_cfg)
    device, sa, idx, tab, env_init = FR._setup(sc, env_cfg, dtype, device)
    n_v = len(wcfg.target_speeds)
    n_paths = wcfg.num_paths
    num_actions = n_paths + 1
    obs_dim = env_cfg.state_dim
    l = seg_cfg.max_len

    def make_net(seed: int) -> AttentionQNet:
        return AttentionQNet(num_actions, token_dim=dq.token_dim,
                             width=dq.attention_width, hidden=dq.hidden_dim,
                             generator=torch.Generator().manual_seed(seed)
                             ).to(device)

    # capturable Adam on the card, graphed or not: both routes give the
    # same bits (torch takes it on CUDA tensors only)
    learner = DQ.DQN(make_net(0), cfg=dq, capturable=device.type == "cuda")

    def init_fn(seed: int = 0) -> TrustsetCarry:
        gen = torch.Generator(device=device).manual_seed(seed)
        learner.reset(make_net(seed))
        return TrustsetCarry(
            env=env_init(batch, gen),
            hold=segment_init(batch, obs_dim, seg_cfg, dtype, device),
            replay=RB.replay_init(replay_capacity, obs_dim, device=device),
            frame=torch.zeros((), dtype=torch.int32, device=device),
            ts=TS.trustset_init(trustset_capacity, dq.attention_width,
                                enc_half_width, device=device),
            warm=True)

    def draw(generator: torch.Generator) -> TrustsetDraws:
        return TrustsetDraws(
            eps_uniform=torch.rand((batch,), generator=generator,
                                   device=device),
            random_action=torch.randint(0, num_actions, (batch,),
                                        generator=generator, device=device),
            gumbel=RB.gumbel_noise((dq.batch_size, replay_capacity),
                                   generator, device=device))

    def with_draws(carry: TrustsetCarry, draws: TrustsetDraws,
                   generator: torch.Generator
                   ) -> Tuple[TrustsetCarry, Dict[str, torch.Tensor]]:
        state = carry.env
        obs = FR._obs_ori_soa(state, idx)                  # [20, B]
        obs_bf = obs.T
        ego_x, ego_y, ego_vx, ego_vy, ego_yaw = obs[:5]

        # 1. act-hold: the epsilon-greedy proposal, held over the segment
        rl_action = learner.act_epsilon_greedy(
            obs_bf, carry.frame, draws.eps_uniform, draws.random_action)
        hold, action = segment_select_action(carry.hold, rl_action)

        # 2. plan, then follow the held candidate (trajectory_update_CP)
        s0, d_signed, vd = FR._project_ego(ego_x, ego_y, ego_vx, ego_vy, tab)
        ego_v = torch.sqrt(ego_vx ** 2 + ego_vy ** 2)
        lat = FR._plan_lattice(s0, -d_signed, vd, ego_v, tab, wcfg)
        exec_idx = torch.clamp(action, 0, n_paths).to(torch.int64)
        traj_x, traj_y, speed_end = FR._pick_path(lat, exec_idx, n_v)
        acc, steer = FR._control(ego_x, ego_y, ego_yaw, ego_v, traj_x, traj_y,
                                 speed_end)
        env2, reward, done = FR._step_env_soa(state, acc, steer, generator, sa,
                                              env_cfg)
        obs2_bf = FR._obs_ori_soa(env2, idx).T

        # 3. segment push -> replay (suffix-sum shared returns)
        hold, recs = segment_push(hold, obs_bf, reward, obs2_bf, done, seg_cfg)
        replay = RB.replay_push(
            carry.replay, recs.obs.reshape(batch * l, obs_dim),
            recs.action.reshape(-1), recs.value.reshape(-1),
            recs.next_obs.reshape(batch * l, obs_dim),
            recs.done.reshape(-1), mask=recs.valid.reshape(-1))

        # 4. the trust-set TD step, once the replay can fill a batch
        # (dqn.py:405); size never shrinks, so it is read back only until
        # then
        warm = carry.warm and int(replay.size) < dq.batch_size
        if warm:
            frame, ts = carry.frame, carry.ts
            loss = torch.zeros((), device=device)
        else:
            replay, frame, ts, loss = learner.train_step_with_trustset(
                replay, carry.frame, carry.ts, draws.gumbel,
                use_kernel=use_kernel)

        metrics = {
            "loss": loss,
            "reward_mean": reward.mean(),
            "pushed": recs.valid.sum(dtype=torch.int32),
            "segments_closed": hold.tail.sum(dtype=torch.int32),
            "replay_size": replay.size,
            "ts_rows": ts.store.size,
            "held_fraction": (~hold.fresh).to(torch.float32).mean(),
        }
        return TrustsetCarry(env=env2, hold=hold, replay=replay, frame=frame,
                             ts=ts, warm=warm), metrics

    def step(carry: TrustsetCarry, generator: torch.Generator):
        return with_draws(carry, draw(generator), generator)

    runner = graphs.TickRunner(
        lambda carry, _inputs, generator: step(carry, generator),
        device.type == "cuda", state=learner.state_tensors, name="trustset")

    def run_fn(carry: TrustsetCarry, generator: torch.Generator,
               n_steps: int = 16):
        # warm steps eagerly (each reads the replay's size back); from the
        # first warm-free step on, the runner (``warm`` is a constant of
        # its carry)
        ms = []
        while carry.warm and len(ms) < n_steps:
            carry, m = step(carry, generator)
            ms.append(m)
        parts = [{k: torch.stack([m[k] for m in ms]) for k in METRIC_KEYS}
                 ] if ms else []
        if len(ms) < n_steps:
            carry, rest = runner(carry, (), n_steps - len(ms), generator)
            parts.append(rest)
        return carry, {k: torch.cat([p[k] for p in parts])
                       for k in METRIC_KEYS}

    run_fn.step = step
    run_fn.with_draws = with_draws
    run_fn.draw = draw
    run_fn.learner = learner
    run_fn.runner = runner
    return init_fn, run_fn
