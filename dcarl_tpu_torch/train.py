"""The integrated DCARL training step, batch first (``dcarl_tpu/train.py``).

One step, for each rank's B envs (the reference's planner, gym server,
RLS gate and DQN as one loop, SURVEY.md §3.3):

  1. plan: the Werling lattice and the rule pick of every env
  2. query: the store's statistics of the rule action (train mode)
  3. gate: the RLS train gate over the epsilon-greedy DQN proposal
  4. drive: control the chosen trajectory, step the env (auto-reset)
  5. record: trajectory-buffer flush and backfill into the store
  6. learn: a prioritized TD step, gradients averaged over the ranks

This is the readable account of the step that ``train_fast.py`` lays out
lane-major for speed: the planner, controller and env step are the
batch-first ones (``planning/werling.py``, ``control/controller.py``,
``env/driving_env.py``); the trajectory buffers push through the batched
``core/rls.traj_push_lane`` on transposed views (the same records, in
the same order, as JAX's vmapped ``traj_buffer_push``).

Over a mesh the query all-gathers the observations, asks this rank's
rows for the whole batch and reduce-scatters the moments, as
``train_fast.py`` and the gated driver do.  JAX's ``train.py:223-225``
adds the ranks' local-batch moments instead (``psum``), which mixes the
statistics of different envs that share a local index whenever envs
differ across ranks; the two agree where the envs coincide across ranks.

The learner (online and target networks, Adam) is the trainer's ``DQN``
object and changes in place; :class:`TrainState` holds the rest.  Every
random input of a step but the env's auto-reset jitter comes in through
``train_fast.TrainDraws``.
"""

from __future__ import annotations

from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import DCARLConfig
from dcarl_tpu_torch.core import rls as RLS
from dcarl_tpu_torch.core import store as ST
from dcarl_tpu_torch.core.store import (ConfidenceStore, _raw_moments,
                                        moments_to_stats)
from dcarl_tpu_torch.env import driving_env as de
from dcarl_tpu_torch.env.scenario import Scenario, t_intersection
from dcarl_tpu_torch.models import dqn as DQ
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models.networks import AttentionQNet
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel.mesh import ProcessMesh
from dcarl_tpu_torch.planning import werling as W
from dcarl_tpu_torch.planning.rollout import (_control,
                                              _obstacles_from_obs_ori,
                                              _setup)


class StepMetrics(NamedTuple):
    reward_mean: torch.Tensor
    done_count: torch.Tensor
    pass_count: torch.Tensor
    collision_count: torch.Tensor
    loss: torch.Tensor
    rule_fraction: torch.Tensor
    store_rows: torch.Tensor
    # terminal-backfill records dropped by the fixed compaction budget
    # (0 when the budget is disabled or sufficient)
    dropped_records: torch.Tensor


N_METRICS = len(StepMetrics._fields)


class TrainState(NamedTuple):
    """The readable trainer's state but the learner's: batch first, with
    the leading shard axis (size 1 on each rank) of JAX's ``TrainState``."""

    env: de.EnvState               # [S, B, ...]
    obs_ori: torch.Tensor          # [S, B, 20]
    traj_obs: torch.Tensor         # [S, B, W, 20]
    traj_act: torch.Tensor         # [S, B, W]
    traj_rew: torch.Tensor         # [S, B, W]
    traj_len: torch.Tensor         # [S, B] i32
    store_keys: torch.Tensor       # [S, N, 21]
    store_actions: torch.Tensor    # [S, N]
    store_values: torch.Tensor     # [S, N]
    store_size: torch.Tensor       # [S] i32
    store_head: torch.Tensor       # [S] i32
    replay: RB.Replay              # [S, ...]
    frame: torch.Tensor            # [] i32


def _lead(x):
    if isinstance(x, torch.Tensor):
        return x[None]
    return type(x)(*(t[None] for t in x))


def _shard0(x):
    if isinstance(x, torch.Tensor):
        return x[0]
    return type(x)(*(t[0] for t in x))


def reduce_metrics(m: StepMetrics, mesh: "ProcessMesh | None") -> StepMetrics:
    """A step's metrics over the mesh (JAX ``train.py:352-361``): the
    means ``pmean``, the counts ``psum``; the loss comes averaged from
    the learner."""
    if mesh is None or mesh.size == 1:
        return m
    means = ("reward_mean", "rule_fraction")
    return StepMetrics(**{
        k: v if k == "loss" else
        (coll.pmean(v, mesh) if k in means else coll.psum(v, mesh))
        for k, v in m._asdict().items()})


def make_trainer(
    cfg: DCARLConfig = DCARLConfig(),
    batch_per_device: int = 32,
    store_capacity_per_device: int = 1 << 14,
    replay_capacity_per_device: int = 1 << 14,
    scenario: Optional[Scenario] = None,
    dtype: torch.dtype = torch.float32,
    device: "str | torch.device | None" = None,
    mesh: "ProcessMesh | None" = None,
):
    """Build ``(init_fn, step_fn, learner)``:

      init_fn(seed)             -> TrainState (and re-initializes the
                                   learner from ``seed``)
      step_fn(state, generator) -> (state, StepMetrics)
      step_fn.with_draws(state, draws, generator) -> the same step with
                                   the given ``train_fast.TrainDraws``
      step_fn.draw(generator)   -> the draws ``step_fn`` uses

    ``mesh``: this rank's trainer of a sharded one (its device is the
    mesh's); ``init_fn`` draws the starts of all S x B envs and keeps the
    rank's block.  ``device=None`` runs on ``cuda`` (which must exist)."""
    from dcarl_tpu_torch.train_fast import TrainDraws, make_draws

    if mesh is not None:
        device = mesh.device
    env_cfg, wcfg, scfg = cfg.env, cfg.werling, cfg.store
    if scfg.value_mode == "episode" \
            and scfg.n_step_window < env_cfg.max_episode_steps:
        raise ValueError(
            f"value_mode='episode' needs n_step_window "
            f"({scfg.n_step_window}) >= max_episode_steps "
            f"({env_cfg.max_episode_steps})")
    sc = scenario or t_intersection(env_cfg)
    device, sa, idx, ref_line, rp = _setup(sc, dtype, device)
    half_widths = torch.as_tensor(
        np.asarray(scfg.half_widths or ST.FIELD_HALF_WIDTHS, np.float32),
        device=device)
    num_actions = wcfg.num_paths + 1
    obs_dim = env_cfg.state_dim
    b = batch_per_device
    n_shards = 1 if mesh is None else mesh.size
    rank = 0 if mesh is None else mesh.rank
    dq = cfg.dqn

    def make_net(seed: int) -> AttentionQNet:
        return AttentionQNet(num_actions, token_dim=dq.token_dim,
                             width=dq.attention_width, hidden=dq.hidden_dim,
                             generator=torch.Generator().manual_seed(seed)
                             ).to(device)

    learner = DQ.DQN(make_net(0), cfg=dq)

    def init_fn(seed: int = 0) -> TrainState:
        gen = torch.Generator(device=device).manual_seed(seed)
        env_all = de.reset(sa, n_shards * b, gen, env_cfg)
        env = de.EnvState(*(t[rank * b:(rank + 1) * b] for t in env_all))
        _, obs_ori = de.wrap_state(env, sa, idx, env_cfg)
        learner.reset(make_net(seed))
        w = scfg.n_step_window

        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return TrainState(
            env=_lead(env), obs_ori=obs_ori[None],
            traj_obs=z(1, b, w, obs_dim), traj_act=z(1, b, w),
            traj_rew=z(1, b, w), traj_len=z(1, b, dt=torch.int32),
            store_keys=z(1, store_capacity_per_device, obs_dim + 1),
            store_actions=z(1, store_capacity_per_device),
            store_values=z(1, store_capacity_per_device),
            store_size=z(1, dt=torch.int32), store_head=z(1, dt=torch.int32),
            replay=_lead(RB.replay_init(replay_capacity_per_device, obs_dim,
                                        device=device)),
            frame=z(dt=torch.int32))

    def draw(generator: torch.Generator) -> "TrainDraws":
        return make_draws(generator, b, num_actions, scfg, dq,
                          replay_capacity_per_device, device)

    def with_draws(state: TrainState, draws: "TrainDraws",
                   generator: torch.Generator
                   ) -> Tuple[TrainState, StepMetrics]:
        obs_ori = state.obs_ori[0]                           # [B, 20]
        store = ConfidenceStore(state.store_keys[0], state.store_actions[0],
                                state.store_values[0], state.store_size[0],
                                state.store_head[0])

        # 1. plan every candidate of every env, and the rule pick
        obstacles, valid = _obstacles_from_obs_ori(obs_ori)
        plans = W.plan_with_rule(rp, ref_line, obs_ori[:, :5], obstacles,
                                 valid, wcfg)

        # 2. the rule action's statistics: the whole batch against this
        # rank's rows, reduce-scattered back to its envs
        obs_q = obs_ori if mesh is None else coll.all_gather(obs_ori, mesh)
        flat_q = RLS.state_with_action(
            obs_q, torch.zeros(obs_q.shape[0], dtype=obs_q.dtype,
                               device=device))
        moments = _raw_moments(store.keys, store.values,
                               ST.store_valid(store), flat_q, half_widths)
        if mesh is not None:
            moments = coll.reduce_scatter(moments, mesh)
        qs = moments_to_stats(moments)
        stats = RLS.ActionStats(*(f[:, None] for f in qs))

        # 3. the DQN proposes, the RLS gate decides (deepq/dqn.py:226-236)
        rl_action = learner.act_epsilon_greedy(
            obs_ori, state.frame, draws.eps_uniform, draws.random_action)
        env_action = RLS.act_train(stats, rl_action, draws.gate_uniform, scfg)

        # 4. gated action 0 follows the rule policy's pick; the recorded
        # action stays env_action
        exec_index = torch.where(env_action == 0, plans.rule_index,
                                 env_action.to(plans.rule_index.dtype))
        traj = W.trajectory_by_index(plans.lattice, exec_index)
        action = _control(obs_ori, traj.xy, traj.desired_speed)
        env2, _, reward, done, obs_ori2 = de.step_autoreset(
            _shard0(state.env), action, generator, sa, idx, env_cfg)

        # 5. trajectory buffers -> records (RLS.add_data): flushes first,
        # then the terminal backfills, env by env
        bufs, recs = RLS.traj_push_lane(
            state.traj_obs[0].permute(1, 2, 0), state.traj_act[0].T,
            state.traj_rew[0].T, state.traj_len[0], obs_ori.T, env_action,
            reward, done, scfg)
        new_store = ST.store_insert(store, recs.keys[0].T, recs.actions[0],
                                    recs.values[0], recs.valid[0])
        new_store = ST.store_insert(
            new_store, recs.keys[1:].permute(2, 0, 1).reshape(-1, obs_dim + 1),
            recs.actions[1:].T.reshape(-1), recs.values[1:].T.reshape(-1),
            recs.valid[1:].T.reshape(-1))

        # 6. replay push and a prioritized TD step, gradients averaged
        # over the ranks
        replay = RB.replay_push(_shard0(state.replay), obs_ori, env_action,
                                reward, obs_ori2, done.to(torch.float32))
        batch = RB.replay_sample(replay, draws.gumbel,
                                 alpha=dq.priority_alpha,
                                 beta=DQ.beta_by_frame(state.frame, dq))
        loss, prios = learner.train_on(
            batch, torch.zeros(dq.batch_size, device=device), mesh=mesh)
        replay = RB.replay_update_priorities(replay, batch.indices, prios)
        frame = (state.frame + 1).to(torch.int32)
        learner.update_target((frame % dq.target_update_every) == 0)

        metrics = reduce_metrics(StepMetrics(
            reward_mean=reward.mean(),
            done_count=done.sum(),
            pass_count=(env2.passed & done).sum(),
            collision_count=(env2.collided & done).sum(),
            loss=loss,
            rule_fraction=(env_action == 0).to(torch.float32).mean(),
            store_rows=new_store.size,
            dropped_records=torch.zeros((), dtype=torch.int32,
                                        device=device)), mesh)
        new_state = TrainState(
            env=_lead(env2), obs_ori=obs_ori2[None],
            traj_obs=bufs[0].permute(2, 0, 1)[None],
            traj_act=bufs[1].T[None], traj_rew=bufs[2].T[None],
            traj_len=bufs[3][None],
            store_keys=new_store.keys[None],
            store_actions=new_store.actions[None],
            store_values=new_store.values[None],
            store_size=new_store.size[None], store_head=new_store.head[None],
            replay=_lead(replay), frame=frame)
        return new_state, metrics

    def step_fn(state: TrainState, generator: torch.Generator
                ) -> Tuple[TrainState, StepMetrics]:
        return with_draws(state, draw(generator), generator)

    step_fn.with_draws = with_draws
    step_fn.draw = draw
    return init_fn, step_fn, learner
