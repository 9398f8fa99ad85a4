"""Lane-major integrated DCARL training step (``dcarl_tpu/train_fast.py``).

One step, for B lockstep envs:

  plan -> rule-column store query -> RLS train gate -> epsilon-greedy
  DQN proposal -> drive -> trajectory-buffer flush -> store insert ->
  prioritized TD step

The planning/env half is lane-major (batch last), as in the gated driver
(``planning/fast_rollout.py``, whose ``_plan_tick`` and ``_follow`` it
reuses); the learner half (Q-network, replay, TD update) is batch-first.
On CUDA the store query runs through the sorted-band kernel
(``csrc/sorted_moments.cu``, once per step) on the action-0 column.

Over a mesh (``mesh=``, one rank a device, :mod:`dcarl_tpu_torch.parallel`)
each rank steps its own block of envs, its own store shard and its own
replay; the learner is replicated.  The state keeps the JAX state's
leading shard axis, of size 1 on each rank, so the two map field by
field (``interop.fast_train_state_from_numpy``; the JAX layout, leading
axis = world size, is assembled only where a checkpoint is written).
The JAX step's collectives are those of ``parallel/collectives.py``:
the rule-column query all-gathers the observations, asks the rank's
rows for the whole batch and reduce-scatters the moments (every env's
gate sees the whole store); the gradients and the loss go through one
``pmean``, the metrics through ``psum`` / ``pmean``.  On one rank (or
with no mesh) each is the identity and issues nothing.

The learner's weights, target weights and Adam moments live in the
``DQN`` object returned beside the step and change in place each step;
``FastTrainState`` holds the rest, functionally (each step returns new
tensors).  Every random input of a step but the env's auto-reset
jitter comes in through :class:`TrainDraws`, so a test can feed the JAX
package's draws; ``step_fn`` makes them from a ``torch.Generator``,
which on rank r of a mesh is the rank's own (:func:`rank_seed`, the
counterpart of JAX's ``fold_in(key, axis_index)``).  Nothing in a step
waits on the device.

On CUDA a run of steps replays one captured CUDA graph of a step
(``utils/graphs.py``), as JAX jits its scan of steps; the learner's
Adam is then ``capturable`` (its state on the device), and so is the
eager loop's on the card, so the two give the same bits.

Traced (``utils/profiling``), a step's phases are ``draw`` (the step's
draws, in ``step_fn``) and, along ``with_draws``' numbered comments,
``plan`` (1), ``rule_query`` (2), ``propose_gate`` (3-4), ``env_step``
(5), ``store_write`` (6: the trajectory push, the backfill compaction,
both inserts) and ``td_step`` (7: replay push and sample, the TD update,
priorities, target update, metrics); the runner is ``train``.
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
from dcarl_tpu_torch.env.scenario import Scenario, t_intersection
from dcarl_tpu_torch.models import dqn as DQ
from dcarl_tpu_torch.models import replay as RB
from dcarl_tpu_torch.models.networks import AttentionQNet
from dcarl_tpu_torch.ops import store_kernels
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel.mesh import ProcessMesh
from dcarl_tpu_torch.planning import fast_rollout as FR
from dcarl_tpu_torch.train import StepMetrics, reduce_metrics
from dcarl_tpu_torch.utils import graphs, profiling


class FastTrainState(NamedTuple):
    """The trainer's state but the learner's (leading axis S = 1)."""

    env: FR.FastEnvState           # [S, ..., B] lane-major
    obs_ori: torch.Tensor          # [S, 20, B]
    traj_obs: torch.Tensor         # [S, W, 20, B]
    traj_act: torch.Tensor         # [S, W, B]
    traj_rew: torch.Tensor         # [S, W, B]
    traj_len: torch.Tensor         # [S, B] i32
    store_keys: torch.Tensor       # [S, N, 21]
    store_actions: torch.Tensor    # [S, N]
    store_values: torch.Tensor     # [S, N]
    store_size: torch.Tensor       # [S] i32
    store_head: torch.Tensor       # [S] i32
    # cumulative ring slots written (i32, wrapping): exact insert counts
    # between snapshots, which the head alone aliases
    store_total: torch.Tensor      # [S] i32
    replay: RB.Replay              # [S, ...]
    frame: torch.Tensor            # [] i32


class TrainDraws(NamedTuple):
    """Every random input of one step except the env's auto-reset."""

    eps_uniform: torch.Tensor    # [B] U(0, 1): explore where < epsilon
    random_action: torch.Tensor  # [B] uniform in 0..A-1
    gate_uniform: torch.Tensor   # [B] U(explore_low, explore_high)
    gumbel: torch.Tensor         # [batch_size, replay_capacity] Gumbel(0, 1)


def _lead(x):
    """Add the shard axis to a tensor or every field of a NamedTuple."""
    if isinstance(x, torch.Tensor):
        return x[None]
    return type(x)(*(t[None] for t in x))


def _shard0(x):
    if isinstance(x, torch.Tensor):
        return x[0]
    return type(x)(*(t[0] for t in x))


def make_draws(generator: torch.Generator, b: int, num_actions: int, scfg,
               dq, replay_capacity: int, device) -> TrainDraws:
    """One step's :class:`TrainDraws` for ``b`` envs from ``generator``."""
    u = torch.rand((3, b), generator=generator, device=device)
    return TrainDraws(
        eps_uniform=u[0],
        random_action=torch.randint(0, num_actions, (b,),
                                    generator=generator, device=device),
        gate_uniform=scfg.explore_low
        + u[1] * (scfg.explore_high - scfg.explore_low),
        gumbel=RB.gumbel_noise((dq.batch_size, replay_capacity), generator,
                               device=device))


def rank_seed(seed: int, rank: int) -> int:
    """The seed of rank ``rank``'s step generator: ``seed`` itself on
    rank 0 (so one rank draws as an unsharded run does), a distinct
    stream on every other rank."""
    return (seed + rank * 0x9E3779B97F4A7C15) % (1 << 63)


def snapshot(state):
    """A copy of a trainer state (every tensor cloned; host flags kept):
    a run from it leaves the original as it was."""
    if isinstance(state, torch.Tensor):
        return state.clone()
    if isinstance(state, tuple):
        return type(state)(*(snapshot(x) for x in state))
    return state


def _compact(rows: torch.Tensor, dest: torch.Tensor, k: int) -> torch.Tensor:
    """[k, ...] rows at their ``dest`` positions, zeros elsewhere; a dest
    of ``k`` drops its row."""
    buf = rows.new_zeros((k + 1,) + rows.shape[1:])
    return buf.index_copy_(0, dest, rows)[:k]


def make_trainer_fast(
    cfg: DCARLConfig = DCARLConfig(),
    batch_per_device: int = 1024,
    store_capacity_per_device: int = 1 << 14,
    replay_capacity_per_device: int = 1 << 14,
    scenario: Optional[Scenario] = None,
    use_kernel: Optional[bool] = None,
    backfill_budget_per_step: Optional[int] = None,
    dense_store_writes: bool = False,
    init_step_offset: bool = False,
    dtype: torch.dtype = torch.float32,
    device: "str | torch.device | None" = None,
    mesh: "ProcessMesh | None" = None,
):
    """Build ``(init_fn, step_fn, learner, run_fn_factory)``:

      init_fn(seed)             -> FastTrainState (and re-initializes the
                                   learner from ``seed``)
      step_fn(state, generator) -> (state, StepMetrics)
      step_fn.with_draws(state, draws, generator) -> the same step with
                                   the given :class:`TrainDraws`
      step_fn.draw(generator)   -> the TrainDraws ``step_fn`` uses
      run_fn_factory(n)         -> run_fn(state, generator) taking n
                                   steps, metrics stacked to [n]

    On CUDA without ``mesh`` a ``run_fn`` replays one captured CUDA graph
    a step (the runner, shared by every factory's ``run_fn``, is
    ``run_fn.runner``); elsewhere it runs the eager loop,
    ``graphs.run_loop(run_fn.runner.tick, ...)``, the same bits.
    ``step_fn`` is always eager.

    ``use_kernel`` (None = on CUDA) queries through the sorted-band
    kernel route (``store_kernels.box_query_moments_grouped``; its plain
    version on CPU tensors); False through the brute ``_raw_moments``.
    ``device=None`` runs on ``cuda`` (which must exist).

    ``backfill_budget_per_step`` compacts each step's terminal-backfill
    records into that many rows (drops are counted in
    ``dropped_records``); ``dense_store_writes`` (needs a budget) writes
    one contiguous [B + budget] block per step with sentinel keys for
    invalid rows.  ``init_step_offset`` staggers each env's first
    episode by a random initial step count; in ``value_mode="episode"``
    the records of those truncated first episodes are dropped.

    ``mesh``: this rank's trainer of a sharded one (``batch_per_device``
    envs, ``store_capacity_per_device`` rows and its replay on the rank,
    the learner replicated; ``device`` is the mesh's).  ``init_fn(seed)``
    draws the starts of all S x B envs as JAX does and keeps the rank's
    block; pass each rank a generator of its own (:func:`rank_seed`)."""
    if mesh is not None:
        device = mesh.device
    env_cfg, wcfg, scfg = cfg.env, cfg.werling, cfg.store
    if scfg.value_mode == "episode" \
            and scfg.n_step_window < env_cfg.max_episode_steps:
        raise ValueError(
            f"value_mode='episode' needs n_step_window "
            f"({scfg.n_step_window}) >= max_episode_steps "
            f"({env_cfg.max_episode_steps}) so every record's episode "
            "boundary is inside the window")
    if dense_store_writes and backfill_budget_per_step is None:
        raise ValueError("dense_store_writes requires backfill_budget_per_step")
    sc = scenario or t_intersection(env_cfg)
    device, sa, idx, tab, env_init = FR._setup(sc, env_cfg, dtype, device)
    if use_kernel is None:
        use_kernel = device.type == "cuda"

    half_widths = torch.as_tensor(
        np.asarray(scfg.half_widths or ST.FIELD_HALF_WIDTHS, np.float32),
        device=device)
    num_actions = wcfg.num_paths + 1
    obs_dim = env_cfg.state_dim
    n_obj = (obs_dim - 5) // 5
    n_v = len(wcfg.target_speeds)
    b = batch_per_device
    dq = cfg.dqn

    def make_net(seed: int) -> AttentionQNet:
        return AttentionQNet(num_actions, token_dim=dq.token_dim,
                             width=dq.attention_width, hidden=dq.hidden_dim,
                             generator=torch.Generator().manual_seed(seed)
                             ).to(device)

    # capturable Adam on the card, graphed or not: both routes give the
    # same bits (torch takes it on CUDA tensors only)
    learner = DQ.DQN(make_net(0), cfg=dq, capturable=device.type == "cuda")

    # ------------------------------------------------------------------
    n_shards = 1 if mesh is None else mesh.size

    def init_fn(seed: int = 0) -> FastTrainState:
        gen = torch.Generator(device=device).manual_seed(seed)
        env = env_init(n_shards * b, gen)
        if init_step_offset:
            env = env._replace(step_count=torch.randint(
                0, env_cfg.max_episode_steps, (n_shards * b,), generator=gen,
                device=device, dtype=torch.int32))
        if mesh is not None:
            env = FR.shard_lanes(env, mesh)
        learner.reset(make_net(seed))
        w = scfg.n_step_window

        def z(*shape, dt=dtype):
            return torch.zeros(shape, dtype=dt, device=device)

        return FastTrainState(
            env=_lead(env),
            obs_ori=FR._obs_ori_soa(env, idx)[None],
            traj_obs=z(1, w, obs_dim, b), traj_act=z(1, w, b),
            traj_rew=z(1, w, b), traj_len=z(1, b, dt=torch.int32),
            store_keys=z(1, store_capacity_per_device, obs_dim + 1),
            store_actions=z(1, store_capacity_per_device),
            store_values=z(1, store_capacity_per_device),
            store_size=z(1, dt=torch.int32), store_head=z(1, dt=torch.int32),
            store_total=z(1, dt=torch.int32),
            replay=_lead(RB.replay_init(replay_capacity_per_device, obs_dim,
                                        device=device)),
            frame=z(dt=torch.int32))

    # ------------------------------------------------------------------
    def draw(generator: torch.Generator) -> TrainDraws:
        return make_draws(generator, b, num_actions, scfg, dq,
                          replay_capacity_per_device, device)

    def query_rule_column(store: ConfidenceStore, obs_bf: torch.Tensor
                          ) -> torch.Tensor:
        """[B, 3] moments of the keys obs || 0.  TRAIN mode reads only the
        rule action's statistics (should_use_rule), so only the action-0
        column is queried.  Over a mesh: the whole batch's observations
        against this rank's rows, reduce-scattered back to its envs."""
        valid = ST.store_valid(store)
        obs_q = obs_bf if mesh is None else coll.all_gather(obs_bf, mesh)
        zeros = torch.zeros((obs_q.shape[0], 1), dtype=obs_q.dtype,
                            device=device)
        if use_kernel:
            queries_g = torch.cat([obs_q, zeros], dim=1)[None]  # [1, B, D]
            moments = store_kernels.box_query_moments_grouped(
                store.keys, store.values, valid, queries_g, half_widths)[0]
        else:
            moments = _raw_moments(store.keys, store.values, valid,
                                   torch.cat([obs_q, zeros], dim=1),
                                   half_widths)
        return moments if mesh is None else coll.reduce_scatter(moments, mesh)

    def with_draws(state: FastTrainState, draws: TrainDraws,
                   generator: torch.Generator
                   ) -> Tuple[FastTrainState, StepMetrics]:
        env = _shard0(state.env)
        store = ConfidenceStore(state.store_keys[0], state.store_actions[0],
                                state.store_values[0], state.store_size[0],
                                state.store_head[0])

        # 1. plan all candidates (lane-major lattice) + the rule pick
        with profiling.phase("plan"):
            tick = FR._plan_tick(env, idx, tab, wcfg, n_obj)
            obs = tick.obs                                  # [20, B]
            obs_bf = obs.T                                  # [B, 20]

        # 2. confidence stats of the rule column
        with profiling.phase("rule_query"):
            qs = moments_to_stats(query_rule_column(store, obs_bf))
            stats = RLS.ActionStats(*(f[:, None] for f in qs))

        # 3-4. DQN proposes, RLS gates (deepq/dqn.py:226-236)
        with profiling.phase("propose_gate"):
            rl_action = learner.act_epsilon_greedy(
                obs_bf, state.frame, draws.eps_uniform, draws.random_action)
            env_action = RLS.act_train(stats, rl_action, draws.gate_uniform,
                                       scfg)

        # 5. gated action 0 follows the rule policy's pick (which brakes
        # only when no path is collision-free); the recorded action
        # stays env_action
        with profiling.phase("env_step"):
            exec_index = torch.where(env_action == 0, tick.rule_index,
                                     env_action.to(torch.int64))
            env2, reward, done = FR._follow(tick, exec_index, n_v, env,
                                            generator, sa, env_cfg)
            obs2 = FR._obs_ori_soa(env2, idx)

        # 6. trajectory-buffer push -> store records (RLS.add_data)
        with profiling.phase("store_write"):
            bufs, recs = RLS.traj_push_lane(
                state.traj_obs[0], state.traj_act[0], state.traj_rew[0],
                state.traj_len[0], obs, env_action, reward, done, scfg)
            if scfg.value_mode == "episode":
                # warmup filter: a buffer shorter than its episode's step
                # count started mid-episode (init_step_offset) and would
                # record truncated returns
                on_time = state.traj_len[0] == env.step_count
                recs = recs._replace(valid=recs.valid & on_time[None, :])
            # terminal backfills, env-major (the batch-first emission order)
            bk = recs.keys[1:].permute(2, 0, 1).reshape(-1, obs_dim + 1)
            ba = recs.actions[1:].T.reshape(-1)
            bv = recs.values[1:].T.reshape(-1)
            bm = recs.valid[1:].T.reshape(-1)
            if backfill_budget_per_step is not None:
                # compact the valid backfills to the front of a fixed
                # budget: each row's destination is its rank among the
                # valid rows
                kbud = int(backfill_budget_per_step)
                n_backfill = bm.sum()
                rank = torch.cumsum(bm.to(torch.int64), 0) - 1
                dest = torch.where(bm & (rank < kbud), rank, kbud)
                bk, ba, bv = (_compact(x, dest, kbud) for x in (bk, ba, bv))
                bm = torch.arange(kbud, device=device) \
                    < torch.clamp(n_backfill, max=kbud)
                dropped = torch.clamp(n_backfill - kbud,
                                      min=0).to(torch.int32)
            else:
                dropped = torch.zeros((), dtype=torch.int32, device=device)

            if dense_store_writes:
                new_store = ST.store_insert_dense_block(
                    store, torch.cat([recs.keys[0].T, bk]),
                    torch.cat([recs.actions[0], ba]),
                    torch.cat([recs.values[0], bv]),
                    torch.cat([recs.valid[0], bm]))
                # dense blocks take a slot per row, sentinel or not
                slots_written = b + bm.shape[0]
            else:
                new_store = ST.store_insert(store, recs.keys[0].T,
                                            recs.actions[0], recs.values[0],
                                            recs.valid[0])
                new_store = ST.store_insert(new_store, bk, ba, bv, bm)
                slots_written = recs.valid[0].sum() + bm.sum()

        # 7. replay push + prioritized TD step
        with profiling.phase("td_step"):
            replay = RB.replay_push(_shard0(state.replay), obs_bf,
                                    env_action, reward, obs2.T,
                                    done.to(torch.float32))
            beta = DQ.beta_by_frame(state.frame, dq)
            batch = RB.replay_sample(replay, draws.gumbel,
                                     alpha=dq.priority_alpha, beta=beta)
            loss, prios = learner.train_on(
                batch, torch.zeros(dq.batch_size, device=device), mesh=mesh)
            replay = RB.replay_update_priorities(replay, batch.indices,
                                                 prios)
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
                dropped_records=dropped), mesh)
            new_state = FastTrainState(
                env=_lead(env2), obs_ori=obs2[None],
                traj_obs=bufs[0][None], traj_act=bufs[1][None],
                traj_rew=bufs[2][None], traj_len=bufs[3][None],
                store_keys=new_store.keys[None],
                store_actions=new_store.actions[None],
                store_values=new_store.values[None],
                store_size=new_store.size[None],
                store_head=new_store.head[None],
                store_total=(state.store_total
                             + slots_written).to(torch.int32),
                replay=_lead(replay), frame=frame)
        return new_state, metrics

    def step_fn(state: FastTrainState, generator: torch.Generator
                ) -> Tuple[FastTrainState, StepMetrics]:
        with profiling.phase("draw"):
            draws = draw(generator)
        return with_draws(state, draws, generator)

    step_fn.with_draws = with_draws
    step_fn.draw = draw

    def tick(state: FastTrainState, _inputs, generator: torch.Generator):
        return step_fn(state, generator)

    runner = graphs.TickRunner(tick, device.type == "cuda" and mesh is None,
                               state=learner.state_tensors, name="train")

    def run_fn_factory(n_steps: int):
        """A runner of ``n_steps`` training steps (the metrics come back
        stacked to [n_steps])."""

        def run_fn(state: FastTrainState, generator: torch.Generator
                   ) -> Tuple[FastTrainState, StepMetrics]:
            return runner(state, (), n_steps, generator)

        run_fn.runner = runner
        return run_fn

    return init_fn, step_fn, learner, run_fn_factory

