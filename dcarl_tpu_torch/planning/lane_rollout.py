"""The lane-level gated fleet: the reference's ``RLSDecision`` agent
(zhcao92/DCARL ``learning.py:91-208``) behind the confidence gate
(``deepq/RLS.py:120-157``), driving the multilane world
(``env/multilane_env.py``) in lockstep over one store.

Each tick every env reads its 20-D lane state (``wrap_state``), asks the
store for (count, sum v, sum v^2) of each of its 8 candidate keys
``state || a``, runs the Welch z-test gate and maps the pick (0 = the
LaneUtility rule) onto a (target lane, target speed) command for the env
step.  The query is the flat sorted-band one at D = 21: the store is
prepared once a run (:func:`store_kernels.prepare_sorted_store`) and each
tick's B * 8 queries are asked against it
(:func:`store_kernels.query_sorted_prepared`).  On a CUDA device a run
replays one captured CUDA graph a tick (``utils/graphs.TickRunner``); on
the CPU it is the eager loop, the reference a replay is held to bit for
bit.  The JAX package runs this loop only op by op, so this module has no
counterpart there.

:func:`fill_lane_store` fills the store such a fleet deploys with: a
behaviour policy's records, as the lane world's trajectories give them.
"""

from __future__ import annotations

from typing import Tuple

import torch

from dcarl_tpu_torch.config import StoreConfig
from dcarl_tpu_torch.core import rls as RLS
from dcarl_tpu_torch.core import store as ST
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.env import multilane_env as ML
from dcarl_tpu_torch.ops import store_kernels
from dcarl_tpu_torch.planning import decision as DEC
from dcarl_tpu_torch.utils import graphs, profiling


def make_lane_gated_driver_fast(
        env_cfg: ML.MultiLaneEnvConfig = ML.MultiLaneEnvConfig(),
        store_cfg: StoreConfig = StoreConfig(),
        dtype: torch.dtype = torch.float32,
        device: "str | torch.device | None" = None):
    """The lane gate loop (``wrap_state -> all_action_stats -> act_test ->
    decision_from_discrete_action -> step_autoreset``) as a lockstep
    fleet against a fixed store.

    Returns (init_fn, run_fn):
      init_fn(batch, generator) -> carry (a ``MultiLaneEnvState``)
      run_fn(carry, n_steps, store_keys[N, 21], store_values[N],
             store_valid[N], generator=...)
          -> (carry, (reward, done, collided, left_road, gated_action)),
             each [S, B]
    ``gated_action`` is the z-test output (0 = the rule's command).

    The query is the flat sorted-band one against the store prepared
    once per ``run_fn`` call; on CPU tensors it takes the kernel's plain
    version.  ``run_fn.inputs(store_keys, store_values, store_valid)`` gives what a
    run's ticks read; ``run_fn.runner`` is the ``TickRunner``.

    Traced (``utils/profiling``), a tick's phases are ``observe`` (the
    lane state, ``wrap_state`` and the [B * 8, 21] candidate keys),
    ``query``, ``gate`` (the moments' statistics and the Welch test) and
    ``env_step`` (the command and the env step), and a call's store
    prepare is the host span ``dcarl.store_prepare``; the runner is
    ``lane``."""
    device = resolve_device(device)
    n_act = store_cfg.num_candidate_actions
    hw = store_cfg.half_widths or ST.FIELD_HALF_WIDTHS
    if len(hw) != store_cfg.key_dim:
        raise ValueError(f"{len(hw)} half-widths for key_dim "
                         f"{store_cfg.key_dim}")
    half_widths = torch.tensor(hw, dtype=torch.float32, device=device)

    def init_fn(batch: int, generator: torch.Generator) -> ML.MultiLaneEnvState:
        return ML.reset(batch, generator, env_cfg, dtype, device)

    def run_inputs(store_keys, store_values, store_valid):
        """What every tick of a run reads: the prepared store."""
        with profiling.span("dcarl.store_prepare"):
            return store_kernels.prepare_sorted_store(
                torch.as_tensor(store_keys, device=device),
                torch.as_tensor(store_values, device=device),
                torch.as_tensor(store_valid, device=device), half_widths)

    def tick(st: ML.MultiLaneEnvState, store, generator: torch.Generator):
        with profiling.phase("observe"):
            m = ML.to_multilane_state(st, env_cfg)
            obs = DEC.wrap_state(m)                              # [B, 20]
            b = obs.shape[0]
            keys = RLS.candidate_keys(obs, n_act).reshape(b * n_act, -1)
        with profiling.phase("query"):
            moments = store_kernels.query_sorted_prepared(store, keys)
        with profiling.phase("gate"):
            stats = RLS.ActionStats(*(f.reshape(b, n_act) for f in
                                      ST.moments_to_stats(moments)))
            g = RLS.act_test(stats, store_cfg)                   # [B]
        with profiling.phase("env_step"):
            d = DEC.decision_from_discrete_action(m, g)
            st, reward, done = ML.step_autoreset(
                st, d.target_lane_index, d.target_speed, generator, env_cfg)
        return st, (reward, done, st.collided, st.left_road, g)

    runner = graphs.TickRunner(tick, device.type == "cuda", name="lane")

    def run_fn(carry: ML.MultiLaneEnvState, n_steps: int, store_keys,
               store_values, store_valid, *, generator: torch.Generator):
        return runner(carry, run_inputs(store_keys, store_values,
                                        store_valid), n_steps, generator)

    run_fn.inputs = run_inputs
    run_fn.runner = runner
    return init_fn, run_fn


def fill_lane_store(env_cfg: ML.MultiLaneEnvConfig = ML.MultiLaneEnvConfig(),
                    store_cfg: StoreConfig = StoreConfig(value_mode="nstep"),
                    envs: int = 2048, ticks: int = 128,
                    capacity: "int | None" = None, seed: int = 0,
                    device: "str | torch.device | None" = None
                    ) -> Tuple[ST.ConfidenceStore, torch.Tensor]:
    """A lane store filled by a behaviour policy: ``envs`` lockstep envs
    for ``ticks`` ticks from ``seed``, each tick taking the rule (action
    0) with probability 0.5, else an action uniform in 1..A-1; each
    record is ``wrap_state || action`` with its return as
    ``store_cfg.value_mode`` makes it (``traj_push_lane``: reward 1 a
    surviving tick), appended to a ring of ``capacity`` rows
    (``store_cfg.capacity`` by default), oldest rows overwritten.

    Returns the store and the number of records written (an int64
    device scalar; more than the capacity where the ring wrapped)."""
    device = resolve_device(device)
    cap = store_cfg.capacity if capacity is None else capacity
    n_act, d = store_cfg.num_candidate_actions, store_cfg.key_dim
    w = store_cfg.n_step_window
    gen = torch.Generator(device=device).manual_seed(int(seed))
    store = ST.store_init(cap, d, device=device)
    st = ML.reset(envs, gen, env_cfg, device=device)
    buf = (torch.zeros((w, d - 1, envs), device=device),
           torch.zeros((w, envs), device=device),
           torch.zeros((w, envs), device=device),
           torch.zeros((envs,), dtype=torch.int32, device=device))
    written = torch.zeros((), dtype=torch.int64, device=device)
    for _ in range(ticks):
        m = ML.to_multilane_state(st, env_cfg)
        obs = DEC.wrap_state(m)
        rule = torch.rand((envs,), generator=gen, device=device) < 0.5
        a = torch.where(rule, 0, torch.randint(1, n_act, (envs,),
                                               generator=gen, device=device))
        dec = DEC.decision_from_discrete_action(m, a)
        st, r, done = ML.step_autoreset(st, dec.target_lane_index,
                                        dec.target_speed, gen, env_cfg)
        buf, recs = RLS.traj_push_lane(*buf, obs.T, a, r, done, store_cfg)
        store = ST.store_insert(
            store, recs.keys.permute(0, 2, 1).reshape(-1, d),
            recs.actions.reshape(-1), recs.values.reshape(-1),
            recs.valid.reshape(-1))
        written += recs.valid.sum()
    return store, written
