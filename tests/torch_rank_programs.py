"""Rank programs of the port's multi-rank tests.

Each function here runs on every rank of a gloo group that
``dcarl_tpu_torch.parallel.launch.run_ranks`` starts, as
``fn(mesh, payload)``, and returns numpy arrays (or plain values) for
the test to compare.  The ranks import this module, torch, numpy and the
port, never JAX: the tests compute the JAX side in their own process and
hand the inputs over in ``payload``."""

from __future__ import annotations

import numpy as np
import torch

from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel import distributed as D
from dcarl_tpu_torch.parallel import normalize as NM
from dcarl_tpu_torch.parallel import sharded_store as SS
from dcarl_tpu_torch.parallel.mesh import replicate, shard_leading
from dcarl_tpu_torch.planning import fast_rollout as FR
from dcarl_tpu_torch.session import TrainSession, scatter_shards
from dcarl_tpu_torch.train_fast import rank_seed


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    if isinstance(x, tuple) and hasattr(x, "_fields"):
        return {k: _np(v) for k, v in x._asdict().items()}
    if isinstance(x, (list, tuple)):
        return [_np(v) for v in x]
    return x


# ---------------------------------------------------------------------------
# parallel/: collectives, sharded store, data-parallel Adam, normalisation
# ---------------------------------------------------------------------------

def parallel_checks(mesh, p):
    out = {"rank": mesh.rank, "size": mesh.size}
    t = {k: torch.as_tensor(v) for k, v in p["store"].items()}
    # collectives on this rank's own values
    x = torch.arange(6, dtype=torch.float32).reshape(3, 2) + 10 * mesh.rank
    out["all_gather"] = _np(coll.all_gather(x, mesh))
    out["reduce_scatter"] = _np(coll.reduce_scatter(
        torch.arange(4, dtype=torch.float32) * (mesh.rank + 1), mesh))
    out["pmean"] = _np(coll.pmean(torch.tensor([1.0 + mesh.rank]), mesh))
    out["replicated"] = _np(replicate(torch.tensor([7.0 * (mesh.rank + 1)]),
                                      mesh))
    try:
        coll.reduce_scatter(torch.zeros(3), mesh)
        out["odd_scatter_raised"] = False
    except ValueError:
        out["odd_scatter_raised"] = True

    # the sharded store: striped inserts, local shards, psum-ed stats
    st = SS.sharded_store_init(mesh, 256, t["keys"].shape[1],
                               dtype=torch.float64)
    st = SS.sharded_insert(st, t["keys"], t["actions"], t["values"],
                           t["mask"])
    out["local"] = _np(st.local)
    qs = SS.sharded_query_stats(st, t["queries"], t["w"])
    out["stats"] = _np(qs)
    acc = SS.sharded_store_init(mesh, 64, 3)
    for i in range(5):
        acc = SS.sharded_insert(acc, torch.full((4, 3), float(i)),
                                torch.zeros(4), torch.full((4,), float(i)),
                                torch.ones(4, dtype=torch.bool))
    out["accumulated_rows"] = int(coll.psum(acc.local.size, mesh))

    # data-parallel Adam: 3 steps on this rank's block of the batch
    w = torch.nn.Parameter(torch.as_tensor(p["w0"]).clone())
    opt = torch.optim.Adam([w], lr=1e-2)
    x_l, y_l = shard_leading((torch.as_tensor(p["x"]),
                              torch.as_tensor(p["y"])), mesh)
    step = D.make_data_parallel_update(
        lambda b: torch.mean((b[0] @ w - b[1]) ** 2), [w], opt, mesh)
    out["losses"] = [float(step((x_l, y_l))) for _ in range(3)]
    out["w"] = _np(w)
    out["w_norm"] = float(D.tree_replicated_norm([w.detach()]))

    # running mean / variance over the sharded batch
    rms = NM.rms_update_distributed(NM.rms_init((5,), device=mesh.device),
                                    shard_leading(torch.as_tensor(p["rms"]),
                                                  mesh), mesh)
    out["rms"] = _np(rms)
    return out


# ---------------------------------------------------------------------------
# planning/fast_rollout.py: the sharded rule and gated drivers
# ---------------------------------------------------------------------------

def _rows_block(x, mesh):
    """This rank's contiguous block of store rows (JAX's P(axis) rows)."""
    n = x.shape[0] // mesh.size
    return x[mesh.rank * n:(mesh.rank + 1) * n]


def driver_checks(mesh, p):
    out = {}
    gate = tcfg.driving_store_config(visited_times_thres=5,
                                     rl_visited_times_min=3)

    # the rule driver: each rank steps its block, no collective
    cfg0 = tcfg.EnvConfig(reset_jitter=0.0)
    init_r, run_r = FR.make_rule_driver_fast(t_intersection(cfg0), cfg0,
                                             device="cpu")
    init_s, run_s = FR.shard_rule_driver(init_r, run_r, mesh)
    carry = init_s(16, torch.Generator().manual_seed(0))
    _, o = run_s(carry, 12, torch.Generator().manual_seed(1))
    out["rule"] = _np(list(o))

    # the gated driver from JAX's starts (zero-jitter and jittered), f64,
    # on the brute route, and on the kernel route (its plain version)
    for name in ("exact", "jittered"):
        q = p[name]
        env_cfg = tcfg.EnvConfig(reset_jitter=q["jitter"])
        keys, vals, valid = (torch.as_tensor(_rows_block(q[k], mesh))
                             for k in ("keys", "values", "valid"))
        runs = {}
        for use_kernel in (False, True):
            _, run_g = FR.make_gated_driver_sharded(
                t_intersection(env_cfg), mesh, env_cfg, store_cfg=gate,
                dtype=torch.float64, use_kernel=use_kernel)
            carry = FR.shard_lanes(q["carry"], mesh)
            _, o = run_g(carry, q["steps"], keys, vals, valid,
                         generator=torch.Generator().manual_seed(2))
            runs[use_kernel] = _np(list(o))
        out[name] = runs[False]
        out[name + "_kernel_route"] = runs[True]
        # one tick's reduced moments: the whole batch's queries against
        # this rank's rows, reduce-scattered back to its envs
        obs = FR._obs_ori_soa(FR.shard_lanes(q["carry"], mesh),
                              q["in_state"]).T
        hw = torch.as_tensor(gate.half_widths, dtype=torch.float64)
        part = FR._raw_moments(keys.double(), vals.double(), valid,
                               coll.all_gather(obs, mesh), hw, 11)
        out[name + "_moments"] = _np(coll.reduce_scatter(part, mesh))
    return out


# ---------------------------------------------------------------------------
# train_fast.py / train.py: the sharded trainers
# ---------------------------------------------------------------------------

def _trainer_cfg(jitter):
    return tcfg.DCARLConfig(
        env=tcfg.EnvConfig(reset_jitter=jitter),
        dqn=tcfg.DQNConfig(batch_size=8, replay_capacity=256,
                           target_update_every=3))


def _params(learner):
    return {k: _np(v) for k, v in learner.net.state_dict().items()}


def trainer_checks(mesh, p):
    """The sharded fast trainer fed JAX's per-shard draws, from JAX's
    state; then the readable trainer against the fast one from the same
    start and the same draws (zero reset jitter)."""
    from dcarl_tpu_torch.train import make_trainer
    from dcarl_tpu_torch.train_fast import TrainDraws, make_trainer_fast

    out = {}
    kw = p["kw"]
    j = p["jax"]
    _, step_t, learner, _ = make_trainer_fast(
        _trainer_cfg(0.0), device="cpu", use_kernel=False, mesh=mesh, **kw)
    learner.load_state_dict(j["learner"])
    r = mesh.rank
    state = scatter_shards(j["state"], mesh)
    metrics = []
    for draws in j["draws"][r]:
        state, m = step_t.with_draws(state, TrainDraws(*draws),
                                     torch.Generator().manual_seed(0))
        metrics.append(_np(m))
    out["fast_metrics"] = metrics
    out["fast_state"] = _np(state)
    out["fast_params"] = _params(learner)

    # the readable trainer against the fast one: same seed, same draws
    cfg = _trainer_cfg(0.0)
    init_a, step_a, learner_a = make_trainer(cfg, device="cpu", mesh=mesh,
                                             **kw)
    init_b, step_b, learner_b, _ = make_trainer_fast(
        cfg, device="cpu", use_kernel=False, mesh=mesh, **kw)
    sa, sb = init_a(seed=3), init_b(seed=3)
    gen = torch.Generator().manual_seed(11 + r)
    ma, mb, same_params = [], [], []
    for _ in range(p["steps"]):
        d = step_b.draw(gen)
        sa, m1 = step_a.with_draws(sa, d, torch.Generator().manual_seed(0))
        sb, m2 = step_b.with_draws(sb, d, torch.Generator().manual_seed(0))
        ma.append(_np(m1))
        mb.append(_np(m2))
        # replicated parameters: the same bits on every rank
        flat = torch.cat([v.reshape(-1) for v in
                          learner_b.net.state_dict().values()])
        every = coll.all_gather(flat[None], mesh)
        same_params.append(all(torch.equal(every[0], x) for x in every))
    out["readable_metrics"], out["fast_metrics_b"] = ma, mb
    out["readable_store"] = _np((sa.store_size, sa.store_values))
    out["fast_store"] = _np((sb.store_size, sb.store_values))
    out["readable_params"] = _params(learner_a)
    out["fast_params_b"] = _params(learner_b)
    out["params_equal_across_ranks"] = same_params
    return out


def session_checks(mesh, p):
    """A two-rank TrainSession: 3 steps, save, a fresh session resumes
    and takes 2 more; against 5 uninterrupted steps from the same
    generators.  The files are rank 0's."""
    kw = dict(batch_per_device=4, store_capacity_per_device=128,
              replay_capacity_per_device=128, use_kernel=False)
    cfg = tcfg.DCARLConfig(
        dqn=tcfg.DQNConfig(batch_size=4, replay_capacity=128),
        store=tcfg.driving_store_config(visited_times_thres=4,
                                        rl_visited_times_min=2,
                                        n_step_window=2))

    def gen():
        return torch.Generator().manual_seed(rank_seed(5, mesh.rank))

    ref = TrainSession(p["dir_ref"], cfg, n_devices=mesh.size, mesh=mesh,
                       **kw)
    s_ref, _ = ref.init_or_resume(seed=0)
    s_ref, _ = ref.run_factory(5)(s_ref, gen())

    a = TrainSession(p["dir"], cfg, n_devices=mesh.size, mesh=mesh, **kw)
    st, step = a.init_or_resume(seed=0)
    g = gen()
    st, _ = a.run_factory(3)(st, g)
    a.save(st, 3)
    b = TrainSession(p["dir"], cfg, n_devices=mesh.size, mesh=mesh, **kw)
    st2, step2 = b.init_or_resume(seed=0)
    st2, _ = b.run_factory(2)(st2, g)
    same = all(torch.equal(x, y) for x, y in
               zip(_leaves(st2), _leaves(s_ref)))
    same_learner = all(torch.equal(x, y) for x, y in zip(
        b.learner.net.state_dict().values(),
        ref.learner.net.state_dict().values()))
    return {"resumed_step": step2, "bit_equal": same,
            "learner_equal": same_learner,
            "history_rows": b.history_rows()}


def _leaves(x):
    if isinstance(x, torch.Tensor):
        return [x]
    return [t for v in x for t in _leaves(v)]


# ---------------------------------------------------------------------------
# algos/: PPO over the mesh
# ---------------------------------------------------------------------------


def ppo_mesh_checks(mesh, p=None):
    """PPO on the identity env (8 envs a rank, n_steps 4, 2 x 2
    minibatches): one update over the mesh from the same init on the
    same draws as a one-rank update (must match it bit for bit), and one
    on this rank's own draws (the test holds the ranks bit-equal)."""
    from dcarl_tpu_torch.algos import common as C
    from dcarl_tpu_torch.algos import ppo as PPO

    env = C.identity_env(3)
    cfg = PPO.PPOConfig(n_steps=4, n_epochs=2, n_minibatches=2)
    init, upd_mesh = PPO.make_ppo(env, cfg, (16, 16), mesh=mesh)
    _, upd_one = PPO.make_ppo(env, cfg, (16, 16))
    state = init(torch.Generator().manual_seed(0), 8)
    draws = upd_one.draw(state, torch.Generator().manual_seed(1))
    same, _ = upd_mesh.with_draws(state, draws)
    one, _ = upd_one.with_draws(state, draws)
    own_draws = upd_one.draw(state, torch.Generator().manual_seed(
        10 + mesh.rank))
    own, _ = upd_mesh.with_draws(state, own_draws)
    return {"same_draws_equal_one_rank": all(
        torch.equal(same.params[k], one.params[k]) for k in one.params),
        "same_draws": {k: _np(v) for k, v in same.params.items()},
        "own_draws": {k: _np(v) for k, v in own.params.items()}}


def entry_point_checks(mesh, p=None):
    """The multi-process entry points on this rank, as a launcher's
    every rank runs them: what each printed (rank 0 only prints)."""
    import contextlib
    import io

    from dcarl_tpu_torch.examples import bench_scaling, train_multihost

    printed = []
    for mod, argv in ((bench_scaling, ["--batch-per-device", "4",
                                       "--steps", "3"]),
                      (train_multihost, ["--smoke"])):
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            assert mod.main(argv + ["--device", str(mesh.device)]) == 0
        printed.append(out.getvalue().splitlines())
    return printed
