"""The integrated trainer: ``make_trainer_fast`` steps a lockstep fleet
on the T-intersection, asks its store for the rule column, gates the
DQN's proposals, writes the trajectory records into the store and takes
one prioritized TD step a step.  Each ``run_fn`` call replays one
captured graph a step (on the CPU, the eager loop); the state is carried
from call to call.

Compared, in each compared call's first step, against the plain
reference worked out from the state and the learner at the call's
start: the rule-column query of the sampled envs (the query itself, its
count and sums), the whole store after the step's two inserts (every
row's key and action exactly, its value, its size and head), and the TD
step (the loss, and the median leaf's gaps of gradient norm and of
change: the attention's query and key weights sit behind a saturated
softmax, and their float32 gradients carry rounding noise of about a
thousandth, which the worst leaf would read; the sample keeps it).  The
store's records are worked out from the step's actions, rewards and
ends as the port produced them, and the TD step from the batch the port
sampled: the env step and the replay's sampling are the port's own.
"""

from __future__ import annotations

import time

import torch

from dcarl_bench import harness as H
from dcarl_bench import spec
from dcarl_bench.entries import common
from dcarl_bench.reference import learner as L
from dcarl_bench.reference import store as R

SORTED_KERNELS = ("moments_main", "moments_sum")


def _learner_state(learner):
    """Copies of the online and target weights and Adam's state."""
    net = dict(learner.net.named_parameters())
    opt = learner.optimizer.state
    return dict(
        params={k: p.detach().clone() for k, p in net.items()},
        target={k: p.detach().clone() for k, p in
                learner.target_net.named_parameters()},
        adam={k: (opt[p]["exp_avg"].clone(), opt[p]["exp_avg_sq"].clone(),
                  opt[p]["step"].clone()) for k, p in net.items()})


def run(cell: spec.Cell, seed: int, seconds: float, trace: bool,
        device: torch.device, t_start: float, control: str = "") -> dict:
    from dcarl_tpu_torch.core import rls, store as core_store
    from dcarl_tpu_torch.ops import _cuda, store_kernels

    cfg, tr = cell.config, cell.traffic
    if device.type == "cuda":
        _cuda.build()
    b, s_steps = int(tr["envs"]), int(tr["steps_per_call"])
    envs = spec.compared_envs(seed, b, tr)
    envs_t = torch.tensor(envs, dtype=torch.int64, device=device)
    calls = spec.compared_calls(seed, tr)
    traced = range(int(tr["trace"]["first_call"]),
                   int(tr["trace"]["first_call"]) + int(tr["trace"]["calls"]))
    rec = H.Recorder(device)
    inserts = [0]

    def query_probe(orig):
        def grouped(keys, values, valid, queries, half_widths, *a, **kw):
            m = orig(keys, values, valid, queries, half_widths, *a, **kw)
            rec.keep("queries", queries[0].index_select(0, envs_t))
            rec.keep("moments", m[0].index_select(0, envs_t))
            rec.add("matched", m[0, :, 0].sum(dtype=torch.float64))
            return m
        return grouped

    def push_probe(orig):
        def push(buf_obs, buf_act, buf_rew, length, obs, action, reward,
                 done, cfg_):
            rec.keep("step", torch.stack([action.to(reward.dtype), reward,
                                          done.to(reward.dtype)]))
            return orig(buf_obs, buf_act, buf_rew, length, obs, action,
                        reward, done, cfg_)
        return push

    def insert_probe(orig):
        def insert(store, *a, **kw):
            new = orig(store, *a, **kw)
            inserts[0] += 1
            if inserts[0] % 2 == 0:       # the step's second insert
                rec.keep("store_rows", torch.cat(
                    [new.keys, new.actions[:, None], new.values[:, None]], 1))
                rec.keep("store_at", torch.stack([new.size, new.head]))
            return new
        return insert

    init_fn, _, learner, factory = common.make_trainer(
        cfg, b, int(tr["store_rows"]), int(tr["replay_rows"]),
        int(tr["backfill_budget"]), device)
    net = dict(learner.net.named_parameters())

    def train_probe(orig):
        def train_on(batch, punishment, mesh=None):
            loss, prios = orig(batch, punishment, mesh=mesh)
            f = batch.obs.dtype
            rec.keep("batch", torch.cat(
                [batch.obs, batch.next_obs]
                + [getattr(batch, k).to(f)[:, None]
                   for k in ("action", "reward", "done", "weights")], 1))
            rec.keep("params", torch.cat([p.reshape(-1)
                                          for p in net.values()]))
            rec.keep("grads", torch.cat([
                (p.grad if p.grad is not None else torch.zeros_like(p))
                .reshape(-1) for p in net.values()]))
            rec.disarm()
            return loss, prios
        return train_on

    kept, totals = {}, {}
    with H.patched(store_kernels, "box_query_moments_grouped", query_probe), \
            H.patched(rls, "traj_push_lane", push_probe), \
            H.patched(core_store, "store_insert", insert_probe), \
            H.patched(learner, "train_on", train_probe):
        run_fn = factory(s_steps)
        run_gen = common.generator(device, seed, "train-run")
        state = {"carry": init_fn(spec.torch_seed(seed, "train-init"))}

        def one():
            rec.arm()
            state["carry"], outs = run_fn(state["carry"], run_gen)
            return outs

        for _ in range(int(tr["warmup_calls"])):
            one()
        H.sync(device)
        setup_s = time.perf_counter() - t_start

        def call(k: int) -> None:
            before = state["carry"]
            snap = _learner_state(learner) if k in calls else None
            if trace and k == traced.start:
                totals["start"] = rec.totals["matched"].clone()
            outs = one()
            if trace and k == traced.stop - 1:
                totals["stop"] = rec.totals["matched"].clone()
            if k in calls:
                kept[k] = dict(pre=before, learner=snap,
                               loss=outs.loss[0].clone(), **rec.taken())

        tracer = H.Tracer(device) if trace else None
        w = H.window(device, seconds, max(int(tr["compare"]
                                              ["within_first_calls"]),
                                          traced.stop),
                     call, traced, tracer)
    dev_line = H.device_line(device, cell.chips)
    del run_fn, state, learner, factory
    if device.type == "cuda":
        torch.cuda.empty_cache()

    sample, checks = compare(cfg, tr, envs_t, kept, calls, control)
    env_steps = w["calls"] * s_steps * b
    measured = None
    if trace:
        measured = dict(
            trace=tracer.summary,
            counters=dict(
                matched=float(totals["stop"] - totals["start"]),
                ticks=len(traced) * s_steps, rows=int(tr["store_rows"]),
                key_dim=int(cfg["store"]["key_dim"]), queries=b,
                query_dim=int(cfg["store"]["key_dim"]), answers=b),
            kernels=dict(sorted_moments=SORTED_KERNELS))
    return H.result(cell, checks, sample, env_steps, 0,
                    dict(train_env_steps_per_s=env_steps / w["seconds"],
                         setup_s=setup_s),
                    measured, dev_line)


def _unflat(flat: torch.Tensor, like: dict) -> dict:
    """``flat`` cut into tensors of the shapes of ``like``'s, by name."""
    out, at = {}, 0
    for k, t in like.items():
        out[k] = flat[at:at + t.numel()].reshape(t.shape)
        at += t.numel()
    return out


def compare(cfg: dict, tr: dict, envs_t, kept: dict, calls, control: str
            ) -> dict:
    """The checks of the compared calls' first steps against the plain
    reference (with ``control="tf32"``, the reference in TF32 stands in
    the port's place for the query and the TD step)."""
    lim = cfg["limits"]
    hw = None
    n = obs_bad = counts_bad = rows_bad = flushed = backfilled = 0
    matched = 0.0
    counted = []
    sum_err = value_err = loss_err = grad_gap = step_gap = 0.0
    worst_grad = worst_step = 0.0
    for k in calls:
        r = kept.get(k)
        if r is None:
            continue
        pre = r["pre"]
        dev = pre.store_keys.device
        if hw is None:
            hw = torch.tensor(cfg["store"]["half_widths"],
                              dtype=torch.float32, device=dev)
        env = pre.env
        obs = R.observation(env.ego[0], env.walker[0], env.vehicles[0],
                            cfg["in_state_vehicles"])            # [B, 20]
        keys, values = pre.store_keys[0], pre.store_values[0]
        size, head = int(pre.store_size[0]), int(pre.store_head[0])
        valid = torch.arange(keys.shape[0], device=dev) < size

        # the rule-column query of the sampled envs
        q = torch.cat([obs.index_select(0, envs_t),
                       obs.new_zeros((envs_t.numel(), 1))], dim=1)
        ref = R.box_moments(keys, values, valid, q, hw, 0, "f64")
        port_m = r["moments"]
        if control == "tf32":
            port_m = R.box_moments(keys, values, valid, q, hw, 0,
                                   "tf32")[:, :3]
        obs_bad += int((r["queries"] != q).any(dim=1).sum())
        c, e = R.sum_errors(port_m, ref)
        counts_bad += c
        sum_err = max(sum_err, e)
        matched += float(ref[:, 0].sum())

        # the records and the store after the step's two inserts
        flush, back = R.records(pre.traj_obs[0], pre.traj_act[0],
                                pre.traj_rew[0], pre.traj_len[0], obs.T,
                                r["step"][0], r["step"][1],
                                r["step"][2] != 0,
                                float(cfg["store"]["gamma"]))
        st = (keys, pre.store_actions[0], values.to(torch.float64), size,
              head)
        st = R.ring_insert(st, flush)
        flushed += int(flush[3].sum())
        backfilled += int(back[3].sum())
        d1 = back[0].shape[-1]
        st = R.ring_insert(st, R.compact(
            (back[0].reshape(-1, d1), back[1].reshape(-1),
             back[2].reshape(-1), back[3].reshape(-1)),
            int(tr["backfill_budget"])))
        got = r["store_rows"]
        d = keys.shape[1]
        rows_bad += int(((got[:, :d] != st[0]).any(dim=1)
                         | (got[:, d] != st[1])).sum())
        rows_bad += int(int(r["store_at"][0]) != st[3]) \
            + int(int(r["store_at"][1]) != st[4])
        diff = (got[:, d + 1].to(torch.float64) - st[2]).abs()
        value_err = max(value_err, float(
            (diff / st[2].abs().clamp(min=1e-12)).max()))

        # the TD step
        lr_state = r["learner"]
        bt, o = r["batch"], obs.shape[1]
        batch = dict(obs=bt[:, :o], next_obs=bt[:, o:2 * o],
                     action=bt[:, 2 * o], reward=bt[:, 2 * o + 1],
                     done=bt[:, 2 * o + 2], weights=bt[:, 2 * o + 3])
        dq = cfg["dqn"]
        loss_ref, g_ref, new_ref = L.td_step(
            lr_state["params"], lr_state["target"], lr_state["adam"], batch,
            dq)
        loss_port = r["loss"]
        g_port = _unflat(r["grads"], lr_state["params"])
        new_port = _unflat(r["params"], lr_state["params"])
        if control == "tf32":
            loss_port, g_port, new_port = L.td_step(
                lr_state["params"], lr_state["target"], lr_state["adam"],
                batch, dq, tf32=True)
        loss_err = max(loss_err, abs(float(loss_port) - float(loss_ref))
                       / max(abs(float(loss_ref)), 1e-300))
        counted = L.counted_leaves(g_ref)
        gg = L.leaf_gaps(g_port, g_ref, counted)
        pre_p = lr_state["params"]
        sg = L.leaf_gaps(
            {k: new_port[k].to(torch.float64) - pre_p[k].to(torch.float64)
             for k in g_ref},
            {k: new_ref[k] - pre_p[k].to(torch.float64) for k in g_ref},
            counted)
        grad_gap = max(grad_gap, L.median(gg.values()))
        step_gap = max(step_gap, L.median(sg.values()))
        worst_grad = max(worst_grad, max(gg.values()))
        worst_step = max(worst_step, max(sg.values()))
        n += 1
    sample = dict(calls=[k for k in calls if k in kept], steps=n,
                  matched_pairs=matched, flushed_rows=flushed,
                  backfill_rows=backfilled, counted_leaves=len(counted),
                  worst_leaf_grad_gap=worst_grad,
                  worst_leaf_step_gap=worst_step)
    return sample, {
        "compared": spec.check(n, 1, at_least=True),
        "obs_mismatch": spec.check(obs_bad, lim["obs_mismatch"]),
        "count_mismatch": spec.check(counts_bad, lim["count_mismatch"]),
        "sum_err": spec.check(sum_err, lim["sum_err"]),
        "store_row_mismatch": spec.check(rows_bad,
                                         lim["store_row_mismatch"]),
        "store_value_err": spec.check(value_err, lim["store_value_err"]),
        "loss_err": spec.check(loss_err, lim["loss_err"]),
        "grad_gap": spec.check(grad_gap, lim["grad_gap"]),
        "step_gap": spec.check(step_gap, lim["step_gap"]),
    }
