"""Continuous-improvement experiment (``dcarl_tpu/improvement.py``): the
closed loop the paper is about.

1. **Train** (:func:`train_store`): the integrated lane-major trainer
   from an *empty* store, under a deliberately conservative rule
   (inflated collision-check radius), so candidates have headroom.  On
   CUDA its store query is the sorted-band kernel, once a step.
2. **Deploy** (:func:`evaluate_gated`): the confidence-gated driver over
   the trained store, seed-matched against the same driver with an EMPTY
   store (the z-test never passes, so it is exactly the rule fleet).  On
   CUDA its store query is the per-action kernel, once a tick, in both
   arms.
3. **Compare**: activation fraction, reward per env-step, pass and
   collision rates.

:func:`run_two_session_improvement` adds persistence: session A trains
and spools its store to the reference text history, session B (a fresh
agent) reloads that history and deploys from it at once.
:func:`run_improvement_suite` runs every arm of the JAX package's suite.

Reports keep the JAX package's keys, so the two packages' reports compare
key by key.  The port's random streams (``torch.Generator``) differ from
JAX's, so its numbers are behaviour of the same loop, not the same
draws.  Over a mesh (``mesh=``, ``n_devices`` its size) the trainer
shards envs, store and replay over the ranks (``train_fast.py``) and
every rank gets the merged store and the same report; rank 0 alone
writes the session files.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import (DCARLConfig, DQNConfig, EnvConfig,
                                    WerlingConfig, driving_store_config)
from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.planning.fast_rollout import make_gated_driver_fast
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel.mesh import ProcessMesh
from dcarl_tpu_torch.session import (TrainSession, check_devices,
                                     seed_store_from_text)
from dcarl_tpu_torch.train_fast import (FastTrainState, make_trainer_fast,
                                        rank_seed)


def demo_config(
    conservative_radius: float = 6.0,
    confidence_thres: float = 0.8,
    visited_times_thres: int = 10,
    rl_visited_times_min: int = 5,
    reset_jitter: float = 0.1,
    value_mode: str = "nstep",
    select_mode: str = "best",
    collision_radius: float = 1.0,
    **store_overrides,
) -> DCARLConfig:
    """The improvement-demo configuration: ``conservative_radius``
    inflates only the rule's collision check (WerlingConfig.robot_radius);
    the env's physical collision radius stays ``collision_radius``."""
    return DCARLConfig(
        env=EnvConfig(reset_jitter=reset_jitter, offroute_dist=6.0,
                      collision_radius=collision_radius),
        werling=WerlingConfig(robot_radius=conservative_radius),
        store=driving_store_config(
            confidence_thres=confidence_thres,
            visited_times_thres=visited_times_thres,
            rl_visited_times_min=rl_visited_times_min,
            value_mode=value_mode,
            select_mode=select_mode,
            **store_overrides,
        ),
        dqn=DQNConfig(batch_size=32, replay_capacity=1 << 16),
    )


def _append_history(history: Dict[str, list], metrics) -> None:
    """Per-chunk means of the stacked step metrics (host numpy, as the
    JAX package takes them)."""
    for k, v in metrics._asdict().items():
        history.setdefault(k, []).append(float(v.cpu().numpy().mean()))


def merged_store(state: FastTrainState,
                 mesh: "ProcessMesh | None" = None) -> Dict:
    """The store shards merged, shard-major (the ranks' shards gathered
    over ``mesh``): [S, N, D] -> [S*N, D] host arrays with a per-shard
    valid prefix, and the live row count."""
    def gathered(t):
        return (t if mesh is None else coll.all_gather(t, mesh)).cpu().numpy()

    keys_sh = gathered(state.store_keys)              # [S, N, D]
    vals_sh = gathered(state.store_values)            # [S, N]
    sizes = gathered(state.store_size)                # [S]
    s, n, d = keys_sh.shape
    valid = np.arange(n)[None, :] < sizes[:, None]
    return {
        "keys": keys_sh.reshape(s * n, d).astype(np.float32),
        "values": vals_sh.reshape(s * n).astype(np.float32),
        "valid": valid.reshape(s * n),
        "rows": int(sizes.sum()),
    }


def train_store(
    cfg: DCARLConfig,
    batch_per_device: int = 256,
    steps: int = 600,
    chunk: int = 50,
    store_capacity_per_device: int = 1 << 15,
    seed: int = 0,
    n_devices: int = 1,
    use_kernel: Optional[bool] = None,
    device: "str | torch.device | None" = None,
    mesh: "ProcessMesh | None" = None,
    **trainer_kwargs,
) -> Tuple[Dict[str, np.ndarray], Dict[str, list]]:
    """Run the integrated trainer from an empty store.

    Returns (store, history): ``store`` holds the merged
    keys/values/valid arrays; ``history`` per-chunk means of the training
    metrics.  ``trainer_kwargs`` go to :func:`make_trainer_fast`.  The
    steps draw from one generator seeded ``seed + 1`` (each rank's own,
    ``train_fast.rank_seed``); the host reads the metrics once a chunk.
    ``n_devices`` must be the size of ``mesh`` (1 without one)."""
    check_devices(n_devices, mesh)
    device = mesh.device if mesh is not None else resolve_device(device)
    init_fn, _, _, run_factory = make_trainer_fast(
        cfg, batch_per_device=batch_per_device,
        store_capacity_per_device=store_capacity_per_device,
        replay_capacity_per_device=store_capacity_per_device,
        use_kernel=use_kernel, device=device, mesh=mesh, **trainer_kwargs)
    run_fn = run_factory(chunk)
    state = init_fn(seed=seed)
    gen = torch.Generator(device=device).manual_seed(
        rank_seed(seed + 1, 0 if mesh is None else mesh.rank))

    history: Dict[str, list] = {}
    for i in range(steps // chunk):
        state, metrics = run_fn(state, gen)
        _append_history(history, metrics)
        history.setdefault("step", []).append((i + 1) * chunk)
    return merged_store(state, mesh), history


def evaluate_gated(
    cfg: DCARLConfig,
    store: Optional[Dict[str, np.ndarray]],
    n_envs: int = 512,
    n_steps: int = 300,
    seed: int = 100,
    use_kernel: Optional[bool] = None,
    store_rows_hint: int = 1024,
    device: "str | torch.device | None" = None,
) -> Dict[str, float]:
    """Roll the confidence-gated fleet; ``store=None`` means the empty
    store (``store_rows_hint`` rows of 1e9 keys, none valid, made on the
    device), which is the pure rule fleet on identical seeds."""
    device = resolve_device(device)
    sc = t_intersection(cfg.env)
    init_f, run_f = make_gated_driver_fast(
        sc, cfg.env, cfg.werling, store_cfg=cfg.store, device=device,
        use_kernel=use_kernel)

    if store is None:
        n = store_rows_hint
        d = len(cfg.store.half_widths or ()) or 21
        s_keys = torch.full((n, d), 1e9, dtype=torch.float32, device=device)
        s_vals = torch.zeros((n,), dtype=torch.float32, device=device)
        s_valid = torch.zeros((n,), dtype=torch.bool, device=device)
    else:
        s_keys, s_vals, s_valid = (torch.as_tensor(store[k], device=device)
                                   for k in ("keys", "values", "valid"))

    carry = init_f(n_envs, torch.Generator(device=device).manual_seed(seed))
    _, (reward, done, passed, collided, executed, gate) = run_f(
        carry, n_steps, s_keys, s_vals, s_valid,
        generator=torch.Generator(device=device).manual_seed(seed + 1))

    reward = reward.cpu().numpy()
    done = done.cpu().numpy()
    passed = passed.cpu().numpy() & done
    collided = collided.cpu().numpy() & done
    gate = gate.cpu().numpy()

    episodes = int(done.sum())
    denom = max(episodes, 1)
    kilosteps = reward.size / 1000.0
    return {
        # reward per env-step: the fleet's time-normalized reward rate
        "mean_step_reward": float(reward.mean()),
        "episodes": episodes,
        "passes_per_kstep": float(passed.sum()) / kilosteps,
        "collisions_per_kstep": float(collided.sum()) / kilosteps,
        "pass_rate": float(passed.sum()) / denom,
        "collision_rate": float(collided.sum()) / denom,
        "activation_fraction": float((gate != 0).mean()),
        "env_steps": int(reward.size),
    }


def _ratio(num: float, den: float) -> "float | None":
    """num/den, or None on a zero denominator (strict JSON has no
    Infinity)."""
    return num / den if den else None


def run_improvement(
    cfg: Optional[DCARLConfig] = None,
    batch_per_device: int = 256,
    train_steps: int = 600,
    chunk: int = 50,
    store_capacity_per_device: int = 1 << 15,
    eval_envs: int = 512,
    eval_steps: int = 300,
    seed: int = 0,
    n_devices: int = 1,
    use_kernel: Optional[bool] = None,
    device: "str | torch.device | None" = None,
    mesh: "ProcessMesh | None" = None,
    **trainer_kwargs,
) -> Dict:
    """The full experiment.  Returns a JSON-serializable report.  Over a
    ``mesh`` the training is sharded and every rank evaluates the merged
    store alike (the same report on every rank)."""
    cfg = cfg or demo_config()
    store, history = train_store(
        cfg, batch_per_device=batch_per_device, steps=train_steps,
        chunk=chunk, store_capacity_per_device=store_capacity_per_device,
        seed=seed, n_devices=n_devices, use_kernel=use_kernel, device=device,
        mesh=mesh, **trainer_kwargs)
    if mesh is not None:
        device = mesh.device

    evkw = dict(n_envs=eval_envs, n_steps=eval_steps, seed=seed + 100,
                use_kernel=use_kernel, device=device)
    rule = evaluate_gated(cfg, None, store_rows_hint=len(store["values"]),
                          **evkw)
    gated = evaluate_gated(cfg, store, **evkw)

    return {
        "config": {
            "conservative_radius": cfg.werling.robot_radius,
            "confidence_thres": cfg.store.confidence_thres,
            "visited_times_thres": cfg.store.visited_times_thres,
            "rl_visited_times_min": cfg.store.rl_visited_times_min,
            "batch_per_device": batch_per_device,
            "train_steps": train_steps,
            "eval_envs": eval_envs,
            "eval_steps": eval_steps,
            "seed": seed,
        },
        "train": {
            "store_rows": store["rows"],
            "final_rule_fraction": history["rule_fraction"][-1],
            "history": history,
        },
        "eval_rule": rule,
        "eval_gated": gated,
        "improvement": {
            "reward_rate_ratio": _ratio(gated["mean_step_reward"],
                                        rule["mean_step_reward"]),
            "reward_rate_delta": gated["mean_step_reward"]
            - rule["mean_step_reward"],
            "pass_throughput_ratio": _ratio(gated["passes_per_kstep"],
                                            rule["passes_per_kstep"]),
            "collision_delta_per_kstep": gated["collisions_per_kstep"]
            - rule["collisions_per_kstep"],
            "activation_fraction": gated["activation_fraction"],
        },
    }


# ---------------------------------------------------------------------------
# The experiment suite: two-session lifecycle, reference-default
# semantics, negative control, pass-rate-limited scenario.
# ---------------------------------------------------------------------------


def train_store_sessioned(
    cfg: DCARLConfig,
    session_dir: str,
    batch_per_device: int = 256,
    steps: int = 600,
    chunk: int = 50,
    store_capacity_per_device: int = 1 << 15,
    seed: int = 0,
    import_history_from: "Tuple[str, str] | None" = None,
    use_kernel: Optional[bool] = None,
    backfill_budget_per_step: Optional[int] = None,
    device: "str | torch.device | None" = None,
    mesh: "ProcessMesh | None" = None,
) -> Tuple[Dict[str, np.ndarray], Dict[str, list], Dict[str, int]]:
    """:func:`train_store` through the cross-session lifecycle
    (``session.py``): checkpoints plus the append-only text history, and
    optionally a store seeded from a previous session's history (the
    reference's reload-on-construction, RLS.py:34-76).

    Returns (store, history, session_info).  Over a ``mesh`` each rank
    trains its shard and rank 0 writes the files."""
    device = mesh.device if mesh is not None else resolve_device(device)
    sess = TrainSession(
        session_dir, cfg, n_devices=1 if mesh is None else mesh.size,
        mesh=mesh, batch_per_device=batch_per_device,
        store_capacity_per_device=store_capacity_per_device,
        replay_capacity_per_device=store_capacity_per_device,
        use_kernel=use_kernel, device=device,
        backfill_budget_per_step=backfill_budget_per_step)
    state, start_step = sess.init_or_resume(seed=seed)
    imported = 0
    if import_history_from is not None and start_step == 0:
        state = seed_store_from_text(state, *import_history_from, mesh=mesh)
        imported = int(state.store_size.sum()) if mesh is None else \
            int(coll.psum(state.store_size.sum(), mesh))
        # imported rows already live in the previous session's history;
        # this session's spool appends only its OWN new evidence
        sess.mark_synced(state)

    # Spool cadence must beat the ring: <= capacity inserts between spools
    # (the StoreSpooler contract).  The true per-step worst case is batch
    # flushes + batch * n_step_window terminal backfills, or batch + the
    # budget when a backfill budget bounds the write count.
    if backfill_budget_per_step is not None:
        worst_per_step = batch_per_device + backfill_budget_per_step
    else:
        worst_per_step = batch_per_device * (1 + cfg.store.n_step_window)
    sub_chunk = max(1, min(chunk, store_capacity_per_device
                           // worst_per_step))
    run_fn = sess.run_factory(sub_chunk)
    history: Dict[str, list] = {}
    gen = torch.Generator(device=device).manual_seed(
        rank_seed(seed + 1, 0 if mesh is None else mesh.rank))
    for i in range(steps // sub_chunk):
        state, metrics = run_fn(state, gen)
        sess.spool(state)
        _append_history(history, metrics)
        history.setdefault("step", []).append(
            start_step + (i + 1) * sub_chunk)
    sess.save(state, step=start_step + steps, spool_first=True)

    info = {
        "start_step": int(start_step),
        "imported_rows": imported,
        "history_rows": sess.history_rows(),
        "state_path": sess.state_path,
        "value_path": sess.value_path,
    }
    return merged_store(state, mesh), history, info


def run_two_session_improvement(
    session_root: str,
    cfg: Optional[DCARLConfig] = None,
    batch_per_device: int = 256,
    train_steps: int = 600,
    chunk: int = 50,
    store_capacity_per_device: int = 1 << 15,
    eval_envs: int = 512,
    eval_steps: int = 300,
    seed: int = 0,
    use_kernel: Optional[bool] = None,
    backfill_budget_per_step: Optional[int] = None,
    device: "str | torch.device | None" = None,
    mesh: "ProcessMesh | None" = None,
) -> Dict:
    """Session A trains from empty and persists {checkpoint, spooled text
    history}; session B is a fresh agent whose store is reloaded from A's
    history, is evaluated at once (the evidence transfers: the gated fleet
    activates without retraining), then keeps training.  Over a ``mesh``
    the sessions train sharded."""
    cfg = cfg or demo_config()
    if mesh is not None:
        device = mesh.device
    kw = dict(batch_per_device=batch_per_device, chunk=chunk,
              store_capacity_per_device=store_capacity_per_device,
              use_kernel=use_kernel,
              backfill_budget_per_step=backfill_budget_per_step,
              device=device, mesh=mesh)
    evkw = dict(n_envs=eval_envs, n_steps=eval_steps, seed=seed + 100,
                use_kernel=use_kernel, device=device)

    rule = evaluate_gated(cfg, None, **evkw)

    dir_a = os.path.join(session_root, "session_a")
    store_a, hist_a, info_a = train_store_sessioned(
        cfg, dir_a, steps=train_steps, seed=seed, **kw)
    eval_a = evaluate_gated(cfg, store_a, **evkw)

    # session B: fresh agent, history imported, no training (steps=0:
    # the import alone must carry the activation)
    dir_b = os.path.join(session_root, "session_b")
    history_from = (info_a["state_path"], info_a["value_path"])
    store_b0, _, info_b_probe = train_store_sessioned(
        cfg, dir_b, steps=0, seed=seed + 7,
        import_history_from=history_from, **kw)
    eval_b_imported = evaluate_gated(cfg, store_b0, **evkw)

    # session B continues training on top of the imported evidence
    store_b, hist_b, info_b = train_store_sessioned(
        cfg, dir_b, steps=train_steps, seed=seed + 8,
        import_history_from=history_from, **kw)
    eval_b = evaluate_gated(cfg, store_b, **evkw)

    return {
        "eval_rule": rule,
        "session_a": {"info": info_a, "eval": eval_a,
                      "store_rows": store_a["rows"]},
        "session_b_imported": {"info": info_b_probe,
                               "eval": eval_b_imported,
                               "store_rows": store_b0["rows"]},
        "session_b_final": {"info": info_b, "eval": eval_b,
                            "store_rows": store_b["rows"]},
        "evidence_transferred": info_b_probe["imported_rows"] > 0,
        "activation_retained":
            eval_b_imported["activation_fraction"] > 0.0,
        "improvement_a": eval_a["mean_step_reward"]
        / max(rule["mean_step_reward"], 1e-9),
        "improvement_b": eval_b["mean_step_reward"]
        / max(rule["mean_step_reward"], 1e-9),
    }


def run_improvement_suite(
    session_root: str,
    batch_per_device: int = 2048,
    train_steps: int = 2000,
    chunk: int = 100,
    store_capacity_per_device: int = 1 << 17,
    eval_envs: int = 1024,
    eval_steps: int = 400,
    seed: int = 0,
    use_kernel: Optional[bool] = None,
    session_scale: float = 1.0,
    device: "str | torch.device | None" = None,
) -> Dict:
    """Every arm of the JAX package's suite, with the same configs:
    ``main`` (nstep values, best-select, thres 0.8), ``reference_default``
    (the reference's own semantics), ``negative_control`` (the
    reference's zero-per-step reward: the gate must stay shut),
    ``pass_limited`` and ``pass_limited_episode`` (conservatism costs
    passes; whole-episode values), and ``two_session`` (train, persist,
    reload, keep improving)."""
    kw = dict(batch_per_device=batch_per_device, train_steps=train_steps,
              chunk=chunk, store_capacity_per_device=store_capacity_per_device,
              eval_envs=eval_envs, eval_steps=eval_steps,
              use_kernel=use_kernel, device=device)

    out: Dict = {}
    out["main"] = run_improvement(demo_config(), seed=seed, **kw)
    out["reference_default"] = run_improvement(
        demo_config(confidence_thres=0.5, value_mode="reference",
                    select_mode="first"),
        seed=seed, **kw)
    cfg_nc = demo_config(value_mode="reference", explore_low=-1.0,
                         explore_high=0.0, rule_good_thres=-0.1)
    cfg_nc = dataclasses.replace(
        cfg_nc, env=dataclasses.replace(cfg_nc.env, speed_reward_scale=0.0))
    out["negative_control"] = run_improvement(cfg_nc, seed=seed, **kw)
    cfg_pl = demo_config(conservative_radius=11.0, n_step_window=30)
    cfg_pl = dataclasses.replace(
        cfg_pl, env=dataclasses.replace(cfg_pl.env, max_episode_steps=300,
                                        reward_pass=5.0))
    out["pass_limited"] = run_improvement(cfg_pl, seed=seed, **kw)
    # whole-episode suffix values make "leads to a pass" expressible;
    # init_step_offset staggers the fleet's first episodes and masks
    # their truncated-return records
    cfg_ple = demo_config(conservative_radius=11.0, value_mode="episode",
                          gamma=1.0, n_step_window=300)
    cfg_ple = dataclasses.replace(
        cfg_ple, env=dataclasses.replace(cfg_ple.env, max_episode_steps=300,
                                         reward_pass=5.0))
    out["pass_limited_episode"] = run_improvement(
        cfg_ple, seed=seed,
        backfill_budget_per_step=4 * batch_per_device,
        init_step_offset=True, **kw)

    sb = max(int(batch_per_device * session_scale), 64)
    out["two_session"] = run_two_session_improvement(
        os.path.join(session_root, "two_session"),
        batch_per_device=sb,
        train_steps=train_steps,
        chunk=chunk,
        store_capacity_per_device=max(
            int(store_capacity_per_device * session_scale), 1 << 14),
        eval_envs=eval_envs, eval_steps=eval_steps,
        seed=seed, use_kernel=use_kernel, device=device,
        # a generous budget bounds the per-step write count so the spool
        # cadence stays at a sane chunk length
        backfill_budget_per_step=2 * sb)

    nc = out["negative_control"]
    out["summary"] = {
        "main_reward_ratio": out["main"]["improvement"]["reward_rate_ratio"],
        "main_activation": out["main"]["improvement"]["activation_fraction"],
        "reference_default_reward_ratio":
            out["reference_default"]["improvement"]["reward_rate_ratio"],
        "reference_default_activation":
            out["reference_default"]["improvement"]["activation_fraction"],
        "negative_control_activation":
            nc["improvement"]["activation_fraction"],
        "negative_control_collision_delta":
            nc["improvement"]["collision_delta_per_kstep"],
        "pass_limited_rule_pass_rate":
            out["pass_limited"]["eval_rule"]["pass_rate"],
        "pass_limited_gated_pass_rate":
            out["pass_limited"]["eval_gated"]["pass_rate"],
        "pass_limited_pass_throughput_ratio":
            out["pass_limited"]["improvement"]["pass_throughput_ratio"],
        "pass_limited_episode_rule_pass_rate":
            out["pass_limited_episode"]["eval_rule"]["pass_rate"],
        "pass_limited_episode_gated_pass_rate":
            out["pass_limited_episode"]["eval_gated"]["pass_rate"],
        "pass_limited_episode_activation":
            out["pass_limited_episode"]["improvement"]
            ["activation_fraction"],
        "pass_limited_episode_passes_per_kstep_gated":
            out["pass_limited_episode"]["eval_gated"]["passes_per_kstep"],
        "pass_limited_episode_passes_per_kstep_rule":
            out["pass_limited_episode"]["eval_rule"]["passes_per_kstep"],
        "two_session_improvement_b":
            out["two_session"]["improvement_b"],
        "two_session_activation_retained":
            out["two_session"]["activation_retained"],
    }
    return out
