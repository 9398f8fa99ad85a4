"""VecEnv adapter surface: the host-side batched-env API
(``dcarl_tpu/parallel/vec_env.py``).

The reference's parallelism for environments is the stable-baselines
VecEnv family: the ABC with ``step_async``/``step_wait``
(common/vec_env/base_vec_env.py), ``DummyVecEnv`` (serial,
dummy_vec_env.py:8-38), ``SubprocVecEnv`` (one OS process per env with
a Pipe command loop, subproc_vec_env.py:10-47), and wrappers
``VecFrameStack`` / ``VecCheckNan``.

On the card the real vectorization is the lockstep batch of
``env/driving_env.make_vec_env``, so OS processes per env would be
strictly slower.  This module provides:

- the VecEnv API itself (so SB-style user code ports over unchanged),
- ``DummyVecEnv`` / ``SubprocVecEnv`` for wrapping arbitrary *Python*
  envs (e.g. an external CARLA client, which genuinely needs process
  parallelism because the CARLA RPC blocks),
- ``TorchVecEnv``: the adapter that exposes the port's lockstep env
  through the same API (auto-reset included), and
- ``VecFrameStack`` / ``VecCheckNan`` / ``VecMonitor`` /
  ``VecVideoRecorder`` wrappers.

Everything but ``TorchVecEnv`` is numpy and multiprocessing only, the
same code as the JAX package's.
"""

from __future__ import annotations

import multiprocessing as mp
from abc import ABC, abstractmethod
from typing import Callable, List, Optional, Sequence

import numpy as np


class VecEnv(ABC):
    """Batched env API (base_vec_env.py semantics): ``reset`` returns
    ``[B, ...]`` observations; ``step`` auto-resets finished envs and
    reports the pre-reset observation under ``info['terminal_observation']``."""

    num_envs: int

    @abstractmethod
    def reset(self) -> np.ndarray:
        ...

    @abstractmethod
    def step(self, actions):
        """-> (obs [B,...], rewards [B], dones [B], infos list[dict])"""
        ...

    def close(self) -> None:
        pass

    # SB compat: split-phase stepping (we execute synchronously)
    def step_async(self, actions) -> None:
        self._pending_actions = actions

    def step_wait(self):
        return self.step(self._pending_actions)


class DummyVecEnv(VecEnv):
    """Serial batching of gym-style python envs (dummy_vec_env.py:8-38)."""

    def __init__(self, env_fns: Sequence[Callable]):
        self.envs = [fn() for fn in env_fns]
        self.num_envs = len(self.envs)

    def reset(self):
        return np.stack([_reset_obs(e) for e in self.envs])

    def step(self, actions):
        obs, rews, dones, infos = [], [], [], []
        for env, act in zip(self.envs, actions):
            o, r, d, info = _step4(env, act)
            if d:
                info = dict(info)
                info["terminal_observation"] = o
                o = _reset_obs(env)
            obs.append(o)
            rews.append(r)
            dones.append(d)
            infos.append(info)
        return (np.stack(obs), np.asarray(rews, np.float64),
                np.asarray(dones, bool), infos)

    def close(self):
        for e in self.envs:
            if hasattr(e, "close"):
                e.close()

    def env_method(self, name: str, *args, **kwargs) -> List:
        return [getattr(e, name)(*args, **kwargs) for e in self.envs]


def _reset_obs(env):
    out = env.reset()
    return out[0] if isinstance(out, tuple) else out


def _step4(env, action):
    out = env.step(action)
    if len(out) == 5:  # gymnasium 5-tuple
        o, r, term, trunc, info = out
        return o, r, bool(term or trunc), info
    return out


def _subproc_worker(remote, parent_remote, env_fn):
    """Child command loop (subproc_vec_env.py:10-47 semantics)."""
    parent_remote.close()
    env = env_fn()
    try:
        while True:
            cmd, data = remote.recv()
            if cmd == "step":
                o, r, d, info = _step4(env, data)
                if d:
                    info = dict(info)
                    info["terminal_observation"] = o
                    o = _reset_obs(env)
                remote.send((o, r, d, info))
            elif cmd == "reset":
                remote.send(_reset_obs(env))
            elif cmd == "env_method":
                name, args, kwargs = data
                remote.send(getattr(env, name)(*args, **kwargs))
            elif cmd == "close":
                remote.close()
                break
    except (EOFError, KeyboardInterrupt):
        pass
    finally:
        if hasattr(env, "close"):
            env.close()


class SubprocVecEnv(VecEnv):
    """One OS process per env, Pipe RPC — for envs that block on
    external I/O (a CARLA client, a ROS bridge).  For pure-Python or
    lockstep envs prefer DummyVecEnv / TorchVecEnv."""

    def __init__(self, env_fns: Sequence[Callable], context: str = "spawn"):
        ctx = mp.get_context(context)
        self.num_envs = len(env_fns)
        self._remotes, work_remotes = zip(
            *[ctx.Pipe() for _ in range(self.num_envs)])
        self._procs = []
        for wr, r, fn in zip(work_remotes, self._remotes, env_fns):
            p = ctx.Process(target=_subproc_worker, args=(wr, r, fn),
                            daemon=True)
            p.start()
            wr.close()
            self._procs.append(p)

    def reset(self):
        for r in self._remotes:
            r.send(("reset", None))
        return np.stack([r.recv() for r in self._remotes])

    def step(self, actions):
        for r, a in zip(self._remotes, actions):
            r.send(("step", a))
        results = [r.recv() for r in self._remotes]
        obs, rews, dones, infos = zip(*results)
        return (np.stack(obs), np.asarray(rews, np.float64),
                np.asarray(dones, bool), list(infos))

    def env_method(self, name: str, *args, **kwargs) -> List:
        for r in self._remotes:
            r.send(("env_method", (name, args, kwargs)))
        return [r.recv() for r in self._remotes]

    def close(self):
        for r in self._remotes:
            try:
                r.send(("close", None))
            except (BrokenPipeError, OSError):
                pass
        for p in self._procs:
            p.join(timeout=2.0)


class TorchVecEnv(VecEnv):
    """Expose the port's lockstep env (``env/driving_env.make_vec_env``:
    ``reset_fn(batch, generator)``, ``step_fn(states, actions,
    generator)`` with built-in auto-reset) through the VecEnv API, so
    SB-style host loops drive the env on the card unchanged.  The
    counterpart of ``JaxVecEnv`` (dcarl_tpu/parallel/vec_env.py:182):
    a ``torch.Generator`` on the env's device seeded with ``seed`` takes
    the place of the PRNG key.  Observations, rewards and done flags come
    back as numpy arrays, in one device-to-host copy per step."""

    def __init__(self, reset_fn, step_fn, num_envs: int, seed: int = 0,
                 device=None):
        import torch

        from dcarl_tpu_torch.device import resolve_device

        self._torch = torch
        self._reset_fn = reset_fn
        self._step_fn = step_fn
        self.num_envs = num_envs
        self.device = resolve_device(device)
        self.generator = torch.Generator(device=self.device).manual_seed(seed)
        self._states = None
        self._dtype = None

    def reset(self):
        # reset_fn -> (states, obs[, extras...])
        self._states, obs, *_ = self._reset_fn(self.num_envs, self.generator)
        self._dtype = obs.dtype
        return obs.cpu().numpy()

    def step(self, actions):
        torch = self._torch
        act = torch.as_tensor(np.asarray(actions), dtype=self._dtype,
                              device=self.device)
        # step_fn -> (states, obs, reward, done[, extras...])
        self._states, obs, reward, done, *_ = self._step_fn(
            self._states, act, self.generator)
        host = torch.cat([obs, reward[:, None].to(obs.dtype),
                          done[:, None].to(obs.dtype)], dim=1).cpu().numpy()
        infos = [{} for _ in range(self.num_envs)]
        return (host[:, :-2], host[:, -2].astype(np.float64),
                host[:, -1].astype(bool), infos)


class VecFrameStack(VecEnv):
    """Stack the last ``n_stack`` observations along the last axis
    (vec_frame_stack.py semantics: reset fills the stack with the
    first frame; done clears history)."""

    def __init__(self, venv: VecEnv, n_stack: int):
        self.venv = venv
        self.n_stack = n_stack
        self.num_envs = venv.num_envs
        self._stacked = None

    def reset(self):
        obs = self.venv.reset()
        self._stacked = np.concatenate([obs] * self.n_stack, axis=-1)
        return self._stacked.copy()

    def step(self, actions):
        obs, rew, done, infos = self.venv.step(actions)
        w = obs.shape[-1]
        self._stacked = np.roll(self._stacked, -w, axis=-1)
        self._stacked[..., -w:] = obs
        if done.any():
            for i in np.where(done)[0]:
                self._stacked[i] = np.concatenate(
                    [obs[i]] * self.n_stack, axis=-1)
        return self._stacked.copy(), rew, done, infos

    def close(self):
        self.venv.close()


class VecCheckNan(VecEnv):
    """NaN/inf sentinel (vec_check_nan.py): raise (or warn once) when
    actions or observations go non-finite, naming the offender."""

    def __init__(self, venv: VecEnv, raise_exception: bool = True,
                 warn_once: bool = True):
        self.venv = venv
        self.num_envs = venv.num_envs
        self._raise = raise_exception
        self._warn_once = warn_once
        self._warned = False

    def _check(self, name: str, arr):
        arr = np.asarray(arr, dtype=np.float64)
        if np.isfinite(arr).all():
            return
        msg = f"VecCheckNan: non-finite values in {name}"
        if self._raise:
            raise ValueError(msg)
        if not (self._warn_once and self._warned):
            import warnings

            warnings.warn(msg)
            self._warned = True

    def reset(self):
        obs = self.venv.reset()
        self._check("reset observation", obs)
        return obs

    def step(self, actions):
        self._check("actions", actions)
        obs, rew, done, infos = self.venv.step(actions)
        self._check("observation", obs)
        self._check("reward", rew)
        return obs, rew, done, infos

    def close(self):
        self.venv.close()


class VecMonitor(VecEnv):
    """Episode-stats monitor (bench/monitor.py semantics): per-episode
    reward ``r``, length ``l``, wall-time ``t`` appended to a CSV whose
    first line is the reference's JSON comment header
    (``#{"t_start": ..., "env_id": ...}``).  Covers the whole vec batch
    in one file; per-env attribution is the extra ``env`` column (the
    reference wraps one env per Monitor — a per-process file layout that
    has no analog for a lockstep batch)."""

    EXT = "monitor.csv"

    def __init__(self, venv: VecEnv, filename: Optional[str] = None,
                 env_id: str = "dcarl"):
        import json
        import time as _time

        self.venv = venv
        self.num_envs = venv.num_envs
        self.t_start = _time.time()
        self.episode_rewards: List[float] = []
        self.episode_lengths: List[int] = []
        self.episode_times: List[float] = []
        self._rew = np.zeros(self.num_envs, np.float64)
        self._len = np.zeros(self.num_envs, np.int64)
        self.file = None
        if filename is not None:
            if not filename.endswith(self.EXT):
                filename = filename + "." + self.EXT
            self.file = open(filename, "w")
            self.file.write("#%s\n" % json.dumps(
                {"t_start": self.t_start, "env_id": env_id}))
            self.file.write("r,l,t,env\n")
            self.file.flush()

    def reset(self):
        self._rew[:] = 0.0
        self._len[:] = 0
        return self.venv.reset()

    def step(self, actions):
        import time as _time

        obs, rew, done, infos = self.venv.step(actions)
        self._rew += np.asarray(rew, np.float64)
        self._len += 1
        for i in np.flatnonzero(np.asarray(done)):
            ep_r = float(self._rew[i])
            ep_l = int(self._len[i])
            ep_t = round(_time.time() - self.t_start, 6)
            self.episode_rewards.append(ep_r)
            self.episode_lengths.append(ep_l)
            self.episode_times.append(ep_t)
            if isinstance(infos[i], dict):
                infos[i]["episode"] = {"r": ep_r, "l": ep_l, "t": ep_t}
            if self.file is not None:
                self.file.write(f"{ep_r:.6f},{ep_l},{ep_t},{i}\n")
                self.file.flush()
            self._rew[i] = 0.0
            self._len[i] = 0
        return obs, rew, done, infos

    # SB Monitor accessors
    def get_episode_rewards(self) -> List[float]:
        return self.episode_rewards

    def get_episode_lengths(self) -> List[int]:
        return self.episode_lengths

    def get_episode_times(self) -> List[float]:
        return self.episode_times

    def close(self):
        if self.file is not None:
            self.file.close()
        self.venv.close()


def load_monitor_csv(path: str):
    """Parse a VecMonitor CSV -> (header dict, list of row dicts) —
    the load_results counterpart of bench/monitor.py."""
    import json

    with open(path) as f:
        first = f.readline()
        header = json.loads(first[1:]) if first.startswith("#") else {}
        cols = f.readline().strip().split(",")
        rows = []
        for line in f:
            vals = line.strip().split(",")
            if len(vals) != len(cols):
                continue
            rows.append({c: (float(v) if c in ("r", "t") else int(v))
                         for c, v in zip(cols, vals)})
    return header, rows


class VecVideoRecorder(VecEnv):
    """Rollout video capture (vec_video_recorder.py semantics): when
    ``record_video_trigger(step)`` fires, record ``video_length`` frames
    and write them out; recording restarts whenever the trigger fires
    again.

    The reference calls the env's OpenGL ``render``; the lockstep
    envs have no renderer process, so frames come from ``render_fn(obs)
    -> uint8 [H, W, 3]`` (default: top-down scatter of the 20-D driving
    observation, :func:`_default_render`).  Output is an animated GIF (PIL)
    plus the raw frame stack as ``.npz``.
    """

    def __init__(self, venv: VecEnv, video_folder: str,
                 record_video_trigger: Callable[[int], bool],
                 video_length: int = 200,
                 name_prefix: str = "rl-video",
                 render_fn: Optional[Callable] = None,
                 fps: int = 20):
        import os

        self.venv = venv
        self.num_envs = venv.num_envs
        self.trigger = record_video_trigger
        self.video_length = video_length
        self.folder = video_folder
        self.prefix = name_prefix
        self.render_fn = render_fn or _default_render
        self.fps = fps
        os.makedirs(video_folder, exist_ok=True)
        self.step_id = 0
        self.recording = False
        self.frames: List[np.ndarray] = []
        self.recorded_paths: List[str] = []
        self._last_obs = None

    def reset(self):
        obs = self.venv.reset()
        self._last_obs = obs
        self._maybe_start()
        return obs

    def _maybe_start(self):
        if not self.recording and self.trigger(self.step_id):
            self.recording = True
            self.frames = []
            self.start_step = self.step_id

    def step(self, actions):
        obs, rew, done, infos = self.venv.step(actions)
        self._last_obs = obs
        self.step_id += 1
        self._maybe_start()
        if self.recording:
            self.frames.append(self.render_fn(np.asarray(obs)))
            if len(self.frames) >= self.video_length:
                self._flush()
        return obs, rew, done, infos

    def _flush(self):
        import os

        if not self.frames:
            self.recording = False
            return
        base = os.path.join(
            self.folder,
            f"{self.prefix}-step-{self.start_step}-to-{self.step_id}")
        stack = np.stack(self.frames)
        np.savez_compressed(base + ".npz", frames=stack)
        gif = base + ".gif"
        try:
            from PIL import Image

            imgs = [Image.fromarray(f) for f in self.frames]
            imgs[0].save(gif, save_all=True, append_images=imgs[1:],
                         duration=int(1000 / self.fps), loop=0)
            self.recorded_paths.append(gif)
        except Exception:  # pragma: no cover - PIL is baked in
            self.recorded_paths.append(base + ".npz")
        self.frames = []
        self.recording = False

    def close(self):
        self._flush()
        self.venv.close()


def _default_render(obs: np.ndarray, size: int = 128) -> np.ndarray:
    """Minimal top-down rasterization of the 20-D driving observation
    batch (ego + objects of env 0) — enough to eyeball a rollout
    without a display server."""
    frame = np.zeros((size, size, 3), np.uint8)
    rows = np.asarray(obs[0], np.float64).reshape(-1, 5)

    def plot(x, y, color):
        px = int(np.clip(size / 2 + x * 2.0, 0, size - 1))
        py = int(np.clip(size / 2 - y * 2.0, 0, size - 1))
        frame[max(0, py - 1): py + 2, max(0, px - 1): px + 2] = color

    for k, row in enumerate(rows):
        if k == 0:
            plot(0.0, 0.0, (0, 255, 0))          # ego at frame center
        else:
            plot(row[0] - rows[0][0], row[1] - rows[0][1], (255, 64, 64))
    return frame
