"""Component timing of the rollout hot path (the JAX package's
``examples/profile_step.py``).

Times each stage of the rule driver's step apart, S steps of B envs
each, in the batch-first layout (``env/driving_env``,
``planning/werling``, ``control/controller``): env physics, the Frenet
projection, the lattice, the full plan with its collision check, and
the controller.  Each stage's output feeds its next input, so no step
repeats the last.  On the card each run is timed with CUDA events, on
the CPU with the host clock; the best of three after a warm-up.

    python -m dcarl_tpu_torch.examples.profile_step [B] [S] [--device cpu]
"""

from __future__ import annotations

import argparse

import torch

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.config import EnvConfig, WerlingConfig
from dcarl_tpu_torch.control.controller import get_control
from dcarl_tpu_torch.env import driving_env as de
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.planning import werling as W
from dcarl_tpu_torch.planning.rollout import _setup


def _seconds(fn, dev: torch.device) -> float:
    if dev.type != "cuda":
        return cli.seconds(fn, dev)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / 1e3


def timeit(name: str, fn, b: int, s: int, dev: torch.device) -> float:
    """Print ``name``'s best of three runs after a warm-up; its ms."""
    fn()
    best = min(_seconds(fn, dev) for _ in range(3))
    print(f"{name:28s} {best*1e3:9.2f} ms  {b * s / best / 1e3:10.1f}k "
          f"env-steps/s", flush=True)
    return best * 1e3


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("B", type=int, nargs="?", default=1024, help="envs")
    p.add_argument("S", type=int, nargs="?", default=50, help="steps")
    cli.add_device_flag(p)
    args = p.parse_args(argv)
    dev = cli.device_of(args)
    b, s = args.B, args.S

    sc = t_intersection()
    env_cfg, wcfg = EnvConfig(), WerlingConfig()
    _, sa, idx, ref_line, rp = _setup(sc, torch.float32, dev)
    env0 = de.reset(sa, b, cli.generator(dev, 0), env_cfg)
    _, obs_ori0 = de.wrap_state(env0, sa, idx, env_cfg)
    gen = cli.generator(dev, 1)
    traj_xy = torch.linspace(0, 50, 13, device=dev)[:, None] \
        .repeat(1, 2).expand(b, 13, 2)
    speed = torch.full((b, 13), 5.0, device=dev)

    def env_only():                      # 1. env physics (zero action)
        e, act = env0, torch.zeros((b, 2), device=dev)
        for _ in range(s):
            e = de.step_autoreset(e, act, gen, sa, idx, env_cfg)[0]

    def feed(one):                       # stages 2-5: out -> next input
        def run():
            c = obs_ori0
            for _ in range(s):
                c = c + 1e-6 * one(c).to(c.dtype)[:, None]
        return run

    def frenet(c):                       # 2. Frenet projection
        st = W.start_state_from_ego(c[:, 0], c[:, 1], c[:, 2], c[:, 3],
                                    c[:, 4], ref_line)
        return st.s0 + st.c_d

    def lattice(c):                      # 3. lattice generation
        st = W.FrenetStart(s0=c[:, 0] * 0.01, c_d=c[:, 1] * 0.001,
                           c_d_d=c[:, 2] * 0.01, c_d_dd=c[:, 3] * 0.0,
                           c_speed=c[:, 2] * 0.1 + 3.0)
        lat = W.plan(rp, st, wcfg)
        return lat.cf[:, 0] + lat.x[:, 0, 0]

    def full_plan(c):                    # 4. plan with the collision check
        objs = c[:, 5:].reshape(b, -1, 5).clone()
        objs[:, :, 4] = 0.0
        valid = torch.ones(objs.shape[:2], dtype=torch.bool, device=dev)
        return W.plan_with_rule(rp, ref_line, c[:, :5], objs, valid,
                                wcfg).rule_index

    def control(c):                      # 5. controller
        ctl = get_control(c[:, 0], c[:, 1], c[:, 4],
                          torch.sqrt(c[:, 2] ** 2 + c[:, 3] ** 2),
                          traj_xy, speed)
        return ctl.acc + ctl.steering

    print(f"backend={dev.type} B={b} S={s}", flush=True)
    timeit("env physics only", env_only, b, s, dev)
    timeit("frenet projection only", feed(frenet), b, s, dev)
    timeit("lattice only", feed(lattice), b, s, dev)
    timeit("full plan (incl collision)", feed(full_plan), b, s, dev)
    timeit("controller only", feed(control), b, s, dev)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
