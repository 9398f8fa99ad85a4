#!/usr/bin/env python3
"""Where the field tick's time goes, on one GPU.

Runs ``chip_smoke.py``'s field tick (map window, locator, rule decision,
RL state, local trajectory, safeguard, path buffer, route hazard) for a
fleet of egos on the 2-lane loop map, times steady ticks with the host
clock around a synchronise, then traces a few ticks with
``torch.profiler`` and prints one JSON line: milliseconds a tick, device
time a tick (the traced kernels' sum), the device's idle share, CUDA
kernel launches a tick and the ten operators with the most device time.
The card's name and power limit come first.

    python3 tools/torch_field_profile.py --egos 16384
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke as cs  # noqa: E402
from dcarl_tpu_torch.cognition.path_buffer import path_buffer_init  # noqa: E402
from dcarl_tpu_torch.navigation import route as R  # noqa: E402
from dcarl_tpu_torch.navigation.map_provider import synthetic_loop_map  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--egos", type=int, default=16384)
    ap.add_argument("--objects", type=int, default=8)
    ap.add_argument("--ticks", type=int, default=5, help="timed and traced")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("torch_field_profile: no CUDA device", file=sys.stderr)
        return 2
    print(cs.gpu_line(), flush=True)
    dev = torch.device("cuda")
    radius, sep = 200.0, 3.5
    lmap = synthetic_loop_map(n_lanes=2, n_points=1024, radius=radius,
                              lane_sep=sep, device=dev)
    line = torch.cat([lmap.loops[0], lmap.loops[0][:1]])
    state = dict(
        route=R.make_route(line.cpu().numpy(), batch_shape=(args.egos,),
                           device=dev),
        world=cs.field_world(args.egos, args.objects,
                             torch.Generator(device=dev).manual_seed(40), dev),
        pb=path_buffer_init((args.egos,), device=dev))

    def tick():
        ego, objs = cs.field_poses(state["world"], radius, sep)
        out, state["pb"], state["route"] = cs.field_tick(
            lmap, line, state["route"], state["pb"], ego, objs, 256)
        state["world"] = cs.field_move(state["world"], out["target_speed"],
                                       out["target_lane"], radius, sep)

    for _ in range(3):                      # warm-up: allocations, caches
        tick()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(args.ticks):
        tick()
    torch.cuda.synchronize()
    tick_ms = (time.perf_counter() - t0) / args.ticks * 1e3

    act = [torch.profiler.ProfilerActivity.CPU,
           torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=act) as prof:
        for _ in range(args.ticks):
            tick()
        torch.cuda.synchronize()
    events = prof.key_averages()
    cuda = torch.autograd.DeviceType.CUDA
    kernels = [e for e in events if e.device_type == cuda]
    device_ms = sum(e.self_device_time_total for e in kernels) / 1e3 \
        / args.ticks
    ops = sorted((e for e in events if e.device_type != cuda
                  and e.key.startswith("aten::")),
                 key=lambda e: -e.self_device_time_total)[:10]
    print(json.dumps(dict(
        egos=args.egos, objects=args.objects, ticks=args.ticks,
        tick_ms=tick_ms, device_ms_per_tick=device_ms,
        device_idle_share=1.0 - device_ms / tick_ms,
        kernel_launches_per_tick=sum(e.count for e in kernels) / args.ticks,
        top_ops_device_ms_per_tick={
            e.key: e.self_device_time_total / 1e3 / args.ticks for e in ops},
        gpu=cs.gpu_line())), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
