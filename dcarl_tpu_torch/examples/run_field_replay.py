"""Field-log replay through the decision stack (the JAX package's
``examples/run_field_replay.py``), the reference's rosbag-replay demo
(README.md:236-242).

The Scenario text logs (Field_testing/Scenario{1,2,3}/) are parsed, the
ego's driven path becomes the reference lane (the PathBuffer role),
every surrounding object of every tick is Frenet-projected onto it, and
a ``MultiLaneState`` is built per tick; then the whole drive's
decisions (IDM speed, LaneUtility lateral rule, the RLS 20-D state) are
computed for all ticks at once, batch-first, with no loop over ticks.

    python -m dcarl_tpu_torch.examples.run_field_replay [--scenario DIR]
        [--stride 4] [--plot] [--out PREFIX] [--device cpu]

A missing ``--scenario`` directory exits 2 (no run passes on absent
input).  ``--plot`` writes ``<out>.json`` (markers) and ``<out>.png``
(default ``build/torch_runs/field_replay``).
"""

from __future__ import annotations

import argparse
import os
import time

import numpy as np
import torch

from dcarl_tpu_torch import cli
from dcarl_tpu_torch.data.datasets import default_root
from dcarl_tpu_torch.ops import geometry as geo
from dcarl_tpu_torch.planning import idm, lane_utility as LU
from dcarl_tpu_torch.planning.decision import wrap_state
from dcarl_tpu_torch.planning.multilane import LaneVehicle, MultiLaneState
from dcarl_tpu_torch.utils import field_analysis as fa

MAX_OBJ = 8          # nearest objects per tick fed to the locator
LANE_WIDTH = 3.5
LANES = 2            # the log has no lane map: the lane and its shoulder


def default_scenario() -> str:
    return os.path.join(default_root(), "Field_testing", "Scenario1")


def build_frames(scenario_dir: str, stride: int = 4) -> dict:
    """Parse the logs into fixed-shape per-tick arrays (host side)."""
    a = fa.analyze_scenario(scenario_dir)
    traffic = a["channels"]["traffic"]
    surround = a["channels"]["surrounding_obj"]

    ego_t = traffic[::stride, 0]
    ego_xy = traffic[::stride, 3:5]
    # ego speed from finite differences of the pose track
    dt = np.maximum(np.diff(ego_t, prepend=ego_t[0] - 0.1), 1e-3)
    ego_v = np.hypot(*np.diff(ego_xy, axis=0, prepend=ego_xy[:1]).T) / dt

    # reference lane = the densified driven path (PathBuffer role)
    path = geo.dense_polyline2d_np(ego_xy, resolution=1.0)

    # bucket surrounding detections to the nearest ego tick
    idx = np.clip(np.searchsorted(ego_t, surround[:, 0]), 0, len(ego_t) - 1)
    T = len(ego_t)
    obj_xy = np.zeros((T, MAX_OBJ, 2))
    obj_v = np.zeros((T, MAX_OBJ, 2))
    obj_valid = np.zeros((T, MAX_OBJ), bool)
    fill = np.zeros(T, int)
    for row, k in zip(surround, idx):
        j = fill[k]
        if j < MAX_OBJ:
            obj_xy[k, j] = row[1:3]
            obj_v[k, j] = row[3:5] if row.shape[0] >= 5 else 0.0
            obj_valid[k, j] = True
            fill[k] = j + 1
    return dict(t=ego_t, ego_xy=ego_xy, ego_v=ego_v, path=path,
                obj_xy=obj_xy, obj_v=obj_v, obj_valid=obj_valid,
                summary={k: v for k, v in a.items() if k != "channels"})


def decide_all(frames: dict, device: torch.device):
    """(target lane [T] i32, target speed [T], IDM speed [T], RL state
    [T, 20]) of every tick at once, in float32."""
    def f32(a):
        return torch.as_tensor(np.asarray(a), dtype=torch.float32,
                               device=device)

    path = f32(frames["path"])
    ego_xy, ego_v = f32(frames["ego_xy"]), f32(frames["ego_v"])
    obj_xy, obj_v = f32(frames["obj_xy"]), f32(frames["obj_v"])
    valid = torch.as_tensor(frames["obj_valid"], device=device)
    T = ego_xy.shape[0]
    zero_t = torch.zeros((T,), device=device)
    ego_f = geo.cartesian_to_frenet(ego_xy[:, 0], ego_xy[:, 1], zero_t,
                                    zero_t, zero_t, path)
    obj_f = geo.cartesian_to_frenet(obj_xy[..., 0], obj_xy[..., 1],
                                    obj_v[..., 0], obj_v[..., 1],
                                    torch.zeros_like(obj_v[..., 0]), path)
    vs = torch.hypot(obj_v[..., 0], obj_v[..., 1])            # [T, K]
    rel_s = obj_f.s - ego_f.s[:, None]
    lane_idx = torch.clamp(obj_f.d / LANE_WIDTH + 0.5, -0.49, 1.49)

    # per-lane nearest front / rear (locate_objects semantics, inline:
    # the log has no lane map)
    lanes = torch.arange(LANES, dtype=torch.float32, device=device)
    member = (torch.abs(lane_idx[..., None] - lanes) <= 0.5) \
        & valid[..., None]                                   # [T, K, L]
    rel = rel_s[..., None].expand_as(member)
    front_key = torch.where(member & (rel > 0), rel, torch.inf)
    fi = torch.argmin(front_key, dim=1)                      # [T, L]
    f_exists = torch.isfinite(front_key.amin(dim=1))
    rear_key = torch.where(member & (rel <= 0), rel, -torch.inf)
    ri = torch.argmax(rear_key, dim=1)
    r_exists = rear_key.amax(dim=1) > -torch.inf

    def take(x, i):
        return torch.gather(x, 1, i)

    lanes_t = lanes.expand(T, LANES)
    zeros_l = torch.zeros((T, LANES), device=device)
    front = LaneVehicle(
        exists=f_exists,
        s=torch.where(f_exists, take(rel_s, fi), 50.0),
        d=torch.where(f_exists, take(lane_idx, fi), lanes_t),
        vs=torch.where(f_exists, take(vs, fi), 20.0), vd=zeros_l)
    rear = LaneVehicle(
        exists=r_exists,
        s=torch.where(r_exists, take(rel_s, ri), -50.0),
        d=torch.where(r_exists, take(lane_idx, ri), lanes_t),
        vs=torch.where(r_exists, take(vs, ri), 0.0), vd=zeros_l)
    mmap = MultiLaneState(
        ego_lane_index=torch.clamp(ego_f.d / LANE_WIDTH + 0.5, 0.0, 1.0),
        ego_speed=ego_v, ego_vd=zero_t, front=front, rear=rear,
        speed_limit=torch.full((T, LANES), 12.0, device=device),
        distance_to_junction=torch.full((T,), 200.0, device=device),
        target_lane_index=zero_t,
        traffic_light_stop=torch.zeros((T, LANES), dtype=torch.bool,
                                       device=device),
        stop_distance=torch.full((T, LANES), 200.0, device=device))

    lane, speed = LU.lateral_decision(mmap)
    idm_speed = idm.longitudinal_speed(mmap, lane)
    return lane, speed, idm_speed, wrap_state(mmap)


def parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--scenario", default=default_scenario())
    p.add_argument("--stride", type=int, default=4)
    p.add_argument("--plot", action="store_true")
    p.add_argument("--out", default=str(cli.RUNS_DIR / "field_replay"))
    cli.add_device_flag(p)
    return p


def main(argv=None) -> int:
    args = parser().parse_args(argv)
    dev = cli.device_of(args)
    if not os.path.isdir(args.scenario):
        print(f"scenario dir {args.scenario} not found", flush=True)
        return 2

    frames = build_frames(args.scenario, args.stride)
    print("scenario summary:", {k: (round(v, 2) if isinstance(v, float)
                                    else v)
                                for k, v in frames["summary"].items()})
    cli.sync(dev)
    t0 = time.perf_counter()
    lane, speed, idm_speed, state20 = decide_all(frames, dev)
    cli.sync(dev)
    dt = time.perf_counter() - t0
    T = len(frames["t"])
    print(f"replayed {T} decision ticks in {dt:.2f}s "
          f"({T/dt:,.0f} ticks/s, first call; reference stack: 5 Hz)")
    lane = lane.cpu().numpy()
    speed = speed.cpu().numpy()
    print(f"lateral decisions: lane0={np.mean(np.round(lane)==0):.1%} "
          f"lane1={np.mean(np.round(lane)==1):.1%}; "
          f"target speed mean={speed.mean():.2f} m/s "
          f"idm mean={float(idm_speed.mean()):.2f} m/s", flush=True)
    if not bool(torch.isfinite(state20).all()):
        raise RuntimeError("the replay's RL state is not finite")

    if args.plot:
        from dcarl_tpu_torch.utils import visualize as viz

        markers = viz.lane_markers([frames["path"]])
        ov = frames["obj_xy"][frames["obj_valid"]]
        markers += [{"type": "centroid", "uid": i, "point": p.tolist(),
                     "color": (0.9, 0.4, 0.1)}
                    for i, p in enumerate(ov[::20])]
        cli.make_parent(args.out)
        viz.save_markers(args.out + ".json", markers)
        viz.render(markers, out_path=args.out + ".png", title="field replay")
        print("wrote", args.out + ".png", "and", args.out + ".json",
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
