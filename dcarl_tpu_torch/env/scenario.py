"""Static T-intersection scenario (CARLA Town03 replacement).

The reference's fixed junction scenario (TestScenario_Town03.py:33-68
spawns, :464-610 scripted traffic): the ego starts at (242, 110) heading
-y toward a junction it must cross (pass line y=73.7), with six scripted
vehicles and a pedestrian crossing at y=80.  Host-side numpy, built once.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from dcarl_tpu_torch.config import EnvConfig
from dcarl_tpu_torch.ops.geometry import dense_polyline2d_np

DEG = math.pi / 180.0


class Scenario(NamedTuple):
    """Fixed per-scenario arrays (host numpy)."""

    ref_path: np.ndarray          # [N, 2] dense reference polyline (2 m)
    ref_path_fine: np.ndarray     # [M, 2] fine polyline for control (0.1 m)
    vehicle_spawns: np.ndarray    # [V, 5] x, y, vx, vy, yaw
    vehicle_moving: np.ndarray    # [V] bool: scripted motion on/off
    vehicle_in_state: np.ndarray  # [V] bool: exposed in the 20-D state
    walker_spawn: np.ndarray      # [5] x, y, vx, vy, yaw
    ego_spawn: np.ndarray         # [5]


def t_intersection(cfg: EnvConfig = EnvConfig()) -> Scenario:
    """The reference's Town03 junction scenario, natively laid out."""
    # Route: south along x=242 to the junction, drifting to the goal
    # (245, 29) (TestScenario_Town03.py:149-180).
    waypoints = np.array([
        [242.0, 120.0],
        [242.0, 100.0],
        [242.0, 80.0],
        [242.2, 65.0],
        [243.0, 50.0],
        [244.2, 38.0],
        [245.0, 29.0],
    ])
    ref_path = dense_polyline2d_np(waypoints, 2.0)
    ref_path_fine = dense_polyline2d_np(waypoints, 0.1)

    yaw_s = -90.0 * DEG  # southbound
    yaw_n = 90.0 * DEG   # northbound
    autopilot_speed = 5.0

    def spawn(x, y, yaw, moving):
        v = autopilot_speed if moving else 0.0
        return [x, y, v * math.cos(yaw), v * math.sin(yaw), yaw]

    # (x, y, yaw, moving, in_state) per TestScenario_Town03.py:468-562
    rows = [
        (246.0, 110.0, yaw_s, False, False),
        (246.0, 100.0, yaw_s, False, False),
        (240.0, 80.0, yaw_s, True, True),    # firetruck
        (240.0, 110.0, yaw_s, True, True),   # mini
        (233.0, 90.0, yaw_n, True, False),
        (230.0, 110.0, yaw_n, True, False),
    ]
    vehicle_spawns = np.array([spawn(x, y, yw, mv) for x, y, yw, mv, _ in rows])
    vehicle_moving = np.array([mv for *_, mv, _ in rows])
    vehicle_in_state = np.array([ins for *_, ins in rows])

    # Pedestrian at (248, 80) walking heading 180 deg
    # (TestScenario_Town03.py:62-68, :592-610)
    walker_yaw = 180.0 * DEG
    walker = np.array([
        248.0, 80.0,
        cfg.pedestrian_speed * math.cos(walker_yaw),
        cfg.pedestrian_speed * math.sin(walker_yaw),
        walker_yaw,
    ])

    ego = np.array([cfg.ego_start[0], cfg.ego_start[1], 0.0, 0.0,
                    cfg.ego_start[2]])

    return Scenario(
        ref_path=ref_path,
        ref_path_fine=ref_path_fine,
        vehicle_spawns=vehicle_spawns,
        vehicle_moving=vehicle_moving,
        vehicle_in_state=vehicle_in_state,
        walker_spawn=walker,
        ego_spawn=ego,
    )
