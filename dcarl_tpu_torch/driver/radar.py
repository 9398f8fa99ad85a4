"""Radar-object ingestion into the cognition layer's array format.

The reference pipes continental/srr/us radar messages through perception
into ``TrackingBoxArray`` for the object locator; here radar objects
convert straight to the fixed-slot arrays that
``dcarl_tpu_torch.cognition.locator.update_map_state`` consumes
(x, y, vx, vy, yaw rows + valid mask), with the same semantic filters a
radar preprocessor applies: existence probability gate and optional
stationary-target rejection via ``dynprop``.
"""

from __future__ import annotations

from typing import Sequence, Tuple

import numpy as np

from dcarl_tpu_torch.driver.messages import RadarObs

# dynprop codes (continental_radar_msgs/msg/RadarObs.msg)
DYNPROP_MOVING = 0
DYNPROP_STATIONARY = 1
DYNPROP_ONCOMING = 2
DYNPROP_STATIONARY_CAND = 3
DYNPROP_UNKNOWN = 4
DYNPROP_CROSSING_STATIONARY = 5
DYNPROP_CROSSING_MOVING = 6
DYNPROP_STOPPED = 7

_STATIONARY = {DYNPROP_STATIONARY, DYNPROP_STATIONARY_CAND,
               DYNPROP_CROSSING_STATIONARY}


def radar_to_tracked_arrays(
    objects: Sequence[RadarObs],
    max_slots: int,
    sensor_pose: Tuple[float, float, float] = (0.0, 0.0, 0.0),
    min_probexist: float = 0.5,
    drop_stationary: bool = False,
) -> Tuple[np.ndarray, np.ndarray]:
    """-> (rows [max_slots, 5] of (x, y, vx, vy, yaw), valid [max_slots]).

    Radar frame is +x forward / +y left (RadarObs.msg); ``sensor_pose``
    = (x, y, yaw) of the radar in the vehicle/world frame rotates and
    translates objects into that frame.  Objects are sorted by range so
    slot truncation keeps the nearest (the locator's nearest-K
    semantics).
    """
    sx, sy, syaw = sensor_pose
    c, s = np.cos(syaw), np.sin(syaw)

    rows = []
    for o in objects:
        if o.probexist < min_probexist:
            continue
        if drop_stationary and o.dynprop in _STATIONARY:
            continue
        x_l, y_l = o.longitude_dist, o.lateral_dist
        vx_l, vy_l = o.longitude_vel, o.lateral_vel
        x = sx + c * x_l - s * y_l
        y = sy + s * x_l + c * y_l
        vx = c * vx_l - s * vy_l
        vy = s * vx_l + c * vy_l
        yaw = syaw + np.radians(o.oritation_angle)
        rows.append((x_l * x_l + y_l * y_l, (x, y, vx, vy, yaw)))

    rows.sort(key=lambda t: t[0])
    out = np.zeros((max_slots, 5), np.float64)
    valid = np.zeros((max_slots,), bool)
    for i, (_, r) in enumerate(rows[:max_slots]):
        out[i] = r
        valid[i] = True
    return out, valid
