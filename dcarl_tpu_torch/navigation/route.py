"""Global route planning: rolling waypoint windows and hazard checks,
batch-first (the JAX package's ``navigation/route.py``).

The reference's CARLA-side ``RoutePlanner`` (route_planner.py:30-282)
rolls a 5 m-sampled waypoint queue forward as the ego advances, hands a
fixed-size forward buffer to the local planner, and checks two hazards
(a red light within proximity on the route, a lead vehicle within
proximity in the lane).  Here the route is one [N, 2] polyline resampled
on the host; each ego of a batch keeps its own cursor ([...]), and the
cursor advance, window gather and hazard reductions run for all of
them at once.
"""

from __future__ import annotations

import enum
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.ops import geometry as geo

SAMPLING_RADIUS = 5.0    # m between route waypoints (route_planner.py:36)
MIN_DISTANCE = 4.0       # purge radius behind ego (:37)
PROXIMITY_THRES = 15.0   # hazard lookahead (:49)


class RoadOption(enum.IntEnum):
    """Topology options at branch points (route_planner.py:14-28)."""
    VOID = -1
    LEFT = 1
    RIGHT = 2
    STRAIGHT = 3
    LANEFOLLOW = 4


class Route(NamedTuple):
    """A global route: uniformly sampled waypoints, options, cursors."""
    waypoints: torch.Tensor  # [N, 2]
    options: torch.Tensor    # [N] i32 RoadOption codes
    cursor: torch.Tensor     # [...] i32 index of the first un-passed waypoint


def make_route(path_xy: np.ndarray, sampling_radius: float = SAMPLING_RADIUS,
               batch_shape: Tuple[int, ...] = (), device=None) -> Route:
    """Resample a start->goal polyline at the sampling radius (host), with
    turn options from the heading change, and a cursor at the start for
    each of ``batch_shape`` egos; on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    dense = geo.dense_polyline2d_np(np.asarray(path_xy, float),
                                    resolution=sampling_radius)
    d = np.diff(dense, axis=0)
    yaw = np.arctan2(d[:, 1], d[:, 0])
    turn = np.zeros(len(dense))
    turn[1:-1] = np.degrees((np.diff(yaw) + np.pi) % (2 * np.pi) - np.pi)
    options = np.full(len(dense), int(RoadOption.LANEFOLLOW), np.int32)
    options[turn > 30] = int(RoadOption.LEFT)
    options[turn < -30] = int(RoadOption.RIGHT)
    return Route(waypoints=torch.as_tensor(dense, dtype=torch.float32,
                                           device=device),
                 options=torch.as_tensor(options, device=device),
                 cursor=torch.zeros(batch_shape, dtype=torch.int32,
                                    device=device))


def _ego(route: Route, ego_x, ego_y) -> torch.Tensor:
    wp = route.waypoints
    x, y = torch.broadcast_tensors(
        torch.as_tensor(ego_x, dtype=wp.dtype, device=wp.device),
        torch.as_tensor(ego_y, dtype=wp.dtype, device=wp.device))
    return torch.stack([x, y], -1)


def advance(route: Route, ego_x, ego_y,
            min_distance: float = MIN_DISTANCE) -> Route:
    """Purge passed waypoints: move each cursor past every waypoint behind
    the nearest one, and past the nearest too once within
    ``min_distance`` (route_planner.py:120-138); monotone."""
    wp = route.waypoints
    d = wp - _ego(route, ego_x, ego_y)[..., None, :]
    dist = geo.norm2(d[..., 0], d[..., 1])                      # [..., N]
    nearest = torch.argmin(dist, dim=-1, keepdim=True)
    near = torch.gather(dist, -1, nearest)[..., 0] < min_distance
    nearest = nearest[..., 0].to(torch.int32)
    new_cursor = torch.maximum(route.cursor,
                               torch.where(near, nearest + 1, nearest))
    return route._replace(cursor=torch.clamp(new_cursor,
                                             max=wp.shape[0] - 1))


def window(route: Route, size: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """Each cursor's fixed-size forward buffer ([..., size, 2] waypoints,
    [..., size] options); the route end clamps."""
    idx = torch.clamp(route.cursor[..., None].to(torch.int64)
                      + torch.arange(size, device=route.cursor.device),
                      0, route.waypoints.shape[0] - 1)
    return route.waypoints[idx], route.options[idx]


def distance_remaining(route: Route) -> torch.Tensor:
    """[...] arc length from each cursor to the goal."""
    d = torch.diff(route.waypoints, dim=0)
    seg = geo.norm2(d[:, 0], d[:, 1])
    passed = torch.arange(seg.shape[0], device=seg.device) \
        < route.cursor[..., None]
    return torch.where(passed, 0.0, seg).sum(-1)


def _hazards(route: Route, ego_x, ego_y, xy: torch.Tensor, proximity: float):
    """Each point's projection [..., K] onto its ego's forward buffer and
    whether it lies within ``proximity`` of the ego."""
    wp, _ = window(route, 8)
    proj = geo.project_points_to_lines(xy, wp[..., None, :, :])
    d = xy - _ego(route, ego_x, ego_y)[..., None, :]
    return proj, geo.norm2(d[..., 0], d[..., 1]) < proximity


def hazard_vehicle_ahead(route: Route, ego_x, ego_y,
                         veh_xy: torch.Tensor,     # [..., K, 2]
                         veh_valid: torch.Tensor,  # [..., K] bool
                         proximity: float = PROXIMITY_THRES,
                         lane_half_width: float = 2.0) -> torch.Tensor:
    """Lead-vehicle hazard (_is_vehicle_hazard): a valid vehicle within
    ``proximity`` of the ego whose projection onto the forward route lies
    ahead and within a lane half-width."""
    proj, near = _hazards(route, ego_x, ego_y, veh_xy, proximity)
    hits = veh_valid & near & (torch.abs(proj.distance) < lane_half_width) \
        & (proj.dist_start > 0.5)
    return hits.any(-1)


def hazard_red_light(route: Route, ego_x, ego_y,
                     light_xy: torch.Tensor,   # [..., K, 2] stop-line points
                     light_red: torch.Tensor,  # [..., K] bool
                     proximity: float = PROXIMITY_THRES) -> torch.Tensor:
    """Red-light hazard (_is_light_red): a red light's stop point within
    proximity and ahead on the route."""
    proj, near = _hazards(route, ego_x, ego_y, light_xy, proximity)
    hits = light_red & near & (proj.dist_start > 0.0) \
        & (torch.abs(proj.distance) < 5.0)
    return hits.any(-1)
