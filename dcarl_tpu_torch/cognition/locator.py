"""NearestLocator: the lane-level world model from raw tracks,
batch-first (the JAX package's ``cognition/locator.py``).

zzz_cognition_object_locator/obstacle_locator.py merges the static map,
the tracked objects and the ego pose into a ``MapState`` at 20 Hz per
vehicle.  Here it is one function of tensors: every object is projected
onto every lane at once ([..., K, L] projections onto each env's own
lanes) and the per-lane sorted front/rear lists become nearest-slot
reductions (IDM, LaneUtility and RLSDecision read only the nearest
vehicle of each lane).

Shapes: the map's fields lead with the envs' batch dims or with none
(one map for every env); ego fields are [...], object fields [..., K],
light and sign fields [..., M].
"""

from __future__ import annotations

import math
from enum import IntEnum
from typing import NamedTuple, Optional, Tuple

import torch

from dcarl_tpu_torch.ops.geometry import (PolylineProjection,
                                          cartesian_to_frenet, gather_rows,
                                          project_points_to_lines)
from dcarl_tpu_torch.planning.multilane import LaneVehicle, MultiLaneState


class MapModel(IntEnum):
    """MapState.msg model enum."""

    JUNCTION = 0
    MULTILANE = 1


class Behavior(IntEnum):
    """RoadObstacle.msg behavior enum (the subset the stack reads)."""

    FOLLOW = 0
    MOVING_LEFT = 1
    MOVING_RIGHT = 2


class LightSignal(IntEnum):
    """ObjectSignals traffic-light enum (perception msg subset)."""

    UNKNOWN = 0
    RED = 1
    YELLOW = 2
    GREEN = 3


class StopState(IntEnum):
    """Lane.msg stop_state enum (navigation/protocol/msg/Lane.msg:20-26)."""

    UNKNOWN = 0
    THRU = 1
    YIELD = 2
    STOP = 3


class SignKind(IntEnum):
    """Detected road-sign classes the lane locators read."""

    NONE = 0
    STOP = 1
    SPEED_LIMIT = 2


class TrafficLightDetection(NamedTuple):
    """Fixed-M traffic-light detections (the constructor's
    ``_traffic_light_detection_buffer``, driving_space_constructor.py:
    77-80)."""

    signal: torch.Tensor  # [..., M] LightSignal
    valid: torch.Tensor   # [..., M] bool


class RoadSignDetection(NamedTuple):
    """Fixed-M detected road signs with a world position, attributed to
    their nearest lane (the reference left both locators as stubs,
    driving_space_constructor.py:1214-1229)."""

    kind: torch.Tensor   # [..., M] SignKind
    value: torch.Tensor  # [..., M] speed limit (m/s) of SPEED_LIMIT signs
    x: torch.Tensor      # [..., M]
    y: torch.Tensor      # [..., M]
    valid: torch.Tensor  # [..., M] bool


class StaticLocalMap(NamedTuple):
    """The windowed static map (navigation's Map msg): L lanes sampled to
    a common point count N, outermost lane first."""

    lanes: torch.Tensor              # [..., L, N, 2] central polylines
    tangents: torch.Tensor           # [..., L, N] tangent yaw at each point
    speed_limit: torch.Tensor        # [..., L] m/s
    stop_thru: torch.Tensor          # [..., L] bool: Lane.STOP_STATE_THRU
    target_lane_index: torch.Tensor  # [...]

    @property
    def num_lanes(self) -> int:
        return self.lanes.shape[-3]


class EgoPose(NamedTuple):
    x: torch.Tensor
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    yaw: torch.Tensor


class TrackedObjects(NamedTuple):
    """Fixed-K tracked-object table (TrackingBoxArray equivalent)."""

    x: torch.Tensor      # [..., K]
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    yaw: torch.Tensor
    valid: torch.Tensor  # [..., K] bool


def _project_all(x, y, lanes: torch.Tensor) -> PolylineProjection:
    """Points [*b, *e] onto every lane of lanes [*b, L, N, 2] (or [L, N,
    2]): the projection batched to [*b, *e, L]."""
    x, y = torch.broadcast_tensors(torch.as_tensor(x, dtype=lanes.dtype,
                                                   device=lanes.device),
                                   torch.as_tensor(y, dtype=lanes.dtype,
                                                   device=lanes.device))
    nb = max(lanes.ndim - 3, 0)
    extra = x.ndim - nb
    lines = lanes.reshape(lanes.shape[:nb] + (1,) * extra + lanes.shape[nb:])
    return project_points_to_lines(torch.stack([x, y], -1)[..., None, :],
                                   lines)


def _take_lane(field: torch.Tensor, idx: torch.Tensor, rest: int = 0
               ) -> torch.Tensor:
    """``field`` [*b, L, *r] (``rest`` = len(r); ``*b`` may be empty) at the
    lane ``idx`` [*b, *e]: [*b, *e, *r]."""
    nb = field.ndim - 1 - rest
    rows = field.reshape(field.shape[:nb] + (1,) * (idx.ndim - nb)
                         + (field.shape[nb], -1))
    return gather_rows(rows, idx.to(torch.int64)).reshape(
        idx.shape + field.shape[nb + 1:])


def _lane_index(d: torch.Tensor, lane_dist_thres: float) -> torch.Tensor:
    """Continuous lane index from signed distances [..., L] to every lane
    (locate_object_in_lane, obstacle_locator.py:138-170)."""
    ad = torch.abs(d)
    L = d.shape[-1]
    a = torch.argmin(ad, dim=-1, keepdim=True)
    # a functional update: the caller's distances stay as they are
    b = torch.argmin(ad.scatter(-1, a, torch.inf), dim=-1, keepdim=True)
    da, db = torch.gather(d, -1, a)[..., 0], torch.gather(d, -1, b)[..., 0]
    la, lb = torch.abs(da), torch.abs(db)
    af, bf = a[..., 0].to(d.dtype), b[..., 0].to(d.dtype)
    outside = da * db > 0                   # same side of both centers
    between = (bf * la + af * lb) / torch.clamp(la + lb, min=1e-9)
    idx = af if L < 2 else torch.where(outside, af, between)
    return torch.where(la > lane_dist_thres, -1.0, idx)


def locate_objects_in_lane(x, y, lanes: torch.Tensor,
                           lane_dist_thres: float = 5.0) -> torch.Tensor:
    """Continuous lane index of points: interpolated between the two
    nearest lane centers when a point lies between them; -1 when farther
    than ``lane_dist_thres`` from every lane."""
    return _lane_index(_project_all(x, y, lanes).distance, lane_dist_thres)


def _behavior(yaw, proj: PolylineProjection, tangents: torch.Tensor,
              lane_change_thres: float) -> torch.Tensor:
    closest_lane = torch.argmin(torch.abs(proj.distance), dim=-1)
    closest_idx = torch.gather(proj.closest_idx, -1,
                               closest_lane[..., None])[..., 0]
    lane_dir = _take_lane(tangents.flatten(-2),
                          closest_lane * tangents.shape[-1] + closest_idx)
    d_theta = (yaw - lane_dir + math.pi) % (2.0 * math.pi) - math.pi
    return torch.where(
        torch.abs(d_theta) > lane_change_thres,
        torch.where(d_theta > 0, int(Behavior.MOVING_LEFT),
                    int(Behavior.MOVING_RIGHT)),
        int(Behavior.FOLLOW)).to(torch.int32)


def predict_vehicle_behavior(yaw, x, y, smap: StaticLocalMap,
                             lane_change_thres: float = 0.2) -> torch.Tensor:
    """Behavior enum from the heading against the nearest lane's tangent
    (predict_vehicle_behavior, obstacle_locator.py:378-404)."""
    return _behavior(torch.as_tensor(yaw, dtype=smap.lanes.dtype,
                                     device=smap.lanes.device),
                     _project_all(x, y, smap.lanes), smap.tangents,
                     lane_change_thres)


def _to_stop_state(s: torch.Tensor) -> torch.Tensor:
    out = torch.full_like(s, int(StopState.UNKNOWN), dtype=torch.int32)
    for sig, st in ((LightSignal.GREEN, StopState.THRU),
                    (LightSignal.YELLOW, StopState.YIELD),
                    (LightSignal.RED, StopState.STOP)):
        out = torch.where(s == int(sig), int(st), out)
    return out


def locate_traffic_lights_in_lanes(lights: TrafficLightDetection,
                                   num_lanes: int) -> torch.Tensor:
    """[..., L] i32 per-lane StopState from light detections
    (driving_space_constructor.py:1179-1213): one detection states every
    lane; exactly L detections state lane i by light i; any other count
    above one stops all lanes unless a light is green; none is UNKNOWN."""
    valid = lights.valid
    sig = torch.where(valid, lights.signal, int(LightSignal.UNKNOWN))
    m = valid.to(torch.int32).sum(-1, keepdim=True)
    # valid signals compacted to the front (lane i <- i-th valid light)
    order = torch.argsort((~valid).to(torch.uint8), dim=-1, stable=True)
    sig_c = torch.gather(sig, -1, order)
    l_idx = torch.clamp(torch.arange(num_lanes, device=sig.device),
                        max=sig.shape[-1] - 1)
    per_lane = _to_stop_state(sig_c[..., l_idx])
    first = _to_stop_state(sig_c[..., :1]).expand_as(per_lane)
    any_green = ((sig == int(LightSignal.GREEN)) & valid).any(-1,
                                                              keepdim=True)
    out = torch.where(any_green, int(StopState.THRU),
                      int(StopState.STOP)).to(torch.int32).expand_as(per_lane)
    out = torch.where(m == num_lanes, per_lane, out)
    out = torch.where(m == 1, first, out)
    return torch.where(m == 0, int(StopState.UNKNOWN), out).to(torch.int32)


def _sign_lane_attribution(signs: RoadSignDetection, lanes: torch.Tensor,
                           attach_dist: float) -> torch.Tensor:
    """[..., M, L] bool: sign m applies to lane l (its nearest lane, within
    ``attach_dist`` of the center line)."""
    ad = torch.abs(_project_all(signs.x, signs.y, lanes).distance)
    nearest = torch.argmin(ad, dim=-1, keepdim=True)          # [..., M, 1]
    close = torch.gather(ad, -1, nearest)[..., 0] <= attach_dist
    lane_ids = torch.arange(lanes.shape[-3], device=lanes.device)
    return (nearest == lane_ids) & (signs.valid & close)[..., None]


def locate_stop_signs_in_lanes(signs: RoadSignDetection, lanes: torch.Tensor,
                               attach_dist: float = 8.0) -> torch.Tensor:
    """[..., L] bool: the lane has a detected stop sign (each STOP
    detection stops its nearest lane; the stop line sits at the lane
    end, as the traffic-light case)."""
    member = _sign_lane_attribution(signs, lanes, attach_dist)
    return (member & (signs.kind == int(SignKind.STOP))[..., None]).any(-2)


def locate_speed_limits_in_lanes(signs: RoadSignDetection,
                                 lanes: torch.Tensor,
                                 default_limit: torch.Tensor,
                                 attach_dist: float = 8.0) -> torch.Tensor:
    """[..., L] m/s: the minimum of the map default and every speed-limit
    sign attributed to the lane."""
    member = _sign_lane_attribution(signs, lanes, attach_dist)
    applies = member & (signs.kind == int(SignKind.SPEED_LIMIT))[..., None]
    lim = torch.where(applies, signs.value[..., None], torch.inf)
    return torch.minimum(default_limit, lim.amin(-2))


def update_map_state(smap: StaticLocalMap, ego: EgoPose,
                     objects: TrackedObjects,
                     lights: Optional[TrafficLightDetection] = None,
                     signs: Optional[RoadSignDetection] = None,
                     lane_end_dist_thres: float = 15.0,
                     lane_head_thres: float = 3.0,
                     lane_dist_thres: float = 5.0,
                     lane_width: float = 3.0,
                     vehicle_width: float = 1.7,
                     danger_area: float = 30.0,
                     ) -> Tuple[MultiLaneState, torch.Tensor, torch.Tensor]:
    """The NearestLocator.update tick (obstacle_locator.py:68-136,
    189-305, with the DrivingSpaceConstructor's light ingestion,
    driving_space_constructor.py:84-142, 1179-1213).

    Returns (mmap, model [...] i32, behaviors [..., K] i32): ``model`` is
    MapModel.JUNCTION when the ego is off-lane, at a lane head or close to
    a THRU lane's end.  A RED/YELLOW light or a stop sign reports
    ``traffic_light_stop`` with ``stop_distance`` the ego's distance to
    the lane's end (IDM's ``traffic_light_speed`` reads it)."""
    L = smap.num_lanes
    dtype, dev = smap.lanes.dtype, smap.lanes.device
    lanes_f = torch.arange(L, dtype=dtype, device=dev)
    batch = torch.broadcast_shapes(
        torch.as_tensor(ego.x).shape, smap.lanes.shape[:-3])
    # every map field with the envs' batch dims (views, no copies)
    smap = StaticLocalMap(
        lanes=smap.lanes.expand(*batch, *smap.lanes.shape[-3:]),
        tangents=smap.tangents.expand(*batch, *smap.tangents.shape[-2:]),
        speed_limit=smap.speed_limit.expand(*batch, L),
        stop_thru=smap.stop_thru.expand(*batch, L),
        target_lane_index=smap.target_lane_index.expand(batch))

    # --- ego location
    ego_proj = _project_all(ego.x, ego.y, smap.lanes)          # [..., L]
    ego_lane_index = _lane_index(ego_proj.distance, lane_dist_thres)
    ego_rounded = torch.clamp(torch.round(ego_lane_index).to(torch.int64),
                              0, L - 1)
    ego_head, ego_tail = ego_proj.dist_start, ego_proj.dist_end
    off_lane = ego_lane_index < 0
    near_tail = (_take_lane(ego_tail, ego_rounded) <= lane_end_dist_thres) \
        & _take_lane(smap.stop_thru, ego_rounded)
    near_head = _take_lane(ego_head, ego_rounded) <= lane_head_thres
    model = torch.where(off_lane | near_tail | near_head,
                        int(MapModel.JUNCTION),
                        int(MapModel.MULTILANE)).to(torch.int32)
    ego_ff = cartesian_to_frenet(ego.x, ego.y, ego.vx, ego.vy, ego.yaw,
                                 _take_lane(smap.lanes, ego_rounded, 2),
                                 _take_lane(smap.tangents, ego_rounded, 1))
    ego_speed = torch.sqrt(torch.as_tensor(ego.vx) ** 2
                           + torch.as_tensor(ego.vy) ** 2)

    # --- objects onto lanes: [..., K, L] projections
    obj_proj = _project_all(objects.x, objects.y, smap.lanes)
    obj_dist = obj_proj.distance
    closest = torch.argmin(torch.abs(obj_dist), dim=-1)          # [..., K]
    d_closest = torch.abs(torch.gather(obj_dist, -1, closest[..., None])
                          )[..., 0]
    dist_to_ego = torch.sqrt((objects.x - ego.x[..., None]) ** 2
                             + (objects.y - ego.y[..., None]) ** 2)
    usable = objects.valid & (dist_to_ego <= danger_area) \
        & (d_closest <= lane_width * 0.5 + vehicle_width * 0.5)
    member = (closest[..., None] == torch.arange(L, device=dev)) \
        & usable[..., None]

    obj_head, obj_tail = obj_proj.dist_start, obj_proj.dist_end  # [..., K, L]
    # front: closer to the lane end than the ego, relative s = ego_tail -
    # obj_tail (obstacle_locator.py:279); rear: relative s = obj_head -
    # ego_head (negative, :297)
    front_s = ego_tail[..., None, :] - obj_tail
    rear_s = obj_head - ego_head[..., None, :]
    is_front = member & (obj_tail < ego_tail[..., None, :])
    is_rear = member & (obj_head < ego_head[..., None, :]) & ~is_front

    # per-object Frenet speed in its closest lane
    obj_ff = cartesian_to_frenet(objects.x, objects.y, objects.vx,
                                 objects.vy, objects.yaw,
                                 _take_lane(smap.lanes, closest, 2),
                                 _take_lane(smap.tangents, closest, 1))
    obj_lane_cont = _lane_index(obj_dist, lane_dist_thres)       # [..., K]

    front_key = torch.where(is_front, front_s, torch.inf)
    front_idx = torch.argmin(front_key, dim=-2)                  # [..., L]
    front_exists = torch.isfinite(front_key.amin(-2))
    rear_key = torch.where(is_rear, rear_s, -torch.inf)
    rear_idx = torch.argmax(rear_key, dim=-2)
    rear_exists = rear_key.amax(-2) > -torch.inf

    def per_lane(v, idx):
        return torch.gather(v, -2, idx[..., None, :])[..., 0, :]

    def obj(v, idx):
        return torch.gather(v, -1, idx)

    front = LaneVehicle(
        exists=front_exists,
        s=torch.where(front_exists, per_lane(front_s, front_idx), 50.0),
        d=torch.where(front_exists, obj(obj_lane_cont, front_idx), lanes_f),
        vs=torch.where(front_exists, obj(obj_ff.vs, front_idx), 20.0),
        vd=torch.where(front_exists, obj(obj_ff.vd, front_idx), 0.0))
    rear = LaneVehicle(
        exists=rear_exists,
        s=torch.where(rear_exists, per_lane(rear_s, rear_idx), -50.0),
        d=torch.where(rear_exists, obj(obj_lane_cont, rear_idx), lanes_f),
        vs=torch.where(rear_exists, obj(obj_ff.vs, rear_idx), 0.0),
        vd=torch.where(rear_exists, obj(obj_ff.vd, rear_idx), 0.0))
    behaviors = _behavior(objects.yaw, obj_proj, smap.tangents, 0.2)

    # --- traffic lights -> per-lane stop states; the stop line sits at
    # the lane end.  UNKNOWN (no detections) is no standing red.
    if lights is None:
        light_stop = torch.zeros((*batch, L), dtype=torch.bool, device=dev)
    else:
        stop_state = locate_traffic_lights_in_lanes(lights, L)
        light_stop = (stop_state == int(StopState.STOP)) \
            | (stop_state == int(StopState.YIELD))
    # --- detected road signs: stop signs stop their lane; speed-limit
    # boards cap it
    speed_limit = smap.speed_limit
    if signs is not None:
        light_stop = light_stop | locate_stop_signs_in_lanes(
            signs, smap.lanes)
        speed_limit = locate_speed_limits_in_lanes(signs, smap.lanes,
                                                   speed_limit)

    mmap = MultiLaneState(
        ego_lane_index=ego_lane_index, ego_speed=ego_speed,
        ego_vd=ego_ff.vd, front=front, rear=rear, speed_limit=speed_limit,
        distance_to_junction=_take_lane(ego_tail, ego_rounded),
        target_lane_index=smap.target_lane_index.to(dtype),
        traffic_light_stop=light_stop,
        stop_distance=torch.where(light_stop, ego_tail, 1e6))
    return mmap, model, behaviors
