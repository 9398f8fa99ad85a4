"""OpenDrive hdmap provider: the LocalMap equivalent (the JAX package's
``navigation/opendrive.py``).

The reference's ``LocalMap`` (map_provider/sumo/src/
zzz_navigation_map_provider_sumo/local_map.py:24-260) loads an
OpenDrive/SUMO net through ``netconvert`` and sumolib, locates the ego's
current edge, and republishes a static map of that edge's lanes whenever
the edge changes or a junction approaches.  This module parses the
useful OpenDrive subset directly, on the host:

* ``<road>`` planView geometries ``line`` and ``arc`` (sampled at 0.5 m,
  the reference's curve resolution),
* ``<laneSection>`` left/right driving lanes with cubic width records,
* road ``<link>`` successor/predecessor (road or junction),
* ``<junction>`` connections (for target-lane routing).

Each published map is the same
:class:`~dcarl_tpu_torch.cognition.locator.StaticLocalMap` the loop
provider (``map_provider.window_static_map``) makes, as tensors on the
provider's device, so the cognition and planning stack does not depend
on the provider.
"""

from __future__ import annotations

import math
import xml.etree.ElementTree as ET
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.cognition.locator import StaticLocalMap
from dcarl_tpu_torch.device import resolve_device

DEFAULT_RESOLUTION = 0.5  # m — the reference's opendrive.curve-resolution


# ---------------------------------------------------------------------------
# Parsing
# ---------------------------------------------------------------------------


@dataclass
class _Geom:
    s: float
    x: float
    y: float
    hdg: float
    length: float
    kind: str          # "line" | "arc"
    curvature: float = 0.0


@dataclass
class _WidthRec:
    s_offset: float
    a: float
    b: float
    c: float
    d: float

    def eval(self, ds: float) -> float:
        t = ds - self.s_offset
        return self.a + self.b * t + self.c * t * t + self.d * t ** 3


@dataclass
class _Lane:
    id: int            # OpenDrive lane id: >0 left, <0 right
    type: str
    widths: List[_WidthRec]

    def width_at(self, ds: float) -> float:
        recs = [w for w in self.widths if w.s_offset <= ds + 1e-9]
        rec = recs[-1] if recs else (self.widths[0] if self.widths else None)
        return rec.eval(ds) if rec else 3.5


@dataclass
class Road:
    id: str
    length: float
    junction: str               # "-1" when not inside a junction
    successor: Optional[Tuple[str, str]]    # (elementType, elementId)
    predecessor: Optional[Tuple[str, str]]
    geoms: List[_Geom]
    lanes_left: List[_Lane]
    lanes_right: List[_Lane]
    # sampled: lane centerline polylines, rightmost lane first
    # (calibrate_lane_index, local_map.py:216 — "righest lane index 0")
    lane_lines: List[np.ndarray] = field(default_factory=list)
    lane_ids: List[int] = field(default_factory=list)
    speed_limit: float = 40.0 / 3.6  # locate_speed_limit_in_lanes default


@dataclass
class Connection:
    incoming_road: str
    connecting_road: str
    lane_links: List[Tuple[int, int]]   # (from, to)


def _ref_line(geoms: List[_Geom], length: float, resolution: float
              ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Sample the road reference line: (s, xy[N,2], hdg[N])."""
    n = max(int(math.ceil(length / resolution)) + 1, 2)
    s = np.linspace(0.0, length, n)
    xy = np.zeros((n, 2))
    hdg = np.zeros(n)
    for g in geoms:
        sel = (s >= g.s - 1e-9) & (s <= g.s + g.length + 1e-9)
        ds = s[sel] - g.s
        if g.kind == "arc" and abs(g.curvature) > 1e-12:
            k = g.curvature
            xy[sel, 0] = g.x + (np.sin(g.hdg + k * ds) - np.sin(g.hdg)) / k
            xy[sel, 1] = g.y - (np.cos(g.hdg + k * ds) - np.cos(g.hdg)) / k
            hdg[sel] = g.hdg + k * ds
        else:  # line (and zero-curvature arc)
            xy[sel, 0] = g.x + np.cos(g.hdg) * ds
            xy[sel, 1] = g.y + np.sin(g.hdg) * ds
            hdg[sel] = g.hdg
    return s, xy, hdg


def _sample_road(road: Road, resolution: float) -> None:
    """Fill road.lane_lines with driving-lane centerlines, rightmost
    first.  OpenDrive: right lanes have negative ids growing outward
    (-1 adjacent to the reference line); left lanes positive."""
    s, xy, hdg = _ref_line(road.geoms, road.length, resolution)
    normal = np.stack([-np.sin(hdg), np.cos(hdg)], axis=1)  # left normal

    def center_offsets(lanes: List[_Lane], sign: float) -> List[np.ndarray]:
        # cumulative offset from the reference line to each lane center
        out = []
        acc = np.zeros_like(s)
        for ln in sorted(lanes, key=lambda l: abs(l.id)):
            w = np.array([ln.width_at(d) for d in s])
            center = acc + w * 0.5
            acc = acc + w
            if ln.type == "driving":
                out.append(sign * center)
        return out

    entries: List[Tuple[float, np.ndarray, int]] = []
    for off, ln in zip(center_offsets(road.lanes_right, -1.0),
                       [l for l in sorted(road.lanes_right,
                                          key=lambda l: abs(l.id))
                        if l.type == "driving"]):
        entries.append((float(np.mean(off)), xy + off[:, None] * normal,
                        ln.id))
    for off, ln in zip(center_offsets(road.lanes_left, 1.0),
                       [l for l in sorted(road.lanes_left,
                                          key=lambda l: abs(l.id))
                        if l.type == "driving"]):
        # left lanes run opposite the reference direction in OpenDrive;
        # flip so every polyline goes in its own travel direction
        entries.append((float(np.mean(off)),
                        (xy + off[:, None] * normal)[::-1], ln.id))

    # rightmost (most negative lateral offset) first = lane index 0
    entries.sort(key=lambda e: e[0])
    road.lane_lines = [e[1] for e in entries]
    road.lane_ids = [e[2] for e in entries]


def parse_opendrive(source: str, resolution: float = DEFAULT_RESOLUTION
                    ) -> Tuple[Dict[str, Road], Dict[str, List[Connection]]]:
    """Parse an .xodr document (path or XML string) into sampled roads
    and junction connection tables."""
    root = (ET.fromstring(source) if source.lstrip().startswith("<")
            else ET.parse(source).getroot())

    roads: Dict[str, Road] = {}
    for r in root.findall("road"):
        geoms = []
        for g in r.findall("./planView/geometry"):
            arc = g.find("arc")
            geoms.append(_Geom(
                s=float(g.get("s", 0)), x=float(g.get("x", 0)),
                y=float(g.get("y", 0)), hdg=float(g.get("hdg", 0)),
                length=float(g.get("length", 0)),
                kind="arc" if arc is not None else "line",
                curvature=float(arc.get("curvature")) if arc is not None
                else 0.0))

        def lanes_of(side: str) -> List[_Lane]:
            out = []
            for ln in r.findall(f"./lanes/laneSection/{side}/lane"):
                widths = [_WidthRec(
                    s_offset=float(w.get("sOffset", 0)),
                    a=float(w.get("a", 0)), b=float(w.get("b", 0)),
                    c=float(w.get("c", 0)), d=float(w.get("d", 0)))
                    for w in ln.findall("width")]
                out.append(_Lane(id=int(ln.get("id")),
                                 type=ln.get("type", "driving"),
                                 widths=widths))
            return out

        def link_of(tag: str) -> Optional[Tuple[str, str]]:
            el = r.find(f"./link/{tag}")
            if el is None:
                return None
            return (el.get("elementType", "road"), el.get("elementId", ""))

        road = Road(
            id=r.get("id"), length=float(r.get("length", 0)),
            junction=r.get("junction", "-1"),
            successor=link_of("successor"), predecessor=link_of("predecessor"),
            geoms=geoms, lanes_left=lanes_of("left"),
            lanes_right=lanes_of("right"))
        speed = r.find("./type/speed")
        if speed is not None:
            v = float(speed.get("max", 0))
            road.speed_limit = v / 3.6 if speed.get("unit", "km/h") == "km/h" \
                else v
        _sample_road(road, resolution)
        roads[road.id] = road

    junctions: Dict[str, List[Connection]] = {}
    for j in root.findall("junction"):
        conns = []
        for c in j.findall("connection"):
            links = [(int(l.get("from")), int(l.get("to")))
                     for l in c.findall("laneLink")]
            conns.append(Connection(
                incoming_road=c.get("incomingRoad"),
                connecting_road=c.get("connectingRoad"),
                lane_links=links))
        junctions[j.get("id")] = conns
    return roads, junctions


# ---------------------------------------------------------------------------
# The provider (LocalMap.update semantics)
# ---------------------------------------------------------------------------


class LocalHdMap:
    """Stateful hdmap provider mirroring ``LocalMap``'s update protocol
    (local_map.py:134-216): track the ego's current edge, rebuild the
    static map on edge change (mode 1), near a section end (mode 3), or
    on entering a junction (mode 2, ``in_junction`` map)."""

    def __init__(self, source: str,
                 resolution: float = DEFAULT_RESOLUTION,
                 lane_search_radius: float = 4.0,
                 perception_range: float = 10.0,
                 route: Optional[Sequence[str]] = None,
                 window_points: int = 128, device=None):
        """``device`` holds the published maps (``cuda`` unless the
        caller passes ``device="cpu"``)."""
        self.device = resolve_device(device)
        self.roads, self.junctions = parse_opendrive(source, resolution)
        self.lane_search_radius = lane_search_radius
        self.perception_range = perception_range
        self.route = list(route) if route else None
        self.window_points = window_points
        self.current_road: Optional[str] = None
        self.in_junction = False

    # -- lane location (getNeighboringLanes equivalent) ------------------
    def locate(self, x: float, y: float
               ) -> Optional[Tuple[str, int, float]]:
        """(road_id, lane_index, distance) of the closest driving lane
        within the search radius; None in junction gaps.  Roads inside
        junctions (junction != -1) are excluded, matching
        ``includeJunctions=False`` (local_map.py:154)."""
        best = None
        p = np.array([x, y])
        for rid, road in self.roads.items():
            if road.junction != "-1":
                continue
            for li, line in enumerate(road.lane_lines):
                d = float(np.min(np.linalg.norm(line - p, axis=1)))
                if best is None or d < best[2]:
                    best = (rid, li, d)
        if best is None or best[2] > self.lane_search_radius:
            return None
        return best

    # -- target lane from junction connectivity --------------------------
    def _target_lane(self, road: Road) -> int:
        """Index of the lane whose junction connection continues the
        route (update_target_lane's role); 0 when unknown."""
        if not self.route or road.successor is None:
            return 0
        etype, eid = road.successor
        if etype != "junction" or eid not in self.junctions:
            return 0
        try:
            pos = self.route.index(road.id)
            nxt = self.route[pos + 1]
        except (ValueError, IndexError):
            return 0
        for conn in self.junctions[eid]:
            if conn.incoming_road != road.id:
                continue
            via = self.roads.get(conn.connecting_road)
            reaches = (conn.connecting_road == nxt or (
                via is not None and via.successor is not None
                and via.successor[1] == nxt))
            if reaches:
                for frm, _ in conn.lane_links:
                    if frm in road.lane_ids:
                        return road.lane_ids.index(frm)
        return 0

    # -- static map construction -----------------------------------------
    def static_map(self, road_id: str) -> StaticLocalMap:
        road = self.roads[road_id]
        n = self.window_points
        lanes, tangents = [], []
        for line in road.lane_lines:
            res = _resample(line, n)
            lanes.append(res)
            d = np.diff(res, axis=0)
            t = np.arctan2(d[:, 1], d[:, 0])
            tangents.append(np.concatenate([t, t[-1:]]))
        L = len(lanes)
        ends_in_junction = (road.successor is not None
                            and road.successor[0] == "junction")
        dev = self.device
        return StaticLocalMap(
            lanes=torch.as_tensor(np.stack(lanes), dtype=torch.float32,
                                  device=dev),
            tangents=torch.as_tensor(np.stack(tangents), dtype=torch.float32,
                                     device=dev),
            speed_limit=torch.full((L,), road.speed_limit,
                                   dtype=torch.float32, device=dev),
            stop_thru=torch.full((L,), ends_in_junction, dtype=torch.bool,
                                 device=dev),
            target_lane_index=torch.tensor(self._target_lane(road),
                                           device=dev),
        )

    # -- the update tick ---------------------------------------------------
    def should_update(self, x: float, y: float) -> int:
        """0 = no change, 1 = edge changed, 2 = entered junction,
        3 = near section end (local_map.py:145-181)."""
        loc = self.locate(x, y)
        if loc is None:
            if not self.in_junction:
                self.in_junction = True
                return 2
            return 0
        rid, li, _ = loc
        self.in_junction = False
        if rid != self.current_road:
            self.current_road = rid
            return 1
        tail = self.roads[rid].lane_lines[li][-1]
        if math.hypot(x - tail[0], y - tail[1]) < self.perception_range:
            return 3
        return 0

    def update(self, x: float, y: float) -> Optional[StaticLocalMap]:
        """Returns a fresh StaticLocalMap when one is due, else None
        (LocalMap.update, local_map.py:134-142).  In-junction mode has
        no lanes; the caller switches the cognition model to JUNCTION
        (the locator does this on its own when the ego is off-lane)."""
        mode = self.should_update(x, y)
        if mode in (1, 3):
            return self.static_map(self.current_road)
        return None


def _resample(line: np.ndarray, n: int) -> np.ndarray:
    seg = np.linalg.norm(np.diff(line, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    si = np.linspace(0.0, s[-1], n)
    return np.stack([np.interp(si, s, line[:, 0]),
                     np.interp(si, s, line[:, 1])], axis=1)
