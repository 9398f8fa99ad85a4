"""Static map provider: recorded loops windowed around each ego,
batch-first (the JAX package's ``navigation/map_provider.py``).

The reference's ``NativeMap`` (map_provider/sumo/.../native_map.py:
16-148) keeps two recorded loop polylines and, per pose update, rotates
each circular lane to start at the point farthest from the ego.  Here
the rotation is a fixed-size modular window gather around the nearest
vertex, one for each ego of a batch, and the
:class:`~dcarl_tpu_torch.cognition.locator.StaticLocalMap` it produces
feeds the cognition layer.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional, Sequence

import numpy as np
import torch

from dcarl_tpu_torch.cognition.locator import StaticLocalMap
from dcarl_tpu_torch.device import resolve_device


class LoopMap(NamedTuple):
    """The full recorded map: L closed-loop lanes resampled to a common
    vertex count (outermost lane first, native_map.py:35-36)."""

    loops: torch.Tensor        # [L, N, 2]
    speed_limit: torch.Tensor  # [L] m/s
    target_lane_index: int = 0


def _resample_closed(points: np.ndarray, n: int) -> np.ndarray:
    """Arc-length resample of a closed polyline to n vertices (host)."""
    pts = np.asarray(points, np.float64)
    closed = np.vstack([pts, pts[:1]])
    seg = np.linalg.norm(np.diff(closed, axis=0), axis=1)
    s = np.concatenate([[0.0], np.cumsum(seg)])
    si = np.linspace(0.0, s[-1], n, endpoint=False)
    return np.stack([np.interp(si, s, closed[:, 0]),
                     np.interp(si, s, closed[:, 1])], axis=1)


def _loop_map(loops: Sequence[np.ndarray], speed_limit: float, device
              ) -> LoopMap:
    device = resolve_device(device)
    return LoopMap(
        loops=torch.as_tensor(np.stack(loops), dtype=torch.float32,
                              device=device),
        speed_limit=torch.full((len(loops),), speed_limit,
                               dtype=torch.float32, device=device))


def load_loop_map(paths: Sequence[str], n_points: int = 4096,
                  speed_limit: float = 15.0, device=None) -> LoopMap:
    """Recorded loops (inner/outer_loop.dat: CSV x,y rows,
    native_map.py:32-36); the first path is lane 0.  On ``device``
    (``cuda`` unless the caller passes ``device="cpu"``)."""
    return _loop_map([_resample_closed(np.loadtxt(p, delimiter=","),
                                       n_points) for p in paths],
                     speed_limit, device)


def synthetic_loop_map(n_lanes: int = 2, n_points: int = 1024,
                       radius: float = 200.0, lane_sep: float = 3.5,
                       speed_limit: float = 15.0, device=None) -> LoopMap:
    """A synthetic circular track standing in for the recorded loops
    (lane 0 outermost), on ``device``."""
    theta = np.linspace(0.0, 2.0 * np.pi, n_points, endpoint=False)
    return _loop_map([np.stack([(radius - i * lane_sep) * np.cos(theta),
                                (radius - i * lane_sep) * np.sin(theta)],
                               axis=1) for i in range(n_lanes)],
                     speed_limit, device)


def window_static_map(lmap: LoopMap, ego_x, ego_y, window: int = 256,
                      back_fraction: float = 0.25) -> StaticLocalMap:
    """Each ego's local static map ([...] egos): per lane, a
    ``window``-vertex stretch of the closed loop starting
    ``back_fraction`` of the window behind the nearest vertex (the
    fixed-shape form of rebuild_lane's rotate-at-farthest-point,
    native_map.py:83-109)."""
    loops = lmap.loops
    L, N = loops.shape[0], loops.shape[1]
    ex, ey = torch.broadcast_tensors(
        torch.as_tensor(ego_x, dtype=loops.dtype, device=loops.device),
        torch.as_tensor(ego_y, dtype=loops.dtype, device=loops.device))
    ego = torch.stack([ex, ey], -1)[..., None, None, :]
    d2 = ((loops - ego) ** 2).sum(-1)                           # [..., L, N]
    nearest = torch.argmin(d2, dim=-1)                          # [..., L]
    start = nearest - int(window * back_fraction)
    idx = (start[..., None] + torch.arange(window, device=loops.device)) % N

    def gather(i):
        lines = loops.expand(*i.shape[:-1], N, 2)
        return torch.gather(lines, -2, i[..., None].expand(*i.shape, 2))

    lanes = gather(idx)                                         # [..., L, W, 2]
    nxt = gather((idx + 1) % N)
    tangents = torch.atan2(nxt[..., 1] - lanes[..., 1],
                           nxt[..., 0] - lanes[..., 0])
    batch = ex.shape
    return StaticLocalMap(
        lanes=lanes, tangents=tangents,
        speed_limit=lmap.speed_limit.expand(*batch, L),
        stop_thru=torch.zeros((*batch, L), dtype=torch.bool,
                              device=loops.device),   # closed loop: no end
        target_lane_index=torch.full(batch, lmap.target_lane_index,
                                     dtype=torch.int64, device=loops.device))


def reference_loop_paths() -> Optional[Sequence[str]]:
    """The reference's recorded loops when available (ZZZ_ROOT layout,
    native_map.py:32-34); None otherwise."""
    root = os.environ.get("ZZZ_ROOT")
    if not root:
        return None
    base = os.path.join(root, "zzz/src/navigation/data")
    paths = [os.path.join(base, "outer_loop.dat"),
             os.path.join(base, "inner_loop.dat")]
    return paths if all(os.path.exists(p) for p in paths) else None
