"""Dynamic drivable-area boundary, batch-first (the JAX package's
``cognition/drivable.py``).

DrivingSpaceConstructor's ``calculate_drivable_area``
(driving_space_constructor.py:827-1100) shatters the static
drivable-area polygon and the obstacle contours, converts them to
(angle, distance) around the ego and keeps the nearest point in each
angular direction, with the velocity of the object it belongs to.  Here
the angular sweep is a fixed-bin segment minimum (one ``scatter_reduce``
over the points of each env).
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np
import torch


class DynamicBoundary(NamedTuple):
    """Per angular bin: the nearest boundary point and its velocity."""

    x: torch.Tensor     # [..., bins]
    y: torch.Tensor
    vx: torch.Tensor
    vy: torch.Tensor
    dist: torch.Tensor  # distance from the ego (inf where the bin is open)


def _corners(cx, cy, yaw, length: float, width: float) -> torch.Tensor:
    """[..., 4, 2] rectangle corners (box_to_corners_2d,
    geometry.pyx:204), in the JAX package's corner order."""
    c, s = torch.cos(yaw)[..., None], torch.sin(yaw)[..., None]
    sx = torch.tensor([1.0, 1.0, -1.0, -1.0], dtype=cx.dtype, device=cx.device)
    sy = torch.tensor([1.0, -1.0, 1.0, -1.0], dtype=cx.dtype, device=cx.device)
    dx, dy = sx * (length / 2.0), sy * (width / 2.0)
    return torch.stack([cx[..., None] + c * dx - s * dy,
                        cy[..., None] + s * dx + c * dy], dim=-1)


def dynamic_boundary(ego_x, ego_y,
                     static_polygon: torch.Tensor,  # [..., P, 2] (dense)
                     obs_x, obs_y, obs_vx, obs_vy, obs_yaw,  # [..., K]
                     obs_valid,                     # [..., K]
                     obs_length: float = 4.5, obs_width: float = 1.8,
                     num_bins: int = 256, contour_samples: int = 16
                     ) -> DynamicBoundary:
    """Angular-sweep boundary: static polygon points (velocity 0) and
    obstacle contour samples (the object's velocity) compete in each
    angular bin and the nearest wins
    (driving_space_constructor.py:843-1100)."""
    dt, dev = obs_x.dtype, obs_x.device
    ego_x = torch.as_tensor(ego_x, dtype=dt, device=dev)
    ego_y = torch.as_tensor(ego_y, dtype=dt, device=dev)
    # obstacle contours: sample each box's edge loop
    t = torch.as_tensor(np.linspace(0.0, 4.0, contour_samples,
                                    endpoint=False), dtype=dt, device=dev)
    seg = torch.floor(t).to(torch.int64) % 4
    frac = (t - torch.floor(t))[:, None]
    corners = _corners(obs_x, obs_y, obs_yaw, obs_length, obs_width)
    a, b = corners[..., seg, :], corners[..., (seg + 1) % 4, :]
    pts = (a + frac * (b - a)).flatten(-3, -2)               # [..., K*S, 2]

    batch = torch.broadcast_shapes(ego_x.shape, static_polygon.shape[:-2],
                                   obs_x.shape[:-1])
    poly = static_polygon.expand(*batch, *static_polygon.shape[-2:])
    pts = pts.expand(*batch, *pts.shape[-2:])
    px = torch.cat([poly[..., 0], pts[..., 0]], -1)
    py = torch.cat([poly[..., 1], pts[..., 1]], -1)
    zero = torch.zeros_like(poly[..., 0])
    pvx = torch.cat([zero, obs_vx.repeat_interleave(contour_samples, -1)
                     .expand(*batch, -1)], -1)
    pvy = torch.cat([zero, obs_vy.repeat_interleave(contour_samples, -1)
                     .expand(*batch, -1)], -1)
    valid = torch.cat([torch.ones_like(zero, dtype=torch.bool),
                       obs_valid.repeat_interleave(contour_samples, -1)
                       .expand(*batch, -1)], -1)

    ex, ey = ego_x.expand(batch)[..., None], ego_y.expand(batch)[..., None]
    ang = torch.atan2(py - ey, px - ex)
    dist = torch.sqrt((px - ex) ** 2 + (py - ey) ** 2)
    bins = torch.clamp(torch.floor((ang + math.pi) / (2.0 * math.pi)
                                   * num_bins).to(torch.int64),
                       0, num_bins - 1)
    dist = torch.where(valid, dist, torch.inf)

    # segment minimum per bin, then the first point that attains it
    n = dist.shape[-1]
    bin_min = torch.full((*batch, num_bins), torch.inf, dtype=dt,
                         device=dev).scatter_reduce(-1, bins, dist, "amin")
    is_min = (dist == torch.gather(bin_min, -1, bins)) & torch.isfinite(dist)
    order = torch.arange(n, device=dev).expand(*batch, n)
    winner = torch.full((*batch, num_bins), n, dtype=torch.int64,
                        device=dev).scatter_reduce(
        -1, bins, torch.where(is_min, order, n), "amin")
    has = winner < n
    w = torch.clamp(winner, 0, n - 1)

    def at(v):
        return torch.gather(v, -1, w)

    return DynamicBoundary(
        x=torch.where(has, at(px), ex), y=torch.where(has, at(py), ey),
        vx=torch.where(has, at(pvx), 0.0), vy=torch.where(has, at(pvy), 0.0),
        dist=torch.where(has, bin_min, torch.inf))
