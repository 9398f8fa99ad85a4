"""Polyline geometry, batch-first (the JAX package's ``ops/geometry.py``).

The reference's branchy "8-case" signed point-to-polyline distance
(tools.py:141-222) is a chain of ``torch.where`` selects, so a batch of
points ``[..., 2]`` projects onto one ``[N, 2]`` line at once: where the
JAX function is ``vmap``-ped over points, the port takes the points'
leading dims (and where it is ``vmap``-ped over lines too,
:func:`project_points_to_lines` takes [..., N, 2] lines).  Where the reference takes ``jnp.linalg.norm`` of a 2-D
vector, the port writes :func:`norm2` out as ``sqrt(dx*dx + dy*dy)``:
the nearest vertex is a first-minimum ``argmin`` over those distances,
and the lane-major drivers (``planning/fast_rollout.py``) compute the
same bits, so the readable and the fast drivers agree bit for bit.
(XLA fuses the second square into the sum as one FMA, so the JAX
package's distances may differ from these in the last place.)  Arc
lengths use the 16-element blocked prefix sum of XLA's CPU ``cumsum``.

Host-side (numpy, dynamic-shape) helpers carry the ``_np`` suffix.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.ops.spline import _cumsum_blocked


def wrap_angle(theta):
    """Normalize an angle to [-pi, pi) (tools.py:48-57); ``%`` takes the
    divisor's sign, as ``jnp.remainder`` does."""
    return (theta + math.pi) % (2.0 * math.pi) - math.pi


def norm2(dx: torch.Tensor, dy: torch.Tensor) -> torch.Tensor:
    """Length of the 2-D vectors (dx, dy), written out (``jnp.linalg.norm``
    in the reference)."""
    return torch.sqrt(dx * dx + dy * dy)


def _seg_lengths(line: torch.Tensor) -> torch.Tensor:
    d = torch.diff(line, dim=-2)
    return norm2(d[..., 0], d[..., 1])


def polyline_length(line: torch.Tensor) -> torch.Tensor:
    """Total arc length of a [N, 2] line (tools.py:59-69)."""
    return torch.sum(_seg_lengths(line))


def arclengths(line: torch.Tensor) -> torch.Tensor:
    """[..., N] cumulative arc length of [..., N, 2] lines, 0 at the first
    vertex."""
    seg = _seg_lengths(line)
    return torch.cat([torch.zeros_like(seg[..., :1]), _cumsum_blocked(seg)],
                     dim=-1)


def interp(x: torch.Tensor, xp: torch.Tensor, fp: torch.Tensor) -> torch.Tensor:
    """``jnp.interp`` with constant ends: ``xp``/``fp`` are [N] or
    [..., N] (one table per leading index, matching ``x``'s leading
    dims), ``x`` any shape for a 1-D table, [..., M] otherwise."""
    n = xp.shape[-1]
    if xp.ndim == 1:
        i = torch.searchsorted(xp, x.contiguous(), right=True)
    else:
        i = torch.searchsorted(xp.contiguous(), x.contiguous(), right=True)
    i = torch.clamp(i, 1, n - 1)

    def at(t, j):
        return t[j] if t.ndim == 1 else torch.gather(t, -1, j)

    f_lo, f_hi = at(fp, i - 1), at(fp, i)
    x_lo, x_hi = at(xp, i - 1), at(xp, i)
    df = f_hi - f_lo
    dx = x_hi - x_lo
    delta = x - x_lo
    eps = float(np.spacing(np.finfo(
        np.float64 if xp.dtype == torch.float64 else np.float32).eps))
    dx0 = torch.abs(dx) <= eps
    f = torch.where(dx0, f_lo, f_lo + (delta / torch.where(dx0, 1.0, dx)) * df)
    first, last = xp[..., :1], xp[..., -1:]
    f = torch.where(x < first, fp[..., :1], f)
    return torch.where(x > last, fp[..., -1:], f)


def resample_polyline(line: torch.Tensor, num: int) -> torch.Tensor:
    """Arc-length uniform resampling of a [N, 2] line to ``num`` points
    (the in-graph ``dense_polyline2d``, tools.py:72-96); the sample grid
    is ``jnp.linspace``'s ``start (1 - t) + stop t``."""
    s = arclengths(line)
    stop = s[-1]
    t = torch.arange(num - 1, dtype=line.dtype, device=line.device) / (num - 1)
    s_space = torch.cat([0.0 * (1 - t) + stop * t, stop[None]])
    return torch.stack([interp(s_space, s, line[:, 0]),
                        interp(s_space, s, line[:, 1])], dim=1)


def dense_polyline2d_np(line: np.ndarray, resolution: float) -> np.ndarray:
    """Dense arc-length resampling with the reference's sizing rule
    ``num = round(total / resolution)`` (tools.py:72-96)."""
    line = np.asarray(line, dtype=np.float64)
    if len(line) == 0:
        raise ValueError("Line input is null")
    s = np.concatenate([[0], np.cumsum(np.linalg.norm(np.diff(line, axis=0), axis=1))])
    num = int(round(s[-1] / resolution))
    s_space = np.linspace(0, s[-1], num=num)
    x = np.interp(s_space, s, line[:, 0])
    y = np.interp(s_space, s, line[:, 1])
    return np.stack([x, y], axis=1)


def dist_point_to_segments(p: torch.Tensor, a: torch.Tensor, b: torch.Tensor):
    """(dl, d1, d2) of points ``p`` [..., 2] against segments a -> b
    ([..., 2], broadcast with ``p``) (tools.py:124-138): ``dl`` signed
    perpendicular distance, ``d1`` projection arc from the head, ``d2``
    projection arc to the tail."""
    x0, y0 = p[..., 0], p[..., 1]
    x1, y1 = a[..., 0], a[..., 1]
    x2, y2 = b[..., 0], b[..., 1]
    l = torch.sqrt((y2 - y1) ** 2 + (x2 - x1) ** 2)
    safe_l = torch.where(l == 0, 1.0, l)
    dl = ((y2 - y1) * x0 - (x2 - x1) * y0 + x2 * y1 - x1 * y2) / safe_l
    d1 = (x1 * x1 + x0 * (x2 - x1) - x1 * x2 + y1 * y1 + y0 * (y2 - y1)
          - y1 * y2) / safe_l
    d2 = (x2 * x2 - x0 * (x2 - x1) - x1 * x2 + y2 * y2 - y0 * (y2 - y1)
          - y1 * y2) / safe_l
    # degenerate segment: distance to the (equal) endpoints
    dl0 = torch.sqrt((y0 - y1) ** 2 + (x0 - x1) ** 2)
    dl = torch.where(l == 0, dl0, dl)
    d1 = torch.where(l == 0, 0.0, d1)
    d2 = torch.where(l == 0, 0.0, d2)
    return dl, d1, d2


class PolylineProjection(NamedTuple):
    """Signed point-to-polyline projection, one entry per point."""

    distance: torch.Tensor      # signed lateral distance
    closest_idx: torch.Tensor   # i64 index of the nearest vertex
    closest_type: torch.Tensor  # i64 0: vertex, 1: next seg., -1: previous
    dist_start: torch.Tensor    # arc length from line start to the foot
    dist_end: torch.Tensor      # arc length from the foot to line end


def gather_rows(t: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """``t[..., i, :]`` of [..., N, C] rows for an index of the (broadcast)
    leading shape: [..., C]."""
    t = t.expand(*i.shape, *t.shape[-2:])
    idx = i[..., None, None].expand(*i.shape, 1, t.shape[-1])
    return torch.gather(t, -2, idx)[..., 0, :]


def project_point_to_polyline(p: torch.Tensor, line: torch.Tensor
                              ) -> PolylineProjection:
    """Signed distance and arc-length projection of points ``p`` [..., 2]
    onto a [N, 2] polyline: the vectorized 8-case logic of
    ``dist_from_point_to_polyline2d`` (tools.py:141-222) as nested
    selects.  The nearest vertex is the first minimum, as ``jnp.argmin``
    takes it."""
    cum = arclengths(line)
    return _project(p, line[:, 0], line[:, 1], lambda i: line[i],
                    lambda i: cum[i], cum[-1], line.shape[0])


def project_points_to_lines(p: torch.Tensor, lines: torch.Tensor
                            ) -> PolylineProjection:
    """:func:`project_point_to_polyline` with a line of its own for each
    point: points ``p`` [..., 2] onto lines [..., N, 2], the leading dims
    broadcast (the JAX package ``vmap``-s the one-line form over lines).
    For one line it gives the one-line form's bits: the same operations
    on the same values."""
    n = lines.shape[-2]
    batch = torch.broadcast_shapes(p.shape[:-1], lines.shape[:-2])
    p = p.expand(*batch, 2)
    lines_b = lines.expand(*batch, n, 2)
    cum = arclengths(lines).expand(*batch, n)

    def cum_at(i):
        return torch.gather(cum, -1, i[..., None])[..., 0]

    return _project(p, lines_b[..., 0], lines_b[..., 1],
                    lambda i: gather_rows(lines_b, i), cum_at, cum[..., -1], n)


def _project(p, line_x, line_y, take, cum_at, total, n: int
             ) -> PolylineProjection:
    """Body of both projections: ``line_x``/``line_y`` [..., N] the
    vertices, ``take(i)`` the vertices at index ``i`` ([..., 2]),
    ``cum_at(i)`` the arc lengths there and ``total`` the line length."""
    dx = line_x - p[..., 0, None]                      # [..., N]
    dy = line_y - p[..., 1, None]
    dist_line = norm2(dx, dy)
    ci = torch.argmin(dist_line, dim=-1)

    seg_prev = torch.clamp(ci - 1, 0, n - 2)   # segment [ci-1, ci]
    seg_next = torch.clamp(ci, 0, n - 2)       # segment [ci, ci+1]
    dl_p, d1_p, d2_p = dist_point_to_segments(p, take(seg_prev),
                                              take(seg_prev + 1))
    dl_n, d1_n, d2_n = dist_point_to_segments(p, take(seg_next),
                                              take(seg_next + 1))
    at_start = ci == 0
    at_end = ci == n - 1

    # interior vertex (case 5): the sign comes from the turn direction
    ci_m1 = torch.clamp(ci - 1, 0, n - 1)
    ci_p1 = torch.clamp(ci + 1, 0, n - 1)
    turn_dl, _, _ = dist_point_to_segments(take(ci_p1), take(ci_m1), take(ci))
    vertex_sign_interior = torch.where(turn_dl > 0, -1.0, 1.0).to(line_x.dtype)

    d_vertex = torch.gather(dist_line, -1, ci[..., None])[..., 0]
    # start / end vertex cases keep the sign of the adjacent segment's dl
    dist_c0_start = torch.where(dl_n < 0, -d_vertex, d_vertex)  # case 1
    dist_c0_end = torch.where(dl_p < 0, -d_vertex, d_vertex)    # case 3
    dist_c0_mid = vertex_sign_interior * d_vertex               # case 5

    both_out = (d2_p < 0) & (d1_n < 0)
    prev_out = d2_p < 0
    next_out = d1_n < 0
    pick_prev = torch.abs(dl_n) > torch.abs(dl_p)  # case 8 tie-break
    dist_i = torch.where(
        both_out, dist_c0_mid,
        torch.where(prev_out, dl_n,
                    torch.where(next_out, dl_p,
                                torch.where(pick_prev, dl_p, dl_n))))
    one = torch.ones_like(ci)
    type_i = torch.where(
        both_out, 0 * one,
        torch.where(prev_out, one,
                    torch.where(next_out, -one,
                                torch.where(pick_prev, -one, one))))
    dist_s = torch.where(d1_n < 0, dist_c0_start, dl_n)
    type_s = torch.where(d1_n < 0, 0 * one, one)
    dist_e = torch.where(d2_p < 0, dist_c0_end, dl_p)
    type_e = torch.where(d2_p < 0, 0 * one, -one)

    distance = torch.where(at_start, dist_s, torch.where(at_end, dist_e, dist_i))
    ctype = torch.where(at_start, type_s, torch.where(at_end, type_e, type_i))

    # arc-length bookkeeping (tools.py:205-220)
    ds_next = d1_n + cum_at(seg_next)
    de_next = d2_n + (total - cum_at(seg_next + 1))
    ds_prev = d1_p + cum_at(seg_prev)
    de_prev = d2_p + (total - cum_at(seg_prev + 1))
    ds_vert = cum_at(ci)
    de_vert = total - cum_at(ci)
    dist_start = torch.where(ctype == 1, ds_next,
                             torch.where(ctype == -1, ds_prev, ds_vert))
    dist_end = torch.where(ctype == 1, de_next,
                           torch.where(ctype == -1, de_prev, de_vert))
    return PolylineProjection(distance, ci, ctype, dist_start, dist_end)


# the JAX package's vmapped form; the port's function already takes a batch
project_points_to_polyline = project_point_to_polyline


class FrenetState(NamedTuple):
    s: torch.Tensor    # arc length along the line
    d: torch.Tensor    # signed lateral offset
    psi: torch.Tensor  # heading error relative to the line tangent
    vs: torch.Tensor   # longitudinal velocity
    vd: torch.Tensor   # lateral velocity


def _as(t, like: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(t, dtype=like.dtype, device=like.device)


def cartesian_to_frenet(x, y, vx, vy, yaw, line: torch.Tensor,
                        tangents: Optional[torch.Tensor] = None
                        ) -> FrenetState:
    """Cartesian -> Frenet (tools.py:224-257, kinematics.pyx:115-178) for
    points of any leading shape: project onto the line, take the tangent
    of the hosting segment, rotate the velocity into the (s, d) frame.
    ``line`` is one [N, 2] line, or [..., N, 2] lines, one for each point
    (``tangents`` [..., N] with them), as :func:`project_points_to_lines`
    takes them."""
    x, y = torch.broadcast_tensors(_as(x, line), _as(y, line))
    pts = torch.stack([x, y], dim=-1)
    n = line.shape[-2]
    if line.ndim == 2:
        proj = project_point_to_polyline(pts, line)

        def take(i):
            return line[i]

        def tangent(i):
            return tangents[i]
    else:
        proj = project_points_to_lines(pts, line)

        def take(i):
            return gather_rows(line, i)

        def tangent(i):
            return gather_rows(tangents[..., None], i)[..., 0]
    ci = proj.closest_idx
    nxt = torch.clamp(ci + 1, 0, n - 1)
    prv = torch.clamp(ci - 1, 0, n - 1)
    p_ci, p_nxt, p_prv = take(ci), take(nxt), take(prv)
    psi_next = torch.atan2(p_nxt[..., 1] - p_ci[..., 1],
                           p_nxt[..., 0] - p_ci[..., 0])
    psi_prev = torch.atan2(p_ci[..., 1] - p_prv[..., 1],
                           p_ci[..., 0] - p_prv[..., 0])
    psi_vert = psi_next if tangents is None else tangent(ci)
    psi_line = torch.where(proj.closest_type == 1, psi_next,
                           torch.where(proj.closest_type == -1, psi_prev,
                                       psi_vert))
    c, s = torch.cos(psi_line), torch.sin(psi_line)
    vx, vy, yaw = _as(vx, line), _as(vy, line), _as(yaw, line)
    vs = vx * c + vy * s
    vd = -vx * s + vy * c
    return FrenetState(s=proj.dist_start, d=proj.distance,
                       psi=wrap_angle(yaw - psi_line), vs=vs, vd=vd)


def transfer_to_ego_frame(x, y, vx, vy, yaw, ego_x, ego_y, ego_yaw):
    """Rigid transform of (position, velocity, yaw) into the ego frame
    (Planning_library/coordinates.py:5-33), elementwise over any
    broadcastable leading dims."""
    c, s = torch.cos(-ego_yaw), torch.sin(-ego_yaw)
    dx, dy = x - ego_x, y - ego_y
    x_t = c * dx - s * dy
    y_t = s * dx + c * dy
    vx_t = c * vx - s * vy
    vy_t = s * vx + c * vy
    return x_t, y_t, vx_t, vy_t, yaw - ego_yaw


def box_to_corners_2d(cx, cy, yaw, length, width) -> torch.Tensor:
    """Oriented-box corners (geometry.pyx:204-226), batched: [..., 4, 2]
    in CCW order starting front-left."""
    cx, cy, yaw = (torch.as_tensor(a) for a in (cx, cy, yaw))
    hl, hw = torch.broadcast_tensors(
        torch.as_tensor(length, dtype=cx.dtype, device=cx.device) / 2.0,
        torch.as_tensor(width, dtype=cx.dtype, device=cx.device) / 2.0)
    local = torch.tensor([[1, 1], [-1, 1], [-1, -1], [1, -1]],
                         dtype=cx.dtype, device=cx.device)
    local = local * torch.stack([hl, hw], dim=-1)[..., None, :]
    c, s = torch.cos(yaw), torch.sin(yaw)
    rx = local[..., 0] * c[..., None] - local[..., 1] * s[..., None] \
        + cx[..., None]
    ry = local[..., 0] * s[..., None] + local[..., 1] * c[..., None] \
        + cy[..., None]
    return torch.stack([rx, ry], dim=-1)


def curvature(x: torch.Tensor, y: torch.Tensor) -> torch.Tensor:
    """Discrete curvature along paths [..., M] from heading differences
    (JunctionTrajectoryPlanner.py:366-377: dyaw/ds, the last value
    repeated twice)."""
    dx = torch.diff(x, dim=-1)
    dy = torch.diff(y, dim=-1)
    yaw = torch.atan2(dy, dx)
    ds = torch.sqrt(dx ** 2 + dy ** 2)
    ds = torch.where(ds < 1e-5, 0.1, ds)
    c = torch.diff(yaw, dim=-1) / ds[..., :-1]
    return torch.cat([c, c[..., -1:], c[..., -1:]], dim=-1)


# ---------------------------------------------------------------------------
# Host-side oracle (numpy, a direct transliteration of the published
# algorithm) for testing the vectorized version.
# ---------------------------------------------------------------------------


def project_point_to_polyline_np(x0: float, y0: float, line: np.ndarray
                                 ) -> Tuple[float, int, int, float, float]:
    """Reference-semantics host implementation (scalar, branchy) of the
    signed polyline distance; the test oracle of the vectorized one."""
    line = np.asarray(line, dtype=np.float64)

    def seg(x1, y1, x2, y2):
        l = math.hypot(x2 - x1, y2 - y1)
        if l == 0:
            return math.hypot(x0 - x1, y0 - y1), 0.0, 0.0
        dl = ((y2 - y1) * x0 - (x2 - x1) * y0 + x2 * y1 - x1 * y2) / l
        d1 = (x1 * x1 + x0 * (x2 - x1) - x1 * x2 + y1 * y1 + y0 * (y2 - y1) - y1 * y2) / l
        d2 = (x2 * x2 - x0 * (x2 - x1) - x1 * x2 + y2 * y2 - y0 * (y2 - y1) - y1 * y2) / l
        return dl, d1, d2

    dist_line = np.linalg.norm(line - [x0, y0], axis=1)
    ci = int(np.argmin(dist_line))
    n = len(line)
    ctype = 0
    dl_p = d1_p = d2_p = dl_n = d1_n = d2_n = 0.0
    if ci == 0:
        dl_n, d1_n, d2_n = seg(*line[0], *line[1])
        if d1_n < 0:
            dist = dist_line[ci] if dl_n >= 0 else -dist_line[ci]
        else:
            dist, ctype = dl_n, 1
    elif ci == n - 1:
        dl_p, d1_p, d2_p = seg(*line[n - 2], *line[n - 1])
        if d2_p < 0:
            dist = dist_line[ci] if dl_p >= 0 else -dist_line[ci]
        else:
            dist, ctype = dl_p, -1
    else:
        dl_p, d1_p, d2_p = seg(*line[ci - 1], *line[ci])
        dl_n, d1_n, d2_n = seg(*line[ci], *line[ci + 1])
        if d2_p < 0 and d1_n < 0:
            dist = dist_line[ci]
            # sign from the turn direction of the corner
            x2, y2 = line[ci + 1]
            xa, ya = line[ci - 1]
            xb, yb = line[ci]
            l = math.hypot(xb - xa, yb - ya)
            dl_corner = ((yb - ya) * x2 - (xb - xa) * y2 + xb * ya - xa * yb) / l if l else 0.0
            if dl_corner > 0:
                dist = -dist
        elif d2_p < 0:
            dist, ctype = dl_n, 1
        elif d1_n < 0:
            dist, ctype = dl_p, -1
        else:
            if abs(dl_n) > abs(dl_p):
                dist, ctype = dl_p, -1
            else:
                dist, ctype = dl_n, 1

    seg_len = np.linalg.norm(np.diff(line, axis=0), axis=1)
    cum = np.concatenate([[0], np.cumsum(seg_len)])
    total = cum[-1]
    if ctype == 1:
        dist_start = d1_n + cum[ci]
        dist_end = d2_n + total - cum[ci + 1]
    elif ctype == -1:
        dist_start = d1_p + cum[ci - 1]
        dist_end = d2_p + total - cum[ci]
    else:
        dist_start = cum[ci]
        dist_end = total - cum[ci]
    return float(dist), ci, ctype, float(dist_start), float(dist_end)
