"""Natural cubic splines and the arc-length parameterized reference path
(the reference's cubic_spline_planner Spline / Spline2D).

Fitting is host-side set-up, done once per driver: the tridiagonal
system is solved by a Thomas sweep written as a Python loop over 0-d
tensors, in the caller's dtype, so every step rounds as the JAX scan
does.  Evaluation takes query arc lengths of any shape: one
``searchsorted`` into the shared 1-D knot vector, then a gather of the
segment's coefficients.  Outside the knot range it clamps to the end
segments (the reference returns None there).
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch


class CubicSpline1D(NamedTuple):
    """y = a_i + b_i dx + c_i dx^2 + d_i dx^3 on [x_i, x_{i+1}]."""

    x: torch.Tensor  # [N] knots
    a: torch.Tensor  # [N]   (y values)
    b: torch.Tensor  # [N-1]
    c: torch.Tensor  # [N]
    d: torch.Tensor  # [N-1]


def fit_natural_cubic(x: torch.Tensor, y: torch.Tensor) -> CubicSpline1D:
    """Natural cubic spline fit (c'' = 0 at both ends), the tridiagonal
    system of cubic_spline_planner.py:104-135."""
    n = x.shape[0]
    h = torch.diff(x)
    one = torch.ones((1,), dtype=x.dtype)
    zero = torch.zeros((1,), dtype=x.dtype)
    main = torch.cat([one, 2.0 * (h[:-1] + h[1:]), one])
    lower = torch.cat([zero, h[:-1], zero])   # A[i, i-1]
    upper = torch.cat([zero, h[1:], zero])    # A[i, i+1]
    rhs = torch.cat([
        zero,
        3.0 * (y[2:] - y[1:-1]) / h[1:] - 3.0 * (y[1:-1] - y[:-2]) / h[:-1],
        zero,
    ])

    # Thomas algorithm: forward elimination, then back substitution
    cp_prev = torch.zeros((), dtype=x.dtype)
    dp_prev = torch.zeros((), dtype=x.dtype)
    cps, dps = [], []
    for i in range(n):
        denom = main[i] - lower[i] * cp_prev
        cp_prev = upper[i] / denom
        dp_prev = (rhs[i] - lower[i] * dp_prev) / denom
        cps.append(cp_prev)
        dps.append(dp_prev)
    c_next = torch.zeros((), dtype=x.dtype)
    cs = [None] * n
    for i in reversed(range(n)):
        c_next = dps[i] - cps[i] * c_next
        cs[i] = c_next
    c = torch.stack(cs)

    b = (y[1:] - y[:-1]) / h - h * (c[1:] + 2.0 * c[:-1]) / 3.0
    d = (c[1:] - c[:-1]) / (3.0 * h)
    return CubicSpline1D(x=x, a=y, b=b, c=c, d=d)


class RefPath(NamedTuple):
    """Arc-length parameterized 2-D path (Spline2D)."""

    s: torch.Tensor  # [N] chordal arc lengths
    sx: CubicSpline1D
    sy: CubicSpline1D


def _cumsum_blocked(v: torch.Tensor, block: int = 16) -> torch.Tensor:
    """Prefix sum over the last axis in the association order of the JAX
    reference on the CPU, where XLA lowers ``cumsum`` as a two-level
    scan: a sequential prefix inside each 16-element block, plus the
    running total of the earlier blocks.  The chordal knots, and every
    spline coefficient fitted on them, then round exactly as the
    reference's do.  Leading axes are independent sums."""
    # elementwise adds round in v's dtype at every step (torch.cumsum on
    # the CPU would accumulate a float32 input in double)
    n = v.shape[-1]
    nb = -(-n // block)
    vb = torch.nn.functional.pad(v, (0, nb * block - n)).reshape(
        *v.shape[:-1], nb, block)
    acc = [torch.zeros_like(vb[..., 0]) + vb[..., 0]]
    for j in range(1, block):
        acc.append(acc[-1] + vb[..., j])
    acc = torch.stack(acc, -1)                          # [..., nb, block]
    carry = [torch.zeros_like(acc[..., 0, 0])]
    for b in range(nb - 1):
        carry.append(carry[-1] + acc[..., b, -1])
    carry = torch.stack(carry, -1)                      # [..., nb]
    return (carry[..., None] + acc).reshape(*v.shape[:-1], nb * block)[..., :n]


def refpath_from_xy(x: torch.Tensor, y: torch.Tensor) -> RefPath:
    """Spline2D.__init__ (cubic_spline_planner.py:143-156)."""
    ds = torch.sqrt(torch.diff(x) ** 2 + torch.diff(y) ** 2)
    s = torch.cat([torch.zeros((1,), dtype=x.dtype), _cumsum_blocked(ds)])
    return RefPath(s=s, sx=fit_natural_cubic(s, x), sy=fit_natural_cubic(s, y))


def refpath_to(rp: RefPath, device: torch.device) -> RefPath:
    """A copy of a (host-fitted) path on ``device``."""
    return RefPath(s=rp.s.to(device),
                   sx=CubicSpline1D(*(a.to(device) for a in rp.sx)),
                   sy=CubicSpline1D(*(a.to(device) for a in rp.sy)))


def _segment_index(sp: CubicSpline1D, t: torch.Tensor) -> torch.Tensor:
    """Segment of each query: ``searchsorted(side="right") - 1``, clamped
    to [0, N-2]; the knot vector is one contiguous 1-D tensor."""
    i = torch.searchsorted(sp.x.contiguous(), t.contiguous(), right=True) - 1
    return torch.clamp(i, 0, sp.x.shape[0] - 2)


def spline_eval(sp: CubicSpline1D, t: torch.Tensor) -> torch.Tensor:
    i = _segment_index(sp, t)
    dx = t - sp.x[i]
    return sp.a[i] + sp.b[i] * dx + sp.c[i] * dx ** 2 + sp.d[i] * dx ** 3


def spline_d1(sp: CubicSpline1D, t: torch.Tensor) -> torch.Tensor:
    i = _segment_index(sp, t)
    dx = t - sp.x[i]
    return sp.b[i] + 2.0 * sp.c[i] * dx + 3.0 * sp.d[i] * dx ** 2


def spline_d2(sp: CubicSpline1D, t: torch.Tensor) -> torch.Tensor:
    i = _segment_index(sp, t)
    dx = t - sp.x[i]
    return 2.0 * sp.c[i] + 6.0 * sp.d[i] * dx


def refpath_position(rp: RefPath, s: torch.Tensor
                     ) -> Tuple[torch.Tensor, torch.Tensor]:
    return spline_eval(rp.sx, s), spline_eval(rp.sy, s)


def refpath_pos_tangent(rp: RefPath, s: torch.Tensor):
    """(x, y, dx/ds, dy/ds) with one shared segment search: the x and y
    splines share their knot vector, so the planner's lattice evaluates
    position and tangent from one ``searchsorted``."""
    sx, sy = rp.sx, rp.sy
    i = _segment_index(sx, s)
    dt = s - sx.x[i]
    x = sx.a[i] + (sx.b[i] + (sx.c[i] + sx.d[i] * dt) * dt) * dt
    y = sy.a[i] + (sy.b[i] + (sy.c[i] + sy.d[i] * dt) * dt) * dt
    dx = sx.b[i] + (2.0 * sx.c[i] + 3.0 * sx.d[i] * dt) * dt
    dy = sy.b[i] + (2.0 * sy.c[i] + 3.0 * sy.d[i] * dt) * dt
    return x, y, dx, dy


def refpath_yaw(rp: RefPath, s: torch.Tensor) -> torch.Tensor:
    return torch.atan2(spline_d1(rp.sy, s), spline_d1(rp.sx, s))


def refpath_curvature(rp: RefPath, s: torch.Tensor) -> torch.Tensor:
    dx, dy = spline_d1(rp.sx, s), spline_d1(rp.sy, s)
    ddx, ddy = spline_d2(rp.sx, s), spline_d2(rp.sy, s)
    return (ddy * dx - ddx * dy) / (dx ** 2 + dy ** 2)
