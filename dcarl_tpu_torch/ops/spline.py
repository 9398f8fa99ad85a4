"""Natural cubic splines and the arc-length parameterized reference path
(the reference's cubic_spline_planner Spline / Spline2D).

Fitting is host-side set-up, done once per driver: the tridiagonal
system is solved by a Thomas sweep written as a Python loop over 0-d
tensors, in the caller's dtype, so every step rounds as the JAX scan
does.
"""

from __future__ import annotations

from typing import NamedTuple

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
    """Prefix sum in the association order of the JAX reference on the
    CPU, where XLA lowers ``cumsum`` as a two-level scan: a sequential
    prefix inside each 16-element block, plus the running total of the
    earlier blocks.  The chordal knots, and every spline coefficient
    fitted on them, then round exactly as the reference's do."""
    # 0-d tensor adds round in v's dtype at every step (torch.cumsum on
    # the CPU would accumulate a float32 input in double)
    out, carry = [], torch.zeros((), dtype=v.dtype)
    for start in range(0, v.shape[0], block):
        acc = torch.zeros((), dtype=v.dtype)
        for x in v[start:start + block]:
            acc = acc + x
            out.append(carry + acc)
        carry = carry + acc
    return torch.stack(out)


def refpath_from_xy(x: torch.Tensor, y: torch.Tensor) -> RefPath:
    """Spline2D.__init__ (cubic_spline_planner.py:143-156)."""
    ds = torch.sqrt(torch.diff(x) ** 2 + torch.diff(y) ** 2)
    s = torch.cat([torch.zeros((1,), dtype=x.dtype), _cumsum_blocked(ds)])
    return RefPath(s=s, sx=fit_natural_cubic(s, x), sy=fit_natural_cubic(s, y))
