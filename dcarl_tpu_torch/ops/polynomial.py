"""Closed-form quintic/quartic boundary-value polynomials, batched.

The reference solves a small linear system per lattice sample
(JunctionTrajectoryPlanner.py:397-491); here the closed-form inverses
solve a whole lattice elementwise, and derivatives evaluate with Horner
products on the shared time grid.  Works on tensors and Python floats.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class QuinticCoeffs(NamedTuple):
    """x(t) = a0 + a1 t + a2 t^2 + a3 t^3 + a4 t^4 + a5 t^5."""

    a0: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor
    a3: torch.Tensor
    a4: torch.Tensor
    a5: torch.Tensor


def solve_quintic(xs, vxs, axs, xe, vxe, axe, T) -> QuinticCoeffs:
    """Position/velocity/acceleration boundary conditions at t=0 and
    t=T (quintic_polynomial.__init__), closed form."""
    a0 = xs
    a1 = vxs
    a2 = axs / 2.0
    T2, T3, T4, T5 = T * T, T ** 3, T ** 4, T ** 5
    b0 = xe - a0 - a1 * T - a2 * T2
    b1 = vxe - a1 - 2.0 * a2 * T
    b2 = axe - 2.0 * a2
    a3 = (10.0 * b0 - 4.0 * b1 * T + 0.5 * b2 * T2) / T3
    a4 = (-15.0 * b0 + 7.0 * b1 * T - b2 * T2) / T4
    a5 = (6.0 * b0 - 3.0 * b1 * T + 0.5 * b2 * T2) / T5
    return QuinticCoeffs(a0, a1, a2, a3, a4, a5)


def quintic_eval(c: QuinticCoeffs, t):
    return c.a0 + t * (c.a1 + t * (c.a2 + t * (c.a3 + t * (c.a4 + t * c.a5))))


def quintic_d1(c: QuinticCoeffs, t):
    return c.a1 + t * (2 * c.a2 + t * (3 * c.a3 + t * (4 * c.a4 + t * 5 * c.a5)))


def quintic_d2(c: QuinticCoeffs, t):
    return 2 * c.a2 + t * (6 * c.a3 + t * (12 * c.a4 + t * 20 * c.a5))


def quintic_d3(c: QuinticCoeffs, t):
    return 6 * c.a3 + t * (24 * c.a4 + t * 60 * c.a5)


class QuarticCoeffs(NamedTuple):
    """x(t) = a0 + a1 t + a2 t^2 + a3 t^3 + a4 t^4 (velocity keeping)."""

    a0: torch.Tensor
    a1: torch.Tensor
    a2: torch.Tensor
    a3: torch.Tensor
    a4: torch.Tensor


def solve_quartic(xs, vxs, axs, vxe, axe, T) -> QuarticCoeffs:
    """quartic_polynomial.__init__ closed form (terminal velocity and
    acceleration constrained, position free)."""
    a0 = xs
    a1 = vxs
    a2 = axs / 2.0
    b0 = vxe - a1 - 2.0 * a2 * T
    b1 = axe - 2.0 * a2
    T2 = T * T
    a3 = (b0 - b1 * T / 3.0) / T2
    a4 = (b1 * T / 2.0 - b0) / (2.0 * T2 * T)
    return QuarticCoeffs(a0, a1, a2, a3, a4)


def quartic_eval(c: QuarticCoeffs, t):
    return c.a0 + t * (c.a1 + t * (c.a2 + t * (c.a3 + t * c.a4)))


def quartic_d1(c: QuarticCoeffs, t):
    return c.a1 + t * (2 * c.a2 + t * (3 * c.a3 + t * 4 * c.a4))


def quartic_d2(c: QuarticCoeffs, t):
    return 2 * c.a2 + t * (6 * c.a3 + t * 12 * c.a4)


def quartic_d3(c: QuarticCoeffs, t):
    return 6 * c.a3 + t * 24 * c.a4
