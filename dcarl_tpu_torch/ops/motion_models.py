"""Batched motion models for tracking and prediction (the JAX package's
``ops/motion_models.py``; the reference's zzz_common.dynamic_models,
dynamic_models.py:11-104):

- ``motion_br``    Brownian (identity mean)
- ``motion_cv``    constant velocity                  [x, y, vx, vy]
- ``motion_ca``    constant acceleration              [x, y, vx, vy, ax, ay]
- ``motion_ctrv``  constant turn-rate and velocity    [x, y, th, v, w]
- ``motion_ctra``  constant turn-rate and accel.      [x, y, th, v, a, w]
- ``motion_csaa``  constant steering angle and accel. [x, y, th, v, a, c]
                   (a clothoid step through Fresnel integrals)

Every model takes ``state`` [..., D] and a scalar ``dt`` and returns a
new tensor; the near-zero turn-rate branch is a masked ``where`` with a
poisoned denominator.  ``fresnel`` is a power series below |x| = 3.2 and
an asymptotic expansion above, both evaluated in float64 on clipped
inputs, so neither branch can carry a NaN into the other's range.
"""

from __future__ import annotations

import math

import torch

from dcarl_tpu_torch.ops.geometry import wrap_angle

__all__ = [
    "fresnel", "motion_br", "motion_cv", "motion_ca", "motion_ctrv",
    "motion_ctra", "motion_csaa",
]

_SERIES_TERMS = 36
_ASYMPTOTIC_TERMS = 8
_CROSSOVER = 3.2  # |x| below: power series; above: asymptotic


def _fresnel_series(x: torch.Tensor):
    """Power series (A&S 7.3.11/12), accurate to f64 roundoff for
    |x| <= ~3.5 (the alternating terms peak near 1e6)."""
    u = 0.5 * math.pi * x * x
    u2 = u * u
    s = torch.zeros_like(x)
    c = torch.zeros_like(x)
    a = torch.ones_like(x)   # (-1)^n u^{2n} / (2n)!    ; C = x sum a_n/(4n+1)
    b = u                    # (-1)^n u^{2n+1}/(2n+1)!  ; S = x sum b_n/(4n+3)
    for n in range(_SERIES_TERMS):
        c = c + a / (4.0 * n + 1.0)
        s = s + b / (4.0 * n + 3.0)
        a = -a * u2 / ((2.0 * n + 1.0) * (2.0 * n + 2.0))
        b = -b * u2 / ((2.0 * n + 2.0) * (2.0 * n + 3.0))
    return x * s, x * c


def _fresnel_asymptotic(x: torch.Tensor):
    """Large-|x| expansion (A&S 7.3.27/28):
    C = 1/2 + f sin(u) - g cos(u), S = 1/2 - f cos(u) - g sin(u)."""
    u = 0.5 * math.pi * x * x
    z = torch.clamp(math.pi * x * x, min=1e-30)
    inv_z2 = 1.0 / (z * z)
    f = torch.zeros_like(x)
    g = torch.zeros_like(x)
    tf = torch.ones_like(x)   # (4m-1)!!/z^{2m}
    tg = 1.0 / z              # (4m+1)!!/z^{2m+1}
    sign = 1.0
    for m in range(_ASYMPTOTIC_TERMS):
        f = f + sign * tf
        g = g + sign * tg
        tf = tf * (4.0 * m + 1.0) * (4.0 * m + 3.0) * inv_z2
        tg = tg * (4.0 * m + 3.0) * (4.0 * m + 5.0) * inv_z2
        sign = -sign
    pix = math.pi * torch.clamp(torch.abs(x), min=1e-30)
    f = f / pix
    g = g / pix
    su, cu = torch.sin(u), torch.cos(u)
    return 0.5 - f * cu - g * su, 0.5 + f * su - g * cu


def fresnel(x):
    """Fresnel integrals ``(S(x), C(x))``, scipy's convention
    S(x) = int_0^x sin(pi t^2 / 2) dt, C(x) = int_0^x cos(pi t^2 / 2) dt.
    Elementwise, odd in x; computed in float64 and returned in x's
    floating dtype."""
    x = torch.as_tensor(x)
    out_dtype = x.dtype if x.is_floating_point() else torch.get_default_dtype()
    x64 = x.to(torch.float64)
    ax = torch.abs(x64)
    s_ser, c_ser = _fresnel_series(torch.clamp(ax, max=_CROSSOVER))
    s_asy, c_asy = _fresnel_asymptotic(torch.clamp(ax, min=_CROSSOVER))
    big = ax > _CROSSOVER
    sgn = torch.sign(x64)
    s = sgn * torch.where(big, s_asy, s_ser)
    c = sgn * torch.where(big, c_asy, c_ser)
    return s.to(out_dtype), c.to(out_dtype)


def _with(state: torch.Tensor, cols: dict) -> torch.Tensor:
    """A copy of ``state`` with columns replaced."""
    out = state.clone()
    for i, v in cols.items():
        out[..., i] = v
    return out


def motion_br(state, dt):
    """Brownian motion: the mean is unchanged (dynamic_models.py:11-21)."""
    del dt
    return torch.as_tensor(state)


def motion_cv(state, dt):
    """Constant velocity over [..., (x, y, vx, vy, ...)]
    (dynamic_models.py:24-38)."""
    state = torch.as_tensor(state)
    return _with(state, {0: state[..., 0] + state[..., 2] * dt,
                         1: state[..., 1] + state[..., 3] * dt})


def motion_ca(state, dt):
    """Constant acceleration over [..., (x, y, vx, vy, ax, ay)]; a stub
    in the reference (dynamic_models.py:40)."""
    state = torch.as_tensor(state)
    ax_, ay_ = state[..., 4], state[..., 5]
    return _with(state, {
        0: state[..., 0] + (state[..., 2] * dt + 0.5 * ax_ * dt * dt),
        1: state[..., 1] + (state[..., 3] * dt + 0.5 * ay_ * dt * dt),
        2: state[..., 2] + ax_ * dt,
        3: state[..., 3] + ay_ * dt})


def motion_ctrv(state, dt):
    """Constant turn-rate and velocity over [..., (x, y, th, v, w)]; a
    stub in the reference (dynamic_models.py:43).  The straight-line
    limit is the masked w -> 0 branch."""
    state = torch.as_tensor(state)
    x, y, th, v, w = (state[..., i] for i in range(5))
    nth = wrap_angle(th + w * dt)
    straight = torch.abs(w) < 1e-8
    w_safe = torch.where(straight, 1.0, w)
    nx = torch.where(straight, x + v * torch.cos(th) * dt,
                     x + v / w_safe * (torch.sin(nth) - torch.sin(th)))
    ny = torch.where(straight, y + v * torch.sin(th) * dt,
                     y - v / w_safe * (torch.cos(nth) - torch.cos(th)))
    return _with(state, {0: nx, 1: ny, 2: nth})


def motion_ctra(state, dt):
    """Constant turn-rate and acceleration over [..., (x, y, th, v, a, w)]
    (dynamic_models.py:46-71); the reference's ``np.isclose(w, 0)``
    branch is a masked ``where`` with a poisoned denominator."""
    state = torch.as_tensor(state)
    x, y, th, v, a, w = (state[..., i] for i in range(6))
    nth = wrap_angle(th + w * dt)
    nv = v + a * dt
    straight = torch.abs(w) < 1e-8
    w_safe = torch.where(straight, 1.0, w)
    ww = w_safe * w_safe
    sin_nth, cos_nth = torch.sin(nth), torch.cos(nth)
    sin_th, cos_th = torch.sin(th), torch.cos(th)
    nx_turn = x + (nv * w_safe * sin_nth + a * cos_nth
                   - v * w_safe * sin_th - a * cos_th) / ww
    ny_turn = y + (-nv * w_safe * cos_nth + a * sin_nth
                   + v * w_safe * cos_th - a * sin_th) / ww
    nx_str = x + 0.5 * (nv + v) * cos_th * dt
    ny_str = y + 0.5 * (nv + v) * sin_th * dt
    return _with(state, {0: torch.where(straight, nx_str, nx_turn),
                         1: torch.where(straight, ny_str, ny_turn),
                         2: nth, 3: nv})


def motion_csaa(state, dt):
    """Constant steering angle and acceleration (a clothoid) over
    [..., (x, y, th, v, a, c)] (dynamic_models.py:73-104), with the
    reference's literal operator precedence (the trailing
    ``/ 4*sqrt(a*c)*c`` multiplies by sqrt(a*c)*c)."""
    state = torch.as_tensor(state)
    x, y, th, v, a, c = (state[..., i] for i in range(6))
    gamma1 = (c * v * v) / (4.0 * a) + th
    gamma2 = c * dt * v + c * dt * dt * a - th
    eta = math.sqrt(2.0 * math.pi) * v * c
    root = torch.sqrt(c / 2.0 * a * math.pi)
    sz1, cz1 = fresnel((2.0 * a * dt + v) * root)
    sz2, cz2 = fresnel(v * root)
    sac = torch.sqrt(a * c)
    cg1, sg1 = torch.cos(gamma1), torch.sin(gamma1)
    nx = x + (eta * (cg1 * cz1 + sg1 * sz1 - cg1 * cz2 - sg1 * sz2)
              + 2.0 * torch.sin(gamma2) * sac
              + 2.0 * torch.sin(th) * sac) / 4.0 * sac * c
    ny = y + (eta * (-cg1 * sz1 + sg1 * cz1 - sg1 * cz2 - cg1 * sz2)
              + 2.0 * torch.cos(gamma2) * sac
              - 2.0 * torch.sin(th) * sac) / 4.0 * sac * c
    nth = wrap_angle(th - c * dt * dt * a / 2.0 - c * dt * v)
    nv = v + a * dt
    return _with(state, {0: nx, 1: ny, 2: nth, 3: nv})
