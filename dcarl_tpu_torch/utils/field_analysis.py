"""Field-test log analysis — the MATLAB ``DrawData.m`` pipeline in Python.

The reference ships three field scenarios of rosbag-extracted text logs
(Field_testing/Scenario{1,2,3}/: ``control.txt``, ``automode.txt``,
``traffic.txt``, ``surrounding_obj.txt``, ``decision.txt`` — formats in
``Files list.txt``) analysed by ``DrawData.m``: time-window the
channels, unwrap the int16 steering CAN counter, integrate driven
distance, and plot target speed / steering / auto-mode plus the UTM
trajectory with lowess-smoothed confidence traces.

This module reproduces that analysis natively (numpy + matplotlib) so
field logs are first-class inputs of the framework's tooling —
``analyze_scenario`` gives the numbers, ``plot_scenario`` the figures.

Column conventions (from DrawData.m usage):
  control.txt          t, target_speed [m/s], steering_raw (wrapped int16)
  automode.txt         t, mode (2 = autonomous)
  traffic.txt          t, ..., ego_x (col 4), ego_y (col 5), ...
  surrounding_obj.txt  t, x, y, vx, vy
  decision.txt         t, value, action, x, y
"""

from __future__ import annotations

import os
from typing import Dict, Optional

import numpy as np

STEER_RANGE = 520.0      # DrawData.m:24-31 wraps raw counts into ±520°


def load_channel(scenario_dir: str, name: str) -> np.ndarray:
    """Load one whitespace-separated log (rows sorted by timestamp)."""
    return np.atleast_2d(np.loadtxt(os.path.join(scenario_dir,
                                                 name + ".txt")))


def unwrap_steering(raw: np.ndarray) -> np.ndarray:
    """Map wrapped uint16 CAN steering counts back into a physical
    angle.  DrawData.m:24-31 adds/subtracts 65536 until |angle| <= 520;
    since the true angle magnitude is far below 32768 a single modular
    reduction is exact."""
    return (np.asarray(raw, dtype=float) + 32768.0) % 65536.0 - 32768.0


def time_window(arr: np.ndarray, tmin: float, tmax: float) -> np.ndarray:
    """Rows with tmin <= t <= tmax (DrawData.m's repeated masking)."""
    t = arr[:, 0]
    return arr[(t >= tmin) & (t <= tmax)]


def path_length(xy: np.ndarray) -> float:
    """Driven distance by polyline integration (DrawData.m:50-59)."""
    if len(xy) < 2:
        return 0.0
    return float(np.sum(np.hypot(np.diff(xy[:, 0]), np.diff(xy[:, 1]))))


def lowess(y: np.ndarray, frac: float = 0.1) -> np.ndarray:
    """Local linear smoother with tricube weights — the role of
    MATLAB ``smoothdata(..., 'lowess')`` on the confidence traces
    (DrawData.m:97-106).  Vectorized over all windows at once."""
    y = np.asarray(y, dtype=float)
    n = len(y)
    if n < 3:
        return y.copy()
    half = max(1, int(frac * n) // 2)
    idx = np.arange(n)
    lo = np.clip(idx - half, 0, n - 1)
    hi = np.clip(idx + half, 0, n - 1)
    # gather fixed-width windows (edges clamp; weights kill duplicates)
    offs = np.arange(-half, half + 1)
    win = np.clip(idx[:, None] + offs[None, :], 0, n - 1)
    x = win.astype(float)
    yw = y[win]
    d = np.abs(x - idx[:, None])
    dmax = np.maximum(np.maximum(idx - lo, hi - idx), 1)[:, None]
    w = np.clip(1.0 - (d / dmax) ** 3, 0.0, None) ** 3
    # weighted linear fit per window, evaluated at the centre
    sw = w.sum(1)
    sx = (w * x).sum(1)
    sy = (w * yw).sum(1)
    sxx = (w * x * x).sum(1)
    sxy = (w * x * yw).sum(1)
    denom = sw * sxx - sx * sx
    denom = np.where(np.abs(denom) < 1e-12, 1.0, denom)
    slope = (sw * sxy - sx * sy) / denom
    intercept = (sy - slope * sx) / sw
    return intercept + slope * idx


def analyze_scenario(scenario_dir: str,
                     tmin: Optional[float] = None,
                     tmax: Optional[float] = None) -> Dict[str, object]:
    """Load every channel, window it, and compute the DrawData summary
    statistics.  Defaults the window to the surrounding-object channel's
    span like DrawData.m:11-12 (which picks rows 1200/2000 of
    ``surrounding_obj``)."""
    control = load_channel(scenario_dir, "control")
    automode = load_channel(scenario_dir, "automode")
    traffic = load_channel(scenario_dir, "traffic")
    surround = load_channel(scenario_dir, "surrounding_obj")
    try:
        decision = load_channel(scenario_dir, "decision")
    except OSError:
        decision = np.zeros((0, 5))

    if tmin is None:
        tmin = float(surround[0, 0])
    if tmax is None:
        tmax = float(surround[-1, 0])

    control_w = time_window(control, tmin, tmax)
    automode_w = time_window(automode, tmin, tmax)
    traffic_w = time_window(traffic, tmin, tmax)
    surround_w = time_window(surround, tmin, tmax)

    steering = unwrap_steering(control_w[:, 2]) if len(control_w) else \
        np.zeros((0,))
    ego_xy = traffic_w[:, 3:5]
    auto_frac = float(np.mean(automode_w[:, 1] == 2.0)) \
        if len(automode_w) else 0.0

    return {
        "tmin": tmin,
        "tmax": tmax,
        "duration_s": tmax - tmin,
        "distance_m": path_length(ego_xy),
        "auto_mode_fraction": auto_frac,
        "target_speed_mean": float(np.mean(control_w[:, 1]))
        if len(control_w) else 0.0,
        "target_speed_max": float(np.max(control_w[:, 1]))
        if len(control_w) else 0.0,
        "steering_abs_max": float(np.max(np.abs(steering)))
        if len(steering) else 0.0,
        "n_surrounding_detections": int(len(surround_w)),
        "n_decisions": int(len(time_window(decision, tmin, tmax)))
        if len(decision) else 0,
        "channels": {
            "control": control_w,
            "automode": automode_w,
            "traffic": traffic_w,
            "surrounding_obj": surround_w,
            "decision": decision,
        },
    }


def plot_scenario(scenario_dir: str, out_prefix: str,
                  tmin: Optional[float] = None,
                  tmax: Optional[float] = None) -> Dict[str, str]:
    """Recreate DrawData.m's two figures: (1) target speed [km/h] /
    steering angle / auto-mode vs time, (2) ego + surrounding UTM
    trajectory.  Returns the written file paths."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    a = analyze_scenario(scenario_dir, tmin, tmax)
    ch = a["channels"]
    t0 = a["tmin"]
    out = {}

    fig, axes = plt.subplots(3, 1, figsize=(8, 8), sharex=True)
    c = ch["control"]
    axes[0].plot(c[:, 0] - t0, c[:, 1] * 3.6)
    axes[0].set_ylabel("target speed (km/h)")
    axes[1].plot(c[:, 0] - t0, unwrap_steering(c[:, 2]))
    axes[1].set_ylabel("steering angle (deg)")
    m = ch["automode"]
    axes[2].plot(m[:, 0] - t0, m[:, 1] * 0.5, ".")
    axes[2].set_ylabel("auto mode")
    axes[2].set_xlabel("t (s)")
    axes[2].set_ylim(0, 1.5)
    fig.tight_layout()
    p = out_prefix + "_control.png"
    fig.savefig(p, dpi=110)
    plt.close(fig)
    out["control"] = p

    fig, ax = plt.subplots(figsize=(7, 7))
    s = ch["surrounding_obj"]
    tr = ch["traffic"]
    ax.plot(s[:, 1], s[:, 2], "o", ms=2, label="surrounding obj pose")
    ax.plot(tr[:, 3], tr[:, 4], "o", ms=2, label="ego pose")
    ax.set_xlabel("UTM x (m)")
    ax.set_ylabel("UTM y (m)")
    ax.legend()
    ax.set_aspect("equal", adjustable="datalim")
    fig.tight_layout()
    p = out_prefix + "_trajectory.png"
    fig.savefig(p, dpi=110)
    plt.close(fig)
    out["trajectory"] = p
    return out
