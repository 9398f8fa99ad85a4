"""Host-side polyline geometry used to build the static scenario."""

from __future__ import annotations

import numpy as np


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
