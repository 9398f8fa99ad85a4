"""Scene/trajectory visualization — marker generation + rendering.

Host-side re-design of the reference's visualization layer:

- ``detected_objects_visualizer`` (C++, SW/tools/.../
  visualize_detected_objects.cpp: label/arrow/box/hull/centroid
  MarkerArrays with per-class colors and lifetimes),
- the rviz ``box_visualizer`` nodes and the planners' candidate-
  trajectory markers (nodes/idm_lane_utility ``pub_rviz``),
- CARLA debug draws (TestScenario_Town03.py:428-466).

There is no rviz in the stack, so the product is (a) a structured,
JSON-serializable marker list — the same decoupling rviz markers give:
any front end can render it — and (b) a matplotlib renderer for quick
figures/regression artifacts.  Everything is pure host-side numpy on
already-materialised arrays; nothing here touches the device hot path.
"""

from __future__ import annotations

import json
from typing import Dict, List, Optional, Sequence

import numpy as np

# per-class colors, the visualizer's classification palette
CLASS_COLORS = {
    "unknown": (0.6, 0.6, 0.6),
    "car": (0.1, 0.5, 0.9),
    "truck": (0.2, 0.3, 0.7),
    "pedestrian": (0.9, 0.4, 0.1),
    "cyclist": (0.2, 0.8, 0.3),
    "ego": (0.9, 0.1, 0.1),
}


def _corners(cx, cy, yaw, length, width) -> np.ndarray:
    c, s = np.cos(yaw), np.sin(yaw)
    dx, dy = length / 2.0, width / 2.0
    local = np.array([[dx, dy], [dx, -dy], [-dx, -dy], [-dx, dy]])
    rot = np.array([[c, -s], [s, c]])
    return local @ rot.T + np.array([cx, cy])


def object_markers(objects: Sequence[Dict], lifetime: float = 0.2
                   ) -> List[Dict]:
    """Build label/arrow/box/centroid markers for detected objects.

    Each object dict: ``{x, y, yaw, vx, vy, length, width, cls, uid}``
    (missing fields default sensibly).  Mirrors the marker taxonomy of
    visualize_detected_objects.cpp (ObjectLabels/Arrows/Boxes/Centroids).
    """
    markers: List[Dict] = []
    for i, ob in enumerate(objects):
        x, y = float(ob.get("x", 0.0)), float(ob.get("y", 0.0))
        yaw = float(ob.get("yaw", 0.0))
        vx, vy = float(ob.get("vx", 0.0)), float(ob.get("vy", 0.0))
        cls = str(ob.get("cls", "unknown"))
        uid = ob.get("uid", i)
        color = CLASS_COLORS.get(cls, CLASS_COLORS["unknown"])
        speed = float(np.hypot(vx, vy))
        corners = _corners(x, y, yaw,
                           float(ob.get("length", 4.0)),
                           float(ob.get("width", 2.0)))
        markers.append({"type": "box", "uid": uid, "cls": cls,
                        "points": corners.tolist(), "color": color,
                        "lifetime": lifetime})
        markers.append({"type": "centroid", "uid": uid,
                        "point": [x, y], "color": color,
                        "lifetime": lifetime})
        markers.append({"type": "label", "uid": uid,
                        "point": [x, y],
                        "text": f"{cls}:{uid} {speed:.1f} m/s",
                        "color": color, "lifetime": lifetime})
        if speed > 0.05:
            head = [x + vx / max(speed, 1e-6) * 2.0,
                    y + vy / max(speed, 1e-6) * 2.0]
            markers.append({"type": "arrow", "uid": uid,
                            "points": [[x, y], head], "color": color,
                            "lifetime": lifetime})
    return markers


def trajectory_markers(paths: np.ndarray, costs: Optional[np.ndarray] = None,
                       chosen: Optional[int] = None) -> List[Dict]:
    """Candidate-lattice markers (``pub_rviz`` role): one polyline per
    candidate, cost-shaded, the chosen one highlighted.

    ``paths``: [n_paths, n_pts, 2] global xy.
    """
    paths = np.asarray(paths)
    markers: List[Dict] = []
    if costs is not None:
        costs = np.asarray(costs, dtype=float)
        lo, hi = float(np.min(costs)), float(np.max(costs))
        span = (hi - lo) or 1.0
    for i, path in enumerate(paths):
        if costs is not None:
            t = (float(costs[i]) - lo) / span
            color = (0.2 + 0.7 * t, 0.8 - 0.6 * t, 0.2)  # green→red by cost
        else:
            color = (0.4, 0.7, 0.4)
        markers.append({"type": "polyline", "uid": i,
                        "points": np.asarray(path).tolist(),
                        "color": color, "width": 1.0})
    if chosen is not None and 0 <= int(chosen) < len(paths):
        markers.append({"type": "polyline", "uid": f"chosen:{int(chosen)}",
                        "points": np.asarray(paths[int(chosen)]).tolist(),
                        "color": (0.1, 0.3, 1.0), "width": 3.0})
    return markers


def lane_markers(lanes: Sequence[np.ndarray]) -> List[Dict]:
    return [{"type": "polyline", "uid": f"lane:{i}",
             "points": np.asarray(l).tolist(),
             "color": (0.5, 0.5, 0.5), "width": 0.5}
            for i, l in enumerate(lanes)]


def save_markers(path: str, markers: Sequence[Dict]) -> None:
    with open(path, "w") as f:
        json.dump(list(markers), f)


def load_markers(path: str) -> List[Dict]:
    with open(path) as f:
        return json.load(f)


def render(markers: Sequence[Dict], out_path: Optional[str] = None,
           ax=None, title: str = ""):
    """Draw a marker list with matplotlib (the rviz stand-in)."""
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    own_fig = ax is None
    if own_fig:
        fig, ax = plt.subplots(figsize=(8, 8))
    for m in markers:
        color = tuple(m.get("color", (0.3, 0.3, 0.3)))
        t = m["type"]
        if t in ("box", "polyline"):
            pts = np.asarray(m["points"])
            if t == "box":
                pts = np.vstack([pts, pts[:1]])
            ax.plot(pts[:, 0], pts[:, 1], color=color,
                    lw=m.get("width", 1.0))
        elif t == "arrow":
            (x0, y0), (x1, y1) = m["points"]
            ax.annotate("", xy=(x1, y1), xytext=(x0, y0),
                        arrowprops=dict(arrowstyle="->", color=color))
        elif t == "centroid":
            ax.plot(*m["point"], "o", color=color, ms=3)
        elif t == "label":
            ax.annotate(m["text"], m["point"], fontsize=6, color=color)
    ax.set_aspect("equal", adjustable="datalim")
    if title:
        ax.set_title(title)
    if own_fig:
        if out_path:
            fig.tight_layout()
            fig.savefig(out_path, dpi=110)
            plt.close(fig)
            return out_path
        return fig
    return ax
