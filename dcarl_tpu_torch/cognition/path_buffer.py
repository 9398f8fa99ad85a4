"""PathBuffer: a rolling dense reference-path window around the ego,
batch-first (the JAX package's ``cognition/path_buffer.py``).

The reference's deque of waypoints (zzz_cognition_object_locator/
path_buffer.py: dequeue passed points, enqueue from the route, flag
rerouting / junction fallback when the remaining route is short) is a
cursor into a fixed route array: a window gather and per-env cursor
state.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import torch

from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.ops.geometry import gather_rows, project_points_to_lines


class PathBufferState(NamedTuple):
    cursor: torch.Tensor     # [...] i32: route index of the window start
    rerouting: torch.Tensor  # [...] bool: route nearly exhausted & stopped


def path_buffer_init(batch_shape: Tuple[int, ...] = (), device=None
                     ) -> PathBufferState:
    """Cursors at the route start, on ``device`` (``cuda`` unless the
    caller passes ``device="cpu"``)."""
    device = resolve_device(device)
    return PathBufferState(
        cursor=torch.zeros(batch_shape, dtype=torch.int32, device=device),
        rerouting=torch.zeros(batch_shape, dtype=torch.bool, device=device))


def path_buffer_update(state: PathBufferState,
                       route: torch.Tensor,  # [..., N, 2] dense path
                       ego_x, ego_y, ego_speed,
                       window: int = 150,    # buffer_size (path_buffer.py:19)
                       remained_passed_points: int = 5,
                       required_reference_path_length: int = 15,
                       prepare_stop_path_length: int = 30,
                       ) -> Tuple[PathBufferState, torch.Tensor, torch.Tensor,
                                  torch.Tensor]:
    """One update tick (path_buffer.py:82-155): (state', segment [...,
    window, 2], valid [..., window], junction_flag [...]).  The window
    keeps ``remained_passed_points`` behind the nearest waypoint and never
    moves back; ``junction_flag`` is the fallback to the junction model
    when fewer than ``prepare_stop_path_length`` points remain;
    ``rerouting`` latches when the route is nearly exhausted while
    (almost) stopped."""
    n = route.shape[-2]
    ex, ey = torch.broadcast_tensors(torch.as_tensor(ego_x),
                                     torch.as_tensor(ego_y))
    p = torch.stack([ex, ey], dim=-1).to(route.dtype)
    nearest = project_points_to_lines(p, route).closest_idx
    # never move backwards; keep a few passed points
    cursor = torch.clamp(torch.maximum(state.cursor.to(nearest.dtype),
                                       nearest - remained_passed_points),
                         0, n - 1)
    idx = cursor[..., None] + torch.arange(window, device=route.device)
    valid = idx < n
    seg = gather_rows(route[..., None, :, :], torch.clamp(idx, max=n - 1))
    # pad the tail with the last route point
    seg = torch.where(valid[..., None], seg, route[..., None, n - 1, :])
    remaining = n - cursor
    junction_flag = remaining < prepare_stop_path_length
    rerouting = (remaining < required_reference_path_length) \
        & (torch.as_tensor(ego_speed) < 1.0 / 3.6)
    return (PathBufferState(cursor=cursor.to(torch.int32),
                            rerouting=rerouting), seg, valid, junction_flag)
