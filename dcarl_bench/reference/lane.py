"""Plain reference of the lane-level agent's observation: the 20-D state
of zhcao92/DCARL ``RLSDecision`` (``learning.py:91-151``) worked out from
the multilane world's raw state.

The state: 0, the ego's lane index, its speed and its lateral speed;
then, for lanes 0 and 1, the nearest vehicle ahead as (s relative to the
ego, its lane index, its speed, its lateral speed), and after those the
nearest vehicle behind likewise.  A lane with no vehicle ahead reads
(50, lane, 20, 0), with none behind (-50, lane, 0, 0).  A vehicle is in
lane k when its lane index lies within 0.5 of k; ahead means a relative
s above 0, behind at or below 0; of two equally near vehicles the one
listed first counts.  The world's traffic keeps its lane, so a vehicle's
lateral speed is 0.  Everything in float32, as the configuration states.
"""

from __future__ import annotations

import torch

LANES = 2                      # the state's layout carries two lanes
AHEAD = (50.0, 20.0)           # (s, speed) read where no vehicle is ahead
BEHIND = (-50.0, 0.0)          # the same behind


def _nearest(rel, in_lane, ahead: bool):
    """(found [E], relative s [E], index [E]) of the nearest vehicle of a
    lane ahead of or behind each ego, by a scan over the vehicles."""
    e, k = rel.shape
    found = torch.zeros(e, dtype=torch.bool, device=rel.device)
    best = torch.zeros(e, dtype=rel.dtype, device=rel.device)
    idx = torch.zeros(e, dtype=torch.int64, device=rel.device)
    for j in range(k):
        r = rel[:, j]
        side = in_lane[:, j] & ((r > 0) if ahead else (r <= 0))
        nearer = (r < best) if ahead else (r > best)
        take = side & (~found | nearer)
        best = torch.where(take, r, best)
        idx = torch.where(take, j, idx)
        found = found | side
    return found, best, idx


def observation(ego_s, ego_lane, ego_speed, ego_vd, veh_s, veh_lane,
                veh_speed, num_lanes: int = LANES) -> torch.Tensor:
    """[E, 20] states of E egos: ``ego_*`` [E], ``veh_*`` [E, K]."""
    f32 = torch.float32
    ego_s, ego_lane = ego_s.to(f32), ego_lane.to(f32)
    veh_s, veh_lane, veh_speed = (veh_s.to(f32), veh_lane.to(f32),
                                  veh_speed.to(f32))
    e = ego_s.shape[0]
    rel = veh_s - ego_s[:, None]
    rows = torch.arange(e, device=ego_s.device)
    zero = torch.zeros(e, dtype=f32, device=ego_s.device)
    cols = [zero, ego_lane, ego_speed.to(f32), ego_vd.to(f32)]
    for ahead, (s_none, v_none) in ((True, AHEAD), (False, BEHIND)):
        for lane in range(LANES):
            if lane < num_lanes:
                in_lane = (veh_lane - lane).abs() <= 0.5
            else:
                in_lane = torch.zeros_like(veh_lane, dtype=torch.bool)
            found, s, j = _nearest(rel, in_lane, ahead)
            cols += [torch.where(found, s, s_none),
                     torch.where(found, veh_lane[rows, j], float(lane)),
                     torch.where(found, veh_speed[rows, j], v_none),
                     zero]
    return torch.stack(cols, dim=1)
