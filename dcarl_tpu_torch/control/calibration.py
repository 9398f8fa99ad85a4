"""Throttle/brake calibration: the acceleration tables
(``dcarl_tpu/control/calibration.py``).

Re-design of the reference's CARLA calibration tool
(Simulation_testing/.../Planning_library/calibration.py:20-170), which
drives a real CARLA vehicle over a (velocity x throttle) and (velocity x
brake) grid one cell at a time and writes ``acc_table.txt`` /
``dec_table.txt``.  Here every (v0, command) cell is one lane of a
``[n_v * n_cmd]`` batch stepped through the env's longitudinal dynamics
together.  The tables serve the reference's role: a feedforward inverse
map ``(v, desired accel) -> command`` for the longitudinal controller.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from dcarl_tpu_torch.config import EnvConfig
from dcarl_tpu_torch.device import resolve_device


class CalibrationTable(NamedTuple):
    """Measured accelerations on a (speed x command) grid: ``acc[i, j]``
    is the realised dv/dt from ``speeds[i]`` under constant command
    ``commands[j]`` (throttle in [0, 1] for the acc table, brake in [0, 1]
    for the dec table, the reference's two-file layout
    calibration.py:60-66, 135-141)."""

    speeds: torch.Tensor    # [n_v]
    commands: torch.Tensor  # [n_cmd]
    acc: torch.Tensor       # [n_v, n_cmd]


def _longitudinal_accel(v, cmd, cfg: EnvConfig):
    """The env's longitudinal model (driving_env._step_ego): throttle /
    brake split plus speed-proportional drag."""
    throttle = torch.clamp(cmd, min=0.0)
    brake = torch.clamp(-cmd, min=0.0)
    return throttle * cfg.max_accel - brake * cfg.max_brake - 0.05 * v


def measure_table(cfg: EnvConfig = EnvConfig(), speeds=None, commands=None,
                  settle_steps: int = 4, brake: bool = False,
                  device=None) -> CalibrationTable:
    """dv/dt of every grid cell, all cells stepped together on ``device``
    (``cuda`` unless the caller passes ``device="cpu"``): hold the
    command for ``settle_steps`` ticks from the cell's speed and record
    the mean acceleration (the reference's protocol,
    calibration.py:40-58)."""
    device = resolve_device(device)
    if speeds is None:
        speeds = np.arange(0.0, 20.5, 2.5)
    if commands is None:
        commands = np.arange(0.0, 1.01, 0.1)
    speeds = torch.as_tensor(np.asarray(speeds), dtype=torch.float32,
                             device=device)
    commands = torch.as_tensor(np.asarray(commands), dtype=torch.float32,
                               device=device)
    sign = -1.0 if brake else 1.0
    v0, cmd = torch.meshgrid(speeds, commands, indexing="ij")
    v0 = v0.reshape(-1)
    cmd = sign * cmd.reshape(-1)
    v = v0
    for _ in range(settle_steps):
        v = torch.clamp(v + _longitudinal_accel(v, cmd, cfg) * cfg.dt,
                        0.0, 60.0)
    acc = (v - v0) / (settle_steps * cfg.dt)
    return CalibrationTable(speeds, commands,
                            acc.reshape(len(speeds), len(commands)))


def save_tables(acc_table: CalibrationTable, dec_table: CalibrationTable,
                acc_path: str = "acc_table.txt",
                dec_path: str = "dec_table.txt") -> None:
    """Write the reference's two text files (rows = speeds, columns =
    commands; calibration.py:60-66)."""
    np.savetxt(acc_path, acc_table.acc.cpu().numpy(), fmt="%.6f")
    np.savetxt(dec_path, dec_table.acc.cpu().numpy(), fmt="%.6f")


def load_table(path: str, speeds, commands, device=None) -> CalibrationTable:
    device = resolve_device(device)

    def f32(a):
        return torch.as_tensor(np.asarray(a, np.float32), device=device)

    return CalibrationTable(f32(speeds), f32(commands), f32(np.loadtxt(path)))


def feedforward_command(table: CalibrationTable, v, desired_accel
                        ) -> torch.Tensor:
    """Invert the table: the smallest command that reaches at least the
    desired acceleration at speed ``v`` (batched; the last command where
    none does).  Rows rise with the command, so the first True of the
    row's mask is the answer; it is found as the argmax of the mask in
    ``uint8`` (the first maximum, on the card too)."""
    dev = table.acc.device
    v = torch.as_tensor(v, dtype=table.speeds.dtype, device=dev)
    desired = torch.as_tensor(desired_accel, dtype=table.acc.dtype,
                              device=dev)
    n_v, n_cmd = table.acc.shape
    iv = torch.clamp(torch.searchsorted(table.speeds, v.contiguous()),
                     0, n_v - 1)
    ok = table.acc[iv] >= desired[..., None]
    j = torch.argmax(ok.to(torch.uint8), dim=-1)
    j = torch.where(ok.any(dim=-1), j, n_cmd - 1)
    return table.commands[j]
