"""What the port's entry points share: the ``--device`` flag, the card's
name and power limit, and where their outputs go by default.

Every entry point runs on the card unless ``--device cpu`` asks for the
CPU; with no card the default raises (``device.resolve_device``).  Their
default outputs go under ``build/torch_runs/`` (git-ignored), never over
a file the repository keeps.
"""

from __future__ import annotations

import argparse
import subprocess
import time
from pathlib import Path
from typing import Optional

import torch

from dcarl_tpu_torch.device import disable_tf32, resolve_device

RUNS_DIR = Path(__file__).resolve().parent.parent / "build" / "torch_runs"


def add_device_flag(parser: argparse.ArgumentParser,
                    cpu_alias: bool = False) -> None:
    """``--device {cuda,cpu}`` (default cuda); with ``cpu_alias`` also
    the JAX CLI's ``--cpu``, an alias of ``--device cpu``."""
    parser.add_argument("--device", choices=("cuda", "cpu"), default="cuda",
                        help="where to run (cuda raises without a card)")
    if cpu_alias:
        parser.add_argument("--cpu", dest="device", action="store_const",
                            const="cpu", default="cuda",
                            help="alias of --device cpu")


def device_of(args: argparse.Namespace) -> torch.device:
    """The device ``args.device`` names (raising for a missing card);
    full-FP32 products on the card."""
    dev = resolve_device(args.device)
    if dev.type == "cuda":
        disable_tf32()
    return dev


def sync(dev: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the CPU)."""
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def seconds(fn, dev: torch.device) -> float:
    """Host seconds of ``fn()``, from an idle card to an idle card."""
    sync(dev)
    t0 = time.perf_counter()
    fn()
    sync(dev)
    return time.perf_counter() - t0


def generator(dev: torch.device, seed: int) -> torch.Generator:
    return torch.Generator(device=dev).manual_seed(seed)


def card_line(dev: torch.device) -> Optional[str]:
    """The card's name and power limit as ``nvidia-smi
    --query-gpu=name,power.limit --format=csv,noheader`` gives them
    (None on the CPU)."""
    if dev.type != "cuda":
        return None
    index = dev.index if dev.index is not None else torch.cuda.current_device()
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader", f"--id={index}"],
        capture_output=True, text=True, check=True, timeout=60).stdout
    return out.strip().splitlines()[0]


def make_parent(path: str) -> str:
    """``path``, its directory made (the default ``build/torch_runs/``
    may not exist yet)."""
    Path(path).resolve().parent.mkdir(parents=True, exist_ok=True)
    return path
