"""Bundled-dataset loading (``dcarl_tpu/data/datasets.py``, numpy only).

The reference ships its demo datasets as ``.npy`` files:
  Simulation_1: data_carla.npy (20000, 4), action_value_carla.npy (1, 11)
  Simulation_2: data.npy (49866, 4), action_value.npy (20, 11), states.npy (20,)
Row format of the data arrays: [state_idx, state_scalar, action_idx, value]
(Data_Sampling/data_sampling.py:30-67).

The files are looked up under ``root``: the argument, else the
``DCARL_REFERENCE_ROOT`` environment variable (read at each call), else
the JAX package's default root.
"""

from __future__ import annotations

import os
from typing import NamedTuple, Optional

import numpy as np

# The JAX package's default root (dcarl_tpu/data/datasets.py:21).
_FALLBACK_ROOT = os.path.join(os.sep, "root", "reference")
# As JAX has it: the variable as it was at import.
DEFAULT_ROOT = os.environ.get("DCARL_REFERENCE_ROOT", _FALLBACK_ROOT)


class DemoDataset(NamedTuple):
    data: np.ndarray                # [N, 4]
    action_values: np.ndarray       # [S, A]
    states: Optional[np.ndarray]    # [S] or None
    stream_len: int                 # samples the demo consumes
    action_num: int                 # size of the demo's action table


def default_root() -> str:
    """The variable as it is now, else the JAX package's default."""
    return os.environ.get("DCARL_REFERENCE_ROOT", _FALLBACK_ROOT)


def _sim_dir(name: str, root: Optional[str]) -> str:
    return os.path.join(root or default_root(), "Simulation_testing", name)


def reference_available(root: Optional[str] = None) -> bool:
    return os.path.exists(_sim_dir("Simulation_1", root))


def load_sim1(root: Optional[str] = None) -> DemoDataset:
    """Simulation_1: one state x a 30-action table (the data covers
    actions 0-10), a 20k-sample stream (Simulation_1/test_DCARL.py:33-39,
    :73)."""
    d = _sim_dir("Simulation_1", root)
    data = np.load(os.path.join(d, "data_carla.npy"))
    av = np.load(os.path.join(d, "action_value_carla.npy"))
    # the demo sizes its table at 30 actions while the ground truth has
    # 11 columns: pad the truth table so lookups stay in range
    padded = np.full((av.shape[0], 30), np.nan)
    padded[:, : av.shape[1]] = av
    return DemoDataset(data=data, action_values=padded, states=None,
                       stream_len=20000, action_num=30)


def load_sim2(root: Optional[str] = None) -> DemoDataset:
    """Simulation_2: 20 states x 11 actions, 20k of 49,866 samples
    consumed (Simulation_2/test_DCARL.py:33-39, :72)."""
    d = _sim_dir("Simulation_2", root)
    data = np.load(os.path.join(d, "data.npy"))
    av = np.load(os.path.join(d, "action_value.npy"))
    return DemoDataset(data=data, action_values=av, states=None,
                       stream_len=20000, action_num=11)
