"""Carry state across from the JAX package.

The system has no model weights: its state is the env carry, the
confidence store and the reference-path tables.  These helpers take
that state as numpy arrays (``np.asarray`` of each JAX array; this
module never imports JAX) and return the port's tensors on a given
device, so both packages can start from the same carry and store.
"""

from __future__ import annotations

from typing import Any, Mapping, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.planning.fast_rollout import FastEnvState, RefTables

_INT_FIELDS = ("stuck_steps", "step_count")
_BOOL_FIELDS = ("done", "collided", "passed", "stuck")


def _fields(src: Any) -> Mapping[str, Any]:
    """A NamedTuple (``_asdict``) or a mapping, by field name."""
    return src._asdict() if hasattr(src, "_asdict") else src


def fast_env_state_from_numpy(src: Any, device, dtype=torch.float32
                              ) -> FastEnvState:
    """The lane-major carry of the JAX drivers' ``init_fn``/``run_fn``
    (``dcarl_tpu.planning.fast_rollout.FastEnvState``, any object with
    its fields) as the port's FastEnvState on ``device``."""
    f = _fields(src)
    out = {}
    for name in FastEnvState._fields:
        a = np.asarray(f[name])
        if name in _INT_FIELDS:
            t = torch.as_tensor(a.astype(np.int32))
        elif name in _BOOL_FIELDS:
            t = torch.as_tensor(a.astype(bool))
        else:
            t = torch.as_tensor(np.array(a)).to(dtype)
        out[name] = t.to(device)
    return FastEnvState(**out)


def store_from_numpy(keys, values, valid, device
                     ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """A store's (keys [N, D] f32, values [N] f32, valid [N] bool)."""
    keys = np.asarray(keys)
    values = np.asarray(values)
    valid = np.asarray(valid)
    if keys.ndim != 2 or values.shape != keys.shape[:1] \
            or valid.shape != keys.shape[:1]:
        raise ValueError(f"keys [N, D], values [N], valid [N] expected; got "
                         f"{keys.shape}, {values.shape}, {valid.shape}")
    return (torch.as_tensor(keys, dtype=torch.float32, device=device),
            torch.as_tensor(values, dtype=torch.float32, device=device),
            torch.as_tensor(valid.astype(bool), device=device))


def ref_tables_from_numpy(src: Any) -> RefTables:
    """The JAX package's ``RefTables`` (host float64 arrays) as the
    port's host tables; ``fast_rollout.tables_to`` makes device copies."""
    f = _fields(src)
    return RefTables(*(np.asarray(f[name], np.float64)
                       for name in RefTables._fields))
