"""Runtime NaN/Inf sanitizer (``dcarl_tpu/utils/nan_guard.py``).

Re-design of the SB fork's ``VecCheckNan``
(common/vec_env/vec_check_nan.py, the reference's only runtime
sanitizer): detect NaN/inf in actions, observations and rewards and
either raise (host side) or surface a boolean flag that stays on the
device (no host sync).

The trees are nested NamedTuples, dicts, lists and tuples of tensors,
numpy arrays and Python numbers.  Leaf paths read as JAX's
``tree_util.keystr`` writes them (``[0].obs``, ``['k']``), so the
messages name the same leaves as the JAX package's.
"""

from __future__ import annotations

from typing import Any, Dict, Iterator, Tuple

import numpy as np
import torch


def tree_leaves_with_path(tree: Any, path: str = ""
                          ) -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) of every leaf, in JAX's flattening order
    (dict keys sorted, ``None`` an empty subtree)."""
    if tree is None:
        return
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        for name in tree._fields:
            yield from tree_leaves_with_path(getattr(tree, name),
                                             f"{path}.{name}")
    elif isinstance(tree, (tuple, list)):
        for i, v in enumerate(tree):
            yield from tree_leaves_with_path(v, f"{path}[{i}]")
    elif isinstance(tree, dict):
        try:
            keys = sorted(tree)
        except TypeError:
            keys = list(tree)
        for k in keys:
            yield from tree_leaves_with_path(tree[k], f"{path}[{k!r}]")
    else:
        yield path, tree


def _is_float(leaf) -> bool:
    if isinstance(leaf, torch.Tensor):
        return leaf.is_floating_point()
    return np.issubdtype(np.asarray(leaf).dtype, np.floating)


def check_finite(tree: Any) -> torch.Tensor:
    """0-d bool tensor, True when every floating leaf is finite.  It lies
    on the device of the tensor leaves, so reading it is the caller's
    choice of when to sync."""
    out = None
    for _, leaf in tree_leaves_with_path(tree):
        if not _is_float(leaf):
            continue
        ok = torch.isfinite(torch.as_tensor(leaf)).all()
        out = ok if out is None else out & ok.to(out.device)
    return torch.tensor(True) if out is None else out


def first_nonfinite(tree: Any) -> Dict[str, int]:
    """Host-side diagnosis: leaf path -> count of non-finite entries."""
    out = {}
    for path, leaf in tree_leaves_with_path(tree):
        if not _is_float(leaf):
            continue
        bad = int((~torch.isfinite(torch.as_tensor(leaf))).sum())
        if bad:
            out[path] = bad
    return out


def assert_finite(tree: Any, context: str = "") -> None:
    """Raise ValueError naming the offending leaves (VecCheckNan's
    error-with-provenance behaviour)."""
    bad = first_nonfinite(tree)
    if bad:
        raise ValueError(
            f"NaN/Inf detected{' in ' + context if context else ''}: {bad}")


def guard_step(step_fn, context: str = "step"):
    """Wrap a host-called step function: checks inputs and outputs
    (check_array_value pattern of vec_check_nan.py)."""

    def wrapped(*args, **kwargs):
        assert_finite((args, kwargs), context + " inputs")
        out = step_fn(*args, **kwargs)
        assert_finite(out, context + " outputs")
        return out

    return wrapped
