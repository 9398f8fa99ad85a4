"""Checkpoint / resume and the store's text history
(``dcarl_tpu/utils/checkpoint.py``).

A checkpoint is one ``torch.save`` file at ``directory/step_<N>`` (the
JAX package's ``step_<10 digits>`` layout) holding a flat dict: every
tensor of the saved state under its dotted field name
(``env.ego``, ``store_keys``, ``learner.net.head.0.weight``, ...).
NamedTuples and string-keyed dicts are walked; anything else (an
optimizer's per-parameter state, its param groups) is kept as one
value.  ``torch.load(..., weights_only=True)`` reads it back, so a
checkpoint carries no pickled classes.

The confidence store's append-only text mirror (visited_state.txt /
visited_value.txt, RLS.py:55-60) is the interchange between the two
packages and with the reference, so its bytes must equal the JAX
writer's: ``f"{x:f}"`` per value, space-separated, one row per line.
:func:`format_rows` writes those bytes from the float32 bit patterns
with integer arithmetic (round half to even on the exact binary value,
as Python's formatter does), several times faster than formatting each
value.  Histories are read back with ``np.loadtxt``, as the JAX
package reads them (its C parser is the fastest numpy offers).
"""

from __future__ import annotations

import hashlib
import os
import re
from typing import Any, Dict, Optional

import numpy as np
import torch

from dcarl_tpu_torch.core.store import (SENTINEL_KEY, ConfidenceStore,
                                        store_init, store_insert)
from dcarl_tpu_torch.device import resolve_device


def _path(directory: str, step: int) -> str:
    return os.path.abspath(os.path.join(directory, f"step_{step:010d}"))


def _is_namedtuple(x) -> bool:
    return isinstance(x, tuple) and hasattr(x, "_fields")


def _walked(x) -> bool:
    # an empty dict stays one value: a fresh optimizer's per-parameter
    # state is {} where the saved one is keyed by parameter index
    return _is_namedtuple(x) or (
        isinstance(x, dict) and bool(x) and all(isinstance(k, str) for k in x))


def flatten(state: Any, prefix: str = "") -> Dict[str, Any]:
    """``{dotted name: leaf}`` of a tree of NamedTuples and non-empty
    string-keyed dicts; any other value is a leaf."""
    if not _walked(state):
        return {prefix: state}
    items = state._asdict().items() if _is_namedtuple(state) else state.items()
    out: Dict[str, Any] = {}
    for name, value in items:
        out.update(flatten(value, f"{prefix}.{name}" if prefix else name))
    return out


def unflatten(flat: Dict[str, Any], target: Any, prefix: str = "") -> Any:
    """``target``'s structure filled from ``flat``.  A tensor leaf must
    match the target's shape and dtype and lands on the target's device;
    any other leaf is taken as saved."""
    if not _walked(target):
        if prefix not in flat:
            raise KeyError(f"checkpoint holds no {prefix!r}")
        value = flat[prefix]
        if isinstance(target, torch.Tensor):
            if not isinstance(value, torch.Tensor) \
                    or value.shape != target.shape or value.dtype != target.dtype:
                got = (tuple(value.shape), value.dtype) \
                    if isinstance(value, torch.Tensor) else type(value)
                raise ValueError(f"{prefix}: checkpoint holds {got}, the target "
                                 f"{tuple(target.shape)} {target.dtype}")
            return value.to(target.device)
        return value
    names = target._fields if _is_namedtuple(target) else list(target)
    values = {n: unflatten(flat, getattr(target, n) if _is_namedtuple(target)
                           else target[n], f"{prefix}.{n}" if prefix else n)
              for n in names}
    return type(target)(**values) if _is_namedtuple(target) else values


def save(directory: str, step: int, state: Any) -> str:
    """Save ``state`` at ``directory/step_<N>`` (written beside it, then
    renamed into place)."""
    os.makedirs(directory, exist_ok=True)
    path = _path(directory, step)
    flat = {k: (v.detach().cpu() if isinstance(v, torch.Tensor) else v)
            for k, v in flatten(state).items()}
    torch.save(flat, path + ".tmp")
    os.replace(path + ".tmp", path)
    return path


def restore(directory: str, step: int, target: Any) -> Any:
    """Restore into the structure of ``target`` (its shapes, dtypes and
    devices)."""
    flat = torch.load(_path(directory, step), map_location="cpu",
                      weights_only=True)
    extra = set(flat) - set(flatten(target))
    if extra:
        raise ValueError(f"checkpoint holds fields the target lacks: "
                         f"{sorted(extra)}")
    return unflatten(flat, target)


def latest_step(directory: str) -> Optional[int]:
    if not os.path.isdir(directory):
        return None
    steps = [int(m.group(1)) for m in
             (re.fullmatch(r"step_(\d+)", n) for n in os.listdir(directory))
             if m]
    return max(steps) if steps else None


def load_or_init(directory: str, init_fn, *args, **kwargs):
    """The reference's load-or-create pattern (DCARL_agent.py:21-26):
    restore the latest checkpoint if one exists, else initialize fresh."""
    target = init_fn(*args, **kwargs)
    step = latest_step(directory)
    if step is None:
        return target, 0
    return restore(directory, step, target), step


def save_npz(path: str, state: Any) -> None:
    """Every tensor (or array) leaf of ``state`` under its dotted name."""
    flat = flatten(state)
    bad = [k for k, v in flat.items()
           if not isinstance(v, (torch.Tensor, np.ndarray, np.generic))]
    if bad:
        raise TypeError(f"save_npz stores arrays only; not arrays: {bad}")
    np.savez(path, **{k: _host(v) for k, v in flat.items()})


def load_npz(path: str, target: Any) -> Any:
    with np.load(path, allow_pickle=False) as data:
        flat = {k: torch.as_tensor(data[k]) for k in data.files}
    return unflatten(flat, target)


# ---------------------------------------------------------------------------
# The store's text history
# ---------------------------------------------------------------------------

_BLOCK_ROWS = 1 << 15
_FIELD = 22          # sign, 13 integer digits, '.', 6 decimals, separator
_INT_DIGITS = 13
_MAX_EXP = 127 + 43  # |x| < 2^43: x * 10^6 is an exact int64


def _host(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def _format_slow(a: np.ndarray) -> bytes:
    return "".join(" ".join(f"{x:f}" for x in row) + "\n"
                   for row in a).encode()


def _format_block_f32(a: np.ndarray) -> bytes:
    bits = np.ascontiguousarray(a).view(np.uint32).astype(np.int64)
    ex = (bits >> 23) & 0xFF
    if (ex >= _MAX_EXP).any():   # inf, nan or |x| >= 2^43
        return _format_slow(a)
    neg = ((bits >> 31) & 1).astype(bool)
    man = bits & 0x7FFFFF
    m = np.where(ex == 0, man, man | 0x800000)          # x = m * 2^e
    e = np.where(ex == 0, -149, ex - 150)
    # x * 10^6 rounded half to even: exact for e >= 0, else from the
    # remainder of m * 10^6 / 2^k (k <= 62 is enough: m * 10^6 < 2^45)
    r_pos = (m << np.clip(e, 0, 62)) * 1_000_000
    big = m * 1_000_000
    k = np.clip(-e, 1, 62)
    q = big >> k
    rem = big & ((np.int64(1) << k) - 1)
    half = np.int64(1) << (k - 1)
    r_neg = q + ((rem > half) | ((rem == half) & ((q & 1) == 1)))
    ip, fp = np.divmod(np.where(e >= 0, r_pos, r_neg), 1_000_000)
    fp = fp.astype(np.int32)
    if int(ip.max()) < 2 ** 31:
        ip = ip.astype(np.int32)

    n, c = a.shape
    buf = np.empty((n, c, _FIELD), np.uint8)
    keep = np.zeros((n, c, _FIELD), bool)
    buf[..., 0] = ord("-")
    keep[..., 0] = neg
    # integer digits from the right; a place is printed while the
    # number still has digits there (the units place always)
    dot = 1 + _INT_DIGITS
    for j in range(dot - 1, 0, -1):
        if j < dot - 1 and not ip.any():
            break
        keep[..., j] = (ip > 0) if j < dot - 1 else True
        ip, digit = np.divmod(ip, 10)
        buf[..., j] = digit + 48
    buf[..., dot] = ord(".")
    for j in range(dot + 6, dot, -1):
        fp, digit = np.divmod(fp, 10)
        buf[..., j] = digit + 48
    buf[..., -1] = ord(" ")
    buf[:, -1, -1] = ord("\n")
    keep[..., dot:] = True
    return buf[keep].tobytes()


def format_rows(a) -> bytes:
    """The bytes of ``" ".join(f"{x:f}" for x in row) + "\\n"`` for every
    row of a 2-D array (the JAX package's text writer)."""
    a = _host(a)
    if a.ndim != 2:
        raise ValueError(f"rows [N, C] expected, got shape {a.shape}")
    if a.dtype != np.float32 or a.shape[1] == 0:
        return _format_slow(a)
    return b"".join(_format_block_f32(a[i:i + _BLOCK_ROWS])
                    for i in range(0, a.shape[0], _BLOCK_ROWS))


def export_store_text(store: ConfidenceStore, state_path: str,
                      value_path: str) -> None:
    """Mirror the confidence store to the reference's append-only text
    format: visited_state.txt rows = state||action, visited_value.txt
    rows = (action, value) (RLS.py:55-60, :196-199)."""
    keys, actions, values = (_host(x) for x in (store.keys, store.actions,
                                                store.values))
    n = int(_host(store.size))
    with open(state_path, "wb") as f:
        f.write(format_rows(keys[:n]))
    with open(value_path, "wb") as f:
        f.write(format_rows(np.stack([actions[:n], values[:n]], axis=1)))


def ring_delta_slots(old_head: int, new_head: int, n_inserted: int,
                     capacity: int) -> np.ndarray:
    """Ring slots written between two snapshots, oldest first.

    Valid only when fewer than ``capacity`` rows were inserted between
    the snapshots (otherwise some rows were overwritten before they
    could be observed; the spooler raises in that case)."""
    if n_inserted > capacity:
        raise ValueError(
            f"{n_inserted} inserts since last snapshot exceed capacity "
            f"{capacity}: rows were lost before spooling; snapshot more "
            f"often than once per `capacity` inserts")
    if (old_head + n_inserted) % capacity != new_head % capacity:
        raise ValueError(f"head {old_head} + {n_inserted} inserts does not "
                         f"reach head {new_head} in a ring of {capacity}")
    return (old_head + np.arange(n_inserted)) % capacity


class StoreSpooler:
    """Host-side append-only persistence of a ring store's history.

    The reference store is append-only and persisted forever
    (visited_state.txt / visited_value.txt, RLS.py:34-76, :185-215); the
    device store ring-overwrites once full (``core/store.py``
    ``store_insert``).  Feed the spooler each periodic store snapshot and
    it appends exactly the rows written since the previous snapshot, so
    the history grows without bound while the device keeps a fixed-shape
    working set.  Snapshots must come at least once per ``capacity``
    inserts or the spooler raises."""

    def __init__(self, state_path: str, value_path: str):
        self.state_path = state_path
        self.value_path = value_path
        self._head = 0
        self._total = 0      # cumulative inserts observed
        self._digest = None  # content fingerprint of the last snapshot

    def spool(self, store: ConfidenceStore,
              n_inserted: Optional[int] = None) -> int:
        """Append rows written since the previous ``spool`` call.

        ``n_inserted`` is the number of inserts since the last spool; if
        omitted it is inferred from the head delta, which wraps to 0 after
        a whole multiple of ``capacity`` inserts, so inferred mode also
        fingerprints the store and raises when the contents changed under
        a zero head delta.  Rows stamped with :data:`SENTINEL_KEY` (dense
        block padding, which matches no query) are skipped.  The store's
        fields may be tensors on any device (one copy to the host) or
        arrays.  Returns the number of rows appended."""
        keys, actions, values = (_host(x) for x in (store.keys, store.actions,
                                                    store.values))
        head = int(_host(store.head))
        capacity = keys.shape[0]
        digest = hashlib.sha256(
            np.ascontiguousarray(keys).tobytes()
            + np.ascontiguousarray(values).tobytes()).digest()
        if n_inserted is None:
            n_inserted = (head - self._head) % capacity
            if (n_inserted == 0 and self._digest is not None
                    and digest != self._digest):
                raise ValueError(
                    "store contents changed but the head returned to its "
                    "previous slot: a whole multiple of `capacity` inserts "
                    "happened since the last spool, so rows were "
                    "overwritten before they could be persisted; spool "
                    "more often or pass n_inserted explicitly")
        slots = ring_delta_slots(self._head, head, n_inserted, capacity)
        if len(slots):
            slots = slots[np.abs(keys[slots]).max(axis=1) < SENTINEL_KEY / 2]
        with open(self.state_path, "ab") as f:
            f.write(format_rows(keys[slots]))
        with open(self.value_path, "ab") as f:
            f.write(format_rows(np.stack([actions[slots], values[slots]],
                                         axis=1)))
        self._head = head % capacity
        self._total += n_inserted
        self._digest = digest
        return len(slots)

    @property
    def total_spooled(self) -> int:
        return self._total


def import_store_text(state_path: str, value_path: str, capacity: int,
                      device: "str | torch.device | None" = None
                      ) -> ConfidenceStore:
    """Reload a text-mirrored store (the RLS.py:47-52 load path) into a
    ring store of ``capacity`` rows on ``device`` (None = ``cuda``)."""
    device = resolve_device(device)
    keys = np.loadtxt(state_path, ndmin=2)
    vals = np.loadtxt(value_path, ndmin=2)
    store = store_init(capacity, keys.shape[1], device=device)

    def f32(a):
        return torch.as_tensor(a.astype(np.float32), device=device)

    return store_insert(store, f32(keys), f32(vals[:, 0]), f32(vals[:, 1]),
                        torch.ones(len(keys), dtype=torch.bool, device=device))
