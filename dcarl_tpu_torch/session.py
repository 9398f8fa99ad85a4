"""Cross-session training lifecycle (``dcarl_tpu/session.py``): persist,
reload, keep improving.

The reference's confidence dataset lives in append-only text reloaded
every time the agent process starts (deepq/RLS.py:34-76), and the agent
itself is load-or-new (DCARL_agent.py:18-43).  Here:

* :class:`TrainSession` wraps ``train_fast.make_trainer_fast`` with a
  checkpoint directory and a :class:`~dcarl_tpu_torch.utils.checkpoint.
  StoreSpooler` that appends each chunk's new store rows to the
  reference text format, counted by the trainer's ``store_total``.
  The JAX ``FastTrainState`` carries the learner's params, target params
  and optimizer state; the port keeps them in the trainer's ``DQN``
  object, so a checkpoint holds the ``FastTrainState`` tensors and
  ``learner.state_dict()``, and :meth:`TrainSession.init_or_resume`
  restores both: a resumed run is then the uninterrupted one.
* :func:`seed_store_from_text` starts a new session (fresh learner,
  empty replay) from the spooled history of earlier ones.

Single device: the state keeps the shard axis S = 1.
"""

from __future__ import annotations

import json
import os
from typing import Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import DCARLConfig
from dcarl_tpu_torch.core.store import ConfidenceStore
from dcarl_tpu_torch.train_fast import FastTrainState, make_trainer_fast
from dcarl_tpu_torch.utils import checkpoint as CKPT


def single_device(n_devices: int) -> None:
    if n_devices != 1:
        raise NotImplementedError(
            f"n_devices={n_devices}: the port runs on one device; the "
            "sharded forms are ROADMAP.md queue A item 9")


def _shard_store(state: FastTrainState, s: int) -> ConfidenceStore:
    """Shard ``s`` of the state's store as host arrays (one copy each)."""
    def host(t):
        return t[s].detach().cpu().numpy()

    return ConfidenceStore(keys=host(state.store_keys),
                           actions=host(state.store_actions),
                           values=host(state.store_values),
                           size=host(state.store_size),
                           head=host(state.store_head))


class TrainSession:
    """A checkpointed, history-spooling wrapper of the fast trainer.

    ``trainer_kwargs`` are those of :func:`make_trainer_fast`;
    ``session_dir`` holds ``ckpt/`` plus the append-only
    ``visited_state.txt`` / ``visited_value.txt`` history shared by all
    sessions that point at the same directory."""

    def __init__(self, session_dir: str, cfg: DCARLConfig = DCARLConfig(),
                 n_devices: int = 1, **trainer_kwargs):
        single_device(n_devices)
        self.session_dir = session_dir
        self.ckpt_dir = os.path.join(session_dir, "ckpt")
        self.state_path = os.path.join(session_dir, "visited_state.txt")
        self.value_path = os.path.join(session_dir, "visited_value.txt")
        self.meta_path = os.path.join(session_dir, "session_meta.json")
        os.makedirs(self.ckpt_dir, exist_ok=True)
        self.n_shards = 1
        (self.init_fn, self.step_fn, self.learner,
         self.run_factory) = make_trainer_fast(cfg, **trainer_kwargs)
        self._spoolers = [CKPT.StoreSpooler(self.state_path, self.value_path)
                          for _ in range(self.n_shards)]
        self._spooled_total = [0] * self.n_shards

    # -- load-or-new (DCARL_agent.py:18-43) -----------------------------
    def init_or_resume(self, seed: int = 0) -> Tuple[FastTrainState, int]:
        """Restore the latest checkpoint (trainer state and learner) into
        this trainer, else initialize fresh.  Returns (state, step)."""
        template = self.init_fn(seed=seed)
        step = CKPT.latest_step(self.ckpt_dir)
        if step is None:
            return template, 0
        saved = CKPT.restore(self.ckpt_dir, step, {
            "state": template, "learner": self.learner.state_dict()})
        self.learner.load_state_dict(saved["learner"])
        if os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            for s, sp in enumerate(self._spoolers):
                sp._head = meta["spool_heads"][s]
                self._spooled_total[s] = meta["spooled_totals"][s]
        return saved["state"], step

    def mark_synced(self, state: FastTrainState) -> None:
        """Declare the state's current store contents already persisted
        (e.g. just imported by :func:`seed_store_from_text`): later
        ``spool`` calls append only rows written after this point."""
        totals = state.store_total.cpu().numpy()
        heads = state.store_head.cpu().numpy()
        for s in range(self.n_shards):
            self._spooled_total[s] = int(totals[s])
            self._spoolers[s]._head = int(heads[s])
            self._spoolers[s]._digest = None

    # -- history spooling (RLS.py:185-215 unbounded persistence) --------
    def spool(self, state: FastTrainState) -> int:
        """Append every store row written since the last spool to the text
        history, counted by the trainer's cumulative insert counters (a
        whole-capacity ring wrap raises instead of losing rows).  Returns
        rows appended (sentinel padding excluded)."""
        totals = state.store_total.cpu().numpy()
        appended = 0
        for s in range(self.n_shards):
            # i32 wrapping delta of cumulative slots written
            delta = int(np.uint32(np.int64(totals[s])
                                  - np.int64(self._spooled_total[s])))
            appended += self._spoolers[s].spool(_shard_store(state, s),
                                                n_inserted=delta)
            self._spooled_total[s] = int(totals[s])
        return appended

    # -- checkpointing ---------------------------------------------------
    def save(self, state: FastTrainState, step: int,
             spool_first: bool = True) -> str:
        if spool_first:
            self.spool(state)
        path = CKPT.save(self.ckpt_dir, step, {
            "state": state, "learner": self.learner.state_dict()})
        with open(self.meta_path, "w") as f:
            json.dump({
                "step": step,
                "spool_heads": [sp._head for sp in self._spoolers],
                "spooled_totals": self._spooled_total,
            }, f)
        return path

    def history_rows(self) -> int:
        if not os.path.exists(self.value_path):
            return 0
        with open(self.value_path, "rb") as f:
            return sum(1 for _ in f)


def seed_store_from_text(state: FastTrainState, state_path: str,
                         value_path: str) -> FastTrainState:
    """Start a new session from the spooled history of earlier ones (the
    reference reloads its whole history on construction, RLS.py:34-76).
    History rows go round-robin over the store shards; if a shard's share
    exceeds its capacity the newest rows win, as the ring would keep
    them.  Only the store changes: learner, replay and env stay as given."""
    hist_keys = np.loadtxt(state_path, ndmin=2).astype(np.float32)
    hist_vals = np.loadtxt(value_path, ndmin=2).astype(np.float32)
    n_rows = hist_keys.shape[0]
    s_shards, capacity, d = state.store_keys.shape
    if n_rows and hist_keys.shape[1] != d:
        raise ValueError(f"history key dim {hist_keys.shape[1]} != "
                         f"store dim {d}")

    new_keys = np.zeros((s_shards, capacity, d), np.float32)
    new_actions = np.zeros((s_shards, capacity), np.float32)
    new_values = np.zeros((s_shards, capacity), np.float32)
    new_size = np.zeros((s_shards,), np.int32)
    new_head = np.zeros((s_shards,), np.int32)
    new_total = np.zeros((s_shards,), np.int32)
    for s in range(s_shards):
        rows = np.arange(s, n_rows, s_shards)
        new_total[s] = len(rows)
        if len(rows) > capacity:
            rows = rows[-capacity:]          # newest win, ring semantics
        k = len(rows)
        new_keys[s, :k] = hist_keys[rows]
        new_actions[s, :k] = hist_vals[rows, 0]
        new_values[s, :k] = hist_vals[rows, 1]
        new_size[s] = k
        new_head[s] = k % capacity

    def put(old: torch.Tensor, new: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(new, device=old.device).to(old.dtype)

    return state._replace(
        store_keys=put(state.store_keys, new_keys),
        store_actions=put(state.store_actions, new_actions),
        store_values=put(state.store_values, new_values),
        store_size=put(state.store_size, new_size),
        store_head=put(state.store_head, new_head),
        store_total=put(state.store_total, new_total),
    )
