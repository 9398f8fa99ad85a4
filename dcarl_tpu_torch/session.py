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

Over a mesh of S ranks (``mesh=``, ``n_devices`` = S) each rank trains
its shard; the files keep the JAX package's layout.  Rank 0 gathers the
shards and writes the checkpoint (every per-shard field with a leading
axis of S) and the text history (a spooler a shard, as JAX's); a
restore reads on rank 0 and hands each rank its shard.  Every rank must
call each method (they hold collectives).
"""

from __future__ import annotations

import json
import os
from typing import NamedTuple, Tuple

import numpy as np
import torch

from dcarl_tpu_torch.config import DCARLConfig
from dcarl_tpu_torch.core.store import ConfidenceStore
from dcarl_tpu_torch.parallel import collectives as coll
from dcarl_tpu_torch.parallel.mesh import ProcessMesh, tree_map
from dcarl_tpu_torch.train_fast import FastTrainState, make_trainer_fast
from dcarl_tpu_torch.utils import checkpoint as CKPT


def check_devices(n_devices: int, mesh: "ProcessMesh | None") -> None:
    """``n_devices`` must be the mesh's size (1 without a mesh)."""
    size = 1 if mesh is None else mesh.size
    if n_devices != size:
        raise ValueError(f"n_devices={n_devices} but the mesh has {size} "
                         f"rank(s): pass a mesh of n_devices ranks")


def gather_shards(state, mesh: "ProcessMesh | None"):
    """A rank's state (leading shard axis 1) in the JAX layout, the
    ranks' shards stacked on the leading axis, on every rank.  The frame
    counter is replicated and stays as it is."""
    if mesh is None or mesh.size == 1:
        return state
    return state._replace(**{
        k: tree_map(lambda t: coll.all_gather(t, mesh), v)
        for k, v in state._asdict().items() if k != "frame"})


def scatter_shards(state, mesh: "ProcessMesh | None"):
    """This rank's shard of a state in the JAX layout."""
    if mesh is None or mesh.size == 1:
        return state
    r = mesh.rank
    return state._replace(**{
        k: tree_map(lambda t: t[r:r + 1].contiguous(), v)
        for k, v in state._asdict().items() if k != "frame"})


def _from_rank0(x, mesh: "ProcessMesh | None"):
    """Rank 0's tensors (of any tree) on every rank."""
    if mesh is None or mesh.size == 1:
        return x
    return tree_map(lambda t: coll.broadcast(t, mesh), x)


def _learner_from_rank0(sd: dict, mesh: "ProcessMesh | None") -> dict:
    """Rank 0's learner state (its optimizer state has a shape only a
    restored rank knows) on every rank, on this rank's device."""
    if mesh is None or mesh.size == 1:
        return sd
    sd = coll.broadcast_object(
        tree_map(lambda t: t.cpu(), sd) if mesh.rank == 0 else None, mesh)
    return sd


def _int_from_rank0(v: int, mesh: "ProcessMesh | None") -> int:
    if mesh is None or mesh.size == 1:
        return v
    return int(coll.broadcast(torch.tensor([v], dtype=torch.int64), mesh)[0])


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
    sessions that point at the same directory.  ``n_devices`` must be
    the size of ``mesh`` (1 without one)."""

    def __init__(self, session_dir: str, cfg: DCARLConfig = DCARLConfig(),
                 n_devices: int = 1, mesh: "ProcessMesh | None" = None,
                 **trainer_kwargs):
        check_devices(n_devices, mesh)
        self.mesh = mesh
        self.writer = mesh is None or mesh.rank == 0
        self.session_dir = session_dir
        self.ckpt_dir = os.path.join(session_dir, "ckpt")
        self.state_path = os.path.join(session_dir, "visited_state.txt")
        self.value_path = os.path.join(session_dir, "visited_value.txt")
        self.meta_path = os.path.join(session_dir, "session_meta.json")
        if self.writer:
            os.makedirs(self.ckpt_dir, exist_ok=True)
        self.n_shards = n_devices
        (self.init_fn, self.step_fn, self.learner,
         self.run_factory) = make_trainer_fast(cfg, mesh=mesh,
                                               **trainer_kwargs)
        self._spoolers = [CKPT.StoreSpooler(self.state_path, self.value_path)
                          for _ in range(self.n_shards)]
        self._spooled_total = [0] * self.n_shards

    # -- load-or-new (DCARL_agent.py:18-43) -----------------------------
    def init_or_resume(self, seed: int = 0) -> Tuple[FastTrainState, int]:
        """Restore the latest checkpoint (trainer state and learner) into
        this trainer, else initialize fresh.  Returns (state, step)."""
        template = self.init_fn(seed=seed)
        step = CKPT.latest_step(self.ckpt_dir) if self.writer else None
        step = _int_from_rank0(-1 if step is None else step, self.mesh)
        if step < 0:
            return template, 0
        saved = {"state": gather_shards(template, self.mesh),
                 "learner": self.learner.state_dict()}
        if self.writer:
            saved = CKPT.restore(self.ckpt_dir, step, saved)
        state = _from_rank0(saved["state"], self.mesh)
        self.learner.load_state_dict(
            _learner_from_rank0(saved["learner"], self.mesh))
        if self.writer and os.path.exists(self.meta_path):
            with open(self.meta_path) as f:
                meta = json.load(f)
            for s, sp in enumerate(self._spoolers):
                sp._head = meta["spool_heads"][s]
                self._spooled_total[s] = meta["spooled_totals"][s]
        return scatter_shards(state, self.mesh), step

    def mark_synced(self, state: FastTrainState) -> None:
        """Declare the state's current store contents already persisted
        (e.g. just imported by :func:`seed_store_from_text`): later
        ``spool`` calls append only rows written after this point."""
        totals = coll.all_gather(state.store_total, self.mesh) \
            if self.mesh else state.store_total
        heads = coll.all_gather(state.store_head, self.mesh) \
            if self.mesh else state.store_head
        totals, heads = totals.cpu().numpy(), heads.cpu().numpy()
        for s in range(self.n_shards):
            self._spooled_total[s] = int(totals[s])
            self._spoolers[s]._head = int(heads[s])
            self._spoolers[s]._digest = None

    # -- history spooling (RLS.py:185-215 unbounded persistence) --------
    def spool(self, state: FastTrainState) -> int:
        """Append every store row written since the last spool to the text
        history, counted by the trainer's cumulative insert counters (a
        whole-capacity ring wrap raises instead of losing rows).  Returns
        rows appended (sentinel padding excluded), on every rank."""
        store = _store_fields(state)
        store = gather_shards(store, self.mesh)
        if not self.writer:
            return _int_from_rank0(0, self.mesh)
        totals = store.store_total.cpu().numpy()
        appended = 0
        for s in range(self.n_shards):
            # i32 wrapping delta of cumulative slots written
            delta = int(np.uint32(np.int64(totals[s])
                                  - np.int64(self._spooled_total[s])))
            appended += self._spoolers[s].spool(_shard_store(store, s),
                                                n_inserted=delta)
            self._spooled_total[s] = int(totals[s])
        return _int_from_rank0(appended, self.mesh)

    # -- checkpointing ---------------------------------------------------
    def save(self, state: FastTrainState, step: int,
             spool_first: bool = True) -> str:
        if spool_first:
            self.spool(state)
        full = gather_shards(state, self.mesh)
        path = CKPT._path(self.ckpt_dir, step)
        if self.writer:
            CKPT.save(self.ckpt_dir, step, {
                "state": full, "learner": self.learner.state_dict()})
            with open(self.meta_path, "w") as f:
                json.dump({
                    "step": step,
                    "spool_heads": [sp._head for sp in self._spoolers],
                    "spooled_totals": self._spooled_total,
                }, f)
        return path

    def history_rows(self) -> int:
        n = 0
        if self.writer and os.path.exists(self.value_path):
            with open(self.value_path, "rb") as f:
                n = sum(1 for _ in f)
        return _int_from_rank0(n, self.mesh)


class _StoreFields(NamedTuple):
    store_keys: torch.Tensor
    store_actions: torch.Tensor
    store_values: torch.Tensor
    store_size: torch.Tensor
    store_head: torch.Tensor
    store_total: torch.Tensor


def _store_fields(state: FastTrainState) -> _StoreFields:
    return _StoreFields(*(getattr(state, k) for k in _StoreFields._fields))


def seed_store_from_text(state: FastTrainState, state_path: str,
                         value_path: str,
                         mesh: "ProcessMesh | None" = None) -> FastTrainState:
    """Start a new session from the spooled history of earlier ones (the
    reference reloads its whole history on construction, RLS.py:34-76).
    History rows go round-robin over the store shards (over the ranks of
    ``mesh``: rank r keeps rows r, r + S, ..., reading the history files
    itself); if a shard's share exceeds its capacity the newest rows win,
    as the ring would keep them.  Only the store changes: learner, replay
    and env stay as given."""
    hist_keys = np.loadtxt(state_path, ndmin=2).astype(np.float32)
    hist_vals = np.loadtxt(value_path, ndmin=2).astype(np.float32)
    n_rows = hist_keys.shape[0]
    local, capacity, d = state.store_keys.shape
    s_shards = local if mesh is None else mesh.size
    first = 0 if mesh is None else mesh.rank
    if n_rows and hist_keys.shape[1] != d:
        raise ValueError(f"history key dim {hist_keys.shape[1]} != "
                         f"store dim {d}")

    new_keys = np.zeros((local, capacity, d), np.float32)
    new_actions = np.zeros((local, capacity), np.float32)
    new_values = np.zeros((local, capacity), np.float32)
    new_size = np.zeros((local,), np.int32)
    new_head = np.zeros((local,), np.int32)
    new_total = np.zeros((local,), np.int32)
    for s in range(local):
        rows = np.arange(first + s, n_rows, s_shards)
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
