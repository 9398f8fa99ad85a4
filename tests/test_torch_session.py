"""PyTorch port: the cross-session lifecycle (``dcarl_tpu/session.py``).

The three contracts of ``tests/test_session.py`` on the port, at its
sizes (batch 4, store and replay 128, a 2-step window):

* save -> a fresh ``TrainSession`` -> restore -> continue is bit-equal to
  the uninterrupted run, learner included (same seeded generators);
* spool -> import -> the evidence answers queries -> history keeps growing;
* ``store_total`` counts ring wraps, so the history outgrows the ring.

Plus the interchange with the JAX package: a history written by JAX's
``StoreSpooler`` seeds the same store fields in both packages'
``seed_store_from_text``, and a history written by the port loads into
the JAX package unchanged."""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu import session as jsession
from dcarl_tpu.utils import checkpoint as jckpt
from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch.core import store as tstore
from dcarl_tpu_torch.session import TrainSession, seed_store_from_text
from dcarl_tpu_torch.utils import checkpoint as tckpt

CFG = tcfg.DCARLConfig(
    dqn=tcfg.DQNConfig(batch_size=4, replay_capacity=128),
    store=tcfg.driving_store_config(visited_times_thres=4,
                                    rl_visited_times_min=2, n_step_window=2),
)
TRAINER_KW = dict(batch_per_device=4, store_capacity_per_device=128,
                  replay_capacity_per_device=128, use_kernel=False,
                  device="cpu")


def _gen(seed):
    return torch.Generator().manual_seed(seed)


def _assert_equal(a, b):
    fa, fb = tckpt.flatten(a), tckpt.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert repr(fa[k]) == repr(fb[k]), k


def test_save_restore_bit_identical_continuation(tmp_path):
    """Checkpoint mid-run, rebuild the trainer from scratch (a fresh
    TrainSession, as a new process would), restore, continue: every state
    tensor and the learner (weights, target, Adam) equal the uninterrupted
    run's bit for bit."""
    sess = TrainSession(str(tmp_path), CFG, **TRAINER_KW)
    run3 = sess.run_factory(3)
    state, step0 = sess.init_or_resume(seed=0)
    assert step0 == 0
    state, _ = run3(state, _gen(10))
    sess.save(state, step=3)
    state_cont, _ = run3(state, _gen(20))          # uninterrupted reference

    sess2 = TrainSession(str(tmp_path), CFG, **TRAINER_KW)
    restored, step = sess2.init_or_resume(seed=5)
    assert step == 3
    state_resumed, _ = sess2.run_factory(3)(restored, _gen(20))
    _assert_equal(state_resumed, state_cont)
    _assert_equal(sess2.learner.state_dict(), sess.learner.state_dict())
    assert int(state_cont.frame) == 6


def test_spool_import_continue_improving(tmp_path):
    """Session A trains and spools; session B (fresh learner and replay,
    another directory) imports the text history, sees the evidence in
    queries, and keeps appending to its own history."""
    dir_a, dir_b = str(tmp_path / "a"), str(tmp_path / "b")
    sess_a = TrainSession(dir_a, CFG, **TRAINER_KW)
    run5 = sess_a.run_factory(5)
    state, _ = sess_a.init_or_resume(seed=0)
    gen = _gen(0)
    for _ in range(3):                               # spool once per chunk
        state, _ = run5(state, gen)
        sess_a.spool(state)
    sess_a.save(state, step=15)
    hist_a = sess_a.history_rows()
    assert hist_a > 0
    assert hist_a == int(state.store_size.sum())     # nothing wrapped: 1:1

    sess_b = TrainSession(dir_b, CFG, **TRAINER_KW)
    state_b, step_b = sess_b.init_or_resume(seed=99)
    assert step_b == 0 and int(state_b.store_size.sum()) == 0
    state_b = seed_store_from_text(state_b, sess_a.state_path,
                                   sess_a.value_path)
    assert int(state_b.store_size.sum()) == hist_a
    assert torch.equal(state_b.store_total, state_b.store_size)

    # the imported evidence answers queries: an imported key matches
    store0 = tstore.ConfidenceStore(
        state_b.store_keys[0], state_b.store_actions[0],
        state_b.store_values[0], state_b.store_size[0], state_b.store_head[0])
    hw = torch.as_tensor(CFG.store.half_widths, dtype=torch.float32)
    qs = tstore.box_query_stats(store0, state_b.store_keys[0, :1], hw,
                                use_kernel=False)
    assert int(qs.count[0]) >= 1

    state_b, _ = sess_b.run_factory(5)(state_b, _gen(7))
    sess_b.spool(state_b)
    assert sess_b.history_rows() > 0
    assert int(state_b.store_size.sum()) > hist_a \
        or int(state_b.store_total.sum()) > hist_a


def test_store_total_counts_ring_wraps(tmp_path):
    """store_total keeps exact insert counts past capacity, so the spooled
    history exceeds the device ring (RLS.py:185-215)."""
    tiny = dict(TRAINER_KW, batch_per_device=8, store_capacity_per_device=32,
                replay_capacity_per_device=32)
    sess = TrainSession(str(tmp_path), CFG, **tiny)
    run2 = sess.run_factory(2)
    state, _ = sess.init_or_resume(seed=0)
    gen, hist = _gen(0), 0
    for _ in range(12):
        state, _ = run2(state, gen)
        hist += sess.spool(state)
    total = int(state.store_total[0])
    assert hist == total
    assert int(state.store_size[0]) <= 32
    assert total > 32, "test needs the ring to wrap"
    assert sess.history_rows() == total


class StoreFields(NamedTuple):
    """The store fields of a trainer state, [S, ...] (what
    ``seed_store_from_text`` reads and replaces)."""

    store_keys: object
    store_actions: object
    store_values: object
    store_size: object
    store_head: object
    store_total: object


def _empty_fields(s, capacity, d, make):
    return StoreFields(make(np.zeros((s, capacity, d), np.float32)),
                       make(np.zeros((s, capacity), np.float32)),
                       make(np.zeros((s, capacity), np.float32)),
                       make(np.zeros(s, np.int32)), make(np.zeros(s, np.int32)),
                       make(np.zeros(s, np.int32)))


class Snap(NamedTuple):
    keys: np.ndarray
    actions: np.ndarray
    values: np.ndarray
    size: np.ndarray
    head: np.ndarray


def _write_history(mod, tmp_path, tag, n_rows):
    rng = np.random.default_rng(n_rows)
    keys = rng.normal(0, 20, (n_rows, 21)).astype(np.float32)
    keys[:, -1] = rng.integers(0, 11, n_rows)
    sp = mod.StoreSpooler(str(tmp_path / f"{tag}_s.txt"),
                          str(tmp_path / f"{tag}_v.txt"))
    sp.spool(Snap(keys, keys[:, -1].copy(),
                  rng.normal(0, 2, n_rows).astype(np.float32),
                  np.int32(n_rows), np.int32(0)), n_inserted=n_rows)
    return sp.state_path, sp.value_path


def _compare_seeded(paths, s, capacity):
    got = seed_store_from_text(_empty_fields(s, capacity, 21, torch.as_tensor),
                               *paths)
    want = jsession.seed_store_from_text(
        _empty_fields(s, capacity, 21, jnp.asarray), *paths)
    for name in StoreFields._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    return got


@pytest.mark.parametrize("shards,capacity", [(1, 64), (1, 16), (2, 16)])
def test_seed_store_from_jax_history_matches_jax(tmp_path, shards, capacity):
    """A history written by the JAX package's spooler: both packages seed
    the same store (round-robin over shards, newest rows win a full
    shard)."""
    paths = _write_history(jckpt, tmp_path, "jax", 40)
    got = _compare_seeded(paths, shards, capacity)
    assert int(got.store_total.sum()) == 40


def test_port_history_loads_into_jax(tmp_path):
    paths_t = _write_history(tckpt, tmp_path, "port", 40)
    paths_j = _write_history(jckpt, tmp_path, "jax", 40)
    assert [open(p, "rb").read() for p in paths_t] \
        == [open(p, "rb").read() for p in paths_j]
    _compare_seeded(paths_t, 1, 64)
    want = jckpt.import_store_text(*paths_t, capacity=64)
    got = tckpt.import_store_text(*paths_t, capacity=64, device="cpu")
    for name in tstore.ConfidenceStore._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)


def test_session_is_single_device(tmp_path):
    """Without a mesh the session runs on one device: n_devices must be
    the mesh's size."""
    with pytest.raises(ValueError, match="mesh has 1 rank"):
        TrainSession(str(tmp_path), CFG, n_devices=2, **TRAINER_KW)
