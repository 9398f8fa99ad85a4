"""PyTorch port: checkpoints and the store's text history against the JAX
package (``dcarl_tpu/utils/checkpoint.py``).

The text history is the interchange between the two packages, so the
port's writer must produce the JAX writer's bytes on the same numpy
snapshots (ring wraps, sentinel rows, inferred insert counts), and the
import paths must build equal stores.  Checkpoints are the port's own
(``torch.save`` in place of orbax) and must round-trip bit for bit."""

from typing import NamedTuple

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.core import store as jstore
from dcarl_tpu.utils import checkpoint as jckpt
from dcarl_tpu_torch import config as tcfg
from dcarl_tpu_torch.core import store as tstore
from dcarl_tpu_torch.train_fast import make_trainer_fast
from dcarl_tpu_torch.utils import checkpoint as tckpt


class Snap(NamedTuple):
    """A store snapshot both packages' writers read (numpy fields)."""

    keys: np.ndarray
    actions: np.ndarray
    values: np.ndarray
    size: np.ndarray
    head: np.ndarray


def _snapshots(rng, capacity=32, d=21, inserts=(5, 20, 0, 31, 12, 30),
               sentinel_p=0.0):
    """Ring-store snapshots after each batch of ``inserts`` writes, and the
    batch sizes: the head wraps several times, never a whole ring between
    two snapshots."""
    keys = np.zeros((capacity, d), np.float32)
    actions = np.zeros(capacity, np.float32)
    values = np.zeros(capacity, np.float32)
    head, size, out = 0, 0, []
    for n in inserts:
        for _ in range(n):
            k = rng.normal(0, 30, d).astype(np.float32)
            k[-1] = rng.integers(0, 11)
            if rng.random() < sentinel_p:
                k[:] = tstore.SENTINEL_KEY
            keys[head], actions[head] = k, k[-1]
            values[head] = np.float32(rng.normal(0, 2))
            head = (head + 1) % capacity
            size = min(size + 1, capacity)
        out.append(Snap(keys.copy(), actions.copy(), values.copy(),
                        np.int32(size), np.int32(head)))
    return out, list(inserts)


def _spool_all(mod, tmp_path, tag, snaps, counts):
    sp = mod.StoreSpooler(str(tmp_path / f"{tag}_s.txt"),
                          str(tmp_path / f"{tag}_v.txt"))
    appended = [sp.spool(s, n_inserted=n) for s, n in zip(snaps, counts)]
    files = [open(p, "rb").read() for p in (sp.state_path, sp.value_path)]
    return appended, files, sp.total_spooled


@pytest.mark.parametrize("case", ["ring_wraps", "sentinel_rows", "inferred"])
def test_spooled_history_is_byte_identical(tmp_path, case):
    rng = np.random.default_rng(0)
    snaps, counts = _snapshots(rng, sentinel_p=0.3 if case == "sentinel_rows"
                               else 0.0)
    if case == "inferred":
        # inferred counts alias a whole-ring lap: no empty batch here
        snaps, _ = _snapshots(rng, inserts=(5, 20, 11, 31, 12))
        counts = [None] * len(snaps)
    got = _spool_all(tckpt, tmp_path, "port", snaps, counts)
    want = _spool_all(jckpt, tmp_path, "jax", snaps, counts)
    assert got[0] == want[0] and got[2] == want[2]
    assert got[1] == want[1]
    assert len(got[1][0]) > 0
    if case == "sentinel_rows":
        assert sum(got[0]) < sum(counts)


def test_whole_ring_wrap_raises_in_both(tmp_path):
    """Inferred mode: a whole-capacity lap leaves the head where it was;
    the content digest exposes it in both packages."""
    snaps, _ = _snapshots(np.random.default_rng(1), inserts=(7, 32))
    for mod, tag in ((tckpt, "port"), (jckpt, "jax")):
        sp = mod.StoreSpooler(str(tmp_path / f"{tag}_s"),
                              str(tmp_path / f"{tag}_v"))
        assert sp.spool(snaps[0]) == 7
        with pytest.raises(ValueError, match="whole multiple"):
            sp.spool(snaps[1])
        with pytest.raises(ValueError, match="exceed capacity"):
            sp.spool(snaps[1], n_inserted=33)


def test_export_store_text_is_byte_identical(tmp_path):
    rng = np.random.default_rng(2)
    keys = rng.normal(0, 100, (50, 21)).astype(np.float32)
    keys[3] = 1.0e9
    keys[4, :3] = [-0.0, 1 / 128, -5e-7]
    snap = Snap(keys, keys[:, -1].copy(), rng.normal(0, 3, 50).astype(
        np.float32), np.int32(41), np.int32(41))
    paths = {}
    for mod, tag in ((tckpt, "port"), (jckpt, "jax")):
        p = (str(tmp_path / f"{tag}_s"), str(tmp_path / f"{tag}_v"))
        mod.export_store_text(snap, *p)
        paths[tag] = [open(x, "rb").read() for x in p]
    assert paths["port"] == paths["jax"]
    # the port's store of tensors writes the same bytes
    tsnap = tstore.ConfidenceStore(*(torch.as_tensor(np.asarray(x))
                                     for x in snap))
    tckpt.export_store_text(tsnap, str(tmp_path / "t_s"), str(tmp_path / "t_v"))
    assert [open(str(tmp_path / x), "rb").read()
            for x in ("t_s", "t_v")] == paths["jax"]


def test_format_rows_matches_python_formatter():
    """Every float32 the integer path takes, and the ones it hands to the
    plain formatter (inf, nan, |x| >= 2^43)."""
    rng = np.random.default_rng(3)
    vals = np.concatenate([
        rng.normal(0, 5, 3000), rng.normal(0, 1e6, 300),
        rng.integers(-4000, 4000, 500) / 128.0,       # exact decimal ties
        rng.normal(0, 1e-5, 300), [1e9, -1e9, 8.7e12, -0.0, 0.0, 5e-7,
                                   1.5e-6, 2.5e-6, 1.4e-45, -1.2e-38]])
    a = vals.astype(np.float32)[-4095:].reshape(-1, 21)
    want = "".join(" ".join(f"{x:f}" for x in row) + "\n" for row in a)
    assert tckpt.format_rows(a) == want.encode()
    b = a[:4].copy()
    b[1, 2], b[2, 5], b[3, 0] = np.inf, np.nan, 3e20
    want = "".join(" ".join(f"{x:f}" for x in row) + "\n" for row in b)
    assert tckpt.format_rows(b) == want.encode()
    assert tckpt.format_rows(np.zeros((0, 21), np.float32)) == b""


@pytest.mark.parametrize("old,new,n,cap", [(0, 5, 5, 32), (30, 3, 5, 32),
                                           (7, 7, 0, 32), (31, 30, 31, 32)])
def test_ring_delta_slots_matches_jax(old, new, n, cap):
    np.testing.assert_array_equal(tckpt.ring_delta_slots(old, new, n, cap),
                                  jckpt.ring_delta_slots(old, new, n, cap))


@pytest.mark.parametrize("n_rows,capacity", [(40, 64), (50, 32)])
def test_import_store_text_matches_jax(tmp_path, n_rows, capacity):
    rng = np.random.default_rng(n_rows)
    keys = rng.normal(0, 20, (n_rows, 21)).astype(np.float32)
    snap = Snap(keys, keys[:, -1].copy(),
                rng.normal(0, 2, n_rows).astype(np.float32),
                np.int32(n_rows), np.int32(0))
    s, v = str(tmp_path / "s"), str(tmp_path / "v")
    tckpt.export_store_text(snap, s, v)
    got = tckpt.import_store_text(s, v, capacity, device="cpu")
    want = jckpt.import_store_text(s, v, capacity)
    for name in tstore.ConfidenceStore._fields:
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(want, name)), name)
    assert int(got.size) == min(n_rows, capacity)


@pytest.mark.parametrize("dims", [(0,), (0, 1)])
def test_active_region_mask_matches_jax(dims):
    rng = np.random.default_rng(len(dims))
    keys = rng.normal(0, 30, (5000, 21)).astype(np.float32)
    w = np.asarray(tcfg.DRIVING_HALF_WIDTHS, np.float32)
    center, radius = (3.0, -2.0)[:len(dims)], (25.0, 10.0)[:len(dims)]
    got = tstore.active_region_mask(keys, w, dims, center, radius)
    want = jstore.active_region_mask(keys, w, dims, center, radius)
    np.testing.assert_array_equal(got, want)
    assert 0 < got.sum() < len(got)


def _trainer():
    cfg = tcfg.DCARLConfig(dqn=tcfg.DQNConfig(batch_size=4,
                                              replay_capacity=64))
    return make_trainer_fast(cfg, batch_per_device=4,
                             store_capacity_per_device=64,
                             replay_capacity_per_device=64, device="cpu")


def _assert_trees_equal(a, b):
    fa, fb = tckpt.flatten(a), tckpt.flatten(b)
    assert fa.keys() == fb.keys()
    for k in fa:
        if isinstance(fa[k], torch.Tensor):
            assert fa[k].dtype == fb[k].dtype, k
            assert torch.equal(fa[k], fb[k]), k
        else:
            assert repr(fa[k]) == repr(fb[k]), k


def test_save_restore_round_trip_is_bit_equal(tmp_path):
    """A trained FastTrainState and its learner (weights, target, Adam
    moments and step) restore bit for bit into a fresh trainer."""
    init_fn, _, learner, factory = _trainer()
    state, _ = factory(5)(init_fn(seed=0), torch.Generator().manual_seed(1))
    saved = {"state": state, "learner": learner.state_dict()}
    path = tckpt.save(str(tmp_path / "ckpt"), 5, saved)
    assert path.endswith("step_0000000005")
    assert tckpt.latest_step(str(tmp_path / "ckpt")) == 5
    assert tckpt.latest_step(str(tmp_path / "none")) is None

    init2, _, learner2, _ = _trainer()
    template = {"state": init2(seed=3), "learner": learner2.state_dict()}
    restored = tckpt.restore(str(tmp_path / "ckpt"), 5, template)
    _assert_trees_equal(restored["state"], state)
    learner2.load_state_dict(restored["learner"])
    _assert_trees_equal(learner2.state_dict(), learner.state_dict())

    # load_or_init restores the latest step; a fresh directory inits
    got, step = tckpt.load_or_init(str(tmp_path / "ckpt"),
                                   lambda: {"state": init2(seed=4),
                                            "learner": learner2.state_dict()})
    assert step == 5
    _assert_trees_equal(got["state"], state)
    _, step = tckpt.load_or_init(str(tmp_path / "fresh"), init2, seed=0)
    assert step == 0

    # npz round trip of the tensors alone
    tckpt.save_npz(str(tmp_path / "s.npz"), state)
    _assert_trees_equal(tckpt.load_npz(str(tmp_path / "s.npz"),
                                       init2(seed=5)), state)
    with pytest.raises(ValueError):
        bad = state._replace(store_keys=state.store_keys[:, :3])
        tckpt.restore(str(tmp_path / "ckpt"), 5, {"state": bad,
                                                  "learner": saved["learner"]})


def test_jax_store_snapshot_fields_agree():
    """The JAX store type the spooler reads has the port's field order."""
    assert jstore.ConfidenceStore._fields == tstore.ConfidenceStore._fields
    s = jstore.store_init(4, 3)
    assert np.asarray(s.keys).shape == (4, 3) and jnp.asarray(s.head) == 0
