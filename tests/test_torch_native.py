"""The port's ctypes binding of the C++ host library
(``dcarl_tpu_torch/utils/native.py``) against the JAX package's
(``dcarl_tpu/utils/native.py``): every case of ``tests/test_native.py``
through both bindings, equal results; the box store against the port's
``box_query_stats``.  The port builds its own copy of the library into
``build/torch_host/``; a failed build raises."""

import shutil

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.utils import native as JNV
from dcarl_tpu_torch.core import store as S
from dcarl_tpu_torch.ops.geometry import (dense_polyline2d_np,
                                          project_point_to_polyline_np)
from dcarl_tpu_torch.utils import native as NV

CPU = "cpu"


@pytest.fixture(scope="module")
def libs():
    """(port library, JAX library); the test skips only without g++."""
    if shutil.which("g++") is None:
        pytest.skip("g++ not found: the host library cannot be built")
    port = NV.load_library()
    jax_lib = JNV.load_library()
    assert jax_lib is not None, "the JAX package's build failed"
    return port, jax_lib


def test_port_builds_its_own_library(libs):
    path = NV.lib_path()
    assert path.exists() and path.parent == NV.BUILD_DIR
    assert path.parent.name == "torch_host" and "csrc" not in path.parts
    assert libs[0]._name == str(path)


def test_failed_build_raises_with_the_compiler_output(libs, tmp_path,
                                                      monkeypatch):
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(NV, "SOURCE", bad)
    monkeypatch.setattr(NV, "BUILD_DIR", tmp_path / "build")
    with pytest.raises(RuntimeError, match="g\\+\\+ failed.*broken.cpp"):
        NV.build()
    assert not list((tmp_path / "build").iterdir())


def test_wrap_angle_native(libs):
    port, jax_lib = libs
    for th in [0.0, 3.1, -3.1, 9.0, -7.5]:
        got = port.dcarl_wrap_angle(th)
        assert got == jax_lib.dcarl_wrap_angle(th)
        want = (th + np.pi) % (2 * np.pi) - np.pi
        assert abs(got - want) < 1e-12


def test_dense_polyline_native_matches_jax_and_numpy(libs):
    rng = np.random.default_rng(0)
    line = np.cumsum(rng.normal(1.0, 0.3, (15, 2)), axis=0)
    got = NV.dense_polyline2d(line, 0.5)
    np.testing.assert_array_equal(got, JNV.dense_polyline2d(line, 0.5))
    want = dense_polyline2d_np(line, 0.5)
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, atol=1e-9)


def test_project_native_matches_jax_and_oracle(libs):
    rng = np.random.default_rng(1)
    for _ in range(25):
        n = rng.integers(3, 30)
        line = np.cumsum(rng.normal(1.0, 0.4, (n, 2)), axis=0)
        p = rng.normal(0, 2, 2) + line[rng.integers(0, n)]
        got = NV.project_point_to_polyline(p[0], p[1], line)
        assert got == JNV.project_point_to_polyline(p[0], p[1], line)
        want = project_point_to_polyline_np(p[0], p[1], line)
        assert got[1] == want[1] and got[2] == want[2]
        np.testing.assert_allclose([got[0], got[3], got[4]],
                                   [want[0], want[3], want[4]], atol=1e-9)


def test_boxstore_grid_matches_bruteforce_and_jax(libs):
    rng = np.random.default_rng(2)
    d = 5
    widths = np.asarray([1.0, 0.3, 2.0, 5.0, 0.1])
    port, jax_store = NV.HostBoxStore(widths), JNV.HostBoxStore(widths)
    for _ in range(500):
        key = rng.normal(0, 3, d)
        key[-1] = float(rng.integers(0, 8))
        value = rng.normal()
        assert port.insert(key, key[-1], value) == \
            jax_store.insert(key, key[-1], value)
    assert len(port) == len(jax_store) == 500
    matched = 0
    for _ in range(50):
        q = rng.normal(0, 3, d)
        q[-1] = float(rng.integers(0, 8))
        fast, slow = port.query(q), port.query(q, exact=True)
        assert fast == jax_store.query(q)
        assert slow == jax_store.query(q, exact=True)
        assert fast[0] == slow[0]
        np.testing.assert_allclose(fast[1:], slow[1:], atol=1e-12)
        matched += fast[0] > 0
    assert matched > 0
    with pytest.raises(ValueError):
        port.query(np.zeros(d - 1))


@pytest.mark.parametrize("use_kernel", [False, True],
                         ids=["raw_moments", "sorted_plain"])
def test_boxstore_matches_port_store(libs, use_kernel):
    """Host index and the port's device store agree: counts exactly,
    means and variances at MOMENT_TOL (the -1 sentinels included)."""
    rng = np.random.default_rng(3)
    d = 4
    widths = np.asarray([1.0, 1.0, 1.0, 0.1])
    host = NV.HostBoxStore(widths)
    keys = rng.normal(0, 2, (120, d))
    keys[:, -1] = 0.0
    vals = rng.normal(0, 1, 120)
    for i in range(120):
        host.insert(keys[i], 0.0, vals[i])
    dev = S.store_insert(S.store_init(256, d, device=CPU),
                         torch.as_tensor(keys, dtype=torch.float32),
                         torch.zeros(120),
                         torch.as_tensor(vals, dtype=torch.float32),
                         torch.ones(120, dtype=torch.bool))
    queries = rng.normal(0, 2, (20, d))
    queries[:, -1] = 0.0
    stats = S.box_query_stats(dev, torch.as_tensor(queries, dtype=torch.float32),
                              torch.as_tensor(widths, dtype=torch.float32),
                              use_kernel=use_kernel)
    got = np.array([host.query(q) for q in queries])
    np.testing.assert_array_equal(got[:, 0], stats.count.numpy())
    np.testing.assert_allclose(got[:, 1], stats.mean.numpy(), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_allclose(got[:, 2], stats.var.numpy(), rtol=1e-4,
                               atol=1e-3)
    assert (got[:, 0] > 0).any() and (got[:, 0] == 0).any()


def test_boxstore_save_load_matches_jax(libs, tmp_path):
    widths = np.asarray([0.5, 0.5])
    store = NV.HostBoxStore(widths)
    store.insert(np.asarray([1.0, 2.0]), 1.0, 3.0)
    store.insert(np.asarray([4.0, 5.0]), 0.0, -1.0)
    path = str(tmp_path / "store.bin")
    store.save(path)
    for mod in (NV, JNV):
        back = mod.HostBoxStore.load(path)
        assert len(back) == 2
        np.testing.assert_array_equal(back.widths, widths)
        cnt, mean, var = back.query(np.asarray([1.1, 2.1]))
        assert cnt == 1 and mean == pytest.approx(3.0)
    jpath = str(tmp_path / "jax_store.bin")
    JNV.HostBoxStore.load(path).save(jpath)
    assert open(jpath, "rb").read() == open(path, "rb").read()


def test_record_log_roundtrip_matches_jax(libs, tmp_path):
    rows = np.arange(12.0).reshape(3, 4)
    files = []
    for mod, name in ((NV, "port"), (JNV, "jax")):
        path = str(tmp_path / f"{name}.bin")
        log = mod.RecordLog(path, width=4)
        log.append(rows)
        log.append(np.asarray([100.0, 101.0, 102.0, 103.0]))
        log.flush()
        log.close()
        files.append(open(path, "rb").read())
        back = NV.RecordLog.read(path, 4)
        np.testing.assert_array_equal(back, JNV.RecordLog.read(path, 4))
        assert back.shape == (4, 4)
        np.testing.assert_array_equal(back[:3], rows)
    assert files[0] == files[1]
    with pytest.raises(ValueError):
        NV.RecordLog(str(tmp_path / "w.bin"), width=4).append(np.zeros(3))


def test_async_log_writer_matches_jax(libs, tmp_path):
    outs = []
    for mod, name in ((NV, "port"), (JNV, "jax")):
        path = str(tmp_path / f"{name}.txt")
        with mod.AsyncLogWriter(path) as w:
            for i in range(500):
                w.append(f"row {i}, value {i * 0.5}")
            w.flush()
            assert w.lines_written == 500
        with mod.AsyncLogWriter(path) as w:   # append mode across reopen
            w.append("tail")
        outs.append(open(path, "rb").read())
    assert outs[0] == outs[1]
    lines = outs[0].decode().splitlines()
    assert len(lines) == 501 and lines[0] == "row 0, value 0.0"
    assert lines[499] == "row 499, value 249.5" and lines[-1] == "tail"


def test_npy_mmap_roundtrip_matches_jax(libs, tmp_path):
    arrays = [(np.arange(60).reshape(3, 4, 5) % 250).astype(dt)
              for dt in (np.float32, np.float64, np.int32, np.int64,
                         np.uint8)]
    arrays.append(np.random.default_rng(0).normal(size=(17,)))
    for i, arr in enumerate(arrays):
        p = str(tmp_path / f"a{i}.npy")
        np.save(p, arr)
        back = NV.npy_mmap(p)
        assert back.dtype == arr.dtype and back.shape == arr.shape
        np.testing.assert_array_equal(back, arr)
        np.testing.assert_array_equal(back, JNV.npy_mmap(p))
    with pytest.raises(IOError):
        NV.npy_mmap(str(tmp_path / "missing.npy"))


def test_npy_stream_chunks_match_jax(libs, tmp_path):
    rng = np.random.default_rng(1)
    data = rng.normal(size=(1003, 4)).astype(np.float64)
    p = str(tmp_path / "data.npy")
    np.save(p, data)
    chunks = {}
    for mod in (NV, JNV):
        with mod.NpyStream(p, chunk_rows=100, n_buffers=3) as s:
            assert s.total_rows == 1003 and s.row_bytes == 32
            assert s.dtype == np.float64 and s.row_shape == (4,)
            chunks[mod] = list(s)
    assert [len(c) for c in chunks[NV]] == [100] * 10 + [3]
    for a, b in zip(chunks[NV], chunks[JNV]):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(np.concatenate(chunks[NV]), data)
