"""The yardstick on hand-made inputs: the roofline arithmetic, the trace
reader on a small synthetic Chrome trace, and the per-layer readers."""

from __future__ import annotations

import json

import pytest
import torch

from dcarl_bench import roofline, spec
from dcarl_bench import trace as T
from dcarl_bench.reference import store as R

PEAK = dict(hbm_bytes_per_s=1e12, f64_flops_per_s=1e12, f32_flops_per_s=2e12)


def test_query_bound_bytes_and_operations():
    # 1,000 rows of 21 floats and a value, 100 queries of 20 floats,
    # 1,100 answers of 3 floats: 4 * (22,000 + 2,000 + 3,300) bytes
    b = roofline.query_bound(1000, 21, 100, 20, 1100, 10, "f64", PEAK)
    assert b["bytes_s"] == pytest.approx(4 * 27300 / 1e12)
    assert b["ops_s"] == pytest.approx(40 / 1e12)
    assert b["binds"] == "bytes" and b["bound_s"] == b["bytes_s"]
    b = roofline.query_bound(1000, 21, 100, 20, 1100, 1e9, "f64", PEAK)
    assert b["binds"] == "operations" and b["bound_s"] == pytest.approx(4e-3)
    assert roofline.share_pct(2e-3, 4e-3) == pytest.approx(50.0)
    assert roofline.peaks()["hbm_bytes_per_s"] == 3.35e12


def test_matched_triples_of_a_hand_made_store():
    """Counts of a store whose matches are known: the triples that the
    roofline's operations are counted from."""
    hw = torch.tensor([1.0, 1.0, 0.1])
    keys = torch.tensor([[0.0, 0.0, 0.0], [0.5, 0.5, 0.0], [0.5, 0.5, 1.0],
                         [3.0, 0.0, 1.0], [0.0, 0.9, 2.0], [0.0, 0.0, 1.4]])
    values = torch.tensor([1.0, 2.0, -3.0, 4.0, 5.0, 6.0])
    valid = torch.tensor([True, True, True, True, True, False])
    obs = torch.tensor([[0.0, 0.0], [3.0, 0.5]])
    m = R.box_moments(keys, values, valid, obs, hw, 3)
    assert m[..., 0].tolist() == [[2, 1, 1], [0, 1, 0]]
    assert m[0, 0, 1:].tolist() == [3.0, 5.0, 3.0]
    assert m[0, 1, 1:].tolist() == [-3.0, 9.0, 3.0]
    assert float(m[..., 0].sum()) == 5
    flat = R.box_moments(keys, values, valid,
                         torch.tensor([[0.0, 0.0, 0.0]]), hw)
    assert flat[0].tolist() == [2.0, 3.0, 5.0, 3.0]


def test_tf32_rounds_to_ten_mantissa_bits():
    x = torch.tensor([1.0 + 2 ** -10, 1.0 + 2 ** -11, 1.0 + 3 * 2 ** -11,
                      -(1.0 + 2 ** -12), 3.0])
    assert R.tf32(x).tolist() == [1.0 + 2 ** -10, 1.0, 1.0 + 2 ** -9, -1.0,
                                  3.0]


def _trace():
    """A window of two graph launches on one stream, a copy and a kernel
    launched outside the graphs, with host events around the gaps."""
    def x(cat, name, ts, dur, **args):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur,
                "args": args}

    return [
        x("user_annotation", "dcarl_bench_traced", 0.0, 100.0),
        x("cuda_runtime", "cudaGraphLaunch", 1.0, 2.0, correlation=7),
        x("cuda_runtime", "cudaGraphLaunch", 40.0, 2.0, correlation=9),
        x("cuda_runtime", "cudaLaunchKernel", 70.0, 1.0, correlation=11),
        x("cpu_op", "aten::copy_", 60.0, 10.0),
        x("kernel", "peraction_main<...>", 5.0, 10.0, correlation=7),
        x("kernel", "elementwise", 12.0, 8.0, correlation=7),   # overlaps
        x("kernel", "peraction_sum", 45.0, 5.0, correlation=9),
        x("gpu_memcpy", "Memcpy DtoD", 55.0, 5.0, correlation=10),
        x("kernel", "other", 72.0, 8.0, correlation=11),
        x("kernel", "outside", 150.0, 8.0, correlation=12),
        x("gpu_user_annotation", "dcarl_bench_traced", 0.0, 100.0),
    ]


def test_trace_summary_of_a_synthetic_trace(tmp_path):
    path = tmp_path / "t.json"
    path.write_text(json.dumps({"traceEvents": _trace()}))
    s = T.summarize(T.load_events(str(path)), "dcarl_bench_traced")
    assert s["replays"] == 2 and s["replay_kernels"] == 3
    assert s["replay_kernel_s"]["peraction_main<...>"] == pytest.approx(1e-5)
    assert T.kernel_seconds(s, ("peraction_main", "peraction_sum")) == \
        pytest.approx(1.5e-5)
    # busy: [5, 20) merged, [45, 50), [55, 60), [72, 80): 33 us of 100
    assert s["busy_s"] == pytest.approx(33e-6)
    assert s["window_s"] == pytest.approx(100e-6)
    gaps = dict(s["idle_gaps"])
    assert gaps["aten::copy_"] == pytest.approx(12e-6)        # 60 .. 72
    assert gaps["idle host"] == pytest.approx(55e-6)    # nothing at starts
    assert sum(gaps.values()) == pytest.approx(67e-6)
    assert dict(s["device_ops"])["Memcpy DtoD"] == pytest.approx(5e-6)
    assert T.summarize(_trace(), "no such window") == {}


def test_readers_on_a_synthetic_trace():
    s = T.summarize(_trace(), "dcarl_bench_traced")
    measured = dict(trace=s, kernels=dict(peraction=("peraction_main",
                                                     "peraction_sum")),
                    counters=dict(matched=2e6, ticks=2, rows=1000, key_dim=21,
                                  queries=100, query_dim=20, answers=1100),
                    spans=dict(store_fill_s=1.5))
    read = {m: spec.metric_reader(m)(measured) for m in (
        "kernels_per_tick.gated", "device_idle_pct.gated",
        "peraction_ms_per_tick", "peraction_moments_roofline",
        "store_fill_s")}
    assert read["kernels_per_tick.gated"] == 1.5
    assert read["device_idle_pct.gated"] == pytest.approx(67.0)
    assert read["peraction_ms_per_tick"] == pytest.approx(7.5e-3)
    one = roofline.query_bound(1000, 21, 100, 20, 1100, 1e6, "f64",
                               roofline.peaks())
    assert read["peraction_moments_roofline"] == pytest.approx(
        100 * 2 * one["bound_s"] / 1.5e-5)
    assert read["store_fill_s"] == 1.5
    assert spec.metric_reader("sorted_moments_roofline")(measured) is None
