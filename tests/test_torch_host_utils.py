"""The port's host utilities against the JAX package's: the monitor,
field-log analysis and visualization cases of ``tests/test_aux.py`` and
the ``MetricsLogger`` / ``EpisodeStats`` cases of ``tests/test_utils.py``
run through both packages.  Outputs and written files are byte-equal;
the figures (PNG) need only exist."""

import dataclasses
import os

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.utils import field_analysis as JFA
from dcarl_tpu.utils import logging as JL
from dcarl_tpu.utils import monitor as JM
from dcarl_tpu.utils import visualize as JV
from dcarl_tpu_torch.utils import field_analysis as PFA
from dcarl_tpu_torch.utils import logging as PL
from dcarl_tpu_torch.utils import monitor as PM
from dcarl_tpu_torch.utils import visualize as PV
from torch_scenarios import synthetic_scenario


def _snapshot(statuses: dict) -> dict:
    return {k: dict(dataclasses.asdict(v), status=v.status.name)
            for k, v in statuses.items()}


# ---------------------------------------------------------------- monitor

def _status_transitions(mod):
    t = [0.0]
    mon = mod.Monitor(clock=lambda: t[0])
    mon.register("cognition", rate_hz=20.0)   # period 0.05
    mon.beat("cognition")
    seen = [_snapshot(mon.check())]
    for dt in (0.06 * 1.6, 1.0):
        t[0] += dt
        seen.append(_snapshot(mon.check()))
    mon.beat("cognition")
    seen.append(_snapshot(mon.check()))
    return seen, mon.healthy()


def _guard_counts_and_reraises(mod):
    mon = mod.Monitor(clock=lambda: 0.0)
    mon.register("planner", rate_hz=5.0)
    for _ in range(2):
        with mon.guard("planner", reraise_after=3):
            raise RuntimeError("boom")
    seen = [_snapshot(mon.check())]
    with pytest.raises(RuntimeError):
        with mon.guard("planner", reraise_after=3):
            raise RuntimeError("boom")
    with mon.guard("planner"):
        pass
    seen.append(_snapshot(mon.check()))
    return seen


def _fallback_degrades_to_rule(mod):
    mon = mod.Monitor(clock=lambda: 0.0)

    def rl(state):
        raise ConnectionError("agent down")

    fn = mod.with_fallback(rl, lambda state: 0, monitor=mon, name="rl")
    return fn([1.0, 2.0]), _snapshot(mon.check())


@pytest.mark.parametrize("case", [_status_transitions,
                                  _guard_counts_and_reraises,
                                  _fallback_degrades_to_rule],
                         ids=lambda f: f.__name__.strip("_"))
def test_monitor_matches_jax(case):
    got, want = case(PM), case(JM)
    assert got == want
    if case is _status_transitions:
        assert [s["cognition"]["status"] for s in got[0][:4]] == \
            ["OK", "WARN", "STALE", "OK"] and got[1]
    if case is _guard_counts_and_reraises:
        assert got[0]["planner"]["status"] == "ERROR"
        assert got[0]["planner"]["failure_count"] == 2
        assert got[1]["planner"]["status"] == "OK"
    if case is _fallback_degrades_to_rule:
        assert got[0] == 0 and got[1]["rl"]["failure_count"] == 1


# --------------------------------------------------------- field analysis

def _assert_same_analysis(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        if k == "channels":
            for c in want[k]:
                np.testing.assert_array_equal(got[k][c], want[k][c])
        else:
            assert got[k] == want[k], k


@pytest.mark.parametrize("window", [None, (1002.0, 1008.0)])
def test_field_analysis_synthetic_matches_jax(tmp_path, window):
    d = synthetic_scenario(str(tmp_path / "scen"))
    tmin, tmax = window or (None, None)
    a = PFA.analyze_scenario(d, tmin, tmax)
    _assert_same_analysis(a, JFA.analyze_scenario(d, tmin, tmax))
    if window is None:
        assert a["distance_m"] == pytest.approx(30.0, abs=1e-6)
        assert a["auto_mode_fraction"] == pytest.approx(0.75)
        assert a["steering_abs_max"] == pytest.approx(100.0)
        figs = PFA.plot_scenario(d, str(tmp_path / "scen"))
        assert os.path.exists(figs["control"])
        assert os.path.exists(figs["trajectory"])


def test_unwrap_and_lowess_match_jax():
    raw = np.array([0.0, 520.0, 65536.0 - 520.0, 65016.0, 65535.0])
    np.testing.assert_array_equal(PFA.unwrap_steering(raw),
                                  JFA.unwrap_steering(raw))
    rng = np.random.default_rng(0)
    y = np.sin(np.linspace(0, 3, 300)) + rng.normal(0, 0.2, 300)
    for frac in (0.05, 0.2):
        np.testing.assert_array_equal(PFA.lowess(y, frac), JFA.lowess(y, frac))
    xy = rng.normal(0, 1, (40, 2))
    assert PFA.path_length(xy) == JFA.path_length(xy)
    sm = PFA.lowess(y, frac=0.2)
    truth = np.sin(np.linspace(0, 3, 300))
    assert np.abs(sm - truth).mean() < np.abs(y - truth).mean() * 0.5


REF_SCEN = "/root/reference/Field_testing/Scenario1"


def test_field_analysis_reference_scenario1():
    if not os.path.isdir(REF_SCEN):
        pytest.skip("reference field logs not mounted")
    a = PFA.analyze_scenario(REF_SCEN)
    _assert_same_analysis(a, JFA.analyze_scenario(REF_SCEN))
    assert a["steering_abs_max"] <= 520.0


# ------------------------------------------------------------- visualize

def _markers(mod):
    objs = [dict(x=0, y=0, yaw=0.3, vx=3, vy=0, cls="car", uid=7),
            dict(x=5, y=2, cls="pedestrian")]
    markers = mod.object_markers(objs)
    paths = np.stack([np.c_[np.linspace(0, 10, 8),
                            np.full(8, d)] for d in (-2.0, 0.0, 2.0)])
    markers += mod.trajectory_markers(paths, costs=np.array([3.0, 1.0, 2.0]),
                                      chosen=1)
    markers += mod.trajectory_markers(paths)
    markers += mod.lane_markers([paths[0], paths[2]])
    return markers


def test_markers_and_render_match_jax(tmp_path):
    got, want = _markers(PV), _markers(JV)
    assert got == want
    assert {"box", "label", "centroid", "arrow"} <= {m["type"] for m in got}
    pp, jp = str(tmp_path / "port.json"), str(tmp_path / "jax.json")
    PV.save_markers(pp, got)
    JV.save_markers(jp, want)
    assert open(pp, "rb").read() == open(jp, "rb").read()
    assert PV.load_markers(pp) == JV.load_markers(jp)
    out = PV.render(got, out_path=str(tmp_path / "scene.png"), title="t")
    assert os.path.exists(out)


# ------------------------------------------------------------- logging

def _log(mod, path, value):
    csv_path, jsonl_path = path + ".csv", path + ".jsonl"
    lg = mod.MetricsLogger([mod.CSVWriter(csv_path),
                            mod.JSONLWriter(jsonl_path)])
    lg.logkv("a", value(1.0))
    lg.logkv_mean("b", value(2.0))
    lg.logkv_mean("b", value(4.0))
    first = lg.dumpkvs()
    lg.logkv("a", 2.0)
    lg.logkv("c", 7)  # schema growth
    second = lg.dumpkvs()
    lg.close()
    return first, second, open(csv_path, "rb").read(), \
        open(jsonl_path, "rb").read()


def test_metrics_logger_csv_jsonl_match_jax(tmp_path):
    want = _log(JL, str(tmp_path / "jax"), float)
    assert _log(PL, str(tmp_path / "port"), float) == want
    # the port's logger takes torch scalars as they come off the card
    got = _log(PL, str(tmp_path / "torch"),
               lambda v: torch.tensor(v, dtype=torch.float64))
    assert got == want
    assert want[0]["b"] == pytest.approx(3.0)
    assert b"7" in want[2].splitlines()[2]


def test_human_writer_matches_jax():
    import io

    kvs = {"loss": 0.123456789, "ticks": 200, "name": "x"}
    outs = []
    for mod in (PL, JL):
        s = io.StringIO()
        mod.HumanWriter(s).writekvs(kvs)
        outs.append(s.getvalue())
    assert outs[0] == outs[1] and "0.12346" in outs[0]


def test_episode_stats_match_jax(tmp_path):
    steps = [(np.zeros(4, bool),) * 3,
             (np.asarray([True, True, False, True]),
              np.asarray([True, False, False, False]),
              np.asarray([False, True, False, False])),
             (np.asarray([True, False]), np.asarray([False, False]),
              np.asarray([True, False]))]
    rows = {}
    for name, mod in (("port", PL), ("jax", JL)):
        es = mod.EpisodeStats(str(tmp_path / f"{name}.txt"))
        rows[name] = [es.update(*s) for s in steps]
    assert rows["port"] == rows["jax"]
    assert rows["port"][0] is None and rows["port"][1]["task_num"] == 3
    assert rows["port"][1]["pass_rate"] == pytest.approx(1 / 3)
    assert (tmp_path / "port.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()
    args = (np.arange(3.0), 2, 0.5, True, (3, -0.2, 0.01), (0, -1, -1))
    np.testing.assert_array_equal(PL.driving_record_row(*args),
                                  JL.driving_record_row(*args))
