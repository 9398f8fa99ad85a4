"""The port's entry points (``dcarl_tpu_torch/examples/``,
``dcarl_tpu_torch/tools/``) against the JAX package's CLIs, on the CPU.

* Arguments: the JAX CLI (loaded from ``examples/`` with ``importlib``,
  ``sys.argv`` patched) and the port's ``main`` take the same argv, and
  their callees (``run_improvement`` / ``run_improvement_suite``,
  ``collect_local_records`` / ``run_vehicle_life``,
  ``make_trainer_fast``) receive the same arguments, configs field by
  field; only the kernel switch (``use_pallas`` / ``use_kernel``) and the
  port's ``device`` and ``mesh`` differ by design.
* Runs: each port CLI runs once for real at tiny widths, writing into
  the test's directory; no default output path names a file the
  repository keeps.
* Golden demos on generated datasets in the reference's layout: the
  port's printed decisions, activation steps and overall value equal
  JAX's, in float64 (values to rtol 1e-12).
* Field replay on a synthetic scenario: the port's per-tick decisions
  equal JAX's ``decide_all`` on the same frames (lanes exact, speeds
  rtol 1e-5, the RL state rtol 1e-5 / atol 1e-4).
"""

import dataclasses
import importlib
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu_torch import cli
from torch_algos_jax import one_torch_thread  # noqa: F401 (fixture)
from torch_scenarios import demo_datasets, synthetic_scenario

ROOT = Path(__file__).resolve().parent.parent
CPU = ["--device", "cpu"]
PORT_ENTRY_POINTS = (
    "bench", "examples.bench_store", "examples.bench_scaling",
    "examples.profile_step", "tools.bench_store_scale",
    "examples.run_improvement", "examples.run_vehicle_life",
    "examples.train_multihost", "examples.run_rollout",
    "examples.run_simulation1", "examples.run_simulation2",
    "examples.run_field_replay")


def port(name):
    return importlib.import_module("dcarl_tpu_torch." + name)


def jax_cli(name):
    """The JAX package's ``examples/<name>.py`` as a fresh module."""
    spec = importlib.util.spec_from_file_location(
        f"jax_examples_{name}", ROOT / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class _Stop(Exception):
    pass


def recorder(fn, calls, result=None):
    """A stand-in for ``fn`` that records its bound arguments, then
    returns ``result`` (or stops the CLI when it is None)."""
    sig = inspect.signature(fn)

    def fake(*args, **kwargs):
        bound = sig.bind(*args, **kwargs)
        bound.apply_defaults()
        calls.append((fn.__name__, dict(bound.arguments)))
        if result is None:
            raise _Stop
        return result
    return fake


# Arguments that differ by design: the kernel switches, the port's
# device and mesh, JAX's mesh and its axis.
BY_DESIGN = {"use_pallas", "pallas_interpret", "use_kernel", "device",
             "mesh", "axis"}


def _normal(v):
    if isinstance(v, torch.dtype):
        return str(v).removeprefix("torch.")
    if isinstance(v, type) and hasattr(v, "dtype"):        # jnp.float32
        return np.dtype(v).name
    if dataclasses.is_dataclass(v) and not isinstance(v, type):
        return dataclasses.asdict(v)
    if isinstance(v, tuple):
        return tuple(_normal(x) for x in v)
    if isinstance(v, np.ndarray):
        return v.tolist()
    return v


def _same_calls(jax_calls, port_calls):
    assert [n for n, _ in port_calls] == [n for n, _ in jax_calls]
    for (name, j), (_, p) in zip(jax_calls, port_calls):
        keys = (set(j) | set(p)) - BY_DESIGN
        for k in sorted(keys):
            assert k in j and k in p, f"{name}: {k} on one side only"
            assert _normal(p[k]) == _normal(j[k]), f"{name}.{k}"


def _run_jax(monkeypatch, name, argv):
    mod = jax_cli(name)
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    with pytest.raises(_Stop):
        mod.main()


def _run_port(name, argv):
    with pytest.raises(_Stop):
        port("examples." + name).main([*argv, *CPU])


@pytest.mark.parametrize("argv", [[], ["--smoke"], ["--suite"],
                                  ["--smoke", "--suite", "--seed", "3"]],
                         ids=["default", "smoke", "suite", "smoke_suite"])
def test_run_improvement_arguments_match_jax(argv, tmp_path, monkeypatch):
    import dcarl_tpu.improvement as JI

    argv = argv + ["--out", str(tmp_path / "imp"),
                   "--session-root", str(tmp_path / "sessions")]
    jcalls, pcalls = [], []
    for fn in ("run_improvement", "run_improvement_suite"):
        monkeypatch.setattr(JI, fn, recorder(getattr(JI, fn), jcalls))
    _run_jax(monkeypatch, "run_improvement", argv)
    mod = port("examples.run_improvement")
    for fn in ("run_improvement", "run_improvement_suite"):
        monkeypatch.setattr(mod, fn, recorder(getattr(mod, fn), pcalls))
    _run_port("run_improvement", argv)
    _same_calls(jcalls, pcalls)


@pytest.mark.parametrize("argv", [[], ["--smoke"],
                                  ["--envs", "512", "--chunks", "7",
                                   "--local-rows", "99", "--offsets", "5"]],
                         ids=["default", "smoke", "flags"])
def test_run_vehicle_life_arguments_match_jax(argv, tmp_path, monkeypatch):
    import dcarl_tpu.workingset as JW

    history = (np.zeros((3, 21), np.float32), np.ones(3, np.float32))
    jcalls, pcalls = [], []
    monkeypatch.setattr(JW, "collect_local_records",
                        recorder(JW.collect_local_records, jcalls, history))
    monkeypatch.setattr(JW, "run_vehicle_life",
                        recorder(JW.run_vehicle_life, jcalls))
    _run_jax(monkeypatch, "run_vehicle_life", argv)
    WS = port("workingset")
    monkeypatch.setattr(WS, "collect_local_records",
                        recorder(WS.collect_local_records, pcalls, history))
    monkeypatch.setattr(WS, "run_vehicle_life",
                        recorder(WS.run_vehicle_life, pcalls))
    _run_port("run_vehicle_life", argv)
    _same_calls(jcalls, pcalls)


@pytest.mark.parametrize("argv", [[], ["--smoke"],
                                  ["--batch-per-device", "64",
                                   "--store-capacity", "4096", "--seed", "2"]],
                         ids=["default", "smoke", "flags"])
def test_train_multihost_arguments_match_jax(argv, monkeypatch):
    import dcarl_tpu.train_fast as JT

    monkeypatch.delenv("DCARL_NUM_PROCESSES", raising=False)
    jcalls, pcalls = [], []
    monkeypatch.setattr(JT, "make_trainer_fast",
                        recorder(JT.make_trainer_fast, jcalls))
    _run_jax(monkeypatch, "train_multihost", argv)
    mod = port("examples.train_multihost")
    monkeypatch.setattr(mod, "make_trainer_fast",
                        recorder(mod.make_trainer_fast, pcalls))
    _run_port("train_multihost", argv)
    _same_calls(jcalls, pcalls)
    assert pcalls[0][1]["mesh"].size == 1


# ----------------------------------------------------------------- runs


def _lines(capsys):
    return capsys.readouterr().out.splitlines()


def test_bench_store_runs(capsys, one_torch_thread):
    assert port("examples.bench_store").main(
        ["--rows", "1024", "2048", "--queries", "64", "--inner", "1",
         *CPU]) == 0
    out = _lines(capsys)
    assert len(out) == 4 and out[0].startswith("N=1024: brute ")
    assert out[1].startswith("  1/8-full store: sorted ")


def test_bench_scaling_runs(capsys, monkeypatch, one_torch_thread):
    monkeypatch.delenv("DCARL_NUM_PROCESSES", raising=False)
    assert port("examples.bench_scaling").main(
        ["--batch-per-device", "4", "--steps", "3", *CPU]) == 0
    line = json.loads(_lines(capsys)[-1])
    assert line["devices"] == 1 and line["efficiency"] == 1.0
    assert line["steps_per_s_1dev"] > 0 and line["backend"] == "cpu"


def test_profile_step_prints_its_five_rows(capsys, one_torch_thread):
    assert port("examples.profile_step").main(["4", "2", *CPU]) == 0
    out = _lines(capsys)
    assert out[0] == "backend=cpu B=4 S=2" and len(out) == 6
    names = ("env physics only", "frenet projection only", "lattice only",
             "full plan (incl collision)", "controller only")
    for line, name in zip(out[1:], names):
        assert line.startswith(name) and line.endswith("k env-steps/s")
        assert float(line[28:].split()[0]) > 0


def test_bench_store_scale_runs(tmp_path, capsys, one_torch_thread):
    out = tmp_path / "scale.json"
    assert port("tools.bench_store_scale").main(
        ["--sizes", "1024", "2048", "--gated-sizes", "1024", "--out",
         str(out), *CPU]) == 0
    res = json.loads(out.read_text())
    assert [r["rows"] for r in res["kernel"]] == [1024, 2048]
    assert [r["rows"] for r in res["gated"]] == [1024]
    assert all(r["parity_checked"] for r in res["kernel"] + res["gated"])
    assert res["backend"] == "cpu" and res["device"] is None


def test_run_improvement_smoke_runs(tmp_path, capsys, monkeypatch,
                                    one_torch_thread):
    mod = port("examples.run_improvement")
    monkeypatch.setattr(mod, "SMOKE", dict(
        batch=8, train_steps=20, chunk=10, store_capacity=1 << 10,
        eval_envs=8, eval_steps=20))
    assert mod.main(["--smoke", "--out", str(tmp_path / "imp"), *CPU]) == 0
    rep = json.loads((tmp_path / "imp.json").read_text())
    line = json.loads(_lines(capsys)[0])
    assert line["store_rows"] == rep["train"]["store_rows"] > 0
    assert rep["train"]["history"]["step"] == [10, 20]


def test_run_vehicle_life_smoke_runs(tmp_path, capsys, monkeypatch,
                                     one_torch_thread):
    mod = port("examples.run_vehicle_life")
    monkeypatch.setattr(mod, "SMOKE_COLLECT",
                        dict(n_envs=16, n_steps=300, seed=3))
    monkeypatch.setattr(mod, "SMOKE_LIFE", dict(
        n_envs=8, chunk_steps=5, n_chunks=4, n_offsets=3,
        cache_capacity=1 << 10, recenter_margin=6.0, checkpoints=1,
        checkpoint_queries=8))
    monkeypatch.chdir(tmp_path)
    assert mod.main(["--smoke", *CPU]) == 0
    rep = json.loads(capsys.readouterr().out)
    assert "timeline" not in rep and rep["history_rows"] > 0
    assert list(tmp_path.iterdir()) == []          # --smoke writes nothing


def test_train_multihost_smoke_runs(capsys, monkeypatch, one_torch_thread):
    monkeypatch.delenv("DCARL_NUM_PROCESSES", raising=False)
    assert port("examples.train_multihost").main(["--smoke", *CPU]) == 0
    lines = [json.loads(s) for s in _lines(capsys)]
    assert [x["step"] for x in lines] == [4, 8]
    assert all(x["processes"] == 1 and x["devices"] == 1 for x in lines)
    assert all(np.isfinite(x["loss"]) for x in lines)


@pytest.mark.parametrize("extra", [["--device", "cpu"],
                                   ["--cpu", "--readable"]],
                         ids=["fast", "readable_cpu_alias"])
def test_run_rollout_runs(extra, capsys, one_torch_thread):
    assert port("examples.run_rollout").main(
        ["--envs", "4", "--steps", "40", *extra]) == 0
    out = _lines(capsys)
    assert out[0].startswith("4 envs x 40 steps in ")
    assert out[1].startswith("episodes: ")


# ------------------------------------------------------------ golden demos


@pytest.fixture(scope="module")
def reference_root(tmp_path_factory):
    return str(demo_datasets(tmp_path_factory.mktemp("reference")))


def _jax_demo_output(name, root, monkeypatch, capsys):
    import dcarl_tpu.data.datasets as JD

    monkeypatch.setattr(JD, "DEFAULT_ROOT", root)
    monkeypatch.setattr(sys, "argv", [f"{name}.py"])
    jax_cli(name).main()
    return _lines(capsys)


def test_simulation1_matches_jax(reference_root, monkeypatch, capsys):
    want = _jax_demo_output("run_simulation1", reference_root, monkeypatch,
                            capsys)
    assert port("examples.run_simulation1").main(
        ["--root", reference_root, *CPU]) == 0
    got = _lines(capsys)
    assert len(got) == len(want) == 11
    assert got[-1] == want[-1] and want[-1].startswith("activation step: ")
    for g, w in zip(got[:-1], want[:-1]):
        gk, ga, gv, gt = g.split()
        wk, wa, wv, wt = w.split()
        assert (gk, ga) == (wk, wa)
        np.testing.assert_allclose([float(gv), float(gt)],
                                   [float(wv), float(wt)], rtol=1e-12)


def test_simulation2_matches_jax(reference_root, monkeypatch, capsys):
    want = _jax_demo_output("run_simulation2", reference_root, monkeypatch,
                            capsys)
    assert port("examples.run_simulation2").main(
        ["--root", reference_root, *CPU]) == 0
    got = _lines(capsys)
    assert got[:2] == want[:2]        # data volumes, activation steps
    steps = json.loads(got[1].split(":", 1)[1])
    assert min(steps) == -1 and max(steps) > 0   # some states activate
    np.testing.assert_allclose(float(got[2].split(":")[1]),
                               float(want[2].split(":")[1]), rtol=1e-12)


def test_simulation_plots_go_to_the_out_dir(reference_root, tmp_path):
    for name in ("run_simulation1", "run_simulation2"):
        assert port("examples." + name).main(
            ["--root", reference_root, "--plot", "--out-dir", str(tmp_path),
             "--cpu"]) == 0
    assert sorted(p.name for p in tmp_path.iterdir()) == [
        "simulation1_confidence_curve.png", "simulation2_panel_1.png",
        "simulation2_panel_2.png", "simulation2_panel_3.png",
        "simulation2_panel_4.png"]


# ------------------------------------------------------------- field replay


def test_field_replay_decisions_match_jax(tmp_path):
    import jax

    scen = synthetic_scenario(str(tmp_path / "scen"))
    mod = port("examples.run_field_replay")
    jmod = jax_cli("run_field_replay")
    frames = mod.build_frames(scen, stride=2)
    jframes = jmod.build_frames(scen, stride=2)
    for k in ("t", "ego_xy", "ego_v", "path", "obj_xy", "obj_v",
              "obj_valid"):
        np.testing.assert_array_equal(frames[k], jframes[k])
    assert frames["summary"] == jframes["summary"]
    got = mod.decide_all(frames, torch.device("cpu"))
    want = jax.device_get(jmod.decide_all(jframes))
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want[0]))
    assert len(set(got[0].tolist())) == 2            # both lanes chosen
    for g, w in zip(got[1:3], want[1:3]):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-5)
    # the RL state holds f32 arc-length differences of points up to 40 m
    # along the path, where XLA's fused multiply-adds round otherwise
    np.testing.assert_allclose(got[3].numpy(), np.asarray(want[3]),
                               rtol=1e-5, atol=1e-4)


def test_field_replay_runs_and_plots(tmp_path, capsys):
    scen = synthetic_scenario(str(tmp_path / "scen"))
    out = tmp_path / "replay"
    assert port("examples.run_field_replay").main(
        ["--scenario", scen, "--plot", "--out", str(out), *CPU]) == 0
    lines = _lines(capsys)
    assert lines[1].startswith("replayed 50 decision ticks in ")
    assert (tmp_path / "replay.json").is_file()
    assert (tmp_path / "replay.png").is_file()


def test_field_replay_exits_2_without_its_scenario(tmp_path, capsys):
    """JAX's CLI returns (exit 0) on a missing scenario; the port exits 2
    so that no run passes on absent input."""
    missing = str(tmp_path / "absent")
    assert port("examples.run_field_replay").main(
        ["--scenario", missing, *CPU]) == 2
    assert _lines(capsys) == [f"scenario dir {missing} not found"]


# ------------------------------------------------------- defaults, devices


def _tracked_files() -> set:
    res = subprocess.run(["git", "ls-files"], cwd=ROOT, capture_output=True,
                         text=True)
    if res.returncode == 0:
        return {str(ROOT / f) for f in res.stdout.splitlines()}
    return {str(p) for p in ROOT.rglob("*") if p.is_file()
            and "build" not in p.relative_to(ROOT).parts}


@pytest.mark.parametrize("name,outputs", [
    ("tools.bench_store_scale", lambda a: [a.out]),
    ("examples.run_improvement",
     lambda a: [a.out + ".json", a.out + ".png", a.session_root]),
    ("examples.run_vehicle_life", lambda a: [a.out]),
    ("examples.run_simulation1",
     lambda a: [a.out_dir + "/simulation1_confidence_curve.png"]),
    ("examples.run_simulation2",
     lambda a: [f"{a.out_dir}/simulation2_panel_{i}.png" for i in (1, 2, 3, 4)]),
    ("examples.run_field_replay", lambda a: [a.out + ".json", a.out + ".png"]),
], ids=lambda x: x if isinstance(x, str) else "")
def test_default_outputs_stay_in_build(name, outputs):
    """Every default output lies under ``build/torch_runs/`` (git-ignored)
    and names no file the repository keeps."""
    args = port(name).parser().parse_args([])
    tracked = _tracked_files()
    assert "build/" in (ROOT / ".gitignore").read_text().split()
    for path in outputs(args):
        resolved = Path(path).resolve()
        assert resolved.is_relative_to(cli.RUNS_DIR), path
        assert str(resolved) not in tracked, path


@pytest.mark.parametrize("name", PORT_ENTRY_POINTS)
def test_entry_point_default_device_is_the_card(name, monkeypatch):
    """With no card, the default ``--device cuda`` raises before any
    work: no entry point falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a card is present: the default runs there")
    monkeypatch.delenv("DCARL_NUM_PROCESSES", raising=False)
    argv = ["--scenario", str(ROOT)] if name.endswith("field_replay") else []
    with pytest.raises(RuntimeError, match="CUDA"):
        port(name).main(argv)


def test_multi_process_entry_points_on_two_ranks():
    """``bench_scaling`` and ``train_multihost`` on two gloo ranks (fresh
    interpreters, as a launcher starts them): rank 0 alone prints, and
    both see the world of two."""
    import torch_rank_programs as RP
    from dcarl_tpu_torch.parallel.launch import run_ranks

    (scal0, mh0), (scal1, mh1) = run_ranks(RP.entry_point_checks, 2, "gloo",
                                           "cpu", timeout_s=120)
    assert scal1 == [] and mh1 == []
    line = json.loads(scal0[-1])
    assert line["devices"] == 2 and line["steps_per_s_ndev"] > 0
    assert 0 < line["efficiency"]
    steps = [json.loads(x) for x in mh0]
    assert [x["step"] for x in steps] == [4, 8]
    assert all(x["processes"] == 2 and x["devices"] == 2 for x in steps)
