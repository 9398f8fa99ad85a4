"""PyTorch port of the vec-env wrappers and the small utilities against
the JAX package: ``parallel/vec_env.py``, ``control/calibration.py``,
``utils/nan_guard.py`` and ``utils/profiling.py``.

The wrapper cases are those of ``tests/test_vec_wrappers.py`` and
``tests/test_aux.py`` (vec env section), run through both packages on
the same toy envs; ``TorchVecEnv`` is held to ``JaxVecEnv`` on the
T-intersection at ``EnvConfig(reset_jitter=0)``, where the reset draws
change nothing (observations to rtol 1e-5 / atol 1e-4: XLA's and
PyTorch's float32 trigonometry differ in the last place).  Calibration
tables and commands are held to JAX's to rtol 1e-6; the NaN guard's
messages name the same leaves.
"""

import functools
import glob
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.control import calibration as JCAL
from dcarl_tpu.parallel import vec_env as JV
from dcarl_tpu.utils import nan_guard as JNG
from dcarl_tpu_torch.control import calibration as CAL
from dcarl_tpu_torch.parallel import vec_env as TV
from dcarl_tpu_torch.utils import nan_guard as NG
from dcarl_tpu_torch.utils import profiling as PR

from torch_algos_jax import one_torch_thread  # noqa: F401 (fixture)

PACKAGES = {"jax": JV, "torch": TV}


class _CountEnv:
    """Deterministic env: reward 1/step, episode length ``length``
    (``tests/test_vec_wrappers.py``)."""

    def __init__(self, length):
        self.length = length
        self.t = 0

    def reset(self):
        self.t = 0
        return np.zeros(4, np.float32)

    def step(self, action):
        self.t += 1
        done = self.t >= self.length
        return np.full(4, self.t, np.float32), 1.0, done, {}


class _OffsetEnv:
    """obs = offset + counter, done after 3 steps (``tests/test_aux.py``)."""

    def __init__(self, offset=0):
        self.offset = offset
        self.n = 0

    def reset(self):
        self.n = 0
        return np.array([self.offset + self.n], np.float64)

    def step(self, action):
        self.n += 1
        done = self.n >= 3
        return (np.array([self.offset + self.n], np.float64),
                float(action), done, {})


class _NanEnv(_OffsetEnv):
    def step(self, action):
        o, r, d, i = super().step(action)
        return o * np.nan, r, d, i


# ---------------------------------------------------------------------------
# vec wrappers


def _monitor_run(V, path):
    venv = V.VecMonitor(V.DummyVecEnv([lambda: _CountEnv(3),
                                       lambda: _CountEnv(5)]), path)
    venv.reset()
    flagged = []
    for _ in range(10):
        obs, rew, done, infos = venv.step(np.zeros(2))
        flagged += [("episode" in info) == bool(done[i])
                    for i, info in enumerate(infos)]
    out = (venv.get_episode_lengths(), venv.get_episode_rewards(), all(flagged))
    venv.close()
    header, rows = V.load_monitor_csv(path + ".monitor.csv")
    return out, sorted(header), [(r["l"], r["r"], r["env"]) for r in rows]


def test_vec_monitor_matches_jax(tmp_path):
    got = _monitor_run(TV, str(tmp_path / "t"))
    want = _monitor_run(JV, str(tmp_path / "j"))
    assert got == want
    assert got[0][0] == [3, 5, 3, 3, 5] and got[0][2]
    assert got[2][0][2] == 0 and got[2][1][2] == 1


def _video_run(V, folder):
    venv = V.VecVideoRecorder(
        V.DummyVecEnv([lambda: _CountEnv(100)]), folder,
        record_video_trigger=lambda step: step == 2, video_length=4,
        render_fn=lambda obs: np.full((8, 8, 3), int(obs[0][0]) % 255,
                                      np.uint8))
    venv.reset()
    for _ in range(10):
        venv.step(np.zeros(1))
    venv.close()
    npz = glob.glob(folder + "/*.npz")
    frames = np.load(npz[0])["frames"]
    return ([os.path.basename(p) for p in venv.recorded_paths], len(npz),
            frames.shape, [int(f[0, 0, 0]) for f in frames])


def test_vec_video_recorder_matches_jax(tmp_path):
    got = _video_run(TV, str(tmp_path / "t"))
    assert got == _video_run(JV, str(tmp_path / "j"))
    assert got[0][0].endswith(".gif") and got[1] == 1
    assert got[2] == (4, 8, 8, 3) and got[3] == [2, 3, 4, 5]


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
@pytest.mark.parametrize("cls_name", ["DummyVecEnv", "SubprocVecEnv"])
def test_vec_env_parity(pkg, cls_name):
    cls = getattr(PACKAGES[pkg], cls_name)
    venv = cls([functools.partial(_OffsetEnv, 10 * i) for i in range(3)])
    obs = venv.reset()
    np.testing.assert_allclose(obs[:, 0], [0.0, 10.0, 20.0])
    for k in range(1, 3):
        obs, rew, done, infos = venv.step(np.ones(3))
        np.testing.assert_allclose(obs[:, 0], [k, 10 + k, 20 + k])
        assert not done.any()
    obs, rew, done, infos = venv.step(np.ones(3))
    assert done.all()
    np.testing.assert_allclose(obs[:, 0], [0.0, 10.0, 20.0])
    np.testing.assert_allclose(
        [i["terminal_observation"][0] for i in infos], [3.0, 13.0, 23.0])
    assert venv.env_method("step", 0)[0][0][0] == 1.0
    venv.close()


@pytest.mark.parametrize("pkg", sorted(PACKAGES))
def test_vec_frame_stack_and_check_nan(pkg):
    V = PACKAGES[pkg]
    venv = V.VecFrameStack(V.DummyVecEnv([lambda: _OffsetEnv()]), n_stack=3)
    obs = venv.reset()
    np.testing.assert_allclose(obs[0], [0, 0, 0])
    obs, *_ = venv.step(np.ones(1))
    np.testing.assert_allclose(obs[0], [0, 0, 1])
    obs, *_ = venv.step(np.ones(1))
    np.testing.assert_allclose(obs[0], [0, 1, 2])
    obs, _, done, _ = venv.step(np.ones(1))
    assert done[0]
    np.testing.assert_allclose(obs[0], [0, 0, 0])   # done clears history

    guarded = V.VecCheckNan(V.DummyVecEnv([_NanEnv]))
    guarded.reset()
    with pytest.raises(ValueError, match="non-finite"):
        guarded.step(np.ones(1))
    with pytest.raises(ValueError, match="actions"):
        guarded.step(np.full(1, np.inf))
    warned = V.VecCheckNan(V.DummyVecEnv([_NanEnv]), raise_exception=False)
    warned.reset()
    with pytest.warns(UserWarning, match="observation"):
        warned.step(np.ones(1))


def test_torch_vec_env_matches_jax_vec_env():
    """``TorchVecEnv`` against ``JaxVecEnv`` (``test_aux.py``'s adapter
    case), four T-intersection envs through ``VecCheckNan``, 120 steps
    of the same throttle-forward actions, episodes ending on the way."""
    from dcarl_tpu.config import EnvConfig as JEnvConfig
    from dcarl_tpu.env.driving_env import make_vec_env as j_make
    from dcarl_tpu.env.scenario import t_intersection as j_t
    from dcarl_tpu_torch.config import EnvConfig
    from dcarl_tpu_torch.env.driving_env import make_vec_env
    from dcarl_tpu_torch.env.scenario import t_intersection

    jenv = JV.VecCheckNan(JV.JaxVecEnv(
        *j_make(j_t(), JEnvConfig(reset_jitter=0.0))[:2], num_envs=4))
    tenv = TV.VecCheckNan(TV.TorchVecEnv(
        *make_vec_env(t_intersection(), EnvConfig(reset_jitter=0.0),
                      device="cpu"), num_envs=4, device="cpu"))
    jo, to = jenv.reset(), tenv.reset()
    assert to.shape == (4, 20) and to.dtype == jo.dtype
    np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-4)
    rng = np.random.default_rng(0)
    dones = 0
    for _ in range(120):
        a = np.clip([1.0, 0.0] + rng.normal(0.0, 0.1, (4, 2)), -1.0, 1.0
                    ).astype(np.float32)
        jo, jr, jd, _ = jenv.step(a)
        to, tr, td, infos = tenv.step(a)
        assert tr.dtype == np.float64 and td.dtype == bool
        assert len(infos) == 4
        np.testing.assert_array_equal(td, jd)
        np.testing.assert_allclose(to, jo, rtol=1e-5, atol=1e-4)
        np.testing.assert_allclose(tr, jr, rtol=1e-5, atol=1e-4)
        dones += int(td.sum())
    assert dones > 0


# ---------------------------------------------------------------------------
# calibration


def test_calibration_tables_match_jax_and_invert():
    """``test_aux.py``'s calibration case on the port, held to JAX."""
    for brake in (False, True):
        want = JCAL.measure_table(brake=brake)
        got = CAL.measure_table(brake=brake, device="cpu")
        for name in ("speeds", "commands", "acc"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(want, name)),
                                       rtol=1e-6, atol=1e-6, err_msg=name)
    acc = CAL.measure_table(device="cpu")
    dec = CAL.measure_table(brake=True, device="cpu")
    a, d = acc.acc.numpy(), dec.acc.numpy()
    assert (np.diff(a, axis=1) >= -1e-6).all()
    assert (np.diff(d, axis=1) <= 1e-6).all()
    assert (np.diff(a, axis=0) <= 1e-6).all()
    cmd = CAL.feedforward_command(acc, torch.tensor([5.0]),
                                  torch.tensor([2.0]))
    i = int(np.searchsorted(acc.speeds.numpy(), 5.0))
    j = int(np.searchsorted(acc.commands.numpy(), float(cmd[0]) - 1e-9))
    assert a[i, j] >= 2.0 - 1e-6
    # the inverse over a grid of speeds (on and between the table's) and
    # accelerations (reachable or not), against JAX's
    jacc = JCAL.measure_table()
    v = np.linspace(-1.0, 22.0, 47).astype(np.float32)
    want_a = np.linspace(-1.0, 6.0, 29).astype(np.float32)
    vv, aa = np.meshgrid(v, want_a, indexing="ij")
    got = CAL.feedforward_command(acc, torch.as_tensor(vv),
                                  torch.as_tensor(aa))
    want = JCAL.feedforward_command(jacc, jnp.asarray(vv), jnp.asarray(aa))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_calibration_save_load_roundtrip(tmp_path):
    acc = CAL.measure_table(device="cpu")
    dec = CAL.measure_table(brake=True, device="cpu")
    ap, dp = str(tmp_path / "acc.txt"), str(tmp_path / "dec.txt")
    CAL.save_tables(acc, dec, ap, dp)
    back = CAL.load_table(ap, acc.speeds, acc.commands, device="cpu")
    np.testing.assert_allclose(back.acc.numpy(), acc.acc.numpy(), atol=1e-5)
    # the JAX package's text format: each file reads back as its tables
    jap, jdp = str(tmp_path / "jacc.txt"), str(tmp_path / "jdec.txt")
    JCAL.save_tables(JCAL.measure_table(), JCAL.measure_table(brake=True),
                     jap, jdp)
    for mine, theirs in ((ap, jap), (dp, jdp)):
        np.testing.assert_allclose(np.loadtxt(mine), np.loadtxt(theirs),
                                   rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# nan_guard


def _jax_tree(tree):
    if isinstance(tree, torch.Tensor):
        return jnp.asarray(tree.numpy())
    if isinstance(tree, tuple) and hasattr(tree, "_fields"):
        return type(tree)(*(_jax_tree(v) for v in tree))
    if isinstance(tree, (tuple, list)):
        return type(tree)(_jax_tree(v) for v in tree)
    if isinstance(tree, dict):
        return {k: _jax_tree(v) for k, v in tree.items()}
    return tree


def test_nan_guard_matches_jax():
    """``test_utils.py::test_nan_guard``'s cases on both packages, and a
    nested tree whose bad leaves both name the same way."""
    from dcarl_tpu_torch.algos.common import Transition

    good = {"x": torch.ones(3), "i": torch.arange(3)}
    assert bool(NG.check_finite(good))
    flag = NG.check_finite(good)
    assert flag.dtype == torch.bool and flag.shape == ()
    bad = {"x": torch.tensor([1.0, float("nan"), 2.0])}
    assert not bool(NG.check_finite(bad))
    assert NG.first_nonfinite(bad) == JNG.first_nonfinite(_jax_tree(bad))
    with pytest.raises(ValueError, match="NaN/Inf"):
        NG.assert_finite(bad, "test")

    nested = ([Transition(torch.ones(2), torch.zeros(2, dtype=torch.int32),
                          torch.tensor([np.inf, 1.0]), torch.zeros(2),
                          torch.tensor([[np.nan, np.nan]]))],
              {"b": 1.5, "a": (torch.tensor(float("-inf")), None)})
    got = NG.first_nonfinite(nested)
    assert got == JNG.first_nonfinite(_jax_tree(nested))
    assert got == {"[0][0].reward": 1, "[0][0].next_obs": 2, "[1]['a'][0]": 1}
    assert not bool(NG.check_finite(nested))
    assert bool(NG.check_finite({})) and bool(JNG.check_finite({}))

    calls = []

    def step(x):
        calls.append(1)
        return x * 2

    wrapped = NG.guard_step(step)
    np.testing.assert_allclose(wrapped(torch.ones(2)).numpy(), 2.0)
    with pytest.raises(ValueError) as e:
        wrapped(torch.tensor([np.inf]))
    with pytest.raises(ValueError) as ej:
        JNG.guard_step(step)(jnp.asarray([np.inf]))
    assert str(e.value) == str(ej.value)
    assert len(calls) == 1      # the bad input never reaches the step


# ---------------------------------------------------------------------------
# profiling


def test_profiling_trace_annotate_and_timer(tmp_path):
    """The operator's exporter: no file without a directory; one Chrome
    trace holding the program's span (tracing on) and the ops.  The
    span is ``span``; ``annotate`` and ``StepTimer`` are gone."""
    with PR.trace(None):
        x = torch.ones(3) * 2
    assert not list(tmp_path.iterdir())
    PR.enable()
    try:
        with PR.trace(str(tmp_path)):
            with PR.span("dcarl_span"):
                x = torch.ones(64, 64) @ torch.ones(64, 64)
    finally:
        PR.enable(False)
    files = list(tmp_path.glob("trace_*.json"))
    assert len(files) == 1
    events = json.loads(files[0].read_text())["traceEvents"]
    assert any(ev.get("name") == "dcarl_span" for ev in events)
    assert any("mm" in str(ev.get("name", "")) for ev in events)
    assert not hasattr(PR, "annotate") and not hasattr(PR, "StepTimer")
