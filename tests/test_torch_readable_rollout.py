"""PyTorch port: the readable batch-first rule driver and value collector
(``planning/rollout.py``) against the JAX package's readable ones, and
against the port's own lane-major fast drivers (the port's form of
``tests/test_fast_rollout.py``).

All runs use ``reset_jitter=0``, so the auto-reset draws of the
generators never enter.  In float64 over 300 ticks (episode ends, passes
and auto-resets included) integer outputs must be bit-equal and rewards
within rtol 1e-9; in float32 over 30 ticks rewards are held to rtol/atol
1e-3 (f32 transcendentals differ from XLA's in the last place, and the
lane-major layout sums in another order)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import EnvConfig as JEnvConfig
from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.planning import rollout as JR
from dcarl_tpu_torch.config import EnvConfig, WerlingConfig
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.ops import geometry as G
from dcarl_tpu_torch.ops import spline as S
from dcarl_tpu_torch.planning import fast_rollout as FR
from dcarl_tpu_torch.planning import rollout as R
from dcarl_tpu_torch.planning import werling as W

F64_TOL = dict(rtol=1e-9, atol=1e-9)
F32_TOL = dict(rtol=1e-3, atol=1e-3)
CFG = EnvConfig(reset_jitter=0.0)
JCFG = JEnvConfig(reset_jitter=0.0)
DTYPES = {"f64": (jnp.float64, torch.float64), "f32": (jnp.float32,
                                                      torch.float32)}


def _gen(seed=0):
    return torch.Generator().manual_seed(seed)


def _jax_run(make, b, s, dtype):
    init_fn, run_fn = make(j_t_intersection(JCFG), JCFG, dtype=dtype)
    keys = jax.random.split(jax.random.PRNGKey(0), b)
    step_keys = jax.random.split(jax.random.PRNGKey(1), b * s).reshape(b, s, 2)
    _, out = run_fn(init_fn(keys), step_keys)
    return out


def _port_run(make, b, s, dtype):
    init_fn, run_fn = make(t_intersection(CFG), CFG, dtype=dtype, device="cpu")
    gen = _gen()
    return run_fn(init_fn(b, gen), s, gen)[1]


def _assert_rule_runs(got, ref, tol):
    """(reward, done, passed, collided), each [B, S]."""
    r_g, *ints_g = (np.asarray(a) for a in got)
    r_r, *ints_r = (np.asarray(a) for a in ref)
    for name, a, b in zip(("done", "passed", "collided"), ints_g, ints_r):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(r_g, r_r, **tol)


@pytest.mark.parametrize("prec,b,s", [("f64", 16, 300), ("f32", 8, 30)])
def test_rule_driver_matches_jax_readable(prec, b, s):
    jdt, tdt = DTYPES[prec]
    ref = _jax_run(JR.make_rule_driver, b, s, jdt)
    got = _port_run(R.make_rule_driver, b, s, tdt)
    assert got[0].shape == (b, s) and got[0].dtype == tdt
    if prec == "f64":
        _assert_rule_runs(got, ref, F64_TOL)
        assert got[1].any() and got[2].any()   # episodes end, some pass
    else:
        np.testing.assert_allclose(got[0].numpy(), np.asarray(ref[0]),
                                   **F32_TOL)


def _assert_records(got, ref, tol, step_major_ref=False):
    """StepRecord fields of the port's readable collector ([B, S, ...])
    against a reference ([B, S, ...], or the fast collector's [S, ...]
    with ``step_major_ref``)."""
    for name in R.StepRecord._fields:
        g = getattr(got, name).numpy()
        r = np.asarray(getattr(ref, name))
        if step_major_ref:   # [S, B] and [S, 20, B]
            r = np.transpose(r, (2, 0, 1)) if r.ndim == 3 else r.T
        if g.dtype.kind in "biu":
            np.testing.assert_array_equal(g, r, err_msg=name)
        else:
            np.testing.assert_allclose(g, r, err_msg=name, **tol)


def test_collector_matches_jax_readable():
    ref = _jax_run(JR.make_collector, 16, 300, jnp.float64)
    got = _port_run(R.make_collector, 16, 300, torch.float64)
    _assert_records(got, ref, F64_TOL)
    # the window triggers, ends episodes and rotates the action
    assert got.done.any() and int(got.used_action.max()) >= 1
    assert (got.recorded_state[..., 1] != 0).any()


def test_collector_f32_close_to_jax_readable():
    ref = _jax_run(JR.make_collector, 8, 30, jnp.float32)
    got = _port_run(R.make_collector, 8, 30, torch.float32)
    # in f32 a near-tie of two lattice costs may pick another path (integer
    # outputs are held bit-equal in f64 only); the rewards stay close
    np.testing.assert_allclose(got.reward.numpy(), np.asarray(ref.reward),
                               **F32_TOL)
    np.testing.assert_allclose(got.episode_return.numpy(),
                               np.asarray(ref.episode_return), **F32_TOL)


@pytest.mark.parametrize("prec,b,s", [("f64", 16, 300), ("f32", 8, 30)])
def test_fast_driver_matches_readable_driver(prec, b, s):
    """``tests/test_fast_rollout.py:22`` and ``:53`` within the port."""
    tdt = DTYPES[prec][1]
    readable = _port_run(R.make_rule_driver, b, s, tdt)
    fast = _port_run(FR.make_rule_driver_fast, b, s, tdt)
    fast = tuple(a.T for a in fast)             # [S, B] -> [B, S]
    if prec == "f64":
        _assert_rule_runs(fast, readable, F64_TOL)
        assert readable[1].any()
    else:
        np.testing.assert_allclose(fast[0].numpy(), readable[0].numpy(),
                                   **F32_TOL)


def test_fast_collector_matches_readable_collector():
    """``tests/test_fast_rollout.py:150`` within the port."""
    readable = _port_run(R.make_collector, 12, 300, torch.float64)
    fast = _port_run(FR.make_collector_fast, 12, 300, torch.float64)
    _assert_records(readable, fast, F64_TOL, step_major_ref=True)
    assert readable.done.any() and int(readable.used_action.max()) >= 1


def _tables(ref):
    return FR.tables_to(FR.build_ref_tables(ref, torch.float64),
                        torch.float64, torch.device("cpu"))


def test_project_ego_matches_geometry_op():
    """``tests/test_fast_rollout.py:72``: the fused lane-major projection
    equals ``cartesian_to_frenet`` on poses around the path."""
    ref = np.asarray(t_intersection().ref_path, np.float64)
    rng = np.random.default_rng(0)
    n = 64
    base = ref[rng.integers(0, len(ref), n)]
    px, py = base[:, 0] + rng.normal(0, 3.0, n), base[:, 1] + rng.normal(0, 3, n)
    vx, vy = rng.normal(0, 5.0, n), rng.normal(0, 5.0, n)
    t = [torch.as_tensor(a) for a in (px, py, vx, vy)]
    s0, d, vd = FR._project_ego(*t, _tables(ref))
    f = G.cartesian_to_frenet(*t, torch.zeros(n, dtype=torch.float64),
                              torch.as_tensor(ref))
    for got, want in ((s0, f.s), (d, f.d), (vd, f.vd)):
        np.testing.assert_allclose(got.numpy(), want.numpy(), **F64_TOL)


def test_fast_lattice_matches_werling_plan():
    """``tests/test_fast_rollout.py:110``: the lane-major lattice equals
    the readable ``werling.plan`` for every env."""
    ref = np.asarray(t_intersection().ref_path, np.float64)
    rp = S.refpath_from_xy(torch.as_tensor(ref[:, 0]),
                           torch.as_tensor(ref[:, 1]))
    rng = np.random.default_rng(1)
    b = 8
    s0, c_d, c_d_d, c_speed = (torch.as_tensor(a) for a in (
        rng.uniform(1.0, 30.0, b), rng.normal(0, 1.0, b),
        rng.normal(0, 0.5, b), rng.uniform(0.0, 10.0, b)))
    wcfg = WerlingConfig()
    fast = FR._plan_lattice(s0, c_d, c_d_d, c_speed, _tables(ref), wcfg)
    lat = W.plan(rp, W.FrenetStart(s0, c_d, c_d_d, torch.zeros(b), c_speed),
                 wcfg)
    np.testing.assert_allclose(fast.x.permute(2, 0, 1).numpy(), lat.x.numpy(),
                               **F64_TOL)
    np.testing.assert_allclose(fast.y.permute(2, 0, 1).numpy(), lat.y.numpy(),
                               **F64_TOL)
    np.testing.assert_allclose(fast.cf.T.numpy(), lat.cf.numpy(), **F64_TOL)
    np.testing.assert_array_equal(fast.feasible.T.numpy(),
                                  lat.feasible.numpy())


def test_drivers_refuse_a_quiet_cpu_run():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: device=None is valid here")
    for make in (R.make_rule_driver, R.make_collector):
        with pytest.raises(RuntimeError):
            make(t_intersection(CFG), CFG)
