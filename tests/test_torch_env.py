"""PyTorch port: config copies, scenario, path maths, env reset/step and
the state interop, against the JAX package on the same inputs."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import dcarl_tpu.config as jcfg
from dcarl_tpu.env import driving_env as jde
from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.ops import polynomial as jpoly
from dcarl_tpu.ops import spline as jspl
from dcarl_tpu.planning import fast_rollout as jfr
import dcarl_tpu_torch.config as tcfg
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.env import driving_env as tde
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.ops import polynomial as tpoly
from dcarl_tpu_torch.ops import spline as tspl
from dcarl_tpu_torch.planning import fast_rollout as tfr


def _t(a):
    return torch.as_tensor(np.asarray(a))


@pytest.mark.parametrize("name", ["StoreConfig", "WerlingConfig", "EnvConfig"])
def test_config_copies_match(name):
    j, t = getattr(jcfg, name)(), getattr(tcfg, name)()
    assert dataclasses.asdict(j) == dataclasses.asdict(t)
    if name == "WerlingConfig":
        for prop in ("d_offsets", "horizons", "target_speeds", "n_time_steps",
                     "num_paths"):
            assert getattr(j, prop) == getattr(t, prop)
        assert t.num_paths == 10 and t.n_time_steps == 13


@pytest.mark.parametrize("overrides", [{}, {"value_mode": "nstep"},
                                       {"value_mode": "episode", "gamma": 1.0,
                                        "explore_high": 2.0}])
def test_driving_store_config_matches(overrides):
    assert tcfg.DRIVING_HALF_WIDTHS == jcfg.DRIVING_HALF_WIDTHS
    assert (dataclasses.asdict(tcfg.driving_store_config(**overrides))
            == dataclasses.asdict(jcfg.driving_store_config(**overrides)))


def test_t_intersection_matches():
    j, t = j_t_intersection(), t_intersection()
    for name in j._fields:
        np.testing.assert_array_equal(getattr(t, name), getattr(j, name), name)
    assert tde.in_state_indices(t) == jde.in_state_indices(j)


def test_polynomials_match():
    rng = np.random.default_rng(0)
    xs, vxs, axs, xe, vxe, axe = rng.normal(0, 2, (6, 32))
    T, t = 4.0, rng.uniform(0, 4, 32)
    jq = jpoly.solve_quintic(*(jnp.asarray(a) for a in (xs, vxs, axs, xe,
                                                         vxe, axe)), T)
    tq = tpoly.solve_quintic(*(_t(a) for a in (xs, vxs, axs, xe, vxe, axe)), T)
    for fj, ft in ((jpoly.quintic_eval, tpoly.quintic_eval),
                   (jpoly.quintic_d1, tpoly.quintic_d1),
                   (jpoly.quintic_d2, tpoly.quintic_d2),
                   (jpoly.quintic_d3, tpoly.quintic_d3)):
        np.testing.assert_allclose(ft(tq, _t(t)).numpy(),
                                   np.asarray(fj(jq, jnp.asarray(t))),
                                   rtol=1e-13, atol=1e-12)
    jr = jpoly.solve_quartic(*(jnp.asarray(a) for a in (xs, vxs, axs, vxe,
                                                         axe)), T)
    tr = tpoly.solve_quartic(*(_t(a) for a in (xs, vxs, axs, vxe, axe)), T)
    for fj, ft in ((jpoly.quartic_eval, tpoly.quartic_eval),
                   (jpoly.quartic_d1, tpoly.quartic_d1),
                   (jpoly.quartic_d2, tpoly.quartic_d2),
                   (jpoly.quartic_d3, tpoly.quartic_d3)):
        np.testing.assert_allclose(ft(tr, _t(t)).numpy(),
                                   np.asarray(fj(jr, jnp.asarray(t))),
                                   rtol=1e-13, atol=1e-12)


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_spline_fit_matches(dtype):
    rng = np.random.default_rng(1)
    x = np.cumsum(rng.uniform(0.5, 2.0, 30)).astype(dtype)
    y = rng.normal(0, 3, 30).astype(dtype)
    j = jspl.fit_natural_cubic(jnp.asarray(x), jnp.asarray(y))
    t = tspl.fit_natural_cubic(_t(x), _t(y))
    tol = dict(rtol=1e-12, atol=1e-12) if dtype == np.float64 else \
        dict(rtol=1e-5, atol=1e-5)
    for name in ("a", "b", "c", "d"):
        np.testing.assert_allclose(getattr(t, name).numpy(),
                                   np.asarray(getattr(j, name)), **tol)


@pytest.mark.parametrize("dtype,rtol", [(torch.float64, 1e-12),
                                        (torch.float32, 1e-6)])
def test_build_ref_tables_matches(dtype, rtol):
    ref = np.asarray(t_intersection().ref_path, np.float64)
    jdt = jnp.float64 if dtype == torch.float64 else jnp.float32
    j = jfr.build_ref_tables(ref, jdt)
    t = tfr.build_ref_tables(ref, dtype)
    for name in j._fields:
        a, b = getattr(t, name), np.asarray(getattr(j, name))
        assert a.dtype == np.float64 and a.shape == b.shape
        # relative to each spline coefficient column's scale: a straight
        # stretch of path leaves higher-order coefficients at rounding
        # noise, for which an elementwise rtol means nothing
        scale = np.abs(b).max(axis=0) if name == "seg" else np.abs(b).max()
        assert (np.abs(a - b) <= rtol * scale).all(), name
    np.testing.assert_array_equal(t.knots, np.asarray(j.knots))
    # the interop path carries the JAX tables across unchanged
    carried = interop.ref_tables_from_numpy(j)
    for name in j._fields:
        np.testing.assert_array_equal(getattr(carried, name),
                                      np.asarray(getattr(j, name)))


def test_reset_without_jitter_matches_jax():
    cfg = tcfg.EnvConfig(reset_jitter=0.0)
    sc = t_intersection(cfg)
    jsa = jde.scenario_to_device(j_t_intersection(), jnp.float64)
    keys = jax.random.split(jax.random.PRNGKey(0), 5)
    jst = jax.vmap(lambda k: jde.reset(jsa, k, jcfg.EnvConfig(reset_jitter=0.0)))(keys)
    sa = tde.scenario_to_device(sc, torch.float64, torch.device("cpu"))
    tst = tde.reset(sa, 5, torch.Generator().manual_seed(0), cfg)
    for name in jst._fields:
        np.testing.assert_array_equal(getattr(tst, name).numpy(),
                                      np.asarray(getattr(jst, name)), name)


def test_reset_jitter_is_bounded_and_seeded():
    cfg = tcfg.EnvConfig()
    sa = tde.scenario_to_device(t_intersection(cfg), torch.float64,
                                torch.device("cpu"))
    a = tde.reset(sa, 256, torch.Generator().manual_seed(7), cfg)
    b = tde.reset(sa, 256, torch.Generator().manual_seed(7), cfg)
    np.testing.assert_array_equal(a.ego.numpy(), b.ego.numpy())
    off = a.ego[:, :2] - sa.ego_spawn[:2]
    assert (off.abs() <= cfg.reset_jitter).all() and off.std() > 0.03
    voff = a.vehicles[:, :, :2] - sa.vehicle_spawns[:, :2]
    assert (voff.abs() <= cfg.reset_jitter).all()
    assert (a.ego[:, 2:] == sa.ego_spawn[2:]).all()


def test_interop_carry_and_step_match_jax():
    """The JAX init carry (jittered, 8 envs) crosses over exactly, and
    one lane-major env step from it agrees with the JAX step."""
    sc_j = j_t_intersection()
    init_j, _ = jfr.make_rule_driver_fast(sc_j, dtype=jnp.float64)
    carry_j = init_j(jax.random.split(jax.random.PRNGKey(0), 8))
    carry_t = interop.fast_env_state_from_numpy(carry_j, "cpu", torch.float64)
    for name in carry_j._fields:
        a, b = getattr(carry_t, name), np.asarray(getattr(carry_j, name))
        np.testing.assert_array_equal(a.numpy(), b, name)
    assert carry_t.stuck_steps.dtype == torch.int32
    assert carry_t.done.dtype == torch.bool

    idx = jde.in_state_indices(sc_j)
    obs_j = np.asarray(jfr._obs_ori_soa(carry_j, idx))
    np.testing.assert_array_equal(tfr._obs_ori_soa(carry_t, idx).numpy(), obs_j)

    rng = np.random.default_rng(2)
    acc, steer = rng.uniform(-1, 1, (2, 8))
    jsa = jde.scenario_to_device(sc_j, jnp.float64)
    st_j, r_j, d_j = jfr._step_env_soa(
        carry_j, jnp.asarray(acc), jnp.asarray(steer), jax.random.PRNGKey(3),
        jsa, idx, jcfg.EnvConfig(), np.float64)
    tsa = tde.scenario_to_device(t_intersection(), torch.float64,
                                 torch.device("cpu"))
    st_t, r_t, d_t = tfr._step_env_soa(carry_t, _t(acc), _t(steer),
                                       torch.Generator().manual_seed(3), tsa,
                                       tcfg.EnvConfig())
    assert not np.asarray(d_j).any()
    np.testing.assert_array_equal(d_t.numpy(), np.asarray(d_j))
    np.testing.assert_allclose(r_t.numpy(), np.asarray(r_j), rtol=1e-12)
    for name in st_j._fields:
        np.testing.assert_allclose(getattr(st_t, name).numpy(),
                                   np.asarray(getattr(st_j, name)),
                                   rtol=1e-12, atol=1e-12, err_msg=name)


def test_store_interop_checks_shapes():
    k, v, m = interop.store_from_numpy(np.zeros((4, 21)), np.zeros(4),
                                       np.array([1, 0, 1, 1]), "cpu")
    assert k.dtype == torch.float32 and m.dtype == torch.bool
    assert m.tolist() == [True, False, True, True]
    with pytest.raises(ValueError):
        interop.store_from_numpy(np.zeros((4, 21)), np.zeros(3),
                                 np.ones(4, bool), "cpu")
