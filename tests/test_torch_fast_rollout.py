"""PyTorch port: the lane-major rule and gated drivers against the JAX
package, started from the same carry and store.

Both packages start from the JAX ``init_fn`` carry (jitter 0.1, 8 envs),
carried across with ``dcarl_tpu_torch.interop``.  Auto-reset draws come
from different generators (threefry vs. torch), so the horizons are kept
short enough that no env finishes, and the tests assert that.  In f64
the integer outputs must be bit-equal and rewards within 1e-9, the
tolerance the JAX package holds its own two drivers to
(``tests/test_fast_rollout.py``)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from dcarl_tpu.config import EnvConfig as JEnvConfig
from dcarl_tpu.config import StoreConfig as JStoreConfig
from dcarl_tpu.config import WerlingConfig as JWerlingConfig
from dcarl_tpu.env import driving_env as jde
from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.planning import fast_rollout as jfr
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.config import EnvConfig, StoreConfig, WerlingConfig
from dcarl_tpu_torch.env.scenario import t_intersection
from dcarl_tpu_torch.planning import fast_rollout as tfr

B = 8
GATE = dict(visited_times_thres=10, rl_visited_times_min=5)
CPU = torch.device("cpu")


def _t(a):
    return torch.as_tensor(np.array(a))


def _jax_carry(dtype):
    init_j, _ = jfr.make_rule_driver_fast(j_t_intersection(), dtype=dtype)
    return init_j(jax.random.split(jax.random.PRNGKey(0), B))


@pytest.fixture(scope="module")
def store():
    """Rows seeded near the start observation (rule action 0 low-valued,
    candidate 3 high-valued, as ``tests/test_fast_rollout.py:228``) plus
    random rows around it and an invalid tail."""
    sc = j_t_intersection()
    sa = jde.scenario_to_device(sc, jnp.float64)
    env0 = jde.reset(sa, jax.random.PRNGKey(0), JEnvConfig())
    _, obs0 = jde.wrap_state(env0, sa, jde.in_state_indices(sc), JEnvConfig())
    obs0 = np.asarray(obs0)
    rng = np.random.default_rng(2)
    rows, vals = [], []
    for _ in range(40):
        base = obs0 + rng.normal(0, 0.05, 20)
        rows.append(np.r_[base, 0.0])
        vals.append(-5.0 + rng.normal(0, 0.1))
        rows.append(np.r_[base, 3.0])
        vals.append(5.0 + rng.normal(0, 0.1))
    for _ in range(300):
        rows.append(np.r_[obs0 + rng.normal(0, 1.0, 20), rng.integers(0, 11)])
        vals.append(rng.normal(0, 2.0))
    n_pad = 64
    keys = np.concatenate([np.asarray(rows), np.full((n_pad, 21), 1e6)])
    vals = np.concatenate([np.asarray(vals), np.zeros(n_pad)])
    valid = np.arange(len(keys)) < len(rows)
    return keys.astype(np.float32), vals.astype(np.float32), valid


def _run_jax_gated(dtype, steps, store, with_offset=None):
    init_j, run_j = jfr.make_gated_driver_fast(
        j_t_intersection(), store_cfg=JStoreConfig(**GATE), dtype=dtype,
        use_pallas=False, with_query_offset=with_offset is not None)
    carry = _jax_carry(dtype)
    args = [carry, jax.random.split(jax.random.PRNGKey(1), steps),
            *(jnp.asarray(a) for a in store)]
    if with_offset is not None:
        args.append(jnp.asarray(with_offset))
    _, out = run_j(*args)
    return carry, [np.asarray(o) for o in out]


def _run_torch_gated(carry_j, dtype, steps, store, use_kernel,
                     with_offset=None):
    init_t, run_t = tfr.make_gated_driver_fast(
        t_intersection(), store_cfg=StoreConfig(**GATE), dtype=dtype,
        device="cpu", use_kernel=use_kernel,
        with_query_offset=with_offset is not None)
    carry = interop.fast_env_state_from_numpy(carry_j, CPU, dtype)
    keys, vals, valid = interop.store_from_numpy(*store, CPU)
    extra = [] if with_offset is None else [_t(with_offset)]
    _, out = run_t(carry, steps, keys, vals, valid, *extra,
                   generator=torch.Generator().manual_seed(1))
    return [o.numpy() for o in out]


def _assert_same_run(got, ref, reward_tol):
    r_g, *ints_g = got
    r_r, *ints_r = ref
    for name, a, b in zip(("done", "passed", "collided", "executed", "gated"),
                          ints_g, ints_r):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(r_g, r_r, **reward_tol)
    # no env finishes inside the horizon: the auto-reset draws of the two
    # generators never enter the comparison
    assert not ref[1].any()


def test_rule_driver_matches_jax_f64():
    steps = 20
    carry_j = _jax_carry(jnp.float64)
    _, run_j = jfr.make_rule_driver_fast(j_t_intersection(), dtype=jnp.float64)
    _, ref = run_j(carry_j, jax.random.split(jax.random.PRNGKey(1), steps))
    ref = [np.asarray(o) for o in ref]

    _, run_t = tfr.make_rule_driver_fast(t_intersection(), dtype=torch.float64,
                                         device="cpu")
    carry = interop.fast_env_state_from_numpy(carry_j, CPU, torch.float64)
    _, got = run_t(carry, steps, torch.Generator().manual_seed(1))
    got = [o.numpy() for o in got]
    for name, a, b in zip(("done", "passed", "collided"), got[1:], ref[1:]):
        np.testing.assert_array_equal(a, b, err_msg=name)
    np.testing.assert_allclose(got[0], ref[0], rtol=0, atol=1e-9)
    assert not ref[1].any()
    assert got[0].shape == (steps, B)


def test_gated_driver_matches_jax_f64(store):
    steps = 20
    carry_j, ref = _run_jax_gated(jnp.float64, steps, store)
    got = _run_torch_gated(carry_j, torch.float64, steps, store,
                           use_kernel=False)
    _assert_same_run(got, ref, dict(rtol=0, atol=1e-9))
    gated = ref[5]
    assert (gated > 0).any() and (gated == 0).any()


def test_gated_driver_kernel_route_matches_jax_f32(store):
    """use_kernel=True on CPU: the per-action prepare and the kernel's
    plain version, against the JAX f32 reference route."""
    steps = 5
    carry_j, ref = _run_jax_gated(jnp.float32, steps, store)
    got = _run_torch_gated(carry_j, torch.float32, steps, store,
                           use_kernel=True)
    _assert_same_run(got, ref, dict(rtol=1e-5, atol=0))
    assert (ref[5] > 0).any()


def test_gated_driver_query_offset_matches_jax(store):
    steps = 6
    offset = np.zeros(20)
    offset[0], offset[6] = 0.4, -0.7
    carry_j, ref = _run_jax_gated(jnp.float64, steps, store, offset)
    got = _run_torch_gated(carry_j, torch.float64, steps, store,
                           use_kernel=False, with_offset=offset)
    _assert_same_run(got, ref, dict(rtol=0, atol=1e-9))


def test_gated_driver_empty_store_is_the_rule_driver():
    sc = t_intersection()
    _, run_r = tfr.make_rule_driver_fast(sc, dtype=torch.float64, device="cpu")
    init_g, run_g = tfr.make_gated_driver_fast(sc, dtype=torch.float64,
                                               device="cpu", use_kernel=True)
    carry = init_g(B, torch.Generator().manual_seed(0))
    _, (r_r, *_) = run_r(carry, 8, torch.Generator().manual_seed(1))
    _, (r_g, _, _, _, executed, gated) = run_g(
        carry, 8, torch.zeros((16, 21)), torch.zeros(16),
        torch.zeros(16, dtype=torch.bool),
        generator=torch.Generator().manual_seed(1))
    assert (gated == 0).all() and (executed > 0).any()
    np.testing.assert_array_equal(r_g.numpy(), r_r.numpy())


def _tables(dtype_t, dtype_j):
    ref = np.asarray(t_intersection().ref_path, np.float64)
    return (tfr.tables_to(tfr.build_ref_tables(ref, dtype_t), dtype_t, CPU),
            jfr.build_ref_tables(ref, dtype_j))


def test_projection_and_lattice_match_jax():
    tab_t, tab_j = _tables(torch.float64, jnp.float64)
    ref = np.asarray(t_intersection().ref_path)
    rng = np.random.default_rng(0)
    n = 64
    base = ref[rng.integers(0, len(ref), n)]
    px, py = (base + rng.normal(0, 3.0, (n, 2))).T
    vx, vy = rng.normal(0, 5.0, (2, n))
    got = tfr._project_ego(*(_t(a) for a in (px, py, vx, vy)), tab_t)
    want = jfr._project_ego(*(jnp.asarray(a) for a in (px, py, vx, vy)),
                            tab_j, np.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12)

    s0 = rng.uniform(1.0, 80.0, n)
    c_d, c_d_d = rng.normal(0, 1.0, n), rng.normal(0, 0.5, n)
    c_speed = rng.uniform(0.0, 20.0, n)  # above max_speed: infeasible
    lat_t = tfr._plan_lattice(*(_t(a) for a in (s0, c_d, c_d_d, c_speed)),
                              tab_t, WerlingConfig())
    lat_j = jfr._plan_lattice(*(jnp.asarray(a) for a in (s0, c_d, c_d_d,
                                                          c_speed)),
                              tab_j, JWerlingConfig(), np.float64)
    for name in ("x", "y", "s_d_end", "cf"):
        np.testing.assert_allclose(getattr(lat_t, name).numpy(),
                                   np.asarray(getattr(lat_j, name)),
                                   rtol=1e-12, atol=1e-9, err_msg=name)
    np.testing.assert_array_equal(lat_t.feasible.numpy(),
                                  np.asarray(lat_j.feasible))
    assert not lat_t.feasible.all()

    obstacles = np.stack([lat_t.x[::3, 5].numpy()[:3] + rng.normal(0, 1, (3, n)),
                          lat_t.y[::3, 5].numpy()[:3] + rng.normal(0, 1, (3, n)),
                          *rng.normal(0, 2, (2, 3, n)),
                          np.zeros((3, n))], axis=1)   # [K, 5, B]
    free_t = tfr._collision_free(lat_t, _t(obstacles), WerlingConfig())
    free_j = jfr._collision_free(lat_j, jnp.asarray(obstacles),
                                 JWerlingConfig(), np.float64)
    np.testing.assert_array_equal(free_t.numpy(), np.asarray(free_j))
    assert free_t.any() and not free_t.all()

    ex, ey = lat_t.x[4, 0].numpy() + rng.normal(0, 0.5, n), \
        lat_t.y[4, 0].numpy() + rng.normal(0, 0.5, n)
    yaw, v = rng.uniform(-np.pi, np.pi, n), rng.uniform(0, 15, n)
    speed_end = np.where(rng.random(n) < 0.2, 0.0, rng.uniform(2, 12, n))
    got = tfr._control(*(_t(a) for a in (ex, ey, yaw, v)), lat_t.x[4],
                       lat_t.y[4], _t(speed_end))
    want = jfr._control(*(jnp.asarray(a) for a in (ex, ey, yaw, v)),
                        lat_j.x[4], lat_j.y[4], jnp.asarray(speed_end),
                        np.float64)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-11,
                                   atol=1e-12)


def test_entry_points_refuse_a_quiet_cpu_run(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        tfr.make_rule_driver_fast(t_intersection())
    with pytest.raises(RuntimeError):
        tfr.make_gated_driver_fast(t_intersection(), device="cuda")


def test_gated_driver_rejects_cross_action_width():
    hw = (1.0,) * 20 + (0.5,)
    with pytest.raises(ValueError, match="half_width"):
        tfr.make_gated_driver_fast(t_intersection(), device="cpu",
                                   store_cfg=StoreConfig(half_widths=hw))
    _, run = tfr.make_gated_driver_fast(t_intersection(), device="cpu",
                                        env_cfg=EnvConfig())
    with pytest.raises(TypeError, match="query_offset"):
        run(None, 1, None, None, None, torch.zeros(20),
            generator=torch.Generator())
