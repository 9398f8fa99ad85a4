"""PyTorch port: obstacle prediction, the Werling lattice, the rule pick,
the brake path, trajectory lookup and the controller against the JAX
package (the cases of ``tests/test_planning.py``).

The port plans a batch of envs at once where JAX is vmapped.  In float64
integer outputs (rule index, feasibility and collision masks) must be
bit-equal and real outputs within 1e-9 (the tolerance
``tests/test_fast_rollout.py`` holds JAX's own two lattices to)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import WerlingConfig as JWerlingConfig
from dcarl_tpu.control import controller as jctl
from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.ops import spline as JS
from dcarl_tpu.planning import predictor as JP
from dcarl_tpu.planning import werling as JW
from dcarl_tpu_torch.config import WerlingConfig
from dcarl_tpu_torch.control import controller as ctl
from dcarl_tpu_torch.ops import spline as S
from dcarl_tpu_torch.planning import predictor as P
from dcarl_tpu_torch.planning import werling as W

TOL = dict(rtol=1e-9, atol=1e-9)
JCFG, CFG = JWerlingConfig(), WerlingConfig()


def _t(a):
    return torch.as_tensor(np.array(a))


def _paths(kind):
    """(port RefPath, JAX RefPath, line [N, 2] numpy) of a straight x-axis
    path or the scenario's reference path, fitted in float64."""
    if kind == "straight":
        line = np.stack([np.linspace(0.0, 200.0, 101), np.zeros(101)], 1)
    else:
        line = np.asarray(j_t_intersection().ref_path, np.float64)
    return (S.refpath_from_xy(_t(line[:, 0]), _t(line[:, 1])),
            JS.refpath_from_xy(jnp.asarray(line[:, 0]),
                               jnp.asarray(line[:, 1])), line)


def _starts(rng, b, s_max):
    return np.stack([rng.uniform(0.0, s_max, b), rng.normal(0, 1.0, b),
                     rng.normal(0, 0.5, b), np.zeros(b),
                     rng.uniform(0.0, 10.0, b)], axis=1)


def _jax_lattice(rp_j, starts):
    return jax.jit(jax.vmap(lambda v: JW.plan(rp_j, JW.FrenetStart(*v),
                                              JCFG)))(
        tuple(jnp.asarray(starts[:, i]) for i in range(5)))


def _assert_lattice(got: W.Lattice, ref):
    for name in ("d", "s", "s_d", "x", "y", "yaw", "curvature", "cf"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)
    np.testing.assert_array_equal(got.feasible.numpy(),
                                  np.asarray(ref.feasible))


@pytest.mark.parametrize("kind", ["straight", "scenario"])
def test_plan_matches_jax(kind):
    rp_t, rp_j, line = _paths(kind)
    starts = _starts(np.random.default_rng(1), 12, 60.0)
    lat = W.plan(rp_t, W.FrenetStart(*(_t(starts[:, i]) for i in range(5))),
                 CFG)
    assert lat.x.shape == (12, 10, 13) and lat.cf.shape == (12, 10)
    _assert_lattice(lat, _jax_lattice(rp_j, starts))
    if kind == "straight":
        # the lattice normal is +y: global y is the lateral offset
        np.testing.assert_allclose(lat.y.numpy(), lat.d.numpy(), atol=1e-6)
        np.testing.assert_allclose(lat.x.numpy(), lat.s.numpy(), atol=1e-6)


def test_prediction_and_collision_mask_match_jax():
    rng = np.random.default_rng(2)
    obst = rng.normal(0, 5, (6, 4, 5))
    valid = rng.random((6, 4)) < 0.8
    got = P.predict_obstacles(_t(obst), _t(valid), CFG)
    ref = jax.jit(jax.vmap(lambda o, v: JP.predict_obstacles(o, v, JCFG)))(
        jnp.asarray(obst), jnp.asarray(valid))
    np.testing.assert_allclose(got.x.numpy(), np.asarray(ref.x), **TOL)
    np.testing.assert_allclose(got.y.numpy(), np.asarray(ref.y), **TOL)
    # front circle: x = x0 + t vx + move_gap cos(yaw)
    t5 = 5 * CFG.dt
    np.testing.assert_allclose(
        got.x[0, 0, 0, 5].item(),
        obst[0, 0, 0] + t5 * obst[0, 0, 2] + np.cos(obst[0, 0, 4]), atol=1e-12)
    px, py = rng.normal(0, 5, (6, 10, 13)), rng.normal(0, 5, (6, 10, 13))
    free = P.check_collision_free(_t(px), _t(py), got, CFG)
    free_j = jax.jit(jax.vmap(lambda x, y, p: JP.check_collision_free(
        x, y, p, JCFG)))(
        jnp.asarray(px), jnp.asarray(py), ref)
    np.testing.assert_array_equal(free.numpy(), np.asarray(free_j))
    assert free.any() and not free.all()


def test_rule_pick_brake_and_lookup_match_jax():
    """On the straight path: no obstacles -> the cheapest path; a parked
    blocker -> the cheapest collision-free one; a wall across every
    offset -> brake (index 0, desired speed 0).  Each env of the batch has
    its own obstacles."""
    rp_t, rp_j, _ = _paths("straight")
    start = np.tile([0.0, 0.0, 0.0, 0.0, 8.0], (3, 1))
    gx, gy = np.meshgrid(np.linspace(6.0, 20.0, 8), np.linspace(-6.0, 6.0, 9))
    wall = np.stack([gx.ravel(), gy.ravel()] + [np.zeros(gx.size)] * 3, 1)
    obst = np.zeros((3, wall.shape[0], 5))
    valid = np.zeros((3, wall.shape[0]), bool)
    obst[1, 0] = [20.0, 0.0, 0.0, 0.0, 0.0]
    valid[1, 0] = True
    obst[2], valid[2] = wall, True
    lat = W.plan(rp_t, W.FrenetStart(*(_t(start[:, i]) for i in range(5))),
                 CFG)
    idx, free = W.rule_trajectory_index(
        lat, P.predict_obstacles(_t(obst), _t(valid), CFG), CFG)
    lat_j = _jax_lattice(rp_j, start)
    idx_j, free_j = jax.jit(jax.vmap(lambda l, o, v: JW.rule_trajectory_index(
        l, JP.predict_obstacles(o, v, JCFG), JCFG)))(
        lat_j, jnp.asarray(obst), jnp.asarray(valid))
    np.testing.assert_array_equal(idx.numpy(), np.asarray(idx_j))
    np.testing.assert_array_equal(free.numpy(), np.asarray(free_j))
    cheapest = int(torch.argmin(lat.cf[0])) + 1
    assert int(idx[0]) == cheapest and int(idx[1]) != cheapest
    assert int(idx[2]) == 0
    for index in (idx, torch.tensor([3, 0, 7])):
        got = W.trajectory_by_index(lat, index)
        ref = jax.jit(jax.vmap(JW.trajectory_by_index))(
            lat_j, jnp.asarray(index.numpy()))
        np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), **TOL)
        np.testing.assert_allclose(got.desired_speed.numpy(),
                                   np.asarray(ref.desired_speed), **TOL)
    brake = W.trajectory_by_index(lat, idx)
    assert (brake.desired_speed[2] == 0).all()
    np.testing.assert_allclose(W.trajectory_by_index(lat, torch.tensor(
        [3, 3, 3])).xy[:, :, 0].numpy(), lat.x[:, 2].numpy())


def test_plan_with_rule_matches_jax():
    """The whole planning tick on the scenario path, from ego poses and
    obstacles around it."""
    rp_t, rp_j, line = _paths("scenario")
    rng = np.random.default_rng(4)
    b = 16
    base = line[rng.integers(0, 30, b)]
    ego = np.stack([base[:, 0] + rng.normal(0, 1, b),
                    base[:, 1] + rng.normal(0, 1, b),
                    rng.normal(0, 1, b), rng.uniform(-8, 0, b),
                    -np.pi / 2 + rng.normal(0, 0.2, b)], 1)
    ahead = np.stack([rng.normal(0, 3, (b, 3)), -rng.uniform(0, 15, (b, 3))],
                     -1)
    obst = np.concatenate([ego[:, None, :2] + ahead,
                           rng.normal(0, 2, (b, 3, 2)), np.zeros((b, 3, 1))], 2)
    valid = np.ones((b, 3), bool)
    out = W.plan_with_rule(rp_t, _t(line), _t(ego), _t(obst), _t(valid), CFG)
    ref = jax.jit(jax.vmap(lambda e, o, v: JW.plan_with_rule(
        rp_j, jnp.asarray(line), e, o, v, JCFG)))(
        jnp.asarray(ego), jnp.asarray(obst), jnp.asarray(valid))
    np.testing.assert_array_equal(out.rule_index.numpy(),
                                  np.asarray(ref.rule_index))
    np.testing.assert_array_equal(out.collision_free.numpy(),
                                  np.asarray(ref.collision_free))
    _assert_lattice(out.lattice, ref.lattice)
    assert len(set(out.rule_index.tolist())) > 2
    assert not out.collision_free.all()


def test_controller_matches_jax():
    assert float(ctl.longitudinal_pid(0.0, 5.0)) == -1.0
    assert float(ctl.longitudinal_pid(8.0, 4.0)) == pytest.approx(
        min(1.0, 0.25 / 3.6 * (8 - 4) * 3.6), abs=1e-6)
    assert float(ctl.longitudinal_pid(4.0, 20.0)) == -1.0
    rng = np.random.default_rng(5)
    b, n = 32, 13
    heading = rng.uniform(-np.pi, np.pi, b)
    step = rng.uniform(0.0, 2.5, (b, n))
    step[:4, :] = 0.0                  # standing trajectories (brake path)
    ang = heading[:, None] + np.cumsum(rng.normal(0, 0.1, (b, n)), 1)
    xy = np.stack([np.cumsum(step * np.cos(ang), 1),
                   np.cumsum(step * np.sin(ang), 1)], -1) \
        + rng.normal(0, 20, (b, 1, 2))
    ego = xy[:, 0] + rng.normal(0, 2, (b, 2))
    yaw = heading + rng.normal(0, 0.5, b)
    v = rng.uniform(0, 20, b)
    speed = rng.uniform(0, 12, (b, n))
    speed[::5, -1] = 0.0
    got = ctl.get_control(_t(ego[:, 0]), _t(ego[:, 1]), _t(yaw), _t(v),
                          _t(xy), _t(speed))
    ref = jax.jit(jax.vmap(jctl.get_control))(*(jnp.asarray(a) for a in (
        ego[:, 0], ego[:, 1], yaw, v, xy, speed)))
    np.testing.assert_allclose(got.acc.numpy(), np.asarray(ref.acc), **TOL)
    np.testing.assert_allclose(got.steering.numpy(), np.asarray(ref.steering),
                               **TOL)
    # straight ahead -> no steer; a target to the left (+y) steers left
    line = np.stack([np.linspace(0, 50, 20), np.zeros(20)], 1)
    left = np.stack([np.linspace(0, 30, 20), np.linspace(0, 10, 20)], 1)
    steer = ctl.pure_pursuit(0.0, 0.0, 0.0, 5.0, _t(np.stack([line, left])))
    assert abs(float(steer[0])) < 1e-3 and float(steer[1]) > 0.01
