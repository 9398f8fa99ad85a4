"""PyTorch port: the VEG planner against the JAX package (the cases of
``tests/test_veg.py``), every case of a variant as one env of a batch.

In float64 the kick decision and the rule index must be bit-equal, the
trajectories and states within 1e-9."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.config import WerlingConfig as JWerlingConfig
from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.ops import spline as JS
from dcarl_tpu.planning import veg as JV
from dcarl_tpu.planning import werling as JW
from dcarl_tpu_torch.config import WerlingConfig
from dcarl_tpu_torch.ops import spline as S
from dcarl_tpu_torch.planning import veg as V
from dcarl_tpu_torch.planning import werling as W

TOL = dict(rtol=1e-9, atol=1e-9)
CFG, JCFG = WerlingConfig(), JWerlingConfig()

# (d_target, v_target, rl_q, rule_q) per env, and whether each variant
# kicks in (tests/test_veg.py)
CASES = [
    ((0.0, 5.0, 1.0, 0.9), False, False),     # margin 0.1 < 0.2
    ((0.0, 5.0, 1.5, 0.9), True, False),      # margin 0.6
    ((5000.0, 5.0, 9.0, 0.0), False, False),  # out of range
    ((0.0, 0.1, 9.0, 0.0), True, True),       # emergency stop (veg)
    ((0.0, 5.0, 0.0, 0.0), False, False),     # rule fallback
    ((0.0, 3.0, 1.0, 0.0), True, False),      # itsc needs > 5.0
    ((0.0, 3.0, 6.0, 0.0), True, True),
    ((0.0, -3.0, 10.0, 0.0), True, True),     # below the floors
    ((1.5, 6.0, 10.0, 0.0), True, True),
]


def _t(a):
    return torch.as_tensor(np.array(a))


@pytest.fixture(scope="module")
def setup():
    line = np.asarray(j_t_intersection().ref_path, np.float64)
    rp_t = S.refpath_from_xy(_t(line[:, 0]), _t(line[:, 1]))
    rp_j = JS.refpath_from_xy(jnp.asarray(line[:, 0]), jnp.asarray(line[:, 1]))
    b = len(CASES)
    rng = np.random.default_rng(0)
    ego = np.tile([line[2, 0], line[2, 1], 3.0, 0.0, 0.0], (b, 1))
    ego[1:, :2] += rng.normal(0, 0.3, (b - 1, 2))
    obst = np.zeros((b, 3, 5))
    obst[..., 0] = 1e4
    valid = np.zeros((b, 3), bool)
    return line, rp_t, rp_j, ego, obst, valid


def _jax(fn, *batched):
    return jax.jit(jax.vmap(fn))(*(jnp.asarray(a) for a in batched))


def test_config_copy_matches_jax():
    assert dataclasses.asdict(V.VEGConfig()) == dataclasses.asdict(
        JV.VEGConfig())
    assert dataclasses.asdict(V.itsc_config()) == dataclasses.asdict(
        JV.itsc_config())
    for name in ("THRESHOLD", "ACTION_SPACE_SYMMETRY", "KICK_IN_POINT",
                 "MIN_SPEED_RL", "ACTION_LIMIT", "VEG_STATE_DIM"):
        assert getattr(V, name) == getattr(JV, name)


def test_wrap_state_matches_jax(setup):
    """The 16-D state with obstacles present, absent and out of order,
    and the rule point."""
    line, rp_t, rp_j, ego, _, _ = setup
    rng = np.random.default_rng(1)
    b, k = ego.shape[0], 5
    obst = np.concatenate([ego[:, None, :2] + rng.normal(0, 10, (b, k, 2)),
                           rng.normal(0, 3, (b, k, 3))], 2)
    valid = rng.random((b, k)) < 0.6
    valid[0] = False                       # no obstacle at all
    out = W.plan_with_rule(rp_t, _t(line), _t(ego), _t(obst), _t(valid), CFG)
    coll, leave = torch.zeros(b), torch.ones(b)
    got = V.wrap_state(_t(line), _t(ego), _t(obst), _t(valid), coll, leave,
                       out.lattice, out.rule_index)

    def one(e, o, v):
        o_j = JW.plan_with_rule(rp_j, jnp.asarray(line), e, o, v, JCFG)
        return JV.wrap_state(jnp.asarray(line), e, o, v, jnp.zeros(()),
                             jnp.ones(()), o_j.lattice, o_j.rule_index)

    ref = _jax(one, ego, obst, valid)
    assert got.state.shape == (b, V.VEG_STATE_DIM)
    np.testing.assert_allclose(got.state.numpy(), np.asarray(ref.state), **TOL)
    np.testing.assert_allclose(got.rule_point.numpy(),
                               np.asarray(ref.rule_point), **TOL)
    np.testing.assert_allclose(got.state[0, 4:].numpy(), 0.0)
    p = out.rule_index - 1
    expect = out.lattice.s_d[torch.arange(b), p, V.KICK_IN_POINT] \
        - V.ACTION_SPACE_SYMMETRY
    np.testing.assert_allclose(got.rule_point[:, 1].numpy(), expect.numpy(),
                               **TOL)


def test_plan_rl_kick_matches_jax(setup):
    line, rp_t, rp_j, ego, _, _ = setup
    rng = np.random.default_rng(2)
    b = ego.shape[0]
    d_t, v_t = rng.normal(0, 1.5, b), rng.uniform(0, 12, b)
    start = W.start_state_from_ego(*(_t(ego[:, i]) for i in range(5)),
                                   _t(line))
    xy, speed, feasible, end = V.plan_rl_kick(rp_t, start, _t(d_t), _t(v_t),
                                              CFG)

    def one(e, d, v):
        st = JW.start_state_from_ego(e[0], e[1], e[2], e[3], e[4],
                                     jnp.asarray(line))
        return JV.plan_rl_kick(rp_j, st, d, v, JCFG)

    xy_j, speed_j, feas_j, end_j = _jax(one, ego, d_t, v_t)
    assert xy.shape == (b, CFG.n_time_steps, 2)
    np.testing.assert_allclose(xy.numpy(), np.asarray(xy_j), **TOL)
    np.testing.assert_allclose(speed.numpy(), np.asarray(speed_j), **TOL)
    np.testing.assert_array_equal(feasible.numpy(), np.asarray(feas_j))
    for g, r in zip(end, end_j):
        np.testing.assert_allclose(g.numpy(), np.broadcast_to(
            np.asarray(r), g.shape), **TOL)
    # the speed approaches the target along the horizon (the grid ends
    # one dt before T)
    ok = feasible.numpy()
    assert ok.any()
    np.testing.assert_allclose(speed[ok, -1].numpy(), v_t[ok],
                               atol=0.5 + 12.0 * CFG.dt)


@pytest.mark.parametrize("variant", ["veg", "itsc"])
def test_plan_veg_matches_jax(setup, variant):
    line, rp_t, rp_j, ego, obst, valid = setup
    vcfg_t = V.VEGConfig() if variant == "veg" else V.itsc_config()
    vcfg_j = JV.VEGConfig() if variant == "veg" else JV.itsc_config()
    cases = np.asarray([c[0] for c in CASES])
    kicks = np.asarray([c[1] if variant == "veg" else c[2] for c in CASES])
    got = V.plan_veg(rp_t, _t(line), _t(ego), _t(obst), _t(valid),
                     _t(cases[:, :2]), _t(cases[:, 2]), _t(cases[:, 3]),
                     CFG, vcfg_t)
    ref = _jax(lambda e, o, v, a, q1, q0: JV.plan_veg(
        rp_j, jnp.asarray(line), e, o, v, a, q1, q0, JCFG, vcfg_j),
        ego, obst, valid, cases[:, :2], cases[:, 2], cases[:, 3])
    np.testing.assert_array_equal(got.kicked_in.numpy(), kicks)
    np.testing.assert_array_equal(got.kicked_in.numpy(),
                                  np.asarray(ref.kicked_in))
    np.testing.assert_array_equal(got.rule_index.numpy(),
                                  np.asarray(ref.rule_index))
    np.testing.assert_allclose(got.xy.numpy(), np.asarray(ref.xy), **TOL)
    np.testing.assert_allclose(got.desired_speed.numpy(),
                               np.asarray(ref.desired_speed), **TOL)
    n_t = CFG.n_time_steps
    # the rule fallback follows the rule trajectory
    rule = W.trajectory_by_index(
        W.plan_with_rule(rp_t, _t(line), _t(ego), _t(obst), _t(valid),
                         CFG).lattice, got.rule_index)
    np.testing.assert_allclose(got.xy[4, :n_t].numpy(), rule.xy[4].numpy())
    if variant == "veg":
        assert got.xy.shape == (len(CASES), n_t, 2)
        np.testing.assert_allclose(got.desired_speed[3].numpy(), 0.0)
    else:
        # two chained segments, continuous at the seam; the floor stops
        assert got.xy.shape == (len(CASES), 2 * n_t, 2)
        seam = torch.linalg.norm(got.xy[:, n_t] - got.xy[:, n_t - 1], dim=-1)
        assert float(seam[6]) < (5.0 + 12.5 / 3.6) * CFG.dt * 3.0
        np.testing.assert_allclose(got.desired_speed[7].numpy(), 0.0)
        v_cmd = 3.0 + 12.5 / 3.6
        assert float(got.desired_speed[6, n_t - 1]) == pytest.approx(
            v_cmd, abs=0.5 + v_cmd * CFG.dt)
