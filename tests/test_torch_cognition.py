"""PyTorch port: the cognition layer (``cognition/{locator,path_buffer,
drivable}.py``) against the JAX package.

Every case of ``tests/test_cognition.py`` feeds the same map, ego and
objects to both packages (the static map carried across with
``interop.static_local_map_from_numpy``): the world model's integer and
boolean fields (map model, rounded lane, behaviours, exists, stop flags,
cursors) must be equal, real ones within rtol 1e-5 / atol 1e-4.  Then
the batch-first form: a batch of egos, each on a map of its own (the JAX
package ``vmap``-s the tick), equal to JAX's vmapped tick and to the
port's own one-env calls.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.cognition import (EgoPose, PathBufferState, StaticLocalMap,
                                 TrackedObjects, dynamic_boundary,
                                 locate_objects_in_lane, path_buffer_init,
                                 path_buffer_update, update_map_state)
from dcarl_tpu.cognition import locator as JL
from dcarl_tpu.planning.idm import longitudinal_speed
from dcarl_tpu_torch import interop
from dcarl_tpu_torch.cognition import drivable as TD
from dcarl_tpu_torch.cognition import locator as TL
from dcarl_tpu_torch.cognition import path_buffer as TPB
from dcarl_tpu_torch.planning.idm import longitudinal_speed as t_speed

CPU = torch.device("cpu")
F64 = torch.float64
TOL = dict(rtol=1e-5, atol=1e-4)


def straight_map(L=2, n=50, lane_sep=3.5, length=100.0):
    xs = jnp.linspace(0.0, length, n)
    lanes = jnp.stack([
        jnp.stack([xs, jnp.full((n,), i * lane_sep)], axis=1)
        for i in range(L)])
    return StaticLocalMap(
        lanes=lanes, tangents=jnp.zeros((L, n)),
        speed_limit=jnp.full((L,), 15.0),
        stop_thru=jnp.ones((L,), bool),
        target_lane_index=jnp.asarray(1))


def no_objects(K=4):
    z = jnp.zeros((K,))
    return TrackedObjects(x=z + 1e4, y=z, vx=z, vy=z, yaw=z,
                          valid=jnp.zeros((K,), bool))


def ego_at(x, y, vx=5.0, vy=0.0, yaw=0.0):
    return EgoPose(*(jnp.asarray(v) for v in (x, y, vx, vy, yaw)))


def t_map(smap):
    return interop.static_local_map_from_numpy(jax.device_get(smap), CPU, F64)


def t_nt(cls, nt):
    """A NamedTuple of JAX arrays as the port's class of tensors (f64
    reals, bools and ints kept)."""
    out = []
    for a in jax.device_get(nt):
        a = np.array(a)
        out.append(torch.as_tensor(a.astype(np.float64)
                                   if a.dtype.kind == "f" else a))
    return cls(*out)


def check_mmap(got, ref):
    for f in ("ego_lane_index", "ego_speed", "ego_vd", "speed_limit",
              "distance_to_junction", "target_lane_index", "stop_distance"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **TOL)
    np.testing.assert_array_equal(got.traffic_light_stop.numpy(),
                                  np.asarray(ref.traffic_light_stop))
    for side in ("front", "rear"):
        g, r = getattr(got, side), getattr(ref, side)
        np.testing.assert_array_equal(g.exists.numpy(), np.asarray(r.exists))
        for f in ("s", "d", "vs", "vd"):
            np.testing.assert_allclose(getattr(g, f).numpy(),
                                       np.asarray(getattr(r, f)),
                                       err_msg=side + f, **TOL)


_j_update = jax.jit(update_map_state)


def both_update(smap, ego, objs, **kw):
    ref = _j_update(smap, ego, objs, **kw)
    tkw = {k: t_nt(getattr(TL, type(v).__name__), v) for k, v in kw.items()}
    got = TL.update_map_state(t_map(smap), t_nt(TL.EgoPose, ego),
                              t_nt(TL.TrackedObjects, objs), **tkw)
    check_mmap(got[0], ref[0])
    assert int(got[1]) == int(ref[1])
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    return got


@pytest.mark.parametrize("y,want", [(0.0, 0.0), (3.5, 1.0), (1.75, 0.5),
                                    (0.875, 0.25), (-30.0, -1.0)],
                         ids=["lane0", "lane1", "between", "quarter", "far"])
def test_locate_objects_in_lane(y, want):
    """The contract's on-center, between-lanes and far-off cases."""
    smap = straight_map()
    ref = float(locate_objects_in_lane(jnp.asarray(50.0), jnp.asarray(y),
                                       smap.lanes))
    got = float(TL.locate_objects_in_lane(torch.tensor(50.0, dtype=F64),
                                          torch.tensor(y, dtype=F64),
                                          t_map(smap).lanes))
    assert got == pytest.approx(ref, abs=1e-9)
    assert got == pytest.approx(want, abs=1e-6)


def test_ego_midlane_multilane_model():
    mmap, model, _ = both_update(straight_map(), ego_at(50.0, 0.0),
                                 no_objects())
    assert int(model) == TL.MapModel.MULTILANE
    assert float(mmap.distance_to_junction) == pytest.approx(50.0, abs=1e-5)


def test_ego_near_lane_end_junction_model():
    _, model, _ = both_update(straight_map(), ego_at(90.0, 0.0), no_objects())
    assert int(model) == TL.MapModel.JUNCTION


def test_front_rear_assignment():
    objs = TrackedObjects(
        x=jnp.asarray([70.0, 30.0, 60.0, 55.0]),
        y=jnp.asarray([0.0, 0.0, 3.5, 0.0]),
        vx=jnp.asarray([8.0, 4.0, 6.0, 7.0]), vy=jnp.zeros((4,)),
        yaw=jnp.zeros((4,)), valid=jnp.asarray([True] * 4))
    mmap, _, behaviors = both_update(straight_map(), ego_at(50.0, 0.0), objs)
    assert float(mmap.front.s[0]) == pytest.approx(5.0, abs=1e-4)
    assert float(mmap.rear.s[0]) == pytest.approx(-20.0, abs=1e-4)
    assert bool(mmap.front.exists[1]) and (behaviors.numpy() == 0).all()


def test_behavior_lane_change_detection():
    objs = TrackedObjects(
        x=jnp.asarray([60.0, 65.0]), y=jnp.asarray([0.0, 0.0]),
        vx=jnp.asarray([5.0, 5.0]), vy=jnp.asarray([1.5, -1.5]),
        yaw=jnp.asarray([0.5, -0.5]), valid=jnp.asarray([True, True]))
    _, _, behaviors = both_update(straight_map(), ego_at(50.0, 0.0), objs)
    assert behaviors.tolist() == [1, 2]


def _route(n, length):
    return jnp.stack([jnp.linspace(0, length, n), jnp.zeros((n,))], axis=1)


def test_path_buffer_window_advances():
    route = _route(200, 199.0)
    st_j = path_buffer_init()
    st_t = TPB.path_buffer_init(device="cpu")
    troute = torch.as_tensor(np.array(route), dtype=F64)
    for x, v in ((0.0, 5.0), (50.0, 5.0), (195.0, 0.1)):
        st_j, seg_j, valid_j, junc_j = path_buffer_update(
            st_j, route, jnp.asarray(x), jnp.asarray(0.0), jnp.asarray(v))
        st_t, seg, valid, junc = TPB.path_buffer_update(
            st_t, troute, torch.tensor(x, dtype=F64),
            torch.tensor(0.0, dtype=F64), torch.tensor(v, dtype=F64))
        assert int(st_t.cursor) == int(st_j.cursor)
        assert bool(st_t.rerouting) == bool(st_j.rerouting)
        assert bool(junc) == bool(junc_j)
        np.testing.assert_array_equal(valid.numpy(), np.asarray(valid_j))
        np.testing.assert_allclose(seg.numpy(), np.asarray(seg_j), **TOL)
    assert bool(junc) and bool(st_t.rerouting) and not bool(valid.all())


def test_path_buffer_cursor_monotone():
    route = torch.as_tensor(np.array(_route(100, 99.0)), dtype=F64)
    st = TPB.path_buffer_init(device="cpu")
    st, *_ = TPB.path_buffer_update(st, route, 50.0, 0.0, 5.0)
    c = int(st.cursor)
    st, *_ = TPB.path_buffer_update(st, route, 10.0, 0.0, 5.0)
    assert int(st.cursor) == c == int(path_buffer_update(
        path_buffer_init(), _route(100, 99.0), jnp.asarray(50.0),
        jnp.asarray(0.0), jnp.asarray(5.0))[0].cursor)


def test_dynamic_boundary_obstacle_shadows_static():
    theta = jnp.linspace(-jnp.pi, jnp.pi, 400, endpoint=False)
    poly = jnp.stack([20.0 * jnp.cos(theta), 20.0 * jnp.sin(theta)], axis=1)
    obs = dict(obs_x=[8.0], obs_y=[0.0], obs_vx=[3.0], obs_vy=[0.0],
               obs_yaw=[0.0])
    ref = dynamic_boundary(jnp.asarray(0.0), jnp.asarray(0.0), poly,
                           **{k: jnp.asarray(v) for k, v in obs.items()},
                           obs_valid=jnp.asarray([True]), num_bins=128)
    got = TD.dynamic_boundary(0.0, 0.0, torch.as_tensor(np.array(poly)),
                              **{k: torch.tensor(v, dtype=F64)
                                 for k, v in obs.items()},
                              obs_valid=torch.tensor([True]), num_bins=128)
    for f in TD.DynamicBoundary._fields:
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **TOL)
    assert float(got.dist[64]) < 7.0 and float(got.vx[64]) == pytest.approx(3.0)
    assert float(got.dist[96]) == pytest.approx(20.0, abs=0.5)


def _lights(sig, valid):
    return JL.TrafficLightDetection(signal=jnp.asarray(sig, jnp.int32),
                                    valid=jnp.asarray(valid))


def test_traffic_light_red_stops_lane_stack():
    smap = straight_map()
    ego = ego_at(90.0, 0.0, vx=8.0)
    R, G = JL.LightSignal.RED.value, JL.LightSignal.GREEN.value
    for sig, stops in ((R, True), (G, False)):
        lights = _lights([sig, 0, 0, 0], [True, False, False, False])
        mmap, _, _ = both_update(smap, ego, no_objects(), lights=lights)
        assert bool(mmap.traffic_light_stop.all()) == stops
        v = t_speed(mmap, torch.tensor(0), traffic_light=True)
        v_j = longitudinal_speed(_j_update(smap, ego, no_objects(),
                                           lights=lights)[0],
                                 jnp.asarray(0), traffic_light=True)
        np.testing.assert_allclose(float(v), float(v_j), **TOL)
        assert (float(v) == 0.0) == stops
    mmap, _, _ = both_update(smap, ego, no_objects())
    assert not bool(mmap.traffic_light_stop.any())


@pytest.mark.parametrize("sig,valid", [
    ([1, 3, 0, 0], [True, True, False, False]),
    ([2, 0, 0, 0], [True, False, False, False]),
    ([1, 1, 2, 0], [True, True, True, False]),
    ([1, 3, 1, 0], [True, True, True, False]),
    ([3, 1, 0, 0], [False, False, False, False]),
    ([0, 1, 0, 3], [False, True, False, True]),
], ids=["per_lane", "yellow", "mismatch_red", "mismatch_green", "none",
        "compacted"])
def test_traffic_light_per_lane_and_mismatch_cases(sig, valid):
    det = _lights(sig, valid)
    ref = np.asarray(JL.locate_traffic_lights_in_lanes(det, 2))
    got = TL.locate_traffic_lights_in_lanes(
        TL.TrafficLightDetection(torch.tensor(sig, dtype=torch.int32),
                                 torch.tensor(valid)), 2)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), ref)


def _signs(kind, value, x, y, valid):
    return JL.RoadSignDetection(
        kind=jnp.asarray(kind, jnp.int32), value=jnp.asarray(value),
        x=jnp.asarray(x), y=jnp.asarray(y), valid=jnp.asarray(valid))


def test_stop_sign_stops_its_lane_only():
    S = JL.SignKind.STOP.value
    ego = ego_at(90.0, 0.0, vx=8.0)
    for y, stops in ((-1.0, [True, False]), (-50.0, [False, False])):
        signs = _signs([S, 0, 0], [0.0, 0.0, 0.0], [98.0, 0.0, 0.0],
                       [y, 0.0, 0.0], [True, False, False])
        mmap, _, _ = both_update(straight_map(), ego, no_objects(),
                                 signs=signs)
        assert mmap.traffic_light_stop.tolist() == stops


def test_speed_limit_sign_caps_lane():
    V = JL.SignKind.SPEED_LIMIT.value
    signs = _signs([V, V, 0], [8.0, 20.0, 0.0], [60.0, 60.0, 0.0],
                   [0.5, 3.0, 0.0], [True, True, False])
    mmap, _, _ = both_update(straight_map(), ego_at(50.0, 0.0, vx=8.0),
                             no_objects(), signs=signs)
    np.testing.assert_allclose(mmap.speed_limit.numpy(), [8.0, 15.0])


def test_batched_egos_on_maps_of_their_own():
    """B egos, each on its own two-lane map with its own objects and
    lights: the port's batch tick against JAX's vmapped tick and against
    its own one-env calls."""
    rng = np.random.default_rng(0)
    B, K = 5, 6
    maps = [straight_map(n=40 + 0 * b, length=80.0 + 10 * b) for b in range(B)]
    smap = jax.tree.map(lambda *a: jnp.stack(a), *maps)
    rot = rng.uniform(-0.4, 0.4, B)
    c, s = np.cos(rot), np.sin(rot)
    lanes = np.array(smap.lanes)
    lanes = np.einsum("bij,blnj->blni", np.stack([np.stack([c, -s], -1),
                                                  np.stack([s, c], -1)], 1),
                      lanes)
    smap = smap._replace(lanes=jnp.asarray(lanes),
                         tangents=jnp.asarray(np.broadcast_to(
                             rot[:, None, None], (B, 2, 40))))
    ex = rng.uniform(10, 60, B)
    ego_local = np.stack([ex, rng.uniform(-0.5, 4.0, B)], -1)
    ego_xy = np.einsum("bij,bj->bi", np.stack([np.stack([c, -s], -1),
                                               np.stack([s, c], -1)], 1),
                       ego_local)
    ego = EgoPose(x=jnp.asarray(ego_xy[:, 0]), y=jnp.asarray(ego_xy[:, 1]),
                  vx=jnp.asarray(rng.uniform(2, 9, B) * c),
                  vy=jnp.asarray(rng.uniform(2, 9, B) * s),
                  yaw=jnp.asarray(rot))
    off = rng.uniform(-25, 25, (B, K))
    objs = TrackedObjects(
        x=jnp.asarray(ego_xy[:, :1] + off * c[:, None]),
        y=jnp.asarray(ego_xy[:, 1:] + off * s[:, None]
                      + rng.choice([0.0, 3.5], (B, K))),
        vx=jnp.asarray(rng.uniform(0, 10, (B, K))),
        vy=jnp.asarray(rng.normal(0, 1, (B, K))),
        yaw=jnp.asarray(rot[:, None] + rng.normal(0, 0.3, (B, K))),
        valid=jnp.asarray(rng.random((B, K)) < 0.8))
    lights = _lights(rng.integers(0, 4, (B, 3)), rng.random((B, 3)) < 0.5)
    ref = jax.jit(jax.vmap(
        lambda m, e, o, li: update_map_state(m, e, o, lights=li)))(
        smap, ego, objs, lights)
    tm, te = t_map(smap), t_nt(TL.EgoPose, ego)
    to, tli = t_nt(TL.TrackedObjects, objs), t_nt(TL.TrafficLightDetection,
                                                   lights)
    got = TL.update_map_state(tm, te, to, lights=tli)
    check_mmap(got[0], ref[0])
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(ref[1]))
    np.testing.assert_array_equal(got[2].numpy(), np.asarray(ref[2]))
    assert got[0].front.exists.any() and (got[2].numpy() != 0).any()
    for b in range(B):
        one = TL.update_map_state(
            TL.StaticLocalMap(*(f[b] for f in tm)),
            TL.EgoPose(*(f[b] for f in te)),
            TL.TrackedObjects(*(f[b] for f in to)),
            lights=TL.TrafficLightDetection(*(f[b] for f in tli)))
        assert torch.equal(one[0].front.s, got[0].front.s[b])
        assert torch.equal(one[0].ego_lane_index, got[0].ego_lane_index[b])
        assert torch.equal(one[2], got[2][b])


def test_static_local_map_round_trip():
    smap = straight_map()
    tm = interop.static_local_map_from_numpy(jax.device_get(smap), CPU)
    assert tm.lanes.dtype == torch.float32 and tm.stop_thru.dtype == torch.bool
    assert tm.target_lane_index.dtype == torch.int64 and tm.num_lanes == 2
    for f in StaticLocalMap._fields:
        got = getattr(tm, f).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(getattr(smap, f)).astype(got.dtype))
    st = PathBufferState(cursor=jnp.asarray([3, 4]), rerouting=jnp.asarray(
        [False, True]))
    assert t_nt(TPB.PathBufferState, st).cursor.tolist() == [3, 4]
