"""PyTorch port: the navigation layer (``navigation/{map_provider,route,
opendrive}.py``) against the JAX package.

The cases of ``tests/test_navigation.py``, ``tests/test_route.py`` and
``tests/test_opendrive.py`` run through both packages on the same loop
map, route and OpenDrive document: indices, cursors, options, flags and
update modes must be equal, real outputs within rtol 1e-5 / atol 1e-4.
The port windows a map around each ego of a batch at once, and keeps a
route cursor for each; the JAX package ``vmap``-s both.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.cognition import EgoPose, update_map_state
from dcarl_tpu.cognition.locator import TrackedObjects
from dcarl_tpu.navigation import route as R
from dcarl_tpu.navigation import synthetic_loop_map, window_static_map
from dcarl_tpu.navigation.opendrive import LocalHdMap, parse_opendrive
from dcarl_tpu_torch.cognition import locator as TL
from dcarl_tpu_torch.navigation import map_provider as TMP
from dcarl_tpu_torch.navigation import opendrive as TOD
from dcarl_tpu_torch.navigation import route as TR

CPU = torch.device("cpu")
TOL = dict(rtol=1e-5, atol=1e-4)


def _maps(**kw):
    return synthetic_loop_map(**kw), TMP.synthetic_loop_map(device="cpu", **kw)


def _check_map(got, ref):
    for f in ("lanes", "tangents", "speed_limit"):
        np.testing.assert_allclose(getattr(got, f).numpy(),
                                   np.asarray(getattr(ref, f)), err_msg=f,
                                   **TOL)
    np.testing.assert_array_equal(got.stop_thru.numpy(),
                                  np.asarray(ref.stop_thru))
    np.testing.assert_array_equal(got.target_lane_index.numpy(),
                                  np.asarray(ref.target_lane_index))


def test_window_contains_ego_neighborhood():
    jm, tm = _maps(n_lanes=2, n_points=512, radius=100.0)
    got = TMP.window_static_map(tm, 100.0, 0.0, window=128)
    _check_map(got, window_static_map(jm, 100.0, 0.0, window=128))
    d = np.linalg.norm(got.lanes[0].numpy() - [100.0, 0.0], axis=1)
    assert got.lanes.shape == (2, 128, 2) and d.min() < 1.5
    assert 16 < int(d.argmin()) < 48


def test_window_wraps_around_loop_seam():
    jm, tm = _maps(n_lanes=1, n_points=512, radius=100.0)
    got = TMP.window_static_map(tm, 100.0, -0.1, window=64)
    _check_map(got, window_static_map(jm, 100.0, -0.1, window=64))
    assert np.linalg.norm(np.diff(got.lanes[0].numpy(), axis=0),
                          axis=1).max() < 5.0


def test_tangents_follow_loop_direction():
    jm, tm = _maps(n_lanes=1, n_points=1024, radius=100.0)
    got = TMP.window_static_map(tm, 100.0, 0.0, window=64)
    _check_map(got, window_static_map(jm, 100.0, 0.0, window=64))
    i = int(np.linalg.norm(got.lanes[0].numpy() - [100.0, 0.0], axis=1)
            .argmin())
    assert float(got.tangents[0, i]) == pytest.approx(np.pi / 2, abs=0.05)


def _no_objects(K=4, batch=()):
    def z(v=0.0):
        return torch.full(batch + (K,), v)
    return TL.TrackedObjects(x=z(1e4), y=z(), vx=z(), vy=z(), yaw=z(),
                             valid=torch.zeros(batch + (K,), dtype=torch.bool))


def _j_no_objects(K=4):
    return TrackedObjects(x=jnp.full((K,), 1e4), y=jnp.zeros((K,)),
                          vx=jnp.zeros((K,)), vy=jnp.zeros((K,)),
                          yaw=jnp.zeros((K,)), valid=jnp.zeros((K,), bool))


def _j_ego(x, y, vx, vy, yaw):
    return EgoPose(*(jnp.asarray(v) for v in (x, y, vx, vy, yaw)))


def test_provider_feeds_cognition():
    """One map per ego: three egos around the loop, each windowed and
    located at once, against JAX's tick for each."""
    jm, tm = _maps(n_lanes=2, n_points=1024, radius=200.0)
    ang = np.asarray([0.0, 1.3, 4.0])
    r = np.asarray([200.0, 196.5, 198.0])
    x, y = (r * np.cos(ang)).astype(np.float32), (r * np.sin(ang)).astype(np.float32)
    vx, vy = -8.0 * np.sin(ang), 8.0 * np.cos(ang)
    smap = TMP.window_static_map(tm, torch.as_tensor(x), torch.as_tensor(y),
                                 window=256)
    ego = TL.EgoPose(*(torch.as_tensor(v, dtype=torch.float32)
                       for v in (x, y, vx, vy, ang + np.pi / 2)))
    mmap, model, _ = TL.update_map_state(smap, ego, _no_objects(batch=(3,)))
    for b in range(3):
        jsm = window_static_map(jm, x[b], y[b], window=256)
        # eager: jitted, XLA fuses the distances' multiply-adds and may
        # pick the neighbouring vertex of a curved lane
        jmm, jmodel, _ = update_map_state(
            jsm, _j_ego(x[b], y[b], vx[b], vy[b], ang[b] + np.pi / 2),
            _j_no_objects())
        _check_map(TL.StaticLocalMap(*(f[b] for f in smap)), jsm)
        assert int(model[b]) == int(jmodel) == TL.MapModel.MULTILANE
        np.testing.assert_allclose(float(mmap.ego_lane_index[b]),
                                   float(jmm.ego_lane_index), **TOL)
        np.testing.assert_allclose(float(mmap.ego_speed[b]),
                                   float(jmm.ego_speed), **TOL)
    assert float(mmap.ego_lane_index[0]) == pytest.approx(0.0, abs=0.05)
    assert float(mmap.ego_lane_index[1]) == pytest.approx(1.0, abs=0.05)


# ---------------------------------------------------------------------------
# route
# ---------------------------------------------------------------------------


def _l_path():
    a = np.c_[np.linspace(0, 100, 21), np.zeros(21)]
    b = np.c_[np.full(20, 100.0), np.linspace(5, 100, 20)]
    return np.vstack([a, b])


def _routes(batch=()):
    return R.make_route(_l_path()), TR.make_route(_l_path(),
                                                  batch_shape=batch,
                                                  device="cpu")


def test_make_route_sampling_and_options():
    jr, tr = _routes()
    np.testing.assert_allclose(tr.waypoints.numpy(), np.asarray(jr.waypoints),
                               **TOL)
    np.testing.assert_array_equal(tr.options.numpy(), np.asarray(jr.options))
    assert (tr.options.numpy() == int(TR.RoadOption.LEFT)).sum() >= 1


def test_advance_and_window_roll_forward():
    jr, tr = _routes()
    for x, y in ((30.0, 0.0), (0.0, 0.0), (100.0, 30.0)):
        jr, tr = R.advance(jr, x, y), TR.advance(tr, x, y)
        assert int(tr.cursor) == int(jr.cursor)
        wj, oj = R.window(jr, 5)
        wt, ot = TR.window(tr, 5)
        np.testing.assert_allclose(wt.numpy(), np.asarray(wj), **TOL)
        np.testing.assert_array_equal(ot.numpy(), np.asarray(oj))
        np.testing.assert_allclose(float(TR.distance_remaining(tr)),
                                   float(R.distance_remaining(jr)), **TOL)
    assert float(TR.distance_remaining(tr)) < float(
        TR.distance_remaining(_routes()[1]))


def test_advance_batched_matches_jax_scan():
    """The contract's jitted scan of advance/window for one ego against the
    port's cursors for three egos at once (the first one on the scan's
    path, one ahead of it, one behind)."""
    jr, _ = _routes()

    def body(rt, x):
        rt = R.advance(rt, x, 0.0)
        return rt, R.window(rt, 4)[0]

    xs = np.linspace(0.0, 90.0, 10)
    _, wins = jax.jit(lambda r, v: jax.lax.scan(body, r, v))(
        jr, jnp.asarray(xs))
    _, tr = _routes((3,))
    offsets = torch.tensor([0.0, 7.0, -3.0])
    for k, x in enumerate(xs):
        tr = TR.advance(tr, x + offsets, torch.zeros(3))
        np.testing.assert_allclose(TR.window(tr, 4)[0][0].numpy(),
                                   np.asarray(wins[k]), **TOL)
    c = tr.cursor.tolist()
    assert c[1] > c[0] > c[2]


def test_vehicle_hazard():
    jr, tr = _routes()
    jr, tr = R.advance(jr, 10.0, 0.0), TR.advance(tr, 10.0, 0.0)
    veh = np.asarray([[20.0, 0.5], [20.0, 10.0], [5.0, 0.0]], np.float32)
    cases = [([True, True, True], veh), ([False, True, True], veh),
             ([True], np.asarray([[80.0, 0.0]], np.float32))]
    got = [bool(TR.hazard_vehicle_ahead(tr, 10.0, 0.0, torch.as_tensor(v),
                                        torch.tensor(ok))) for ok, v in cases]
    ref = [bool(R.hazard_vehicle_ahead(jr, 10.0, 0.0, jnp.asarray(v),
                                       jnp.asarray(ok))) for ok, v in cases]
    assert got == ref == [True, False, False]


def test_red_light_hazard():
    jr, tr = _routes()
    lights = np.asarray([[12.0, 0.0]], np.float32)
    got = [bool(TR.hazard_red_light(tr, 5.0, 0.0, torch.as_tensor(lights),
                                    torch.tensor([red]))) for red in (True, False)]
    ref = [bool(R.hazard_red_light(jr, 5.0, 0.0, jnp.asarray(lights),
                                   jnp.asarray([red]))) for red in (True, False)]
    assert got == ref == [True, False]


def test_hazards_per_ego_cursor():
    """Egos at different cursors on one route, each with its own vehicles:
    the port's batch against JAX's call for each ego."""
    jr, tr = _routes((3,))
    ex = np.asarray([10.0, 40.0, 100.0], np.float32)
    ey = np.asarray([0.0, 0.0, 20.0], np.float32)
    tr = TR.advance(tr, torch.as_tensor(ex), torch.as_tensor(ey))
    rng = np.random.default_rng(0)
    veh = np.stack([ex, ey], -1)[:, None] + rng.uniform(-12, 12, (3, 5, 2))
    veh = veh.astype(np.float32)
    ok = rng.random((3, 5)) < 0.8
    got = TR.hazard_vehicle_ahead(tr, torch.as_tensor(ex), torch.as_tensor(ey),
                                  torch.as_tensor(veh), torch.as_tensor(ok),
                                  lane_half_width=4.0)
    for b in range(3):
        rb = R.advance(jr, ex[b], ey[b])
        assert int(tr.cursor[b]) == int(rb.cursor)
        assert bool(got[b]) == bool(R.hazard_vehicle_ahead(
            rb, ex[b], ey[b], jnp.asarray(veh[b]), jnp.asarray(ok[b]),
            lane_half_width=4.0))


# ---------------------------------------------------------------------------
# OpenDrive
# ---------------------------------------------------------------------------

from test_opendrive import XODR  # noqa: E402  (the contract's network)


def test_parse_roads_and_lanes():
    roads_j, junctions_j = parse_opendrive(XODR)
    roads, junctions = TOD.parse_opendrive(XODR)
    assert set(roads) == set(roads_j) == {"1", "5", "2"}
    for rid in roads:
        assert roads[rid].lane_ids == roads_j[rid].lane_ids
        assert roads[rid].speed_limit == roads_j[rid].speed_limit
        for a, b in zip(roads[rid].lane_lines, roads_j[rid].lane_lines):
            np.testing.assert_array_equal(a, b)
    assert {k: [(c.incoming_road, c.connecting_road, c.lane_links)
                for c in v] for k, v in junctions.items()} == \
        {k: [(c.incoming_road, c.connecting_road, c.lane_links)
             for c in v] for k, v in junctions_j.items()}
    np.testing.assert_allclose(roads["1"].lane_lines[0][:, 1], -5.25,
                               atol=1e-6)


def _hd_maps():
    return (LocalHdMap(XODR, route=["1", "2"]),
            TOD.LocalHdMap(XODR, route=["1", "2"], device="cpu"))


def test_locate_excludes_junction_roads():
    jm, tm = _hd_maps()
    for x, y in ((50.0, -1.75), (50.0, -5.25), (105.0, -1.75)):
        assert tm.locate(x, y) == jm.locate(x, y)
    assert tm.locate(105.0, -1.75) is None


def test_update_protocol_edge_change_and_junction():
    jm, tm = _hd_maps()
    for x in (20.0, 50.0, 95.0, 105.0, 150.0):
        ref, got = jm.update(x, -1.75), tm.update(x, -1.75)
        assert (got is None) == (ref is None)
        assert tm.in_junction == jm.in_junction
        if got is not None:
            _check_map(got, ref)
    assert tm.in_junction is False and not bool(got.stop_thru.any())


def test_cognition_consumes_hdmap_window():
    jm, tm = _hd_maps()
    jsm, tsm = jm.update(20.0, -1.75), tm.update(20.0, -1.75)
    for x in (20.0, 95.0):
        ref = update_map_state(jsm, _j_ego(x, -1.75, 8.0, 0.0, 0.0),
                               _j_no_objects())
        got = TL.update_map_state(tsm, TL.EgoPose(*(torch.tensor(v) for v in (
            x, -1.75, 8.0, 0.0, 0.0))), _no_objects())
        assert int(got[1]) == int(ref[1])
        np.testing.assert_allclose(float(got[0].ego_lane_index),
                                   float(ref[0].ego_lane_index), **TOL)
    assert int(got[1]) == TL.MapModel.JUNCTION
