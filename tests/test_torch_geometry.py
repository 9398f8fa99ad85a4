"""PyTorch port: polyline geometry and the spline evaluators against the
JAX package on the same numpy inputs.

The port's functions take a batch of points where the JAX ones are
vmapped.  In float64 integer outputs (nearest vertex, hosting-segment
type, spline segment) must be bit-equal, real outputs within 1e-12 (XLA
fuses a multiply and an add into one FMA, in ``jnp.linalg.norm`` and
inside jitted functions, where the port rounds twice); the nearest vertex
is a first-minimum ``argmin``, which a point equidistant from two
vertices pins."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.ops import geometry as JG
from dcarl_tpu.ops import spline as JS
from dcarl_tpu_torch.ops import geometry as G
from dcarl_tpu_torch.ops import spline as S

TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.array(a))


def _walk(rng, n):
    steps = rng.normal(1.0, 0.4, (n - 1, 2))
    return np.concatenate([[[0.0, 0.0]], np.cumsum(steps, axis=0)])


def _ref_line():
    return np.asarray(j_t_intersection().ref_path, np.float64)


def test_wrap_angle_and_lengths_match_jax():
    th = np.asarray([0.0, 3.1, -3.1, 3 * np.pi, -2.5 * np.pi, 0.3, 7.0, -9.4])
    np.testing.assert_array_equal(G.wrap_angle(_t(th)).numpy(),
                                  np.asarray(JG.wrap_angle(jnp.asarray(th))))
    line = _ref_line()   # 46 vertices: three 16-element cumsum blocks
    np.testing.assert_allclose(G.arclengths(_t(line)).numpy(),
                               np.asarray(JG.arclengths(jnp.asarray(line))),
                               **TOL)
    np.testing.assert_allclose(float(G.polyline_length(_t(line))),
                               float(JG.polyline_length(jnp.asarray(line))),
                               **TOL)
    for num in (7, 60):
        np.testing.assert_allclose(
            G.resample_polyline(_t(line), num).numpy(),
            np.asarray(JG.resample_polyline(jnp.asarray(line), num)), **TOL)


@pytest.mark.parametrize("seed", [0, 1])
def test_projection_matches_jax_and_oracle(seed):
    rng = np.random.default_rng(seed)
    line = _walk(rng, 25)
    pts = rng.normal(0, 3, (64, 2)) + line.mean(0)
    pts[:8] = line[rng.integers(0, 25, 8)]           # on vertices
    pts[8:12] = line[0] - rng.uniform(1, 3, (4, 2))  # before the start
    pts[12:16] = line[-1] + rng.uniform(1, 3, (4, 2))  # past the end
    got = G.project_points_to_polyline(_t(pts), _t(line))
    ref = JG.project_points_to_polyline(jnp.asarray(pts), jnp.asarray(line))
    for name in ("closest_idx", "closest_type"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    for name in ("distance", "dist_start", "dist_end"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL)
    for i in range(len(pts)):
        want = G.project_point_to_polyline_np(pts[i, 0], pts[i, 1], line)
        assert int(got.closest_idx[i]) == want[1]
        assert int(got.closest_type[i]) == want[2]
        np.testing.assert_allclose(float(got.distance[i]), want[0], atol=1e-9)


def test_equidistant_point_takes_the_first_vertex():
    """A point on the perpendicular bisector of two vertices: both
    packages take the lower index (first minimum) and agree on every
    field, in float64 and float32."""
    line = np.asarray([[0.0, 0.0], [2.0, 0.0], [4.0, 1.0], [6.0, 1.0]])
    pts = np.asarray([[1.0, 0.7], [1.0, -2.5], [5.0, 3.0]])
    for dt in (np.float64, np.float32):
        got = G.project_point_to_polyline(_t(pts.astype(dt)),
                                          _t(line.astype(dt)))
        ref = JG.project_points_to_polyline(jnp.asarray(pts.astype(dt)),
                                            jnp.asarray(line.astype(dt)))
        np.testing.assert_array_equal(got.closest_idx.numpy(), [0, 0, 2])
        np.testing.assert_array_equal(got.closest_idx.numpy(),
                                      np.asarray(ref.closest_idx))
        np.testing.assert_array_equal(got.closest_type.numpy(),
                                      np.asarray(ref.closest_type))
        np.testing.assert_array_equal(got.distance.numpy(),
                                      np.asarray(ref.distance))


@pytest.mark.parametrize("tangents", [False, True])
def test_cartesian_to_frenet_matches_jax(tangents):
    rng = np.random.default_rng(3)
    line = _ref_line()
    n = 48
    base = line[rng.integers(0, len(line), n)]
    x, y = base[:, 0] + rng.normal(0, 3, n), base[:, 1] + rng.normal(0, 3, n)
    vx, vy, yaw = rng.normal(0, 5, n), rng.normal(0, 5, n), rng.normal(0, 2, n)
    tan = rng.normal(0, 1, len(line)) if tangents else None
    got = G.cartesian_to_frenet(_t(x), _t(y), _t(vx), _t(vy), _t(yaw),
                                _t(line), None if tan is None else _t(tan))
    jl = jnp.asarray(line)
    jt = None if tan is None else jnp.asarray(tan)
    ref = jax.vmap(lambda *a: JG.cartesian_to_frenet(*a, jl, jt))(
        *(jnp.asarray(a) for a in (x, y, vx, vy, yaw)))
    for name in ("s", "d", "psi", "vs", "vd"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)), **TOL)


def test_frame_transform_corners_and_curvature_match_jax():
    rng = np.random.default_rng(4)
    a = [rng.normal(0, 5, (6, 4)) for _ in range(8)]
    got = G.transfer_to_ego_frame(*(_t(v) for v in a))
    ref = JG.transfer_to_ego_frame(*(jnp.asarray(v) for v in a))
    for g, r in zip(got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), **TOL)
    cx, cy, yaw = (rng.normal(0, 5, 7) for _ in range(3))
    ln, wd = rng.uniform(2, 5, 7), rng.uniform(1, 2, 7)
    np.testing.assert_allclose(
        G.box_to_corners_2d(*(_t(v) for v in (cx, cy, yaw, ln, wd))).numpy(),
        np.asarray(JG.box_to_corners_2d(*(jnp.asarray(v) for v in
                                          (cx, cy, yaw, ln, wd)))), **TOL)
    path = _walk(rng, 30)
    np.testing.assert_allclose(
        G.curvature(_t(path[:, 0]), _t(path[:, 1])).numpy(),
        np.asarray(JG.curvature(jnp.asarray(path[:, 0]),
                                jnp.asarray(path[:, 1]))), **TOL)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spline_evaluators_match_jax(dtype):
    """On the reference path's spline, fitted by each package in
    ``dtype``, at arc lengths inside, on and outside the knots."""
    line = _ref_line().astype(dtype)
    rp_t = S.refpath_from_xy(_t(line[:, 0]), _t(line[:, 1]))
    rp_j = JS.refpath_from_xy(jnp.asarray(line[:, 0]), jnp.asarray(line[:, 1]))
    knots = np.asarray(rp_j.s)
    rng = np.random.default_rng(5)
    s = np.concatenate([rng.uniform(-5, knots[-1] + 5, 198), knots[:10],
                        [0.0, knots[-1]]]).astype(dtype).reshape(-1, 3)
    st, sj = _t(s), jnp.asarray(s)
    np.testing.assert_array_equal(S._segment_index(rp_t.sx, st).numpy(),
                                  np.asarray(JS._segment_index(rp_j.sx, sj)))
    tol = TOL if dtype == np.float64 else dict(rtol=1e-5, atol=1e-4)
    pairs = [
        (S.spline_eval(rp_t.sy, st), JS.spline_eval(rp_j.sy, sj)),
        (S.spline_d1(rp_t.sx, st), JS.spline_d1(rp_j.sx, sj)),
        (S.spline_d2(rp_t.sy, st), JS.spline_d2(rp_j.sy, sj)),
        (S.refpath_yaw(rp_t, st), JS.refpath_yaw(rp_j, sj)),
        (S.refpath_curvature(rp_t, st), JS.refpath_curvature(rp_j, sj)),
        *zip(S.refpath_position(rp_t, st), JS.refpath_position(rp_j, sj)),
        *zip(S.refpath_pos_tangent(rp_t, st), JS.refpath_pos_tangent(rp_j, sj)),
    ]
    for got, ref in pairs:
        assert got.shape == s.shape
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)


@pytest.mark.parametrize("dt", [np.float64, np.float32])
def test_project_points_to_lines_is_the_one_line_form(dt):
    """Points onto a line of their own ([..., N, 2] lines, the leading dims
    broadcast): each line's points get the one-line form's bits, and JAX's
    projection vmapped over lines agrees (f64: integers equal, reals
    within 1e-12)."""
    rng = np.random.default_rng(4)
    lines = np.stack([_walk(rng, 37) for _ in range(3)]).astype(dt)  # [3, N, 2]
    pts = (rng.normal(0, 3, (3, 5, 2)) + lines.mean(1)[:, None]).astype(dt)
    pts[:, 0] = lines[:, 0] - 1.5                      # before the starts
    pts[:, 1] = lines[:, 7]                            # on a vertex
    got = G.project_points_to_lines(_t(pts), _t(lines)[:, None])   # [3, 5]
    for b in range(3):
        one = G.project_point_to_polyline(_t(pts[b]), _t(lines[b]))
        for name in G.PolylineProjection._fields:
            assert torch.equal(getattr(got, name)[b], getattr(one, name)), name
    ref = jax.vmap(JG.project_points_to_polyline)(jnp.asarray(pts),
                                                 jnp.asarray(lines))
    for name in ("closest_idx", "closest_type"):
        np.testing.assert_array_equal(getattr(got, name).numpy(),
                                      np.asarray(getattr(ref, name)), name)
    if dt == np.float64:
        for name in ("distance", "dist_start", "dist_end"):
            np.testing.assert_allclose(getattr(got, name).numpy(),
                                       np.asarray(getattr(ref, name)), **TOL)
    # one shared line broadcast against a batch of points
    shared = G.project_points_to_lines(_t(pts), _t(lines[0]))
    one = G.project_point_to_polyline(_t(pts), _t(lines[0]))
    for name in G.PolylineProjection._fields:
        assert torch.equal(getattr(shared, name), getattr(one, name)), name


def test_cartesian_to_frenet_per_point_lines():
    """cartesian_to_frenet with [..., N, 2] lines (one for each point) is
    the one-line form's bits, line by line."""
    rng = np.random.default_rng(5)
    lines = np.stack([_walk(rng, 30) for _ in range(4)])
    tan = rng.normal(0, 1, (4, 30))
    pts = rng.normal(0, 3, (4, 2)) + lines.mean(1)
    v = rng.normal(0, 5, (3, 4))
    got = G.cartesian_to_frenet(_t(pts[:, 0]), _t(pts[:, 1]), _t(v[0]),
                                _t(v[1]), _t(v[2]), _t(lines), _t(tan))
    for b in range(4):
        one = G.cartesian_to_frenet(_t(pts[b, 0]), _t(pts[b, 1]), _t(v[0, b]),
                                    _t(v[1, b]), _t(v[2, b]), _t(lines[b]),
                                    _t(tan[b]))
        for name in G.FrenetState._fields:
            assert torch.equal(getattr(got, name)[b], getattr(one, name)), name


def test_blocked_cumsum_batches_the_one_line_sum():
    """The blocked prefix sum over the last axis of a batch is each row's
    own 1-D sum, bit for bit."""
    rng = np.random.default_rng(6)
    v = _t(rng.normal(0, 1, (3, 4, 53)).astype(np.float32))
    got = S._cumsum_blocked(v)
    for a in range(3):
        for b in range(4):
            assert torch.equal(got[a, b], S._cumsum_blocked(v[a, b]))
