"""PyTorch port: the local trajectory (keep-lane windows and hermite lane
change, ``planning/local_trajectory.py``) against the JAX package.

Every case of ``tests/test_local_trajectory.py`` runs through both
packages on the same centerline: the lane-change flag and the window
indices must be equal, the points within rtol 1e-5 / atol 1e-4.  The
port also takes one centerline per env ([B, N, 2]), which the JAX
package reaches with ``vmap`` over lines.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.planning import local_trajectory as LT
from dcarl_tpu_torch.planning import local_trajectory as TLT

TOL = dict(rtol=1e-5, atol=1e-4)


def _straight_lane(y=0.0, n=400, res=0.5):
    x = np.arange(n) * res
    return np.c_[x, np.full(n, y)].astype(np.float32)


def _both(lane, *args):
    ref = LT.get_trajectory(jnp.asarray(lane), *args)
    got = TLT.get_trajectory(torch.as_tensor(lane), *args)
    assert bool(got.lane_change) == bool(ref.lane_change)
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               **TOL)
    np.testing.assert_allclose(float(got.desired_speed),
                               float(ref.desired_speed))
    return got


def test_keep_lane_window():
    out = _both(_straight_lane(), 10.0, 0.1, 0.0, 4.0, 0.0, 0.0)
    pts = out.points.numpy()
    assert not bool(out.lane_change)
    assert abs(pts[0, 0] - 10.0) <= 0.5
    assert pts[-1, 0] <= 10.0 + 30.0 + 0.5 + 1e-5


def test_lane_change_hermite():
    out = _both(_straight_lane(y=3.5), 20.0, 0.0, 0.0, 5.0, 0.0, 1.0)
    pts = out.points.numpy()
    assert bool(out.lane_change)
    np.testing.assert_allclose(pts[0], [20.0, 0.0], atol=1e-5)
    np.testing.assert_allclose(pts[-1, 1], 3.5, atol=1e-4)
    assert abs(pts[TLT.HERMITE_PTS - 1, 0] - 27.5) < 1.0


def test_reference_path_follow_mode():
    out = _both(_straight_lane(y=4.0), 0.0, 0.0, 0.0, 4.0, 0.0, -1.0)
    assert bool(out.lane_change)
    np.testing.assert_allclose(out.points.numpy()[-1, 1], 4.0, atol=1e-4)


def test_batched_matches_jit_vmap():
    """The contract's jitted vmap over egos on one lane, and each env on a
    centerline of its own ([B, N, 2] against JAX's vmap over lines)."""
    lane = _straight_lane(y=3.5)
    xs = np.asarray([5.0, 20.0, 40.0])
    ref = jax.jit(jax.vmap(lambda x: LT.get_trajectory(
        jnp.asarray(lane), x, 0.0, 0.0, 5.0, 0.0, 1.0).points))(
            jnp.asarray(xs))
    got = TLT.get_trajectory(torch.as_tensor(lane), torch.as_tensor(xs),
                             0.0, 0.0, 5.0, 0.0, 1.0).points
    assert got.shape == (3, 64, 2) and torch.isfinite(got).all()
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)

    rng = np.random.default_rng(0)
    B = 6
    lanes = np.stack([_straight_lane(y=y) for y in rng.uniform(-4, 4, B)])
    ex, ey = rng.uniform(0, 150, B), rng.uniform(-4, 4, B)
    yaw, v = rng.uniform(-0.3, 0.3, B), rng.uniform(0, 12, B)
    tgt = rng.integers(-1, 2, B).astype(np.float64)
    ref = jax.vmap(lambda ln, *a: LT.get_trajectory(ln, *a))(
        jnp.asarray(lanes), *(jnp.asarray(a) for a in (ex, ey, yaw, v,
                                                       np.zeros(B), tgt)))
    got = TLT.get_trajectory(torch.as_tensor(lanes),
                             *(torch.as_tensor(a) for a in (ex, ey, yaw, v,
                                                            np.zeros(B), tgt)))
    np.testing.assert_array_equal(got.lane_change.numpy(),
                                  np.asarray(ref.lane_change))
    np.testing.assert_allclose(got.points.numpy(), np.asarray(ref.points),
                               **TOL)
    assert got.lane_change.any() and not got.lane_change.all()


@pytest.mark.parametrize("jdt,tdt", [(jnp.float32, torch.float32),
                                     (jnp.float64, torch.float64)],
                         ids=["f32", "f64"])
def test_hermite_grid_is_jax_linspace(jdt, tdt):
    """The hermite's ``jnp.linspace(0, 1, 20)`` rounds as numpy's does
    (``torch.linspace`` differs in one value): the grid takes numpy's
    values, bit for bit JAX's."""
    ref = np.asarray(jnp.linspace(0.0, 1.0, TLT.HERMITE_PTS, dtype=jdt))
    got = TLT._unit_grid(TLT.HERMITE_PTS, tdt, torch.device("cpu")).numpy()
    np.testing.assert_array_equal(got, ref)
