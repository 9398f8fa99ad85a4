"""PyTorch port: rigid-body kinematics and the motion models against the
JAX package (the cases of ``tests/test_kinematics.py`` and
``tests/test_motion_models.py``), and the Fresnel integrals against
``scipy.special.fresnel``.

Random bodies and states from a numpy seed go to both packages in
float64; outputs agree within 1e-12 (1e-9 through the clothoid model,
whose Fresnel branches the port evaluates in float64 on clipped inputs,
as the JAX package does in float64)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.special
import torch
import torch_threads  # noqa: F401 (caps intra-op threads under xdist)

from dcarl_tpu.env.scenario import t_intersection as j_t_intersection
from dcarl_tpu.ops import kinematics as JK
from dcarl_tpu.ops import motion_models as JM
from dcarl_tpu_torch.ops import kinematics as K
from dcarl_tpu_torch.ops import motion_models as M

TOL = dict(rtol=1e-12, atol=1e-12)


def _t(a):
    return torch.as_tensor(np.array(a))


def _bodies(rng, n):
    """n random bodies as numpy fields (unit-ish quaternions)."""
    q = rng.normal(0, 1, (n, 4))
    return [rng.normal(0, 3, (n, 3)), q / np.linalg.norm(q, axis=1,
                                                         keepdims=True)] \
        + [rng.normal(0, 2, (n, 3)) for _ in range(4)]


def test_quaternion_helpers_match_jax():
    rng = np.random.default_rng(0)
    q1, q2 = rng.normal(0, 1, (2, 9, 4))
    yaw = rng.uniform(-3, 3, 9)
    pairs = [
        (K.quaternion_multiply(_t(q1), _t(q2)),
         JK.quaternion_multiply(jnp.asarray(q1), jnp.asarray(q2))),
        (K.quaternion_to_matrix(_t(q1)), JK.quaternion_to_matrix(jnp.asarray(q1))),
        (K.yaw_to_quaternion(_t(yaw)), JK.yaw_to_quaternion(jnp.asarray(yaw))),
        (K.quaternion_yaw(_t(q2)), JK.quaternion_yaw(jnp.asarray(q2))),
    ]
    for got, ref in pairs:
        np.testing.assert_allclose(got.numpy(), np.asarray(ref), **TOL)
    # the round trip and the planar rotation (tests/test_kinematics.py:17)
    np.testing.assert_allclose(
        K.quaternion_yaw(K.yaw_to_quaternion(_t(yaw))).numpy(), yaw, **TOL)
    c, s = np.cos(0.7), np.sin(0.7)
    np.testing.assert_allclose(
        K.quaternion_to_matrix(K.yaw_to_quaternion(torch.tensor(0.7,
                               dtype=torch.float64))).numpy(),
        [[c, -s, 0], [s, c, 0], [0, 0, 1]], atol=1e-12)


@pytest.mark.parametrize("batched_base", [False, True])
def test_absolute_state_matches_jax(batched_base):
    """A batch of bodies against one base (the JAX package's
    ``get_absolute_state_batch``) or each against its own base."""
    rng = np.random.default_rng(1)
    rel, base = _bodies(rng, 16), _bodies(rng, 16 if batched_base else 1)
    if not batched_base:
        base = [b[0] for b in base]
    got = K.get_absolute_state(K.RigidBodyState(*map(_t, rel)),
                               K.RigidBodyState(*map(_t, base)))
    jrel = JK.RigidBodyState(*map(jnp.asarray, rel))
    jbase = JK.RigidBodyState(*map(jnp.asarray, base))
    if batched_base:
        ref = jax.vmap(JK.get_absolute_state)(jrel, jbase)
    else:
        ref = JK.get_absolute_state_batch(jrel, jbase)
    for name, g, r in zip(K.RigidBodyState._fields, got, ref):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), err_msg=name,
                                   **TOL)


def test_identity_base_and_create_defaults():
    rel = K.RigidBodyState.create(
        position=[1.0, 2.0, 0.0], linear_vel=[3.0, 0.0, 0.0],
        linear_acc=[0.5, 0.1, 0.0],
        orientation=K.yaw_to_quaternion(torch.tensor(0.3)),
        dtype=torch.float64, device="cpu")
    out = K.get_absolute_state(rel, K.RigidBodyState.create(
        dtype=torch.float64, device="cpu"))
    for a, b in zip(out, rel):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-12)
    # centripetal term: a body at r = 2 on a base spinning at w = 3
    spin = K.RigidBodyState.create(angular_vel=[0.0, 0.0, 3.0],
                                   dtype=torch.float64, device="cpu")
    far = K.RigidBodyState.create(position=[2.0, 0.0, 0.0],
                                  dtype=torch.float64, device="cpu")
    np.testing.assert_allclose(
        K.get_absolute_state(far, spin).linear_acc.numpy(),
        [-18.0, 0.0, 0.0], atol=1e-12)


def test_frenet_state_matches_jax():
    rng = np.random.default_rng(2)
    line = np.asarray(j_t_intersection().ref_path, np.float64)
    body = _bodies(rng, 24)
    body[0] = np.concatenate([line[rng.integers(0, len(line), 24)]
                              + rng.normal(0, 2, (24, 2)),
                              np.zeros((24, 1))], 1)
    got = K.get_frenet_state(K.RigidBodyState(*map(_t, body)), _t(line))
    ref = jax.vmap(lambda *b: JK.get_frenet_state(JK.RigidBodyState(*b),
                                                  jnp.asarray(line)))(
        *map(jnp.asarray, body))
    for name in ("s", "d", "psi", "vs", "vd"):
        np.testing.assert_allclose(getattr(got, name).numpy(),
                                   np.asarray(getattr(ref, name)),
                                   err_msg=name, **TOL)


def test_fresnel_matches_scipy_and_jax():
    x = np.concatenate([np.linspace(-12.0, 12.0, 4001),
                        [0.0, 1e-8, -1e-8, 3.1999, 3.2, 3.2001, 100.0, -57.3]])
    s_ref, c_ref = scipy.special.fresnel(x)
    s, c = M.fresnel(_t(x))
    np.testing.assert_allclose(s.numpy(), s_ref, atol=5e-8)
    np.testing.assert_allclose(c.numpy(), c_ref, atol=5e-8)
    s_j, c_j = jax.jit(JM.fresnel)(jnp.asarray(x))
    np.testing.assert_allclose(s.numpy(), np.asarray(s_j), atol=1e-12)
    np.testing.assert_allclose(c.numpy(), np.asarray(c_j), atol=1e-12)
    # f32 in, f32 out: both branches run in f64, so no NaN and no
    # power-series cancellation near the crossover
    s32, c32 = M.fresnel(_t(x.astype(np.float32)))
    assert s32.dtype == torch.float32 and torch.isfinite(s32).all()
    np.testing.assert_allclose(c32.numpy(), c_ref, atol=1e-6)


def _states(rng, n, w_col, kind):
    if kind == "ctrv":
        return np.stack([rng.normal(0, 1, n), rng.normal(0, 1, n),
                         rng.uniform(-3, 3, n), rng.uniform(0, 20, n),
                         w_col], 1)
    if kind == "ctra":
        return np.stack([rng.normal(0, 1, n), rng.normal(0, 1, n),
                         rng.uniform(-3, 3, n), rng.uniform(0, 20, n),
                         rng.normal(0, 2, n), w_col], 1)
    return np.stack([rng.normal(0, 1, n), rng.normal(0, 1, n),
                     rng.uniform(-1, 1, n), rng.uniform(1, 15, n),
                     rng.uniform(0.5, 3.0, n), rng.uniform(0.01, 0.2, n)], 1)


@pytest.mark.parametrize("kind", ["br", "cv", "ca", "ctrv", "ctra", "csaa"])
def test_motion_models_match_jax(kind):
    rng = np.random.default_rng(3)
    n = 40
    # turn rates include the straight-line branch (0 and below 1e-8)
    w = np.concatenate([np.zeros(8), np.full(8, 1e-12),
                        rng.normal(0, 0.7, n - 16)])
    st = {"br": rng.normal(size=(n, 4)), "cv": rng.normal(size=(n, 5)),
          "ca": rng.normal(size=(n, 6))}.get(kind)
    if st is None:
        st = _states(rng, n, w, kind)
    dt = 0.1
    x = _t(st)
    got = getattr(M, f"motion_{kind}")(x, dt)
    ref = getattr(JM, f"motion_{kind}")(jnp.asarray(st), dt)
    tol = dict(rtol=1e-9, atol=1e-9) if kind == "csaa" else TOL
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), **tol)
    assert torch.isfinite(got).all()
    np.testing.assert_array_equal(x.numpy(), st)   # the input is not written


def test_motion_model_limits():
    out = M.motion_ctrv(torch.tensor([0.0, 0.0, 0.0, 10.0, 0.0],
                                     dtype=torch.float64), 1.0)
    np.testing.assert_allclose(out.numpy(), [10.0, 0.0, 0.0, 10.0, 0.0],
                               atol=1e-12)
    r = 4.0
    out = M.motion_ctrv(torch.tensor([0.0, 0.0, 0.0, r * np.pi / 2, np.pi / 2],
                                     dtype=torch.float64), 1.0)
    np.testing.assert_allclose(out[:2].numpy(), [r, r], atol=1e-9)
    out = M.motion_ca(torch.tensor([0.0, 0.0, 1.0, 0.0, 2.0, -1.0],
                                   dtype=torch.float64), 2.0)
    np.testing.assert_allclose(out.numpy(), [6.0, -2.0, 5.0, -2.0, 2.0, -1.0])
