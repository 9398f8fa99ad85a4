"""Rigid-body kinematics: frame composition and Cartesian -> Frenet,
batch-first (the JAX package's ``ops/kinematics.py``; the reference's
compiled kinematics, software/src/library/src/zzz_common/kinematics.pyx).

A :class:`RigidBodyState` is a tuple of tensors with any leading dims;
the full composition (quaternion orientation, velocity with omega x r
transport, acceleration with centripetal, Euler and Coriolis terms,
kinematics.pyx:18-113) broadcasts a batch of bodies against one base or
a batch of bases.  Rotations are written as elementwise sums, so no
matrix product (and no TF32 on the card) enters.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from dcarl_tpu_torch.device import resolve_device
from dcarl_tpu_torch.ops.geometry import FrenetState, cartesian_to_frenet


class RigidBodyState(NamedTuple):
    """Pose, twist and acceleration of bodies in some frame (the
    RigidBodyState message without covariances)."""

    position: torch.Tensor     # [.., 3]
    orientation: torch.Tensor  # [.., 4] quaternion (x, y, z, w)
    linear_vel: torch.Tensor   # [.., 3]
    angular_vel: torch.Tensor  # [.., 3]
    linear_acc: torch.Tensor   # [.., 3]
    angular_acc: torch.Tensor  # [.., 3]

    @classmethod
    def create(cls, position=None, orientation=None, linear_vel=None,
               angular_vel=None, linear_acc=None, angular_acc=None,
               dtype: torch.dtype = torch.float32, device=None):
        device = resolve_device(device)
        z3 = torch.zeros((3,), dtype=dtype, device=device)
        qi = torch.tensor([0.0, 0.0, 0.0, 1.0], dtype=dtype, device=device)

        def pick(v, default):
            return default if v is None else torch.as_tensor(
                v, dtype=dtype, device=device)

        return cls(pick(position, z3), pick(orientation, qi),
                   pick(linear_vel, z3), pick(angular_vel, z3),
                   pick(linear_acc, z3), pick(angular_acc, z3))


def quaternion_multiply(q1: torch.Tensor, q2: torch.Tensor) -> torch.Tensor:
    """Hamilton product, (x, y, z, w) layout (the tf.transformations
    convention of kinematics.pyx:59)."""
    x1, y1, z1, w1 = q1.unbind(-1)
    x2, y2, z2, w2 = q2.unbind(-1)
    return torch.stack([
        w1 * x2 + x1 * w2 + y1 * z2 - z1 * y2,
        w1 * y2 - x1 * z2 + y1 * w2 + z1 * x2,
        w1 * z2 + x1 * y2 - y1 * x2 + z1 * w2,
        w1 * w2 - x1 * x2 - y1 * y2 - z1 * z2,
    ], dim=-1)


def quaternion_to_matrix(q: torch.Tensor) -> torch.Tensor:
    """[.., 4] (x, y, z, w) -> [.., 3, 3] rotation matrix."""
    q = q / torch.linalg.norm(q, dim=-1, keepdim=True)
    x, y, z, w = q.unbind(-1)
    return torch.stack([
        torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - z * w),
                     2 * (x * z + y * w)], dim=-1),
        torch.stack([2 * (x * y + z * w), 1 - 2 * (x * x + z * z),
                     2 * (y * z - x * w)], dim=-1),
        torch.stack([2 * (x * z - y * w), 2 * (y * z + x * w),
                     1 - 2 * (x * x + y * y)], dim=-1),
    ], dim=-2)


def yaw_to_quaternion(yaw) -> torch.Tensor:
    half = torch.as_tensor(yaw) / 2.0
    zero = torch.zeros_like(half)
    return torch.stack([zero, zero, torch.sin(half), torch.cos(half)], dim=-1)


def quaternion_yaw(q: torch.Tensor) -> torch.Tensor:
    x, y, z, w = q.unbind(-1)
    return torch.atan2(2.0 * (w * z + x * y), 1.0 - 2.0 * (y * y + z * z))


def _rotate(rot: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """``rot @ v`` for [.., 3, 3] and [.., 3], summed column by column."""
    return (rot[..., 0] * v[..., 0, None] + rot[..., 1] * v[..., 1, None]
            + rot[..., 2] * v[..., 2, None])


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def get_absolute_state(rel: RigidBodyState, base: RigidBodyState
                       ) -> RigidBodyState:
    """Full rigid-body frame composition (kinematics.pyx:18-113):

      q_abs = q_base * q_rel
      r_abs = R_base r_rel + r_base
      w_abs = R_base w_rel + w_base
      v_abs = v_base + w_base x (R_base r_rel) + R_base v_rel
      a_abs = a_base + e_base x r + w x (w x r) + a_rel + 2 w x v_rel

    Two reference quirks are kept: the base's angular and linear
    accelerations are rotated by R_base (pyx:100, 110) though they are
    already in the static frame, and ``t_rel.dot(R_base.T)`` (pyx:71)
    rotates by R.  ``rel`` and ``base`` broadcast over leading dims (one
    base for a batch of bodies is the JAX package's
    ``get_absolute_state_batch``)."""
    rot = quaternion_to_matrix(base.orientation)
    r_rel = _rotate(rot, rel.position)
    w_rel = _rotate(rot, rel.angular_vel)
    v_rel = _rotate(rot, rel.linear_vel)
    e_base = _rotate(rot, base.angular_acc)
    a_base = _rotate(rot, base.linear_acc)
    w = base.angular_vel

    q_abs = quaternion_multiply(base.orientation, rel.orientation)
    r_abs = r_rel + base.position
    w_abs = w_rel + w
    v_abs = base.linear_vel + _cross(w, r_rel) + v_rel
    e_abs = e_base + rel.angular_acc + _cross(w, w_rel)
    a_abs = (a_base + _cross(e_base, r_rel) + _cross(w, _cross(w, r_rel))
             + rel.linear_acc + 2.0 * _cross(w, v_rel))
    return RigidBodyState(r_abs, q_abs, v_abs, w_abs, a_abs, e_abs)



def get_frenet_state(state: RigidBodyState, line: torch.Tensor,
                     tangents: Optional[torch.Tensor] = None) -> FrenetState:
    """RigidBodyState -> FrenetSerretState2D along a polyline
    (kinematics.pyx:115-178): the planar projection of the 3-D state."""
    yaw = quaternion_yaw(state.orientation)
    return cartesian_to_frenet(state.position[..., 0], state.position[..., 1],
                               state.linear_vel[..., 0],
                               state.linear_vel[..., 1], yaw, line, tangents)
