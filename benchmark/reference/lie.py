"""SO(3)/SE(3) operations on (quaternion, translation) poses, on tensors.

The benchmark's frozen copy of the port's counterpart of
aruco_slam_tpu/core/lie.py, same formulas and the same conventions: a
pose is ``(q, t)`` with a scalar-first (..., 4) quaternion and a (...,
3) translation mapping local coordinates into the parent frame,
``x_world = R(q) x_local + t``; SE(3) tangent vectors are ordered
[omega, v] (GTSAM's ``Pose3::Logmap``). Every function broadcasts over
leading dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from benchmark.reference import quaternion as quat

_EPS = 1e-12


class Pose(NamedTuple):
    """SE(3) pose as scalar-first quaternion + translation."""

    q: torch.Tensor  # (..., 4) wxyz
    t: torch.Tensor  # (..., 3)


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b — apply b first, then a."""
    return Pose(quat.multiply(a.q, b.q), quat.rotate(a.q, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    qi = quat.conjugate(p.q)
    return Pose(qi, -quat.rotate(qi, p.t))


def between(a: Pose, b: Pose) -> Pose:
    """Relative pose a⁻¹ ∘ b (GTSAM ``Pose3::between`` semantics)."""
    return compose(inverse(a), b)


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric matrix [v]ₓ (batched)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)
