"""SO(3)/SE(3) operations on (quaternion, translation) poses, on tensors.

Counterpart of aruco_slam_tpu/core/lie.py, same formulas and the same
conventions: a pose is ``(q, t)`` with a scalar-first (..., 4)
quaternion and a (..., 3) translation mapping local coordinates into
the parent frame, ``x_world = R(q) x_local + t``; SE(3) tangent vectors
are ordered [omega, v] (GTSAM's ``Pose3::Logmap``). Every function
broadcasts over leading dimensions.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aruco_slam_tpu_torch.core import quaternion as quat

_EPS = 1e-12


class Pose(NamedTuple):
    """SE(3) pose as scalar-first quaternion + translation."""

    q: torch.Tensor  # (..., 4) wxyz
    t: torch.Tensor  # (..., 3)


def identity_pose(dtype=torch.float32, device=None) -> Pose:
    return Pose(quat.identity(dtype, device),
                torch.zeros(3, dtype=dtype, device=device))


def compose(a: Pose, b: Pose) -> Pose:
    """a ∘ b — apply b first, then a."""
    return Pose(quat.multiply(a.q, b.q), quat.rotate(a.q, b.t) + a.t)


def inverse(p: Pose) -> Pose:
    qi = quat.conjugate(p.q)
    return Pose(qi, -quat.rotate(qi, p.t))


def transform(p: Pose, x: torch.Tensor) -> torch.Tensor:
    """Map local point(s) x into the parent frame: R x + t."""
    return quat.rotate(p.q, x) + p.t


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


def _so3_coeffs(angle_sq: torch.Tensor):
    """Taylor-safe A = sin(θ)/θ, B = (1 − cos θ)/θ² and C = (1 − A)/θ²
    (the JAX package's switch at θ² = 1e-10)."""
    angle = torch.sqrt(torch.clamp(angle_sq, min=_EPS))
    small = angle_sq < 1e-10
    sq = torch.clamp(angle_sq, min=_EPS)
    a = torch.where(small, 1.0 - angle_sq / 6.0, torch.sin(angle) / angle)
    b = torch.where(small, 0.5 - angle_sq / 24.0,
                    (1.0 - torch.cos(angle)) / sq)
    c = torch.where(small, 1.0 / 6.0 - angle_sq / 120.0, (1.0 - a) / sq)
    return a, b, c


def _vinv_coeff(angle_sq: torch.Tensor) -> torch.Tensor:
    """k = 1/θ² − cot(θ/2)/(2θ) of Jr⁻¹ and V⁻¹ (stable up to θ = π),
    Taylor 1/12 + θ²/720 below θ² = 1e-10."""
    angle = torch.sqrt(torch.clamp(angle_sq, min=_EPS))
    half = 0.5 * angle
    return torch.where(
        angle_sq < 1e-10, 1.0 / 12.0 + angle_sq / 720.0,
        1.0 / torch.clamp(angle_sq, min=_EPS) - torch.cos(half)
        / torch.clamp(2.0 * angle * torch.sin(half), min=_EPS))


def _eye(like: torch.Tensor) -> torch.Tensor:
    return torch.eye(3, dtype=like.dtype, device=like.device)


def so3_right_jacobian(omega: torch.Tensor) -> torch.Tensor:
    """Right Jacobian Jr(ω) of SO(3): Exp(ω+δ) ≈ Exp(ω) Exp(Jr δ)."""
    angle_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    w = skew(omega)
    _, b, c = _so3_coeffs(angle_sq)
    return _eye(omega) - b * w + c * (w @ w)


def so3_right_jacobian_inv(omega: torch.Tensor) -> torch.Tensor:
    """Inverse right Jacobian Jr⁻¹(ω) = I + ½[ω]ₓ + k[ω]ₓ² with k = 1/θ²
    − cot(θ/2)/(2θ), the JAX package's formula (stable up to θ = π).
    Below θ = 1e-3 k is its Taylor series 1/12 + θ²/720 (the JAX
    function switches at 1e-5, where float32 loses the closed form's
    digits to the 1/θ² cancellation)."""
    angle_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    small = angle_sq < 1e-6
    sq = torch.where(small, 1.0, angle_sq)
    angle = torch.sqrt(sq)
    half = 0.5 * angle
    k = torch.where(small, 1.0 / 12.0 + angle_sq / 720.0,
                    1.0 / sq - torch.cos(half) / (2.0 * angle
                                                  * torch.sin(half)))
    w = skew(omega)
    return _eye(omega) + 0.5 * w + k * (w @ w)


def se3_exp(xi: torch.Tensor) -> Pose:
    """SE(3) exponential. xi = [omega (3), v (3)] -> Pose, with
    t = V(ω) v and V = I + B W + C W²."""
    omega, v = xi[..., :3], xi[..., 3:]
    angle_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    w = skew(omega)
    _, b, c = _so3_coeffs(angle_sq)
    vmat = _eye(xi) + b * w + c * (w @ w)
    return Pose(quat.from_rotvec(omega), (vmat @ v[..., None])[..., 0])


def se3_log(p: Pose) -> torch.Tensor:
    """SE(3) logarithm -> [omega (3), v (3)], v = V⁻¹ t with
    V⁻¹ = I − W/2 + k W²."""
    omega = quat.to_rotvec(p.q)
    angle_sq = torch.sum(omega * omega, dim=-1)[..., None, None]
    w = skew(omega)
    vinv = _eye(omega) - 0.5 * w + _vinv_coeff(angle_sq) * (w @ w)
    return torch.cat([omega, (vinv @ p.t[..., None])[..., 0]], dim=-1)


def retract(p: Pose, xi: torch.Tensor) -> Pose:
    """Right retraction p ⊞ xi: rotation p.q ⊗ Exp(omega), translation
    p.t + R(p.q) v (decoupled SO3 x R³, as the JAX package's)."""
    dq = quat.from_rotvec(xi[..., :3])
    return Pose(quat.normalize(quat.multiply(p.q, dq)),
                p.t + quat.rotate(p.q, xi[..., 3:]))


def pose_to_matrix(p: Pose) -> torch.Tensor:
    """Pose -> 4x4 homogeneous transform."""
    r = quat.to_matrix(p.q)
    top = torch.cat([r, p.t[..., :, None]], dim=-1)
    bottom = torch.zeros((*p.t.shape[:-1], 1, 4), dtype=p.t.dtype,
                         device=p.t.device)
    bottom[..., 3] = 1.0
    return torch.cat([top, bottom], dim=-2)
