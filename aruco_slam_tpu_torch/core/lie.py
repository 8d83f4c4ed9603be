"""SO(3) helpers on tensors: counterparts of `skew` and
`so3_right_jacobian_inv` in aruco_slam_tpu/core/lie.py (the rest of
that module is not ported yet)."""

from __future__ import annotations

import torch


def skew(v: torch.Tensor) -> torch.Tensor:
    """3-vector -> 3x3 skew-symmetric matrix [v]ₓ (batched)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


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
    eye = torch.eye(3, dtype=omega.dtype, device=omega.device)
    return eye + 0.5 * w + k * (w @ w)
