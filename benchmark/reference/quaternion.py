"""Quaternion algebra in scalar-first (w, x, y, z) convention, on tensors.

The benchmark's frozen copy of the port's counterpart of
aruco_slam_tpu/core/quaternion.py, same formulas. All functions act on
the trailing axis of size 4 and broadcast over leading dimensions.
"""

from __future__ import annotations

import torch

_EPS = 1e-12


def identity(dtype=torch.float32, device=None) -> torch.Tensor:
    """[1, 0, 0, 0], made on the device (no host-to-device copy)."""
    return torch.eye(1, 4, dtype=dtype, device=device)[0]


def normalize(q: torch.Tensor) -> torch.Tensor:
    """Normalize to unit quaternion (safe at zero norm)."""
    n = torch.linalg.vector_norm(q, dim=-1, keepdim=True)
    return q / torch.clamp(n, min=_EPS)


def conjugate(q: torch.Tensor) -> torch.Tensor:
    """[w, -x, -y, -z] (no host-to-device copy: a solve that reads
    nothing back can use it under torch.cuda.set_sync_debug_mode)."""
    return torch.cat([q[..., :1], -q[..., 1:]], dim=-1)


def multiply(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Hamilton product a ⊗ b (scalar-first)."""
    aw, ax, ay, az = a.unbind(-1)
    bw, bx, by, bz = b.unbind(-1)
    return torch.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        dim=-1,
    )


def _cross(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    a, b = torch.broadcast_tensors(a, b)
    return torch.linalg.cross(a, b, dim=-1)


def rotate(q: torch.Tensor, v: torch.Tensor) -> torch.Tensor:
    """Rotate vector(s) v by unit quaternion(s) q (expanded Rodrigues)."""
    w = q[..., :1]
    u = q[..., 1:]
    uv = _cross(u, v)
    return v + 2.0 * (w * uv + _cross(u, uv))


def to_matrix(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> 3x3 rotation matrix."""
    w, x, y, z = q.unbind(-1)
    xx, yy, zz = x * x, y * y, z * z
    wx, wy, wz = w * x, w * y, w * z
    xy, xz, yz = x * y, x * z, y * z
    m = torch.stack(
        [
            1.0 - 2.0 * (yy + zz), 2.0 * (xy - wz), 2.0 * (xz + wy),
            2.0 * (xy + wz), 1.0 - 2.0 * (xx + zz), 2.0 * (yz - wx),
            2.0 * (xz - wy), 2.0 * (yz + wx), 1.0 - 2.0 * (xx + yy),
        ],
        dim=-1,
    )
    return m.reshape(*q.shape[:-1], 3, 3)


def from_matrix(m: torch.Tensor) -> torch.Tensor:
    """3x3 rotation matrix -> unit quaternion (largest-pivot branch)."""
    m00, m01, m02 = m[..., 0, 0], m[..., 0, 1], m[..., 0, 2]
    m10, m11, m12 = m[..., 1, 0], m[..., 1, 1], m[..., 1, 2]
    m20, m21, m22 = m[..., 2, 0], m[..., 2, 1], m[..., 2, 2]
    tr = m00 + m11 + m22

    def _safe_sqrt(x):
        return torch.sqrt(torch.clamp(x, min=_EPS))

    qw0 = _safe_sqrt(1.0 + tr) / 2.0
    q0 = torch.stack(
        [qw0, (m21 - m12) / (4 * qw0), (m02 - m20) / (4 * qw0),
         (m10 - m01) / (4 * qw0)], dim=-1)
    qx1 = _safe_sqrt(1.0 + m00 - m11 - m22) / 2.0
    q1 = torch.stack(
        [(m21 - m12) / (4 * qx1), qx1, (m01 + m10) / (4 * qx1),
         (m02 + m20) / (4 * qx1)], dim=-1)
    qy2 = _safe_sqrt(1.0 - m00 + m11 - m22) / 2.0
    q2 = torch.stack(
        [(m02 - m20) / (4 * qy2), (m01 + m10) / (4 * qy2), qy2,
         (m12 + m21) / (4 * qy2)], dim=-1)
    qz3 = _safe_sqrt(1.0 - m00 - m11 + m22) / 2.0
    q3 = torch.stack(
        [(m10 - m01) / (4 * qz3), (m02 + m20) / (4 * qz3),
         (m12 + m21) / (4 * qz3), qz3], dim=-1)
    pivots = torch.stack([tr, m00 - m11 - m22, -m00 + m11 - m22,
                          -m00 - m11 + m22], dim=-1)
    best = torch.argmax(pivots, dim=-1)[..., None]
    q = torch.where(best == 0, q0,
                    torch.where(best == 1, q1,
                                torch.where(best == 2, q2, q3)))
    return normalize(q)


def to_rotvec(q: torch.Tensor) -> torch.Tensor:
    """Unit quaternion -> rotation vector (axis * angle)."""
    q = torch.where(q[..., :1] < 0, -q, q)  # shortest arc
    w = torch.clamp(q[..., :1], -1.0, 1.0)
    v = q[..., 1:]
    sin_sq = torch.sum(v * v, dim=-1, keepdim=True)
    sin_half = torch.sqrt(torch.clamp(sin_sq, min=_EPS))
    angle = 2.0 * torch.atan2(sin_half, w)
    small = sin_sq < 1e-12
    k = torch.where(small, 2.0 + sin_sq / 3.0, angle / sin_half)
    return v * k
