"""Pinhole camera with 5-term radial-tangential distortion, on tensors.

Counterpart of aruco_slam_tpu/core/camera.py (OpenCV's model, with
distortion coefficients ordered k1, k2, p1, p2, k3). `undistort_image`
and `bilinear_sample` are not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class CameraModel(NamedTuple):
    """Intrinsics + distortion; fields are scalar tensors and a (5,)
    distortion tensor."""

    fx: torch.Tensor
    fy: torch.Tensor
    cx: torch.Tensor
    cy: torch.Tensor
    dist: torch.Tensor  # (5,) = k1, k2, p1, p2, k3

    @classmethod
    def from_matrix(cls, k, dist, dtype=None, device=None
                    ) -> "CameraModel":
        """Build from a 3x3 intrinsic matrix + (5,) distortion vector
        (tensors or arrays; dtype defaults to the matrix's)."""
        k = torch.as_tensor(k, dtype=dtype, device=device)
        dist = torch.as_tensor(dist, dtype=k.dtype,
                               device=k.device).reshape(-1)[:5]
        return cls(k[0, 0], k[1, 1], k[0, 2], k[1, 2], dist)

    def to(self, dtype=None, device=None) -> "CameraModel":
        return CameraModel(*(t.to(dtype=dtype, device=device)
                             for t in self))


def distort(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    """Apply distortion to normalized image coords (..., 2)."""
    k1, k2, p1, p2, k3 = cam.dist.unbind(-1)
    x, y = xy[..., 0], xy[..., 1]
    r2 = x * x + y * y
    radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
    xd = x * radial + 2.0 * p1 * x * y + p2 * (r2 + 2.0 * x * x)
    yd = y * radial + p1 * (r2 + 2.0 * y * y) + 2.0 * p2 * x * y
    return torch.stack([xd, yd], dim=-1)


def undistort(cam: CameraModel, xy_d: torch.Tensor, iters: int = 8
              ) -> torch.Tensor:
    """Invert `distort` by a fixed number of fixed-point iterations."""
    k1, k2, p1, p2, k3 = cam.dist.unbind(-1)
    x = xy_d[..., 0]
    y = xy_d[..., 1]
    xu, yu = x, y
    for _ in range(iters):
        r2 = xu * xu + yu * yu
        radial = 1.0 + r2 * (k1 + r2 * (k2 + r2 * k3))
        dx = 2.0 * p1 * xu * yu + p2 * (r2 + 2.0 * xu * xu)
        dy = p1 * (r2 + 2.0 * yu * yu) + 2.0 * p2 * xu * yu
        xu = (x - dx) / radial
        yu = (y - dy) / radial
    return torch.stack([xu, yu], dim=-1)


def normalized_to_pixel(cam: CameraModel, xy: torch.Tensor) -> torch.Tensor:
    u = cam.fx * xy[..., 0] + cam.cx
    v = cam.fy * xy[..., 1] + cam.cy
    return torch.stack([u, v], dim=-1)


def pixel_to_normalized(cam: CameraModel, uv: torch.Tensor) -> torch.Tensor:
    x = (uv[..., 0] - cam.cx) / cam.fx
    y = (uv[..., 1] - cam.cy) / cam.fy
    return torch.stack([x, y], dim=-1)


def project(cam: CameraModel, pts_cam: torch.Tensor,
            eps: float = 1e-9) -> torch.Tensor:
    """Project camera-frame 3D points (..., 3) to distorted pixels."""
    z = pts_cam[..., 2:3]
    xy = pts_cam[..., :2] / torch.where(torch.abs(z) < eps,
                                        torch.sign(z) * eps + eps, z)
    return normalized_to_pixel(cam, distort(cam, xy))


def pixel_to_ray(cam: CameraModel, uv: torch.Tensor,
                 iters: int = 8) -> torch.Tensor:
    """Distorted pixel (..., 2) -> undistorted normalized coords."""
    return undistort(cam, pixel_to_normalized(cam, uv), iters=iters)
