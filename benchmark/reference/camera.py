"""Pinhole camera with 5-term radial-tangential distortion, on tensors.

The benchmark's frozen copy of the port's counterpart of
aruco_slam_tpu/core/camera.py (OpenCV's model, with distortion
coefficients ordered k1, k2, p1, p2, k3), with the image remap
`undistort_image` (cv2.undistort's) and its `bilinear_sample`.
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


def undistort_image(cam: CameraModel, img: torch.Tensor) -> torch.Tensor:
    """Undistort a grayscale image (H, W) under ``cam`` (cv2.undistort's
    remap): every output pixel of the ideal pinhole grid takes the
    bilinear sample at its distorted source position, the forward
    `distort` of its normalized coordinates. Integer images are rounded
    (half to even, as the JAX function), not truncated; a pixel whose
    source lies outside the frame is 0. Runs on the image's device; the
    sample coordinates are float32, or float64 with a float64 camera
    (as JAX promotes them)."""
    h, w = img.shape
    dev = img.device
    cam = cam.to(device=dev)
    dt = torch.promote_types(torch.float32, cam.fx.dtype)
    vv, uu = torch.meshgrid(torch.arange(h, dtype=dt, device=dev),
                            torch.arange(w, dtype=dt, device=dev),
                            indexing="ij")
    src = normalized_to_pixel(cam, distort(cam, pixel_to_normalized(
        cam, torch.stack([uu, vv], -1))))
    x, y = src[..., 0], src[..., 1]
    inside = (x >= 0) & (x <= w - 1) & (y >= 0) & (y <= h - 1)
    out = bilinear_sample(img.to(torch.float32), x, y)
    if not torch.is_floating_point(img):
        out = torch.round(out)  # truncation would bias ~0.5 level dark
    return torch.where(inside, out, 0.0).to(img.dtype)


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
                    ) -> torch.Tensor:
    """Bilinear sample of a single-channel image (H, W) at float
    coordinates (clamped to the valid interior)."""
    h, w = img.shape
    x0 = torch.clamp(torch.floor(x).to(torch.int32), 0, w - 2)
    y0 = torch.clamp(torch.floor(y).to(torch.int32), 0, h - 2)
    fx = torch.clamp(x - x0, 0.0, 1.0)
    fy = torch.clamp(y - y0, 0.0, 1.0)
    x0, y0 = x0.long(), y0.long()
    v00 = img[y0, x0]
    v01 = img[y0, x0 + 1]
    v10 = img[y0 + 1, x0]
    v11 = img[y0 + 1, x0 + 1]
    return ((1 - fy) * ((1 - fx) * v00 + fx * v01)
            + fy * ((1 - fx) * v10 + fx * v11))
