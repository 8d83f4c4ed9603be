"""Synthetic ArUco-marker scenes with exact ground truth (numpy).

The benchmark's frozen copy of aruco_slam_tpu_torch/bench/synthetic.py
(the scenes, orbits and corner observations its traffic uses): the same
seeds give the same arrays, bit for bit; projection goes through the
benchmark's camera copy, in float64 on the CPU.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import camera as cam_mod

DEFAULT_MARKER_SIZE = 0.16  # meters


def canonical_corners(marker_size: float) -> np.ndarray:
    """The 4 corners of a marker in its own plane (z=0): TL TR BR BL."""
    s = marker_size / 2.0
    return np.array(
        [[-s, s, 0.0], [s, s, 0.0], [s, -s, 0.0], [-s, -s, 0.0]])


class Scene(NamedTuple):
    marker_pos: np.ndarray   # (M, 3)
    marker_quat: np.ndarray  # (M, 4) wxyz, marker-to-world
    marker_size: float


class Trajectory(NamedTuple):
    cam_t: np.ndarray  # (T, 3)
    cam_q: np.ndarray  # (T, 4) wxyz camera-to-world
    times: np.ndarray  # (T,) seconds


def _quat_rotate(q, v):
    w = q[..., :1]
    u = q[..., 1:]
    uv = np.cross(u, v)
    return v + 2.0 * (w * uv + np.cross(u, uv))


def _quat_conj(q):
    return q * np.array([1.0, -1.0, -1.0, -1.0])


def _quat_mul(a, b):
    aw, ax, ay, az = np.moveaxis(a, -1, 0)
    bw, bx, by, bz = np.moveaxis(b, -1, 0)
    return np.stack(
        [
            aw * bw - ax * bx - ay * by - az * bz,
            aw * bx + ax * bw + ay * bz - az * by,
            aw * by - ax * bz + ay * bw + az * bx,
            aw * bz + ax * by - ay * bx + az * bw,
        ],
        axis=-1,
    )


def _quat_from_rotvec(rv):
    angle = np.linalg.norm(rv, axis=-1, keepdims=True)
    half = 0.5 * angle
    k = np.where(angle < 1e-9, 0.5, np.sin(half) / np.maximum(angle, 1e-12))
    return np.concatenate([np.cos(half), rv * k], axis=-1)


def project_np(cam: cam_mod.CameraModel, pts: np.ndarray) -> np.ndarray:
    """Project camera-frame points (..., 3), in float64 on the CPU."""
    cam64 = cam.to(dtype=torch.float64, device="cpu")
    return cam_mod.project(cam64, torch.as_tensor(
        pts, dtype=torch.float64)).numpy()


def make_wall_scene(num_markers: int = 12, seed: int = 0,
                    marker_size: float = DEFAULT_MARKER_SIZE,
                    extent: float = 2.5, depth: float = 3.0) -> Scene:
    """Markers scattered on a rough wall at z≈depth, facing -z."""
    rng = np.random.default_rng(seed)
    pos = np.stack(
        [
            rng.uniform(-extent, extent, num_markers),
            rng.uniform(-extent * 0.6, extent * 0.6, num_markers),
            depth + rng.uniform(-0.3, 0.3, num_markers),
        ],
        axis=-1,
    )
    base = _quat_from_rotvec(np.array([[np.pi, 0.0, 0.0]]))  # flip z
    tilt = _quat_from_rotvec(rng.normal(scale=0.12, size=(num_markers, 3)))
    return Scene(pos, _quat_mul(tilt, np.broadcast_to(base, (num_markers, 4))),
                 marker_size)


def make_orbit_trajectory(num_frames: int = 300, fps: float = 30.0,
                          radius: float = 0.8, sway: float = 0.4,
                          seed: int = 1) -> Trajectory:
    """Smooth lateral arc with gentle yaw, looking toward +z."""
    t = np.arange(num_frames) / fps
    phase = 2.0 * np.pi * t / t[-1] if num_frames > 1 else np.zeros(1)
    x = radius * np.sin(phase)
    y = 0.15 * np.sin(2.1 * phase)
    z = sway * 0.5 * (1 - np.cos(phase))
    pos = np.stack([x, y, z], axis=-1)
    yaw = 0.25 * np.sin(phase)
    pitch = 0.06 * np.sin(1.7 * phase)
    q = _quat_mul(
        _quat_from_rotvec(np.stack(
            [np.zeros_like(yaw), yaw, np.zeros_like(yaw)], axis=-1)),
        _quat_from_rotvec(np.stack(
            [pitch, np.zeros_like(pitch), np.zeros_like(pitch)], axis=-1)),
    )
    return Trajectory(pos, q, t)


def observe_corners(scene: Scene, traj: Trajectory,
                    cam: cam_mod.CameraModel, capacity: int,
                    noise_px: float = 0.0, seed: int = 3,
                    image_size: tuple[int, int] = (1920, 1080)):
    """Distorted pixel corners per marker: (corners (T, C, 4, 2),
    mask (T, C))."""
    rng = np.random.default_rng(seed)
    tn, c = len(traj.times), capacity
    m = len(scene.marker_pos)
    obj = canonical_corners(scene.marker_size)
    corners = np.zeros((tn, c, 4, 2))
    mask = np.zeros((tn, c), dtype=bool)
    w, h = image_size
    for i in range(tn):
        cq, ct = traj.cam_q[i], traj.cam_t[i]
        cq_inv = _quat_conj(cq)
        rel_t = _quat_rotate(cq_inv[None], scene.marker_pos - ct)
        rel_q = _quat_mul(cq_inv[None], scene.marker_quat)
        pts = _quat_rotate(rel_q[:, None, :], obj[None]) + rel_t[:, None, :]
        px = project_np(cam, pts)
        px += rng.normal(scale=noise_px, size=px.shape)
        in_img = (
            (pts[..., 2] > 0.2).all(-1)
            & (px[..., 0] > 0).all(-1) & (px[..., 0] < w).all(-1)
            & (px[..., 1] > 0).all(-1) & (px[..., 1] < h).all(-1)
        )
        mz = _quat_rotate(rel_q, np.broadcast_to([0.0, 0.0, 1.0], (m, 3)))
        in_img &= np.einsum("md,md->m", mz, rel_t) < 0
        corners[i, :m][in_img] = px[in_img]
        mask[i, :m] = in_img
    return corners, mask
