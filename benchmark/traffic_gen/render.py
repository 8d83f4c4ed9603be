"""Synthetic grayscale frame renderer (numpy + the benchmark's camera).

The benchmark's frozen copy of aruco_slam_tpu_torch/bench/render.py's
`render_sequence`: each scene marker (payload and black border) is
rasterized into the frame by inverse homography warping through the
distorted camera. The same scene gives the same frames, bit for bit.
"""

from __future__ import annotations

import numpy as np
import torch

from benchmark.reference import camera as cam_mod
from benchmark.reference import dictionary as dict_mod
from benchmark.traffic_gen.synthetic import (
    Scene, Trajectory, _quat_conj, _quat_mul, _quat_rotate,
    canonical_corners, project_np)

BACKGROUND = 178  # light gray


def _undistort_map(cam: cam_mod.CameraModel, w: int, h: int) -> np.ndarray:
    """Per-pixel undistorted normalized coords (H, W, 2), float64."""
    uv = np.stack(np.meshgrid(np.arange(w, dtype=np.float64),
                              np.arange(h, dtype=np.float64)), -1)
    cam64 = cam.to(dtype=torch.float64, device="cpu")
    return cam_mod.pixel_to_ray(
        cam64, torch.as_tensor(uv.reshape(-1, 2)), iters=10
    ).numpy().reshape(h, w, 2)


def render_frame(scene: Scene, cam_q, cam_t, cam, norm_map,
                 d: dict_mod.Dictionary, marker_ids=None,
                 background: np.ndarray | None = None) -> np.ndarray:
    h, w = norm_map.shape[:2]
    img = np.full((h, w), BACKGROUND, np.uint8) \
        if background is None else background.copy()
    m = len(scene.marker_pos)
    ids = np.arange(m) if marker_ids is None else marker_ids
    cq_inv = _quat_conj(np.asarray(cam_q))
    rel_t = _quat_rotate(cq_inv[None], scene.marker_pos - np.asarray(cam_t))
    rel_q = _quat_mul(cq_inv[None], scene.marker_quat)
    s = scene.marker_size
    cells = d.marker_bits + 2
    obj = canonical_corners(s)

    for j in range(m):
        if rel_t[j, 2] < 0.15:
            continue
        rq = rel_q[j]
        ex = _quat_rotate(rq[None], np.array([[1.0, 0, 0]]))[0]
        ey = _quat_rotate(rq[None], np.array([[0, 1.0, 0]]))[0]
        org = rel_t[j]
        if np.dot(np.cross(ex, ey), org) >= 0:  # facing away
            continue
        px = project_np(cam, _quat_rotate(rq[None], obj) + org)
        x0 = int(max(np.floor(px[:, 0].min()) - 2, 0))
        x1 = int(min(np.ceil(px[:, 0].max()) + 3, w))
        y0 = int(max(np.floor(px[:, 1].min()) - 2, 0))
        y1 = int(min(np.ceil(px[:, 1].max()) + 3, h))
        if x1 <= x0 or y1 <= y0:
            continue
        # ray r = (x, y, 1) meets the plane {org + a ex + b ey}:
        # solve [ex ey -r] [a b t]^T = -org
        nm = norm_map[y0:y1, x0:x1]
        bh, bw = nm.shape[:2]
        rays = np.concatenate([nm, np.ones((bh, bw, 1))], -1)
        a_mat = np.empty((bh, bw, 3, 3))
        a_mat[..., :, 0] = ex
        a_mat[..., :, 1] = ey
        a_mat[..., :, 2] = -rays
        rhs = np.broadcast_to(-org, (bh, bw, 3))
        try:
            sol = np.linalg.solve(a_mat, rhs[..., None])[..., 0]
        except np.linalg.LinAlgError:
            continue
        a, b, depth = sol[..., 0], sol[..., 1], sol[..., 2]
        inside = (np.abs(a) <= s / 2) & (np.abs(b) <= s / 2) & (depth > 0)
        # marker-frame y is UP; bit rows go down from the top-left
        cx = ((a + s / 2) / s * cells).astype(np.int64).clip(0, cells - 1)
        cy = ((s / 2 - b) / s * cells).astype(np.int64).clip(0, cells - 1)
        pattern = np.zeros((cells, cells), np.uint8)
        pattern[1:-1, 1:-1] = d.bits[ids[j] % d.num_markers]
        val = pattern[cy, cx] * 255
        region = img[y0:y1, x0:x1]
        region[inside] = val[inside]
    return img


def render_sequence(scene: Scene, traj: Trajectory, cam,
                    dict_name: str = dict_mod.DICT_5X5_50,
                    image_size=(1920, 1080),
                    background: np.ndarray | None = None,
                    marker_ids=None) -> np.ndarray:
    """(T, H, W) uint8 frames; marker j renders id marker_ids[j]
    (default j)."""
    w, h = image_size
    d = dict_mod.load(dict_name)
    norm_map = _undistort_map(cam, w, h)
    frames = np.empty((len(traj.times), h, w), np.uint8)
    for i in range(len(traj.times)):
        frames[i] = render_frame(scene, traj.cam_q[i], traj.cam_t[i],
                                 cam, norm_map, d, marker_ids=marker_ids,
                                 background=background)
    return frames
