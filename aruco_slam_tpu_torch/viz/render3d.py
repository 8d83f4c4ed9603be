"""Fast raster 3D map renderer (pure numpy, no GL / matplotlib).

Counterpart of aruco_slam_tpu/viz/render3d.py, line for line; the one
change is that rotations come from the port's `core/quaternion.
to_matrix` on a CPU float64 tensor (`rotation_matrix`), where the JAX
module calls its jax.numpy version. tests/test_torch_viz.py holds every
function bit-identical to the JAX module's for float64 inputs.

The interactive role of the reference's Pangolin viewer — a live 3D
window whose view camera FOLLOWS the estimated camera (reference
viewers/viewer_3d.py:52-108 sets up an OpenGL render state with a
follow target) — re-built as a host-side pinhole rasterizer over the
same numpy primitives the 2D overlay uses (viz/draw.py). Per-frame
cost is ~1-2 ms vs ~50 ms for a matplotlib 3D figure, which is what
makes a live window (and fast mp4 export) viable.

Scene content matches viz/viewer3d.py (the headless matplotlib sink):
green trajectory polyline, blue filtered landmarks, red raw
detections, black camera frustum. Conventions are OpenCV's: camera
looks along +z of its own frame, y down.
"""

from __future__ import annotations

import numpy as np
import torch

from aruco_slam_tpu_torch.core import quaternion as quat
from aruco_slam_tpu_torch.viz import draw

_FRUSTUM = np.array([
    [0.0, 0.0, 0.0], [-0.1, -0.06, 0.12], [0.1, -0.06, 0.12],
    [0.1, 0.06, 0.12], [-0.1, 0.06, 0.12]])
_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3),
                  (3, 4), (4, 1)]

_BG = np.array([245, 245, 245], np.uint8)
_TRAJ = (40, 160, 40)
_LM = (40, 70, 220)
_DET = (220, 50, 50)
_FRUST = (30, 30, 30)

_NEAR = 0.05


def rotation_matrix(q) -> np.ndarray:
    """Unit quaternion(s) [w, x, y, z] (..., 4) -> float64 rotation
    matrices (..., 3, 3), computed on the host at float64."""
    return quat.to_matrix(torch.as_tensor(
        np.asarray(q, np.float64))).numpy()


def look_at(eye: np.ndarray, target: np.ndarray, up: np.ndarray
            ) -> tuple[np.ndarray, np.ndarray]:
    """World->view rotation + eye for a viewer at `eye` looking at
    `target` (OpenCV convention: +z forward, +y down in view)."""
    fwd = target - eye
    fwd = fwd / max(np.linalg.norm(fwd), 1e-9)
    # right-handed OpenCV view frame (x right, y down, z forward):
    # with world up = -y, right = fwd x up points to +x when looking
    # along +z, and down = fwd x right closes the frame
    right = np.cross(fwd, up)
    right = right / max(np.linalg.norm(right), 1e-9)
    down = np.cross(fwd, right)
    r = np.stack([right, down, fwd])  # rows = view axes in world
    return r, eye


def follow_view(cam_pose: np.ndarray,
                offset=(0.0, -0.8, -2.5)) -> tuple[np.ndarray,
                                                   np.ndarray]:
    """Chase-camera view: behind and above the estimated camera,
    looking where it looks — the reference viewer's follow navigation
    (reference viewers/viewer_3d.py:52-108)."""
    cam_t = np.asarray(cam_pose[:3], np.float64)
    r = rotation_matrix(cam_pose[3:7])
    eye = cam_t + r @ np.asarray(offset)
    target = cam_t + r @ np.array([0.0, 0.0, 1.0])
    # fixed world up (-y, OpenCV world): no roll wobble with the camera
    return look_at(eye, target, np.array([0.0, -1.0, 0.0]))


def scene_view(points: np.ndarray, traj: np.ndarray
               ) -> tuple[np.ndarray, np.ndarray]:
    """Static overview: the whole scene bbox from an elevated orbit
    position (for offline replay / exports without follow)."""
    allp = [p for p in (points, traj) if p is not None and len(p)]
    if not allp:
        return follow_view(np.array([0, 0, 0, 1.0, 0, 0, 0]))
    pts = np.concatenate(allp, axis=0)
    center = pts.mean(axis=0)
    radius = max(float(np.linalg.norm(pts - center, axis=1).max()), 1.0)
    eye = center + radius * np.array([1.6, -1.2, -1.6])
    return look_at(eye, center, np.array([0.0, -1.0, 0.0]))


class OrbitView:
    """Mouse-driven free view: orbit / pan / zoom around a target —
    the role of Pangolin's Handler3D interactive render state
    (reference viewers/viewer_3d.py:52-108) for the live map window.

    Screen-space gestures map to view updates the way GL orbit
    controllers do: left-drag orbits (azimuth/elevation on a sphere
    around the target), right-drag pans (target slides in the view
    plane, scaled by radius so motion tracks the cursor), wheel zooms
    (radius scales geometrically)."""

    def __init__(self, target=(0.0, 0.0, 2.0), radius=5.0,
                 azimuth=0.5, elevation=-0.45) -> None:
        self.target = np.asarray(target, np.float64).copy()
        self.radius = float(radius)
        self.az = float(azimuth)
        self.el = float(elevation)

    @classmethod
    def from_pose(cls, cam_pose, radius=4.0) -> "OrbitView":
        """Seed the free view from the followed camera so toggling
        follow->free doesn't jump."""
        return cls(target=np.asarray(cam_pose[:3], np.float64),
                   radius=radius)

    def rv_eye(self) -> tuple[np.ndarray, np.ndarray]:
        ca, sa = np.cos(self.az), np.sin(self.az)
        ce, se = np.cos(self.el), np.sin(self.el)
        # world up is -y (OpenCV): elevation<0 looks down from above
        direction = np.array([ca * ce, se, sa * ce])
        eye = self.target - self.radius * direction
        return look_at(eye, self.target, np.array([0.0, -1.0, 0.0]))

    def orbit(self, dx_px: float, dy_px: float) -> None:
        self.az += 0.008 * dx_px
        self.el = float(np.clip(self.el - 0.008 * dy_px,
                                -1.45, 1.45))

    def pan(self, dx_px: float, dy_px: float) -> None:
        rv, _ = self.rv_eye()
        scale = 0.0025 * self.radius
        # drag right moves the WORLD right under the cursor: target
        # shifts along -view_right; same for vertical
        self.target -= scale * (dx_px * rv[0] + dy_px * rv[1])

    def zoom(self, steps: float) -> None:
        self.radius = float(np.clip(
            self.radius * (0.9 ** steps), 0.2, 500.0))


def _project(pts: np.ndarray, rv: np.ndarray, eye: np.ndarray,
             f: float, cx: float, cy: float
             ) -> tuple[np.ndarray, np.ndarray]:
    """(N, 3) world -> ((N, 2) pixels, (N,) in-front-of-camera)."""
    if len(pts) == 0:
        return np.zeros((0, 2)), np.zeros(0, bool)
    v = (np.asarray(pts, np.float64) - eye) @ rv.T
    z = v[:, 2]
    ok = z > _NEAR
    zs = np.where(ok, z, 1.0)
    px = f * v[:, 0] / zs + cx
    py = f * v[:, 1] / zs + cy
    return np.stack([px, py], -1), ok


def render_map_frame(cam_pose: np.ndarray, traj: np.ndarray,
                     points: np.ndarray,
                     detections: np.ndarray | None = None,
                     size: tuple[int, int] = (480, 640),
                     follow: bool = True,
                     fov_deg: float = 60.0,
                     view: tuple[np.ndarray, np.ndarray] | None = None
                     ) -> np.ndarray:
    """Render one 3D map frame to (H, W, 3) uint8.

    cam_pose: (7,) [xyz, quat wxyz]; traj: (T, 3) camera positions so
    far; points: (L, 3) world landmarks; detections: (D, 3) world-frame
    raw detections (or None). `follow=True` chases the camera
    (interactive parity with the reference's follow mode); False gives
    a static whole-scene view. An explicit `view` (rv, eye) — e.g.
    `OrbitView.rv_eye()` for the live window's free navigation —
    overrides both.
    """
    h, w = size
    img = np.empty((h, w, 3), np.uint8)
    img[:] = _BG
    traj = np.asarray(traj, np.float64).reshape(-1, 3)
    rv, eye = view if view is not None else (
        follow_view(cam_pose) if follow else scene_view(points, traj))
    f = 0.5 * w / np.tan(np.radians(fov_deg) / 2.0)
    cx, cy = w / 2.0, h / 2.0

    # trajectory polyline (subsampled: >256 segments adds nothing at
    # window resolution but costs a host loop per segment)
    if len(traj) > 1:
        if len(traj) > 257:
            idx = np.linspace(0, len(traj) - 1, 257).astype(int)
            tr = traj[idx]
        else:
            tr = traj
        p2, ok = _project(tr, rv, eye, f, cx, cy)
        for a in range(len(tr) - 1):
            if ok[a] and ok[a + 1]:
                draw.draw_line(img, p2[a], p2[a + 1], _TRAJ, 2)

    pts = np.asarray(points, np.float64).reshape(-1, 3)
    p2, ok = _project(pts, rv, eye, f, cx, cy)
    for i in np.where(ok)[0]:
        draw.draw_circle(img, p2[i], 3, _LM)
    if detections is not None and len(detections):
        d2, ok = _project(np.asarray(detections, np.float64), rv, eye,
                          f, cx, cy)
        for i in np.where(ok)[0]:
            draw.draw_circle(img, d2[i], 2, _DET)

    # camera frustum at the current pose
    rc = rotation_matrix(cam_pose[3:7])
    fr = _FRUSTUM @ rc.T + np.asarray(cam_pose[:3], np.float64)
    f2, ok = _project(fr, rv, eye, f, cx, cy)
    for a, b in _FRUSTUM_EDGES:
        if ok[a] and ok[b]:
            draw.draw_line(img, f2[a], f2[b], _FRUST, 1)
    return img
