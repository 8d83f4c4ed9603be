"""3D map/trajectory sink (matplotlib or the numpy raster, headless).

Counterpart of aruco_slam_tpu/viz/viewer3d.py. The role of the reference's Pangolin/OpenGL viewer (reference
viewers/viewer_3d.py:127-208): camera frustum at the current pose, the
trajectory polyline, filtered landmarks (blue) and raw detections
transformed into the map frame (red). Renders to PNG frames and an
optional MP4 — no GL stack or window system required. matplotlib is
imported only for the "mpl" renderer, as in the JAX module; the "fast"
renderer (`viz/render3d`) needs nothing beyond numpy, and its PNGs go
through the port's own writer (`io.write_png_rgb`). With the same
float64 inputs both renderers give the JAX viewer's images
(tests/test_torch_viz.py).
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

from aruco_slam_tpu_torch.io import write_png_rgb
from aruco_slam_tpu_torch.utils.profiling import StageTimer
from aruco_slam_tpu_torch.viz.render3d import (
    render_map_frame, rotation_matrix)
from aruco_slam_tpu_torch.viz.video import write_video

_FRUSTUM = np.array([
    [0.0, 0.0, 0.0], [-0.1, -0.06, 0.12], [0.1, -0.06, 0.12],
    [0.1, 0.06, 0.12], [-0.1, 0.06, 0.12]])
_FRUSTUM_EDGES = [(0, 1), (0, 2), (0, 3), (0, 4), (1, 2), (2, 3),
                  (3, 4), (4, 1)]


class Viewer3D:
    def __init__(self, export_dir: str | None = None,
                 export_video: str | None = None,
                 stride: int = 1, renderer: str = "mpl",
                 timer: StageTimer | None = None) -> None:
        """renderer: "mpl" = matplotlib 3D figures (axes + ticks),
        "fast" = the numpy raster used by the live follow window
        (viz/render3d, static whole-scene view) — pick "fast" for long
        sequences. ``timer`` (a `utils.profiling.StageTimer`) takes the
        seconds of the rendering (``raster_3d``) and of the PNG encoding
        (``png``)."""
        if renderer not in ("mpl", "fast"):
            raise ValueError(f"unknown 3D renderer {renderer!r}")
        self.renderer = renderer
        if renderer == "mpl":
            import matplotlib
            matplotlib.use("Agg")
            import matplotlib.pyplot as plt
            self._plt = plt
        self.export_dir = Path(export_dir) if export_dir else None
        if self.export_dir:
            self.export_dir.mkdir(parents=True, exist_ok=True)
        self.export_video = export_video
        self._frames = [] if export_video else None
        self._traj: list[np.ndarray] = []
        self._idx = 0
        self.stride = max(int(stride), 1)
        self.timer = timer or StageTimer()

    def view(self, camera_pose: np.ndarray, points_world: np.ndarray,
             detected_world: np.ndarray | None = None) -> None:
        cam_t = np.asarray(camera_pose[:3])
        self._traj.append(cam_t.copy())
        self._idx += 1
        if (self._idx - 1) % self.stride:
            return
        if self.export_dir is None and self._frames is None:
            return  # nothing to emit; still records the trajectory

        with self.timer.stage("raster_3d"):
            img = self._render(camera_pose, points_world, detected_world)
        self._emit(img)

    def _render(self, camera_pose, points_world, detected_world):
        if self.renderer == "fast":
            return render_map_frame(
                np.asarray(camera_pose), np.asarray(self._traj),
                np.asarray(points_world), detected_world,
                follow=False)

        cam_t = np.asarray(camera_pose[:3])
        fig = self._plt.figure(figsize=(6.4, 4.8), dpi=100)
        ax = fig.add_subplot(projection="3d")
        traj = np.asarray(self._traj)
        ax.plot(traj[:, 0], traj[:, 1], traj[:, 2], "g-", linewidth=1)
        pts = np.asarray(points_world)
        if len(pts):
            ax.scatter(pts[:, 0], pts[:, 1], pts[:, 2], c="b", s=12)
        if detected_world is not None and len(detected_world):
            dw = np.asarray(detected_world)
            ax.scatter(dw[:, 0], dw[:, 1], dw[:, 2], c="r", s=8)
        # camera frustum
        r = rotation_matrix(camera_pose[3:7])
        fr = _FRUSTUM @ r.T + cam_t
        for a, b in _FRUSTUM_EDGES:
            ax.plot(*zip(fr[a], fr[b]), "k-", linewidth=0.8)
        ax.set_xlabel("x"); ax.set_ylabel("y"); ax.set_zlabel("z")
        fig.canvas.draw()
        img = np.asarray(fig.canvas.buffer_rgba())[..., :3].copy()
        self._plt.close(fig)
        return img

    def _emit(self, img: np.ndarray) -> None:
        if self.export_dir is not None:
            with self.timer.stage("png"):
                write_png_rgb(self.export_dir / f"map_{self._idx:05d}.png",
                              img)
        if self._frames is not None:
            self._frames.append(img)

    def close(self) -> None:
        if self._frames:
            write_video(self.export_video, self._frames)
            self._frames = []
