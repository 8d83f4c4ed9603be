"""2D overlay sink: detected-marker axes + reprojected map points.

Counterpart of aruco_slam_tpu/viz/viewer2d.py (the reference's Viewer2D
semantics, reference viewers/viewer_2d.py:64-190): xyz axes, the square
outline, the top-left corner dot and the id label at each *detected*
marker pose, a dot at each *filtered* map point reprojected into the
frame, then a nearest-neighbour downsample for export. Headless: frames
accumulate to PNG files (the port's own writer, `io.write_png_rgb`)
and/or an MP4 (`viz.video`).

Projection runs through `core/camera.project` on a float64 CPU copy of
the camera, made once when the viewer is built: never on the run's
device, where every marker of every frame would cost a launch and a
synchronisation. With the same float64 inputs the pixels equal the JAX
viewer's (tests/test_torch_viz.py). Each marker's axis and outline
points are projected in one call, and the frame's map points in
another; projection is elementwise, so batching changes no value.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.io import write_png_rgb
from aruco_slam_tpu_torch.utils.profiling import StageTimer
from aruco_slam_tpu_torch.viz import draw
from aruco_slam_tpu_torch.viz.render3d import rotation_matrix
from aruco_slam_tpu_torch.viz.video import write_video

AXIS_SIZE = 0.25  # meters (reference viewers/viewer_2d.py:9)
_AXIS_PTS = np.array(
    [[1.0, 0, 0], [0, 1.0, 0], [0, 0, 1.0], [0, 0, 0]]) * AXIS_SIZE
_COLORS = [(255, 64, 64), (64, 255, 64), (64, 64, 255)]
# drawDetectedMarkers palette (reference filters/base_filter.py:198
# via cv2.aruco): green border, red top-left corner, blue id text
OUTLINE_COLOR = (0, 255, 0)
CORNER_COLOR = (255, 0, 0)
ID_COLOR = (64, 64, 255)
MAP_COLOR = (160, 32, 32)
# marker-frame square corners, IPPE_SQUARE order (ops/pnp.py
# square_object_points): the outline reprojects these through the
# fitted pose
_SQUARE = np.array([[-0.5, 0.5, 0], [0.5, 0.5, 0],
                    [0.5, -0.5, 0], [-0.5, -0.5, 0]])


class Viewer2D:
    """Accumulating 2D overlay renderer. ``timer`` (a
    `utils.profiling.StageTimer`) takes the seconds of the drawing and
    resize (``draw_2d``) and of the PNG encoding (``png``)."""

    def __init__(self, cam: cam_mod.CameraModel,
                 export_dir: str | None = None,
                 export_video: str | None = None,
                 display_size=(960, 540),
                 marker_size: float = 0.16,
                 timer: StageTimer | None = None) -> None:
        self.cam = cam.to(dtype=torch.float64, device="cpu")
        self.display_size = display_size
        self.marker_size = marker_size
        self.export_dir = Path(export_dir) if export_dir else None
        if self.export_dir:
            self.export_dir.mkdir(parents=True, exist_ok=True)
        self.export_video = export_video
        self._frames = [] if export_video else None
        self._idx = 0
        self.timer = timer or StageTimer()

    def _project(self, pts) -> np.ndarray:
        return cam_mod.project(
            self.cam, torch.as_tensor(np.asarray(pts, np.float64))).numpy()

    def view(self, frame: np.ndarray, camera_pose: np.ndarray,
             points_world: np.ndarray, detected: list | np.ndarray
             ) -> np.ndarray:
        """Render one frame.

        frame: (H, W) uint8 grayscale or (H, W, 3) RGB.
        camera_pose: (7+,) [xyz, quat wxyz].
        points_world: (M, 3) filtered landmark positions.
        detected: iterable of (t_cl (3,), q_cl (4,)) marker poses in
        the camera frame (PnP output), optionally (t_cl, q_cl, id): with
        an id the marker's square outline and id label render too (the
        reference's cv2.aruco.drawDetectedMarkers overlay, reference
        filters/base_filter.py:198).
        """
        with self.timer.stage("draw_2d"):
            out = self._draw(frame, camera_pose, points_world, detected)
        self._emit(out)
        return out

    def _draw(self, frame, camera_pose, points_world, detected):
        img = np.ascontiguousarray(
            np.stack([frame] * 3, -1) if frame.ndim == 2 else frame
        ).copy()
        # detected marker axes + outline + id label
        for d in detected:
            t_cl, q_cl = np.asarray(d[0]), np.asarray(d[1])
            mid = d[2] if len(d) > 2 else None
            r = rotation_matrix(q_cl)
            pts = _AXIS_PTS @ r.T + t_cl
            sq = _SQUARE * self.marker_size @ r.T + t_cl
            both = self._project(np.concatenate([pts, sq]))
            px, qx = both[:4], both[4:]
            if not np.isfinite(px).all():
                continue
            origin = px[3]
            for k in range(3):
                draw.draw_line(img, origin, px[k], _COLORS[k], 6)
            if mid is None or not np.isfinite(qx).all():
                continue
            draw.draw_polygon(img, qx, OUTLINE_COLOR, 3)
            draw.draw_circle(img, qx[0], 6, CORNER_COLOR)
            draw.draw_text(img, qx[0] + np.array([8.0, 8.0]),
                           str(int(mid)), ID_COLOR, scale=3)
        # filtered map points reprojected
        cam_t = np.asarray(camera_pose[:3])
        r_wc = rotation_matrix(camera_pose[3:7])
        front = []
        for p in np.asarray(points_world):
            p_c = r_wc.T @ (p - cam_t)
            if p_c[2] > 0.05:
                front.append(p_c)
        if front:
            for px in self._project(np.stack(front)):
                draw.draw_circle(img, px, 10, MAP_COLOR)
        return _resize(img, self.display_size)

    def _emit(self, img: np.ndarray) -> None:
        if self.export_dir is not None:
            with self.timer.stage("png"):
                write_png_rgb(self.export_dir / f"frame_{self._idx:05d}.png",
                              img)
        if self._frames is not None:
            self._frames.append(img)
        self._idx += 1

    def close(self) -> None:
        if self._frames:
            write_video(self.export_video, self._frames)
            self._frames = []


def _resize(img: np.ndarray, size) -> np.ndarray:
    w, h = size
    ys = (np.arange(h) * img.shape[0] / h).astype(np.int64)
    xs = (np.arange(w) * img.shape[1] / w).astype(np.int64)
    return img[ys][:, xs]
