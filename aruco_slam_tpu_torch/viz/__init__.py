"""Host-side visualization sinks (2D overlay, 3D map/trajectory).

Counterpart of aruco_slam_tpu/viz: pure host-side sinks fed by
device→host pose and map snapshots. The 2D overlay rasterizes in numpy,
the 3D view renders with matplotlib (the "mpl" renderer, headless
export) or the numpy rasterizer (`render3d`, the live follow-camera
window and the "fast" renderer), and both export PNG frames through the
port's own writer and MP4 through `video` (cv2, else imageio's pyav).
Importing this package imports none of cv2, imageio, matplotlib or
PIL: each is imported where it is used.
"""

from aruco_slam_tpu_torch.viz.viewer2d import Viewer2D
from aruco_slam_tpu_torch.viz.viewer3d import Viewer3D
from aruco_slam_tpu_torch.viz.render3d import render_map_frame

__all__ = ["Viewer2D", "Viewer3D", "render_map_frame"]
