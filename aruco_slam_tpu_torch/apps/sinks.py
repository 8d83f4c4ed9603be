"""Driver-side visualization sinks: real frames through the viewers.

Counterpart of aruco_slam_tpu/apps/sinks.py. The reference draws
detections on the actual video frame (reference
viewers/viewer_2d.py:64-111) and replays smoothed poses through both
viewers in the offline driver (reference main/run_offline.py:124-142).
This module gives both drivers one wiring: a *frame provider* that
re-reads the original imagery (the npz `images` array, or a second
sequential decode of the video file — frames are not kept resident),
and viewer adapters with a uniform
``view_frame(cam_pose, points, detections)`` surface. Everything here
runs on the host on numpy snapshots the drivers read back from the
device; the 2D viewer projects on a float64 CPU copy of the camera.

`check_libraries` refuses, before a driver reads any input, a viewer
whose library is not installed: matplotlib for ``--viz-3d`` with the
default "mpl" renderer, and cv2 or imageio's pyav for
``--export-video``. (The JAX sinks raise the same ImportError later:
when the viewers are built, or when they are closed after the run.)
Importing this module imports none of cv2, imageio, matplotlib or PIL.
"""

from __future__ import annotations

import os
import sys

import numpy as np

from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.io import VideoSource, is_video
from aruco_slam_tpu_torch.utils.profiling import StageTimer
from aruco_slam_tpu_torch.viz import Viewer2D, Viewer3D
from aruco_slam_tpu_torch.viz.render3d import (
    OrbitView, render_map_frame, rotation_matrix)
from aruco_slam_tpu_torch.viz.video import encoder_available, installed


def check_libraries(cfg: SlamAppConfig, display: bool = False) -> None:
    """Raise ImportError when a requested viewer needs a library that is
    not installed (call before any input is read)."""
    if not (cfg.viz_2d or cfg.viz_3d or display):
        return  # no viewer is built: the modifiers act on nothing
    if cfg.viz_3d and cfg.viz_3d_renderer == "mpl" \
            and not installed("matplotlib"):
        raise ImportError(
            "--viz-3d renders with matplotlib by default, and matplotlib "
            "is not installed: add --viz-3d-renderer fast (the numpy "
            "raster, which needs no library)")
    if cfg.export_video and not encoder_available():
        raise ImportError(
            "--export-video needs cv2, or imageio with pyav, and neither "
            "is installed: drop --export-video (the PNG frames need no "
            "library)")


def make_frame_provider(cfg: SlamAppConfig, src=None):
    """Callable i -> grayscale frame (H, W) uint8, or None when the
    input carries no imagery (pose-/corner-level npz)."""
    if src is not None and src.has("images"):
        imgs = src["images"]
        return lambda i: imgs[i]
    if is_video(cfg.input):
        state = {"it": None, "next": 0}

        def provider(i):
            # sequential re-decode; viz replay is in-order by design
            if state["it"] is None or i < state["next"]:
                state["it"] = VideoSource(cfg.input).frames()
                state["next"] = 0
            frame = None
            while state["next"] <= i:
                _, frame = next(state["it"])
                state["next"] += 1
            return frame

        return provider
    return None


class Viewer2DSink:
    """Feeds the 2D overlay the REAL frame for step i (falls back to a
    blank canvas only when the input has no imagery at all)."""

    def __init__(self, cam, cfg: SlamAppConfig, frame_provider=None,
                 frame_shape=(1080, 1920),
                 timer: StageTimer | None = None) -> None:
        video = f"{cfg.viz_dir}/2d.mp4" if cfg.export_video else None
        self.v = Viewer2D(cam, export_dir=f"{cfg.viz_dir}/2d",
                          export_video=video,
                          marker_size=cfg.marker_size, timer=timer)
        self.provider = frame_provider
        self.blank = np.zeros(frame_shape, np.uint8)
        self.idx = 0

    def view_frame(self, cam_pose, pts, det) -> np.ndarray:
        frame = self.provider(self.idx) if self.provider else self.blank
        img = self.v.view(frame, cam_pose, pts, det)
        self.idx += 1
        return img

    def skip_to(self, i: int) -> None:
        """Align the frame provider with a resumed run's first frame
        (--resume starts the filter loop mid-sequence)."""
        self.idx = i

    def close(self) -> None:
        self.v.close()


def _world_detections(cam_pose, det):
    """Camera-frame detections -> (D, 3) world points (reference
    viewers/viewer_3d.py:167-192)."""
    r = rotation_matrix(cam_pose[3:7])
    return np.asarray([r @ np.asarray(d[0]) + cam_pose[:3] for d in det])


class Viewer3DSink:
    """3D map sink; transforms camera-frame detections to the world
    frame like the reference (reference viewers/viewer_3d.py:167-192)."""

    def __init__(self, cfg: SlamAppConfig, stride: int = 1,
                 timer: StageTimer | None = None) -> None:
        video = f"{cfg.viz_dir}/3d.mp4" if cfg.export_video else None
        self.v = Viewer3D(export_dir=f"{cfg.viz_dir}/3d",
                          export_video=video, stride=stride,
                          renderer=cfg.viz_3d_renderer, timer=timer)

    def view_frame(self, cam_pose, pts, det) -> None:
        dw = _world_detections(cam_pose, det) if det else np.zeros((0, 3))
        self.v.view(cam_pose, pts, dw)

    def close(self) -> None:
        self.v.close()


def display_available() -> bool:
    """cv2's Qt backend ABORTS the process (not an exception) when no
    display server exists, so probe the environment first."""
    return bool(os.environ.get("DISPLAY")
                or os.environ.get("WAYLAND_DISPLAY")
                or sys.platform in ("darwin", "win32"))


class LiveDisplaySink:
    """Opt-in interactive window (the reference's cv2.imshow loop with
    'q' to quit, reference viewers/viewer_2d.py:103-106). Wraps a
    Viewer2DSink and shows each overlay; without a display server it
    prints a note and exports headless, and on a build without a GUI
    backend it disables itself after the first frame with a warning
    instead of killing the run."""

    def __init__(self, inner: Viewer2DSink) -> None:
        self.inner = inner
        self.enabled = display_available()
        if not self.enabled:
            print("no display server (DISPLAY unset): --display "
                  "falls back to headless PNG/mp4 export")
        self.quit = False

    def view_frame(self, cam_pose, pts, det) -> None:
        img = self.inner.view_frame(cam_pose, pts, det)
        if not self.enabled or self.quit:
            return
        try:
            import cv2
            cv2.imshow("aruco_slam_tpu", img[..., ::-1])
            if (cv2.waitKey(1) & 0xFF) == ord("q"):
                self.quit = True
                cv2.destroyAllWindows()
        except Exception as e:  # headless build / no display
            print(f"live display unavailable ({e}); continuing "
                  "headless")
            self.enabled = False

    def skip_to(self, i: int) -> None:
        self.inner.skip_to(i)

    def close(self) -> None:
        self.inner.close()
        if self.enabled and not self.quit:
            try:
                import cv2
                cv2.destroyAllWindows()
            except Exception:
                pass


class Live3DDisplaySink:
    """Interactive 3D MAP window: the reference's Pangolin viewer
    (reference viewers/viewer_3d.py:52-108) as the numpy raster
    (`viz/render3d`) shown through cv2 — no GL stack.

    Navigation matches Pangolin's Handler3D affordances: the default
    chase view FOLLOWS the estimated camera; left-drag orbits,
    right-drag pans, the wheel zooms (any of which switches to FREE
    navigation, seeded from the current follow pose so the view
    doesn't jump); 'f' toggles back to follow. 'q' in either window
    ends the run (`stop_requested`)."""

    WINDOW = "aruco_slam_tpu 3d"

    def __init__(self) -> None:
        self.enabled = display_available()
        if not self.enabled:
            print("no display server: live 3D map disabled "
                  "(use --viz-3d for headless PNG/mp4 export)")
        self.quit = False
        self.follow = True
        self.free_view = None          # render3d.OrbitView once free
        self._mouse_cb_set = False
        self._last_xy = None
        self._last_pose = np.array([0, 0, 0, 1.0, 0, 0, 0])
        # amortized-doubling (N, 3) trajectory buffer: a python list +
        # per-frame np.asarray would re-materialize the whole history
        # every frame (O(T) per frame, O(T²) per run)
        self._traj = np.empty((256, 3), np.float64)
        self._n = 0

    # -- free navigation --------------------------------------------
    def _ensure_free(self):
        if self.follow or self.free_view is None:
            self.follow = False
            self.free_view = OrbitView.from_pose(self._last_pose)
        return self.free_view

    def on_mouse(self, event, x, y, flags, _param=None) -> None:
        """cv2 mouse callback (public so tests can drive it with a
        stubbed cv2)."""
        import cv2
        if event == cv2.EVENT_MOUSEWHEEL:
            self._ensure_free().zoom(1.0 if flags > 0 else -1.0)
            return
        if event in (cv2.EVENT_LBUTTONDOWN, cv2.EVENT_RBUTTONDOWN):
            self._last_xy = (x, y)
            return
        if event == cv2.EVENT_MOUSEMOVE and self._last_xy is not None \
                and flags & (cv2.EVENT_FLAG_LBUTTON
                             | cv2.EVENT_FLAG_RBUTTON):
            dx, dy = x - self._last_xy[0], y - self._last_xy[1]
            self._last_xy = (x, y)
            view = self._ensure_free()
            if flags & cv2.EVENT_FLAG_LBUTTON:
                view.orbit(dx, dy)
            else:
                view.pan(dx, dy)

    def current_view(self):
        """(rv, eye) actually used for the next frame (None = follow)."""
        if self.follow or self.free_view is None:
            return None
        return self.free_view.rv_eye()

    def view_frame(self, cam_pose, pts, det) -> None:
        cam_pose = np.asarray(cam_pose)
        self._last_pose = cam_pose
        if self._n == len(self._traj):
            self._traj = np.concatenate(
                [self._traj, np.empty_like(self._traj)])
        self._traj[self._n] = cam_pose[:3]
        self._n += 1
        if not self.enabled or self.quit:
            return
        dw = _world_detections(cam_pose, det) if det else None
        img = render_map_frame(cam_pose, self._traj[:self._n],
                               np.asarray(pts), dw,
                               view=self.current_view())
        try:
            import cv2
            cv2.imshow(self.WINDOW, img[..., ::-1])
            if not self._mouse_cb_set:
                try:
                    cv2.setMouseCallback(self.WINDOW, self.on_mouse)
                except Exception:
                    pass  # backend without mouse support
                self._mouse_cb_set = True
            key = cv2.waitKey(1) & 0xFF
            if key == ord("q"):
                self.quit = True
                cv2.destroyAllWindows()
            elif key == ord("f"):
                # toggle follow <-> free (free keeps its last state)
                self.follow = not self.follow
                if not self.follow:
                    self._ensure_free()
        except Exception as e:
            print(f"live 3D display unavailable ({e}); continuing "
                  "headless")
            self.enabled = False

    def skip_to(self, i: int) -> None:
        pass  # a resumed run's 3D window restarts its trajectory trace

    def close(self) -> None:
        if self.enabled and not self.quit:
            try:
                import cv2
                cv2.destroyAllWindows()
            except Exception:
                pass


def stop_requested(viewers) -> bool:
    """True once any sink asked to end the run — the live window's 'q'
    key. The reference's driver loop breaks when its 2D viewer returns
    False on quit (reference main/run_slam.py:127-141,
    viewers/viewer_2d.py:103-106); the drivers poll this after each
    frame so --display behaves the same way."""
    return any(getattr(v, "quit", False) for v in viewers)


def build_viewers(cfg: SlamAppConfig, cam, src=None,
                  frame_shape=(1080, 1920), display: bool = False,
                  timer: StageTimer | None = None) -> list:
    """The sinks the flags ask for; ``timer`` collects their host
    seconds by stage (``draw_2d``, ``raster_3d``, ``png``)."""
    viewers = []
    if cfg.viz_3d:
        viewers.append(Viewer3DSink(cfg, timer=timer))
    if display:
        # reference parity: --display opens BOTH live windows — the 2D
        # overlay (cv2) and the 3D follow-camera map (Pangolin there,
        # viz/render3d here)
        viewers.append(Live3DDisplaySink())
    if cfg.viz_2d or display:
        v2 = Viewer2DSink(cam, cfg, make_frame_provider(cfg, src),
                          frame_shape, timer=timer)
        viewers.append(LiveDisplaySink(v2) if display else v2)
    return viewers


def replay(viewers, times, cam_traj, lm, lm_active, t_cl, q_cl, mask,
           slot_ids=None) -> None:
    """Offline pass-2: push every smoothed pose + the final map through
    the sinks (reference main/run_offline.py:104-142). Host arrays."""
    act = np.asarray(lm_active)
    pts = np.asarray(lm)[:, :3][act]
    ids = None if slot_ids is None else np.asarray(slot_ids)
    for i in range(len(times)):
        det = [(t_cl[i][j], q_cl[i][j],
                int(j) if ids is None else int(ids[j]))
               for j in np.where(np.asarray(mask[i]))[0]]
        for v in viewers:
            v.view_frame(np.asarray(cam_traj[i]), pts, det)
        if stop_requested(viewers):
            break
    for v in viewers:
        v.close()
