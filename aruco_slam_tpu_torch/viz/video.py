"""Host-side MP4 export with backend fallback.

Counterpart of aruco_slam_tpu/viz/video.py: cv2.VideoWriter first (the
reference's writer, reference viewers/viewer_2d.py:46-56,
viewers/viewer_3d.py:195-198), then imageio's pyav plugin where OpenCV
is absent or has no mp4v encoder. `encoder_available` says, without
importing either, whether one of them is installed, so that a driver
can refuse ``--export-video`` before it reads any input (`installed`
probes one module).
"""

from __future__ import annotations

import importlib.util
import sys
from pathlib import Path

import numpy as np


def installed(name: str) -> bool:
    """True when the top-level module ``name`` can be imported; it is
    not imported here."""
    if name in sys.modules:  # imported, or blocked with None
        return sys.modules[name] is not None
    try:
        return importlib.util.find_spec(name) is not None
    except (ImportError, ValueError):
        return False


def encoder_available() -> bool:
    """True when cv2, or imageio with pyav, is installed."""
    return installed("cv2") or (installed("imageio") and installed("av"))


def write_video(path, frames: list[np.ndarray] | np.ndarray,
                fps: int = 20) -> None:
    """frames: iterable of (H, W, 3) RGB uint8, all the same size."""
    frames = np.stack(list(frames))
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    try:
        import cv2
        h, w = frames.shape[1:3]
        vw = cv2.VideoWriter(str(path),
                             cv2.VideoWriter_fourcc(*"mp4v"), fps,
                             (w, h))
        if not vw.isOpened():
            raise OSError("cv2.VideoWriter failed to open")
        for f in frames:
            vw.write(f[..., ::-1])  # RGB -> BGR
        vw.release()
        return
    except ImportError:
        pass
    except Exception as e:  # present-but-broken cv2 (no mp4v encoder)
        print(f"cv2 VideoWriter failed ({e}); trying imageio/pyav")
    import imageio.v3 as iio
    iio.imwrite(str(path), frames, fps=fps, plugin="pyav",
                codec="libx264")
