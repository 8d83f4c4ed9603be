"""Host-side IO in the JAX package's formats (aruco_slam_tpu/io):
npz sequence bundles, the TUM trajectory file and the landmark map file.

The same formats byte for byte (tests/test_torch_core.py reads the
port's files with the JAX package's readers), without importing the
JAX package. Video decode is the one exception: `video_frames` reuses
the JAX package's JAX-free ``VideoSource`` and imports it only when a
video is opened.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np

VIDEO_SUFFIXES = {".mp4", ".avi", ".mov", ".mkv"}
_MAP_HEADER = "# landmark_id\n# x y z\n# uncertainty\n\n"


def is_video(path) -> bool:
    return Path(path).suffix.lower() in VIDEO_SUFFIXES


def video_frames(path):
    """(timestamp_s, grayscale uint8 (H, W)) per frame of a video."""
    from aruco_slam_tpu.io.sources import VideoSource
    return VideoSource(path).frames()


class NpzSource:
    """Sequence bundle: times (T,) and any of t_cl/q_cl/mask,
    corners/corner_mask, images (T, H, W) uint8, gt_cam_t, marker_size,
    camera_matrix, dist_coeffs."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        with np.load(self.path, allow_pickle=False) as data:
            self.data = {k: data[k] for k in data.files}
        if "times" not in self.data:
            raise ValueError(f"{path}: missing 'times'")

    @property
    def times(self) -> np.ndarray:
        return self.data["times"]

    def has(self, key: str) -> bool:
        return key in self.data

    def __getitem__(self, key: str) -> np.ndarray:
        return self.data[key]


def save_npz(path, **arrays) -> None:
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)


class TrajectoryWriter:
    """TUM trajectory lines ``t x y z qx qy qz qw``, one per frame."""

    def __init__(self, filename) -> None:
        self.filename = Path(filename)
        self.file = None

    def __enter__(self) -> "TrajectoryWriter":
        self.filename.parent.mkdir(parents=True, exist_ok=True)
        self.file = self.filename.open("w", encoding="utf-8")
        self.file.write("# timestamp x y z qx qy qz qw\n")
        return self

    def write(self, timestamp_s: float, pose) -> None:
        """pose: (7,) [x y z qw qx qy qz] (the state layout)."""
        pose = np.asarray(pose, dtype=np.float64)
        vals = " ".join(f"{v:.6f}" for v in (*pose[:3],
                                              *np.roll(pose[3:7], -1)))
        self.file.write(f"{timestamp_s:.4f} {vals}\n")

    def __exit__(self, *exc) -> None:
        if self.file is not None:
            self.file.close()
            self.file = None


def read_trajectory(filename) -> tuple[np.ndarray, np.ndarray]:
    """TUM file -> (times (T,), poses (T, 7) [xyz, quat wxyz])."""
    rows = [[float(v) for v in line.split()]
            for line in Path(filename).read_text(encoding="utf-8")
            .splitlines() if line.strip() and not line.startswith("#")]
    arr = np.asarray(rows).reshape(-1, 8)
    return arr[:, 0], np.concatenate(
        [arr[:, 1:4], np.roll(arr[:, 4:8], 1, axis=-1)], axis=-1)


def save_map(filename, ids, positions, uncertainties) -> None:
    """Landmark records: id, position row, uncertainty row, blank."""
    path = Path(filename)
    path.parent.mkdir(parents=True, exist_ok=True)
    positions = np.asarray(positions, np.float64)
    uncertainties = np.asarray(uncertainties, np.float64)
    with path.open("w", encoding="utf-8") as f:
        f.write(_MAP_HEADER)
        for i, pos, unc in zip(np.asarray(ids), positions, uncertainties):
            f.write(f"{int(i)}\n")
            f.write(", ".join(str(v) for v in pos) + "\n")
            f.write(", ".join(str(v) for v in unc[: len(pos)]) + "\n")
            f.write("\n")


def load_map(filename):
    """Landmark records -> (ids (M,), positions (M, D), unc (M, D))."""
    lines = Path(filename).read_text(encoding="utf-8").splitlines()[4:]
    ids, poss, uncs = [], [], []
    for i in range(0, len(lines) - 2, 4):
        ids.append(int(lines[i].strip()))
        poss.append([float(v) for v in lines[i + 1].split(",")])
        uncs.append([float(v) for v in lines[i + 2].split(",")])
    return (np.asarray(ids, np.int32), np.asarray(poss),
            np.asarray(uncs))
