"""Host-side IO in the JAX package's formats (aruco_slam_tpu/io):
npz sequence bundles, the TUM trajectory file and the landmark map file.

The same formats byte for byte (tests/test_torch_core.py reads the
port's files with the JAX package's readers), without importing the
JAX package. `VideoSource` decodes video files as the JAX package's
does (imageio's pyav plugin where it is installed, else cv2), with the
numpy grayscale+resize in place of the native host library; both give
the same bytes (integer BT.601 weights, floored), which
tests/test_torch_core.py checks on the imageio route with and without
that library. `PrefetchingFrameSource` decodes ahead on a background
thread into a bounded queue, where the JAX package feeds a native ring.
`write_png_gray` and `write_png_rgb` write 8-bit grayscale and RGB PNGs
with the standard library alone (the calibration previews and the
viewers' frames, so that they need no image library);
`read_png_gray` and `read_png_rgb` read them back.
"""

from __future__ import annotations

import queue
import struct
import threading
import zlib
from pathlib import Path
from typing import NamedTuple

import numpy as np

VIDEO_SUFFIXES = {".mp4", ".avi", ".mov", ".mkv"}
_MAP_HEADER = "# landmark_id\n# x y z\n# uncertainty\n\n"


def is_video(path) -> bool:
    return Path(path).suffix.lower() in VIDEO_SUFFIXES


def gray_resize(frame: np.ndarray, out_hw: tuple[int, int]) -> np.ndarray:
    """RGB/gray uint8 frame -> grayscale uint8 at out_hw: BT.601 weights
    in 1/256ths and nearest-neighbour rows/columns."""
    oh, ow = out_hw
    frame = np.ascontiguousarray(frame)
    if frame.ndim == 2:
        g = frame.astype(np.float32)
    else:
        g = frame[..., :3].astype(np.float32) @ (np.asarray([77, 150, 29])
                                                 / 256.0)
    ys = np.arange(oh) * frame.shape[0] // oh
    xs = np.arange(ow) * frame.shape[1] // ow
    return g[ys][:, xs].astype(np.uint8)


class VideoSource:
    """Grayscale frames from a video file, decoded on the host: imageio's
    pyav plugin where it is installed, else cv2. ``size=(w, h)`` resizes
    every frame; None keeps the native resolution."""

    def __init__(self, path, size=None) -> None:
        self.path = str(path)
        self.size = size
        try:
            import imageio.v3 as iio
            self._iio = iio
            self._mode = "imageio"
            meta = iio.improps(self.path, plugin="pyav")
            self.num_frames = int(meta.shape[0]) if meta.shape else 0
        except Exception:
            import cv2
            self._cv2 = cv2
            self._mode = "cv2"
            cap = cv2.VideoCapture(self.path)
            self.num_frames = int(cap.get(cv2.CAP_PROP_FRAME_COUNT))
            cap.release()

    def __len__(self) -> int:
        return self.num_frames

    def frames(self):
        """Yield (timestamp_s, grayscale uint8 (H, W)) per frame."""
        w, h = self.size if self.size else (None, None)
        if self._mode == "imageio":
            for i, frame in enumerate(
                    self._iio.imiter(self.path, plugin="pyav")):
                out_hw = (h, w) if self.size else frame.shape[:2]
                yield i / 30.0, gray_resize(frame, out_hw)
            return
        cap = self._cv2.VideoCapture(self.path)
        try:
            while True:
                ret, frame = cap.read()
                if not ret:
                    break
                ts = cap.get(self._cv2.CAP_PROP_POS_MSEC) / 1000.0
                gray = self._cv2.cvtColor(frame, self._cv2.COLOR_BGR2GRAY)
                if self.size:
                    gray = self._cv2.resize(gray, (w, h))
                yield ts, gray
        finally:
            cap.release()


def video_frames(path):
    """(timestamp_s, grayscale uint8 (H, W)) per frame of a video."""
    return VideoSource(path).frames()


class _Failed(NamedTuple):
    error: Exception


_END = object()


class PrefetchingFrameSource:
    """Decode ahead: a background thread drains ``frame_iter`` of
    (timestamp, gray) pairs into a queue of at most ``capacity`` frames,
    and iterating yields them in order: the timestamp as a float (f64,
    exact), the frame as a uint8 copy of shape ``frame_shape``.

    An exception in the decode thread is raised again in the consumer
    when it reaches that point of the stream, so a truncated video is
    an error, not a shorter run. The thread starts with the iteration,
    so a source that is never iterated decodes nothing. Ending the
    iteration early (a ``break``, an exception, or `close`) stops the
    thread: a producer waiting on a full queue sees the stop within
    ~0.05 s, one in the middle of a decode after it, and then closes
    ``frame_iter``."""

    _POLL_S = 0.05

    def __init__(self, frame_iter, frame_shape, capacity: int = 16) -> None:
        self.shape = tuple(frame_shape)
        self._frames = frame_iter
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self.thread = threading.Thread(target=self._produce,
                                       args=(frame_iter,), daemon=True)

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def _produce(self, frame_iter) -> None:
        end = _END
        try:
            for ts, frame in frame_iter:
                gray = np.array(frame, np.uint8).reshape(self.shape)
                if not self._put((float(ts), gray)):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            end = _Failed(e)
        finally:
            self._put(end)
            _close(frame_iter)

    def __iter__(self):
        if self._stop.is_set():
            return
        self.thread.start()
        try:
            while (item := self._queue.get()) is not _END:
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the decode thread (it ends on its own within ~0.05 s, or
        after the decode it is in); a source never iterated closes
        ``frame_iter`` here."""
        self._stop.set()
        if self.thread.ident is None:
            _close(self._frames)


def _close(frame_iter) -> None:
    close = getattr(frame_iter, "close", None)
    if close is not None:
        close()


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


_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


# PNG colour types (8 bits a sample each): (name, samples a pixel)
_PNG_TYPES = {0: ("grayscale", 1), 2: ("RGB", 3)}


def _write_png(path, img: np.ndarray, color_type: int, level: int) -> None:
    h, w = img.shape[:2]
    rows = np.concatenate(
        [np.zeros((h, 1), np.uint8), img.reshape(h, -1)], axis=1)
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_bytes(
        _PNG_SIGNATURE
        + _png_chunk(b"IHDR",
                     struct.pack(">IIBBBBB", w, h, 8, color_type, 0, 0, 0))
        + _png_chunk(b"IDAT", zlib.compress(rows.tobytes(), level))
        + _png_chunk(b"IEND", b""))


def _read_png(path, color_type: int) -> np.ndarray:
    data = Path(path).read_bytes()
    if not data.startswith(_PNG_SIGNATURE):
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, head = len(_PNG_SIGNATURE), [], None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag, body = data[pos + 4:pos + 8], data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{path}: bad CRC in chunk {tag!r}")
        if tag == b"IHDR":
            head = struct.unpack(">IIBBBBB", body)
        elif tag == b"IDAT":
            idat.append(body)
        pos += 12 + n
    name, c = _PNG_TYPES[color_type]
    if head is None or head[2:] != (8, color_type, 0, 0, 0):
        raise ValueError(f"{path}: not an 8-bit {name} PNG ({head})")
    w, h = head[:2]
    rows = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    rows = rows.reshape(h, w * c + 1)
    if rows[:, 0].any():
        raise ValueError(f"{path}: filtered rows are not supported")
    img = rows[:, 1:].copy()
    return img if c == 1 else img.reshape(h, w, c)


def write_png_gray(path, img: np.ndarray) -> None:
    """Write an (H, W) uint8 image as an 8-bit grayscale PNG (every row
    unfiltered, one zlib stream)."""
    img = np.ascontiguousarray(img)
    if img.ndim != 2 or img.dtype != np.uint8:
        raise ValueError(f"need an (H, W) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    _write_png(path, img, 0, zlib.Z_DEFAULT_COMPRESSION)


def read_png_gray(path) -> np.ndarray:
    """Read back what `write_png_gray` writes: an 8-bit grayscale,
    non-interlaced PNG whose rows are unfiltered. Anything else
    raises ValueError (this is not a general decoder)."""
    return _read_png(path, 0)


def write_png_rgb(path, img: np.ndarray) -> None:
    """Write an (H, W, 3) uint8 image as an 8-bit RGB PNG (every row
    unfiltered, one zlib stream at level 1, the fastest: the viewers
    write a PNG a frame)."""
    img = np.ascontiguousarray(img)
    if img.ndim != 3 or img.shape[2] != 3 or img.dtype != np.uint8:
        raise ValueError(f"need an (H, W, 3) uint8 image, got {img.dtype} "
                         f"{img.shape}")
    _write_png(path, img, 2, 1)


def read_png_rgb(path) -> np.ndarray:
    """Read back what `write_png_rgb` writes: (H, W, 3) uint8. Anything
    else raises ValueError (this is not a general decoder)."""
    return _read_png(path, 2)
