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
thread into a bounded queue, where the JAX package feeds a native ring;
`ChunkReader`, on the same background reader (`_Reader`), inflates an
npz's frames a chunk at a time into the caller's ring of reused chunk
slots, which `NpzSource.stream` hands out.
`write_png_gray` and `write_png_rgb` write 8-bit grayscale and RGB PNGs
with the standard library alone (the calibration previews and the
viewers' frames, so that they need no image library);
`read_png_gray` and `read_png_rgb` read them back.
"""

from __future__ import annotations

import ctypes
import functools
import io
import queue
import struct
import threading
import zipfile
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


class _Reader:
    """The background reader of this module: a thread runs `_items` (a
    generator) into a queue of at most ``capacity`` items, and iterating
    yields them in order.

    An exception in the thread is raised again in the consumer when it
    reaches that point of the stream, so a truncated input is an error,
    not a shorter run. The thread starts with the iteration, so a reader
    that is never iterated reads nothing. Ending the iteration early (a
    ``break``, an exception, or `close`) stops the thread: a producer
    waiting on a full queue sees the stop within ~0.05 s, one in the
    middle of an item after it. The thread then closes `_items` and
    runs `_release` (`close` runs it for a reader never iterated).
    ``waits`` counts the items the consumer asked for before they were
    ready."""

    _POLL_S = 0.05

    def __init__(self, capacity: int) -> None:
        self._queue: queue.Queue = queue.Queue(maxsize=capacity)
        self._stop = threading.Event()
        self.waits = 0
        self.thread = threading.Thread(target=self._produce, daemon=True)

    def _items(self):
        raise NotImplementedError

    def _release(self) -> None:
        """Close what the reader owns (once its thread is done)."""

    def _put(self, item) -> bool:
        while not self._stop.is_set():
            try:
                self._queue.put(item, timeout=self._POLL_S)
                return True
            except queue.Full:
                pass
        return False

    def _get(self, q: queue.Queue):
        """The next item of ``q`` (on the thread), or None once stopped."""
        while not self._stop.is_set():
            try:
                return q.get(timeout=self._POLL_S)
            except queue.Empty:
                pass
        return None

    def _produce(self) -> None:
        end, items = _END, self._items()
        try:
            for item in items:
                if not self._put(item):
                    return
        except Exception as e:  # handed to the consumer, which raises it
            end = _Failed(e)
        finally:
            self._put(end)
            items.close()
            self._release()

    def __iter__(self):
        if self._stop.is_set():
            return
        self.thread.start()
        try:
            while True:
                try:
                    item = self._queue.get_nowait()
                except queue.Empty:
                    item = self._queue.get()
                    self.waits += item is not _END
                if item is _END:
                    return
                if isinstance(item, _Failed):
                    raise item.error
                yield item
        finally:
            self.close()

    def close(self) -> None:
        """Stop the thread (it ends on its own within ~0.05 s, or after
        the item it is in); a reader never iterated releases here."""
        self._stop.set()
        if self.thread.ident is None:
            self._release()


class PrefetchingFrameSource(_Reader):
    """Decode ahead: a background thread drains ``frame_iter`` of
    (timestamp, gray) pairs into a queue of at most ``capacity`` frames,
    and iterating yields them in order: the timestamp as a float (f64,
    exact), the frame as a uint8 copy of shape ``frame_shape``. Stops,
    errors and early ends as `_Reader`'s; ``frame_iter`` is closed when
    the reader ends."""

    def __init__(self, frame_iter, frame_shape, capacity: int = 16) -> None:
        super().__init__(capacity)
        self.shape = tuple(frame_shape)
        self._frames = frame_iter

    def _items(self):
        for ts, frame in self._frames:
            yield float(ts), np.array(frame, np.uint8).reshape(self.shape)

    def _release(self) -> None:
        _close(self._frames)


def _close(frame_iter) -> None:
    close = getattr(frame_iter, "close", None)
    if close is not None:
        close()


def _npy_header(f) -> tuple:
    """(shape, dtype, fortran_order) of the npy stream ``f``, left at
    the array's first byte."""
    version = np.lib.format.read_magic(f)
    read = np.lib.format.read_array_header_1_0 if version[0] == 1 \
        else np.lib.format.read_array_header_2_0
    shape, fortran, dtype = read(f)
    return shape, dtype, fortran


class _Lazy(NamedTuple):
    """An npz member read lazily: its npy header, the header's length,
    and how the zip stores it."""

    shape: tuple
    dtype: np.dtype
    fortran: bool
    offset: int          # bytes of the npy header before the array
    compress_type: int   # zipfile.ZIP_STORED, ZIP_DEFLATED, ...


class _ZStream(ctypes.Structure):
    """zlib's ``z_stream`` (zlib.h)."""

    _fields_ = [("next_in", ctypes.c_void_p), ("avail_in", ctypes.c_uint),
                ("total_in", ctypes.c_ulong), ("next_out", ctypes.c_void_p),
                ("avail_out", ctypes.c_uint), ("total_out", ctypes.c_ulong),
                ("msg", ctypes.c_char_p), ("state", ctypes.c_void_p),
                ("zalloc", ctypes.c_void_p), ("zfree", ctypes.c_void_p),
                ("opaque", ctypes.c_void_p), ("data_type", ctypes.c_int),
                ("adler", ctypes.c_ulong), ("reserved", ctypes.c_ulong)]


Z_OK, Z_STREAM_END, Z_BUF_ERROR = 0, 1, -5


@functools.cache
def _libz():
    """zlib's C library with the prototypes of its inflate. A ctypes
    call releases the interpreter lock, so its inflate runs beside the
    Python of other threads, straight into the caller's buffer."""
    lib = ctypes.CDLL("libz.so.1")
    stream = ctypes.POINTER(_ZStream)
    lib.zlibVersion.argtypes, lib.zlibVersion.restype = [], ctypes.c_char_p
    lib.inflateInit2_.argtypes = [stream, ctypes.c_int, ctypes.c_char_p,
                                  ctypes.c_int]
    lib.inflate.argtypes = [stream, ctypes.c_int]
    lib.inflateEnd.argtypes = [stream]
    for f in (lib.inflateInit2_, lib.inflate, lib.inflateEnd):
        f.restype = ctypes.c_int
    return lib


_INPUT = 1 << 20  # compressed bytes read at a time


class _MemberData:
    """A zip member's bytes, read in order straight into the caller's
    arrays (`into`): a stored member by the file's ``readinto``, a
    deflated one by zlib's C inflate (`_libz`). Neither holds the
    interpreter lock while it works, nor does the CRC-32 of what was
    read, which `end` checks with the size against the zip's
    directory."""

    def __init__(self, path, name: str) -> None:
        self.path, self.name = path, name
        with zipfile.ZipFile(path) as zf:
            self.info = zf.getinfo(name)
        self.fp = open(path, "rb")
        self.z, self.crc, self.done, self.ended = None, 0, 0, False
        try:
            self.fp.seek(self.info.header_offset)
            local = self.fp.read(30)
            if local[:4] != b"PK\x03\x04":
                raise zipfile.BadZipFile(f"{path}: bad local header of "
                                         f"{name!r}")
            self.fp.seek(self.info.header_offset + 30
                         + int.from_bytes(local[26:28], "little")
                         + int.from_bytes(local[28:30], "little"))
            self.left = self.info.compress_size  # compressed bytes unread
            if self.info.compress_type == zipfile.ZIP_DEFLATED:
                self.buf = bytearray(_INPUT)
                self.cbuf = (ctypes.c_char * _INPUT).from_buffer(self.buf)
                z, lib = _ZStream(), _libz()
                r = lib.inflateInit2_(ctypes.byref(z), -zlib.MAX_WBITS,
                                      lib.zlibVersion(),
                                      ctypes.sizeof(_ZStream))
                if r != Z_OK:
                    raise zlib.error(f"Error {r} while preparing to "
                                     "decompress data")
                self.z = z
        except BaseException:
            self.close()
            raise

    def _read(self, out: memoryview) -> int:
        """Compressed (or stored) bytes of the member into ``out``."""
        got = self.fp.readinto(out[:self.left])
        if not got:
            raise zipfile.BadZipFile(f"{self.path}: {self.name!r} is cut "
                                     "short")
        self.left -= got
        return got

    def _inflate(self, out: int, n: int) -> int:
        """Up to ``n`` bytes inflated to the address ``out``, fewer only
        at the stream's end."""
        z, lib, done = self.z, _libz(), 0
        while done < n and not self.ended:
            if z.avail_in == 0 and self.left:
                z.avail_in = self._read(memoryview(self.buf))
                z.next_in = ctypes.addressof(self.cbuf)
            avail = min(n - done, 1 << 30)
            z.next_out, z.avail_out = out + done, avail
            r = lib.inflate(ctypes.byref(z), 0)
            done += avail - z.avail_out
            if r == Z_STREAM_END:
                self.ended = True
            elif r == Z_BUF_ERROR and z.avail_in == 0 and not self.left:
                raise zipfile.BadZipFile(f"{self.path}: {self.name!r} ends "
                                         "before its end-of-stream marker")
            elif r not in (Z_OK, Z_BUF_ERROR):
                raise zlib.error(f"Error {r} while decompressing data: "
                                 f"{(z.msg or b'').decode()}")
        return done

    def into(self, a: np.ndarray) -> None:
        """Fill the C-contiguous array ``a`` with the member's next
        bytes."""
        out = memoryview(a.reshape(-1)).cast("B")
        if self.z is None:
            got = 0
            while got < len(out):
                got += self._read(out[got:])
        elif self._inflate(a.ctypes.data, a.nbytes) < a.nbytes:
            raise zipfile.BadZipFile(f"{self.path}: {self.name!r} ends "
                                     "before its frames")
        self.crc = zlib.crc32(out, self.crc)
        self.done += a.nbytes

    def end(self) -> None:
        """Check that the member holds no more and its CRC-32."""
        scratch = ctypes.create_string_buffer(1)
        extra = self.left if self.z is None else self._inflate(
            ctypes.addressof(scratch), 1)
        if extra or self.done != self.info.file_size:
            raise zipfile.BadZipFile(f"{self.path}: {self.name!r} holds "
                                     f"{self.info.file_size} bytes, its "
                                     f"header {self.done}")
        if self.crc != self.info.CRC:
            raise zipfile.BadZipFile(f"Bad CRC-32 for file {self.name!r}")

    def close(self) -> None:
        if self.z is not None:
            _libz().inflateEnd(ctypes.byref(self.z))
            self.z = None
        self.fp.close()


RING_SLOTS = 3      # chunk slots a `ChunkReader` cycles through


class RingChunk:
    """One chunk handed out by a `ChunkReader`: ``frames``, its ring
    slot, a (chunk, H, W) uint8 buffer whose first ``n`` frames are the
    chunk's and the rest zeros, and ``times``, a tuple of their n
    timestamps."""

    __slots__ = ("times", "frames", "n", "_index", "_free")

    def __init__(self, times, frames, n: int, index: int,
                 free: queue.Queue) -> None:
        self.times, self.frames, self.n = times, frames, n
        self._index, self._free = index, free

    def release(self, after=None) -> None:
        """Hand the slot back to the reader (the first call; later ones
        do nothing). The reader waits for ``after`` (``.synchronize()``:
        an event recorded after the slot's copy to the card) before it
        refills the slot."""
        if self._free is not None:
            self._free.put((self._index, after))
            self._free = None


class ChunkReader(_Reader):
    """An npz's (T, H, W) uint8 ``images``, streamed a chunk at a time: a
    background thread inflates the member (`_MemberData`: zlib's C
    inflate, with the zip's CRC-32 and size checked at the end) straight
    into the slots of ``ring``, the caller's (`RING_SLOTS`, chunk, H, W)
    uint8 buffer (any that ``np.asarray`` views without a copy, such as a
    pinned CPU tensor), zeroes a tail chunk's unused frames, and hands
    each slot over as a `RingChunk` with its timestamps. The consumer
    hands a slot back with `RingChunk.release`, and the reader refills
    it only after that. A corrupt or truncated member raises in the
    consumer at the chunk where it is found."""

    def __init__(self, path, header: _Lazy, times, ring) -> None:
        super().__init__(len(ring))
        self.path, self.header, self.times = Path(path), header, times
        self.slots = list(ring)
        self._views = [np.asarray(slot) for slot in self.slots]
        self._free: queue.Queue = queue.Queue()
        for i in range(len(self.slots)):
            self._free.put((i, None))

    def _items(self):
        t, chunk = self.header.shape[0], len(self._views[0])
        data = _MemberData(self.path, "images.npy")
        try:
            head = np.empty(self.header.offset, np.uint8)
            data.into(head)
            if _npy_header(io.BytesIO(head.tobytes())) != self.header[:3]:
                raise ValueError(f"{self.path}: 'images' changed since it "
                                 "was opened")
            for c0 in range(0, t, chunk):
                got = self._get(self._free)
                if got is None:
                    return
                i, after = got
                if after is not None:
                    after.synchronize()
                n, view = min(chunk, t - c0), self._views[i]
                data.into(view[:n])
                view[n:] = 0
                if c0 + n == t:
                    data.end()
                yield RingChunk(tuple(self.times[c0:c0 + n]), self.slots[i],
                                n, i, self._free)
        finally:
            data.close()


def _empty(shape) -> np.ndarray:
    return np.empty(shape, np.uint8)


class NpzSource:
    """Sequence bundle: times (T,) and any of t_cl/q_cl/mask,
    corners/corner_mask, images (T, H, W) uint8, gt_cam_t, marker_size,
    camera_matrix, dist_coeffs.

    Opening it reads every member but ``images``, of which it reads the
    npy header alone (``images_header``). ``src["images"]`` inflates the
    array when first asked for and keeps it; `stream` hands it out a
    chunk at a time from a background thread instead (`ChunkReader`)."""

    def __init__(self, path) -> None:
        self.path = Path(path)
        self.images_header: _Lazy | None = None
        with np.load(self.path, allow_pickle=False) as data:
            self.data = {k: data[k] for k in data.files if k != "images"}
            if "images" in data.files:
                with data.zip.open("images.npy") as f:
                    header = _npy_header(f)
                    self.images_header = _Lazy(
                        *header, f.tell(),
                        data.zip.getinfo("images.npy").compress_type)
        if "times" not in self.data:
            raise ValueError(f"{path}: missing 'times'")

    @property
    def times(self) -> np.ndarray:
        return self.data["times"]

    def has(self, key: str) -> bool:
        return key in self.data or (key == "images"
                                    and self.images_header is not None)

    def __getitem__(self, key: str) -> np.ndarray:
        if key == "images" and key not in self.data and self.has(key):
            with np.load(self.path, allow_pickle=False) as data:
                self.data[key] = data[key]
        return self.data[key]

    def stream(self, chunk: int, empty=_empty) -> ChunkReader | None:
        """``images`` as a `ChunkReader` of ``chunk`` frames a slot, in a
        ring that ``empty(shape)`` makes (a uint8 buffer of that shape),
        or None where the whole array is the way: an array already
        inflated; one that is not C-order (T, H, W) uint8 with a
        timestamp a frame; one neither stored nor deflated."""
        m = self.images_header
        if m is None or "images" in self.data:
            return None
        if len(m.shape) != 3 or m.dtype != np.uint8 or m.fortran \
                or m.shape[0] != len(self.times):
            return None
        if m.compress_type not in (zipfile.ZIP_STORED, zipfile.ZIP_DEFLATED):
            return None
        return ChunkReader(self.path, m, self.times,
                           empty((RING_SLOTS, chunk, *m.shape[1:])))


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


def write_trajectory(filename, times_s, poses) -> None:
    """Batch write: times (T,), poses (T, 7) = [xyz, quat wxyz]."""
    with TrajectoryWriter(filename) as w:
        for t, p in zip(np.asarray(times_s), np.asarray(poses)):
            w.write(float(t), p)


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
