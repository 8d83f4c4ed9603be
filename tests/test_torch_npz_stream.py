"""An npz clip's frames streamed into the chunk step (`io.ChunkReader`,
`io.NpzSource.stream`, `apps.front_end`): a reader thread inflates the
``images`` member a chunk at a time into a ring of reused slots while
the step runs the chunk before.

On the CPU: the chunks are the file's frames byte for byte, a tail
chunk zero-padded, in a ring the caller made; the front end's
observations equal the whole-array path's bit for bit, plain and
tracked; the 2D viewer keeps the whole array and corner input starts no
reader; a corrupt member fails the request; an early end stops the
thread. The tests marked ``cuda`` need a card and skip without one:

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_npz_stream.py

On the card the slots are pinned and each goes back with an event
recorded after its non-blocking copy: a consumer slowed by
``torch.cuda._sleep`` still uploads every chunk intact, and the
observations (plain and tracked) and the peak of device memory are the
whole-array path's.
"""

import functools
import math
import zipfile
import zlib

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch import io as tio
from aruco_slam_tpu_torch.apps import front_end
from aruco_slam_tpu_torch.apps import make_synthetic as tsyn
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.utils.profiling import StageTimer

# the 1080p camera at half scale, for 960x540 frames
HALF_K = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
                   [0.0, 0.0, 1.0]])
CHUNKS, WAITED, WAIT = "input.chunks", "input.chunks_waited", "input.wait"
# the front end as imported, which the tests that cut its chunk patch
FROM_FRAMES = front_end.observations_from_frames


def _noise_clip(path, frames: int, hw=(24, 40), seed=0, save=tio.save_npz):
    """An npz of ``frames`` random (H, W) uint8 frames (incompressible,
    so the reader makes many reads) with their timestamps; the frames."""
    rng = np.random.default_rng(seed)
    images = rng.integers(0, 256, (frames, *hw), dtype=np.uint8)
    save(path, times=np.arange(frames) / 30.0, images=images)
    return images


@pytest.fixture(scope="module")
def clip(tmp_path_factory):
    """5 rendered 960x540 frames of 12 markers, as an npz."""
    path = tmp_path_factory.mktemp("stream") / "clip.npz"
    tio.save_npz(path, **tsyn.build(
        frames=5, markers=12, capacity=16, with_images=True,
        image_size=(960, 540), camera_matrix=HALF_K))
    return path


def _read_all(reader):
    """Every chunk of ``reader`` as (times, a copy of its slot, n)."""
    out = []
    for chunk in reader:
        out.append((chunk.times, np.array(chunk.frames), chunk.n))
        chunk.release()
    return out


@pytest.mark.parametrize("save", ["deflated", "stored"])
@pytest.mark.parametrize("frames", [128, 77])
def test_chunks_are_the_files_frames(tmp_path, monkeypatch, frames, save):
    """T = 128 and T = 77 at 32 frames a chunk, the npz deflated
    (``np.savez_compressed``, the port's writer) or stored
    (``np.savez``), the file read 1,000 bytes at a time, into a ring the
    caller made full of 255s: each slot holds the next 32 frames of
    np.load's array, a tail chunk's unused frames zero, the timestamps
    beside them; four chunks reuse a slot of the three."""
    monkeypatch.setattr(tio, "_INPUT", 1000)
    write = tio.save_npz if save == "deflated" else np.savez
    images = _noise_clip(tmp_path / "a.npz", frames, save=write)
    src = tio.NpzSource(tmp_path / "a.npz")
    assert src.images_header.shape == images.shape
    assert "images" not in src.data
    rings = []
    reader = src.stream(32, lambda shape: rings.append(
        np.full(shape, 255, np.uint8)) or rings[-1])
    assert [r.shape for r in rings] == [(tio.RING_SLOTS, 32, 24, 40)]
    got = _read_all(reader)
    assert len(got) == math.ceil(frames / 32)
    for c, (times, slot, n) in enumerate(got):
        want = images[32 * c:32 * c + 32]
        assert n == len(want) and slot.shape == (32, 24, 40)
        assert np.array_equal(slot[:n], want)
        assert not slot[n:].any()
        assert times == tuple(src.times[32 * c:32 * c + n])
    assert not reader.thread.is_alive()


def _whole(src, cam, cfg, device, chunk):
    """The front end over the whole inflated array (today's path)."""
    frames = zip(src.times, tio.NpzSource(src.path)["images"])
    return FROM_FRAMES(frames, cam, cfg, device, chunk=chunk)


def _same(a: front_end.Observations, b: front_end.Observations) -> None:
    for name, x, y in zip(a._fields, a, b):
        if name != "cam":
            assert (x is None) == (y is None), name
            if x is not None:
                np.testing.assert_array_equal(x, y, err_msg=name)


@pytest.mark.parametrize("chunk,track", [(32, 0), (1, 0), (1, 3)])
def test_load_observations_streams_bit_equal(clip, monkeypatch, chunk,
                                             track):
    """load_observations on an image npz streams its frames: observations
    bit-equal to the whole-array path's, ceil(T / chunk) chunks counted,
    the array never inflated whole; with more chunks than ring slots,
    plain and tracked (the slot's first n frames, unpadded)."""
    real = front_end.observations_from_frames
    monkeypatch.setattr(front_end, "observations_from_frames",
                        lambda *a: real(*a, chunk=chunk))
    cpu = torch.device("cpu")
    src = tio.NpzSource(clip)
    cfg = SlamAppConfig(input=str(clip), capacity=16, track_every=track)
    timer = StageTimer()
    obs = front_end.load_observations(src, cfg, cpu, timer=timer)
    assert "images" not in src.data
    assert timer.counters[CHUNKS] == math.ceil(5 / chunk)
    assert 0 <= timer.counters[WAITED] <= timer.counters[CHUNKS]
    assert timer.counts[WAIT] == math.ceil(5 / chunk) + 1
    _same(obs, _whole(src, obs.cam, cfg, cpu, chunk))
    assert obs.mask.any()


@pytest.mark.parametrize("why", ["viz_2d", "display"])
def test_the_whole_array_where_the_viewer_reads_the_frames(clip, why):
    """The 2D viewer (``--viz-2d`` or ``--display``) reads the frames
    again after the front end: the whole array, inflated once and kept
    for it, the same observations, and no chunk counted."""
    cpu = torch.device("cpu")
    src = tio.NpzSource(clip)
    cfg = SlamAppConfig(input=str(clip), capacity=16,
                        viz_2d=why == "viz_2d")
    timer = StageTimer()
    obs = front_end.load_observations(src, cfg, cpu, timer=timer,
                                      display=why == "display")
    assert "images" in src.data
    assert CHUNKS not in timer.counters and WAIT not in timer.totals
    _same(obs, _whole(src, obs.cam, cfg, cpu, front_end.CHUNK))


def test_opening_reads_the_header_alone(clip, tmp_path, monkeypatch):
    """NpzSource reads every member but ``images`` at open, and of
    ``images`` its header (shape); ``src["images"]`` inflates it once.
    A corner npz's front end starts no reader."""
    read = []
    real = np.lib.format.read_array
    monkeypatch.setattr(np.lib.format, "read_array",
                        lambda *a, **k: read.append(1) or real(*a, **k))
    with np.load(clip) as data:
        members = {k: data[k] for k in data.files}
    read.clear()
    src = tio.NpzSource(clip)
    assert len(read) == len(members) - 1
    assert src.has("images") and "images" not in src.data
    assert src.images_header.shape == members["images"].shape
    assert np.array_equal(src["images"], members["images"])
    assert src["images"] is src["images"] and len(read) == len(members)
    assert src.stream(32) is None  # inflated: the whole array

    corners = tmp_path / "corners.npz"
    tio.save_npz(corners, **{k: v for k, v in members.items()
                             if k != "images"})
    started = []
    monkeypatch.setattr(tio.NpzSource, "stream",
                        lambda *a, **k: started.append(a))
    csrc = tio.NpzSource(corners)
    assert not csrc.has("images") and csrc.images_header is None
    timer = StageTimer()
    obs = front_end.load_observations(
        csrc, SlamAppConfig(input=str(corners), capacity=16),
        torch.device("cpu"), timer=timer)
    assert obs.mask.shape == members["corner_mask"].shape
    assert started == [] and CHUNKS not in timer.counters


def _flip_member_byte(src_path, dst_path, member="images.npy"):
    """A copy of the npz with one byte of ``member``'s compressed data
    flipped, halfway through it."""
    data = bytearray(src_path.read_bytes())
    with zipfile.ZipFile(src_path) as zf:
        info = zf.getinfo(member)
    head = info.header_offset
    name_len = int.from_bytes(data[head + 26:head + 28], "little")
    extra_len = int.from_bytes(data[head + 28:head + 30], "little")
    at = head + 30 + name_len + extra_len + info.compress_size // 2
    data[at] ^= 0x5A
    dst_path.write_bytes(bytes(data))


def test_a_corrupt_member_fails_the_request(clip, tmp_path):
    """One byte of ``images`` flipped: the file still opens (the header
    and the other members are whole), and the request raises the zip's
    error from the reader, writing no trajectory."""
    bad = tmp_path / "bad.npz"
    _flip_member_byte(clip, bad)
    with pytest.raises((zipfile.BadZipFile, zlib.error)):
        np.load(bad)["images"]
    assert tio.NpzSource(bad).has("images")
    traj = tmp_path / "traj.txt"
    with pytest.raises((zipfile.BadZipFile, zlib.error)):
        trun.main(["--input", str(bad), "--platform", "cpu", "--capacity",
                   "16", "--trajectory", str(traj),
                   "--map", str(tmp_path / "map.txt")])
    assert not traj.exists()


def test_an_early_end_stops_the_reader(tmp_path, monkeypatch):
    """A consumer that breaks after one chunk, and a chunk step that
    raises in the second: the reader thread ends within a second."""
    _noise_clip(tmp_path / "a.npz", 128)
    src = tio.NpzSource(tmp_path / "a.npz")
    reader = src.stream(4)
    for _ in reader:
        break
    reader.thread.join(timeout=1.0)
    assert not reader.thread.is_alive()

    readers = []
    real = tio.NpzSource.stream
    monkeypatch.setattr(tio.NpzSource, "stream", lambda *a, **k:
                        readers.append(real(*a, **k)) or readers[-1])
    calls = []

    def fails(self, carry, frames):
        calls.append(frames)
        if len(calls) == 2:
            raise RuntimeError("the step failed")
        return carry, None
    monkeypatch.setattr(front_end.ChunkStep, "__call__", fails)
    with pytest.raises(RuntimeError, match="the step failed"):
        front_end.observations_from_frames(
            tio.NpzSource(tmp_path / "a.npz"), None,
            SlamAppConfig(input=""), torch.device("cpu"), chunk=4)
    assert len(readers) == 1
    readers[0].thread.join(timeout=1.0)
    assert not readers[0].thread.is_alive()


def test_prefetch_and_the_ring_share_one_reader():
    """The video prefetcher and the npz ring are one background-reader
    pattern (`io._Reader`): one stop, one error hand-off."""
    assert issubclass(tio.PrefetchingFrameSource, tio._Reader)
    assert issubclass(tio.ChunkReader, tio._Reader)
    for cls in (tio.PrefetchingFrameSource, tio.ChunkReader):
        assert "__iter__" not in vars(cls) and "_produce" not in vars(cls)


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the ring is pinned for a card's "
                    "copies")
    return torch.device("cuda")


@pytest.mark.cuda
def test_a_slow_consumer_uploads_every_chunk_intact(card, tmp_path):
    """Each chunk's non-blocking copy queued behind a ~20 ms spin on the
    stream, the slot handed back at once with its event: the reader
    refills a slot only after its copy, so every chunk on the card is
    np.load's frames (three slots, sixteen chunks)."""
    images = _noise_clip(tmp_path / "a.npz", 128, hw=(270, 480))
    cfg = SlamAppConfig(input="", capacity=16)
    step = front_end.ChunkStep(None, cfg, card, chunk=8)
    reader = tio.NpzSource(tmp_path / "a.npz").stream(8, functools.partial(
        torch.empty, dtype=torch.uint8, pin_memory=True))
    assert all(slot.is_pinned() for slot in reader.slots)
    got = []
    with torch.cuda.stream(torch.cuda.Stream()):
        for chunk in reader:
            torch.cuda._sleep(20_000_000)
            ims, n = step._upload(chunk)
            got.append(ims[:n])
        torch.cuda.synchronize()
    assert len(got) == 16
    assert torch.equal(torch.cat(got).cpu(), torch.from_numpy(images))


@pytest.mark.cuda
@pytest.mark.parametrize("chunk,track", [(2, 0), (8, 3)])
def test_streamed_observations_on_the_card(card, clip, chunk, track):
    """On the card, the streamed front end gives the whole-array path's
    observations bit for bit, at the same peak of device memory: three
    chunks over the three slots, and tracked (every third frame
    detected in full), the slot's first five frames of eight."""
    src = tio.NpzSource(clip)
    cfg = SlamAppConfig(input=str(clip), capacity=16, track_every=track)
    cam = front_end.camera(src["camera_matrix"], src["dist_coeffs"], card)
    peaks, out = [], []
    for run in (lambda: front_end.observations_from_frames(
                    tio.NpzSource(clip), cam, cfg, card, chunk=chunk),
                lambda: _whole(src, cam, cfg, card, chunk)) * 2:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        out.append(run())
        torch.cuda.synchronize()
        peaks.append(torch.cuda.max_memory_allocated())
    _same(out[2], out[3])
    _same(out[0], out[1])
    assert peaks[2] == peaks[3]
