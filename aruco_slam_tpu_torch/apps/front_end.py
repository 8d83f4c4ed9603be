"""The apps' front end: frames or marker corners -> each frame's
marker poses in the id->slot table's slots.

`ChunkStep` is the image path over one chunk of frames, (T, H, W) for
one stream or (S, T, H, W) for a fleet: the robust sweep
(`ops.detect.detect_candidates_batch`) and the id->slot scan
(`assign_sequence_lru`), or with ``--track-every K`` the tracker
(`streaming_step`); then batched PnP (`ops.pnp.solve_square_pnp`, one
kernel on a card) and its gate, `accept`. run_slam's single stream
(`observations_from_frames`), its fleet (`run_slam.run_multi_stream`)
and the distributed ingest (`observations_from_frames_sharded`, which
sweeps only its own chunks) all step it. The loaders return
`Observations`. An npz's images reach the single stream's chunk step
from a reader thread (`io.ChunkReader`) that inflates chunk k+1 into a
ring of reused chunk slots, pinned on a card, while the step runs chunk
k. Spans: ``front_end.upload``, ``.sweep``, ``.slots``, ``.pnp``,
``.readback``, and ``input.wait``, the step's wait on the reader;
counters ``front_end.pnp_markers``, ``input.chunks`` (chunks the reader
handed over) and ``input.chunks_waited`` (those the step waited for).
"""

from __future__ import annotations

import contextlib
import functools
import itertools
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.io import (
    NpzSource, PrefetchingFrameSource, RingChunk, video_frames)
from aruco_slam_tpu_torch.ops import detect, pnp
from aruco_slam_tpu_torch.parallel import dist as pdist
from aruco_slam_tpu_torch.utils.profiling import StageTimer

CHUNK = 32  # frames a chunk


class Observations(NamedTuple):
    """A sequence's observations as host arrays (the JAX run_slam's
    loader tuple, in its order)."""

    times: np.ndarray               # (T,)
    t_cl: np.ndarray                # (T, C, 3) marker origin, camera frame
    q_cl: np.ndarray                # (T, C, 4) wxyz marker-to-camera
    mask: np.ndarray                # (T, C) accepted observations
    cam: cam_mod.CameraModel
    ambiguity: np.ndarray | None    # (T, C) err / err2 of IPPE's poses
    slot_ids: np.ndarray | None     # (C,) marker ids; None: slot == id
    reset: np.ndarray | None        # (T, C) slots recycled at the frame
    ids_seq: np.ndarray | None      # (T, C) the table after each frame


class Carry(NamedTuple):
    """What crosses a stream's chunks (a fleet's: a leading (S,) axis)."""

    table: torch.Tensor             # (C,) slot -> marker id, -1 free
    seen: torch.Tensor              # (C,) frame each slot was last seen
    stream: tuple | None            # the tracker's, `detect.streaming_init`
    frame: int                      # frames done


class Chunk(NamedTuple):
    """A chunk's output on the device, cut to its real frames."""

    t_cl: torch.Tensor
    q_cl: torch.Tensor
    mask: torch.Tensor
    ambiguity: torch.Tensor
    reset: torch.Tensor | None      # None when tracked
    ids_seq: torch.Tensor | None
    dropped: torch.Tensor | None    # (..., T) new ids that found no slot


def camera(k, d, device) -> cam_mod.CameraModel:
    return cam_mod.CameraModel.from_matrix(
        np.asarray(k, np.float32), np.asarray(d, np.float32),
        device=device)


def accept(res: pnp.PnPResult, det_mask, max_reproj_px: float):
    """The PnP gate: (mask, ambiguity). A detection is accepted where
    its reprojection error is under ``max_reproj_px`` (a NaN error is
    not); its ambiguity is the error over the rejected solution's."""
    mask = det_mask & (res.err < max_reproj_px)
    return mask, res.err / torch.clamp(res.err2, min=1e-9)


def _pnp(timer: StageTimer, cam, cfg: SlamAppConfig, corners, det_mask):
    """PnP and the gate under ``front_end.pnp``: (t_cl, q_cl, mask,
    ambiguity); counts every slot solved (a shape: no sync)."""
    with timer.stage("front_end.pnp"):
        res = pnp.solve_square_pnp(cam, corners, cfg.marker_size)
        timer.count("front_end.pnp_markers", corners[..., 0, 0].numel())
        return res.t_cl, res.q_cl, *accept(res, det_mask, cfg.max_reproj_px)


def _pad(a: np.ndarray, length: int, axis: int = 0) -> np.ndarray:
    """``a`` zero-padded along ``axis`` to ``length``."""
    width = [(0, 0)] * a.ndim
    width[axis] = (0, length - a.shape[axis])
    return np.pad(a, width) if length > a.shape[axis] else a


class ChunkStep:
    """``step(carry, frames) -> (carry, Chunk)`` over one stream's T
    frames ((T, H, W) or T (H, W) frames, or an `io.RingChunk`) or, with
    ``streams`` S, a fleet's (S, T, H, W) chunk; ``init()`` is the first
    carry. Full detection zero-pads a tail chunk to ``chunk`` frames (a
    zero frame has no candidate, so no real frame's output changes; a
    ring slot comes padded), uploads it, sweeps it as one batch and
    scans the slots (`slots`). Tracked, the
    chunk steps frame by frame through `detect.streaming_step` (a fleet
    time-major, on one schedule or ``cfg.rescue_cohorts`` cohorts)
    under ``front_end.slots``. Then PnP and the gate."""

    def __init__(self, cam, cfg: SlamAppConfig, device: torch.device,
                 timer: StageTimer | None = None, chunk: int = CHUNK,
                 streams: int | None = None):
        self.cam, self.cfg, self.device = cam, cfg, device
        self.timer = timer or StageTimer()
        self.chunk, self.streams = chunk, streams
        self.axis = 0 if streams is None else 1  # the time axis
        self.dcfg = detect.with_preset(detect.DetectorConfig(
            capacity=cfg.capacity, dict_name=cfg.dict_name,
            slot_max_age=cfg.slot_max_age), cfg.detector)
        self.track = cfg.track_every and detect.streaming_step(
            self.dcfg, cfg.track_every, streams=streams, mapped=True,
            rescue_cohorts=cfg.rescue_cohorts)

    def init(self) -> Carry:
        table = detect.slot_table_init(self.dcfg.capacity, self.device,
                                       self.streams)
        stream = detect.streaming_init(
            self.dcfg, streams=self.streams, mapped=True,
            device=self.device) if self.track else None
        return Carry(table, torch.zeros_like(table), stream, 0)

    def __call__(self, carry: Carry, frames) -> tuple[Carry, Chunk]:
        ax = self.axis
        with self.timer.stage("front_end.upload"):
            ims, n = self._upload(frames)
        if not self.track:
            with self.timer.stage("front_end.sweep"):
                cands = detect.detect_candidates_batch(ims, self.dcfg)
            return self.slots(carry, cands, n)
        with self.timer.stage("front_end.slots"):
            # a fleet's chunk made time-major on the device: frame j of
            # every stream is the contiguous (S, H, W) block
            stream, per_frame = carry.stream, []
            for im in ims if ax == 0 else ims.transpose(0, 1).contiguous():
                stream, out = self.track(stream, im)
                per_frame.append(out)
            det_c, det_m = (torch.stack(x, ax) for x in zip(*per_frame))
        carry = Carry(stream[3], carry.seen, stream, carry.frame + n)
        return carry, self._chunk(det_c, det_m, None, None, None, n)

    def _upload(self, frames) -> tuple[torch.Tensor, int]:
        """(the chunk on the device, its real frames). A ring slot goes
        as it is, padded, or its first n frames when tracked: on a card
        a non-blocking copy from pinned memory on the current stream,
        after which the slot goes back with an event the reader waits
        for before it refills it (on the CPU the consumer hands it back
        once the step is done, since the step reads the slot itself)."""
        if isinstance(frames, RingChunk):
            n = frames.n
            ims = (frames.frames[:n] if self.track else frames.frames).to(
                self.device, non_blocking=True)
            if ims.is_cuda:
                copied = torch.cuda.Event()
                copied.record()
                frames.release(copied)
            return ims, n
        ims = np.ascontiguousarray(frames)
        n = ims.shape[self.axis]
        if not self.track:
            ims = _pad(ims, self.chunk, self.axis)
        return torch.from_numpy(ims).to(self.device), n

    def slots(self, carry: Carry, cands, n: int) -> tuple[Carry, Chunk]:
        """The id->slot scan over a chunk's candidates
        (``front_end.slots``: `detect.assign_sequence_lru` from frame
        ``carry.frame``), then PnP and the gate; ``n`` real frames."""
        with self.timer.stage("front_end.slots"):
            det_c, det_m, reset, ids_seq, table, seen, dropped = \
                detect.assign_sequence_lru(self.dcfg, carry.table,
                                           carry.seen, carry.frame, *cands)
        carry = carry._replace(table=table, seen=seen,
                               frame=carry.frame + n)
        return carry, self._chunk(det_c, det_m, reset, ids_seq, dropped, n)

    def _chunk(self, det_c, det_m, reset, ids_seq, dropped, n) -> Chunk:
        out = (*_pnp(self.timer, self.cam, self.cfg, det_c, det_m),
               reset, ids_seq, dropped)
        return Chunk(*(None if x is None else x.narrow(self.axis, 0, n)
                       for x in out))


def _batches(frame_iter, n: int):
    """(timestamps, frames) of every ``n`` consecutive (timestamp, gray)
    pairs of ``frame_iter``; the last batch may be shorter."""
    it = iter(frame_iter)
    while batch := list(itertools.islice(it, n)):
        yield tuple(zip(*batch))


def _waited(reader, timer: StageTimer):
    """(timestamps, `RingChunk`) of each chunk of ``reader``, the wait
    for it under ``input.wait``, counted in ``input.chunks`` and, where
    the reader had not finished it, ``input.chunks_waited``; each slot
    goes back to the reader when the step is done with it."""
    it = iter(reader)
    while True:
        waits = reader.waits
        with timer.stage("input.wait"):
            chunk = next(it, None)
        if chunk is None:
            return
        timer.count("input.chunks", 1)
        timer.count("input.chunks_waited", reader.waits - waits)
        yield chunk.times, chunk
        chunk.release()


@contextlib.contextmanager
def _chunked(frames, n: int, device: torch.device, timer: StageTimer):
    """(timestamps, frames) of every ``n`` consecutive frames: of a
    (timestamp, gray) iterator, or of an `NpzSource`'s images, streamed
    by a reader thread into the slots of a ring made for the request
    (pinned on a card, where PyTorch's caching host allocator serves the
    next request's ring from the freed one) where the source allows it
    (`NpzSource.stream`), else the whole array; the reader stops when
    the block ends."""
    pinned = functools.partial(torch.empty, dtype=torch.uint8,
                               pin_memory=device.type == "cuda")
    reader = frames.stream(n, pinned) if isinstance(frames, NpzSource) \
        else None
    if reader is not None:
        with contextlib.closing(reader):
            yield _waited(reader, timer)
    elif isinstance(frames, NpzSource):
        yield _batches(zip(frames.times, frames["images"]), n)
    else:
        yield _batches(frames, n)


def _observations(timer: StageTimer, times, chunks, cam, table,
                  cfg: SlamAppConfig, warn: bool = True) -> Observations:
    """One stream's chunks read back (``front_end.readback``) as
    `Observations`; warns when the id->slot table saturated."""
    with timer.stage("front_end.readback"):
        dropped = sum(int(c.dropped.sum()) for c in chunks
                      if c.dropped is not None)
        if dropped and warn:
            print(f"WARNING: {dropped} marker sightings found NO free "
                  f"slot (id->slot table saturated at capacity "
                  f"{cfg.capacity}); raise --capacity or set "
                  "--slot-max-age N to recycle stale slots")

        def cat(field):
            return np.concatenate([getattr(c, field).cpu().numpy()
                                   for c in chunks])

        recycle = bool(cfg.slot_max_age)
        return Observations(
            np.asarray(times), cat("t_cl"), cat("q_cl"), cat("mask"), cam,
            cat("ambiguity"), table.cpu().numpy(),
            cat("reset") if recycle else None,
            cat("ids_seq") if recycle else None)


def observations_from_frames(frame_iter, cam, cfg: SlamAppConfig,
                             device: torch.device,
                             timer: StageTimer | None = None,
                             chunk: int = CHUNK) -> Observations:
    """The image front end over a (timestamp, gray) iterator or an
    `NpzSource`'s images (streamed: `_chunked`), ``chunk`` frames at a
    time through `ChunkStep`; ``reset`` and ``ids_seq`` only with
    ``--slot-max-age``."""
    if cfg.track_every and cfg.slot_max_age:
        raise ValueError("--slot-max-age with --track-every is not "
                         "supported yet: the streaming carry does not "
                         "thread the LRU table")
    step = ChunkStep(cam, cfg, device, timer, chunk)
    carry, times, chunks = step.init(), [], []
    with _chunked(frame_iter, chunk, device, step.timer) as batches:
        for ts, frames in batches:
            times += ts
            carry, out = step(carry, frames)
            chunks.append(out)
    if not times:
        raise ValueError("no decodable frames")
    return _observations(step.timer, times, chunks, cam, carry.table, cfg)


def observations_from_frames_sharded(frame_iter, cam, cfg: SlamAppConfig,
                                     device: torch.device, pid: int,
                                     nproc: int, chunk: int = CHUNK,
                                     total: int | None = None,
                                     timer: StageTimer | None = None
                                     ) -> Observations:
    """The distributed image front end (run_offline --distributed), the
    JAX run_slam's: process c % nproc sweeps chunk c (B1, B2), the
    candidates are all-gathered on the host and put back in order, and
    every process replicates the slot scan and PnP (`ChunkStep.slots`)
    at the single stream's chunk and shapes: the observations are
    `observations_from_frames`' bit for bit. With ``total`` frames
    known the sweep's chunk shrinks so that every process owns one; a
    process that owns none raises."""
    if cfg.track_every:
        raise ValueError("--distributed ingest shards full detection; "
                         "tracked streaming (--track-every) is "
                         "sequential — drop one of the two flags")
    step = ChunkStep(cam, cfg, device, timer, chunk)
    sweep = chunk if total is None else max(1, min(chunk, -(-total // nproc)))
    times, mine, n_chunks = [], [], 0
    for ts, frames in _batches(frame_iter, sweep):
        times += ts
        if n_chunks % nproc == pid:
            cands = detect.detect_candidates_batch(torch.from_numpy(
                _pad(np.stack(frames), sweep)).to(device), step.dcfg)
            mine.append([x.cpu().numpy() for x in cands])
        n_chunks += 1
    if not times:
        raise ValueError("no decodable frames")
    if not mine:
        raise ValueError(
            f"process {pid} owns no chunks ({n_chunks} chunks over "
            f"{nproc} processes): use fewer processes")
    mmax = -(-n_chunks // nproc)
    local = [np.stack([m[j] for m in mine]
                      + [np.zeros_like(mine[0][j])] * (mmax - len(mine)))
             for j in range(len(mine[0]))]
    ordered = [np.concatenate([g[c % nproc, c // nproc]
                               for c in range(n_chunks)])
               for g in pdist.all_gather_host(local)]

    carry, chunks = step.init(), []
    for f0 in range(0, len(times), chunk):
        with step.timer.stage("front_end.upload"):
            cands = [torch.from_numpy(_pad(a[f0:f0 + chunk], chunk)
                                      ).to(device) for a in ordered]
        carry, out = step.slots(carry, cands, min(chunk, len(times) - f0))
        chunks.append(out)
    return _observations(step.timer, times, chunks, cam, carry.table, cfg,
                         warn=pid == 0)


def _from_frames(frames, cam, cfg: SlamAppConfig, device: torch.device,
                 shard, timer, total=None) -> Observations:
    """The image front end; ``shard=(pid, nproc)`` shards its sweep."""
    if shard and shard[1] > 1:
        return observations_from_frames_sharded(
            frames, cam, cfg, device, *shard, total=total, timer=timer)
    return observations_from_frames(frames, cam, cfg, device, timer)


def _prefetched_video(path: str):
    """A video's (timestamp, gray) frames, decoded ahead on a background
    thread into a ring of 16 (the JAX run_slam's video path); the first
    frame, decoded here, gives the ring its frame shape."""
    frames = video_frames(path)
    first = next(frames, None)
    if first is None:
        raise ValueError(f"{path}: no decodable frames")
    return itertools.chain([first], PrefetchingFrameSource(
        frames, first[1].shape))


def load_camera(cfg: SlamAppConfig, calib_dir=None, device=None
                ) -> cam_mod.CameraModel:
    """Camera from saved calibration artifacts (``calib_dir``'s
    camera_matrix.npy + dist_coeffs.npy, the reference's files) or the
    config fallback, as f32 on ``device``."""
    k, d = cfg.camera_matrix, cfg.dist_coeffs
    if calib_dir:
        k = np.load(Path(calib_dir) / "camera_matrix.npy")
        d = np.load(Path(calib_dir) / "dist_coeffs.npy")
    return camera(k, d, device)


def load_video_observations(cfg: SlamAppConfig, calib_dir,
                            device: torch.device, shard=None,
                            timer: StageTimer | None = None
                            ) -> Observations:
    """A video's `Observations` (see `load_observations`): the camera
    from `load_camera`, frames decoded ahead on a thread into the front
    end. ``shard=(pid, nproc)`` shards the candidate pipeline over
    processes (`observations_from_frames_sharded`)."""
    cam = load_camera(cfg, calib_dir, device)
    return _from_frames(_prefetched_video(cfg.input), cam, cfg, device,
                        shard, timer)


def load_observations(src: NpzSource, cfg: SlamAppConfig,
                      device: torch.device, shard=None,
                      timer: StageTimer | None = None,
                      display: bool = False) -> Observations:
    """An npz's `Observations`, from its ``images`` (the image front
    end; ``shard=(pid, nproc)`` shards its sweep over processes), its
    ``corners`` (PnP and the gate alone) or its pose-level ``t_cl``; the
    camera and marker size from the file where it has them. One stream's
    images stream from a reader thread into the chunk step, unless the
    2D viewer (``cfg.viz_2d`` or ``display``) reads them again after the
    front end: then, as for a sharded sweep, the whole array is inflated
    once."""
    timer = timer or StageTimer()
    k = src["camera_matrix"] if src.has("camera_matrix") \
        else cfg.camera_matrix
    d = src["dist_coeffs"] if src.has("dist_coeffs") else cfg.dist_coeffs
    cam = camera(k, d, device)
    if src.has("marker_size"):
        cfg.marker_size = float(src["marker_size"])
    if src.has("images"):
        if not ((shard and shard[1] > 1) or cfg.viz_2d or display):
            return observations_from_frames(src, cam, cfg, device, timer)
        imgs = src["images"]
        return _from_frames(zip(src.times, imgs), cam, cfg, device, shard,
                            timer, total=len(imgs))
    if src.has("corners"):
        with timer.stage("front_end.upload"):
            corners = torch.as_tensor(src["corners"], dtype=torch.float32,
                                      device=device)
            corner_mask = torch.as_tensor(src["corner_mask"], device=device)
        t_cl, q_cl, mask, amb = _pnp(timer, cam, cfg, corners, corner_mask)
        with timer.stage("front_end.readback"):
            return Observations(src.times, t_cl.cpu().numpy(),
                                q_cl.cpu().numpy(), mask.cpu().numpy(), cam,
                                amb.cpu().numpy(), None, None, None)
    if src.has("t_cl"):
        return Observations(src.times, src["t_cl"], src["q_cl"],
                            src["mask"], cam, None, None, None, None)
    raise ValueError(
        f"{src.path}: no 'images', 'corners', or 't_cl' observations")
