"""Online SLAM command line on PyTorch/CUDA.

Counterpart of aruco_slam_tpu/apps/run_slam.py:

    python -m aruco_slam_tpu_torch.apps.run_slam --input seq.npz \
        [--platform cuda|cpu] [--filter mekf|mekf_rotations|factorgraph]

frames -> the front end (`apps/front_end.py`: the robust sweep in chunks
of 32, the id->slot scan, batched PnP and its gate) -> the backend ->
TUM trajectory + map files in the JAX run_slam's formats. The MEKF
backends run `filters.mekf.mekf_scan`; ``--filter factorgraph`` runs the
windowed factor graph frame by frame (`graph.add_frame`,
`optimize_window` and, past ``--pose-budget``, `marginalize_poses`;
``--ba-rotations`` for 6-dof landmarks), tuned by ``--window``,
``--meas-sigma-t``, ``--odom-sigma-*`` and ``--huber-delta``, with
recycled slots split into per-epoch landmark columns (`epoch_remap`).
npz input may carry `images`, `corners` or pose-level `t_cl` bundles;
video input is decoded by the port's own `io.VideoSource` on a
background thread (`io.PrefetchingFrameSource`), so decode overlaps
detection.

``--track-every K`` runs the streaming front end instead of full
detection on every frame (`ops.detect.streaming_step`);
``--slot-max-age N`` recycles stale id->slot table slots and resets
their landmarks; ``--load-map`` seeds the filter with a saved map;
``--input a.npz,b.npz,...`` serves S streams at once (the front end's
chunk step over all S, ``--rescue-cohorts G`` staggering a tracked
fleet; the S filters in one batched step; per-stream output files).
``--checkpoint-every N --checkpoint PATH`` writes (state, frames done,
trajectory so far) every N frames (the MEKF scan runs in N-frame
chunks), ``--resume PATH`` restarts from such a file (JAX's format:
`utils/checkpoint.py`) after re-ingesting the input's observations;
``--profile DIR`` writes a torch.profiler trace of the run, from the
input's load to the output files, to DIR/trace.json, where the run's
spans (`utils.profiling.StageTimer`: ``input.load``, ``front_end.*``,
``filter.*``, ``output.write``) appear as user annotations. The timer
also counts the rows of each frame's fused update (B3):
``filter.update_rows``, those that carry an observation, and
``filter.update_row_slots``, all M of them (`_count_update_rows`), the
frames whose update ran its N x N products in the wide GEMM tiling,
``filter.b3_wide_frames`` (`_count_wide_frames`), the map's slots that
hold a landmark by each frame, ``filter.map_slots_used``, of
``filter.map_slots``, the capacity a frame (`_count_map_slots`), and
the front end the markers of each PnP call, ``front_end.pnp_markers``;
``RunResult.counters`` returns them. The fleet writes no checkpoint (as
in JAX).

``--viz-2d`` (the overlay on the real frames), ``--viz-3d`` (the map,
``--viz-3d-renderer mpl|fast``) and ``--display`` (live windows; without
a display server a note and headless export) write PNGs under
``--viz-dir``, and with ``--export-video`` MP4s (`apps/sinks.py`). With
any viewer the MEKF steps once a frame instead of filtering in one
scan, and reads the camera pose, the landmarks and their active flags
back to the host in one copy a frame (the trajectory is the scan's,
bit for bit); the factor graph feeds the viewers after each frame. The
live window's 'q' ends the run. A viewer whose library is missing
(matplotlib for the "mpl" renderer, cv2 or imageio's pyav for video)
is refused before any input is read. ``RunResult.seconds`` then also
holds the viewer loop's host seconds by stage: ``step`` (the filter's
dispatch), ``read`` (the device→host copy, which waits for the step),
``draw_2d``, ``raster_3d`` and ``png``.

``--platform cuda`` is the default and raises when no card is present;
the run never moves to the CPU in its place. Every flag of the JAX
run_slam parses and runs: the factor graph's tuning flags are accepted
and unused on the MEKF paths, as there, and with several inputs the
viewer flags print the JAX run_slam's note and the fleet is served.
"""

from __future__ import annotations

import argparse
import time
import uuid
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch._device import (
    request_stream, resolve_device, sync)
from aruco_slam_tpu_torch.apps import sinks
from aruco_slam_tpu_torch.apps.front_end import (
    CHUNK, ChunkStep, Observations, camera, load_camera, load_observations,
    load_video_observations)
from aruco_slam_tpu_torch.bench import ate
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.filters import cuda_mekf
from aruco_slam_tpu_torch.filters import mekf as mekf_mod
from aruco_slam_tpu_torch.filters import (
    FrameObservations, MekfConfig, MekfState, init_state, mekf_scan,
    mekf_step)
from aruco_slam_tpu_torch.graph import (
    GraphConfig, add_frame, check_indices, init_graph, landmark_covariances,
    marginalize_poses, optimize_window)
from aruco_slam_tpu_torch.io import (
    NpzSource, TrajectoryWriter, is_video, load_map, save_map, video_frames)
from aruco_slam_tpu_torch.parallel import multi_slam
from aruco_slam_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from aruco_slam_tpu_torch.utils.profiling import StageTimer, device_trace


class RunResult(NamedTuple):
    """What `main` wrote and measured (one per stream with several
    inputs)."""

    trajectory_file: str
    map_file: str
    cam_traj: np.ndarray      # (T, 7) [xyz, quat wxyz]
    obs_mask: np.ndarray      # (T, C) accepted observations per frame
    landmark_ids: np.ndarray  # marker ids in the map file
    ate: float | None         # vs the input's gt_cam_t, when present
    seconds: dict             # wall time per stage
    counters: dict            # the request's counters (StageTimer.count)


def _auto_max_obs(cfg: SlamAppConfig, mask, capacity: int) -> int:
    """Update-compaction width sized from the densest frame."""
    max_vis = int(np.asarray(mask).sum(axis=-1).max())
    if cfg.max_obs:
        if max_vis > cfg.max_obs:
            print(f"WARNING: --max-obs {cfg.max_obs} < densest frame "
                  f"({max_vis} markers): extra observations will be "
                  "dropped")
        return cfg.max_obs
    return min(capacity, max(16, -(-max_vis // 8) * 8))


def _mekf_config(cfg: SlamAppConfig, capacity: int, max_obs: int,
                 with_rotations: bool, cam) -> MekfConfig:
    """Driver flags -> MekfConfig (single- and multi-stream paths)."""
    return MekfConfig(capacity=capacity, max_obs=max_obs,
                      with_rotations=with_rotations,
                      r_uncertainty=cfg.mekf_r,
                      q_uncertainty_cam=cfg.mekf_q_cam,
                      q_error_uncertainty_cam=cfg.mekf_q_rot,
                      q_uncertainty_lm=cfg.mekf_q_lm,
                      motion_model=cfg.mekf_motion_model,
                      q_vel=cfg.mekf_q_vel,
                      vel_decay=cfg.mekf_vel_decay,
                      matmul_precision=cfg.mekf_precision,
                      pixel_sigma=cfg.pixel_sigma,
                      focal_px=float(cam.fx),
                      marker_size=cfg.marker_size,
                      gate_distance=cfg.gate_distance)


def _dev(a, device, dtype=None):
    return None if a is None else torch.as_tensor(
        np.asarray(a), dtype=dtype, device=device)


def _preload(fcfg: MekfConfig, state, load_map_file, slot_ids):
    """Seed the filter with a saved map: (state, the slots it filled).
    Under the id->slot table the map's marker ids translate to this
    run's slots; landmarks the sequence never observed have no slot and
    are skipped (they could not receive an update anyway)."""
    ids, pos, unc = load_map(load_map_file)
    if slot_ids is not None:
        lut = {int(mid): s for s, mid in enumerate(slot_ids) if mid >= 0}
        keep = [j for j in range(len(ids)) if int(ids[j]) in lut]
        if len(keep) < len(ids):
            print(f"load-map: {len(ids) - len(keep)} landmarks "
                  "not observed in this sequence; skipped")
        pos, unc = pos[keep], unc[keep]
        ids = np.array([lut[int(ids[j])] for j in keep], np.int64)
    if len(ids):
        state = mekf_mod.preload_map(fcfg, state, ids, pos, unc)
    return state, np.asarray(ids, np.int64)


def _count_update_rows(timer: StageTimer, fcfg: MekfConfig, mask) -> None:
    """Count the fused update's rows for the frames of ``mask`` ((..., C)
    accepted observations a frame, on the host): ``filter.update_rows``,
    the rows that carry an observation (min(observations, M / meas_dims)
    x meas_dims a frame), and ``filter.update_row_slots``, all M rows of
    each frame. The rows the innovation gate then zeroes on the device
    still count."""
    k = min(fcfg.max_obs, fcfg.capacity)
    obs = np.minimum((np.asarray(mask) != 0).sum(-1), k)
    timer.count("filter.update_rows", int(obs.sum()) * fcfg.meas_dims)
    timer.count("filter.update_row_slots", obs.size * k * fcfg.meas_dims)


def _count_wide_frames(timer: StageTimer, fcfg: MekfConfig,
                       device: torch.device, frames: int,
                       streams: int = 1) -> None:
    """Count ``filter.b3_wide_frames``: of ``frames`` frames filtered,
    those whose fused update (B3) ran its N x N products in the wide
    GEMM tiling, by the kernel's own rule (`cuda_mekf.gemm_tiling`) at
    N and the ``streams`` of one launch, on the host (no sync, no
    launch); none where B3 does not run (a CPU device, the XLA-form
    update)."""
    wide = device.type == "cuda" and mekf_mod.update_takes_kernel(fcfg)
    if wide:
        with torch.cuda.device(device):
            wide = cuda_mekf.gemm_tiling(fcfg.err_dim, fcfg.err_dim,
                                         streams) == "wide"
    timer.count("filter.b3_wide_frames", frames if wide else 0)


def _count_map_slots(timer: StageTimer, filled, mask) -> np.ndarray:
    """Count the map's slots for the frames of ``mask`` ((..., T, C)
    accepted observations, on the host): ``filter.map_slots_used``, the
    slots that hold a landmark by each frame (those in ``filled``
    (..., C), the slots filled before these frames, and those with an
    observation at or before the frame), and ``filter.map_slots``, all C
    of each frame. Returns the slots filled after the last frame."""
    used = np.logical_or.accumulate(np.asarray(mask) != 0, axis=-2) \
        | np.asarray(filled)[..., None, :]
    timer.count("filter.map_slots_used", int(used.sum()))
    timer.count("filter.map_slots", used.size)
    return used[..., -1, :] if used.shape[-2] else filled


def _saved_active(path) -> np.ndarray:
    """A run_slam checkpoint's ``MekfState.active`` as its file holds it
    (each state field is one leaf, in field order)."""
    with np.load(path) as z:
        return z[f"leaf_{MekfState._fields.index('active')}"] != 0


def _warn_dropped(dropped: np.ndarray, max_obs: int) -> None:
    """Warn when the max_obs compaction dropped observations (a count, or
    one per stream)."""
    if dropped.sum():
        print(f"WARNING: {dropped.tolist()} observations were dropped by "
              f"the max_obs={max_obs} update compaction (densest frames "
              "exceeded it); raise --max-obs")


def _resume(resume, state):
    """(state, frames done, trajectory rows so far) from a run_slam
    checkpoint, loaded onto ``state``'s devices and dtypes."""
    state, fdone, head = load_checkpoint(
        resume, (state, np.int64(0), np.zeros((1, 7), np.float32)))
    start = int(fdone)
    print(f"resumed from {resume} at frame {start}")
    return state, start, np.asarray(head)[:start]


def _feed_viewers(viewers, cam_pose, lm, active, t_cl, q_cl, mask,
                  slot_ids=None):
    """One frame's host snapshot through every sink: the active
    landmarks and the frame's (t_cl, q_cl, marker id) detections (the
    slot index is the id for corner- and pose-level inputs). Like the
    JAX driver, it labels every frame with the final id->slot table."""
    pts = np.asarray(lm)[:, :3][np.asarray(active)]
    ids = None if slot_ids is None else np.asarray(slot_ids)
    det = [(t_cl[j], q_cl[j], int(j) if ids is None else int(ids[j]))
           for j in np.where(np.asarray(mask))[0]]
    for v in viewers:
        v.view_frame(cam_pose, pts, det)


def _snapshot(pose, lm, active, timer: StageTimer):
    """pose (7,), lm (L, D) and active (L,) read back in ONE copy: (pose,
    landmark positions (L, 3), active) as host arrays."""
    with timer.stage("read"):
        flat = torch.cat([pose, lm[:, :3].reshape(-1),
                          active.to(pose.dtype)]).cpu().numpy()
    n = len(active)
    return flat[:7], flat[7:7 + 3 * n].reshape(n, 3), flat[7 + 3 * n:] > 0


def run_mekf(cfg: SlamAppConfig, times, t_cl, q_cl, mask, cam,
             device: torch.device, with_rotations: bool = False,
             load_map_file=None, ambiguity=None, slot_ids=None,
             reset=None, ckpt_every: int = 0, ckpt_path=None, resume=None,
             viewers=(), timer: StageTimer | None = None):
    """Filter the whole sequence; returns (cam_traj (T, 7), active (C,),
    landmark positions (C, 3), uncertainties (C, 3)). With
    ``ckpt_every`` N the scan runs in N-frame chunks and writes (state,
    frames done, trajectory so far) to ``ckpt_path`` after each chunk
    but the last; ``resume`` restarts from such a file.

    With ``viewers`` the filter steps once a frame (the scan's steps on
    the scan's inputs, so the trajectory is the same bit for bit), reads
    the frame's snapshot back in one copy, feeds the sinks, and
    checkpoints every ``ckpt_every`` frames; the live window's 'q' ends
    the run, and cam_traj then holds the frames done. ``timer`` takes
    the spans ``filter.upload``, ``filter.scan`` (each chunk's scan) and
    ``filter.readback``, or with viewers the loop's ``step`` and
    ``read``, and the update's rows, its wide-tiled frames and the map's
    slots of every frame filtered (`_count_update_rows`,
    `_count_wide_frames`, `_count_map_slots`; the slots filled
    before the first from the loaded map's ids or the checkpoint file's
    ``active``)."""
    timer = timer or StageTimer()
    max_obs = _auto_max_obs(cfg, mask, t_cl.shape[1])
    fcfg = _mekf_config(cfg, t_cl.shape[1], max_obs, with_rotations, cam)
    state = init_state(fcfg, device=device)
    filled = np.zeros(fcfg.capacity, bool)
    if load_map_file:
        state, slots = _preload(fcfg, state, load_map_file, slot_ids)
        filled[slots] = True
    f32 = torch.float32
    with timer.stage("filter.upload"):
        seq = FrameObservations(
            _dev(t_cl, device, f32), _dev(q_cl, device, f32),
            _dev(mask, device), _dev(ambiguity, device, f32),
            _dev(reset, device))
    tt = len(times)
    cam_traj = np.zeros((tt, 7), np.float32)
    start = 0
    if resume:
        state, start, head = _resume(resume, state)
        filled = _saved_active(resume)
        cam_traj[:start] = head
        for v in viewers:  # align frame providers with the skip
            getattr(v, "skip_to", lambda i: None)(start)
    if viewers:
        for i in range(start, tt):
            with timer.stage("step"):
                state = mekf_step(fcfg, state, FrameObservations(
                    *(None if a is None else a[i] for a in seq)))
            _count_update_rows(timer, fcfg, mask[i])
            _count_wide_frames(timer, fcfg, device, 1)
            filled = _count_map_slots(timer, filled, mask[i:i + 1])
            cam_traj[i], lm, active = _snapshot(
                torch.cat([state.cam_t, state.cam_q]), state.lm,
                state.active, timer)
            _feed_viewers(viewers, cam_traj[i], lm, active, t_cl[i],
                          q_cl[i], mask[i], slot_ids)
            if sinks.stop_requested(viewers):
                # the live window's 'q' ends the RUN, like the
                # reference's loop break (reference main/run_slam.py:127-141)
                cam_traj = cam_traj[:i + 1]
                break
            if ckpt_every and ckpt_path is not None \
                    and (i + 1) % ckpt_every == 0 and i + 1 < tt:
                save_checkpoint(ckpt_path, (state, np.int64(i + 1),
                                            cam_traj[:i + 1]))
    else:
        step = max(ckpt_every or tt - start, 1)
        for s in range(start, tt, step):
            e = min(s + step, tt)
            with timer.stage("filter.scan"):
                state, traj = mekf_scan(fcfg, state, FrameObservations(
                    *(None if a is None else a[s:e] for a in seq)))
            _count_update_rows(timer, fcfg, mask[s:e])
            _count_wide_frames(timer, fcfg, device, e - s)
            filled = _count_map_slots(timer, filled, mask[s:e])
            with timer.stage("filter.readback"):
                cam_traj[s:e] = traj.cpu().numpy()
            if ckpt_every and ckpt_path is not None and e < tt:
                save_checkpoint(ckpt_path,
                                (state, np.int64(e), cam_traj[:e]))
    with timer.stage("filter.readback"):
        dropped = state.dropped_obs.cpu().numpy()
        unc = mekf_mod.landmark_uncertainties(fcfg, state).cpu().numpy()
        active = state.active.cpu().numpy()
        lm = state.lm.cpu().numpy()[:, :3]
    _warn_dropped(dropped, fcfg.max_obs)
    return cam_traj, active, lm, unc[:, :3]


def epoch_remap(t_cl, q_cl, mask, reset, ids_seq):
    """Split recycled slots into per-epoch landmark columns (host numpy,
    the JAX run_slam's `epoch_remap`).

    The factor graph keys landmarks by column, and LRU recycling
    (``--slot-max-age``) makes one detector slot host several markers
    over a run; each (slot, epoch) pair, the epoch counting the slot's
    resets up to the frame, gets its own column. Returns (t_cl, q_cl,
    mask, col_ids) with one column per observed (slot, epoch) pair;
    ``col_ids`` maps column -> marker id from ``ids_seq``, the per-frame
    table snapshots."""
    t, c = mask.shape
    epoch = np.cumsum(np.asarray(reset, np.int64), axis=0)  # (T, C)
    key = epoch * c + np.arange(c)[None, :]
    used = np.unique(key[mask])
    col = np.searchsorted(used, key)                        # (T, C)
    l2 = len(used)
    rows = np.broadcast_to(np.arange(t)[:, None], (t, c))
    t_cl2 = np.zeros((t, l2) + t_cl.shape[2:], t_cl.dtype)
    q_cl2 = np.zeros((t, l2) + q_cl.shape[2:], q_cl.dtype)
    mask2 = np.zeros((t, l2), bool)
    t_cl2[rows[mask], col[mask]] = t_cl[mask]
    q_cl2[rows[mask], col[mask]] = q_cl[mask]
    mask2[rows[mask], col[mask]] = True
    col_ids = np.full(l2, -1, np.int64)
    col_ids[col[mask]] = ids_seq[mask]
    return t_cl2, q_cl2, mask2, col_ids


def resolve_recycling(obs: Observations) -> Observations:
    """The observations as the graph consumes them, ``reset`` and
    ``ids_seq`` None: recycled slots epoch-split into fresh landmark
    columns, ``slot_ids`` mapping each to its marker id and no
    ambiguity (the per-slot layout no longer matches); nothing else
    changes when none recycled."""
    if obs.reset is not None and np.asarray(obs.reset).any():
        t_cl, q_cl, mask, slot_ids = epoch_remap(*map(np.asarray, (
            obs.t_cl, obs.q_cl, obs.mask, obs.reset, obs.ids_seq)))
        print(f"slot recycling: split {obs.t_cl.shape[1]} detector slots "
              f"into {t_cl.shape[1]} per-epoch landmark columns")
        obs = obs._replace(t_cl=t_cl, q_cl=q_cl, mask=mask, ambiguity=None,
                           slot_ids=slot_ids)
    return obs._replace(reset=None, ids_seq=None)


def graph_config(cfg: SlamAppConfig, max_poses: int, max_landmarks: int,
                 max_factors: int, cam, with_rotations: bool,
                 dtype: torch.dtype = torch.float32) -> GraphConfig:
    """Driver flags -> GraphConfig (run_slam's online graph and
    run_offline's batch solve)."""
    return GraphConfig(max_poses=max_poses, max_landmarks=max_landmarks,
                       max_factors=max_factors,
                       meas_sigma_t=cfg.meas_sigma_t,
                       odom_sigma_t=cfg.odom_sigma_t,
                       odom_sigma_rot=cfg.odom_sigma_rot,
                       pixel_sigma=cfg.pixel_sigma, focal_px=float(cam.fx),
                       marker_size=cfg.marker_size,
                       huber_delta=cfg.huber_delta,
                       with_rotations=with_rotations, dtype=dtype)


def run_factorgraph(cfg: SlamAppConfig, times, t_cl, q_cl, mask, cam,
                    device: torch.device, with_rotations: bool = False,
                    dtype: torch.dtype = torch.float32, ckpt_every: int = 0,
                    ckpt_path=None, resume=None, viewers=(), slot_ids=None,
                    timer: StageTimer | None = None):
    """The online factor graph over the whole sequence: per frame
    `add_frame` and a ``cfg.window``-pose `optimize_window`; with a pose
    budget shorter than the run, the oldest half of the poses is
    marginalized whenever the graph is full. The pose count is tracked
    on the host (the graph's is deterministic), so the frame loop reads
    nothing back: the trajectory is read once at the end, then the
    landmark covariances. With ``ckpt_every`` N, (state, frames done,
    trajectory so far) goes to ``ckpt_path`` every N frames but after
    the last; ``resume`` restarts from such a file (the pose count from
    its ``num_poses``). With ``viewers``, each frame's pose, landmarks
    and active flags are read back in one copy and fed to the sinks
    (``timer`` takes the ``read`` seconds); the live window's 'q' ends
    the run. Returns (cam_traj (T, 7), active (L,), landmark positions
    (L, 3), uncertainties (L, D))."""
    t = len(times)
    budget = cfg.pose_budget
    if budget and budget < t + 2:
        max_poses = max(budget, 2 * cfg.window + 4)
        if max_poses > budget:
            print(f"pose budget raised {budget} -> {max_poses}: the "
                  f"{cfg.window}-pose window needs headroom to "
                  "marginalize safely")
        max_factors = int(mask.sum(1).max()) * max_poses + 8
    else:
        max_poses, max_factors = t + 2, int(mask.sum()) + 8
    gcfg = graph_config(cfg, max_poses, t_cl.shape[1], max_factors, cam,
                        with_rotations, dtype)
    state = init_graph(gcfg, device=device)
    t_cl_d, mask_d = _dev(t_cl, device), _dev(mask, device)
    q_cl_d = _dev(q_cl, device) if with_rotations else None
    num, drop = 1, max_poses // 2
    start, head = 0, np.zeros((0, 7), np.float32)
    if resume:
        state, start, head = _resume(resume, state)
        check_indices(gcfg, state)
        num = int(state.num_poses)
        for v in viewers:  # align frame providers with the skip
            getattr(v, "skip_to", lambda i: None)(start)
    timer = timer or StageTimer()
    poses = []

    def materialize():
        tail = torch.stack(poses).cpu().numpy() if poses \
            else np.zeros((0, 7))
        return np.concatenate([head, tail.astype(np.float32)])

    t0 = time.perf_counter()
    for i in range(start, t):
        state = add_frame(gcfg, state, t_cl_d[i], mask_d[i],
                          None if q_cl_d is None else q_cl_d[i])
        num = min(num + 1, max_poses)
        state, _ = optimize_window(gcfg, state, window=cfg.window,
                                   iters=cfg.window_iters)
        cur = num - 2
        poses.append(torch.cat([state.pose_t[cur], state.pose_q[cur]]))
        if budget and num >= max_poses - 1:
            state = marginalize_poses(gcfg, state, drop)
            num = max(num - drop, 1)
        if viewers:
            pose, lm, active = _snapshot(poses[-1], state.lm,
                                         state.lm_active, timer)
            _feed_viewers(viewers, pose, lm, active, t_cl[i], q_cl[i],
                          mask[i], slot_ids)
            if sinks.stop_requested(viewers):
                break  # the live window's 'q' ends the run
        if ckpt_every and ckpt_path and (i + 1) % ckpt_every == 0 \
                and i + 1 < t:
            save_checkpoint(ckpt_path, (state, np.int64(i + 1),
                                        materialize()))
    cam_traj = materialize()
    dt = time.perf_counter() - t0
    done = t - start
    print(f"factorgraph online: {done} frames in {dt:.3f}s "
          f"({done / dt:.1f} fps)")
    unc = torch.diagonal(landmark_covariances(gcfg, state), dim1=-2, dim2=-1)
    return (cam_traj, state.lm_active.cpu().numpy(), state.lm.cpu().numpy(),
            unc.cpu().numpy())


def _stream_path(path: str, i: int) -> str:
    """Per-stream output path: outputs/trajectory.txt -> _s0/_s1/..."""
    pp = Path(path)
    return str(pp.with_name(f"{pp.stem}_s{i}{pp.suffix}"))


def _load_stream_frames(path: str, cfg: SlamAppConfig):
    """One stream's (times, frames (T, H, W) uint8, (K, dist) or None,
    npz source or None)."""
    if is_video(path):
        pairs = list(video_frames(path))
        if not pairs:
            raise ValueError(f"{path}: no decodable frames")
        return (np.asarray([t for t, _ in pairs]),
                np.stack([f for _, f in pairs]), None, None)
    src = NpzSource(path)
    if not src.has("images"):
        raise ValueError(f"{path}: multi-stream serving needs image "
                         "input (npz 'images' or video)")
    calib = None
    if src.has("camera_matrix"):
        calib = (src["camera_matrix"], src["dist_coeffs"]
                 if src.has("dist_coeffs") else cfg.dist_coeffs)
    return src.times, src["images"], calib, src


def run_multi_stream(cfg: SlamAppConfig, inputs: list[str], calib_dir,
                     device: torch.device, chunk: int = CHUNK,
                     timer: StageTimer | None = None) -> list[RunResult]:
    """Online multi-camera serving, as the JAX run_multi_stream: S
    streams (truncated to the shortest) through the front end's chunk
    step together (`front_end.ChunkStep(streams=S)`: a chunk's S·T
    frames one sweep batch and S tables scanned together, or tracked
    frame by frame), the observations kept on the device, and the S
    filters stepped together (`parallel.multi_slam.batched_mekf_scan`,
    one fused-update launch per frame). As in JAX, with a stream mesh
    (`multi_slam.stream_mesh`: every card of the process) of ndev > 1
    entries that divide S, the filter scan alone is sharded over them and
    its states come back to ``device``; the front end stays on
    ``device``. Outputs land in per-stream files
    (trajectory_s0.txt, map_s0.txt, ...); with a shared ``--max-obs``
    each stream matches its single-stream run (with tracking: a stream
    of cohort 0, or any stream without cohorts, whose single-stream run
    never swept off the schedule). ``timer`` takes the single-stream
    path's spans under the same names."""
    timer = timer or StageTimer()
    seconds = {}
    t0 = time.perf_counter()
    with timer.stage("input.load"):
        loaded = [_load_stream_frames(p, cfg) for p in inputs]
        s = len(loaded)
        tlen = min(len(t) for t, _, _, _ in loaded)
        if any(len(t) != tlen for t, _, _, _ in loaded):
            print(f"streams have unequal lengths; truncating all to "
                  f"{tlen} frames")
        times = loaded[0][0][:tlen]
        calib = next((c for _, _, c, _ in loaded if c is not None), None)
        cam = load_camera(cfg, calib_dir, device) if calib is None \
            else camera(*calib, device)
        for _, _, _, src in loaded:  # npz marker size, as one stream's path
            if src is not None and src.has("marker_size"):
                cfg.marker_size = float(src["marker_size"])
                break
        frames = np.stack([f[:tlen] for _, f, _, _ in loaded])  # (S,T,H,W)
    seconds["load"] = time.perf_counter() - t0

    mesh = multi_slam.stream_mesh(device)
    ndev = len(mesh)
    if not (ndev > 1 and s % ndev == 0):
        mesh = None
    # peak memory: the sum over every card the run touches
    cards = list(dict.fromkeys(d for d in [device, *(mesh or ())]
                               if d.type == "cuda"))
    for card in cards:
        torch.cuda.reset_peak_memory_stats(card)
    step = ChunkStep(cam, cfg, device, timer, chunk, streams=s)
    carry, outs = step.init(), []
    for c0 in range(0, tlen, chunk):
        carry, out = step(carry, frames[:, c0:c0 + chunk])
        outs.append(out)
    t_cl, q_cl, mask, amb = (torch.cat(x, 1) for x in list(zip(*outs))[:4])
    with timer.stage("front_end.readback"):
        mask_np = mask.cpu().numpy()
    sync(device)
    seconds["front_end"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    max_obs = _auto_max_obs(cfg, mask_np, cfg.capacity)
    fcfg = _mekf_config(cfg, cfg.capacity, max_obs,
                        cfg.filter == "mekf_rotations", cam)
    states = multi_slam.stack_states([init_state(fcfg, device=device)] * s)
    if mesh is not None:
        print(f"sharding {s} streams over {ndev} devices")
    with timer.stage("filter.scan"):
        states, trajs = multi_slam.batched_mekf_scan(
            fcfg, states, FrameObservations(t_cl, q_cl, mask, amb),
            mesh=mesh)
    _count_update_rows(timer, fcfg, mask_np)
    _count_wide_frames(timer, fcfg, device, s * tlen,
                       s if mesh is None else s // ndev)
    _count_map_slots(timer, np.zeros((s, fcfg.capacity), bool), mask_np)
    with timer.stage("filter.readback"):
        states = MekfState(*(x.to(device) for x in states))
        trajs = trajs.cpu().numpy()
    sync(device)
    seconds["filter"] = time.perf_counter() - t0
    peak = ""
    if cards:
        seconds["peak_bytes"] = sum(torch.cuda.max_memory_allocated(card)
                                    for card in cards)
        peak = f", peak device memory {seconds['peak_bytes'] / 2**30:.2f} GiB"
    print(f"fleet: {s} streams x {tlen} frames, front end "
          f"{seconds['front_end']:.3f}s (input load {seconds['load']:.3f}s),"
          f" filter {seconds['filter']:.3f}s ({device}){peak}")

    with timer.stage("filter.readback"):
        dropped = states.dropped_obs.cpu().numpy()
        unc = mekf_mod.landmark_uncertainties(fcfg, states).cpu().numpy()
        active = states.active.cpu().numpy()
        lm = states.lm.cpu().numpy()[..., :3]
        tables = carry.table.cpu().numpy()
    _warn_dropped(dropped, fcfg.max_obs)
    counters = {}  # the request's, as ``seconds``: filled by `main`
    with timer.stage("output.write"):
        results = []
        for i in range(s):
            tf = _stream_path(cfg.trajectory_file, i)
            mf = _stream_path(cfg.map_file, i)
            ids, err = write_outputs(f"stream {i}:", tf, mf, times, trajs[i],
                                      active[i], tables[i], lm[i],
                                      unc[i][:, :3], loaded[i][3])
            results.append(RunResult(tf, mf, trajs[i], mask_np[i], ids, err,
                                     seconds, counters))
        return results


def write_outputs(head: str, traj_file: str, map_file: str, times,
                   cam_traj, active, slot_ids, lm, unc, src):
    """One stream's TUM trajectory, map file (its active slots by marker
    id: ``slot_ids``, None when the slot is the id) and ATE against the
    npz ``src``'s ``gt_cam_t``, in one printed line: (ids, ATE or None).
    """
    with TrajectoryWriter(traj_file) as w:
        for ts, pose in zip(times, cam_traj):
            w.write(float(ts), pose)
    slots = np.where(active)[0]
    ids = slots if slot_ids is None else slot_ids[slots]
    save_map(map_file, ids, lm[slots], unc[slots])
    line = f"{head} {traj_file} ({len(times)} poses), {map_file} " \
           f"({len(ids)} landmarks)"
    err = None
    if src is not None and src.has("gt_cam_t"):
        err = float(ate.ate_rmse(cam_traj[:, :3],
                                 src["gt_cam_t"][:len(times)]))
        line += f", ATE {err:.4f} m"
    print(line)
    return ids, err


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="marker SLAM on PyTorch/CUDA")
    dflt = SlamAppConfig(input="")
    p.add_argument("--input", required=True,
                   help=".npz sequence or video; several, comma-"
                        "separated, for multi-stream serving")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    p.add_argument("--filter", default="mekf",
                   choices=["mekf", "mekf_rotations", "factorgraph"])
    p.add_argument("--trajectory", default="outputs/trajectory.txt")
    p.add_argument("--map", dest="map_file", default="outputs/map.txt")
    p.add_argument("--calib", default=None,
                   help="directory with camera_matrix.npy + "
                        "dist_coeffs.npy (video input)")
    p.add_argument("--load-map", default=None,
                   help="seed the filter with a saved map")
    p.add_argument("--detector", default=dflt.detector,
                   choices=["robust", "fast"])
    p.add_argument("--capacity", type=int, default=dflt.capacity)
    p.add_argument("--dict", dest="dict_name", default=dflt.dict_name)
    p.add_argument("--slot-max-age", type=int, default=dflt.slot_max_age,
                   metavar="N",
                   help="recycle id->slot table slots whose marker went "
                        "unobserved for N frames once the table is full "
                        "(0 = permanent slots)")
    p.add_argument("--mekf-r", type=float, default=dflt.mekf_r)
    p.add_argument("--mekf-q-cam", type=float, default=dflt.mekf_q_cam)
    p.add_argument("--mekf-q-rot", type=float, default=dflt.mekf_q_rot)
    p.add_argument("--mekf-q-lm", type=float, default=dflt.mekf_q_lm)
    p.add_argument("--mekf-motion-model", default=dflt.mekf_motion_model,
                   choices=["none", "cv"])
    p.add_argument("--pixel-sigma", type=float, default=dflt.pixel_sigma)
    p.add_argument("--mekf-q-vel", type=float, default=dflt.mekf_q_vel)
    p.add_argument("--vel-decay", type=float, default=dflt.mekf_vel_decay)
    p.add_argument("--precision", default=dflt.mekf_precision,
                   choices=["highest", "high", "mixed", "default"],
                   help="matmul precision of the filter's non-kernel "
                        "products on a card (mixed = bf16 covariance "
                        "products, f32 gain chain); f32 on the CPU")
    p.add_argument("--gate-distance", type=float,
                   default=dflt.gate_distance)
    p.add_argument("--max-obs", type=int, default=dflt.max_obs)
    p.add_argument("--track-every", type=int, default=dflt.track_every,
                   metavar="K",
                   help="streaming detection: full sweep on 2 of every K "
                        "frames, decode-validated tracking in between "
                        "(K >= 3; 0 = full detection every frame)")
    p.add_argument("--rescue-cohorts", type=int, default=dflt.rescue_cohorts,
                   metavar="G",
                   help="multi-stream serving with --track-every: split "
                        "the fleet into G schedule cohorts (staggered K/G "
                        "frames apart); a stream that loses every marker "
                        "sweeps its own cohort at the next frame. G must "
                        "divide the stream count; 0 = one schedule")
    # the factor graph's tuning (--filter factorgraph; accepted and
    # unused by the MEKF paths, as in the JAX run_slam)
    p.add_argument("--window", type=int, default=dflt.window)
    p.add_argument("--pose-budget", type=int, default=dflt.pose_budget)
    p.add_argument("--meas-sigma-t", type=float, default=dflt.meas_sigma_t)
    p.add_argument("--odom-sigma-t", type=float, default=dflt.odom_sigma_t)
    p.add_argument("--odom-sigma-rot", type=float,
                   default=dflt.odom_sigma_rot)
    p.add_argument("--huber-delta", type=float, default=dflt.huber_delta)
    p.add_argument("--ba-rotations", action="store_true")
    # the viewers (apps/sinks.py): PNGs under --viz-dir, MP4s with
    # --export-video
    p.add_argument("--viz-2d", action="store_true",
                   help="2D overlay: detected-marker axes, outline and id, "
                        "and the map points, on the real frames")
    p.add_argument("--viz-3d", action="store_true",
                   help="3D map: trajectory, landmarks, detections, camera")
    p.add_argument("--display", action="store_true",
                   help="live 2D and 3D windows, 'q' quits (needs a display "
                        "server and cv2; headless export without one)")
    p.add_argument("--viz-dir", default=dflt.viz_dir)
    p.add_argument("--viz-3d-renderer", default=dflt.viz_3d_renderer,
                   choices=["mpl", "fast"],
                   help="mpl = matplotlib figures; fast = the numpy "
                        "raster (needs no library)")
    p.add_argument("--export-video", action="store_true",
                   help="also write {viz_dir}/2d.mp4 / 3d.mp4 (cv2, or "
                        "imageio with pyav)")
    p.add_argument("--checkpoint-every", type=int, default=0,
                   help="save a resumable checkpoint every N frames "
                        "(0 = off)")
    p.add_argument("--checkpoint", default="outputs/checkpoint.npz",
                   help="checkpoint file path")
    p.add_argument("--resume", default=None,
                   help="resume a killed run from a checkpoint; "
                        "observations are re-ingested from the input")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
    return p


def _run_single(cfg: SlamAppConfig, args, device: torch.device,
                timer: StageTimer):
    """One input through the front end, the viewers' construction and
    the backend, with their spans on ``timer``: (stage seconds, the npz
    source or None, the viewers, (times, mask, slot_ids, cam_traj,
    active, landmarks, uncertainties)). The caller closes the
    viewers."""
    seconds = {}
    t0 = time.perf_counter()
    if is_video(cfg.input):
        src = None
        obs = load_video_observations(cfg, args.calib, device, timer=timer)
    else:
        with timer.stage("input.load"):
            src = NpzSource(cfg.input)
        seconds["load"] = time.perf_counter() - t0
        obs = load_observations(src, cfg, device, timer=timer,
                                display=args.display)
    sync(device)
    seconds["front_end"] = time.perf_counter() - t0

    viewers = sinks.build_viewers(cfg, obs.cam, src, display=args.display,
                                  timer=timer)
    t0 = time.perf_counter()
    kw = dict(ckpt_every=args.checkpoint_every, ckpt_path=args.checkpoint,
              resume=args.resume, viewers=viewers, timer=timer)
    if cfg.filter == "factorgraph":
        # the graph keys landmarks by column and has no reset: recycled
        # slots become fresh columns (the MEKF consumes `reset` itself)
        times, t_cl, q_cl, mask, cam, _, slot_ids, _, _ = \
            resolve_recycling(obs)
        out = run_factorgraph(cfg, times, t_cl, q_cl, mask, cam, device,
                              with_rotations=args.ba_rotations,
                              slot_ids=slot_ids, **kw)
    else:
        times, t_cl, q_cl, mask, cam, amb, slot_ids, reset, _ids = obs
        out = run_mekf(
            cfg, times, t_cl, q_cl, mask, cam, device,
            with_rotations=cfg.filter == "mekf_rotations",
            load_map_file=args.load_map, ambiguity=amb, slot_ids=slot_ids,
            reset=reset, **kw)
    sync(device)
    seconds["filter"] = time.perf_counter() - t0
    return seconds, src, viewers, (times, mask, slot_ids, *out)


def main(argv=None) -> RunResult | list[RunResult]:
    """One request: the whole call is the span ``run_slam.request``, and
    each result's ``seconds`` also holds every span's seconds summed by
    name (`utils.profiling.StageTimer`; the viewer loop's stages among
    them), its ``counters`` the request's counters (a fleet's summed
    over its streams)."""
    timer = StageTimer(request_id=uuid.uuid4().hex)
    with timer.stage("run_slam.request"):
        out = _serve(argv, timer)
    for res in out if isinstance(out, list) else [out]:
        res.seconds.update(timer.totals)
        res.counters.update(timer.counters)
    return out


def _serve(argv, timer: StageTimer) -> RunResult | list[RunResult]:
    parser = _parser()
    args = parser.parse_args(argv)
    if args.track_every and args.track_every < 3:
        parser.error("--track-every needs K >= 3 (2 full frames bootstrap "
                     "the velocity prior)")
    inputs = [s for s in args.input.split(",") if s]
    fleet = "," in args.input
    if fleet:  # the JAX run_slam's refusals, word for word in effect
        if args.slot_max_age:
            parser.error("--slot-max-age is not supported by multi-stream "
                         "serving yet (the fleet detector threads per-"
                         "stream id->slot tables without the LRU carry); "
                         "run corridor-scale streams individually")
        if args.filter == "factorgraph":
            parser.error("multi-stream serving runs the MEKF backends; for "
                         "batch factor-graph fleets use run_offline --fleet")
        if args.track_every and args.rescue_cohorts \
                and len(inputs) % args.rescue_cohorts:
            raise ValueError(f"rescue_cohorts={args.rescue_cohorts} must "
                             f"divide streams={len(inputs)}")
    device = resolve_device(args.platform)

    cfg = SlamAppConfig(
        input=args.input, filter=args.filter,
        trajectory_file=args.trajectory, map_file=args.map_file,
        viz_2d=args.viz_2d, viz_3d=args.viz_3d, viz_dir=args.viz_dir,
        viz_3d_renderer=args.viz_3d_renderer,
        export_video=args.export_video, window=args.window,
        pose_budget=args.pose_budget, meas_sigma_t=args.meas_sigma_t,
        odom_sigma_t=args.odom_sigma_t, odom_sigma_rot=args.odom_sigma_rot,
        mekf_r=args.mekf_r, mekf_q_cam=args.mekf_q_cam,
        mekf_q_rot=args.mekf_q_rot, mekf_q_lm=args.mekf_q_lm,
        mekf_motion_model=args.mekf_motion_model,
        pixel_sigma=args.pixel_sigma, mekf_q_vel=args.mekf_q_vel,
        mekf_vel_decay=args.vel_decay, mekf_precision=args.precision,
        gate_distance=args.gate_distance, huber_delta=args.huber_delta,
        max_obs=args.max_obs, dict_name=args.dict_name,
        track_every=args.track_every, detector=args.detector,
        capacity=args.capacity, slot_max_age=args.slot_max_age,
        rescue_cohorts=args.rescue_cohorts)
    if fleet:
        if args.viz_2d or args.viz_3d or args.display:
            print("note: viz/display are per-stream features; the "
                  "fleet path writes trajectories/maps only")
        with device_trace(args.profile), request_stream(device):
            results = run_multi_stream(cfg, inputs, args.calib, device,
                                       timer=timer)
        _wrote_trace(args.profile)
        return results
    sinks.check_libraries(cfg, args.display)  # before any input is read

    with device_trace(args.profile), request_stream(device):
        seconds, src, viewers, (times, mask, slot_ids, cam_traj, active,
                                lm, unc) = _run_single(cfg, args, device,
                                                       timer)
        for v in viewers:
            v.close()
        if len(cam_traj) < len(times):  # the live window's 'q' ended it
            print(f"quit requested at frame {len(cam_traj)}/{len(times)}")
            times, mask = times[:len(cam_traj)], mask[:len(cam_traj)]
        tt = len(times)
        stage = "graph" if cfg.filter == "factorgraph" else "filter"
        print(f"front end: {tt} frames in {seconds['front_end']:.3f}s; "
              f"{stage}: {seconds['filter']:.3f}s ({device})")

        with timer.stage("output.write"):
            ids, err = write_outputs(
                "wrote", cfg.trajectory_file, cfg.map_file, times,
                cam_traj, active, slot_ids, lm, unc, src)
    _wrote_trace(args.profile)
    return RunResult(cfg.trajectory_file, cfg.map_file, cam_traj,
                     np.asarray(mask), np.asarray(ids), err, seconds, {})


def _wrote_trace(profile) -> None:
    if profile:
        print(f"wrote {Path(profile) / 'trace.json'}")


if __name__ == "__main__":
    main()
