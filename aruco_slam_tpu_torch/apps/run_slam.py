"""Online SLAM command line on PyTorch/CUDA.

Counterpart of aruco_slam_tpu/apps/run_slam.py for its default path:

    python -m aruco_slam_tpu_torch.apps.run_slam --input seq.npz \
        [--platform cuda|cpu]

frames -> `ops.detect.detect_markers_batch_lru` (robust sweep, chunks
of 32) -> `ops.pnp.solve_square_pnp` -> `filters.mekf.mekf_scan` ->
TUM trajectory + map files in the JAX run_slam's formats.
npz input may carry `images`, `corners` or pose-level `t_cl` bundles;
video input is decoded by the JAX package's JAX-free `VideoSource`.

``--platform cuda`` is the default and raises when no card is
present; the run never moves to the CPU in its place. Flags of the JAX
run_slam that select paths not ported yet (the factor graph, streaming
tracking, multi-stream serving, viewers, checkpoints, map preloading,
slot recycling) are accepted and refused with a "not ported yet" error.
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.bench import ate
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.filters import mekf as mekf_mod
from aruco_slam_tpu_torch.filters import (
    FrameObservations, MekfConfig, init_state, mekf_scan)
from aruco_slam_tpu_torch.io import (
    NpzSource, TrajectoryWriter, is_video, save_map, video_frames)
from aruco_slam_tpu_torch.ops import detect, pnp


class RunResult(NamedTuple):
    """What `main` wrote and measured."""

    trajectory_file: str
    map_file: str
    cam_traj: np.ndarray      # (T, 7) [xyz, quat wxyz]
    obs_mask: np.ndarray      # (T, C) accepted observations per frame
    landmark_ids: np.ndarray  # marker ids in the map file
    ate: float | None         # vs the input's gt_cam_t, when present
    seconds: dict             # wall time per stage


def _not_ported(what: str):
    raise NotImplementedError(f"{what}: not ported yet to the PyTorch/"
                              "CUDA package (aruco_slam_tpu.apps.run_slam "
                              "has it)")


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def _camera(k, d, device) -> cam_mod.CameraModel:
    return cam_mod.CameraModel.from_matrix(
        np.asarray(k, np.float32), np.asarray(d, np.float32),
        device=device)


def _observations_from_frames(frame_iter, cam, cfg: SlamAppConfig,
                              device: torch.device, chunk: int = 32):
    """Image front end over a (timestamp, gray) iterator: batched
    detection + PnP in fixed-size chunks (the tail chunk zero-padded),
    slots claimed first-seen through the id->slot table. Returns the
    loader tuple (times, t_cl, q_cl, mask, cam, ambiguity, slot_ids,
    reset, ids_seq) as numpy arrays."""
    if cfg.track_every:
        _not_ported("--track-every (streaming tracker)")
    if cfg.slot_max_age:
        _not_ported("--slot-max-age (LRU slot recycling)")
    dcfg = detect.with_preset(
        detect.DetectorConfig(capacity=cfg.capacity,
                              dict_name=cfg.dict_name,
                              slot_max_age=cfg.slot_max_age),
        cfg.detector)
    times, buf, outs = [], [], []
    table = detect.slot_table_init(dcfg.capacity, device)
    seen = torch.zeros(dcfg.capacity, dtype=torch.int32, device=device)
    fidx = 0

    def flush():
        nonlocal table, seen, fidx
        n = len(buf)
        if not n:
            return
        if n < chunk:
            buf.extend([np.zeros_like(buf[0])] * (chunk - n))
        ims = torch.from_numpy(np.stack(buf)).to(device)
        det_c, det_m, _reset, _ids, table, seen, dropped = \
            detect.detect_markers_batch_lru(ims, dcfg, table, seen, fidx)
        fidx += n
        res = pnp.solve_square_pnp(cam, det_c, cfg.marker_size)
        mask = det_m & (res.err < cfg.max_reproj_px)
        amb = res.err / torch.clamp(res.err2, min=1e-9)
        outs.append((res.t_cl, res.q_cl, mask, amb, dropped, n))
        buf.clear()

    for ts, gray in frame_iter:
        times.append(ts)
        buf.append(gray)
        if len(buf) == chunk:
            flush()
    flush()
    if not times:
        raise ValueError("no decodable frames")
    cat = lambda i: np.concatenate(
        [o[i][:o[-1]].cpu().numpy() for o in outs])
    dropped_ids = int(sum(int(o[4][:o[-1]].sum()) for o in outs))
    if dropped_ids:
        print(f"WARNING: {dropped_ids} marker sightings found NO free "
              f"slot (id->slot table saturated at capacity "
              f"{dcfg.capacity}); raise --capacity")
    return (np.asarray(times), cat(0), cat(1), cat(2), cam, cat(3),
            table.cpu().numpy(), None, None)


def load_observations(src: NpzSource, cfg: SlamAppConfig,
                      device: torch.device):
    """Return (times, t_cl (T,C,3), q_cl (T,C,4), mask (T,C), cam,
    ambiguity, slot_ids, reset, ids_seq); ``slot_ids`` maps slot ->
    marker id for image input (None when the slot index is the id)."""
    k = src["camera_matrix"] if src.has("camera_matrix") \
        else cfg.camera_matrix
    d = src["dist_coeffs"] if src.has("dist_coeffs") else cfg.dist_coeffs
    cam = _camera(k, d, device)
    if src.has("marker_size"):
        cfg.marker_size = float(src["marker_size"])
    if src.has("images"):
        return _observations_from_frames(
            zip(src.times, src["images"]), cam, cfg, device)
    if src.has("corners"):
        res = pnp.solve_square_pnp(
            cam, torch.as_tensor(src["corners"], dtype=torch.float32,
                                 device=device), cfg.marker_size)
        mask = torch.as_tensor(src["corner_mask"], device=device) \
            & (res.err < cfg.max_reproj_px)
        amb = res.err / torch.clamp(res.err2, min=1e-9)
        return (src.times, res.t_cl.cpu().numpy(), res.q_cl.cpu().numpy(),
                mask.cpu().numpy(), cam, amb.cpu().numpy(), None, None,
                None)
    if src.has("t_cl"):
        return (src.times, src["t_cl"], src["q_cl"], src["mask"], cam,
                None, None, None, None)
    raise ValueError(
        f"{src.path}: no 'images', 'corners', or 't_cl' observations")


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
                 cam) -> MekfConfig:
    return MekfConfig(capacity=capacity, max_obs=max_obs,
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


def run_mekf(cfg: SlamAppConfig, times, t_cl, q_cl, mask, cam,
             device: torch.device, ambiguity=None, reset=None):
    """Filter the whole sequence; returns (cam_traj (T, 7), active (C,),
    landmark positions (C, 3), uncertainties (C, 3))."""
    max_obs = _auto_max_obs(cfg, mask, t_cl.shape[1])
    fcfg = _mekf_config(cfg, t_cl.shape[1], max_obs, cam)
    state = init_state(fcfg, device=device)

    def dev(a, dtype=None):
        return None if a is None else torch.as_tensor(
            np.asarray(a), dtype=dtype, device=device)

    seq = FrameObservations(dev(t_cl, torch.float32),
                            dev(q_cl, torch.float32), dev(mask),
                            dev(ambiguity, torch.float32), dev(reset))
    state, traj = mekf_scan(fcfg, state, seq)
    if int(state.dropped_obs):
        print(f"WARNING: {int(state.dropped_obs)} observations were "
              f"dropped by the max_obs={fcfg.max_obs} update "
              "compaction (densest frames exceeded it); raise --max-obs")
    unc = mekf_mod.landmark_uncertainties(fcfg, state).cpu().numpy()
    return (traj.cpu().numpy(), state.active.cpu().numpy(),
            state.lm.cpu().numpy()[:, :3], unc[:, :3])


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="marker SLAM on PyTorch/CUDA")
    dflt = SlamAppConfig(input="")
    p.add_argument("--input", required=True, help=".npz sequence or video")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    p.add_argument("--filter", default="mekf",
                   choices=["mekf", "mekf_rotations", "factorgraph"])
    p.add_argument("--trajectory", default="outputs/trajectory.txt")
    p.add_argument("--map", dest="map_file", default="outputs/map.txt")
    p.add_argument("--calib", default=None,
                   help="directory with camera_matrix.npy + "
                        "dist_coeffs.npy (video input)")
    p.add_argument("--detector", default=dflt.detector,
                   choices=["robust", "fast"])
    p.add_argument("--capacity", type=int, default=dflt.capacity)
    p.add_argument("--dict", dest="dict_name", default=dflt.dict_name)
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
                   choices=["highest", "high", "mixed", "default"])
    p.add_argument("--gate-distance", type=float,
                   default=dflt.gate_distance)
    p.add_argument("--max-obs", type=int, default=dflt.max_obs)
    # the JAX run_slam's other paths: accepted, refused below
    p.add_argument("--track-every", type=int, default=0)
    p.add_argument("--slot-max-age", type=int, default=0)
    p.add_argument("--viz-2d", action="store_true")
    p.add_argument("--viz-3d", action="store_true")
    p.add_argument("--display", action="store_true")
    p.add_argument("--checkpoint-every", type=int, default=0)
    p.add_argument("--resume", default=None)
    p.add_argument("--load-map", default=None)
    return p


def main(argv=None) -> RunResult:
    args = _parser().parse_args(argv)
    if args.filter != "mekf":
        _not_ported(f"--filter {args.filter}")
    if "," in args.input:
        _not_ported("multi-stream serving (--input a,b,...)")
    for flag, on in (("--viz-2d", args.viz_2d), ("--viz-3d", args.viz_3d),
                     ("--display", args.display),
                     ("--checkpoint-every", args.checkpoint_every),
                     ("--resume", args.resume),
                     ("--load-map", args.load_map)):
        if on:
            _not_ported(flag)
    device = resolve_device(args.platform)

    cfg = SlamAppConfig(
        input=args.input, filter=args.filter,
        trajectory_file=args.trajectory, map_file=args.map_file,
        mekf_r=args.mekf_r, mekf_q_cam=args.mekf_q_cam,
        mekf_q_rot=args.mekf_q_rot, mekf_q_lm=args.mekf_q_lm,
        mekf_motion_model=args.mekf_motion_model,
        pixel_sigma=args.pixel_sigma, mekf_q_vel=args.mekf_q_vel,
        mekf_vel_decay=args.vel_decay, mekf_precision=args.precision,
        gate_distance=args.gate_distance, max_obs=args.max_obs,
        dict_name=args.dict_name, track_every=args.track_every,
        detector=args.detector, capacity=args.capacity,
        slot_max_age=args.slot_max_age)

    seconds = {}
    t0 = time.perf_counter()
    if is_video(cfg.input):
        src = None
        k, d = cfg.camera_matrix, cfg.dist_coeffs
        if args.calib:
            k = np.load(Path(args.calib) / "camera_matrix.npy")
            d = np.load(Path(args.calib) / "dist_coeffs.npy")
        obs = _observations_from_frames(
            video_frames(cfg.input), _camera(k, d, device), cfg,
            device)
    else:
        src = NpzSource(cfg.input)
        obs = load_observations(src, cfg, device)
    times, t_cl, q_cl, mask, cam, amb, slot_ids, reset, _ids = obs
    _sync(device)
    seconds["front_end"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    cam_traj, active, lm, unc = run_mekf(cfg, times, t_cl, q_cl, mask,
                                         cam, device, ambiguity=amb,
                                         reset=reset)
    _sync(device)
    seconds["filter"] = time.perf_counter() - t0
    tt = len(times)
    print(f"front end: {tt} frames in {seconds['front_end']:.3f}s; "
          f"filter: {seconds['filter']:.3f}s ({device})")

    with TrajectoryWriter(cfg.trajectory_file) as w:
        for ts, pose in zip(times, cam_traj):
            w.write(float(ts), pose)
    slots = np.where(active)[0]
    ids = slot_ids[slots] if slot_ids is not None else slots
    save_map(cfg.map_file, ids, lm[slots], unc[slots])
    print(f"wrote {cfg.trajectory_file} ({tt} poses), "
          f"{cfg.map_file} ({len(ids)} landmarks)")
    err = None
    if src is not None and src.has("gt_cam_t"):
        err = float(ate.ate_rmse(cam_traj[:, :3], src["gt_cam_t"][:tt]))
        print(f"ATE vs ground truth: {err:.4f} m")
    return RunResult(cfg.trajectory_file, cfg.map_file, cam_traj,
                     np.asarray(mask), np.asarray(ids), err, seconds)


if __name__ == "__main__":
    main()
