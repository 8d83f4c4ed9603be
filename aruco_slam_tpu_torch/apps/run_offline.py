"""Offline two-pass SLAM on PyTorch/CUDA (batch smoothing).

Counterpart of aruco_slam_tpu/apps/run_offline.py on one device: pass 1
ingests every frame into the factor graph with a cheap windowed solve
(`graph.add_frame` + `optimize_window`, the warm start), then a
full-batch LM solve (`graph.batch_optimize`) smooths the whole
trajectory, and the smoothed poses and map are written in the JAX
formats (with ``--ba-rotations`` the map records gain quaternion
columns).

    python -m aruco_slam_tpu_torch.apps.run_offline --input seq.npz \
        [--platform cuda|cpu] [--iters 50] [--ba-rotations] [--f64]

npz input may carry `images`, `corners` or pose-level `t_cl` bundles;
video input (with ``--calib``) goes through run_slam's decode ring and
front end; recycled slots (``--slot-max-age``) are epoch-split into
fresh landmark columns. ``--platform cuda`` is the default and raises
when no card is present. Every flag of the JAX run_offline parses, with
its usage errors; the distributed solve (``--distributed``,
``--processes``, ``--fleet``), checkpoints, ``--profile`` and the
viewers are refused with a "not ported yet" error.
"""

from __future__ import annotations

import argparse
import os
import time
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.apps.run_slam import (
    _resolve_recycling, _sync, graph_config, load_observations,
    load_video_observations)
from aruco_slam_tpu_torch.bench import ate
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.graph import (
    GraphConfig, GraphState, add_frame, batch_optimize, init_graph,
    landmark_covariances, optimize_window)
from aruco_slam_tpu_torch.io import (
    NpzSource, TrajectoryWriter, is_video, save_map)


class OfflineResult(NamedTuple):
    """What `main` wrote and measured."""

    trajectory_file: str
    map_file: str
    cam_traj: np.ndarray      # (T, 7) [xyz, quat wxyz], smoothed
    landmark_ids: np.ndarray  # marker ids in the map file
    ate: float | None         # vs the input's gt_cam_t, when present
    cost: float               # the batch solve's final cost
    seconds: dict             # front_end, ingest, solve


def _not_ported(what: str):
    raise NotImplementedError(f"{what}: not ported yet to the PyTorch/"
                              "CUDA package (aruco_slam_tpu.apps."
                              "run_offline has it)")


def _ingest(gcfg: GraphConfig, cfg: SlamAppConfig, t_cl, mask, q_cl,
            with_rotations: bool, device: torch.device) -> GraphState:
    """Pass 1: per-frame ingest with a cheap incremental window solve,
    the warm start batch LM needs (from the raw zero-motion init it
    stalls far from the optimum)."""
    state = init_graph(gcfg, device=device)
    t_cl = torch.as_tensor(np.asarray(t_cl), device=device)
    mask = torch.as_tensor(np.asarray(mask), device=device)
    q_cl = torch.as_tensor(np.asarray(q_cl), device=device) \
        if with_rotations else None
    for i in range(t_cl.shape[0]):
        state = add_frame(gcfg, state, t_cl[i], mask[i],
                          None if q_cl is None else q_cl[i])
        state, _ = optimize_window(gcfg, state, window=cfg.window,
                                   iters=cfg.window_iters)
    return state


def _seq_path(path: str, i: int, n: int) -> str:
    if n == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_seq{i}{ext}"


def _write_outputs(args, cfg: SlamAppConfig, gcfg: GraphConfig,
                   state: GraphState, times, slot_ids, src,
                   seq_i: int = 0, n_seq: int = 1):
    """Trajectory, map and ATE of one solved sequence: (cam_traj, ids,
    ate)."""
    t = len(times)
    cam_traj = torch.cat([state.pose_t, state.pose_q], 1)[:t].cpu().numpy()
    traj_file = _seq_path(cfg.trajectory_file, seq_i, n_seq)
    map_file = _seq_path(cfg.map_file, seq_i, n_seq)
    with TrajectoryWriter(traj_file) as w:
        for i in range(t):
            w.write(float(times[i]), cam_traj[i])
    slots = np.where(state.lm_active.cpu().numpy())[0]
    # id->slot table inputs record TRUE marker ids in the map file
    ids = slot_ids[slots] if slot_ids is not None else slots
    unc = torch.diagonal(landmark_covariances(gcfg, state), dim1=-2,
                         dim2=-1).cpu().numpy()
    lm_out = state.lm.cpu().numpy()
    if args.ba_rotations:
        # 7-column records [xyz, quat wxyz]
        lm_out = np.concatenate([lm_out, state.lm_q.cpu().numpy()], 1)
    save_map(map_file, ids, lm_out[slots], unc[slots])
    print(f"wrote {traj_file} ({t} poses), {map_file} ({len(ids)} "
          "landmarks)")
    err = None
    if src is not None and src.has("gt_cam_t"):
        err = float(ate.ate_rmse(cam_traj[:, :3], src["gt_cam_t"]))
        print(f"ATE vs ground truth: {err:.4f} m")
    return cam_traj, ids, err


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        description="Offline two-pass marker SLAM (batch smoothing) on "
                    "PyTorch/CUDA")
    dflt = SlamAppConfig(input="")
    p.add_argument("--input", required=True,
                   help="sequence bundle (.npz) or video; with --fleet, a "
                        "comma-separated list")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    p.add_argument("--trajectory", default="outputs/trajectory.txt")
    p.add_argument("--map", dest="map_file", default="outputs/map.txt")
    p.add_argument("--iters", type=int, default=50)
    p.add_argument("--calib", default=None,
                   help="directory with camera_matrix.npy + "
                        "dist_coeffs.npy (video input)")
    p.add_argument("--ba-rotations", action="store_true",
                   help="6-dof landmarks: smooth marker orientations too "
                        "(the map records gain quaternion columns)")
    p.add_argument("--meas-sigma-t", type=float, default=dflt.meas_sigma_t)
    p.add_argument("--odom-sigma-t", type=float, default=dflt.odom_sigma_t)
    p.add_argument("--odom-sigma-rot", type=float,
                   default=dflt.odom_sigma_rot)
    p.add_argument("--track-every", type=int, default=dflt.track_every,
                   metavar="K",
                   help="streaming detection for image/video input (see "
                        "run_slam --track-every); 0 = full detection "
                        "every frame")
    p.add_argument("--detector", default=dflt.detector,
                   choices=["robust", "fast"])
    p.add_argument("--capacity", type=int, default=dflt.capacity)
    p.add_argument("--slot-max-age", type=int, default=dflt.slot_max_age,
                   metavar="N",
                   help="recycle detector slots unobserved for > N frames; "
                        "the solve epoch-splits recycled slots into fresh "
                        "landmark columns")
    p.add_argument("--f64", action="store_true",
                   help="solve in float64")
    # the JAX run_offline's paths not ported yet: refused in main; the
    # modifiers of refused flags are accepted
    p.add_argument("--viz-2d", action="store_true")
    p.add_argument("--viz-3d", action="store_true")
    p.add_argument("--viz-3d-renderer", default="mpl",
                   choices=["mpl", "fast"])
    p.add_argument("--viz-dir", default="outputs/images")
    p.add_argument("--export-video", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N")
    p.add_argument("--checkpoint", default="outputs/checkpoint.npz")
    p.add_argument("--resume", default=None)
    p.add_argument("--distributed", action="store_true")
    p.add_argument("--processes", type=int, default=0, metavar="N")
    p.add_argument("--local-devices", type=int, default=None, metavar="M")
    p.add_argument("--coordinator", default="127.0.0.1:29791")
    p.add_argument("--fleet", default=None, metavar="DATAxKF")
    return p


def main(argv=None) -> OfflineResult:
    p = _parser()
    args = p.parse_args(argv)
    # the JAX run_offline's usage errors, in its order
    if args.track_every and args.track_every < 3:
        p.error("--track-every needs K >= 3")
    if len(args.input.split(",")) > 1 and not args.fleet:
        p.error("multiple --input sequences need --fleet DATAxKF")
    if args.fleet and (args.viz_2d or args.viz_3d or args.export_video):
        p.error("--fleet is a batch-production mode; re-run a single "
                "sequence with --viz-2d/--viz-3d to visualize it")
    if args.fleet and (args.checkpoint_every or args.resume):
        p.error("--fleet does not checkpoint (per-sequence ingest is "
                "cheap; checkpoint single-sequence runs)")
    for flag, on in (("--processes", args.processes),
                     ("--distributed", args.distributed),
                     ("--fleet", args.fleet),
                     ("--profile", args.profile),
                     ("--checkpoint-every", args.checkpoint_every),
                     ("--resume", args.resume),
                     ("--viz-2d", args.viz_2d), ("--viz-3d", args.viz_3d),
                     ("--export-video", args.export_video)):
        if on:
            _not_ported(flag)
    device = resolve_device(args.platform)

    cfg = SlamAppConfig(input=args.input, trajectory_file=args.trajectory,
                        map_file=args.map_file, batch_iters=args.iters,
                        meas_sigma_t=args.meas_sigma_t,
                        odom_sigma_t=args.odom_sigma_t,
                        odom_sigma_rot=args.odom_sigma_rot,
                        viz_dir=args.viz_dir,
                        viz_3d_renderer=args.viz_3d_renderer,
                        track_every=args.track_every,
                        detector=args.detector, capacity=args.capacity,
                        slot_max_age=args.slot_max_age)
    seconds = {}
    t0 = time.perf_counter()
    if is_video(cfg.input):
        src = None
        obs = load_video_observations(cfg, args.calib, device)
    else:
        src = NpzSource(cfg.input)
        obs = load_observations(src, cfg, device)
    times, t_cl, q_cl, mask, cam, _amb, slot_ids = _resolve_recycling(obs)
    _sync(device)
    seconds["front_end"] = time.perf_counter() - t0

    t = len(times)
    gcfg = graph_config(cfg, t + 2, t_cl.shape[1], int(mask.sum()) + 8, cam,
                        args.ba_rotations,
                        torch.float64 if args.f64 else torch.float32)
    t0 = time.perf_counter()
    state = _ingest(gcfg, cfg, t_cl, mask, q_cl, args.ba_rotations, device)
    _sync(device)
    seconds["ingest"] = time.perf_counter() - t0
    t1 = time.perf_counter()
    state, cost = batch_optimize(gcfg, state, iters=cfg.batch_iters)
    cost = float(cost)
    seconds["solve"] = time.perf_counter() - t1
    dt = time.perf_counter() - t0
    print(f"batch solve: {t} poses, {int(state.f_count)} factors, "
          f"{cfg.batch_iters} LM iters on 1 device in {dt:.2f}s (final "
          f"cost {cost:.3f})")
    print(f"ingest {seconds['ingest']:.3f}s, solve {seconds['solve']:.3f}s "
          f"({device})")
    cam_traj, ids, err = _write_outputs(args, cfg, gcfg, state, times,
                                        slot_ids, src)
    return OfflineResult(cfg.trajectory_file, cfg.map_file, cam_traj,
                         np.asarray(ids), err, cost, seconds)


if __name__ == "__main__":
    main()
