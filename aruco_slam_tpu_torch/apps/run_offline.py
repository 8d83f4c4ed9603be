"""Offline two-pass SLAM on PyTorch/CUDA (batch smoothing).

Counterpart of aruco_slam_tpu/apps/run_offline.py: pass 1 ingests every
frame into the factor graph with a cheap windowed solve
(`graph.add_frame` + `optimize_window`, the warm start), then a
full-batch LM solve (`graph.batch_optimize`) smooths the whole
trajectory, and the smoothed poses and map are written in the JAX
formats (with ``--ba-rotations`` the map records gain quaternion
columns).

    python -m aruco_slam_tpu_torch.apps.run_offline --input seq.npz \
        [--platform cuda|cpu] [--iters 50] [--ba-rotations] [--f64]

Distributed modes (parallel/dist.py, parallel/sharded_ba.py):

    # N OS processes on one machine joined over torch.distributed; the
    # solve runs landmark-sharded over processes x local devices, and
    # image input's candidate pipeline is sharded over the processes
    python -m aruco_slam_tpu_torch.apps.run_offline --input seq.npz \
        --processes 2 --local-devices 2 --platform cpu

    # one process of a run started elsewhere (SLAM_COORDINATOR,
    # SLAM_NUM_PROCESSES, SLAM_PROCESS_ID)
    python -m aruco_slam_tpu_torch.apps.run_offline --input seq.npz \
        --distributed

    # a fleet of sequences on a (data, kf) mesh: each sequence's
    # landmarks shard over kf, the sequences split over data; a
    # process batches its sequences on its device
    python -m aruco_slam_tpu_torch.apps.run_offline \
        --input a.npz,b.npz,c.npz,d.npz --fleet 1x1

NCCL joins processes that have a card each; Gloo joins CPU processes and
processes that share a card (`dist.choose_backend`). Only process 0
writes outputs.

npz input may carry `images`, `corners` or pose-level `t_cl` bundles;
video input (with ``--calib``) goes through run_slam's decode ring and
front end; recycled slots (``--slot-max-age``) are epoch-split into
fresh landmark columns. ``--checkpoint-every N --checkpoint PATH``
saves the pass-1 ingest's (graph state, frames done) every N frames (the
main process writes; `utils/checkpoint.py`, JAX's format), ``--resume
PATH`` restarts the ingest from it on every process; ``--profile DIR``
writes a torch.profiler trace of the front end, the ingest and the solve
to DIR/trace.json. ``--viz-2d`` / ``--viz-3d`` (``--viz-3d-renderer``,
``--viz-dir``, ``--export-video``) replay the smoothed poses and the
final map through the viewers after the solve (pass 2,
`apps/sinks.replay`); a viewer whose library is missing is refused
before any input is read. ``--platform cuda`` is the default and raises
when no card is present. Every flag of the JAX run_offline parses and
runs, with its usage errors.
"""

from __future__ import annotations

import argparse
import dataclasses
import os
import subprocess
import sys
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.apps import sinks
from aruco_slam_tpu_torch.apps.run_slam import (
    _resolve_recycling, _sync, graph_config, load_observations,
    load_video_observations)
from aruco_slam_tpu_torch.bench import ate
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.graph import (
    GraphConfig, GraphState, add_frame, batch_optimize, check_indices,
    init_graph, landmark_covariances, optimize_window, state_from_numpy,
    state_to_numpy)
from aruco_slam_tpu_torch.io import (
    NpzSource, TrajectoryWriter, is_video, save_map)
from aruco_slam_tpu_torch.parallel import dist as pdist
from aruco_slam_tpu_torch.parallel.sharded_ba import (
    sharded_batch_optimize, sharded_fleet_optimize, stack_graphs)
from aruco_slam_tpu_torch.utils.checkpoint import (
    load_checkpoint, save_checkpoint)
from aruco_slam_tpu_torch.utils.profiling import device_trace


class OfflineResult(NamedTuple):
    """What `main` wrote and measured."""

    trajectory_file: str
    map_file: str
    cam_traj: np.ndarray      # (T, 7) [xyz, quat wxyz], smoothed
    landmark_ids: np.ndarray  # marker ids in the map file
    ate: float | None         # vs the input's gt_cam_t, when present
    cost: float               # the batch solve's final cost
    seconds: dict             # front_end, ingest, solve (a fleet's: all)


def _child_command() -> list[str]:
    """The command a --processes child runs (this module)."""
    return [sys.executable, "-m", "aruco_slam_tpu_torch.apps.run_offline"]


def _wait_all(procs) -> list[int]:
    """Every child's exit code; the first that fails ends the others (a
    peer waiting on a dead one would otherwise wait out its timeout)."""
    while True:
        rc = [p.poll() for p in procs]
        if any(r for r in rc if r is not None):
            for p in procs:
                if p.poll() is None:
                    p.kill()
            return [p.wait() for p in procs]
        if all(r is not None for r in rc):
            return rc
        time.sleep(0.05)


def _spawn(cmd: list[str], n: int, coordinator: str) -> list[int]:
    """Run ``cmd`` in n OS processes joined as one run: each gets its
    SLAM_* environment (`dist.initialize` reads it), the repository on
    PYTHONPATH and its share of the host's cores as OpenMP threads
    (oversubscribed spinning threads stall small ops). Returns their
    exit codes; the first that fails ends the others."""
    root = str(Path(__file__).resolve().parents[2])
    path = os.environ.get("PYTHONPATH")
    threads = str(max(1, len(os.sched_getaffinity(0)) // n))
    procs = []
    try:
        for pid in range(n):
            env = dict(os.environ, SLAM_COORDINATOR=coordinator,
                       SLAM_NUM_PROCESSES=str(n), SLAM_PROCESS_ID=str(pid),
                       PYTHONPATH=root + (os.pathsep + path if path else ""))
            env.setdefault("OMP_NUM_THREADS", threads)
            procs.append(subprocess.Popen(cmd, env=env))
        return _wait_all(procs)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()


def _launch_processes(args, argv) -> None:
    """--processes N: re-run this command in N OS processes joined over
    torch.distributed (`_spawn`), each with --distributed in place of
    --processes (the one-process-per-host launch shape on one machine).
    A child that fails fails the run."""
    src = list(argv) if argv is not None else sys.argv[1:]
    child_argv, skip = [], False
    for a in src:
        if skip:
            skip = False
        elif a == "--processes":
            skip = True
        elif not a.startswith("--processes="):
            child_argv.append(a)
    if "--distributed" not in child_argv:
        child_argv.append("--distributed")
    rc = _spawn(_child_command() + child_argv, args.processes,
                args.coordinator)
    if any(rc):
        raise SystemExit(f"distributed workers failed: exit codes {rc}")


def _load_all(cfg: SlamAppConfig, inputs: list[str], calib,
              device: torch.device):
    """Every input sequence's (npz source or None, observations)."""
    seqs = []
    for path in inputs:
        c = dataclasses.replace(cfg, input=path)
        if is_video(path):
            src, obs = None, load_video_observations(c, calib, device)
        else:
            src = NpzSource(path)
            obs = load_observations(src, c, device)
        seqs.append((src, _resolve_recycling(obs)))
    return seqs


def _ingest(gcfg: GraphConfig, cfg: SlamAppConfig, t_cl, mask, q_cl,
            with_rotations: bool, device: torch.device,
            checkpoint_every: int = 0, checkpoint: str = "",
            resume: str | None = None, is_main: bool = True) -> GraphState:
    """Pass 1: per-frame ingest with a cheap incremental window solve,
    the warm start batch LM needs (from the raw zero-motion init it
    stalls far from the optimum). With ``checkpoint_every`` N the main
    process saves (state, frames done) to ``checkpoint`` every N frames
    but after the last; ``resume`` restarts from such a file."""
    state = init_graph(gcfg, device=device)
    t_cl = torch.as_tensor(np.asarray(t_cl), device=device)
    mask = torch.as_tensor(np.asarray(mask), device=device)
    q_cl = torch.as_tensor(np.asarray(q_cl), device=device) \
        if with_rotations else None
    t = t_cl.shape[0]
    start = 0
    if resume:
        state, fdone = load_checkpoint(resume, (state, np.int64(0)))
        check_indices(gcfg, state)
        start = int(fdone)
        if is_main:
            print(f"resumed from {resume} at ingest frame {start}")
    for i in range(start, t):
        state = add_frame(gcfg, state, t_cl[i], mask[i],
                          None if q_cl is None else q_cl[i])
        state, _ = optimize_window(gcfg, state, window=cfg.window,
                                   iters=cfg.window_iters)
        if checkpoint_every and is_main and i + 1 < t \
                and (i + 1) % checkpoint_every == 0:
            save_checkpoint(checkpoint, (state, np.int64(i + 1)))
    return state


def _seq_path(path: str, i: int, n: int) -> str:
    if n == 1:
        return path
    root, ext = os.path.splitext(path)
    return f"{root}_seq{i}{ext}"


def _write_outputs(args, cfg: SlamAppConfig, gcfg: GraphConfig,
                   state: GraphState, times, slot_ids, src,
                   seq_i: int = 0, n_seq: int = 1, obs=None):
    """Trajectory, pass-2 viewer replay (``obs`` = (t_cl, q_cl, mask,
    cam), with --viz-2d / --viz-3d), map and ATE of one solved sequence:
    (cam_traj, ids, ate)."""
    t = len(times)
    cam_traj = torch.cat([state.pose_t, state.pose_q], 1)[:t].cpu().numpy()
    traj_file = _seq_path(cfg.trajectory_file, seq_i, n_seq)
    map_file = _seq_path(cfg.map_file, seq_i, n_seq)
    with TrajectoryWriter(traj_file) as w:
        for i in range(t):
            w.write(float(times[i]), cam_traj[i])
    active = state.lm_active.cpu().numpy()
    if cfg.viz_2d or cfg.viz_3d:
        t_cl, q_cl, mask, cam = obs
        sinks.replay(sinks.build_viewers(cfg, cam, src), times, cam_traj,
                     state.lm.cpu().numpy(), active, t_cl, q_cl, mask,
                     slot_ids=slot_ids)
    slots = np.where(active)[0]
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
    p.add_argument("--distributed", action="store_true",
                   help="join a multi-process run (SLAM_COORDINATOR / "
                        "SLAM_NUM_PROCESSES / SLAM_PROCESS_ID) over "
                        "torch.distributed: the batch solve runs "
                        "landmark-sharded over every process's local "
                        "devices, image input's candidate pipeline over "
                        "the processes; process 0 writes outputs")
    p.add_argument("--processes", type=int, default=0, metavar="N",
                   help="start N OS processes on this machine, each "
                        "re-running this command with --distributed")
    p.add_argument("--local-devices", type=int, default=None, metavar="M",
                   help="mesh devices each process holds, batched on its "
                        "device (default 1)")
    p.add_argument("--coordinator", default="127.0.0.1:29791",
                   help="host:port of process 0 for --processes")
    p.add_argument("--fleet", default=None, metavar="DATAxKF",
                   help="solve a fleet of sequences (comma-separated "
                        "--input) on a DATA x KF mesh: sequences split over "
                        "DATA, each landmark-sharded over KF; outputs get "
                        "_seqI suffixes")
    # pass-2 replay through the viewers (apps/sinks.py)
    p.add_argument("--viz-2d", action="store_true",
                   help="pass-2 replay through the 2D overlay on the real "
                        "frames")
    p.add_argument("--viz-3d", action="store_true")
    p.add_argument("--viz-3d-renderer", default="mpl",
                   choices=["mpl", "fast"])
    p.add_argument("--viz-dir", default="outputs/images")
    p.add_argument("--export-video", action="store_true")
    p.add_argument("--profile", default=None, metavar="DIR",
                   help="write a torch.profiler trace of the run to "
                        "DIR/trace.json")
    p.add_argument("--checkpoint-every", type=int, default=0, metavar="N",
                   help="checkpoint the pass-1 ingest every N frames "
                        "(0 = off)")
    p.add_argument("--checkpoint", default="outputs/checkpoint.npz")
    p.add_argument("--resume", default=None,
                   help="resume the pass-1 ingest from a checkpoint")
    return p


def _solve(gcfg: GraphConfig, state: GraphState, iters: int,
           distributed: bool, local_devices: int):
    """Batch LM, landmark-sharded over every process's local devices when
    the run is distributed over more than one mesh device (JAX: more
    than one device); otherwise `batch_optimize`."""
    if distributed and pdist.device_count(local_devices) > 1:
        mesh = pdist.make_mesh(local_devices=local_devices)
        return sharded_batch_optimize(gcfg, state, mesh, iters=iters)
    return batch_optimize(gcfg, state, iters=iters)


def _run_fleet(args, cfg: SlamAppConfig, inputs: list[str], is_main: bool,
               device: torch.device, local_devices: int):
    """--fleet DATAxKF: solve the sequences as one fleet. Pass 1 goes
    round-robin over the processes (each ingests its sequences; the graph
    states are all-gathered on the host), the problems stack at common
    capacities, and `sharded_fleet_optimize` batches each process's
    problems. Returns one OfflineResult per sequence on process 0."""
    n_data, n_kf = (int(v) for v in args.fleet.split("x"))
    mesh = pdist.make_mesh2d(n_data=n_data, n_kf=n_kf,
                             local_devices=local_devices)
    seconds = {}
    t0 = time.perf_counter()
    seqs = _load_all(cfg, inputs, args.calib, device)
    seconds["front_end"] = time.perf_counter() - t0
    # common capacities so the problems stack into one fleet
    max_t = max(len(o[0]) for _, o in seqs)
    max_l = max(o[1].shape[1] for _, o in seqs)
    max_f = max(int(o[3].sum()) for _, o in seqs) + 8
    cam0 = seqs[0][1][4]
    gcfg = graph_config(cfg, max_t + 2, max_l, max_f, cam0,
                        args.ba_rotations,
                        torch.float64 if args.f64 else torch.float32)
    for _, o in seqs[1:]:
        if abs(float(o[4].fx) - float(cam0.fx)) > 0.01 * float(cam0.fx):
            print("warning: fleet sequences have different focal "
                  "lengths; using the first camera's for the "
                  "pixel-noise scaling")
            break

    def ingest(o):
        return _ingest(gcfg, cfg, o[1], o[3], o[2], args.ba_rotations,
                       device)

    t0 = time.perf_counter()
    nproc, pid = pdist.process_count(), pdist.process_index()
    if 1 < nproc <= len(seqs):
        own = [state_to_numpy(ingest(o)) for i, (_, o) in enumerate(seqs)
               if i % nproc == pid]
        own += [own[0]] * (-(-len(seqs) // nproc) - len(own))
        fields = GraphState._fields
        g = pdist.all_gather_host([np.stack([s[k] for s in own])
                                   for k in fields])     # (P, mmax, ...)
        states = [state_from_numpy(gcfg, {k: a[i % nproc, i // nproc]
                                          for k, a in zip(fields, g)},
                                   device)
                  for i in range(len(seqs))]
    else:
        states = [ingest(o) for _, o in seqs]
    _sync(device)
    seconds["ingest"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    out, costs = sharded_fleet_optimize(gcfg, stack_graphs(states), mesh,
                                        iters=cfg.batch_iters)
    costs = costs.cpu().numpy()
    seconds["solve"] = time.perf_counter() - t0
    if not is_main:
        return None
    print(f"fleet solve: {len(seqs)} sequences on a {n_data}x{n_kf} "
          f"(data x kf) mesh, {cfg.batch_iters} LM iters in "
          f"{seconds['solve']:.2f}s (ingest {seconds['ingest']:.2f}s)")
    results = []
    for i, (src, o) in enumerate(seqs):
        times, slot_ids = o[0], o[6]
        seq = GraphState(*(x[i] for x in out))
        cam_traj, ids, err = _write_outputs(args, cfg, gcfg, seq, times,
                                            slot_ids, src, seq_i=i,
                                            n_seq=len(seqs))
        results.append(OfflineResult(
            _seq_path(cfg.trajectory_file, i, len(seqs)),
            _seq_path(cfg.map_file, i, len(seqs)), cam_traj,
            np.asarray(ids), err, float(costs[i]), seconds))
    return results


def main(argv=None):
    """Returns the OfflineResult (one per sequence with --fleet) on process
    0; None on the others and from the --processes launcher."""
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
    cfg = SlamAppConfig(input=args.input, trajectory_file=args.trajectory,
                        map_file=args.map_file, batch_iters=args.iters,
                        meas_sigma_t=args.meas_sigma_t,
                        odom_sigma_t=args.odom_sigma_t,
                        odom_sigma_rot=args.odom_sigma_rot,
                        viz_2d=args.viz_2d, viz_3d=args.viz_3d,
                        viz_dir=args.viz_dir,
                        viz_3d_renderer=args.viz_3d_renderer,
                        export_video=args.export_video,
                        track_every=args.track_every,
                        detector=args.detector, capacity=args.capacity,
                        slot_max_age=args.slot_max_age)
    sinks.check_libraries(cfg)  # before any input is read
    if args.processes:
        return _launch_processes(args, argv)
    if args.distributed:
        pdist.initialize(local_devices=args.local_devices,
                         platform=args.platform)
    local_devices = args.local_devices or 1
    is_main = pdist.process_index() == 0
    device = resolve_device(args.platform)

    if args.fleet:
        return _run_fleet(args, cfg, args.input.split(","), is_main, device,
                          local_devices)
    # a multi-process run shards image input's candidate pipeline over
    # the processes; the slot scan and PnP replicate (bit-identical)
    nproc = pdist.process_count()
    shard = (pdist.process_index(), nproc) if nproc > 1 else None
    with device_trace(args.profile):
        seconds = {}
        t0 = time.perf_counter()
        if is_video(cfg.input):
            src = None
            obs = load_video_observations(cfg, args.calib, device,
                                          shard=shard)
        else:
            src = NpzSource(cfg.input)
            obs = load_observations(src, cfg, device, shard=shard)
        times, t_cl, q_cl, mask, cam, _amb, slot_ids = \
            _resolve_recycling(obs)
        _sync(device)
        seconds["front_end"] = time.perf_counter() - t0

        t = len(times)
        gcfg = graph_config(cfg, t + 2, t_cl.shape[1], int(mask.sum()) + 8,
                            cam, args.ba_rotations,
                            torch.float64 if args.f64 else torch.float32)
        t0 = time.perf_counter()
        state = _ingest(gcfg, cfg, t_cl, mask, q_cl, args.ba_rotations,
                        device, checkpoint_every=args.checkpoint_every,
                        checkpoint=args.checkpoint, resume=args.resume,
                        is_main=is_main)
        _sync(device)
        seconds["ingest"] = time.perf_counter() - t0
        t1 = time.perf_counter()
        state, cost = _solve(gcfg, state, cfg.batch_iters,
                             args.distributed, local_devices)
        cost = float(cost)
        seconds["solve"] = time.perf_counter() - t1
        dt = time.perf_counter() - t0
    if not is_main:
        return None
    if args.profile:
        print(f"wrote {Path(args.profile) / 'trace.json'}")
    where = f"{pdist.device_count(local_devices)} devices x {nproc} " \
        "processes" if args.distributed else "1 device"
    print(f"batch solve: {t} poses, {int(state.f_count)} factors, "
          f"{cfg.batch_iters} LM iters on {where} in {dt:.2f}s (final "
          f"cost {cost:.3f})")
    print(f"ingest {seconds['ingest']:.3f}s, solve {seconds['solve']:.3f}s "
          f"({device})")
    cam_traj, ids, err = _write_outputs(args, cfg, gcfg, state, times,
                                        slot_ids, src,
                                        obs=(t_cl, q_cl, mask, cam))
    return OfflineResult(cfg.trajectory_file, cfg.map_file, cam_traj,
                         np.asarray(ids), err, cost, seconds)


if __name__ == "__main__":
    main()
