"""Multi-device scaling harness for the sharded BA solver.

Counterpart of aruco_slam_tpu/bench/scaling.py, with its flags and row
fields. Times `parallel.sharded_batch_optimize` over mesh sizes and
reports strong-scaling efficiency. A mesh device here is a (process,
slot) pair (`parallel/dist.py`): the sweep solves on ``make_mesh(n,
local_devices=n)``, n slots of this one process batched on its one
device — the port's form of JAX's virtual CPU devices, so on one card the
rows check the layout and the reduction rounds, not the speedup:

    python -m aruco_slam_tpu_torch.bench.scaling              # the card
    python -m aruco_slam_tpu_torch.bench.scaling --platform cpu \\
        --sizes 1,2,4 --frames 24 --markers 8 --iters 2 --reps 1

Each row also carries:

* ``factors_per_device`` — per-shard factor capacity after the landmark
  repartition (`sharded_ba._shard_capacity`),
* ``psum_bytes_per_iter`` — the collective volume of one LM iteration
  (pose blocks + partial Schur + cost scalars; O(T²), independent of the
  landmarks and factors), JAX's formula,
* ``collective_s`` / ``collective_frac`` — the time of just the
  reductions: the solver's three rounds of an iteration, at its shapes,
  through the functions the solver calls (`_collective_microbench`),
  ``iters`` times.

``--processes N`` runs the solve in N OS processes joined over
torch.distributed (`dist.initialize`; Gloo or NCCL by
`dist.choose_backend`), ``--fleet DATAxKF`` the 2-D fleet solve,
``--ingest N`` the sharded image front end over N processes against one.
Prints one JSON line a row.
"""

from __future__ import annotations

import argparse
import contextlib
import json
import os
import socket
import sys
import tempfile
from pathlib import Path

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.bench.pipeline import device_name, seconds_per_call

MODULE = "aruco_slam_tpu_torch.bench.scaling"


def _free_port() -> int:
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _collective_microbench(mesh, tcap: int, iters: int, reps: int,
                           dtype: torch.dtype, device: torch.device) -> float:
    """Seconds of ``iters`` rounds of the solver's reductions on ``mesh``
    (`parallel/sharded_ba._lm_iterations`): the pose blocks (tcap·6·6),
    their gradient (tcap·6) and the cost; then the partial Schur
    complement (T6²) and its gradient (T6); then the trial cost — each
    summed over this process's slots and then `dist.all_reduce_sum` over
    the mesh's group (None in one process: the slot sums alone)."""
    from aruco_slam_tpu_torch.parallel import dist as pdist
    rows, _, slots = mesh.layout()
    t6 = tcap * 6

    def zeros(*tail):
        return torch.zeros((len(rows), slots, *tail), dtype=dtype,
                           device=device)

    diag, g_p, cost = zeros(tcap, 6, 6), zeros(tcap, 6), zeros()
    s_part, g_s, trial = zeros(t6, t6), zeros(t6), zeros()

    def run(_):
        for _ in range(iters):
            pdist.all_reduce_sum([diag.sum(1), g_p.sum(1), cost.sum(1)],
                                 mesh.group)
            pdist.all_reduce_sum([s_part.sum(1), g_s.sum(1)], mesh.group)
            pdist.all_reduce_sum([trial.sum(1)], mesh.group)

    return seconds_per_call(run, reps, device)


def _psum_bytes(cfg) -> int:
    """Per-iteration reduction payload: (diag, g_p, cost) + (S, g_S) +
    cost, JAX's formula."""
    tcap = cfg.max_poses
    t6 = tcap * 6
    itemsize = torch.empty((), dtype=cfg.dtype).element_size()
    return itemsize * (tcap * 36 + tcap * 6 + 1 + t6 * t6 + t6 + 1)


def _note(device: torch.device, what: str) -> str:
    return (f"mesh slots batched on one device ({device_name(device)}) in "
            f"one process: checks {what}, NOT speedup — efficiency needs "
            "a device a slot")


def run(mesh_sizes, frames=256, markers=32, iters=10, reps=3,
        device: torch.device | None = None) -> list[dict]:
    """The sweep: one row a mesh size, each the warm mean of ``reps``
    solves of `_build_problem` (``iters`` LM iterations) on
    ``make_mesh(n, local_devices=n)``."""
    from aruco_slam_tpu_torch.parallel import make_mesh, sharded_batch_optimize
    from aruco_slam_tpu_torch.parallel.sharded_ba import _shard_capacity

    device = resolve_device("cuda") if device is None else device
    cfg, state = _build_problem(frames, markers, device)
    psum_bytes = _psum_bytes(cfg)
    results = []
    base_dt = None
    for n in mesh_sizes:
        mesh = make_mesh(n, local_devices=n)
        dt = seconds_per_call(lambda _: sharded_batch_optimize(
            cfg, state, mesh, iters=iters)[1], reps, device)
        if base_dt is None:
            base_dt = dt
        coll = 0.0 if n == 1 else _collective_microbench(
            mesh, cfg.max_poses, iters, reps, cfg.dtype, device)
        row = {"devices": n, "seconds": dt,
               "speedup": base_dt / dt,
               "efficiency": base_dt / (dt * n),
               "factors_per_device": _shard_capacity(cfg, state, n),
               "psum_bytes_per_iter": psum_bytes,
               "collective_s": coll,
               "collective_frac": coll / dt if dt else 0.0,
               "note": _note(device, "the collective layout and mechanics")}
        results.append(row)
        print(json.dumps(row), flush=True)
    return results


def _build_problem(frames, markers, device=None):
    """JAX's problem: an orbit before a ``markers``-marker wall, pose
    observations with 5 mm noise, ingested frame by frame without a
    solve."""
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.graph import GraphConfig, add_frame, init_graph

    cfg = GraphConfig(max_poses=frames + 2, max_landmarks=markers,
                      max_factors=frames * (markers // 2),
                      meas_sigma_t=0.01, odom_sigma_t=1.0,
                      odom_sigma_rot=1.0)
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    obs = synthetic.observe_poses(scene, traj, cfg.max_landmarks,
                                  noise_t=0.005, fov_limit=0.9)
    state = init_graph(cfg, device=device)
    for i in range(frames):
        state = add_frame(cfg, state, torch.as_tensor(
            obs.t_cl[i], dtype=cfg.dtype, device=device),
            torch.as_tensor(obs.mask[i], device=device))
    return cfg, state


def _worker_note(device: torch.device, nproc: int, backend: str) -> str:
    shared = device.type == "cuda" and torch.cuda.device_count() < nproc
    where = (f"{nproc} ranks share one {device_name(device)}" if shared
             else f"{nproc} processes on {device_name(device)}")
    return (f"multi-PROCESS run, {where} over {backend}: validates the "
            "launch shape + cross-process collectives; efficiency numbers "
            "need a card a process")


def run_worker(frames, markers, iters, reps, local_devices,
               platform="cuda") -> None:
    """One process of a multi-process run: the SLAM_* environment carries
    the coordinator and the rank (`dist.initialize` reads it); the solve
    on the global mesh over every process, and the reductions alone;
    process 0 prints the row."""
    from aruco_slam_tpu_torch.parallel import (
        dist, make_mesh, sharded_batch_optimize)

    dist.initialize(local_devices=local_devices, platform=platform)
    device = resolve_device(platform)
    cfg, state = _build_problem(frames, markers, device)
    mesh = make_mesh()  # global: every slot of every process
    dt = seconds_per_call(lambda _: sharded_batch_optimize(
        cfg, state, mesh, iters=iters)[1], reps, device)
    coll = _collective_microbench(mesh, cfg.max_poses, iters, reps,
                                  cfg.dtype, device)
    if dist.process_index() == 0:
        backend = str(torch.distributed.get_backend()) \
            if torch.distributed.is_initialized() else "none"
        print(json.dumps({
            "devices": dist.device_count(),
            "processes": dist.process_count(),
            "seconds": dt,
            "psum_bytes_per_iter": _psum_bytes(cfg),
            "collective_s": coll,
            "collective_frac": coll / dt if dt else 0.0,
            "backend": backend,
            "note": _worker_note(device, dist.process_count(), backend)}),
            flush=True)


def run_fleet(n_data, n_kf, frames, markers, iters, reps,
              device: torch.device | None = None) -> dict:
    """The 2-D ('data', 'kf') mesh: a fleet of n_data copies of the
    problem, each landmark-sharded over n_kf slots, on
    ``make_mesh2d(n_data, n_kf, local_devices=n_data * n_kf)``."""
    from aruco_slam_tpu_torch.parallel import (
        make_mesh2d, sharded_fleet_optimize, stack_graphs)

    device = resolve_device("cuda") if device is None else device
    cfg, state = _build_problem(frames, markers, device)
    fleet = stack_graphs([state] * n_data)
    mesh = make_mesh2d(n_data, n_kf, local_devices=n_data * n_kf)
    dt = seconds_per_call(lambda _: sharded_fleet_optimize(
        cfg, fleet, mesh, iters=iters)[1], reps, device)
    row = {"mesh": f"{n_data}x{n_kf} (data x kf)",
           "problems": n_data, "seconds": dt,
           "problems_per_s": n_data / dt,
           "note": _note(device, "the 2-D layout")}
    print(json.dumps(row), flush=True)
    return row


def _build_image_bundle(frames):
    """Deterministic small image sequence every ingest process rebuilds
    identically (no filesystem coordination needed)."""
    from aruco_slam_tpu_torch.apps import make_synthetic
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    return make_synthetic.build(
        frames=frames, markers=8, capacity=16, noise_px=0.2, seed=0,
        camera_matrix=k, dist_coeffs=np.zeros(5), with_images=True,
        image_size=(720, 405))


def _ingest_once(bundle, shard, device: torch.device, reps: int = 3
                 ) -> float:
    """The image front end (detection + slot scan + PnP) over the
    bundle: the minimum of ``reps`` runs after a warm one. ``shard``
    (process id, process count) runs the distributed front end."""
    import time

    from aruco_slam_tpu_torch.apps.front_end import (
        camera, observations_from_frames, observations_from_frames_sharded)
    from aruco_slam_tpu_torch.config import SlamAppConfig

    cfg = SlamAppConfig(input="", capacity=16)
    cfg.marker_size = float(bundle["marker_size"])
    cam = camera(bundle["camera_matrix"], bundle["dist_coeffs"], device)
    imgs, times = bundle["images"], bundle["times"]

    def go():
        # both return numpy arrays: the device's work is done
        if shard:
            return observations_from_frames_sharded(
                zip(times, imgs), cam, cfg, device, shard[0], shard[1],
                total=len(imgs))
        return observations_from_frames(zip(times, imgs), cam, cfg, device)

    go()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        go()
        best = min(best, time.perf_counter() - t0)
    return best


def run_ingest_worker(frames, local_devices, platform="cuda") -> None:
    """One process of the sharded-ingest measurement, pinned to one host
    core (and one thread), so N processes use N cores."""
    from aruco_slam_tpu_torch.parallel import dist
    dist.initialize(local_devices=local_devices, platform=platform)
    device = resolve_device(platform)
    pid, nproc = dist.process_index(), dist.process_count()
    want = int(os.environ.get("SLAM_NUM_PROCESSES", "1"))
    if nproc != want:
        raise RuntimeError(f"worker joined {nproc} processes, expected "
                           f"{want}")
    cores = sorted(os.sched_getaffinity(0))
    os.sched_setaffinity(0, {cores[pid % len(cores)]})
    torch.set_num_threads(1)
    bundle = _build_image_bundle(frames)
    dt = _ingest_once(bundle, (pid, nproc), device)
    if pid == 0:
        print(json.dumps({"ingest_seconds": dt, "processes": nproc,
                          "frames": frames,
                          "device": device_name(device)}), flush=True)


def _worker_command() -> list[str]:
    """The command a worker process runs (this module)."""
    return [sys.executable, "-m", MODULE]


def _launch(args: list[str], n: int) -> list[dict]:
    """`_worker_command` with ``args`` in n processes joined as one run
    (`run_offline._spawn`, the one launcher of the port's process runs);
    the JSON rows process 0 printed. A worker that fails ends the run
    with a nonzero exit."""
    from aruco_slam_tpu_torch.apps import run_offline
    with tempfile.TemporaryDirectory() as tmp, contextlib.ExitStack() as st:
        outs = [st.enter_context(open(Path(tmp) / f"{i}.out", "w+"))
                for i in range(n)]
        rc = run_offline._spawn(_worker_command() + args, n,
                                f"127.0.0.1:{_free_port()}", stdout=outs)
        if any(rc):
            raise SystemExit(f"workers failed: exit codes {rc}")
        outs[0].seek(0)
        return [json.loads(ln) for ln in outs[0].read().splitlines()
                if ln.startswith("{")]


def run_ingest(nproc, frames, local_devices, platform="cuda") -> dict:
    """The image front end (full per-frame candidate detection) sharded
    over N processes against 1, the same core budget a process. Every
    measurement, the baseline too, runs in fresh worker processes; this
    launcher never touches the device."""
    def launch(n):
        return _launch(["--ingest-worker", "--frames", str(frames),
                        "--local-devices", str(local_devices),
                        "--platform", platform], n)[-1]

    base = launch(1)
    sharded = launch(nproc)
    b, s = base["ingest_seconds"], sharded["ingest_seconds"]
    shared = "" if platform == "cpu" else \
        f"; the {nproc} processes share one {sharded['device']}"
    row = {"metric": "sharded_ingest_scaling",
           "frames": frames,
           "ingest_1proc_s": b,
           f"ingest_{nproc}proc_s": s,
           "speedup": b / s if s else 0.0,
           "efficiency": b / (s * nproc) if s else 0.0,
           "note": "each process pinned to one host core: N processes = N "
                   f"cores{shared}"}
    print(json.dumps(row), flush=True)
    return row


def run_multiprocess(nproc, frames, markers, iters, reps,
                     local_devices=2, platform="cuda") -> dict:
    """The solve in ``nproc`` OS processes (`run_worker`): process 0's
    row, printed here."""
    row = _launch(["--worker", "--frames", str(frames), "--markers",
                   str(markers), "--iters", str(iters), "--reps", str(reps),
                   "--local-devices", str(local_devices), "--platform",
                   platform], nproc)[-1]
    print(json.dumps(row), flush=True)
    return row


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    p.add_argument("--sizes", default="1,2,4,8")
    p.add_argument("--frames", type=int, default=256)
    p.add_argument("--markers", type=int, default=32)
    p.add_argument("--iters", type=int, default=10)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--processes", type=int, default=0,
                   help="launch N OS processes joined with "
                        "torch.distributed (the multi-host shape) "
                        "instead of the single-process device sweep")
    p.add_argument("--local-devices", type=int, default=2)
    p.add_argument("--fleet", default=None, metavar="DATAxKF",
                   help="bench the 2-D mesh instead, e.g. --fleet 4x2 "
                        "= 4 data-parallel problems, each landmark-"
                        "sharded over 2 devices")
    p.add_argument("--worker", action="store_true",
                   help=argparse.SUPPRESS)
    p.add_argument("--ingest", type=int, default=0, metavar="N",
                   help="measure the sharded IMAGE-INGEST front end "
                        "(detection round-robin over N processes) "
                        "against the 1-process baseline at the same "
                        "per-process core budget")
    p.add_argument("--ingest-worker", action="store_true",
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.ingest_worker:
        return run_ingest_worker(args.frames, args.local_devices,
                                 args.platform)
    if args.ingest:
        return run_ingest(args.ingest, min(args.frames, 64),
                          args.local_devices, args.platform)
    if args.worker:
        return run_worker(args.frames, args.markers, args.iters, args.reps,
                          args.local_devices, args.platform)
    if args.processes:
        return run_multiprocess(args.processes, args.frames, args.markers,
                                args.iters, args.reps, args.local_devices,
                                args.platform)
    device = resolve_device(args.platform)
    if args.fleet:
        n_data, n_kf = (int(v) for v in args.fleet.split("x"))
        return run_fleet(n_data, n_kf, args.frames, args.markers,
                         args.iters, args.reps, device)
    sizes = [int(s) for s in args.sizes.split(",")]
    return run(sizes, frames=args.frames, markers=args.markers,
               iters=args.iters, reps=args.reps, device=device)


if __name__ == "__main__":
    main()
