#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path once on one GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints its own lines; any failure raises and exits
non-zero, and no result line is printed):

1. device   — torch/CUDA versions, the card, nvidia-smi's name and
              power limit; no CUDA device is an error.
2. build    — nvcc builds every kernel in aruco_slam_tpu_torch/csrc.
3. kernels  — each kernel's wrapper against its plain PyTorch version
              on the card, at the main path's shapes, with the stated
              tolerance; CUDA-event times (median of 20 after warm-up).
4. main path — 32 rendered 1920x1080 frames through
              `aruco_slam_tpu_torch.apps.run_slam.main` (robust
              detector, PnP, MEKF at the run_slam defaults): output
              files, ATE, detections, and every kernel's launch count
              in that run; then the frame rate of a second, warm run.

The line before the last is {"kernels": [...]}; the last line is
{"ok": true, "device": {...}}. Imports nothing of JAX and nothing
of the JAX package (aruco_slam_tpu).
"""

from __future__ import annotations

import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
CHUNK = 32            # run_slam's detection chunk: the kernels' batch
ATE_BOUND = 0.3       # m, the bound of tests/test_detect.py's image loop
B1_TOL = 0            # labels are integers: bit-identical
B2_TOL = 2e-3         # px: float reassociation only (tests/test_detect.py
                      # holds the JAX package's two backends to this)
B3_TOL = 1e-4         # f32 gain chain in another summation order
                      # (relative to the largest entry, at least 1)


def log(msg: str) -> None:
    print(msg, flush=True)


def cuda_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event time of fn() in milliseconds."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def phase_device():
    import torch
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    if not (ROOT / "aruco_slam_tpu_torch" / "csrc").is_dir():
        raise RuntimeError(f"{ROOT}: not a checkout of the repository "
                           "(aruco_slam_tpu_torch/csrc is missing)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}, {torch.cuda.device_count()} device(s)")
    log(smi)
    return name, smi


def phase_build():
    from aruco_slam_tpu_torch import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.last_build_seconds:.2f} s)")


def _b1(rng, dev):
    import torch
    from aruco_slam_tpu_torch.ops import cuda_cc
    # the grids run_slam labels per chunk at 1080p: 270x480 twice
    # (prop_iters 16) and 540x960 once (fine pass, max(16, 16 // 2)),
    # plus a 1080x1920 grid (the fine pass of 4K input)
    cases = [((CHUNK, 270, 480), 16, 4), ((CHUNK, 540, 960), 16, 4),
             ((2, 1080, 1920), 16, 4)]
    worst = 0
    timing = None
    for shape, iters, rounds in cases:
        fg = torch.from_numpy(rng.random(shape) < 0.45).to(dev)
        got = cuda_cc.flood_scan_labels(fg, iters, rounds)
        want = cuda_cc.flood_scan_labels_plain(fg, iters, rounds)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        worst = max(worst, bad)
        ms = cuda_ms(lambda: cuda_cc.flood_scan_labels(fg, iters, rounds))
        plain = cuda_ms(lambda: cuda_cc.flood_scan_labels_plain(
            fg, iters, rounds), reps=10)
        log(f"[B1] flood_scan_labels {shape} iters {iters} rounds "
            f"{rounds}: {bad} labels differ; kernel {ms:.3f} ms, plain "
            f"{plain:.3f} ms")
        if bad > B1_TOL:
            raise AssertionError(f"B1 differs from its plain version at "
                                 f"{shape}: {bad} labels")
        if shape[1:] == (540, 960):
            timing = (ms, plain)
    return {"name": "flood_scan_labels", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/flood_scan.cu",
            "replaces": "aruco_slam_tpu/ops/pallas_cc.py:87",
            "max_abs_err": float(worst), "ms": timing[0],
            "plain_ms": timing[1]}


def _b2(frames, corners_true, mask_true, rng, dev):
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.ops import cuda_subpix
    # 384 seeds per frame (32 candidates x 3 passes x 4 corners): the
    # true corners perturbed like coarse-grid quad seeds, the rest
    # anywhere in the frame
    t, h, w = frames.shape
    seeds = rng.uniform([0, 0], [w - 1, h - 1], size=(t, 384, 2))
    for i in range(t):
        true = corners_true[i][mask_true[i]].reshape(-1, 2)
        seeds[i, :len(true)] = true + rng.uniform(-3, 3, true.shape)
    img = torch.from_numpy(frames).to(dev)
    c = torch.tensor(seeds, dtype=torch.float32, device=dev)
    sched = ((6, 6), (3, 4))
    got = cuda_subpix.refine_corners(img, c, sched)
    want = cuda_subpix.refine_corners_plain(img, c, sched)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    ms = cuda_ms(lambda: cuda_subpix.refine_corners(img, c, sched))
    plain = cuda_ms(lambda: cuda_subpix.refine_corners_plain(img, c, sched),
                    reps=10)
    log(f"[B2] refine_corners {tuple(c.shape)} on {h}x{w} uint8: max "
        f"|kernel - plain| {err:.3e} px (tol {B2_TOL}); kernel {ms:.3f} "
        f"ms, plain {plain:.3f} ms")
    if not np.isfinite(err) or err > B2_TOL:
        raise AssertionError(f"B2 differs from its plain version: {err}")
    return {"name": "refine_corners", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/subpix.cu",
            "replaces": "aruco_slam_tpu/ops/pallas_subpix.py:92",
            "max_abs_err": err, "ms": ms, "plain_ms": plain}


def _capture_update_inputs(corners, mask, cam, marker_size):
    """The fused update's inputs at every frame of a short filter run
    on the CPU (the run_slam MEKF settings, N = 201, M = 48)."""
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.filters import cuda_mekf
    from aruco_slam_tpu_torch.ops import pnp
    cpu = torch.device("cpu")
    res = pnp.solve_square_pnp(cam.to(device=cpu), torch.tensor(
        corners, dtype=torch.float32), marker_size)
    captured = []
    real = cuda_mekf.fused_update

    def record(*args, **kw):
        captured.append([a.clone() for a in args])
        return real(*args, **kw)

    cuda_mekf.fused_update = record
    try:
        run_slam.run_mekf(SlamAppConfig(input=""), list(range(len(mask))),
                          res.t_cl.numpy(), res.q_cl.numpy(), mask, cam,
                          cpu)
    finally:
        cuda_mekf.fused_update = real
    return captured


def _b3(captured, dev):
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.filters import cuda_mekf
    cov, h, r, resid = (a.to(dev) for a in captured[len(captured) // 2])
    n = 54  # the camera block + 16 landmarks (motion_model "none")
    cases = [(cov, h, r, resid),
             (cov[:n, :n].contiguous(), h[:, :n].contiguous(), r, resid)]
    worst = 0.0
    timing = None
    for args in cases:
        inn, pn = cuda_mekf.fused_update(*args)
        inn_p, pn_p = cuda_mekf.fused_update_plain(*args)
        torch.cuda.synchronize()
        err = max(float((inn - inn_p).abs().max()
                        / max(1.0, float(inn_p.abs().max()))),
                  float((pn - pn_p).abs().max()
                        / max(1.0, float(pn_p.abs().max()))))
        worst = max(worst, err)
        ms = cuda_ms(lambda: cuda_mekf.fused_update(*args))
        plain = cuda_ms(lambda: cuda_mekf.fused_update_plain(*args))
        log(f"[B3] fused_update N={args[0].shape[0]} M={args[1].shape[0]}"
            f": max |kernel - plain| {err:.3e} (tol {B3_TOL}); kernel "
            f"{ms:.3f} ms, plain {plain:.3f} ms")
        if not np.isfinite(err) or err > B3_TOL:
            raise AssertionError(f"B3 differs from its plain version: {err}")
        if timing is None:
            timing = (ms, plain)
    return {"name": "fused_update", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/mekf_update.cu",
            "replaces": "aruco_slam_tpu/filters/pallas_mekf.py:40",
            "max_abs_err": worst, "ms": timing[0], "plain_ms": timing[1]}


def phase_main(npz: Path, out: Path, gt_t, smi: str):
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import ate
    from aruco_slam_tpu_torch.filters import cuda_mekf
    from aruco_slam_tpu_torch.io import read_trajectory
    from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix
    wrappers = (cuda_cc.flood_scan_labels, cuda_subpix.refine_corners,
                cuda_mekf.fused_update)
    argv = ["--input", str(npz), "--platform", "cuda",
            "--trajectory", str(out / "trajectory.txt"),
            "--map", str(out / "map.txt")]
    for fn in wrappers:
        fn.launches = 0
    res = run_slam.main(argv)
    torch.cuda.synchronize()
    launches = {fn.__name__: fn.launches for fn in wrappers}
    traj_file, map_file = Path(res.trajectory_file), Path(res.map_file)
    if not traj_file.is_file() or not map_file.is_file():
        raise AssertionError("run_slam wrote no trajectory/map file")
    _, poses = read_trajectory(traj_file)
    if poses.shape != (len(gt_t), 7) or not np.isfinite(poses).all():
        raise AssertionError(f"trajectory {poses.shape}, finite "
                             f"{np.isfinite(poses).all()}")
    err = ate.ate_rmse(poses[:, :3], gt_t)
    det = res.obs_mask.sum(axis=1)
    log(f"[main] ATE {err:.4f} m (bound {ATE_BOUND}); detections per "
        f"frame {det.tolist()}; {len(res.landmark_ids)} landmarks; "
        f"stage seconds {res.seconds}")
    if not err < ATE_BOUND:
        raise AssertionError(f"ATE {err} m >= {ATE_BOUND} m")
    if (det >= 1).sum() * 2 <= len(det):
        raise AssertionError("fewer than half the frames had a detection")
    log(f"[main] launches in the run: {launches}")
    for name, count in launches.items():
        if count <= 0:
            raise AssertionError(f"the main path never launched {name}")

    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_slam.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fps = len(gt_t) / dt
    log(f"[main] warm run: {len(gt_t)} frames 1920x1080 in {dt:.3f} s = "
        f"{fps:.2f} frames/s end to end (front end "
        f"{warm.seconds['front_end']:.3f} s, filter "
        f"{warm.seconds['filter']:.3f} s) on {smi}")
    return launches


def main() -> int:
    import torch
    name, smi = phase_device()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.io import save_npz

    phase_build()
    dev = torch.device("cuda", 0)
    rng = np.random.default_rng(SEED)
    app = SlamAppConfig(input="")
    cam = cam_mod.CameraModel.from_matrix(
        np.asarray(app.camera_matrix, np.float32),
        np.asarray(app.dist_coeffs, np.float32))
    scene = synthetic.make_wall_scene(num_markers=10, seed=SEED)
    # the first chunk of the default 300-frame (10 s, 30 fps) orbit:
    # hand-held video-rate motion (a whole orbit squeezed into 32 frames
    # moves ~0.16 m per frame and the filter lags it by decimeters)
    traj = synthetic.Trajectory(*(
        a[:CHUNK] for a in synthetic.make_orbit_trajectory()))
    t0 = time.perf_counter()
    frames = render.render_sequence(scene, traj, cam, image_size=(1920, 1080))
    corners, mask = synthetic.observe_corners(scene, traj, cam, 64)
    log(f"[data] rendered {frames.shape} in "
        f"{time.perf_counter() - t0:.1f} s; visible markers per frame "
        f"{mask.sum(1).tolist()}")

    kernels = [_b1(rng, dev), _b2(frames, corners, mask, rng, dev)]
    captured = _capture_update_inputs(corners, mask, cam,
                                      scene.marker_size)
    kernels.append(_b3(captured, dev))

    with tempfile.TemporaryDirectory() as tmp:
        npz = Path(tmp) / "seq.npz"
        save_npz(npz, times=traj.times, images=frames,
                 gt_cam_t=traj.cam_t, gt_cam_q=traj.cam_q,
                 camera_matrix=np.asarray(app.camera_matrix),
                 dist_coeffs=np.asarray(app.dist_coeffs),
                 marker_size=np.float64(scene.marker_size))
        launches = phase_main(npz, Path(tmp), traj.cam_t, smi)
    for k in kernels:
        k["launches"] = launches[k["name"]]
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
