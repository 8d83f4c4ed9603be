#!/usr/bin/env python3
"""Time the port's kernel launch path and main path on several source
trees, in turns.

    python3 scripts/launch_timing.py TREE [TREE ...] [--platform cuda]

Each TREE is a directory holding an ``aruco_slam_tpu_torch`` package
(a checkout, or ``git archive`` of a commit unpacked). For each tree in
the order given, a fresh process imports the package from that tree
and times:

* the host milliseconds a wrapper call costs, launch path included:
  `fused_update` (B3) at the run_slam shape N 201, M 48 and
  `refine_corners` (B2) at the tracker's pull (one frame x 64 corners),
  ``CALLS`` calls each between two synchronizations, the median of
  ``REPS`` such runs;
* the main path: `apps.run_slam.main` on 32 rendered 1920x1080 frames
  (seed 0, the run_slam camera), the median warm frames/s of ``REPS``
  runs after a cold one.

List the trees as parent, change, change, parent to compare two commits
on one card. Prints the card's name and power limit, one JSON line a
tree, and a last JSON line with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path

CALLS = 500
REPS = 5
FRAMES = 32


def _per_call_ms(fn, sync) -> float:
    fn()
    runs = []
    for _ in range(REPS):
        sync()
        t0 = time.perf_counter()
        for _ in range(CALLS):
            fn()
        sync()
        runs.append((time.perf_counter() - t0) / CALLS * 1e3)
    return statistics.median(runs)


def _child(tree: str, npz: str, platform: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.filters import cuda_mekf
    from aruco_slam_tpu_torch.ops import cuda_subpix

    dev = torch.device(platform)

    def sync():
        if dev.type == "cuda":
            torch.cuda.synchronize()

    rng = np.random.default_rng(0)
    n, m = 201, 48
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    cov = torch.tensor(a @ a.T * 0.05 + 0.01 * np.eye(n), dtype=torch.float32,
                       device=dev)
    h = torch.tensor(rng.normal(size=(m, n)) * 0.3, dtype=torch.float32,
                     device=dev)
    r = torch.tensor(rng.uniform(1e-3, 1e-2, m), dtype=torch.float32,
                     device=dev)
    resid = torch.tensor(0.01 * rng.normal(size=m), dtype=torch.float32,
                         device=dev)
    image = torch.tensor(rng.integers(0, 255, (1, 1080, 1920)),
                         dtype=torch.uint8, device=dev)
    corners = torch.tensor(rng.uniform(40, 1000, (1, 64, 2)),
                           dtype=torch.float32, device=dev)
    b3 = _per_call_ms(lambda: cuda_mekf.fused_update(cov, h, r, resid), sync)
    b2 = _per_call_ms(lambda: cuda_subpix.refine_corners(
        image, corners, ((8, 6),)), sync)
    fps = []
    with tempfile.TemporaryDirectory() as tmp:
        argv = ["--input", npz, "--platform", platform, "--trajectory",
                str(Path(tmp) / "t.txt"), "--map", str(Path(tmp) / "m.txt")]
        run_slam.main(argv)
        for _ in range(REPS):
            sync()
            t0 = time.perf_counter()
            run_slam.main(argv)
            sync()
            fps.append(FRAMES / (time.perf_counter() - t0))
    print(json.dumps({
        "tree": tree, "module": run_slam.__file__,
        "b3_host_ms_a_call": b3, "b2_pull_host_ms_a_call": b2,
        "main_fps_median": statistics.median(fps), "main_fps": fps,
        "device": torch.cuda.get_device_name(0) if dev.type == "cuda"
        else "cpu"}), flush=True)


def _frames(path: Path) -> None:
    """The main path's input: 32 rendered 1080p frames of the default
    orbit's first chunk, made by this checkout's code."""
    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.io import save_npz
    app = SlamAppConfig(input="")
    k = np.asarray(app.camera_matrix)
    dist = np.asarray(app.dist_coeffs)
    cam = cam_mod.CameraModel.from_matrix(k.astype(np.float32),
                                          dist.astype(np.float32))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.Trajectory(*(
        a[:FRAMES] for a in synthetic.make_orbit_trajectory()))
    images = render.render_sequence(scene, traj, cam, image_size=(1920, 1080))
    save_npz(path, times=traj.times, images=images, gt_cam_t=traj.cam_t,
             camera_matrix=k, dist_coeffs=dist,
             marker_size=np.float64(scene.marker_size))


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("trees", nargs="+")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"])
    p.add_argument("--child", nargs=2, metavar=("TREE", "NPZ"),
                   help=argparse.SUPPRESS)
    args = p.parse_args(argv)
    if args.child:
        _child(args.child[0], args.child[1], args.platform)
        return 0
    if args.platform == "cuda":
        print(subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip(), flush=True)
    rows = []
    with tempfile.TemporaryDirectory() as tmp:
        npz = Path(tmp) / "frames.npz"
        _frames(npz)
        for tree in args.trees:
            # PYTHONPATH empty: the child imports the package from TREE
            out = subprocess.run(
                [sys.executable, __file__, "--child", tree, str(npz),
                 "--platform", args.platform, tree],
                capture_output=True, text=True,
                env={**os.environ, "PYTHONPATH": ""})
            if out.returncode:
                print(out.stdout[-4000:], out.stderr[-4000:], flush=True)
                return out.returncode
            rows.append(json.loads(out.stdout.strip().splitlines()[-1]))
            print(json.dumps(rows[-1]), flush=True)
    print(json.dumps(rows), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
