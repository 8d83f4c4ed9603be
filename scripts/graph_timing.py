#!/usr/bin/env python3
"""Time the port's factor graph on several source trees, in turns.

    python3 scripts/graph_timing.py TREE [TREE ...] [--platform cuda]

Each TREE is a directory holding an ``aruco_slam_tpu_torch`` package
(a checkout, or ``git archive`` of a commit unpacked). For each tree in
the order given, a fresh process imports the package from that tree
and times:

* the online graph: `bench.factorgraph.main` at its defaults (300
  frames, 12 markers, pose budget 128, window 8), warm frames/s;
* the large-map offline solve: `apps.run_offline.main` on a 512-marker,
  512-frame raster survey (corners with 0.3 px noise, seed 1), ``--iters
  40``: its ingest and solve seconds, a cold run then a warm one.

List the trees as parent, change, change, parent to compare two commits
on one card. Prints the card's name and power limit, one JSON line a
tree, and a last JSON line with all of them.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

MARKERS = 512
FRAMES = 512
ITERS = 40


def _child(tree: str, npz: str, platform: str) -> None:
    sys.path.insert(0, str(Path(tree).resolve()))
    import torch
    from aruco_slam_tpu_torch.apps import run_offline
    from aruco_slam_tpu_torch.bench import factorgraph
    online = factorgraph.main(["--platform", platform])
    runs = []
    with tempfile.TemporaryDirectory() as tmp:
        for _ in range(2):
            res = run_offline.main([
                "--input", npz, "--platform", platform, "--iters",
                str(ITERS), "--trajectory", str(Path(tmp) / "t.txt"),
                "--map", str(Path(tmp) / "m.txt")])
            runs.append(res)
    print(json.dumps({
        "tree": tree,
        "module": run_offline.__file__,
        "online_fps": online["value"], "online_ate_m": online["ate_m"],
        "offline_ingest_s": [r.seconds["ingest"] for r in runs],
        "offline_solve_s": [r.seconds["solve"] for r in runs],
        "offline_cost": runs[-1].cost, "offline_ate_m": runs[-1].ate,
        "device": torch.cuda.get_device_name(0) if platform == "cuda"
        else "cpu"}), flush=True)


def _survey(path: Path) -> None:
    """The large map's input bundle (run_offline's pose-from-corners
    npz), made by this checkout's code."""
    import numpy as np
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    from aruco_slam_tpu_torch.bench import e2e, large_map
    from aruco_slam_tpu_torch.io import save_npz
    scene, traj, corners, mask = large_map.survey(MARKERS, FRAMES,
                                                  e2e.camera())
    save_npz(path, times=traj.times, corners=corners, corner_mask=mask,
             gt_cam_t=traj.cam_t, camera_matrix=np.asarray(e2e.K),
             dist_coeffs=np.asarray(e2e.DIST),
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
        npz = Path(tmp) / "large_map.npz"
        _survey(npz)
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
