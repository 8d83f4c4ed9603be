"""Online factor-graph benchmark: the per-frame smoothing path (windowed
LM with Schur pose marginalization) of `run_slam.run_factorgraph`, the
product function, at the run_slam defaults (128-pose budget, window 8,
3 iterations) on a synthetic orbit. Prints one JSON line: frames/s of a
warm run, ATE and landmarks mapped.

    python -m aruco_slam_tpu_torch.bench.factorgraph            # a card
    python -m aruco_slam_tpu_torch.bench.factorgraph --platform cpu \
        --frames 80 --pose-budget 48                            # the CPU
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.apps import run_slam
from aruco_slam_tpu_torch.bench import synthetic
from aruco_slam_tpu_torch.bench.ate import ate_rmse
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.core import camera as cam_mod


def inputs(frames: int, markers: int):
    """The bench's sequence: a `frames`-frame orbit before a `markers`
    wall (seed 0), pose-level observations at capacity 64 (fov_limit
    0.75, noise 0.01 m / 0.01 rad, seed 1). Returns (trajectory,
    observations, camera)."""
    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    cam = cam_mod.CameraModel.from_matrix(k.astype(np.float32),
                                          np.zeros(5, np.float32))
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    obs = synthetic.observe_poses(scene, traj, 64, fov_limit=0.75,
                                  noise_t=0.01, noise_r=0.01, seed=1)
    return traj, obs, cam


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--markers", type=int, default=12)
    p.add_argument("--pose-budget", type=int, default=128)
    p.add_argument("--window", type=int, default=8)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    args = p.parse_args(argv)
    device = resolve_device(args.platform)
    traj, obs, cam = inputs(args.frames, args.markers)
    cfg = SlamAppConfig(input="", filter="factorgraph", window=args.window,
                        pose_budget=args.pose_budget)

    def run(n):
        return run_slam.run_factorgraph(
            cfg, traj.times[:n], obs.t_cl[:n], obs.q_cl[:n], obs.mask[:n],
            cam, device)

    # warm on a prefix that reaches the marginalization
    run(min(args.frames, args.pose_budget + 4))
    t0 = time.perf_counter()
    cam_traj, active, _, _ = run(args.frames)
    dt = time.perf_counter() - t0
    out = {"metric": "factorgraph_online_fps",
           "value": args.frames / dt,
           "unit": f"frames/s (pose budget {args.pose_budget}, window "
                   f"{args.window}, marginalizing; {device})",
           "ate_m": float(ate_rmse(cam_traj[:, :3], traj.cam_t)),
           "n_landmarks": int(np.asarray(active).sum()),
           "frames": args.frames}
    print(json.dumps(out))
    return out


if __name__ == "__main__":
    main()
