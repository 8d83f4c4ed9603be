"""Large-map throughput benchmark: a 512-marker survey on one card.

Counterpart of aruco_slam_tpu/bench/large_map.py, flag for flag: a
512-marker wall surveyed by a raster sweep (4 rows at 4.5 m depth, so
successive rows share landmarks), filtered by a 512-capacity
constant-velocity MEKF (error state 9 + 512·3 = 1545, so the per-frame
covariance update is a real dense workload; at ``--max-obs 48`` the
update takes M = 144 rows), one sequence and then ``--batch``
independent sequences at once. The filter runs JAX's configuration for
this bench: the XLA-form Newton–Schulz update (``update_kernel=False``,
``s_solver="ns"``), ``--precision`` on its covariance products and
``--cov-dtype`` for the covariance's storage. Then the offline
40-iteration batch LM (`graph.batch_optimize`) solves the same
observations, timed warm.

    python -m aruco_slam_tpu_torch.bench.large_map             # a card
    python -m aruco_slam_tpu_torch.bench.large_map --platform cpu \\
        --markers 96 --frames 160 --batch 2 --reps 1           # the CPU

Prints one JSON line and returns it.
"""

from __future__ import annotations

import argparse
import json
import time

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.bench import e2e, synthetic
from aruco_slam_tpu_torch.bench.ate import ate_rmse
from aruco_slam_tpu_torch.bench.pipeline import (
    device_name, make_pipeline, seconds_per_call, sync)
from aruco_slam_tpu_torch.filters import MekfConfig, init_state
from aruco_slam_tpu_torch.graph import (
    GraphConfig, add_frame, batch_optimize, init_graph)
from aruco_slam_tpu_torch.ops import pnp
from aruco_slam_tpu_torch.parallel.multi_slam import stack_states

BA_ITERS = 40


def survey(markers: int, frames: int, cam):
    """The raster survey: (scene, trajectory, corners (T, markers, 4, 2)
    with 0.3 px noise, mask (T, markers)). The wall is wide enough that
    a frame sees a bounded strip of it, and the rows overlap."""
    extent = 11.0 * np.sqrt(markers / 512.0)
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0,
                                      extent=float(extent), depth=4.5)
    traj = synthetic.make_raster_trajectory(
        num_frames=frames, rows=4, extent_x=float(extent - 2.0),
        extent_y=float(0.4 * extent))
    corners, mask = synthetic.observe_corners(scene, traj, cam, markers,
                                              noise_px=0.3, seed=1)
    return scene, traj, corners, mask


def filter_config(markers: int, max_obs: int, precision: str,
                  cov_dtype: str) -> MekfConfig:
    """The bench's MEKF: JAX's large_map configuration."""
    return MekfConfig(capacity=markers, max_obs=max_obs,
                      update_kernel=False, s_solver="ns",
                      pixel_sigma=0.3, gate_distance=1.5,
                      motion_model="cv", vel_decay=0.99,
                      matmul_precision=precision,
                      cov_dtype=torch.bfloat16 if cov_dtype == "bf16"
                      else None)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--markers", type=int, default=512)
    p.add_argument("--frames", type=int, default=512)
    p.add_argument("--batch", type=int, default=8)
    p.add_argument("--max-obs", type=int, default=48)
    p.add_argument("--reps", type=int, default=3)
    p.add_argument("--precision", default="mixed",
                   choices=["highest", "high", "mixed"],
                   help="update-chain matmul precision (filters/mekf "
                        "matmul_precision). 'mixed': bf16 covariance "
                        "products with the gain chain pinned at f32")
    p.add_argument("--cov-dtype", default="f32",
                   choices=["f32", "bf16"],
                   help="covariance storage dtype (MekfConfig."
                        "cov_dtype): bf16 halves the bytes the "
                        "dim-1545 step moves, at an ATE cost this bench "
                        "reports")
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    return p


def main(argv=None) -> dict:
    args = _parser().parse_args(argv)
    device = resolve_device(args.platform)
    cam = e2e.camera(device)
    scene, traj, corners, mask = survey(args.markers, args.frames,
                                        e2e.camera())
    visible = mask.sum(1)
    fcfg = filter_config(args.markers, args.max_obs, args.precision,
                         args.cov_dtype)
    state0 = init_state(fcfg, device=device)
    marker_size = scene.marker_size
    pipeline = make_pipeline(cam, marker_size, fcfg, chunk=16)

    corners_d = torch.tensor(corners, dtype=torch.float32, device=device)
    mask_d = torch.tensor(mask, device=device)
    rng = np.random.default_rng(7)
    corners_b = torch.tensor(
        corners[None] + rng.normal(0, 0.3, (args.batch,) + corners.shape),
        dtype=torch.float32, device=device)
    mask_b = mask_d.expand(args.batch, *mask.shape)

    _, est = pipeline(state0, corners_d, mask_d)
    ate = ate_rmse(est[:, :3].cpu().numpy(), traj.cam_t)
    dt = seconds_per_call(lambda i: pipeline(state0, corners_d, mask_d),
                          args.reps, device)
    single_fps = args.frames / dt
    states_b = stack_states([state0] * args.batch)
    dt = seconds_per_call(lambda i: pipeline(states_b, corners_b, mask_b),
                          max(1, args.reps - 1), device)
    fps = args.batch * args.frames / dt

    # offline smoothing at the same scale: the full batch LM with
    # Schur-eliminated landmarks over every pose and factor
    res = pnp.solve_square_pnp(cam, corners_d, marker_size)
    mask_h = mask & (res.err < 3.0).cpu().numpy()
    nfac = int(mask_h.sum()) + args.frames
    gcfg = GraphConfig(max_poses=args.frames + 2,
                       max_landmarks=args.markers,
                       max_factors=nfac + 64,
                       pixel_sigma=0.3, huber_delta=2.0)
    gstate = init_graph(gcfg, device=device)
    mask_g = torch.tensor(mask_h, device=device)
    for i in range(args.frames):
        gstate = add_frame(gcfg, gstate, res.t_cl[i], mask_g[i])
    gout, _ = batch_optimize(gcfg, gstate, iters=BA_ITERS)  # warm
    sync(device)
    t0 = time.perf_counter()
    gout, _ = batch_optimize(gcfg, gstate, iters=BA_ITERS)
    sync(device)
    ba_s = time.perf_counter() - t0
    ba_ate = ate_rmse(gout.pose_t[:args.frames].cpu().numpy(), traj.cam_t)

    row = {
        "metric": "large_map_fps_per_chip",
        "value": round(fps, 1),
        "unit": f"frames/s ({args.markers}-marker map, "
                f"batch {args.batch}, {args.precision} precision, "
                f"{args.cov_dtype} covariance)",
        "device": device_name(device),
        "single_stream_fps": round(single_fps, 1),
        "ate_m": round(float(ate), 4),
        "offline_ba_ate_m": round(float(ba_ate), 4),
        "offline_ba_s": round(ba_s, 4),
        "n_factors": nfac,
        "mean_visible": round(float(visible.mean()), 1),
        "state_dim": fcfg.err_dim,
    }
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
