"""Generate a synthetic marker sequence as an .npz bundle.

Counterpart of aruco_slam_tpu/apps/make_synthetic.py: a wall of markers
seen along an orbit, with exact ground truth, as the bundle `run_slam`
and `run_offline` read (pose-level ``t_cl``/``q_cl``/``mask``, corner
level ``corners``/``corner_mask``, and with ``--images`` rendered
grayscale frames):

    python -m aruco_slam_tpu_torch.apps.make_synthetic --out seq.npz \
        --frames 300 --markers 12 [--noise-px 0.3] [--images]

The work is host numpy (`bench/synthetic.py`, `bench/render.py`); the
same arguments give the JAX tool's arrays. ``--platform`` is accepted
for the JAX tool's command lines and changes nothing.
"""

from __future__ import annotations

import argparse

import numpy as np

from aruco_slam_tpu_torch.bench import synthetic
from aruco_slam_tpu_torch.bench.render import render_sequence
from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.io import save_npz


def build(frames=300, markers=12, capacity=64, seed=0, noise_px=0.0,
          noise_t=0.0, noise_r=0.0, fov_limit=0.75,
          camera_matrix=None, dist_coeffs=None, marker_size=0.16,
          with_images=False, image_size=(1920, 1080),
          orbit_frames=None, dict_name="dict_5x5_50",
          marker_ids=None) -> dict:
    """The bundle's arrays. orbit_frames: length of the full orbit the
    ``frames`` output frames are sliced from (default ``frames``, one
    whole orbit; e.g. 10x frames for video-rate motion, the regime of
    ``run_slam --track-every``). dict_name / marker_ids set what the
    rendered images carry (scene marker j shows dictionary id
    marker_ids[j], default j); the corner- and pose-level arrays stay
    indexed by scene marker."""
    k = camera_matrix if camera_matrix is not None else np.array(
        [[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3], [0.0, 0.0, 1.0]])
    d = dist_coeffs if dist_coeffs is not None else np.array(
        [0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    cam = cam_mod.CameraModel.from_matrix(np.asarray(k, np.float64),
                                          np.asarray(d, np.float64))
    scene = synthetic.make_wall_scene(num_markers=markers, seed=seed,
                                      marker_size=marker_size)
    traj = synthetic.make_orbit_trajectory(
        num_frames=max(orbit_frames or frames, frames), seed=seed + 1)
    if orbit_frames and orbit_frames > frames:
        traj = synthetic.Trajectory(*(a[:frames] for a in traj))
    pose_obs = synthetic.observe_poses(
        scene, traj, capacity, noise_t=noise_t, noise_r=noise_r,
        fov_limit=fov_limit, seed=seed + 2)
    corners, cmask = synthetic.observe_corners(
        scene, traj, cam, capacity, noise_px=noise_px, seed=seed + 3,
        image_size=image_size)
    out = dict(
        times=traj.times,
        t_cl=pose_obs.t_cl, q_cl=pose_obs.q_cl, mask=pose_obs.mask,
        corners=corners, corner_mask=cmask,
        gt_cam_t=traj.cam_t, gt_cam_q=traj.cam_q,
        gt_marker_pos=scene.marker_pos, gt_marker_quat=scene.marker_quat,
        marker_size=np.float64(scene.marker_size),
        camera_matrix=k, dist_coeffs=d,
    )
    if with_images:
        out["images"] = render_sequence(scene, traj, cam,
                                        image_size=image_size,
                                        dict_name=dict_name,
                                        marker_ids=marker_ids)
    return out


def main(argv=None) -> None:
    p = argparse.ArgumentParser(description="synthetic marker sequence")
    p.add_argument("--out", required=True)
    p.add_argument("--frames", type=int, default=300)
    p.add_argument("--markers", type=int, default=12)
    p.add_argument("--capacity", type=int, default=64)
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--noise-px", type=float, default=0.0)
    p.add_argument("--noise-t", type=float, default=0.0)
    p.add_argument("--noise-r", type=float, default=0.0)
    p.add_argument("--images", action="store_true",
                   help="render grayscale frames (slower, larger)")
    p.add_argument("--dict", dest="dict_name", default="dict_5x5_50",
                   help="marker dictionary for rendered images "
                        "(ops/dictionary.names())")
    p.add_argument("--id-offset", type=int, default=0,
                   help="rendered marker j carries dictionary id "
                        "offset+j")
    p.add_argument("--video-rate", action="store_true",
                   help="slice the frames from a 10x-longer orbit so "
                        "inter-frame motion is video-rate (what "
                        "run_slam --track-every expects)")
    p.add_argument("--platform", default="cpu",
                   help="accepted for the JAX tool's command lines; the "
                        "synthesis is host numpy whatever it says")
    args = p.parse_args(argv)
    bundle = build(frames=args.frames, markers=args.markers,
                   capacity=args.capacity, seed=args.seed,
                   noise_px=args.noise_px, noise_t=args.noise_t,
                   noise_r=args.noise_r, with_images=args.images,
                   orbit_frames=(10 * args.frames if args.video_rate
                                 else None),
                   dict_name=args.dict_name,
                   marker_ids=(np.arange(args.markers) + args.id_offset
                               if args.id_offset else None))
    save_npz(args.out, **bundle)
    print(f"wrote {args.out}: {args.frames} frames, "
          f"{args.markers} markers"
          + (", with images" if args.images else ""))


if __name__ == "__main__":
    main()
