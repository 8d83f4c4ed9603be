"""The flagship single-frame step and the multi-device dry run.

Counterpart of the repository root's ``__graft_entry__.py`` (`entry`, the
one SLAM frame a compile check runs; `dryrun_multichip`, one step of
every multi-device path with its parity checks). JAX's dry run builds a
mesh of n virtual CPU devices; here a mesh is n slots of this process
(`parallel.dist.make_mesh(n, local_devices=n)`, batched on its one
device) for the solves, and a stream mesh listing the device n times for
the filters — on a card too, where the same checks run through the
kernels.

    python -c "from aruco_slam_tpu_torch import entry; \\
        entry.dryrun_multichip(8, platform='cpu')"
"""

from __future__ import annotations

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device

# the JAX entry's camera (the run_slam default at 1920x1080)
K = ((1414.9, 0.0, 967.0), (0.0, 1414.9, 544.3), (0.0, 0.0, 1.0))
DIST = (0.0614, -0.2951, 0.0005, 0.0029, 0.4387)
CAPACITY = 64
MARKER_SIZE = 0.16

# the dry run's parity bounds (JAX's): the sharded solve against the
# unsharded at float64, where only the reduction order differs; a fleet
# sequence against its own scan
BA_POSE_TOL = 1e-6
BA_COST_RTOL = 1e-6
KF_TRAJ_TOL = 2e-5


def entry(device=None):
    """(frame_step, example_args): one fused SLAM frame, pixel corners ->
    batched IPPE PnP -> MEKF activate / predict / update, as
    ``frame_step(state, corners, mask) -> (next state, camera pose [xyz,
    quat wxyz])``, and its inputs: the initial state and frame 0 of an
    8-marker wall (seed 0) seen from a 2-frame orbit (corners seed 1).
    ``device`` defaults to the card (no card raises); on a card a call
    launches the fused update (B3) once."""
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.filters import (
        FrameObservations, MekfConfig, init_state, mekf_step)
    from aruco_slam_tpu_torch.filters.mekf import camera_pose
    from aruco_slam_tpu_torch.ops import pnp

    device = resolve_device("cuda") if device is None \
        else torch.device(device)
    k = np.asarray(K, np.float32)
    d = np.asarray(DIST, np.float32)
    cam = cam_mod.CameraModel.from_matrix(k, d, device=device)
    cfg = MekfConfig(capacity=CAPACITY)

    def frame_step(state, corners, mask):
        res = pnp.solve_square_pnp(cam, corners, MARKER_SIZE)
        obs = FrameObservations(t_cl=res.t_cl, q_cl=res.q_cl,
                                mask=mask & (res.err < 3.0))
        nxt = mekf_step(cfg, state, obs)
        return nxt, camera_pose(nxt)

    scene = synthetic.make_wall_scene(num_markers=8, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=2)
    corners, mask = synthetic.observe_corners(
        scene, traj, cam_mod.CameraModel.from_matrix(k, d), CAPACITY, seed=1)
    example_args = (
        init_state(cfg, device=device),
        torch.as_tensor(corners[0], dtype=torch.float32, device=device),
        torch.as_tensor(mask[0], device=device))
    return frame_step, example_args


def _check(ok: bool, msg: str) -> None:
    if not ok:
        raise RuntimeError(f"dryrun_multichip: {msg}")


def dryrun_multichip(n_devices: int, platform: str = "cuda") -> dict:
    """One step of every multi-device path on an ``n_devices`` mesh at
    JAX's tiny shapes, each held to JAX's check: the landmark-sharded
    Schur LM against `graph.batch_optimize` at float64 (|dpose| <
    BA_POSE_TOL, |dcost| < BA_COST_RTOL·max(1, |cost|)); the fleet MEKF
    over a stream mesh against one sequence's own `mekf_scan` (within
    KF_TRAJ_TOL); the 2-D (data, kf) fleet solve (a finite cost); the
    image pipeline over n 72x96 streams (finite trajectories; on a card
    through the labeling and subpixel kernels, where JAX's dry run left
    out its Pallas detector). Prints JAX's summary line and returns its
    numbers; a failed check raises RuntimeError. ``platform`` "cuda"
    (the default; no card raises) or "cpu"."""
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.filters import (
        FrameObservations, MekfConfig, init_state, mekf_scan)
    from aruco_slam_tpu_torch.graph import (
        GraphConfig, add_frame, batch_optimize, init_graph)
    from aruco_slam_tpu_torch.ops import detect
    from aruco_slam_tpu_torch.parallel import (
        batched_mekf_scan, make_mesh, make_mesh2d, sharded_batch_optimize,
        sharded_fleet_optimize, stack_graphs)
    from aruco_slam_tpu_torch.parallel.multi_slam import (
        batched_image_slam, stack_states)

    dev = resolve_device(platform)
    n = n_devices
    mesh = make_mesh(n, local_devices=n)
    streams = [dev] * n

    # the factor-sharded Schur solve against the unsharded one at f64
    frames = 12
    gcfg = GraphConfig(max_poses=frames + 2, max_landmarks=8,
                       max_factors=frames * 8, dtype=torch.float64)
    scene = synthetic.make_wall_scene(num_markers=6, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    obs = synthetic.observe_poses(scene, traj, 8, fov_limit=0.75)
    gstate0 = init_graph(gcfg, device=dev)
    for i in range(frames):
        gstate0 = add_frame(
            gcfg, gstate0,
            torch.as_tensor(obs.t_cl[i], dtype=torch.float64, device=dev),
            torch.as_tensor(obs.mask[i], device=dev))
    gstate, cost = sharded_batch_optimize(gcfg, gstate0, mesh, iters=2)
    cost = float(cost)
    _check(np.isfinite(cost), "sharded BA produced nan")
    single, cost_s = batch_optimize(gcfg, gstate0, iters=2)
    cost_s = float(cost_s)
    ba_dpose = float((gstate.pose_t[:frames]
                      - single.pose_t[:frames]).abs().max())
    ba_dcost = abs(cost - cost_s)
    _check(ba_dpose < BA_POSE_TOL, f"sharded BA diverges from "
           f"single-device: |dpose| {ba_dpose}")
    _check(ba_dcost < BA_COST_RTOL * max(1.0, abs(cost_s)),
           f"sharded BA cost mismatch: {cost} vs {cost_s}")

    # the data-parallel multi-sequence MEKF over a stream mesh
    fcfg = MekfConfig(capacity=8)
    t = 4

    def tiled(a, dtype):
        return torch.as_tensor(np.tile(a[None, :t, :8], (n,) + (1,) * (
            a.ndim)), dtype=dtype, device=dev)
    obs_b = FrameObservations(t_cl=tiled(obs.t_cl, torch.float32),
                              q_cl=tiled(obs.q_cl, torch.float32),
                              mask=tiled(obs.mask, torch.bool))
    states = stack_states([init_state(fcfg, device=dev) for _ in range(n)])
    _, trajs = batched_mekf_scan(fcfg, states, obs_b, mesh=streams)
    _check(bool(torch.isfinite(trajs).all()), "multi-seq MEKF nan")
    _, solo = mekf_scan(fcfg, init_state(fcfg, device=dev),
                        FrameObservations(obs_b.t_cl[0], obs_b.q_cl[0],
                                          obs_b.mask[0]))
    kf_dtraj = float((trajs[0] - solo).abs().max())
    _check(kf_dtraj < KF_TRAJ_TOL, f"fleet MEKF diverges from per-sequence "
           f"scan: {kf_dtraj}")

    # the 2-D (data, kf) mesh: a fleet of landmark-sharded solves
    n_kf = 2 if n % 2 == 0 else 1
    n_data = n // n_kf
    mesh2 = make_mesh2d(n_data, n_kf, local_devices=n)
    _, fcosts = sharded_fleet_optimize(
        gcfg, stack_graphs([gstate] * n_data), mesh2, iters=2)
    _check(bool(torch.isfinite(fcosts).all()), "fleet BA nan")

    # the image pipeline (detect + PnP + MEKF), one tiny stream a shard
    cam = cam_mod.CameraModel.from_matrix(
        np.array([[90.0, 0.0, 48.0], [0.0, 90.0, 36.0], [0.0, 0.0, 1.0]],
                 np.float32), np.zeros(5, np.float32), device=dev)
    dcfg = detect.DetectorConfig(capacity=8, max_candidates=8,
                                 passes=((9, 2),), min_area=8)
    imgs = torch.as_tensor(np.random.default_rng(0).integers(
        0, 40, (n, 2, 72, 96)).astype(np.uint8), device=dev)
    ifcfg = MekfConfig(capacity=8, max_obs=4)
    istates = stack_states([init_state(ifcfg, device=dev)
                            for _ in range(n)])
    _, itrajs = batched_image_slam(dcfg, ifcfg, cam, 0.16, imgs, istates,
                                   streams)
    _check(tuple(itrajs.shape) == (n, 2, 7)
           and bool(torch.isfinite(itrajs).all()), "image fleet nan")

    print(f"dryrun_multichip({n}): sharded BA == single-device "
          f"(|dpose| {ba_dpose:.2e}, |dcost| {ba_dcost:.2e}, cost "
          f"{cost:.3f}); {n}-sequence MEKF == per-sequence "
          f"scan (|dtraj| {kf_dtraj:.2e}); "
          f"({n_data}x{n_kf}) data*kf fleet BA ok; "
          f"{n}-stream image pipeline ok", flush=True)
    return {"ba_dpose": ba_dpose, "ba_dcost": ba_dcost, "cost": cost,
            "kf_dtraj": kf_dtraj, "mesh2d": (n_data, n_kf)}
