"""The port's factor-graph drivers on image input, against the JAX
package's, on the CPU: the epoch-split recycling runs of
tests/test_recycling.py (its two-cohort 720x405 sequence) and rendered
960x540 frames through `run_slam --filter factorgraph` and
`run_offline`. Both packages detect, solve PnP and run the graph on the
same npz; the tolerances are tests/test_torch_offline.py's.
"""

import numpy as np
import pytest
import torch

from aruco_slam_tpu.apps import run_offline as joff
from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.io import load_map
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu_torch.apps import front_end
from aruco_slam_tpu_torch.apps import run_offline as toff
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.bench import render, synthetic
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.io import save_npz

torch.set_num_threads(2)

K1 = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3], [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
F32_TRAJ = 2e-3   # m: f32 graphs from f32 (port) and f64 (JAX) PnP


def _both(jmod, tmod, npz, tmp_path, flags=()):
    """Run a driver of each package on ``npz``; returns {package:
    (trajectory (T, 7), map (ids, positions, uncertainties))}."""
    out = {}
    for name, mod in (("jax", jmod), ("torch", tmod)):
        traj_f = tmp_path / f"{name}_traj.txt"
        map_f = tmp_path / f"{name}_map.txt"
        mod.main(["--input", str(npz), "--platform", "cpu",
                  "--trajectory", str(traj_f), "--map", str(map_f), *flags])
        out[name] = (read_trajectory(traj_f)[1], load_map(map_f))
    return out


@pytest.fixture(scope="module")
def two_cohorts(tmp_path_factory):
    """tests/test_recycling.py's image sequence whose marker cohort
    changes mid-run: ids 0-4 for 6 frames, then ids 20-24 (720x405)."""
    from aruco_slam_tpu.apps import make_synthetic
    from aruco_slam_tpu.io.sources import save_npz as jsave
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    a, b = (make_synthetic.build(
        frames=6, markers=5, capacity=16, noise_px=0.2, seed=seed,
        camera_matrix=k, dist_coeffs=np.zeros(5), with_images=True,
        image_size=(720, 405), marker_ids=np.arange(5) + off)
        for seed, off in ((0, 0), (1, 20)))
    seq = dict(a)
    seq["images"] = np.concatenate([a["images"], b["images"]])
    seq["times"] = np.concatenate(
        [a["times"], a["times"][-1] + 0.04 + b["times"]])
    for key in ("gt_cam_t", "gt_cam_q"):
        seq[key] = np.concatenate([a[key], b[key]])
    path = tmp_path_factory.mktemp("cohorts") / "corridor.npz"
    jsave(path, **seq)
    return path


def test_epoch_remap_matches_jax(two_cohorts):
    """The port's front end at --capacity 5 --slot-max-age 1 recycles
    every slot; epoch_remap of its (reset, ids_seq) gives the JAX
    epoch_remap's columns and ids exactly."""
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.io import NpzSource
    cfg = SlamAppConfig(input=str(two_cohorts), capacity=5, slot_max_age=1)
    obs = front_end.load_observations(NpzSource(two_cohorts), cfg,
                                      torch.device("cpu"))
    _, t_cl, q_cl, mask, _, _, _, reset, ids_seq = obs
    assert reset.any()
    want = jrun.epoch_remap(t_cl, q_cl, mask, reset, ids_seq)
    got = trun.epoch_remap(t_cl, q_cl, mask, reset, ids_seq)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    assert got[0].shape[1] > 5


@pytest.mark.parametrize("driver", ["run_offline", "run_slam"])
def test_epoch_split_recycling_matches_jax(two_cohorts, tmp_path, driver):
    """The epoch-split recycling runs of tests/test_recycling.py (:191
    run_offline --iters 15, :248 run_slam --filter factorgraph) at
    --capacity 5 --slot-max-age 1: the map has the JAX run's columns
    and ids (both cohorts), positions within the f32 bound."""
    jmod, tmod = (joff, toff) if driver == "run_offline" else (jrun, trun)
    flags = ["--capacity", "5", "--slot-max-age", "1"] + (
        ["--iters", "15"] if driver == "run_offline"
        else ["--filter", "factorgraph"])
    out = _both(jmod, tmod, two_cohorts, tmp_path, flags)
    (tj, mj), (tt, mt) = out["jax"], out["torch"]
    np.testing.assert_array_equal(mt[0], mj[0])
    ids = set(mt[0].tolist())
    assert set(range(5)) <= ids and len(ids & set(range(20, 25))) >= 3
    np.testing.assert_allclose(mt[1], mj[1], atol=F32_TRAJ)
    np.testing.assert_allclose(tt, tj, atol=F32_TRAJ)


@pytest.fixture(scope="module")
def images(tmp_path_factory):
    """6 rendered 960x540 frames (the first of a 30-frame orbit)."""
    k = K1 / 2.0
    k[2, 2] = 1.0
    cam = tcam.CameraModel.from_matrix(k, DIST)
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.Trajectory(*(a[:6] for a in
                                  synthetic.make_orbit_trajectory(30)))
    frames = render.render_sequence(scene, traj, cam, image_size=(960, 540))
    path = tmp_path_factory.mktemp("images") / "seq.npz"
    save_npz(path, times=traj.times, images=frames, gt_cam_t=traj.cam_t,
             camera_matrix=k, dist_coeffs=DIST,
             marker_size=np.float64(scene.marker_size))
    return path


@pytest.mark.parametrize("driver", ["run_slam", "run_offline"])
def test_image_input_matches_jax(images, tmp_path, driver):
    """Rendered frames through detection, PnP and the graph in both
    packages: the same map ids, poses within the slice bound."""
    jmod, tmod, flags = (jrun, trun, ["--filter", "factorgraph"]) \
        if driver == "run_slam" else (joff, toff, ["--iters", "15"])
    out = _both(jmod, tmod, images, tmp_path, flags)
    (tj, mj), (tt, mt) = out["jax"], out["torch"]
    assert tt.shape == (6, 7) and np.isfinite(tt).all()
    np.testing.assert_array_equal(mt[0], mj[0])
    assert len(mt[0]) >= 4
    np.testing.assert_allclose(tt, tj, atol=F32_TRAJ)
    np.testing.assert_allclose(mt[1], mj[1], atol=F32_TRAJ)
