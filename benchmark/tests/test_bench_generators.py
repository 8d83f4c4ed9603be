"""The frozen generators give the port's arrays bit for bit, and the npz
writer the port's format."""

import numpy as np
import torch

from benchmark import traffic
from benchmark.traffic_gen import render, synthetic
from conftest import HALF_K

DIST = [0.0614, -0.2951, 0.0005, 0.0029, 0.4387]


def _scene_and_traj(syn):
    scene = syn.make_wall_scene(num_markers=6, seed=11)
    traj = syn.make_orbit_trajectory(num_frames=40)
    return scene, syn.Trajectory(*(a[5:8] for a in traj))


def test_synthetic_and_render_match_the_port():
    from aruco_slam_tpu_torch.bench import render as p_render
    from aruco_slam_tpu_torch.bench import synthetic as p_syn
    from aruco_slam_tpu_torch.core import camera as p_cam
    from benchmark.reference import camera as cam_mod
    k, d = np.asarray(HALF_K, np.float64), np.asarray(DIST, np.float64)
    scene, traj = _scene_and_traj(synthetic)
    p_scene, p_traj = _scene_and_traj(p_syn)
    for a, b in zip((*scene[:2], *traj), (*p_scene[:2], *p_traj)):
        np.testing.assert_array_equal(a, b)
    cam = cam_mod.CameraModel.from_matrix(k, d)
    p_c = p_cam.CameraModel.from_matrix(k, d)
    ours = render.render_sequence(scene, traj, cam, image_size=(960, 540))
    port = p_render.render_sequence(p_scene, p_traj, p_c,
                                    image_size=(960, 540))
    assert ours.shape == (3, 540, 960) and (ours != render.BACKGROUND).any()
    np.testing.assert_array_equal(ours, port)
    c1, m1 = synthetic.observe_corners(scene, traj, cam, 16, noise_px=0.5,
                                       seed=4, image_size=(960, 540))
    c2, m2 = p_syn.observe_corners(p_scene, p_traj, p_c, 16, noise_px=0.5,
                                   seed=4, image_size=(960, 540))
    np.testing.assert_array_equal(c1, c2)
    np.testing.assert_array_equal(m1, m2)


def test_pool_is_seeded_and_in_the_ports_npz_format(tmp_path):
    from aruco_slam_tpu_torch.io import NpzSource
    cfg = dict(streams=2, image_size=[960, 540], camera_matrix=HALF_K,
               dist_coeffs=DIST, marker_size=0.16, dict="dict_5x5_50",
               capacity=64)
    tr = dict(kind="corners", frames=5, orbit_frames=300,
              pool_offsets=[0, 7], grid=[3, 4], wall_extent=1.5,
              noise_px=0.5)
    a = traffic.build_pool(cfg, tr, 2**31 + 5, cache=tmp_path / "a")
    b = traffic.build_pool(cfg, tr, 2**31 + 5, cache=tmp_path / "b")
    c = traffic.build_pool(cfg, tr, 2**31 + 6, cache=tmp_path / "c")
    assert len(a) == 2 and len(a[0]) == 2
    src = NpzSource(a[0][1])
    assert src["corners"].shape == (5, 64, 4, 2)
    for key in ("times", "corner_mask", "gt_cam_t", "camera_matrix",
                "dist_coeffs", "marker_size"):
        assert src.has(key)
    same = np.load(b[0][1])
    np.testing.assert_array_equal(src["corners"], same["corners"])
    other = np.load(c[0][1])
    assert not np.array_equal(src["corners"], other["corners"])
    # every stream of every seed keeps several markers in view
    assert src["corner_mask"].sum(1).min() >= 4


def test_grid_scene_keeps_the_wall_layout():
    s = traffic.grid_wall_scene(3, 4, 1.5, seed=3, marker_size=0.16)
    assert s.marker_pos.shape == (12, 3)
    assert np.abs(s.marker_pos[:, 0]).max() <= 1.5
    assert np.abs(s.marker_pos[:, 1]).max() <= 0.9
    assert np.allclose(np.linalg.norm(s.marker_quat, axis=-1), 1.0)
    assert torch.get_default_dtype() == torch.float32
