"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda``
and skips without a device. On a machine with a card (no jax needed):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch.filters import cuda_mekf
from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,iters,rounds", [
    ((3, 48, 64), 32, 4), ((2, 130, 100), 16, 4), ((4, 270, 480), 16, 4),
    ((2, 540, 960), 16, 4), ((2, 270, 480), 16, 0), ((1, 64, 128), 8, 2)])
def test_flood_scan_bit_identical(device, shape, iters, rounds):
    rng = np.random.default_rng(7)
    fg = torch.from_numpy(rng.random(shape) < 0.4).to(device)
    before = cuda_cc.flood_scan_labels.launches
    got = cuda_cc.flood_scan_labels(fg, iters, rounds)
    assert cuda_cc.flood_scan_labels.launches == before + 1
    want = cuda_cc.flood_scan_labels_plain(fg, iters, rounds)
    assert torch.equal(got, want)


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_subpix_matches_plain(device, dtype):
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (2, 240, 320),
                                        dtype=np.uint8)).to(device)
    img = torch.nn.functional.avg_pool2d(
        img[:, None].float(), 5, 1, 2)[:, 0].to(dtype)  # smooth corners
    seeds = torch.tensor(rng.uniform([0, 0], [319, 239], (2, 64, 2)),
                         dtype=torch.float32, device=device)
    sched = ((6, 6), (3, 4))
    got = cuda_subpix.refine_corners(img, seeds, sched)
    want = cuda_subpix.refine_corners_plain(img, seeds, sched)
    assert (got - want).abs().max().item() <= 2e-3  # px, reassociation


def test_fused_update_matches_plain(device):
    rng = np.random.default_rng(5)
    n, m = 201, 48
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    cov = torch.tensor(a @ a.T * 0.05 + 0.01 * np.eye(n),
                       dtype=torch.float32, device=device)
    h = torch.tensor(rng.normal(size=(m, n)) * 0.3, dtype=torch.float32,
                     device=device)
    r = torch.tensor(rng.uniform(1e-3, 1e-2, m), dtype=torch.float32,
                     device=device)
    resid = torch.tensor(0.01 * rng.normal(size=m), dtype=torch.float32,
                         device=device)
    inn, pn = cuda_mekf.fused_update(cov, h, r, resid)
    inn_p, pn_p = cuda_mekf.fused_update_plain(cov, h, r, resid)
    assert (inn - inn_p).abs().max().item() <= 1e-4
    assert (pn - pn_p).abs().max().item() <= 1e-4
    assert torch.equal(pn, pn.T)


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    img = torch.zeros((1, 64, 64), dtype=torch.int16, device=device)
    with pytest.raises(ValueError):
        cuda_subpix.refine_corners(img, torch.zeros((1, 4, 2),
                                                    device=device),
                                   ((6, 6),))
    cov = torch.eye(6, device=device)
    with pytest.raises(ValueError):
        cuda_mekf.fused_update(cov.double(), torch.zeros((3, 6),
                                                         device=device),
                               torch.ones(3, device=device),
                               torch.zeros(3, device=device))


def test_run_slam_cuda_matches_cpu(device, tmp_path):
    """The whole slice on the card against the same slice on the CPU
    (plain versions), on 8 rendered 960x540 frames."""
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.io import read_trajectory, save_npz
    k = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
                  [0.0, 0.0, 1.0]])
    dist = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    traj = synthetic.Trajectory(*(a[:8] for a in traj))
    frames = render.render_sequence(
        scene, traj, cam_mod.CameraModel.from_matrix(k, dist),
        image_size=(960, 540))
    npz = tmp_path / "seq.npz"
    save_npz(npz, times=traj.times, images=frames, gt_cam_t=traj.cam_t,
             camera_matrix=k, dist_coeffs=dist,
             marker_size=np.float64(scene.marker_size))
    out = {}
    for platform in ("cuda", "cpu"):
        res = run_slam.main(["--input", str(npz), "--platform", platform,
                             "--trajectory", str(tmp_path / f"{platform}.txt"),
                             "--map", str(tmp_path / f"{platform}_map.txt")])
        out[platform] = (read_trajectory(res.trajectory_file)[1], res)
    (tc, rc), (tp, rp) = out["cuda"], out["cpu"]
    assert np.array_equal(rc.obs_mask, rp.obs_mask)
    assert np.array_equal(np.sort(rc.landmark_ids), np.sort(rp.landmark_ids))
    # same math; sums (cumsum, GEMMs, reductions) in other orders
    np.testing.assert_allclose(tc, tp, atol=2e-3)
    assert rc.ate < 0.3
