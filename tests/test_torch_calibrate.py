"""The port's calibration library (ops/calibrate.py), its board renderer
(bench/render.py charuco_bitmap, render_plane_views) and the camera's
image remap (core/camera.py undistort_image, bilinear_sample) against
the JAX package's, on the CPU.

Inputs are tests/test_calibrate.py's: its grid-board correspondences
(`make_views`, 12 views, 0.1 px noise, seed 0) and its ChArUco board
(7x5 squares, 30/15 mm, AprilTag 36h11) rendered at 1280x720 from its
view recipe (8 views, seed 0). Tolerances: the host numpy pieces
bit-identical; the float64 IPPE initialization and the LM's Jacobian
within 1e-10; the calibrated camera matrix within rtol 1e-8; the
undistorted image within one gray level (the count of pixels off by one
stated), bilinear samples within 1e-5.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch
from scipy.spatial.transform import Rotation

from aruco_slam_tpu.bench import render as jrender
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.core import quaternion as jquat
from aruco_slam_tpu.ops import calibrate as jcal
from aruco_slam_tpu.ops import dictionary as jdict
from aruco_slam_tpu_torch.bench import render as trender
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.ops import calibrate as tcal
from aruco_slam_tpu_torch.ops import detect as tdetect
from aruco_slam_tpu_torch.ops import dictionary as tdict
from test_calibrate import DIST_TRUE, K_TRUE, SIZE, make_views

torch.set_num_threads(2)

EXTENT = (7 * 0.03, 5 * 0.03)


def _charuco_poses(n_views=8, seed=0):
    """tests/test_calibrate.py make_charuco_views' view poses."""
    rng = np.random.default_rng(seed)
    ex, ey = EXTENT
    center = np.array([ex / 2, ey / 2, 0.0])
    flip = Rotation.from_euler("x", np.pi).as_matrix()
    poses = []
    for _ in range(n_views):
        rot = Rotation.from_euler(
            "xyz", rng.uniform(-0.35, 0.35, 3)).as_matrix() @ flip
        dist = rng.uniform(0.30, 0.42)
        t = np.array([rng.uniform(-0.02, 0.02),
                      rng.uniform(-0.02, 0.02), dist]) - rot @ center
        poses.append(np.concatenate(
            [Rotation.from_matrix(rot).as_rotvec(), t]))
    return np.asarray(poses)


@pytest.fixture(scope="module")
def charuco():
    """The board, and its 8 views rendered by each package."""
    jboard = jcal.charuco_board(7, 5, 0.03, 0.015)
    tboard = tcal.charuco_board(7, 5, 0.03, 0.015)
    poses = _charuco_poses()
    jbmp = jrender.charuco_bitmap(
        jboard, jdict.load(jdict.DICT_APRILTAG_36H11), px_per_square=96)
    tbmp = trender.charuco_bitmap(tboard, tdict.load("apriltag_36h11"),
                                  px_per_square=96)
    jviews = jrender.render_plane_views(
        jbmp, EXTENT, jcam.CameraModel.from_matrix(
            jnp.asarray(K_TRUE), jnp.asarray(DIST_TRUE)), poses, SIZE)
    tviews = trender.render_plane_views(
        tbmp, EXTENT, tcam.CameraModel.from_matrix(K_TRUE, DIST_TRUE),
        poses, SIZE)
    return tboard, jbmp, tbmp, jviews, tviews


@pytest.fixture(scope="module")
def charuco_features(charuco):
    """The port's detections on its views, interpolated and refined
    chessboard corners (tests/test_calibrate.py detect_board's
    detector): the one set of inputs both calibrations are given."""
    board, _, _, _, views = charuco
    cfg = tdetect.DetectorConfig(dict_name="apriltag_36h11", capacity=32,
                                 max_candidates=48, downscale=2, min_area=25)
    det = tdetect.detect_markers(torch.from_numpy(views), cfg)
    ids = board.layout.ids
    corners = det.corners.numpy()[:, ids].astype(np.float64)
    mask = det.mask.numpy()[:, ids]
    chess_px, chess_mask = tcal.interpolate_chess_corners(board, corners,
                                                          mask)
    ref = tdetect.refine_corners(torch.from_numpy(views).float(),
                                 torch.as_tensor(chess_px,
                                                 dtype=torch.float32))
    chess_px[chess_mask] = ref.numpy()[chess_mask]
    return corners, mask, chess_px, chess_mask


@pytest.mark.parametrize("make", [
    lambda m: m.grid_board(4, 3, 0.05, 0.015),
    lambda m: m.grid_board(2, 5, 0.04, 0.01, first_id=7),
    lambda m: m.charuco_board(7, 5, 0.03, 0.015),
    lambda m: m.charuco_board(5, 6, 0.04, 0.028, first_id=3)],
    ids=["grid4x3", "grid2x5", "charuco7x5", "charuco5x6"])
def test_board_layouts_bit_identical(make):
    want, got = make(jcal), make(tcal)
    assert len(got) == len(want)
    for a, b in zip(got, want):
        if isinstance(b, tuple):  # the ChArUco board's marker layout
            for x, y in zip(a, b):
                np.testing.assert_array_equal(x, y)
                assert x.dtype == y.dtype
        else:
            np.testing.assert_array_equal(a, b)


def test_charuco_refuses_marker_larger_than_square():
    with pytest.raises(ValueError, match="marker_len"):
        tcal.charuco_board(7, 5, 0.03, 0.03)


@pytest.mark.parametrize("dict_name,pps", [
    ("apriltag_36h11", 96), ("dict_5x5_50", 64), ("dict_4x4_50", 37)])
def test_charuco_bitmap_bit_identical(dict_name, pps):
    jboard = jcal.charuco_board(5, 4, 0.04, 0.03)
    tboard = tcal.charuco_board(5, 4, 0.04, 0.03)
    want = jrender.charuco_bitmap(jboard, jdict.load(dict_name), pps)
    got = trender.charuco_bitmap(tboard, tdict.load(dict_name), pps)
    np.testing.assert_array_equal(got, want)


def test_render_plane_views_bit_identical(charuco):
    """The 8 uint8 views: every pixel equal (the board-edge pixels would
    be where the port's float64 projection could round apart)."""
    _, jbmp, tbmp, jviews, tviews = charuco
    np.testing.assert_array_equal(tbmp, jbmp)
    assert tviews.shape == jviews.shape == (8, SIZE[1], SIZE[0])
    assert int((tviews != jviews).sum()) == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_fit_homography_bit_identical(seed):
    rng = np.random.default_rng(seed)
    src = rng.uniform(-0.2, 0.2, (4 * (seed + 2), 2))
    dst = rng.uniform(0, 1280, src.shape)
    np.testing.assert_array_equal(tcal._fit_homography(src, dst),
                                  jcal._fit_homography(src, dst))


def test_zhang_focal_init_bit_identical():
    board, corners, mask = make_views()
    homs = [jcal._fit_homography(board.corners[mask[i]].reshape(-1, 2),
                                 corners[i, mask[i]].reshape(-1, 2))
            for i in range(len(mask))]
    want = jcal._zhang_focal_init(homs, 640.0, 360.0)
    assert tcal._zhang_focal_init(homs, 640.0, 360.0) == want
    # the degenerate fallback
    assert tcal._zhang_focal_init([np.eye(3)], 0.0, 0.0) \
        == jcal._zhang_focal_init([np.eye(3)], 0.0, 0.0) == 1000.0


def test_interpolate_chess_corners_bit_identical(charuco_features):
    corners, mask, _, _ = charuco_features
    jboard = jcal.charuco_board(7, 5, 0.03, 0.015)
    tboard = tcal.charuco_board(7, 5, 0.03, 0.015)
    mask = mask.copy()
    mask[0, ::2] = False  # fewer markers: some corners lose their fit
    mask[1] = False
    want = jcal.interpolate_chess_corners(jboard, corners, mask)
    got = tcal.interpolate_chess_corners(tboard, corners, mask)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert got[1][2:].all(-1).any() and not got[1][1].any()


def test_init_views_matches_jax():
    """Zhang focal and per-view IPPE poses at float64: within 1e-10."""
    board, corners, mask = make_views()
    mask = mask.copy()
    mask[3, 1:] = False  # a view with one marker: no pose of its own
    want = jcal._init_views(board, corners, mask, SIZE)
    got = tcal._init_views(tcal.BoardLayout(*board), corners, mask, SIZE)
    assert got[1:3] == want[1:3] and got[4] == want[4]
    assert 3 not in got[4]
    np.testing.assert_allclose(got[0], want[0], rtol=1e-10)
    np.testing.assert_allclose(got[3], want[3], rtol=1e-10, atol=1e-10)


def test_residual_jacobian_matches_jax(charuco_features):
    """The LM's residuals and their `torch.func.jacfwd` Jacobian against
    `jax.jacfwd` of the JAX residual function, float64, at the
    initialization of the 8-view ChArUco problem: within 1e-10
    (relative to the Jacobian's largest entry)."""
    corners, mask, chess_px, chess_mask = charuco_features
    board = tcal.charuco_board(7, 5, 0.03, 0.015)
    f0, cx0, cy0, pose0, _ = tcal._init_views(board.layout, corners, mask,
                                              SIZE)
    params = np.concatenate([[f0 * 1.01, f0, cx0, cy0, 0.01, -0.02, 1e-3,
                              -2e-3, 0.03], pose0.reshape(-1)])
    pts3 = np.concatenate([board.chess_pts, np.zeros((24, 1))], -1)
    v = len(chess_px)

    def jres(p):  # aruco_slam_tpu/ops/calibrate.py _lm_calibrate's
        cam = jcam.CameraModel(fx=p[0], fy=p[1], cx=p[2], cy=p[3],
                               dist=p[4:9])
        poses = p[9:].reshape(v, 6)
        rot = jquat.to_matrix(jquat.from_rotvec(poses[:, :3]))
        pts = jnp.einsum("vab,nb->vna", rot, jnp.asarray(pts3)) \
            + poses[:, None, 3:]
        r = (jcam.project(cam, pts) - jnp.asarray(chess_px)) \
            * jnp.asarray(chess_mask)[:, :, None]
        return r.reshape(-1)

    tres = tcal._residual_fn(torch.from_numpy(pts3),
                             torch.from_numpy(chess_px),
                             torch.from_numpy(chess_mask))
    want_r = np.asarray(jax.jit(jres)(jnp.asarray(params)))
    want_j = np.asarray(jax.jit(jax.jacfwd(jres))(jnp.asarray(params)))
    got_r = tres(torch.from_numpy(params)).numpy()
    got_j = torch.func.jacfwd(tres)(torch.from_numpy(params)).numpy()
    assert got_j.shape == want_j.shape == (v * 24 * 2, 9 + 6 * v)
    np.testing.assert_allclose(got_r, want_r, rtol=0, atol=1e-10)
    np.testing.assert_allclose(got_j, want_j, rtol=0,
                               atol=1e-10 * np.abs(want_j).max())


def test_calibrate_matches_jax():
    """The grid board (make_views, 60 iterations): the camera matrix
    within rtol 1e-8 of JAX's, the distortion within 1e-7, the RMS
    within 1e-9 px; and the intrinsics recovered as
    test_recovers_intrinsics asks."""
    board, corners, mask = make_views()
    want = jcal.calibrate(board, corners, mask, SIZE, iters=60)
    got = tcal.calibrate(tcal.BoardLayout(*board), corners, mask, SIZE,
                         iters=60)
    np.testing.assert_allclose(got.camera_matrix, want.camera_matrix,
                               rtol=1e-8)
    np.testing.assert_allclose(got.dist_coeffs, want.dist_coeffs, atol=1e-7)
    np.testing.assert_allclose(got.rms_px, want.rms_px, atol=1e-9)
    np.testing.assert_allclose(got.per_view_rms, want.per_view_rms,
                               atol=1e-9)
    assert got.rms_px < 0.3
    np.testing.assert_allclose(got.camera_matrix[0, 0], 900.0, rtol=0.01)
    np.testing.assert_allclose(got.camera_matrix[1, 1], 905.0, rtol=0.01)


def test_calibrate_charuco_matches_jax(charuco_features):
    """The 8 rendered ChArUco views, the same detected, interpolated and
    refined features given to both (40 iterations): the camera matrix
    within rtol 1e-8 of JAX's; the intrinsics recovered within
    test_charuco_end_to_end's tolerances."""
    corners, mask, chess_px, chess_mask = charuco_features
    assert (mask.sum(-1) >= 12).all() and (chess_mask.sum(-1) >= 15).all()
    want = jcal.calibrate_charuco(
        jcal.charuco_board(7, 5, 0.03, 0.015), corners, mask, chess_px,
        chess_mask, SIZE, iters=40)
    got = tcal.calibrate_charuco(
        tcal.charuco_board(7, 5, 0.03, 0.015), corners, mask, chess_px,
        chess_mask, SIZE, iters=40)
    np.testing.assert_allclose(got.camera_matrix, want.camera_matrix,
                               rtol=1e-8)
    np.testing.assert_allclose(got.rms_px, want.rms_px, atol=1e-9)
    assert got.rms_px < 0.6
    np.testing.assert_allclose(got.camera_matrix[0, 0], 900.0, rtol=0.015)
    np.testing.assert_allclose(got.camera_matrix[1, 1], 905.0, rtol=0.015)
    np.testing.assert_allclose(got.camera_matrix[0, 2], 640.0, atol=6)
    np.testing.assert_allclose(got.camera_matrix[1, 2], 360.0, atol=6)


@pytest.mark.parametrize("dt", [np.float32, np.float64], ids=["f32", "f64"])
def test_undistort_image_matches_jax(charuco, dt):
    """A rendered view under the true camera (as the CLI's previews, at
    float32, and at float64): within one gray level of JAX's; fewer than
    1 in 10,000 pixels off by one (rounding ties at .5 under another
    summation order)."""
    img = charuco[4][0]
    want = np.asarray(jcam.undistort_image(
        jcam.CameraModel.from_matrix(jnp.asarray(K_TRUE, dt),
                                     jnp.asarray(DIST_TRUE, dt)),
        jnp.asarray(img)))
    got = tcam.undistort_image(
        tcam.CameraModel.from_matrix(np.asarray(K_TRUE, dt),
                                     np.asarray(DIST_TRUE, dt)),
        torch.from_numpy(img)).numpy()
    assert got.dtype == want.dtype == np.uint8
    diff = np.abs(got.astype(int) - want)
    assert diff.max() <= 1
    assert (diff > 0).sum() < img.size // 10_000, (diff > 0).sum()
    assert (got == 0).sum() > 0  # the border outside the source frame


def test_bilinear_sample_matches_jax():
    rng = np.random.default_rng(4)
    img = rng.uniform(0, 255, (37, 53)).astype(np.float32)
    x = rng.uniform(-3, 56, 500).astype(np.float32)
    y = rng.uniform(-3, 40, 500).astype(np.float32)
    want = np.asarray(jcam.bilinear_sample(*(jnp.asarray(a)
                                             for a in (img, x, y))))
    got = tcam.bilinear_sample(*(torch.from_numpy(a)
                                 for a in (img, x, y))).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)
