"""PyTorch port vs the JAX package: public names the drivers use.

`bench.ate.rpe_rmse`, `ops.pnp.homography_4pt`, `ops.dictionary`'s
`marker_image` and name constants, `io.write_trajectory`,
`apps.run_slam.load_camera` and the batched detector entry points
(`detect_markers_batch`, `detect_markers_batch_mapped`), each on the
same seeded inputs as its JAX counterpart.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.bench import ate as jate
from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.config import SlamAppConfig as JaxAppConfig
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.io import trajectory as jtraj
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu.ops import dictionary as jdict
from aruco_slam_tpu.ops import pnp as jpnp
from aruco_slam_tpu_torch import io as tio
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.bench import ate as tate
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.ops import detect as td
from aruco_slam_tpu_torch.ops import dictionary as tdict
from aruco_slam_tpu_torch.ops import pnp as tpnp

torch.set_num_threads(2)

# tests/test_torch_detect.py's detector fixture and corner bound
K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
SIZE = (960, 540)
CORNER_ATOL = 1e-3
# an f32 8x8 normal-equation solve (condition ~1e4 here) against JAX's
# same unrolled Cholesky: relative 1e-4 of the largest entry
H_RTOL = 1e-4


def test_rpe_rmse_matches_jax():
    rng = np.random.default_rng(0)
    gt = np.cumsum(rng.normal(size=(40, 3)), 0)
    est = gt + rng.normal(0, 0.05, gt.shape)
    for delta in (1, 3, 10):
        assert tate.rpe_rmse(est, gt, delta) == jate.rpe_rmse(est, gt, delta)


def test_homography_4pt_matches_jax():
    """Eight perturbed squares, each against the JAX DLT (one (4, 2)
    pair a call there, the batch in one call here)."""
    rng = np.random.default_rng(1)
    obj = (np.array([[-1, 1], [1, 1], [1, -1], [-1, -1]]) * 0.08
           ).astype(np.float32)
    img = (obj[None] * rng.uniform(2, 4, (8, 1, 1))
           + rng.normal(0, 0.01, (8, 4, 2)) + rng.normal(0, 0.2, (8, 1, 2))
           ).astype(np.float32)
    got = tpnp.homography_4pt(torch.tensor(obj).expand(8, 4, 2),
                              torch.tensor(img)).numpy()
    assert got.shape == (8, 3, 3) and (got[:, 2, 2] == 1.0).all()
    for b in range(8):
        want = np.asarray(jpnp.homography_4pt(jnp.asarray(obj),
                                              jnp.asarray(img[b])))
        np.testing.assert_allclose(got[b], want,
                                   atol=H_RTOL * np.abs(want).max())
    one = tpnp.homography_4pt(torch.tensor(obj), torch.tensor(img[0]))
    np.testing.assert_array_equal(one.numpy(), got[0])


def test_dictionary_names_and_marker_image():
    """The name constants equal JAX's, and `marker_image` is bit-equal
    for every named dictionary."""
    for name in ("DICT_5X5_50", "DICT_4X4_50", "DICT_6X6_50",
                 "DICT_7X7_50", "DICT_ARUCO_ORIGINAL",
                 "DICT_APRILTAG_36H11"):
        assert getattr(tdict, name) == getattr(jdict, name)
        dname = getattr(tdict, name)
        for mid, cell in ((0, 16), (7, 5)):
            got = tdict.marker_image(tdict.load(dname), mid, cell)
            want = jdict.marker_image(jdict.load(dname), mid, cell)
            assert got.dtype == want.dtype == np.uint8
            np.testing.assert_array_equal(got, want)


def test_write_trajectory_byte_equal(tmp_path):
    rng = np.random.default_rng(2)
    times = np.arange(12) / 30.0
    q = rng.normal(size=(12, 4))
    poses = np.concatenate([rng.normal(size=(12, 3)),
                            q / np.linalg.norm(q, axis=1, keepdims=True)],
                           1).astype(np.float32)
    tio.write_trajectory(tmp_path / "port" / "t.txt", times, poses)
    jtraj.write_trajectory(tmp_path / "jax.txt", times, poses)
    assert (tmp_path / "port" / "t.txt").read_bytes() == \
        (tmp_path / "jax.txt").read_bytes()


def test_load_camera_matches_jax(tmp_path):
    """The config fallback and a calibration directory's files: the
    same intrinsics and distortion as JAX's `load_camera` (f32), on the
    device asked for."""
    np.save(tmp_path / "camera_matrix.npy",
            np.array([[900.0, 0.0, 640.0], [0.0, 905.0, 360.0],
                      [0.0, 0.0, 1.0]]))
    np.save(tmp_path / "dist_coeffs.npy",
            np.array([0.08, -0.22, 0.001, 0.002, 0.11]))
    for calib in (None, tmp_path):
        got = trun.load_camera(SlamAppConfig(input=""), calib,
                               torch.device("cpu"))
        want = jrun.load_camera(JaxAppConfig(input=""), calib)
        for f in ("fx", "fy", "cx", "cy", "dist"):
            g = getattr(got, f)
            assert g.dtype == torch.float32 and g.device.type == "cpu"
            np.testing.assert_allclose(g.numpy(),
                                       np.asarray(getattr(want, f)),
                                       rtol=1e-7)


@pytest.fixture(scope="module")
def rendered():
    """Six rendered 960x540 frames (tests/test_torch_detect.py's
    fixture: every fifth frame of a 30-frame orbit)."""
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2),
                                       jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    traj = synthetic.Trajectory(*(a[::5] for a in traj))
    return render.render_sequence(scene, traj, cam, image_size=SIZE)


def test_detect_markers_batch_matches_jax(rendered):
    want = jd.detect_markers_batch(jnp.asarray(rendered), jd.DetectorConfig())
    got = td.detect_markers_batch(torch.tensor(rendered), td.DetectorConfig())
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    assert got.mask.any()
    np.testing.assert_allclose(got.corners.numpy(), np.asarray(want.corners),
                               atol=CORNER_ATOL)


def test_detect_markers_batch_mapped_matches_jax(rendered):
    """One stream's 6 frames with a table of capacity 12, first-seen
    slots; then the second half of the frames from the first half's
    table: masks and tables equal, corners within CORNER_ATOL."""
    jcfg, tcfg = jd.DetectorConfig(capacity=12), td.DetectorConfig(
        capacity=12)
    jt = jnp.full((12,), -1, jnp.int32)
    tt = td.slot_table_init(12)
    for part in (rendered[:3], rendered[3:]):
        jc, jm_, jt = jd.detect_markers_batch_mapped(jnp.asarray(part),
                                                     jcfg, jt)
        tc, tm_, tt = td.detect_markers_batch_mapped(torch.tensor(part),
                                                     tcfg, tt)
        np.testing.assert_array_equal(tm_.numpy(), np.asarray(jm_))
        np.testing.assert_array_equal(tt.numpy(), np.asarray(jt))
        np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                   atol=CORNER_ATOL)
    assert (tt.numpy() >= 0).sum() >= 5
