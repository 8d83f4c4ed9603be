"""PyTorch port vs the JAX package: quaternions, camera, PnP, fixtures.

The same numpy-seeded float32 inputs go through both packages
(tests/conftest.py turns on jax_enable_x64, so both sides are cast to
f32 by hand). Tolerances are stated beside each comparison.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import render as jrender
from aruco_slam_tpu.bench import synthetic as jsyn
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.core import quaternion as jquat
from aruco_slam_tpu.ops import pnp as jpnp
from aruco_slam_tpu_torch.bench import render as trender
from aruco_slam_tpu_torch.bench import synthetic as tsyn
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.core import quaternion as tquat
from aruco_slam_tpu_torch.ops import pnp as tpnp

torch.set_num_threads(2)

K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
K1 = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
               [0.0, 0.0, 1.0]])

# f32 roundoff of a few chained products of O(1) values
ATOL_UNIT = 2e-6


def f32(a):
    return np.asarray(a, np.float32)


def both(a):
    return jnp.asarray(f32(a)), torch.tensor(f32(a))


def rand_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=-1, keepdims=True)


@pytest.mark.parametrize("fn", ["normalize", "conjugate", "to_matrix",
                                "from_matrix", "to_rotvec"])
def test_quaternion_unary(fn):
    rng = np.random.default_rng(0)
    q = rand_quats(rng, 64) * rng.uniform(0.5, 2.0, (64, 1))
    if fn in ("to_matrix", "from_matrix", "to_rotvec"):
        q = q / np.linalg.norm(q, axis=-1, keepdims=True)
    jq, tq = both(q)
    if fn == "from_matrix":
        jq = jquat.to_matrix(jq)
        tq = torch.tensor(np.asarray(jq))
    want = np.asarray(getattr(jquat, fn)(jq))
    got = getattr(tquat, fn)(tq).numpy()
    np.testing.assert_allclose(got, want, atol=4 * ATOL_UNIT)


def test_quaternion_binary_and_rotvec():
    rng = np.random.default_rng(1)
    ja, ta = both(rand_quats(rng, 64))
    jb, tb = both(rand_quats(rng, 64))
    jv, tv = both(rng.normal(size=(64, 3)))
    np.testing.assert_allclose(tquat.multiply(ta, tb).numpy(),
                               np.asarray(jquat.multiply(ja, jb)),
                               atol=ATOL_UNIT)
    np.testing.assert_allclose(tquat.rotate(ta, tv).numpy(),
                               np.asarray(jquat.rotate(ja, jv)),
                               atol=4 * ATOL_UNIT)
    # rotation vectors around zero hit the Taylor branch too
    rv = rng.normal(size=(64, 3)) * np.r_[np.full(32, 1.0),
                                          np.full(32, 1e-7)][:, None]
    jr, tr = both(rv)
    np.testing.assert_allclose(tquat.from_rotvec(tr).numpy(),
                               np.asarray(jquat.from_rotvec(jr)),
                               atol=ATOL_UNIT)


def test_camera_parity():
    rng = np.random.default_rng(2)
    jc = jcam.CameraModel.from_matrix(jnp.asarray(f32(K1)),
                                      jnp.asarray(f32(DIST)))
    tc = tcam.CameraModel.from_matrix(f32(K1), f32(DIST))
    pts = np.c_[rng.uniform(-1.5, 1.5, (200, 2)), rng.uniform(1, 6, 200)]
    jp, tp = both(pts)
    px_j = np.asarray(jcam.project(jc, jp))
    px_t = tcam.project(tc, tp).numpy()
    # pixels: f32 ulp at ~2000 px is 1.2e-4
    np.testing.assert_allclose(px_t, px_j, atol=5e-4)
    ju, tu = both(px_j)
    np.testing.assert_allclose(tcam.pixel_to_ray(tc, tu).numpy(),
                               np.asarray(jcam.pixel_to_ray(jc, ju)),
                               atol=1e-5)
    xy = rng.uniform(-0.6, 0.6, (200, 2))
    jx, tx = both(xy)
    np.testing.assert_allclose(tcam.distort(tc, tx).numpy(),
                               np.asarray(jcam.distort(jc, jx)), atol=1e-5)
    np.testing.assert_allclose(tcam.undistort(tc, tx).numpy(),
                               np.asarray(jcam.undistort(jc, jx)),
                               atol=1e-5)


@pytest.fixture(scope="module")
def corner_obs():
    """1080p corner observations with 0.3 px noise (JAX fixtures)."""
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K1),
                                       jnp.asarray(DIST))
    scene = jsyn.make_wall_scene(num_markers=10, seed=0)
    traj = jsyn.make_orbit_trajectory(num_frames=12)
    corners, mask = jsyn.observe_corners(scene, traj, cam, 16,
                                         noise_px=0.3)
    return f32(corners[mask]), scene.marker_size


def test_pnp_matches_jax(corner_obs):
    corners, size = corner_obs
    jc = jcam.CameraModel.from_matrix(jnp.asarray(f32(K1)),
                                      jnp.asarray(f32(DIST)))
    tc = tcam.CameraModel.from_matrix(f32(K1), f32(DIST))
    want = jpnp.solve_square_pnp(jc, jnp.asarray(corners), size)
    got = tpnp.solve_square_pnp(tc, torch.tensor(corners), size)
    w = {k: np.asarray(v) for k, v in want._asdict().items()}
    g = {k: v.numpy() for k, v in got._asdict().items()}
    assert g["t_cl"].shape == w["t_cl"].shape == (len(corners), 3)
    # f32 solves of the same formulas; the per-corner Gauss-Newton
    # terms are summed in the reference's order, so only op fusion
    # differs. Depth along the ray is the ill-conditioned direction of
    # a small distant marker and magnifies that roundoff: 5e-4 m at
    # 3 m range (the 0.3 px corner noise moves it by centimeters)
    np.testing.assert_allclose(g["t_cl"], w["t_cl"], atol=5e-4)
    # the tilt of a small distant marker is as ill-conditioned as its
    # depth; quaternion signs are canonical (from_matrix's pivot)
    np.testing.assert_allclose(g["q_cl"], w["q_cl"], atol=5e-4)
    np.testing.assert_allclose(g["rvec"], w["rvec"], atol=1e-3)
    np.testing.assert_allclose(g["err"], w["err"], atol=1e-3)
    np.testing.assert_allclose(g["err2"], w["err2"], rtol=1e-3, atol=1e-3)


def test_pnp_normalized_and_object_points(corner_obs):
    corners, size = corner_obs
    tc = tcam.CameraModel.from_matrix(f32(K1), f32(DIST))
    xy = tcam.pixel_to_ray(tc, torch.tensor(corners))
    want = jpnp.solve_square_pnp_normalized
    for i in range(0, len(corners), 25):
        w = want(jnp.asarray(xy[i].numpy()), size)
        g = tpnp.solve_square_pnp_normalized(xy[i:i + 1], size)
        np.testing.assert_allclose(g.t_cl[0].numpy(), np.asarray(w.t_cl),
                                   atol=5e-4)
        np.testing.assert_allclose(g.err[0].numpy(), np.asarray(w.err),
                                   atol=1e-6)
    np.testing.assert_allclose(tpnp.square_object_points(size).numpy(),
                               np.asarray(jpnp.square_object_points(size)),
                               atol=0)


def test_h_square_entries(corner_obs):
    corners, _ = corner_obs
    u = [corners[:, k, 0] / 1000.0 for k in range(4)]
    v = [corners[:, k, 1] / 1000.0 for k in range(4)]
    want = jpnp._h_square_entries(jnp.asarray(np.float32(3.5)),
                                  [jnp.asarray(a) for a in u],
                                  [jnp.asarray(a) for a in v])
    got = tpnp._h_square_entries(torch.tensor(3.5),
                                 [torch.tensor(a) for a in u],
                                 [torch.tensor(a) for a in v])
    for i in range(3):
        for j in range(3):
            np.testing.assert_allclose(got[i][j].numpy(),
                                       np.asarray(want[i][j]), rtol=1e-5,
                                       atol=1e-6)


def test_synthetic_fixtures_match():
    js = jsyn.make_wall_scene(num_markers=10, seed=3)
    ts = tsyn.make_wall_scene(num_markers=10, seed=3)
    np.testing.assert_array_equal(ts.marker_pos, js.marker_pos)
    np.testing.assert_array_equal(ts.marker_quat, js.marker_quat)
    jt = jsyn.make_orbit_trajectory(num_frames=20)
    tt = tsyn.make_orbit_trajectory(num_frames=20)
    np.testing.assert_array_equal(tt.cam_t, jt.cam_t)
    np.testing.assert_array_equal(tt.cam_q, jt.cam_q)
    jc = jcam.CameraModel.from_matrix(jnp.asarray(K2), jnp.asarray(DIST))
    tc = tcam.CameraModel.from_matrix(K2, DIST)
    jcor, jm = jsyn.observe_corners(js, jt, jc, 16, noise_px=0.2,
                                    image_size=(960, 540))
    tcor, tm = tsyn.observe_corners(ts, tt, tc, 16, noise_px=0.2,
                                    image_size=(960, 540))
    np.testing.assert_array_equal(tm, jm)
    # both project in float64
    np.testing.assert_allclose(tcor, jcor, atol=1e-9)


def test_renderer_matches_jax():
    """Identical pixels except at most 0.1% (marker edges, where a
    float64 ray lands within roundoff of a cell boundary)."""
    jc = jcam.CameraModel.from_matrix(jnp.asarray(K2), jnp.asarray(DIST))
    tc = tcam.CameraModel.from_matrix(K2, DIST)
    scene = jsyn.make_wall_scene(num_markers=10, seed=0)
    traj = jsyn.make_orbit_trajectory(num_frames=30)
    traj = jsyn.Trajectory(*(a[::6] for a in traj))
    want = jrender.render_sequence(scene, traj, jc, image_size=(960, 540))
    got = trender.render_sequence(scene, traj, tc, image_size=(960, 540))
    assert got.shape == want.shape and got.dtype == np.uint8
    assert (want != trender.BACKGROUND).any()
    assert (got != want).mean() <= 1e-3


def test_app_config_matches_jax():
    """The port's SlamAppConfig keeps the JAX package's fields and
    defaults (run_slam's filter and detector settings come from it)."""
    import dataclasses
    from aruco_slam_tpu.config import SlamAppConfig as JCfg
    from aruco_slam_tpu_torch.config import SlamAppConfig as TCfg
    want = dataclasses.asdict(JCfg())
    got = dataclasses.asdict(TCfg())
    assert list(got) == list(want)
    for k, v in want.items():
        np.testing.assert_array_equal(got[k], v, err_msg=k)


@pytest.mark.parametrize("name", ["dict_5x5_50", "apriltag_36h11",
                                  "dict_4x4_1000"])
def test_dictionary_tables_match_jax(name):
    from aruco_slam_tpu.ops import dictionary as jdict
    from aruco_slam_tpu_torch.ops import dictionary as tdict
    want, got = jdict.load(name), tdict.load(name)
    for field in ("bits", "table", "table_ids", "table_rot"):
        np.testing.assert_array_equal(getattr(got, field),
                                      getattr(want, field))
        assert getattr(got, field).dtype == getattr(want, field).dtype
    assert tdict.names() == jdict.names()
    with pytest.raises(ValueError):
        tdict.load("no_such_dictionary")


def test_io_formats_match_jax(tmp_path):
    """Files the port writes are byte-identical to the JAX package's
    and read back by either package's readers; ATE agrees."""
    from aruco_slam_tpu import io as jio
    from aruco_slam_tpu.bench import ate as jate
    from aruco_slam_tpu.io.sources import NpzSource as JNpz
    from aruco_slam_tpu_torch import io as tio
    from aruco_slam_tpu_torch.bench import ate as tate
    rng = np.random.default_rng(9)
    poses = np.c_[rng.normal(size=(6, 3)), rand_quats(rng, 6)]
    times = np.arange(6) / 30.0
    for mod, name in ((jio, "j"), (tio, "t")):
        with mod.TrajectoryWriter(tmp_path / f"{name}.txt") as w:
            for ts, p in zip(times, poses):
                w.write(float(ts), p)
        mod.save_map(tmp_path / f"{name}_map.txt", [3, 7],
                     poses[:2, :3], np.abs(poses[2:4, :3]))
    for f in ("%s.txt", "%s_map.txt"):
        assert (tmp_path / (f % "t")).read_bytes() \
            == (tmp_path / (f % "j")).read_bytes()
    t_times, t_poses = tio.read_trajectory(tmp_path / "t.txt")
    j_times, j_poses = jio.read_trajectory(tmp_path / "t.txt")
    np.testing.assert_array_equal(t_times, j_times)
    np.testing.assert_array_equal(t_poses, j_poses)
    for a, b in zip(tio.load_map(tmp_path / "t_map.txt"),
                    jio.load_map(tmp_path / "t_map.txt")):
        np.testing.assert_array_equal(a, b)
    tio.save_npz(tmp_path / "s.npz", times=times, gt_cam_t=poses[:, :3])
    t_src, j_src = tio.NpzSource(tmp_path / "s.npz"), \
        JNpz(tmp_path / "s.npz")
    np.testing.assert_array_equal(t_src.times, j_src.times)
    assert t_src.has("gt_cam_t") and not t_src.has("images")
    est = poses[:, :3] + 0.01 * rng.normal(size=(6, 3))
    assert tate.ate_rmse(est, poses[:, :3]) \
        == pytest.approx(jate.ate_rmse(est, poses[:, :3]), abs=1e-12)
    assert tio.is_video("a.MP4") and not tio.is_video("a.npz")
