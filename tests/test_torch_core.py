"""PyTorch port vs the JAX package: quaternions, camera, PnP, fixtures.

The same numpy-seeded float32 inputs go through both packages
(tests/conftest.py turns on jax_enable_x64, so both sides are cast to
f32 by hand). Tolerances are stated beside each comparison.
"""

import ast
import time
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import render as jrender
from aruco_slam_tpu.bench import synthetic as jsyn
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.core import lie as jlie
from aruco_slam_tpu.core import quaternion as jquat
from aruco_slam_tpu.ops import pnp as jpnp
from aruco_slam_tpu_torch.bench import render as trender
from aruco_slam_tpu_torch.bench import synthetic as tsyn
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.core import lie as tlie
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


def test_lie_matches_jax():
    """skew and the inverse right Jacobian (f64, 1e-12 absolute): random
    rotation vectors, angles near zero (both sides of each package's
    Taylor switch) and near pi."""
    rng = np.random.default_rng(4)
    axes = rng.normal(size=(6, 3))
    axes /= np.linalg.norm(axes, axis=-1, keepdims=True)
    angles = np.array([0.0, 1e-7, 2e-4, 1e-3 * 1.01, 1.0, np.pi - 1e-4])
    w = np.concatenate([rng.normal(0, 1.0, (64, 3)),
                        axes * angles[:, None]])
    np.testing.assert_array_equal(tlie.skew(torch.tensor(w)).numpy(),
                                  np.asarray(jlie.skew(jnp.asarray(w))))
    np.testing.assert_allclose(
        tlie.so3_right_jacobian_inv(torch.tensor(w)).numpy(),
        np.asarray(jlie.so3_right_jacobian_inv(jnp.asarray(w))), atol=1e-12)


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


# every baked table of the JAX package (a fixed set of files)
JAX_TABLES = sorted(p.name for p in (Path(jpnp.__file__).parent / "data")
                    .glob("*.npy"))


@pytest.mark.parametrize("name", JAX_TABLES)
def test_dictionary_data_is_the_jax_packages(name):
    """The port ships its own copy of each dictionary table, byte-equal
    to the JAX package's, and reads it from inside its own package."""
    from aruco_slam_tpu_torch.ops import dictionary as tdict
    port_pkg = Path(tdict.__file__).resolve().parents[1]
    assert tdict.DATA.resolve().is_relative_to(port_pkg)
    assert (tdict.DATA / name).read_bytes() \
        == (Path(jpnp.__file__).parent / "data" / name).read_bytes()


def test_video_source_matches_jax(tmp_path):
    """A small MJPG .avi decoded by the port's VideoSource and by the
    JAX package's: the same frames and timestamps, bit for bit (both
    take the cv2 route where pyav is not installed)."""
    import cv2
    from aruco_slam_tpu.io.sources import VideoSource as JVideo
    from aruco_slam_tpu_torch import io as tio
    rng = np.random.default_rng(11)
    path = tmp_path / "clip.avi"
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 25.0,
                          (96, 64))
    assert out.isOpened()
    for _ in range(6):
        out.write(cv2.GaussianBlur(rng.integers(0, 256, (64, 96, 3),
                                                dtype=np.uint8), (5, 5), 0))
    out.release()
    for size in (None, (48, 32)):
        src, ref = tio.VideoSource(path, size), JVideo(path, size)
        assert len(src) == len(ref) == 6
        got, want = list(src.frames()), list(ref.frames())
        assert len(got) == len(want) == 6
        for (ts, g), (ts_j, g_j) in zip(got, want):
            assert ts == ts_j
            assert g.dtype == g_j.dtype and np.array_equal(g, g_j)
    assert [ts for ts, _ in tio.video_frames(path)] == [ts for ts, _ in want]


@pytest.mark.parametrize("host_lib", ["native", "numpy"])
def test_video_source_imageio_route_matches_jax(monkeypatch, host_lib):
    """The imageio/pyav route (a stand-in imageio.v3 serving RGB frames,
    since pyav is not installed here): the port's numpy gray+resize gives
    the frames and timestamps of the JAX VideoSource, whose gray+resize
    is the native host library where it is built (`native`) and its
    numpy fallback where it is not (`numpy`)."""
    import sys
    import types
    from aruco_slam_tpu.io import native
    from aruco_slam_tpu.io.sources import VideoSource as JVideo
    from aruco_slam_tpu_torch import io as tio
    rng = np.random.default_rng(12)
    rgb = rng.integers(0, 256, (5, 67, 101, 3), dtype=np.uint8)
    rgb[0] = 255  # the largest weighted sum
    v3 = types.SimpleNamespace(
        improps=lambda path, plugin: types.SimpleNamespace(shape=rgb.shape),
        imiter=lambda path, plugin: iter(rgb))
    monkeypatch.setitem(sys.modules, "imageio",
                        types.SimpleNamespace(v3=v3))
    monkeypatch.setitem(sys.modules, "imageio.v3", v3)
    if host_lib == "numpy":
        monkeypatch.setattr(native, "get_lib", lambda: None)
    elif native.get_lib() is None:
        pytest.skip("the native host library could not be built here")
    for size in (None, (48, 32), (160, 90)):
        src, ref = tio.VideoSource("clip.mp4", size), JVideo("clip.mp4", size)
        assert src._mode == ref._mode == "imageio"
        assert len(src) == len(ref) == 5
        got, want = list(src.frames()), list(ref.frames())
        assert len(got) == len(want) == 5
        for (ts, g), (ts_j, g_j) in zip(got, want):
            assert ts == ts_j
            assert g.dtype == g_j.dtype and np.array_equal(g, g_j)


def _frames(n, shape=(8, 8)):
    for i in range(n):
        yield i / 30.0, np.full(shape, i, np.uint8)


def test_prefetch_source_order_values_timestamps():
    """tests/test_utils_native.py's prefetch case on the port's ring: 10
    frames at capacity 3 come out in order, values and f64 timestamps
    exact, each a uint8 copy of the frame shape."""
    from aruco_slam_tpu_torch import io as tio
    src = tio.PrefetchingFrameSource(_frames(10), (8, 8), capacity=3)
    got = list(src)
    assert len(got) == 10
    assert got[5][1][0, 0] == 5
    assert abs(got[5][0] - 5 / 30.0) < 1e-9
    for (ts, g), (ts_w, g_w) in zip(got, _frames(10)):
        assert ts == ts_w and type(ts) is float
        assert g.dtype == np.uint8 and np.array_equal(g, g_w)
    src.thread.join(timeout=10)
    assert not src.thread.is_alive()


def test_prefetch_source_early_break_ends_the_thread():
    """A consumer that stops early leaves no thread blocked on the full
    queue, and the decode iterator is closed."""
    from aruco_slam_tpu_torch import io as tio
    closed = []

    def endless():
        try:
            i = 0
            while True:
                yield float(i), np.zeros((4, 4), np.uint8)
                i += 1
        finally:
            closed.append(True)

    src = tio.PrefetchingFrameSource(endless(), (4, 4), capacity=2)
    for ts, _ in src:
        if ts == 3.0:
            break
    src.thread.join(timeout=10)
    assert not src.thread.is_alive() and closed == [True]


def test_prefetch_source_never_iterated_decodes_nothing():
    """A consumer that fails before it iterates (the source is built, the
    camera or the front end's checks then raise) leaves no thread and no
    decode running, and `close` closes the decode iterator."""
    from aruco_slam_tpu_torch import io as tio
    decoded = []

    def counted():
        for item in _frames(40):
            decoded.append(item[0])
            yield item

    frames = counted()
    src = tio.PrefetchingFrameSource(frames, (8, 8), capacity=2)
    time.sleep(0.2)
    assert not src.thread.is_alive() and decoded == []
    src.close()
    assert next(frames, None) is None and decoded == []
    assert list(src) == []


def test_prefetch_source_raises_the_decode_error():
    """An exception in the decode thread reaches the consumer after the
    frames decoded before it (a truncated video is not a shorter run)."""
    from aruco_slam_tpu_torch import io as tio

    def truncated():
        yield from _frames(4)
        raise OSError("truncated stream")

    got = []
    with pytest.raises(OSError, match="truncated stream"):
        for item in tio.PrefetchingFrameSource(truncated(), (8, 8), 2):
            got.append(item)
    assert [ts for ts, _ in got] == [i / 30.0 for i in range(4)]


def _imports(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_imports_nothing_of_jax():
    """No module of the port, and not chip_smoke.py, imports jax or the
    JAX package (names in docstrings and comments are not imports)."""
    root = Path(__file__).resolve().parents[1]
    files = sorted((root / "aruco_slam_tpu_torch").rglob("*.py"))
    files.append(root / "chip_smoke.py")
    bad = [(f.name, mod) for f in files
           for mod in _imports(ast.parse(f.read_text(encoding="utf-8")))
           if mod.split(".")[0] in ("jax", "jaxlib", "aruco_slam_tpu")]
    assert len(files) > 20 and not bad
