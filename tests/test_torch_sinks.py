"""PyTorch port vs the JAX package: the drivers' viewers (apps/sinks.py,
run_slam --viz-2d / --viz-3d / --display / --export-video, run_offline's
pass-2 replay).

tests/test_io_apps.py's 720x405 six-frame image bundle goes through the
JAX drivers and the port's with the same flags. The JAX run_slam takes
its Pallas MEKF update in interpret mode (the port's update is its
counterpart; on the CPU the JAX default is a Cholesky gain). The
trajectories then agree to ~1e-3 m, not bit for bit, and the map dots
and the 3D views follow them: at most MAX_DIFF of an image's pixels may
differ, and each test prints the counts. The viewer path's trajectory
equals the port's run without viewers, bit for bit.
"""

import sys
import types
from pathlib import Path

import numpy as np
import pytest

from aruco_slam_tpu.apps import run_offline as joff
from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.viz import video as jvideo
from aruco_slam_tpu_torch.apps import run_offline as toff
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.apps import sinks
from aruco_slam_tpu_torch.io import read_png_rgb, read_trajectory, save_npz
from aruco_slam_tpu_torch.viz import viewer2d as tv2
from aruco_slam_tpu_torch.viz import viewer3d as tv3

MAX_DIFF = 0.005  # of an image's pixels (any channel)
TRAJ_ATOL = 2e-3  # m, tests/test_torch_slice.py's JAX/port agreement


@pytest.fixture(scope="module")
def image_seq(tmp_path_factory):
    """tests/test_io_apps.py:164's bundle: 6 rendered 720x405 frames."""
    from aruco_slam_tpu_torch.apps import make_synthetic
    path = tmp_path_factory.mktemp("imgseq") / "seq.npz"
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    save_npz(path, **make_synthetic.build(
        frames=6, markers=6, capacity=16, noise_px=0.2, camera_matrix=k,
        dist_coeffs=np.zeros(5), with_images=True, image_size=(720, 405)))
    return path


@pytest.fixture
def jax_kernel_update(monkeypatch):
    make_cfg = jrun._mekf_config
    monkeypatch.setattr(jrun, "_mekf_config", lambda *a, **k: make_cfg(
        *a, **k)._replace(pallas_update=True))


@pytest.fixture
def videos(monkeypatch):
    """The frames each package hands to write_video, by file name."""
    got = {"jax": {}, "torch": {}}

    def capture(name):
        def write_video(path, frames, fps=20):
            got[name][Path(path).name] = np.stack(list(frames))
        return write_video
    monkeypatch.setattr(jvideo, "write_video", capture("jax"))
    monkeypatch.setattr(tv2, "write_video", capture("torch"))
    monkeypatch.setattr(tv3, "write_video", capture("torch"))
    return got


def _argv(npz, out: Path, *flags):
    return ["--input", str(npz), "--trajectory", str(out / "t.txt"),
            "--map", str(out / "m.txt"), "--viz-dir", str(out / "viz"),
            *flags]


def _differ(got, want, what) -> int:
    assert got.shape == want.shape, what
    n = int((got != want).any(axis=-1).sum())
    print(f"{what}: {n} of {got.shape[0] * got.shape[1]} pixels differ")
    assert n <= MAX_DIFF * got.shape[0] * got.shape[1], what
    return n


def _compare_pngs(jdir: Path, tdir: Path, min_mean: float = 0.0):
    """Same PNG names in each viewer folder, each image within MAX_DIFF
    (JAX's through imageio, the port's through its own reader)."""
    import imageio.v3 as iio
    names = {}
    for sub in ("2d", "3d"):
        want = sorted(p.name for p in (jdir / sub).glob("*.png")) \
            if (jdir / sub).is_dir() else []
        got = sorted(p.name for p in (tdir / sub).glob("*.png")) \
            if (tdir / sub).is_dir() else []
        assert got == want, sub
        for name in got:
            img = read_png_rgb(tdir / sub / name)
            _differ(img, iio.imread(jdir / sub / name), f"{sub}/{name}")
            if sub == "2d":
                assert img.mean() > min_mean  # the real frame, not blank
        names[sub] = got
    return names


@pytest.mark.parametrize("filt,renderer", [("mekf", "mpl"),
                                           ("factorgraph", "fast")])
def test_run_slam_viewers_match_jax(image_seq, tmp_path, jax_kernel_update,
                                    videos, filt, renderer):
    flags = ["--filter", filt, "--viz-2d", "--viz-3d", "--export-video",
             "--viz-3d-renderer", renderer]
    jrun.main(_argv(image_seq, tmp_path / "jax", *flags))
    res = trun.main(_argv(image_seq, tmp_path / "torch", *flags,
                          "--platform", "cpu"))
    plain = trun.main(_argv(image_seq, tmp_path / "plain", "--filter", filt,
                            "--platform", "cpu"))
    np.testing.assert_array_equal(res.cam_traj, plain.cam_traj)
    assert Path(res.map_file).read_text() \
        == Path(plain.map_file).read_text()
    np.testing.assert_allclose(
        res.cam_traj, read_trajectory(tmp_path / "jax" / "t.txt")[1],
        atol=TRAJ_ATOL)
    names = _compare_pngs(tmp_path / "jax" / "viz",
                          tmp_path / "torch" / "viz", min_mean=60)
    assert len(names["2d"]) == len(names["3d"]) == 6
    assert sorted(videos["torch"]) == sorted(videos["jax"]) \
        == ["2d.mp4", "3d.mp4"]
    for name, frames in videos["torch"].items():
        assert len(frames) == len(videos["jax"][name]) == 6
        for i, (a, b) in enumerate(zip(frames, videos["jax"][name])):
            _differ(a, b, f"{name} frame {i}")
    assert {"step" if filt == "mekf" else "read", "draw_2d", "raster_3d",
            "png"} <= set(res.seconds)


def _fake_cv2(key):
    return types.SimpleNamespace(
        imshow=lambda *a, **k: None, waitKey=lambda ms: key,
        destroyAllWindows=lambda: None,
        setMouseCallback=lambda *a, **k: None,
        EVENT_MOUSEMOVE=0, EVENT_LBUTTONDOWN=1, EVENT_RBUTTONDOWN=2,
        EVENT_MOUSEWHEEL=10, EVENT_FLAG_LBUTTON=1, EVENT_FLAG_RBUTTON=2)


@pytest.mark.parametrize("filt", ["mekf", "factorgraph"])
def test_display_quit_key_stops_run(image_seq, tmp_path, monkeypatch, filt):
    """'q' in the live window ends the RUN (tests/test_io_apps.py's
    test for the JAX driver): one pose written and returned."""
    monkeypatch.setitem(sys.modules, "cv2", _fake_cv2(ord("q")))
    monkeypatch.setenv("DISPLAY", ":0")
    res = trun.main(_argv(image_seq, tmp_path, "--display", "--filter",
                          filt, "--platform", "cpu"))
    times, _ = read_trajectory(tmp_path / "t.txt")
    assert len(times) == 1 and res.cam_traj.shape == (1, 7)
    assert res.obs_mask.shape[0] == 1


def test_display_headless_note(image_seq, tmp_path, monkeypatch, capsys):
    """Without a display server --display prints JAX's notes and exports
    the overlay PNGs; the trajectory is the run's without viewers."""
    monkeypatch.delenv("DISPLAY", raising=False)
    monkeypatch.delenv("WAYLAND_DISPLAY", raising=False)
    res = trun.main(_argv(image_seq, tmp_path, "--display", "--platform",
                          "cpu"))
    out = capsys.readouterr().out
    assert "--display falls back to headless PNG/mp4 export" in out
    assert "live 3D map disabled" in out
    assert len(list((tmp_path / "viz" / "2d").glob("frame_*.png"))) == 6
    plain = trun.main(_argv(image_seq, tmp_path / "plain", "--platform",
                            "cpu"))
    np.testing.assert_array_equal(res.cam_traj, plain.cam_traj)


def test_display_3d_free_navigation(monkeypatch):
    """The live 3D window's orbit, pan, zoom and 'f' (tests/test_io_apps.py's
    test for the JAX sink)."""
    cbs = {}
    fake = _fake_cv2(255)
    fake.setMouseCallback = lambda win, cb: cbs.__setitem__("cb", cb)
    monkeypatch.setitem(sys.modules, "cv2", fake)
    monkeypatch.setenv("DISPLAY", ":0")
    s = sinks.Live3DDisplaySink()
    pose = np.array([0.2, 0.1, 0.5, 1.0, 0, 0, 0])
    s.view_frame(pose, np.zeros((0, 3)), [])
    assert "cb" in cbs and s.current_view() is None
    cb = cbs["cb"]
    cb(fake.EVENT_LBUTTONDOWN, 100, 100, 0, None)
    cb(fake.EVENT_MOUSEMOVE, 140, 90, fake.EVENT_FLAG_LBUTTON, None)
    rv1, _ = s.current_view()
    cb(fake.EVENT_MOUSEMOVE, 180, 80, fake.EVENT_FLAG_LBUTTON, None)
    rv2, _ = s.current_view()
    assert not np.allclose(rv1, rv2)         # orbit moved the view
    r_before = s.free_view.radius
    cb(fake.EVENT_MOUSEWHEEL, 0, 0, 1, None)
    assert s.free_view.radius < r_before     # wheel zoomed in
    tgt_before = s.free_view.target.copy()
    cb(fake.EVENT_RBUTTONDOWN, 50, 50, 0, None)
    cb(fake.EVENT_MOUSEMOVE, 70, 60, fake.EVENT_FLAG_RBUTTON, None)
    assert not np.allclose(s.free_view.target, tgt_before)  # panned
    fake.waitKey = lambda ms: ord("f")       # toggle back to follow
    s.view_frame(pose, np.zeros((0, 3)), [])
    assert s.follow and s.current_view() is None


def test_run_offline_replay_matches_jax(image_seq, tmp_path, videos):
    """Pass-2 replay of the smoothed poses and the final map: the same
    PNGs as the JAX run_offline's within MAX_DIFF, the trajectory equal
    to the port's run without viewers."""
    flags = ["--iters", "5", "--viz-2d", "--viz-3d", "--export-video"]
    joff.main(_argv(image_seq, tmp_path / "jax", *flags))
    res = toff.main(_argv(image_seq, tmp_path / "torch", *flags,
                          "--platform", "cpu"))
    plain = toff.main(_argv(image_seq, tmp_path / "plain", "--iters", "5",
                            "--platform", "cpu"))
    np.testing.assert_array_equal(res.cam_traj, plain.cam_traj)
    names = _compare_pngs(tmp_path / "jax" / "viz",
                          tmp_path / "torch" / "viz", min_mean=60)
    assert len(names["2d"]) == len(names["3d"]) == 6
    assert sorted(videos["torch"]) == sorted(videos["jax"])
    for name, frames in videos["torch"].items():
        for i, (a, b) in enumerate(zip(frames, videos["jax"][name])):
            _differ(a, b, f"{name} frame {i}")


def test_resume_with_viewers_matches_jax(image_seq, tmp_path,
                                         jax_kernel_update):
    """Both drivers resume from the same JAX checkpoint (frame 3) with
    --viz-2d: overlays numbered from 0 for the three resumed frames, each
    within MAX_DIFF of JAX's; the port's resumed trajectory equals its
    resumed run without viewers."""
    ck = tmp_path / "ck.npz"
    jrun.main(_argv(image_seq, tmp_path / "full", "--checkpoint-every",
                    "3", "--checkpoint", str(ck)))
    resume = ["--resume", str(ck), "--viz-2d"]
    jrun.main(_argv(image_seq, tmp_path / "jax", *resume))
    res = trun.main(_argv(image_seq, tmp_path / "torch", *resume,
                          "--platform", "cpu"))
    plain = trun.main(_argv(image_seq, tmp_path / "plain", "--resume",
                            str(ck), "--platform", "cpu"))
    np.testing.assert_array_equal(res.cam_traj, plain.cam_traj)
    np.testing.assert_allclose(
        res.cam_traj, read_trajectory(tmp_path / "jax" / "t.txt")[1],
        atol=TRAJ_ATOL)
    names = _compare_pngs(tmp_path / "jax" / "viz",
                          tmp_path / "torch" / "viz", min_mean=60)
    assert names["2d"] == [f"frame_{i:05d}.png" for i in range(3)]


def test_viewer_checkpoints_per_frame(image_seq, tmp_path):
    """With viewers the MEKF checkpoints every N frames as it steps (JAX's
    per-frame branch): the resumed run equals the uninterrupted one."""
    ck = tmp_path / "ck.npz"
    full = trun.main(_argv(image_seq, tmp_path / "full", "--viz-2d",
                           "--checkpoint-every", "4", "--checkpoint",
                           str(ck), "--platform", "cpu"))
    res = trun.main(_argv(image_seq, tmp_path / "res", "--viz-2d",
                          "--resume", str(ck), "--platform", "cpu"))
    np.testing.assert_array_equal(res.cam_traj, full.cam_traj)
    assert len(list((tmp_path / "res" / "viz" / "2d").glob("*.png"))) == 2


REFUSALS = {
    # case: (blocked modules, flags, the message's words)
    "no-matplotlib": (("matplotlib",), ["--viz-3d"],
                      "--viz-3d-renderer fast"),
    "no-cv2-no-pyav": (("cv2", "av"), ["--viz-2d", "--export-video"],
                       "--export-video needs"),
    "no-cv2-no-imageio": (("cv2", "imageio"),
                          ["--viz-3d", "--viz-3d-renderer", "fast",
                           "--export-video"], "--export-video needs")}


@pytest.mark.parametrize("blocked,flags,words", REFUSALS.values(),
                         ids=REFUSALS.keys())
@pytest.mark.parametrize("driver", [trun, toff],
                         ids=["run_slam", "run_offline"])
def test_viewer_flags_refuse_without_their_library(image_seq, tmp_path,
                                                   monkeypatch, driver,
                                                   blocked, flags, words):
    """Where the library a viewer needs is missing, the driver refuses
    before it reads any input, and writes nothing."""
    for name in blocked:
        monkeypatch.setitem(sys.modules, name, None)

    def no_input(*a, **k):
        raise AssertionError("input read before the refusal")
    monkeypatch.setattr(trun, "NpzSource", no_input)
    monkeypatch.setattr(toff, "NpzSource", no_input)
    out = tmp_path / "out"
    with pytest.raises(ImportError, match=words):
        driver.main(_argv(image_seq, out, *flags, "--platform", "cpu"))
    assert not out.exists()
