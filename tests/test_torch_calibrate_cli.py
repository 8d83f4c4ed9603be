"""The port's calibration CLI (apps/calibrate.py) against the JAX
package's, and its PNG writer, on the CPU.

Both CLIs run tests/test_calibrate.py test_cli_end_to_end_with_preview's
command (the reference's 7x5 ChArUco board, AprilTag 36h11, 40
iterations, 2 previews) on the same 5 views rendered at 1280x720
(seed 7). Tolerances: the saved camera matrix and distortion within
rtol 1e-6 of JAX's; the previews, read by imageio, within one gray level
with fewer than 100 of their 921,600 pixels off by one (the undistortion
runs at float32 in both, in another summation order).
"""

import os
import subprocess
import sys
from pathlib import Path

import imageio.v3 as iio
import numpy as np
import pytest
import torch

from aruco_slam_tpu.apps import calibrate as jcli
from aruco_slam_tpu_torch import io as tio
from aruco_slam_tpu_torch.apps import calibrate as tcli
from aruco_slam_tpu_torch.bench import render as trender
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.ops import calibrate as tcal
from aruco_slam_tpu_torch.ops import dictionary as tdict
from test_calibrate import DIST_TRUE, K_TRUE, SIZE
from test_torch_calibrate import EXTENT, _charuco_poses

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
ARGS = ["--board", "charuco", "--grid", "7x5", "--square-size", "0.03",
        "--marker-size", "0.015", "--dict", "apriltag_36h11",
        "--iters", "40", "--preview", "2"]


@pytest.fixture(scope="module")
def views(tmp_path_factory):
    """5 views of the board (test_cli_end_to_end_with_preview's seed 7),
    rendered by the port, in an npz."""
    board = tcal.charuco_board(7, 5, 0.03, 0.015)
    bmp = trender.charuco_bitmap(board, tdict.load("apriltag_36h11"), 96)
    ims = trender.render_plane_views(
        bmp, EXTENT, tcam.CameraModel.from_matrix(K_TRUE, DIST_TRUE),
        _charuco_poses(5, seed=7), SIZE)
    path = tmp_path_factory.mktemp("calib") / "views.npz"
    np.savez_compressed(path, images=ims)
    return path, ims


@pytest.fixture(scope="module")
def both(views, tmp_path_factory):
    root = tmp_path_factory.mktemp("calib_out")
    jcli.main(["--images", str(views[0]), *ARGS,
               "--out", str(root / "jax")])
    run = tcli.main(["--images", str(views[0]), *ARGS, "--platform", "cpu",
                     "--out", str(root / "torch")])
    return root / "jax", root / "torch", run


def test_cli_matches_jax(both, views):
    jdir, tdir, run = both
    for name in ("camera_matrix.npy", "dist_coeffs.npy"):
        want, got = np.load(jdir / name), np.load(tdir / name)
        assert got.shape == want.shape and got.dtype == want.dtype
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-9)
    k = run.result.camera_matrix
    np.testing.assert_array_equal(k, np.load(tdir / "camera_matrix.npy"))
    np.testing.assert_allclose(k[0, 0], 900.0, rtol=0.03)
    np.testing.assert_allclose(k[1, 2], 360.0, atol=12)
    assert run.result.rms_px < 0.6
    assert set(run.seconds) == {"detect", "interpolate", "refine",
                                "calibrate", "preview"}


def test_cli_previews_match_jax(both, views):
    jdir, tdir, run = both
    names = sorted(p.name for p in (jdir / "preview").iterdir())
    assert names == ["undistorted_000.png", "undistorted_001.png"]
    assert [p.name for p in run.previews] == names
    for name in names:
        want = iio.imread(jdir / "preview" / name)
        got = iio.imread(tdir / "preview" / name)
        assert got.shape == want.shape == views[1][0].shape
        assert got.dtype == np.uint8 and got.max() > 100
        diff = np.abs(got.astype(int) - want)
        assert diff.max() <= 1 and (diff > 0).sum() < 100, (diff > 0).sum()
        np.testing.assert_array_equal(tio.read_png_gray(tdir / "preview"
                                                        / name), got)


def test_cli_reads_an_image_directory(views, both, tmp_path):
    """--images DIR (PNG files, read with imageio) gives the npz run's
    calibration."""
    for i, im in enumerate(views[1]):
        tio.write_png_gray(tmp_path / "views" / f"v{i}.png", im)
    run = tcli.main(["--images", str(tmp_path / "views"), *ARGS[:-2],
                     "--platform", "cpu", "--out", str(tmp_path / "out")])
    np.testing.assert_array_equal(run.result.camera_matrix,
                                  both[2].result.camera_matrix)
    assert run.previews == [] and "preview" not in run.seconds


@pytest.mark.parametrize("shape", [(1, 1), (37, 53), (720, 1280)])
def test_png_writer_read_by_imageio(tmp_path, shape):
    img = np.random.default_rng(sum(shape)).integers(0, 256, shape,
                                                     dtype=np.uint8)
    path = tmp_path / "sub" / "im.png"
    tio.write_png_gray(path, img)
    got = iio.imread(path)
    assert got.dtype == np.uint8
    np.testing.assert_array_equal(got, img)
    np.testing.assert_array_equal(tio.read_png_gray(path), img)


def test_png_writer_and_reader_refuse(tmp_path):
    with pytest.raises(ValueError, match="uint8"):
        tio.write_png_gray(tmp_path / "a.png", np.zeros((4, 4), np.float32))
    with pytest.raises(ValueError, match="uint8"):
        tio.write_png_gray(tmp_path / "a.png", np.zeros((4, 4, 3), np.uint8))
    iio.imwrite(tmp_path / "rgb.png", np.zeros((4, 4, 3), np.uint8))
    with pytest.raises(ValueError, match="grayscale"):
        tio.read_png_gray(tmp_path / "rgb.png")
    (tmp_path / "x.png").write_bytes(b"not a png")
    with pytest.raises(ValueError, match="not a PNG"):
        tio.read_png_gray(tmp_path / "x.png")


def test_cli_parses_every_jax_flag(monkeypatch):
    """Every flag of the JAX CLI with its JAX default, plus --platform
    (default cuda)."""
    import argparse

    jax_defaults = {}

    def record(self, args=None, namespace=None):
        jax_defaults.update({a.dest: a.default for a in self._actions})
        raise SystemExit(0)

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", record)
    with pytest.raises(SystemExit):
        jcli.main(["--images", "x.npz"])
    monkeypatch.undo()
    port = {a.dest: a.default for a in tcli._parser()._actions}
    assert port.pop("platform") == "cuda"
    assert jax_defaults.pop("platform") is None
    assert port == jax_defaults


def test_platform_cuda_refuses_without_card(views, tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --platform cuda is valid")
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    proc = subprocess.run(
        [sys.executable, "-m", "aruco_slam_tpu_torch.apps.calibrate",
         "--images", str(views[0]), *ARGS, "--out", str(tmp_path / "o")],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert not (tmp_path / "o").exists()
