"""PyTorch port vs the JAX package: the viewers (viz/) and the RGB PNG.

The same seeded numpy inputs go through the JAX package's viz modules
and the port's. Every primitive, view and renderer is bit-identical at
float64 (the JAX tests run with x64 on, so its projections are float64
too): the raster primitives round to integer pixels, so an equal image
needs equal float64 inputs, not merely close ones.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.viz import draw as jdraw
from aruco_slam_tpu.viz import render3d as jr3
from aruco_slam_tpu.viz import viewer2d as jv2
from aruco_slam_tpu.viz import viewer3d as jv3
from aruco_slam_tpu_torch import io as tio
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.viz import draw as tdraw
from aruco_slam_tpu_torch.viz import render3d as tr3
from aruco_slam_tpu_torch.viz import viewer2d as tv2
from aruco_slam_tpu_torch.viz import viewer3d as tv3

K = np.array([[500.0, 0.0, 480.0], [0.0, 500.0, 270.0], [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])


def _canvas(rng, h=120, w=160):
    return rng.integers(0, 256, (h, w, 3), dtype=np.uint8)


def _unit_quats(rng, n):
    q = rng.normal(size=(n, 4))
    return q / np.linalg.norm(q, axis=1, keepdims=True)


@pytest.mark.parametrize("seed", range(4))
def test_draw_primitives_bit_identical(seed):
    """Circles, lines, polylines, polygons and text, on and off the
    canvas (centres and ends up to 60 px outside it)."""
    rng = np.random.default_rng(seed)
    base = _canvas(rng)
    pts = rng.uniform(-60, 220, (12, 2))
    for fn, args in (
            ("draw_circle", lambda: (pts[0], int(rng.integers(1, 30)),
                                     (255, 0, 0))),
            ("draw_line", lambda: (pts[1], pts[2], (0, 255, 0),
                                   int(rng.integers(1, 7)))),
            ("draw_polyline", lambda: (pts[3:7], (0, 0, 255), 3)),
            ("draw_polygon", lambda: (pts[7:11], (9, 8, 7), 2)),
            ("draw_text", lambda: (pts[11], str(rng.integers(-99, 1000)),
                                   (64, 64, 255), int(rng.integers(1, 4))))):
        a = args()
        want, got = base.copy(), base.copy()
        getattr(jdraw, fn)(want, *a)
        getattr(tdraw, fn)(got, *a)
        np.testing.assert_array_equal(got, want, err_msg=fn)


@pytest.mark.parametrize("text,scale", [("0123456789", 1), ("-42", 3),
                                        ("7x", 2)])
def test_glyph_mask_bit_identical(text, scale):
    np.testing.assert_array_equal(tdraw.glyph_mask(text, scale),
                                  jdraw.glyph_mask(text, scale))


@pytest.mark.parametrize("size", [(960, 540), (640, 480), (333, 777)])
def test_resize_bit_identical(size):
    img = _canvas(np.random.default_rng(1), 405, 720)
    np.testing.assert_array_equal(tv2._resize(img, size),
                                  jv2._resize(img, size))


def test_views_bit_identical():
    """look_at, follow_view, scene_view (and its empty-scene fallback),
    OrbitView's from_pose / orbit / pan / zoom / rv_eye and _project."""
    rng = np.random.default_rng(2)
    for _ in range(5):
        eye, target = rng.normal(size=3), rng.normal(size=3)
        up = np.array([0.0, -1.0, 0.0])
        for a, b in zip(tr3.look_at(eye, target, up),
                        jr3.look_at(eye, target, up)):
            np.testing.assert_array_equal(a, b)
        pose = np.concatenate([rng.normal(size=3), _unit_quats(rng, 1)[0]])
        for a, b in zip(tr3.follow_view(pose), jr3.follow_view(pose)):
            np.testing.assert_array_equal(a, b)
        pts, traj = rng.normal(size=(7, 3)), rng.normal(size=(9, 3))
        for a, b in zip(tr3.scene_view(pts, traj),
                        jr3.scene_view(pts, traj)):
            np.testing.assert_array_equal(a, b)
        views = [mod.OrbitView.from_pose(pose) for mod in (tr3, jr3)]
        for v in views:
            v.orbit(17.0, -9.0)
            v.pan(-4.0, 11.0)
            v.zoom(2.0)
            v.zoom(-1.0)
        (rt, et), (rj, ej) = views[0].rv_eye(), views[1].rv_eye()
        np.testing.assert_array_equal(rt, rj)
        np.testing.assert_array_equal(et, ej)
        for a, b in zip(tr3._project(pts, rt, et, 400.0, 320.0, 240.0),
                        jr3._project(pts, rj, ej, 400.0, 320.0, 240.0)):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(tr3.scene_view(np.zeros((0, 3)), np.zeros((0, 3))),
                    jr3.scene_view(np.zeros((0, 3)), np.zeros((0, 3)))):
        np.testing.assert_array_equal(a, b)


def _scene(rng, n_traj):
    traj = np.cumsum(rng.normal(0, 0.05, (n_traj, 3)), 0) \
        + np.array([0.0, 0.0, -2.0])
    pose = np.concatenate([traj[-1], _unit_quats(rng, 1)[0]])
    pts = rng.uniform(-1.5, 1.5, (10, 3)) + np.array([0.0, 0.0, 1.0])
    det = rng.uniform(-1.5, 1.5, (4, 3)) + np.array([0.0, 0.0, 1.0])
    return pose, traj, pts, det


@pytest.mark.parametrize("mode", ["follow", "static", "orbit", "long",
                                  "no-detections"])
def test_render_map_frame_bit_identical(mode):
    """The follow view, the static whole-scene view, an explicit orbit
    view, a trajectory long enough to be subsampled, no detections."""
    rng = np.random.default_rng(3)
    pose, traj, pts, det = _scene(rng, 300 if mode == "long" else 40)
    if mode == "no-detections":
        det = None
    imgs = []
    for mod in (jr3, tr3):
        view = None
        if mode == "orbit":
            orbit = mod.OrbitView.from_pose(pose)
            orbit.orbit(30.0, 12.0)
            view = orbit.rv_eye()
        imgs.append(mod.render_map_frame(pose, traj, pts, det,
                                         size=(240, 320),
                                         follow=mode != "static",
                                         view=view))
    assert (imgs[1] != tr3._BG).any()  # something was drawn
    np.testing.assert_array_equal(imgs[1], imgs[0])


def _cams():
    return (jcam.CameraModel.from_matrix(jnp.asarray(K), jnp.asarray(DIST)),
            tcam.CameraModel.from_matrix(torch.tensor(K),
                                         torch.tensor(DIST)))


def _detections(rng, with_ids):
    """Markers in front of the camera, one half off screen, one behind."""
    t = np.array([[0.15, 0.1, 1.2], [-0.3, 0.05, 2.0], [0.4, -0.2, 1.6],
                  [3.5, 0.0, 1.0], [0.1, 0.1, -1.0]])
    q = _unit_quats(rng, len(t)) * 0.2 + np.array([1.0, 0, 0, 0])
    q /= np.linalg.norm(q, axis=1, keepdims=True)
    return [(t[i], q[i], 10 + i) if with_ids else (t[i], q[i])
            for i in range(len(t))]


@pytest.mark.parametrize("with_ids", [True, False])
@pytest.mark.parametrize("gray", [True, False])
def test_viewer2d_identical_to_jax(with_ids, gray):
    """Axes, outlines, corner dots, id labels and map dots, with markers
    off screen and behind the camera and map points behind it too; a
    gray or an RGB frame; then the downsample to the display size."""
    rng = np.random.default_rng(4)
    jc, tc = _cams()
    frame = rng.integers(0, 256, (540, 960) if gray else (540, 960, 3),
                         dtype=np.uint8)
    pose = np.concatenate([[0.05, -0.02, 0.1], _unit_quats(rng, 1)[0] * 0.05
                           + np.array([1.0, 0, 0, 0])])
    pose[3:] /= np.linalg.norm(pose[3:])
    pts = np.concatenate([rng.uniform(-0.6, 0.6, (8, 3))
                          + np.array([0, 0, 1.5]),
                          np.array([[0.0, 0.0, -1.0], [9.0, 0.0, 1.0]])])
    det = _detections(rng, with_ids)
    outs = []
    for mod, cam in ((jv2, jc), (tv2, tc)):
        v = mod.Viewer2D(cam, display_size=(640, 360), marker_size=0.16)
        outs.append(v.view(frame, pose, pts, det))
    assert outs[0].shape == (360, 640, 3)
    plain = tv2._resize(np.stack([frame] * 3, -1) if gray else frame,
                        (640, 360))
    assert (outs[1] != plain).any(axis=-1).sum() > 1000  # drawn on
    np.testing.assert_array_equal(outs[1], outs[0])


@pytest.mark.parametrize("renderer", ["fast", "mpl"])
def test_viewer3d_identical_to_jax(renderer, tmp_path):
    """Three frames at stride 1, then a stride of 2 (the frames it skips
    still extend the trajectory): the images are the JAX viewer's."""
    rng = np.random.default_rng(5)
    pose, traj, pts, det = _scene(rng, 6)
    frames = {}
    for name, mod in (("jax", jv3), ("torch", tv3)):
        for stride in (1, 2):
            v = mod.Viewer3D(export_video=str(tmp_path / f"{name}.mp4"),
                             stride=stride, renderer=renderer)
            for i in range(3):
                v.view(np.concatenate([traj[i], pose[3:]]), pts, det[:i])
            frames[name, stride] = v._frames
    assert [len(frames["torch", s]) for s in (1, 2)] == [3, 2]
    for key in (("torch", 1), ("torch", 2)):
        for got, want in zip(frames[key], frames["jax", key[1]]):
            np.testing.assert_array_equal(got, want)


def test_png_rgb_round_trip(tmp_path):
    """The port's RGB PNG decodes through imageio (a general decoder) to
    the written array, and through the port's own reader; so does the
    grayscale one."""
    import imageio.v3 as iio
    rng = np.random.default_rng(6)
    rgb = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
    gray = rng.integers(0, 256, (37, 53), dtype=np.uint8)
    tio.write_png_rgb(tmp_path / "rgb.png", rgb)
    tio.write_png_gray(tmp_path / "gray.png", gray)
    np.testing.assert_array_equal(iio.imread(tmp_path / "rgb.png"), rgb)
    np.testing.assert_array_equal(tio.read_png_rgb(tmp_path / "rgb.png"),
                                  rgb)
    np.testing.assert_array_equal(iio.imread(tmp_path / "gray.png"), gray)
    with pytest.raises(ValueError):
        tio.read_png_gray(tmp_path / "rgb.png")
    with pytest.raises(ValueError):
        tio.write_png_rgb(tmp_path / "bad.png", gray)
