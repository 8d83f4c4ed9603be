"""PyTorch port vs the JAX package: bench/degrade.py, and the detector on
degraded frames.

Every degradation is bit-identical to the JAX module's for the same
input and seed (both are numpy). The port's detector then runs on
degraded 960x540 frames (tests/test_detect.py's camera, scene and
presets, and its cluttered background) beside the JAX detector: the
same masks, corners within tests/test_torch_detect.py's CORNER_ATOL.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import degrade as jdeg
from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu_torch.bench import degrade as tdeg
from aruco_slam_tpu_torch.ops import detect as td

torch.set_num_threads(2)

K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
SIZE = (960, 540)
CORNER_ATOL = 1e-3  # px, tests/test_torch_detect.py's
# tests/test_detect.py's presets
DEGRADATIONS = {
    "blur": dict(blur_sigma=1.5),
    "motion": dict(motion_len=7, motion_angle=30.0),
    "noise": dict(noise_sigma=8.0),
    "lighting": dict(vignette_strength=0.55, gradient_strength=0.35),
    "combined": dict(blur_sigma=1.0, noise_sigma=6.0,
                     vignette_strength=0.4),
    "jpeg": dict(jpeg_quality=20),
    "lowlight": dict(low_light_exposure=0.12),
    "night_stream": dict(low_light_exposure=0.2, blur_sigma=0.8,
                         jpeg_quality=35),
}
DETECTED = ("blur", "noise", "lighting", "combined", "lowlight")


@pytest.fixture(scope="module")
def image():
    rng = np.random.default_rng(0)
    img = np.full((90, 130), 178, np.uint8)
    img[20:60, 30:90] = 20
    return np.clip(img + rng.normal(0, 10, img.shape), 0, 255
                   ).astype(np.uint8)


@pytest.mark.parametrize("fn,args", [
    ("gaussian_blur", (1.5,)), ("gaussian_blur", (0.0,)),
    ("motion_blur", (7, 30.0)), ("motion_blur", (1,)),
    ("vignette", (0.55,)), ("lighting_gradient", (0.35,)),
    ("lighting_gradient", (0.35, False)), ("sensor_noise", (8.0, 3)),
    ("low_light", (0.12,)), ("low_light", (0.2, 4.0, 1.0, 5)),
    ("jpeg_compress", (20,))], ids=lambda a: str(a))
def test_degradations_bit_identical(image, fn, args):
    got = getattr(tdeg, fn)(image, *args)
    want = getattr(jdeg, fn)(image, *args)
    assert got.dtype == want.dtype
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("name", sorted(DEGRADATIONS))
def test_degrade_presets_bit_identical(image, name):
    for seed in (0, 7):
        np.testing.assert_array_equal(
            tdeg.degrade(image, seed=seed, **DEGRADATIONS[name]),
            jdeg.degrade(image, seed=seed, **DEGRADATIONS[name]))


@pytest.mark.parametrize("seed", [0, 7])
def test_clutter_background_bit_identical(seed):
    np.testing.assert_array_equal(
        tdeg.clutter_background((270, 480), seed=seed),
        jdeg.clutter_background((270, 480), seed=seed))


def test_jpeg_needs_pil(image, monkeypatch):
    """jpeg_compress imports PIL when it is called, and only then."""
    import sys
    monkeypatch.setitem(sys.modules, "PIL", None)
    assert tdeg.degrade(image, noise_sigma=4.0).shape == image.shape
    with pytest.raises(ImportError):
        tdeg.degrade(image, jpeg_quality=30)


@pytest.fixture(scope="module")
def degraded():
    """One degraded frame per preset of DETECTED (frames 0, 3, 6, ...
    of tests/test_detect.py's orbit, seed = frame), and frame 0 of its
    cluttered-background sequence with noise sigma 5."""
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2), jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    frames = render.render_sequence(scene, traj, cam, image_size=SIZE)
    _, mask = synthetic.observe_corners(scene, traj, cam, 64,
                                        image_size=SIZE)
    imgs, expected = [], []
    for k, name in enumerate(DETECTED):
        f = 3 * k
        imgs.append(tdeg.degrade(frames[f], seed=f, **DEGRADATIONS[name]))
        expected.append(mask[f])
    scene2 = synthetic.make_wall_scene(num_markers=10, seed=2)
    traj2 = synthetic.Trajectory(*(a[:1] for a in
                                   synthetic.make_orbit_trajectory(10)))
    bg = tdeg.clutter_background((SIZE[1], SIZE[0]), seed=7)
    clutter = render.render_sequence(scene2, traj2, cam, image_size=SIZE,
                                     background=bg)
    _, mask2 = synthetic.observe_corners(scene2, traj2, cam, 64,
                                         image_size=SIZE)
    imgs.append(tdeg.degrade(clutter[0], noise_sigma=5.0, seed=0))
    expected.append(mask2[0])
    return np.stack(imgs), np.stack(expected)


def test_detector_on_degraded_frames_matches_jax(degraded):
    """blur, noise, lighting, combined, lowlight and the clutter: the
    port's masks are the JAX detector's, its corners within
    CORNER_ATOL, no id is outside the ground truth, and each frame
    finds at least half of the markers in view."""
    imgs, expected = degraded
    want = jd.detect_markers_batch(jnp.asarray(imgs), jd.DetectorConfig())
    got = td.detect_markers(torch.tensor(imgs),
                            td.config_from_jax(jd.DetectorConfig()._asdict()))
    mask = got.mask.numpy()
    np.testing.assert_array_equal(mask, np.asarray(want.mask))
    np.testing.assert_allclose(got.corners.numpy()[mask],
                               np.asarray(want.corners)[mask],
                               atol=CORNER_ATOL)
    assert not (mask & ~expected).any()
    assert (2 * mask.sum(1) >= expected.sum(1)).all(), mask.sum(1)
