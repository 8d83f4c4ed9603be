"""Realistic image degradations for detection robustness tests and runs.

A copy of aruco_slam_tpu/bench/degrade.py (plain numpy there too), here
so that the port imports nothing of the JAX package;
tests/test_torch_degrade.py holds every function bit-identical to the
original for the same seeds. The reference's detector inherits
OpenCV's robustness machinery (adaptive-threshold window sweep 3-30,
reference filters/base_filter.py:84-88) and was built for noisy
handheld video; the clean renderer (bench/render.py) exercises none of
it, so this module produces the degradations real lenses and sensors
add — Gaussian and motion blur, vignetting, lighting gradients, sensor
and low-light shot noise, JPEG blocking — plus cluttered backgrounds to
stress candidate selection. Host-side numpy; ground-truth corner
positions are unaffected. `jpeg_compress` (and `degrade` with
``jpeg_quality``) imports PIL when called, and raises ImportError where
PIL is absent.
"""

from __future__ import annotations

import numpy as np


def _sep_convolve(img: np.ndarray, k: np.ndarray) -> np.ndarray:
    """Separable 2-D convolution with edge padding (float32)."""
    r = len(k) // 2
    p = np.pad(img, ((r, r), (0, 0)), mode="edge")
    out = np.zeros_like(img, np.float32)
    for i, w in enumerate(k):
        out += w * p[i:i + img.shape[0]]
    p = np.pad(out, ((0, 0), (r, r)), mode="edge")
    out2 = np.zeros_like(img, np.float32)
    for i, w in enumerate(k):
        out2 += w * p[:, i:i + img.shape[1]]
    return out2


def gaussian_blur(img: np.ndarray, sigma: float) -> np.ndarray:
    if sigma <= 0:
        return img.astype(np.float32)
    r = max(1, int(np.ceil(3 * sigma)))
    x = np.arange(-r, r + 1)
    k = np.exp(-0.5 * (x / sigma) ** 2)
    k /= k.sum()
    return _sep_convolve(img.astype(np.float32), k)


def motion_blur(img: np.ndarray, length: int,
                angle_deg: float = 0.0) -> np.ndarray:
    """Linear motion blur: average along a line of `length` pixels."""
    if length <= 1:
        return img.astype(np.float32)
    a = np.deg2rad(angle_deg)
    t = np.linspace(-(length - 1) / 2, (length - 1) / 2, length)
    dx = np.round(t * np.cos(a)).astype(int)
    dy = np.round(t * np.sin(a)).astype(int)
    h, w = img.shape
    acc = np.zeros((h, w), np.float32)
    f = img.astype(np.float32)
    for ddx, ddy in zip(dx, dy):
        acc += np.roll(np.roll(f, ddy, axis=0), ddx, axis=1)
    return acc / length


def vignette(img: np.ndarray, strength: float = 0.5) -> np.ndarray:
    """Radial illumination falloff: corners scaled by (1 - strength)."""
    h, w = img.shape
    y = (np.arange(h) - h / 2) / (h / 2)
    x = (np.arange(w) - w / 2) / (w / 2)
    r2 = (y[:, None] ** 2 + x[None, :] ** 2) / 2.0
    return img.astype(np.float32) * (1.0 - strength * r2)


def lighting_gradient(img: np.ndarray, strength: float = 0.4,
                      horizontal: bool = True) -> np.ndarray:
    """Linear illumination ramp from (1-strength) to (1+strength)."""
    h, w = img.shape
    ramp = np.linspace(1.0 - strength, 1.0 + strength,
                       w if horizontal else h, dtype=np.float32)
    ramp = ramp[None, :] if horizontal else ramp[:, None]
    return img.astype(np.float32) * ramp


def sensor_noise(img: np.ndarray, sigma: float,
                 seed: int = 0) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return img.astype(np.float32) + rng.normal(0, sigma, img.shape)


def low_light(img: np.ndarray, exposure: float = 0.15,
              gain: float | None = None, read_sigma: float = 2.0,
              seed: int = 0) -> np.ndarray:
    """Photon-starved capture: scale luminance by ``exposure``, draw
    Poisson shot noise at the reduced photon count, add sensor read
    noise, then apply digital gain (1/exposure by default) — the
    brightness-restored but noise-amplified frame a camera's auto-gain
    produces at night. Unlike plain ``sensor_noise``, the noise is
    signal-dependent: dark marker cells are noisier relative to their
    level than white ones, which is what breaks thresholding on real
    night footage."""
    rng = np.random.default_rng(seed)
    photons = np.maximum(img.astype(np.float32) * exposure, 0.0)
    shot = rng.poisson(photons).astype(np.float32)
    out = shot + rng.normal(0.0, read_sigma, img.shape)
    return out * (1.0 / exposure if gain is None else gain)


def jpeg_compress(img: np.ndarray, quality: int = 30) -> np.ndarray:
    """Round-trip through a real JPEG codec: 8x8 DCT blocking and
    ringing around the marker edges — the dominant artifact of webcam/
    network streams (the reference's operating regime is compressed
    video capture, reference main/run_slam.py:96-116)."""
    import io

    from PIL import Image

    buf = io.BytesIO()
    Image.fromarray(np.clip(img, 0, 255).astype(np.uint8),
                    mode="L").save(buf, format="JPEG", quality=quality)
    buf.seek(0)
    return np.asarray(Image.open(buf), np.uint8)


def clutter_background(shape: tuple[int, int], seed: int = 0,
                       n_shapes: int = 40,
                       base: int = 178) -> np.ndarray:
    """Background with random dark/light rectangles and disks —
    distractor components for candidate selection. Render markers ON
    TOP via render_frame(background=...)."""
    rng = np.random.default_rng(seed)
    h, w = shape
    img = np.full((h, w), base, np.float32)
    for _ in range(n_shapes):
        val = float(rng.integers(20, 240))
        cx, cy = rng.integers(0, w), rng.integers(0, h)
        if rng.random() < 0.5:
            sw, sh = rng.integers(8, w // 6), rng.integers(8, h // 6)
            img[max(cy - sh, 0):cy + sh, max(cx - sw, 0):cx + sw] = val
        else:
            r = int(rng.integers(5, h // 8))
            y, x = np.ogrid[:h, :w]
            img[(y - cy) ** 2 + (x - cx) ** 2 <= r * r] = val
    return img.astype(np.uint8)


def degrade(img: np.ndarray, blur_sigma: float = 0.0,
            motion_len: int = 0, motion_angle: float = 0.0,
            vignette_strength: float = 0.0,
            gradient_strength: float = 0.0,
            noise_sigma: float = 0.0,
            low_light_exposure: float = 0.0,
            jpeg_quality: int = 0, seed: int = 0) -> np.ndarray:
    """Compose degradations in the physical order (illumination →
    optics → sensor → codec) and requantize to uint8."""
    out = img.astype(np.float32)
    if gradient_strength > 0:
        out = lighting_gradient(out, gradient_strength)
    if vignette_strength > 0:
        out = vignette(out, vignette_strength)
    if blur_sigma > 0:
        out = gaussian_blur(out, blur_sigma)
    if motion_len > 1:
        out = motion_blur(out, motion_len, motion_angle)
    if low_light_exposure > 0:
        out = low_light(out, low_light_exposure, seed=seed)
    if noise_sigma > 0:
        out = sensor_noise(out, noise_sigma, seed)
    out = np.clip(out, 0, 255).astype(np.uint8)
    if jpeg_quality > 0:
        out = jpeg_compress(out, jpeg_quality)
    return out
