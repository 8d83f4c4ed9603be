"""Pure-numpy raster primitives for the 2D overlay sink.

A copy of aruco_slam_tpu/viz/draw.py (JAX-free there too), here so that
the port imports nothing of the JAX package; tests/test_torch_viz.py
holds every primitive bit-identical to the original. It replaces
cv2.line / cv2.circle drawing in the reference's 2D viewer (reference
viewers/viewer_2d.py:140-190) without a native dependency. Host-side
only.
"""

from __future__ import annotations

import numpy as np


def draw_circle(img: np.ndarray, center, radius: int, color) -> None:
    """Filled circle, in place. img: (H, W, 3) uint8."""
    h, w = img.shape[:2]
    cx, cy = int(round(center[0])), int(round(center[1]))
    if not (-radius < cx < w + radius and -radius < cy < h + radius):
        return
    y0, y1 = max(cy - radius, 0), min(cy + radius + 1, h)
    x0, x1 = max(cx - radius, 0), min(cx + radius + 1, w)
    if y0 >= y1 or x0 >= x1:
        return
    yy, xx = np.mgrid[y0:y1, x0:x1]
    m = (yy - cy) ** 2 + (xx - cx) ** 2 <= radius * radius
    img[y0:y1, x0:x1][m] = color


def draw_line(img: np.ndarray, p0, p1, color, thickness: int = 2) -> None:
    """Anti-alias-free thick line, in place."""
    h, w = img.shape[:2]
    x0, y0 = float(p0[0]), float(p0[1])
    x1, y1 = float(p1[0]), float(p1[1])
    n = int(max(abs(x1 - x0), abs(y1 - y0))) + 1
    n = min(n, 8 * max(h, w))  # clamp run-away off-screen lines
    ts = np.linspace(0.0, 1.0, n)
    xs = np.round(x0 + (x1 - x0) * ts).astype(np.int64)
    ys = np.round(y0 + (y1 - y0) * ts).astype(np.int64)
    r = thickness // 2
    for dy in range(-r, r + 1):
        for dx in range(-r, r + 1):
            xi = xs + dx
            yi = ys + dy
            keep = (xi >= 0) & (xi < w) & (yi >= 0) & (yi < h)
            img[yi[keep], xi[keep]] = color


def draw_polyline(img, pts, color, thickness=2) -> None:
    for a, b in zip(pts[:-1], pts[1:]):
        draw_line(img, a, b, color, thickness)


def draw_polygon(img, pts, color, thickness=2) -> None:
    """Closed polygon border (the detected-marker outline the
    reference gets from cv2.aruco.drawDetectedMarkers, reference
    filters/base_filter.py:198)."""
    pts = list(pts)
    draw_polyline(img, pts + pts[:1], color, thickness)


# 5x7 bitmap glyphs for marker-id labels (digits + '-'): enough for
# the id text cv2.aruco.drawDetectedMarkers renders, with no font
# dependency.
_FONT_5X7 = {
    "0": ("01110", "10001", "10011", "10101", "11001", "10001", "01110"),
    "1": ("00100", "01100", "00100", "00100", "00100", "00100", "01110"),
    "2": ("01110", "10001", "00001", "00010", "00100", "01000", "11111"),
    "3": ("11110", "00001", "00001", "01110", "00001", "00001", "11110"),
    "4": ("00010", "00110", "01010", "10010", "11111", "00010", "00010"),
    "5": ("11111", "10000", "11110", "00001", "00001", "10001", "01110"),
    "6": ("00110", "01000", "10000", "11110", "10001", "10001", "01110"),
    "7": ("11111", "00001", "00010", "00100", "01000", "01000", "01000"),
    "8": ("01110", "10001", "10001", "01110", "10001", "10001", "01110"),
    "9": ("01110", "10001", "10001", "01111", "00001", "00010", "01100"),
    "-": ("00000", "00000", "00000", "11111", "00000", "00000", "00000"),
}


def glyph_mask(text: str, scale: int = 2) -> np.ndarray:
    """(7*scale, 6*scale*len) bool mask of the rendered text (tests
    compare this against drawn pixels)."""
    cells = []
    for ch in str(text):
        g = _FONT_5X7.get(ch, ("00000",) * 7)
        cell = np.array([[b == "1" for b in row] + [False]
                         for row in g], bool)          # (7, 6)
        cells.append(cell)
    m = np.concatenate(cells, axis=1)
    return np.kron(m, np.ones((scale, scale), bool))


def draw_text(img: np.ndarray, pos, text, color, scale: int = 2) -> None:
    """Bitmap text, in place; pos is the top-left corner."""
    h, w = img.shape[:2]
    x0, y0 = int(round(pos[0])), int(round(pos[1]))
    m = glyph_mask(text, scale)
    mh, mw = m.shape
    ya, xa = max(y0, 0), max(x0, 0)
    yb, xb = min(y0 + mh, h), min(x0 + mw, w)
    if ya >= yb or xa >= xb:
        return
    sub = m[ya - y0:yb - y0, xa - x0:xb - x0]
    img[ya:yb, xa:xb][sub] = color
