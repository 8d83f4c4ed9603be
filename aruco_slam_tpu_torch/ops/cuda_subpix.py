"""Subpixel corner refinement: the CUDA kernel and its plain version.

Counterpart of aruco_slam_tpu/ops/pallas_subpix.py
`refine_corners_fused` (the fused gather + gradients + cornerSubPix
fixed point). The kernel is ``csrc/subpix.cu``;
`refine_corners_plain` is the reference's XLA path of
ops/detect.py `_subpix_refine` in PyTorch (patch gather, interior
gradients, the coarse-to-fine loop), and is what a CPU tensor runs.
The two sum in different orders: they agree to float reassociation
noise (the detector tests hold them to 2e-3 px, the bound the JAX
package holds its own two backends to).
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch import _build


def schedule_params(schedule: tuple[tuple[int, int], ...]):
    """(half_window, iterations) stages -> (rad, ((half, iters, sigma2,
    drift), ...)), exactly as ops/detect.py `_subpix_refine` derives
    them: the patch radius covers every stage's window plus 1-px
    gradient border after all earlier stages' drift."""
    cum = 0
    rad = 0
    for half, _ in schedule:
        cum += half
        rad = max(rad, cum + half + 1)
    drift = 0
    sched = []
    for half, iters in schedule:
        sigma2 = (half / 1.5) ** 2
        drift = min(drift + half, rad - half - 1)
        sched.append((half, iters, sigma2, drift))
    return rad, tuple(sched)


def _centers(corners: torch.Tensor, rad: int, h: int, w: int):
    cx0 = torch.clamp(torch.round(corners[..., 0]).to(torch.int32),
                      rad, w - rad - 1)
    cy0 = torch.clamp(torch.round(corners[..., 1]).to(torch.int32),
                      rad, h - rad - 1)
    return cx0, cy0


def refine_corners_plain(image: torch.Tensor, corners: torch.Tensor,
                         schedule: tuple[tuple[int, int], ...]
                         ) -> torch.Tensor:
    """(B, H, W) image + (B, N, 2) f32 corners -> (B, N, 2)."""
    b, h, w = image.shape
    rad, sched = schedule_params(schedule)
    p = 2 * rad + 1
    corners = corners.to(torch.float32)
    cx0, cy0 = _centers(corners, rad, h, w)
    ar = torch.arange(p, device=image.device)
    rows = (cy0.long() - rad)[..., None] + ar                 # (B, N, p)
    cols = (cx0.long() - rad)[..., None] + ar
    bi = torch.arange(b, device=image.device)[:, None, None, None]
    patches = image[bi, rows[..., :, None], cols[..., None, :]
                    ].to(torch.float32)                        # (B,N,p,p)
    c = torch.stack([corners[..., 0] - cx0, corners[..., 1] - cy0], -1)
    c = torch.clamp(c, -(rad - 1), rad - 1)

    gx = 0.5 * (patches[..., 1:-1, 2:] - patches[..., 1:-1, :-2])
    gy = 0.5 * (patches[..., 2:, 1:-1] - patches[..., :-2, 1:-1])
    q = 2 * rad - 1
    iq = torch.arange(q, dtype=torch.float32, device=image.device)
    px = (iq - (q - 1) / 2.0)[None, :].expand(q, q)
    py = (iq - (q - 1) / 2.0)[:, None].expand(q, q)
    proj = gx * px + gy * py

    for half, iters, sigma2, drift in sched:
        for _ in range(iters):
            cx, cy = c[..., 0], c[..., 1]
            wx = torch.round(cx)[..., None, None]
            wy = torch.round(cy)[..., None, None]
            inside = ((torch.abs(px - wx) <= half)
                      & (torch.abs(py - wy) <= half)).to(torch.float32)
            wgt = inside * torch.exp(
                -0.5 * ((px - wx) ** 2 + (py - wy) ** 2) / sigma2)
            wgx = wgt * gx
            wgy = wgt * gy
            wxx = (wgx * gx).sum((-1, -2))
            wxy = (wgx * gy).sum((-1, -2))
            wyy = (wgy * gy).sum((-1, -2))
            bx = (wgx * proj).sum((-1, -2))
            by = (wgy * proj).sum((-1, -2))
            det = wxx * wyy - wxy * wxy
            ok = torch.abs(det) > 1e-9
            nx = torch.where(ok, (wyy * bx - wxy * by) / det, cx)
            ny = torch.where(ok, (wxx * by - wxy * bx) / det, cy)
            nx = torch.minimum(torch.maximum(nx, cx - half), cx + half)
            ny = torch.minimum(torch.maximum(ny, cy - half), cy + half)
            c = torch.stack([torch.clamp(nx, -drift, drift),
                             torch.clamp(ny, -drift, drift)], -1)
    return c + torch.stack([cx0, cy0], -1).to(torch.float32)


def refine_corners(image: torch.Tensor, corners: torch.Tensor,
                   schedule: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """Refine (B, N, 2) pixel corners on (B, H, W) uint8/f32 frames.

    A CUDA tensor launches ``csrc/subpix.cu``; a CPU tensor runs
    `refine_corners_plain`."""
    if image.dim() != 3 or corners.dim() != 3 or corners.shape[-1] != 2 \
            or corners.shape[0] != image.shape[0]:
        raise ValueError(f"refine_corners: image {tuple(image.shape)}, "
                         f"corners {tuple(corners.shape)}")
    if image.device.type == "cpu":
        return refine_corners_plain(image, corners, schedule)
    return _launch(image, corners, schedule)


refine_corners.launches = 0


def _launch(image, corners, schedule):
    b, h, w = image.shape
    rad, sched = schedule_params(schedule)
    if len(sched) > 4:
        raise ValueError("refine_corners: at most 4 schedule stages")
    if h < 2 * rad + 1 or w < 2 * rad + 1:
        raise ValueError(f"refine_corners: {h}x{w} frame is smaller "
                         f"than the {2 * rad + 1}-px patch")
    if image.dtype == torch.uint8:
        entry = "subpix_refine_u8"
    elif image.dtype == torch.float32:
        entry = "subpix_refine_f32"
    else:
        raise ValueError(f"refine_corners: image dtype {image.dtype} "
                         "(uint8 or float32)")
    image = image.contiguous()
    corners = corners.to(torch.float32).contiguous()
    _build.check_cuda("image", image, image.dtype, 3)
    _build.check_cuda("corners", corners, torch.float32, 3)
    if corners.device != image.device:
        raise ValueError("refine_corners: image and corners on different "
                         "devices")
    out = torch.empty_like(corners)
    n = corners.shape[1]
    k = len(sched)
    half = (ctypes.c_int * k)(*(s[0] for s in sched))
    iters = (ctypes.c_int * k)(*(s[1] for s in sched))
    sigma2 = (ctypes.c_float * k)(*(s[2] for s in sched))
    drift = (ctypes.c_float * k)(*(float(s[3]) for s in sched))
    fn = _build.function(entry, [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
        ctypes.c_int, ctypes.c_void_p])
    _build.call(fn, _build.ptr(image), _build.ptr(corners),
                _build.ptr(out), b, n, h, w, rad, half, iters, sigma2,
                drift, k, _build.stream())
    refine_corners.launches += 1
    return out
