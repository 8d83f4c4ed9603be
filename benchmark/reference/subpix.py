"""Subpixel corner refinement, plain PyTorch: the benchmark's frozen copy
of the plain route in aruco_slam_tpu_torch/ops/cuda_subpix.py, which the
card's kernel B2 (csrc/subpix.cu) matches to float reassociation noise.
The names the detector calls run the plain loop on any device.
"""

from __future__ import annotations

import torch


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


def gather_patches(image: torch.Tensor, corners: torch.Tensor, rad: int):
    """(B, H, W) frames + (B, N, 2) pixel corners -> ((B, N, p, p) f32
    patches centred at the rounded corners clipped into the frame
    (p = 2 rad + 1), cx0 (B, N), cy0 (B, N) int32 centres), as
    ops/detect.py `_gather_patches`."""
    b, h, w = image.shape
    p = 2 * rad + 1
    cx0 = torch.clamp(torch.round(corners[..., 0]).to(torch.int32),
                      rad, w - rad - 1)
    cy0 = torch.clamp(torch.round(corners[..., 1]).to(torch.int32),
                      rad, h - rad - 1)
    ar = torch.arange(p, device=image.device)
    rows = (cy0.long() - rad)[..., None] + ar                 # (B, N, p)
    cols = (cx0.long() - rad)[..., None] + ar
    bi = torch.arange(b, device=image.device)[:, None, None, None]
    patches = image[bi, rows[..., :, None], cols[..., None, :]]
    return patches.to(torch.float32), cx0, cy0


def start_offsets(corners: torch.Tensor, cx0: torch.Tensor,
                  cy0: torch.Tensor, rad: int) -> torch.Tensor:
    """Corner offsets from the patch centres, clipped so the first
    window stays inside the patch."""
    c = torch.stack([corners[..., 0] - cx0, corners[..., 1] - cy0], -1)
    return torch.clamp(c, -(rad - 1), rad - 1)


def refine_offsets_plain(patches: torch.Tensor, c0: torch.Tensor,
                         schedule: tuple[tuple[int, int], ...]
                         ) -> torch.Tensor:
    """(..., p, p) f32 patches + (..., 2) start offsets from the patch
    centre -> refined (..., 2) offsets, in PyTorch ops."""
    _, sched = schedule_params(schedule)
    patches = patches.to(torch.float32)
    gx = 0.5 * (patches[..., 1:-1, 2:] - patches[..., 1:-1, :-2])
    gy = 0.5 * (patches[..., 2:, 1:-1] - patches[..., :-2, 1:-1])
    q = patches.shape[-1] - 2
    iq = torch.arange(q, dtype=torch.float32, device=patches.device)
    px = (iq - (q - 1) / 2.0)[None, :].expand(q, q)
    py = (iq - (q - 1) / 2.0)[:, None].expand(q, q)
    proj = gx * px + gy * py
    c = c0.to(torch.float32)
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
    return c


def refine_via_patches(image: torch.Tensor, corners: torch.Tensor,
                       schedule: tuple[tuple[int, int], ...], refine
                       ) -> torch.Tensor:
    """(B, H, W) image + (B, N, 2) corners -> (B, N, 2): gather the
    patches, run ``refine`` (`refine_offsets` or `refine_offsets_plain`)
    on the (B*N, p, p) stack, add the centres back."""
    rad, _ = schedule_params(schedule)
    corners = corners.to(torch.float32)
    patches, cx0, cy0 = gather_patches(image, corners, rad)
    c0 = start_offsets(corners, cx0, cy0, rad)
    b, n, p = patches.shape[:3]
    c = refine(patches.reshape(b * n, p, p), c0.reshape(b * n, 2),
               schedule).reshape(b, n, 2)
    return c + torch.stack([cx0, cy0], -1).to(torch.float32)


def refine_corners_plain(image: torch.Tensor, corners: torch.Tensor,
                         schedule: tuple[tuple[int, int], ...]
                         ) -> torch.Tensor:
    """(B, H, W) image + (B, N, 2) f32 corners -> (B, N, 2)."""
    return refine_via_patches(image, corners, schedule,
                              refine_offsets_plain)


refine_corners = refine_corners_plain
refine_offsets = refine_offsets_plain
