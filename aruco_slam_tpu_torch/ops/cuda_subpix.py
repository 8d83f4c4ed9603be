"""Subpixel corner refinement: the CUDA kernels and their plain versions.

Counterparts of aruco_slam_tpu/ops/pallas_subpix.py, whose two kernels
share one iteration loop (`_iterate`):

- `refine_corners` <- `refine_corners_fused` (the fused gather +
  gradients + cornerSubPix fixed point);
- `refine_offsets` <- `refine_offsets` (the same fixed point on
  patches the caller gathered, from offsets to the patch centre).

Both kernels are in ``csrc/subpix.cu`` and share its device loop. The
plain versions are the reference's XLA path of ops/detect.py
`_subpix_refine` in PyTorch: `refine_corners_plain` is `gather_patches`
followed by `refine_offsets_plain`, whose loop serves both, and is what
a CPU tensor runs. Kernel and plain version sum in different orders:
they agree to float reassociation noise (the detector tests hold them
to 2e-3 px, the bound the JAX package holds its own two backends to).
"""

from __future__ import annotations

import ctypes
import functools

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

_SCHEDULE_ARGTYPES = [  # half, iters, sigma2, drift, stages
    ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_int),
    ctypes.POINTER(ctypes.c_float), ctypes.POINTER(ctypes.c_float),
    ctypes.c_int]
_ARGTYPES = {
    "subpix_refine_u8": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 5
    + _SCHEDULE_ARGTYPES + [ctypes.c_void_p],
    "subpix_offsets": [ctypes.c_void_p] * 3 + [ctypes.c_int] * 2
    + _SCHEDULE_ARGTYPES + [ctypes.c_void_p]}
_ARGTYPES["subpix_refine_f32"] = _ARGTYPES["subpix_refine_u8"]
_ENTRIES = {torch.uint8: "subpix_refine_u8",
            torch.float32: "subpix_refine_f32"}


@functools.cache
def _schedule(schedule: tuple[tuple[int, int], ...]):
    """rad and the C schedule arguments (half, iters, sigma2 and drift
    arrays, the stage count) of a schedule, built once; raises on a
    schedule the kernels do not take."""
    rad, sched = schedule_params(schedule)
    if not 1 <= len(sched) <= 4:
        raise ValueError(f"subpix: {len(sched)} schedule stages (1 to 4)")
    if any(s[0] < 0 for s in sched):
        raise ValueError(f"subpix: schedule {schedule}: a negative half "
                         "window")
    k = len(sched)
    return rad, ((ctypes.c_int * k)(*(s[0] for s in sched)),
                 (ctypes.c_int * k)(*(s[1] for s in sched)),
                 (ctypes.c_float * k)(*(s[2] for s in sched)),
                 (ctypes.c_float * k)(*(float(s[3]) for s in sched)), k)


def _launch(image, corners, schedule):
    b, h, w = image.shape
    rad, args = _schedule(tuple(map(tuple, schedule)))
    if h < 2 * rad + 1 or w < 2 * rad + 1:
        raise ValueError(f"refine_corners: {h}x{w} frame is smaller "
                         f"than the {2 * rad + 1}-px patch")
    entry = _ENTRIES.get(image.dtype)
    if entry is None:
        raise ValueError(f"refine_corners: image dtype {image.dtype} "
                         "(uint8 or float32)")
    image = image.contiguous()
    corners = corners.to(torch.float32).contiguous()
    _build.check_cuda("image", image, image.dtype, 3)
    out = torch.empty_like(corners)
    with _build.on_device(image, corners, out) as stream:
        _build.call(_build.function(entry, _ARGTYPES[entry]),
                    _build.ptr(image), _build.ptr(corners), _build.ptr(out),
                    b, corners.shape[1], h, w, rad, *args, stream)
    refine_corners.launches += 1
    return out


def refine_offsets(patches: torch.Tensor, c0: torch.Tensor,
                   schedule: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """Run the refinement ``schedule`` ((half, iters) stages) on (N, p, p)
    f32 patches with p = 2 rad + 1 (rad as `schedule_params` derives
    it) from start offsets c0 (N, 2) relative to the patch centre;
    returns the refined (N, 2) offsets.

    A CUDA tensor launches ``csrc/subpix.cu``'s patch-fed kernel; a CPU
    tensor runs `refine_offsets_plain`."""
    rad, _ = schedule_params(schedule)
    p = 2 * rad + 1
    n = patches.shape[0]
    if patches.shape != (n, p, p) or c0.shape != (n, 2):
        raise ValueError(f"refine_offsets: patches {tuple(patches.shape)}"
                         f", c0 {tuple(c0.shape)}; the schedule needs "
                         f"({p}, {p}) patches")
    if patches.device.type == "cpu":
        return refine_offsets_plain(patches, c0, schedule)
    _, args = _schedule(tuple(map(tuple, schedule)))
    patches = patches.contiguous()
    c0 = c0.contiguous()
    _build.check_cuda("patches", patches, torch.float32, 3)
    _build.check_cuda("c0", c0, torch.float32, 2)
    out = torch.empty_like(c0)
    with _build.on_device(patches, c0, out) as stream:
        _build.call(_build.function("subpix_offsets",
                                    _ARGTYPES["subpix_offsets"]),
                    _build.ptr(patches), _build.ptr(c0), _build.ptr(out), n,
                    rad, *args, stream)
    refine_offsets.launches += 1
    return out


refine_offsets.launches = 0
