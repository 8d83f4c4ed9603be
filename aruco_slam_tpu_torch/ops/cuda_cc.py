"""Connected-component labeling: the CUDA kernel and its plain version.

Counterpart of aruco_slam_tpu/ops/pallas_cc.py `flood_scan_labels`:
the whole `_connected_components` schedule of the detector (opening
3x3 min-stencil block, then `scan_rounds` alternations of segmented
row/column min-scans and stencil blocks). The kernel is
``csrc/flood_scan.cu``; `flood_scan_labels_plain` is the same schedule
in PyTorch, written after the reference's XLA path (ops/detect.py), and
is what a CPU tensor runs.

Output is bit-identical between the two and to the JAX package: labels
are integers and every step is a min. Background is ``h*w``; the
outermost 1-px ring is background in every path.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch import _build


def _clear_border(fg: torch.Tensor) -> torch.Tensor:
    fg = fg.clone()
    fg[..., 0, :] = False
    fg[..., -1, :] = False
    fg[..., :, 0] = False
    fg[..., :, -1] = False
    return fg


def flood_scan_labels_plain(fg: torch.Tensor, iters: int,
                            scan_rounds: int) -> torch.Tensor:
    """(B, h, w) bool -> (B, h, w) int32 labels, in PyTorch ops.

    The segmented scans use the reference's monotonic key — cummax of
    (run id << 32 | (maxl − label)) with run id = cumsum of background
    resets — in int64, so the key has bits to spare at any frame size.
    """
    _, h, w = fg.shape
    big = h * w
    fg = _clear_border(fg.bool())
    lin = torch.arange(big, dtype=torch.int32,
                       device=fg.device).reshape(h, w)
    big_t = torch.tensor(big, dtype=torch.int32, device=fg.device)
    labels = torch.where(fg, lin, big_t)

    def prop(labels):
        p = torch.full_like(labels[:, :1, :], big)
        p = torch.cat([p, labels, p], dim=1)
        v = torch.minimum(labels, torch.minimum(p[:, :-2], p[:, 2:]))
        q = torch.full_like(v[:, :, :1], big)
        q = torch.cat([q, v, q], dim=2)
        m = torch.minimum(v, torch.minimum(q[:, :, :-2], q[:, :, 2:]))
        return torch.where(fg, m, big_t)

    maxl = (1 << 31) - 1
    reset = (~fg).to(torch.int64)

    def seg_scan_dir(labels, axis, reverse):
        f, lab, rs = fg, labels.to(torch.int64), reset
        if reverse:
            f, lab, rs = f.flip(axis), lab.flip(axis), rs.flip(axis)
        run = torch.cumsum(rs, dim=axis)
        key = (run << 32) | torch.where(f, maxl - lab, 0)
        key = torch.cummax(key, dim=axis).values
        out = torch.where(f, maxl - (key & maxl), big).to(torch.int32)
        return out.flip(axis) if reverse else out

    def seg_scan(labels, axis):
        return seg_scan_dir(seg_scan_dir(labels, axis, False), axis, True)

    per = max(1, iters // (scan_rounds + 1)) if scan_rounds else iters
    for _ in range(per):
        labels = prop(labels)
    for _ in range(scan_rounds):
        labels = seg_scan(labels, 2)  # along rows
        labels = seg_scan(labels, 1)  # along columns
        for _ in range(per):
            labels = prop(labels)
    return labels


def flood_scan_labels(fg: torch.Tensor, iters: int,
                      scan_rounds: int) -> torch.Tensor:
    """Component labels of a (h, w) or (B, h, w) bool/uint8 mask.

    A CUDA tensor launches ``csrc/flood_scan.cu``; a CPU tensor runs
    `flood_scan_labels_plain`."""
    squeeze = fg.dim() == 2
    fg3 = fg[None] if squeeze else fg
    if fg3.dim() != 3:
        raise ValueError(f"fg: expected (h, w) or (B, h, w), got "
                         f"{tuple(fg.shape)}")
    if fg3.device.type == "cpu":
        out = flood_scan_labels_plain(fg3, iters, scan_rounds)
    else:
        out = _launch(fg3, iters, scan_rounds)
    return out[0] if squeeze else out


flood_scan_labels.launches = 0


def _launch(fg: torch.Tensor, iters: int, scan_rounds: int
            ) -> torch.Tensor:
    fg_u8 = (fg != 0).to(torch.uint8).contiguous()
    _build.check_cuda("fg", fg_u8, torch.uint8, 3)
    b, h, w = fg_u8.shape
    if h < 3 or w < 3 or h * w >= 2 ** 31:
        raise ValueError(f"flood_scan_labels: unsupported grid {h}x{w}")
    cleared = torch.empty_like(fg_u8)
    labels = torch.empty((b, h, w), dtype=torch.int32, device=fg.device)
    scratch = torch.empty_like(labels)
    fn = _build.function("flood_scan_labels", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p])
    _build.call(fn, _build.ptr(fg_u8), _build.ptr(cleared),
                _build.ptr(labels), _build.ptr(scratch), b, h, w,
                iters, scan_rounds, _build.stream())
    flood_scan_labels.launches += 1
    return labels
