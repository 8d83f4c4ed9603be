"""Connected-component labeling: the CUDA kernels and their plain versions.

Counterparts of aruco_slam_tpu/ops/pallas_cc.py:

- `flood_scan_labels` (``csrc/flood_scan.cu``): the whole
  `_connected_components` schedule of the detector (opening 3x3
  min-stencil block, then `scan_rounds` alternations of segmented
  row/column min-scans and stencil blocks);
- `flood_labels` (``csrc/flood_scan.cu`` too): ``iters`` stencil rounds
  alone, the schedule when ``scan_rounds == 0``, on the same stencil
  launches.

`flood_scan_labels_plain` and `flood_labels_plain` are the same
schedules in PyTorch, written after the reference's XLA path
(ops/detect.py), and are what a CPU tensor runs.

Output is bit-identical between each kernel, its plain version and the
JAX package: labels are integers and every step is a min. Background is
``h*w``; the outermost 1-px ring is background in every path.
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


def _seed(fg: torch.Tensor) -> torch.Tensor:
    """Border-cleared (B, h, w) bool -> seed labels (flat index per
    foreground pixel, background h*w)."""
    _, h, w = fg.shape
    lin = torch.arange(h * w, dtype=torch.int32,
                       device=fg.device).reshape(h, w)
    return torch.where(fg, lin, h * w)


def _prop(fg: torch.Tensor, labels: torch.Tensor) -> torch.Tensor:
    """One stencil round: the separable 3x3 min (vertical, then
    horizontal) with big-valued padding, background kept at h*w."""
    _, h, w = fg.shape
    big = h * w
    p = torch.full_like(labels[:, :1, :], big)
    p = torch.cat([p, labels, p], dim=1)
    v = torch.minimum(labels, torch.minimum(p[:, :-2], p[:, 2:]))
    q = torch.full_like(v[:, :, :1], big)
    q = torch.cat([q, v, q], dim=2)
    m = torch.minimum(v, torch.minimum(q[:, :, :-2], q[:, :, 2:]))
    return torch.where(fg, m, big)


def flood_labels_plain(fg: torch.Tensor, iters: int) -> torch.Tensor:
    """(B, h, w) bool -> (B, h, w) int32 labels after ``iters`` stencil
    rounds, in PyTorch ops."""
    fg = _clear_border(fg.bool())
    labels = _seed(fg)
    for _ in range(iters):
        labels = _prop(fg, labels)
    return labels


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
    labels = _seed(fg)

    def prop(labels):
        return _prop(fg, labels)

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


def _batched(fg: torch.Tensor, run) -> torch.Tensor:
    """Apply ``run`` to a (B, h, w) view of a (h, w) or (B, h, w) mask."""
    squeeze = fg.dim() == 2
    fg3 = fg[None] if squeeze else fg
    if fg3.dim() != 3:
        raise ValueError(f"fg: expected (h, w) or (B, h, w), got "
                         f"{tuple(fg.shape)}")
    out = run(fg3)
    return out[0] if squeeze else out


def _mask_u8(fg: torch.Tensor, name: str) -> torch.Tensor:
    fg_u8 = (fg != 0).to(torch.uint8).contiguous()
    _build.check_cuda("fg", fg_u8, torch.uint8, 3)
    _, h, w = fg_u8.shape
    if h < 3 or w < 3 or h * w >= 2 ** 31:
        raise ValueError(f"{name}: unsupported grid {h}x{w}")
    return fg_u8


def flood_labels(fg: torch.Tensor, iters: int) -> torch.Tensor:
    """Labels after ``iters`` stencil rounds of a (h, w) or (B, h, w)
    bool/uint8 mask (its 1-px ring counts as background).

    A CUDA tensor launches ``csrc/flood_scan.cu``'s stencil-only entry
    point; a CPU tensor runs `flood_labels_plain`."""
    def run(f):
        if f.device.type == "cpu":
            return flood_labels_plain(f, iters)
        out = _launch_flood(f, iters)
        flood_labels.launches += 1
        return out
    return _batched(fg, run)


flood_labels.launches = 0


def flood_labels_split(fg: torch.Tensor, iters: int,
                       per_launch: int) -> torch.Tensor:
    """`flood_labels` on a CUDA mask with at most ``per_launch`` (1 to 8)
    rounds a launch in place of the kernel's own cap
    (``kStencilOnlyRounds``), for timing and testing each split of the
    rounds; not counted in ``flood_labels.launches``."""
    return _batched(fg, lambda f: _launch_flood(f, iters, per_launch))


def _launch_flood(fg: torch.Tensor, iters: int,
                  per_launch: int | None = None) -> torch.Tensor:
    if iters < 0:
        raise ValueError(f"flood_labels: iters {iters} < 0")
    fg_u8 = _mask_u8(fg, "flood_labels")
    b, h, w = fg_u8.shape
    if b > 65535:
        raise ValueError(f"flood_labels: {b} frames > 65535")
    labels = torch.empty((b, h, w), dtype=torch.int32, device=fg.device)
    scratch = torch.empty_like(labels)
    args = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 4
    if per_launch is None:
        fn = _build.function("flood_labels", args + [ctypes.c_void_p])
        extra = ()
    else:
        fn = _build.function("flood_labels_split",
                             args + [ctypes.c_int, ctypes.c_void_p])
        extra = (per_launch,)
    with _build.on_device(fg_u8, labels, scratch) as stream:
        _build.call(fn, _build.ptr(fg_u8), _build.ptr(labels),
                    _build.ptr(scratch), b, h, w, iters, *extra, stream)
    return labels


def flood_scan_labels(fg: torch.Tensor, iters: int,
                      scan_rounds: int) -> torch.Tensor:
    """Component labels of a (h, w) or (B, h, w) bool/uint8 mask.

    A CUDA tensor launches ``csrc/flood_scan.cu``; a CPU tensor runs
    `flood_scan_labels_plain`."""
    def run(f):
        if f.device.type == "cpu":
            return flood_scan_labels_plain(f, iters, scan_rounds)
        out = _launch(f, iters, scan_rounds)
        flood_scan_labels.launches += 1
        return out
    return _batched(fg, run)


flood_scan_labels.launches = 0


def split_ms(fg: torch.Tensor, iters: int, scan_rounds: int) -> dict:
    """CUDA-event milliseconds of one kernel call on a CUDA (B, h, w)
    mask, summed over its launch groups (not counted in
    ``flood_scan_labels.launches``): "stencil" (the opening block, with
    the seeding, and one block a scan round), "rows" and "cols"."""
    groups = ["stencil"] + ["rows", "cols", "stencil"] * scan_rounds
    return _build.split_ms(lambda marks, n_marks: _launch(
        fg, iters, scan_rounds, marks, n_marks), groups)


def _launch(fg: torch.Tensor, iters: int, scan_rounds: int, marks=None,
            n_marks: int = 0) -> torch.Tensor:
    fg_u8 = _mask_u8(fg, "flood_scan_labels")
    b, h, w = fg_u8.shape
    if b > 65535:
        raise ValueError(f"flood_scan_labels: {b} frames > 65535")
    labels = torch.empty((b, h, w), dtype=torch.int32, device=fg.device)
    scratch = torch.empty_like(labels)
    fn = _build.function("flood_scan_labels", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p, ctypes.c_int,
        ctypes.c_int, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_void_p])
    with _build.on_device(fg_u8, labels, scratch) as stream:
        _build.call(fn, _build.ptr(fg_u8), _build.ptr(labels),
                    _build.ptr(scratch), b, h, w, iters, scan_rounds, marks,
                    n_marks, stream)
    return labels
