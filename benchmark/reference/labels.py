"""Connected-component labeling, plain PyTorch: the benchmark's frozen
copy of the plain schedules in aruco_slam_tpu_torch/ops/cuda_cc.py
(`flood_scan_labels_plain`, `flood_labels_plain`), which the card's
kernel B1 (csrc/flood_scan.cu) matches bit for bit. The names the
detector calls run the plain schedules on any device.

Background is ``h*w``; the outermost 1-px ring is background.
"""

from __future__ import annotations

import torch


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


def flood_labels(fg: torch.Tensor, iters: int) -> torch.Tensor:
    return _batched(fg, lambda f: flood_labels_plain(f, iters))


def flood_scan_labels(fg: torch.Tensor, iters: int,
                      scan_rounds: int = 4) -> torch.Tensor:
    return _batched(fg, lambda f: flood_scan_labels_plain(f, iters,
                                                          scan_rounds))
