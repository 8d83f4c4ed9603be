"""Image-domain ArUco detection as a dense, statically shaped pipeline.

Counterpart of aruco_slam_tpu/ops/detect.py, stage for stage (the
names of `candidate_stage_names`):

 1. adaptive threshold fused with each pass's downscale — min/avg
    pools against a local box mean (``rawpools``, ``pools``);
 2. connected components on the label grid — `cuda_cc.flood_scan_labels`,
    or `cuda_cc.flood_labels` for the stencil-only schedule
    (``scan_rounds == 0``) (``flood``);
 3. per-component areas from a sort + run-length scan, area-gated
    top-K (``sort``);
 4. quad corners from the component's own pixel list (``harvest``);
 5. subpixel refinement — `cuda_subpix.refine_corners` (``subpix``);
 6. decode through the quad homography against every dictionary
    rotation (``homog``, ``sample``, ``decode``);
 7. slot outputs: slot == id (`detect_markers`) or the id->slot table
    (`assign_slots_lru` and the batched LRU path).

Where the JAX package maps the per-frame pipeline over frames with
``vmap``, the port carries a leading batch dimension through every
stage and into both kernels. Ties follow the reference: `lax.top_k`
breaks ties to the lowest index (a stable descending sort here),
argmax takes the first maximum. The harvest sort is stable here and
unstable there; within a component the order of its pixels only moves
distance ties in the quad extraction.

The streaming tracker follows: `track_markers` (three subpixel pulls,
a median consensus and a payload re-decode per live slot),
`detect_or_track[_batch][_mapped]` and `streaming_step`, which runs the
detect-every-K schedule frame by frame. Where JAX picks the branch with
`lax.cond`, the port tests the predicate on the host and runs only the
branch taken.

Slot assignment and the tracker take an optional leading stream axis:
the fleet's S tables advance together (T steps per chunk whatever S),
and a fleet frame of the streaming forms (`streaming_step(streams=S)`,
with or without rescue cohorts) runs as at most one sweep batch and one
tracked batch, so each kernel launches once a fleet frame for all S
streams (three subpixel launches a tracked batch), not once a stream.
With ``slot_max_age > 0`` slot assignment recycles the stalest slot
once the table is full.
"""

from __future__ import annotations

from typing import NamedTuple

import torch
import torch.nn.functional as F

from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix
from aruco_slam_tpu_torch.ops import dictionary as dict_mod
from aruco_slam_tpu_torch.ops.pnp import _h_square_entries


class DetectorConfig(NamedTuple):
    """Field names and defaults are the JAX package's (without
    ``pallas``: the port takes its kernels on a card and their plain
    versions on the CPU)."""

    dict_name: str = dict_mod.DICT_5X5_50
    capacity: int = 64
    max_candidates: int = 32
    downscale: int = 4
    thresh_win: int = 15
    passes: tuple[tuple[int, int], ...] | None = None
    thresh_c: float = 7.0
    min_area: int = 16
    max_area_frac: float = 0.05
    prop_iters: int = 16
    scan_rounds: int = 4
    fine_scan_rounds: int | None = None
    subpix_win: int = 6
    subpix_iters: int = 6
    track_win: int = 8
    track_slots: int = 16
    max_hamming: int = 1
    border_max_white: int = 2
    slot_max_age: int = 0
    refine_budget: int = 0


class Detections(NamedTuple):
    """Slot-indexed per-frame output (slot == marker id)."""

    corners: torch.Tensor       # (..., C, 4, 2) full-res corners
    mask: torch.Tensor          # (..., C) bool
    cand_corners: torch.Tensor  # (..., K, 4, 2)
    cand_ids: torch.Tensor      # (..., K) decoded id or -1
    cand_valid: torch.Tensor    # (..., K)


def config_from_jax(fields: dict) -> DetectorConfig:
    """A JAX ``DetectorConfig._asdict()`` -> the port's config."""
    fields = dict(fields)
    fields.pop("pallas", None)
    return DetectorConfig(**fields)


def with_preset(cfg: DetectorConfig, preset: str) -> DetectorConfig:
    """"robust" = the multi-pass sweep (cfg unchanged), "fast" = the
    single coarse pass."""
    if preset == "robust":
        return cfg
    if preset == "fast":
        return cfg._replace(passes=((cfg.thresh_win, cfg.downscale),))
    raise ValueError(f"unknown detector preset {preset!r}")


def candidate_stage_names() -> tuple[str, ...]:
    return ("rawpools", "pools", "flood", "sort", "harvest",
            "subpix", "homog", "sample", "decode")


def _passes(cfg: DetectorConfig) -> tuple[tuple[int, int], ...]:
    if cfg.passes:
        return cfg.passes
    w0, d0 = cfg.thresh_win, cfg.downscale
    passes = ((w0, d0), (3 * w0, d0))
    if d0 // 2 >= 2:
        passes = passes + ((w0, d0 // 2),)
    return passes


def _box_mean_multi(img: torch.Tensor, wins: tuple[int, ...]
                    ) -> list[torch.Tensor]:
    """Box means of (B, h, w) for several windows from one shared
    integral image (edge-replicated)."""
    _, h, w = img.shape
    rmax = max(wn // 2 for wn in wins)
    pad = F.pad(img[:, None], (rmax + 1, rmax, rmax + 1, rmax),
                mode="replicate")[:, 0]
    ii = torch.cumsum(torch.cumsum(pad, dim=1), dim=2)
    out = []
    for wn in wins:
        r = wn // 2
        hi, lo = rmax + 1 + r, rmax - r
        a = ii[:, hi:hi + h, hi:hi + w]
        b = ii[:, lo:lo + h, hi:hi + w]
        c = ii[:, hi:hi + h, lo:lo + w]
        d = ii[:, lo:lo + h, lo:lo + w]
        out.append((a - b - c + d) / (wn * wn))
    return out


def _pool(x: torch.Tensor, f: int):
    """(B, h, w) -> (min, sum) over non-overlapping f x f blocks
    (trailing rows/cols that do not fill a block are dropped)."""
    b, h, w = x.shape
    hl, wl = h // f, w // f
    blocks = x[:, :hl * f, :wl * f].reshape(b, hl, f, wl, f)
    return blocks.amin(dim=(2, 4)), blocks.sum(dim=(2, 4))


def _connected_components(fg: torch.Tensor, iters: int,
                          scan_rounds: int = 3) -> torch.Tensor:
    """(B, h, w) bool -> int32 labels, background h*w. With
    ``scan_rounds == 0`` the schedule is ``iters`` stencil rounds alone
    (`cuda_cc.flood_labels`); otherwise stencil blocks alternate with
    segmented scans (`cuda_cc.flood_scan_labels`)."""
    if scan_rounds == 0:
        return cuda_cc.flood_labels(fg, iters)
    return cuda_cc.flood_scan_labels(fg, iters, scan_rounds)


def _quad_corners_compact(xf: torch.Tensor, yf: torch.Tensor,
                          valid: torch.Tensor) -> torch.Tensor:
    """Extreme-point quad corners from compact per-candidate pixel
    lists (..., K, N) -> (..., K, 4, 2), clockwise."""
    m = valid.to(torch.float32)
    cnt = torch.clamp(m.sum(-1), min=1.0)
    cx = (m * xf).sum(-1) / cnt
    cy = (m * yf).sum(-1) / cnt
    neg = -1e9

    def argpt(score):
        idx = torch.argmax(torch.where(valid, score, neg), dim=-1,
                           keepdim=True)
        return torch.cat([torch.gather(xf, -1, idx),
                          torch.gather(yf, -1, idx)], -1)   # (..., K, 2)

    d0 = (xf - cx[..., None]) ** 2 + (yf - cy[..., None]) ** 2
    c0 = argpt(d0)
    d1 = (xf - c0[..., :1]) ** 2 + (yf - c0[..., 1:]) ** 2
    c1 = argpt(d1)
    ex = c1[..., 0] - c0[..., 0]
    ey = c1[..., 1] - c0[..., 1]
    s = (xf - c0[..., :1]) * ey[..., None] - (yf - c0[..., 1:]) * ex[..., None]
    c2 = argpt(s)
    c3 = argpt(-s)
    quad = torch.stack([c0, c2, c1, c3], dim=-2)          # (..., K, 4, 2)
    ang = torch.atan2(quad[..., 1] - cy[..., None],
                      quad[..., 0] - cx[..., None])
    order = torch.argsort(ang, dim=-1, stable=True)
    return torch.gather(quad, -2, order[..., None].expand(*order.shape, 2))


def _subpix_refine(images: torch.Tensor, corners: torch.Tensor,
                   schedule: tuple[tuple[int, int], ...]) -> torch.Tensor:
    """(B, H, W) frames + (B, N, 2) corners -> refined (B, N, 2)."""
    return cuda_subpix.refine_corners(images, corners, schedule)


def _homography_cells(corners: torch.Tensor, cells: int) -> torch.Tensor:
    """Homography from cell-grid coords (x right, y down, origin at
    corner 0) to pixels: (..., 4, 2) clockwise quads -> (..., 3, 3)."""
    g = float(cells)
    dt, dev = corners.dtype, corners.device
    center = corners.mean(dim=-2)                          # (..., 2)
    scale = torch.clamp(
        torch.abs(corners - center[..., None, :]).mean(dim=(-2, -1)),
        min=1e-3)
    cn = (corners - center[..., None, :]) / scale[..., None, None]
    u = [cn[..., i, 0] for i in range(4)]
    v = [cn[..., i, 1] for i in range(4)]
    hsq = _h_square_entries(torch.tensor(g / 2.0, dtype=dt, device=dev),
                            u, v)
    h_norm = torch.stack([torch.stack(r, -1) for r in hsq], -2)
    t = torch.zeros(*corners.shape[:-2], 3, 3, dtype=dt, device=dev)
    t[..., 0, 0] = scale
    t[..., 1, 1] = scale
    t[..., 0, 2] = center[..., 0]
    t[..., 1, 2] = center[..., 1]
    t[..., 2, 2] = 1.0
    a = torch.tensor([[1.0, 0.0, -g / 2.0], [0.0, -1.0, g / 2.0],
                      [0.0, 0.0, 1.0]], dtype=dt, device=dev)
    return t @ h_norm @ a


def _sample_cells(img: torch.Tensor, quads: torch.Tensor, cells: int):
    """Nearest-pixel samples of the (cells x cells) grid of every quad,
    thresholded to bits. img (B, H, W) uint8 or f32, quads (B, K, 4, 2).
    Returns (bits (B, K, cells, cells) bool, border_white (B, K))."""
    b, k = quads.shape[:2]
    _, h, w = img.shape
    dev = img.device
    hmat = _homography_cells(quads, cells)                 # (B, K, 3, 3)
    ci = torch.arange(cells, dtype=torch.float32, device=dev) + 0.5
    gx, gy = torch.meshgrid(ci, ci, indexing="xy")
    grid = torch.stack([gx, gy, torch.ones_like(gx)], -1).reshape(-1, 3)
    proj = torch.einsum("bkij,nj->bkni", hmat, grid)
    px = proj[..., 0] / proj[..., 2]
    py = proj[..., 1] / proj[..., 2]
    xi = torch.clamp(torch.round(px).to(torch.int64), 0, w - 1)
    yi = torch.clamp(torch.round(py).to(torch.int64), 0, h - 1)
    bi = torch.arange(b, device=dev)[:, None, None]
    samples = img[bi, yi, xi].reshape(b, k, cells, cells).to(torch.float32)
    smin = samples.amin(dim=(-2, -1), keepdim=True)
    smax = samples.amax(dim=(-2, -1), keepdim=True)
    bits = samples > 0.5 * (smin + smax)
    border = torch.cat([bits[..., 0, :], bits[..., -1, :],
                        bits[..., 1:-1, 0], bits[..., 1:-1, -1]], dim=-1)
    return bits, border.sum(-1)


def _top_k_low_index(x: torch.Tensor, k: int):
    """`lax.top_k` along the last axis: largest first, ties to the
    lowest index."""
    order = torch.sort(x, dim=-1, descending=True, stable=True).indices
    idx = order[..., :k]
    return torch.gather(x, -1, idx), idx


def _harvest(labs: torch.Tensor, bgs: torch.Tensor, cfg: DetectorConfig):
    """Component areas -> top-K candidates -> quad corners for a stack
    of label images (L, hl, wl) on the coarsest grid, background
    bgs (L,). Returns (quads (L, K, 4, 2), top_score (L, K), cand_ok)."""
    nl, hl2, wl2 = labs.shape
    n = hl2 * wl2
    k = cfg.max_candidates
    dev = labs.device
    max_area = int(cfg.max_area_frac * n)
    idx = torch.arange(n, device=dev)
    s_lab, s_pos = torch.sort(labs.reshape(nl, n), dim=-1, stable=True)
    start = torch.cat([torch.ones((nl, 1), dtype=torch.bool, device=dev),
                       s_lab[:, 1:] != s_lab[:, :-1]], 1)
    start_pos = torch.where(start, idx, n)
    after = torch.cat([start_pos[:, 1:],
                       torch.full((nl, 1), n, device=dev)], 1)
    next_start = torch.cummin(after.flip(-1), dim=-1).values.flip(-1)
    cnt = torch.where(start, next_start - idx, 0)
    score = torch.where((s_lab < bgs[:, None]) & (cnt >= cfg.min_area)
                        & (cnt <= max_area), cnt, 0)
    pos_bits = max(1, int(n).bit_length())
    score_bits = max(1, int(max_area).bit_length())
    blk = max(1, min(16, cfg.min_area))
    if (pos_bits + score_bits <= 31 and blk > 1
            and (n + (-n) % blk) // blk >= k):
        pmask = (1 << pos_bits) - 1
        key = (score << pos_bits) | (n - 1 - idx)
        pad = (-n) % blk
        if pad:
            key = torch.cat([key, torch.zeros((nl, pad), dtype=key.dtype,
                                              device=dev)], 1)
        red = key.reshape(nl, -1, blk).amax(dim=-1)
        top_key = torch.topk(red, k, dim=-1, sorted=True).values
        top_score = top_key >> pos_bits
        starts = n - 1 - (top_key & pmask)
    else:
        if n < k:  # micro frame: fewer pixels than candidate slots
            score = torch.cat([score, torch.zeros(
                (nl, k - n), dtype=score.dtype, device=dev)], 1)
        top_score, starts = _top_k_low_index(score, k)
    cand_ok = top_score > 0
    # compact per-candidate pixel lists: component j's pixels are
    # s_pos[starts_j : starts_j + cnt_j], read as the reference's
    # 128-aligned slab (same list, same padding entries)
    cap = min(max_area, n)
    rows = cap // 128 + 2
    tot_rows = -(-n // 128) + rows
    pos_pad = torch.cat([s_pos, torch.zeros(
        (nl, tot_rows * 128 - n), dtype=s_pos.dtype, device=dev)], 1)
    capw = rows * 128
    row0 = torch.clamp(starts // 128, 0, tot_rows - rows)
    j2 = torch.arange(capw, device=dev)
    pix = torch.gather(pos_pad[:, None, :].expand(nl, k, -1), -1,
                       (row0 * 128)[..., None] + j2)        # (L, K, capw)
    off = (starts % 128)[..., None]
    valid = (j2 >= off) & (j2 < off + top_score[..., None]) \
        & cand_ok[..., None]
    xf = (pix % wl2).to(torch.float32)
    yf = (pix // wl2).to(torch.float32)
    return _quad_corners_compact(xf, yf, valid), top_score, cand_ok


def _detect_candidates(images: torch.Tensor, cfg: DetectorConfig,
                       stop: str | None = None):
    """Steps 1-6 over a (B, H, W) batch: the candidate sweep through
    decode. Returns (canon (B, K, 4, 2), cand_ids (B, K), decoded (B, K),
    top_score (B, K)) with K = max_candidates * passes. `stop` (from
    `candidate_stage_names`) returns that stage's intermediates."""
    d = dict_mod.load(cfg.dict_name)
    nbits = d.marker_bits
    cells = nbits + 2
    img = images.to(torch.float32)
    nb, h, w = img.shape
    dev = img.device
    k = cfg.max_candidates
    passes = _passes(cfg)
    base_ds = max(ds for _, ds in passes)
    win_by_ds: dict[int, list[int]] = {}
    for wf, ds in passes:
        wl_ = max(3, wf // ds) | 1
        if wl_ not in win_by_ds.setdefault(ds, []):
            win_by_ds[ds].append(wl_)

    # 1+2. min/avg pools finest-first (a coarser grid is an exact pool
    # of a finer one), box means, threshold, label
    pools: dict[int, tuple] = {}
    raw_pools = []
    for ds in sorted({d_ for _, d_ in passes}):
        hl, wl = h // ds, w // ds
        src = next((d2 for d2 in sorted(pools, reverse=True)
                    if ds % d2 == 0), None)
        if src:
            f = ds // src
            small_min, _ = _pool(pools[src][2], f)
            _, s = _pool(pools[src][3], f)
            small_avg = s * (1.0 / (f * f))
        else:
            small_min, s = _pool(img, ds)
            small_avg = s * (1.0 / (ds * ds))
        raw_pools.append((small_min, small_avg))
        means = None if stop == "rawpools" else dict(
            zip(win_by_ds[ds], _box_mean_multi(small_avg,
                                               tuple(win_by_ds[ds]))))
        pools[ds] = (hl, wl, small_min, small_avg, means)
    if stop == "rawpools":
        return tuple(x for rp in raw_pools for x in rp)
    if stop == "pools":
        return tuple(pools[ds][2] for ds in pools)

    per_pass = []
    for wf, ds in passes:
        hl, wl, small_min, small_avg, means = pools[ds]
        win_l = max(3, wf // ds) | 1
        mean = means[win_l]
        fg = (small_min < (mean - cfg.thresh_c)) \
            & (small_avg < (mean - 0.5 * cfg.thresh_c))
        fine = ds < base_ds
        fine_rounds = (cfg.scan_rounds if cfg.fine_scan_rounds is None
                       else cfg.fine_scan_rounds)
        fine_iters = max(16, cfg.prop_iters // 2)
        labels = _connected_components(
            fg, fine_iters if fine else cfg.prop_iters,
            scan_rounds=fine_rounds if fine else cfg.scan_rounds)
        sub = base_ds // ds
        labs = labels[:, ::sub, ::sub] if sub > 1 else labels
        per_pass.append((labs, hl * wl, ds))
    if stop == "flood":
        return tuple(p[0] for p in per_pass)
    labs_stack = torch.stack([p[0] for p in per_pass], 1)  # (B, P, h, w)
    np_ = len(per_pass)
    if stop == "sort":
        return torch.sort(labs_stack.reshape(nb, np_, -1), dim=-1).values

    # 3+4. areas -> top-K -> quads, batched over frames and passes
    bgs = torch.tensor([p[1] for p in per_pass], device=dev).repeat(nb)
    quads, scores, oks = _harvest(
        labs_stack.reshape(nb * np_, *labs_stack.shape[2:]), bgs, cfg)
    quads = quads.reshape(nb, np_, k, 4, 2)
    scores = scores.reshape(nb, np_, k)
    oks = oks.reshape(nb, np_, k)
    if stop == "harvest":
        return quads, scores, oks
    offs = torch.tensor([(p[2] - 1) / 2.0 for p in per_pass],
                        dtype=torch.float32, device=dev)
    quads_full = (quads * base_ds + offs[:, None, None, None]
                  ).reshape(nb, -1, 4, 2)
    top_score = scores.reshape(nb, -1)
    cand_ok = oks.reshape(nb, -1)
    k = k * np_

    b = cfg.refine_budget
    if b and b < k:
        cent = quads_full.mean(dim=2)                        # (B, k, 2)
        idx_k = torch.arange(k, device=dev)
        pri = top_score * k + (k - 1 - idx_k)
        near = torch.amax(torch.abs(cent[:, :, None, :]
                                    - cent[:, None, :, :]), dim=-1) \
            < 2.0 * base_ds
        better = near & cand_ok[:, None, :] \
            & (pri[:, None, :] > pri[:, :, None])
        alive = cand_ok & ~better.any(dim=2)
        top_score, sel = _top_k_low_index(
            torch.where(alive, top_score, 0), b)
        quads_full = torch.gather(
            quads_full, 1, sel[..., None, None].expand(-1, -1, 4, 2))
        cand_ok = top_score > 0
        k = b

    # 5. subpixel refinement on the full-res frames
    refined = _subpix_refine(
        images, quads_full.reshape(nb, -1, 2),
        ((cfg.subpix_win, cfg.subpix_iters), (3, 4))).reshape(nb, k, 4, 2)
    if stop == "subpix":
        return refined, top_score, cand_ok
    if stop == "homog":
        return _homography_cells(refined, cells)
    if stop == "sample":
        return _sample_cells(img, refined, cells)

    # 6. decode against every dictionary rotation
    bits, border_white = _sample_cells(img, refined, cells)
    border_ok = border_white <= cfg.border_max_white
    payload = bits[..., 1:-1, 1:-1].reshape(nb, k, -1)
    table = torch.as_tensor(d.table, device=dev)
    corr = (payload.to(torch.float32) * 2.0 - 1.0) @ table.T
    best = torch.argmax(corr, dim=-1)
    hamming = ((nbits * nbits)
               - torch.gather(corr, -1, best[..., None])[..., 0]) / 2.0
    ids = torch.as_tensor(d.table_ids, device=dev)[best]
    rots = torch.as_tensor(d.table_rot, device=dev)[best].long()
    decoded = border_ok & (hamming <= cfg.max_hamming) & cand_ok
    # canonical corner order: index 0 becomes the marker's TL
    roll = (torch.arange(4, device=dev) + rots[..., None]) % 4
    canon = torch.gather(refined, 2, roll[..., None].expand(-1, -1, -1, 2))
    cand_ids = torch.where(decoded, ids, -1)
    return canon, cand_ids, decoded, top_score


def detect_markers(image: torch.Tensor, cfg: DetectorConfig
                   ) -> Detections:
    """Detect markers in one (H, W) or a batch of (B, H, W) frames.
    Slot layout: slot == marker id (capacity must exceed the max id)."""
    single = image.dim() == 2
    images = image[None] if single else image
    canon, cand_ids, decoded, top_score = _detect_candidates(images, cfg)
    ok = decoded & (cand_ids >= 0) & (cand_ids < cfg.capacity)
    match = ok[..., None] & (cand_ids[..., None] == torch.arange(
        cfg.capacity, device=images.device))               # (B, K, C)
    scores = torch.where(match, top_score[..., None], -1)
    best = torch.argmax(scores, dim=1)                     # (B, C)
    slot_mask = torch.amax(scores, dim=1) > 0
    slot_c = torch.gather(canon, 1,
                          best[..., None, None].expand(-1, -1, 4, 2))
    slot_c = torch.where(slot_mask[..., None, None], slot_c, 0.0)
    det = Detections(corners=slot_c, mask=slot_mask, cand_corners=canon,
                     cand_ids=cand_ids, cand_valid=decoded)
    return Detections(*(x[0] for x in det)) if single else det


def slot_table_init(capacity: int, device=None,
                    streams: int | None = None) -> torch.Tensor:
    """Fresh id->slot table: (C,) int32 marker id per slot, -1 = free
    (leading (S,) axis with ``streams``)."""
    lead = () if streams is None else (streams,)
    return torch.full((*lead, capacity), -1, dtype=torch.int32,
                      device=device)


def _assign_slots_impl(table_ids, canon, cand_ids, decoded, top_score,
                       last_seen=None, frame_idx=None, max_age: int = 0):
    """One frame of slot assignment (see the JAX `assign_slots` and
    `assign_slots_lru`), on one stream or on S streams at once (a
    leading axis on every argument but ``frame_idx``): one winner per id
    (highest score, ties to the lower candidate), known ids land in
    their slot, unseen ids claim free slots in first-occurrence order.
    With ``max_age`` > 0, once the free slots are gone a new id evicts
    the stalest slot unobserved for more than ``max_age`` frames (ties
    to the lowest slot; a slot observed this frame is never evicted);
    new ids beyond the claimable slots drop."""
    c = table_ids.shape[-1]
    k = canon.shape[-3]
    dev = canon.device
    ok = decoded & (cand_ids >= 0)
    idx = torch.arange(k, device=dev)
    same = ok[..., :, None] & ok[..., None, :] \
        & (cand_ids[..., :, None] == cand_ids[..., None, :])  # (..., K, K)
    occ = torch.amin(torch.where(same, idx, k), dim=-1)
    better = same & ((top_score[..., None, :] > top_score[..., :, None])
                     | ((top_score[..., None, :] == top_score[..., :, None])
                        & (idx[None, :] < idx[:, None])))
    winner = ok & ~better.any(dim=-1)

    known = cand_ids[..., :, None] == table_ids[..., None, :]  # (..., K, C)
    has_known = known.any(dim=-1)
    neww = winner & ~has_known
    rank = torch.sum(neww[..., None, :] & (occ[..., None, :]
                                           < occ[..., :, None]), dim=-1)
    free = table_ids < 0
    if max_age:
        # claim order: free slots first (in index order), then evictable
        # slots stalest-first — the JAX int32 key and lax.top_k (ties to
        # the lowest slot: a stable descending sort)
        receiving = (known & winner[..., :, None]).any(dim=-2)
        age = torch.as_tensor(frame_idx, dtype=torch.int32,
                              device=dev) - last_seen
        stale = ~free & ~receiving & (age > max_age)
        big = 1 << 29
        key = torch.where(free, 2 * big, torch.where(
            stale, torch.clamp(age, max=big - 1), -1)).to(torch.int32)
        _, order = _top_k_low_index(key, c)
        n_claim = (free | stale).sum(dim=-1, keepdim=True)
        claim_ok = neww & (rank < n_claim)
        slot_new = torch.gather(order, -1, torch.clamp(rank, 0, c - 1))
    else:
        free_rank = torch.cumsum(free.to(torch.int64), -1) - 1
        claim_ok = neww & (rank < free.sum(dim=-1, keepdim=True))
        slot_new = torch.argmax(
            (free[..., None, :] & (free_rank[..., None, :]
                                   == rank[..., :, None])).to(torch.int32),
            dim=-1)
    slot = torch.where(has_known, torch.argmax(known.to(torch.int32), dim=-1),
                       slot_new)
    placed = (winner & has_known) | claim_ok
    onehot = placed[..., None] & (torch.arange(c, device=dev)
                                  == slot[..., None])       # (..., K, C)
    claim_oh = onehot & claim_ok[..., None]
    claimed = claim_oh.any(dim=-2)
    evicted = claimed & (table_ids >= 0)
    dropped = (neww & ~claim_ok).sum(dim=-1).to(torch.int32)
    table_ids = torch.where(
        claimed,
        torch.sum(torch.where(claim_oh, cand_ids[..., None], 0), dim=-2
                  ).to(table_ids.dtype),
        table_ids)
    slot_mask = onehot.any(dim=-2)
    src = torch.argmax(onehot.to(torch.int32), dim=-2)         # (..., C)
    slot_c = torch.gather(canon, -3, src[..., None, None].expand(
        *src.shape, *canon.shape[-2:]))
    slot_c = torch.where(slot_mask[..., None, None], slot_c, 0.0)
    return slot_c, slot_mask, table_ids, evicted, dropped


def assign_slots(table_ids, canon, cand_ids, decoded, top_score):
    """Step 7 with an id->slot table for one frame: known ids land in
    their slot, unseen ids claim free slots first-seen. Returns (corners
    (C, 4, 2), mask (C,), table_ids (C,))."""
    return _assign_slots_impl(table_ids, canon, cand_ids, decoded,
                              top_score)[:3]


def detect_markers_mapped(image: torch.Tensor, cfg: DetectorConfig,
                          table_ids: torch.Tensor):
    """`detect_markers` with the id->slot table layout: one (H, W) frame
    and its (C,) table, or the (S, H, W) frames of S streams and their
    (S, C) tables (one candidate batch, the S tables assigned at once).
    Returns (Detections, updated table_ids)."""
    if image.dim() == 2:
        det, table_ids = detect_markers_mapped(image[None], cfg,
                                               table_ids[None])
        return Detections(*(x[0] for x in det)), table_ids[0]
    canon, cand_ids, decoded, top_score = _detect_candidates(image, cfg)
    slot_c, slot_mask, table_ids = assign_slots(
        table_ids, canon, cand_ids, decoded, top_score)
    return Detections(corners=slot_c, mask=slot_mask, cand_corners=canon,
                      cand_ids=cand_ids, cand_valid=decoded), table_ids


def detect_markers_batch(images: torch.Tensor, cfg: DetectorConfig
                         ) -> Detections:
    """Detection over a leading batch axis (B, H, W): `detect_markers`,
    which runs the batch as one."""
    return detect_markers(images, cfg)


def detect_markers_batch_mapped(images: torch.Tensor, cfg: DetectorConfig,
                                table_ids: torch.Tensor):
    """Mapped full detection over a chunk of consecutive frames of one
    stream (T, H, W): the candidate pipeline runs the T frames as one
    batch, and only the slot assignment, whose id->slot table is the one
    piece of cross-frame state, steps frame by frame. Returns (corners
    (T, C, 4, 2), mask (T, C), final table_ids)."""
    canon, cand_ids, decoded, top_score = _detect_candidates(images, cfg)
    corners, masks = [], []
    for i in range(images.shape[0]):
        sc, sm, table_ids = assign_slots(table_ids, canon[i], cand_ids[i],
                                         decoded[i], top_score[i])
        corners.append(sc)
        masks.append(sm)
    return torch.stack(corners), torch.stack(masks), table_ids


def assign_slots_lru(table_ids, last_seen, frame_idx, max_age: int,
                     canon, cand_ids, decoded, top_score):
    """Slot assignment with LRU recycling (``max_age`` > 0) and
    saturation accounting, for one stream or S at once. Returns (corners
    (..., C, 4, 2), mask (..., C), table_ids, last_seen, evicted (...,
    C) — slots reassigned this frame, whose landmark the filter resets,
    dropped (...) int32 — new ids that found no slot)."""
    slot_c, slot_mask, table_ids, evicted, dropped = _assign_slots_impl(
        table_ids, canon, cand_ids, decoded, top_score,
        last_seen=last_seen, frame_idx=frame_idx, max_age=max_age)
    last_seen = torch.where(
        slot_mask, torch.as_tensor(frame_idx, dtype=torch.int32,
                                   device=last_seen.device), last_seen)
    return slot_c, slot_mask, table_ids, last_seen, evicted, dropped


def detect_candidates_batch(images: torch.Tensor, cfg: DetectorConfig):
    """The candidate pipeline (steps 1-6) over a (T, H, W) chunk, or an
    (S, T, H, W) one as one batch of S·T frames; the candidates keep the
    leading axes."""
    lead = images.shape[:-2]
    cands = _detect_candidates(images.reshape(-1, *images.shape[-2:]), cfg)
    return tuple(x.reshape(*lead, *x.shape[1:]) for x in cands)


def assign_sequence_lru(cfg: DetectorConfig, table_ids, last_seen,
                        frame0: int, canon, cand_ids, decoded, top_score):
    """Sequential LRU slot assignment over a (T, ...) candidate sequence
    of one stream, or an (S, T, ...) one of S streams with (S, C)
    tables: T steps whatever S. Returns (corners (..., T, C, 4, 2), mask
    (..., T, C), reset (..., T, C), ids_seq (..., T, C), table_ids,
    last_seen, dropped (..., T))."""
    axis = table_ids.dim() - 1
    outs = []
    for i in range(canon.shape[axis]):
        sc, sm, table_ids, last_seen, ev, dr = assign_slots_lru(
            table_ids, last_seen, frame0 + i, cfg.slot_max_age,
            *(x.select(axis, i) for x in (canon, cand_ids, decoded,
                                          top_score)))
        outs.append((sc, sm, ev, table_ids, dr))
    slot_c, slot_m, reset, ids_seq, dropped = (
        torch.stack([o[j] for o in outs], axis) for j in range(5))
    return slot_c, slot_m, reset, ids_seq, table_ids, last_seen, dropped


def detect_markers_batch_lru(images: torch.Tensor, cfg: DetectorConfig,
                             table_ids: torch.Tensor,
                             last_seen: torch.Tensor, frame0: int):
    """Mapped detection over a (T, H, W) chunk of one stream, or an (S,
    T, H, W) chunk of S streams with (S, C) tables and last-seen frames:
    the candidate pipeline over all S·T frames as one batch, then the
    sequential id->slot assignment from absolute frame index ``frame0``
    (all streams at once). Returns (corners (..., T, C, 4, 2), mask (...,
    T, C), reset (..., T, C), ids_seq (..., T, C), table_ids, last_seen,
    dropped (..., T))."""
    return assign_sequence_lru(cfg, table_ids, last_seen, frame0,
                               *detect_candidates_batch(images, cfg))


def _median(x: torch.Tensor, dim: int) -> torch.Tensor:
    """`jnp.median` along ``dim`` (kept): the mean of the two middle
    values for an even count. (`torch.median` returns the lower one.)"""
    s = torch.sort(x, dim=dim).values
    n = x.shape[dim]
    lo = s.narrow(dim, (n - 1) // 2, 1)
    hi = s.narrow(dim, n // 2, 1)
    return (lo + hi) * 0.5


def track_velocity(new_c: torch.Tensor, new_m: torch.Tensor,
                   old_c: torch.Tensor, old_m: torch.Tensor
                   ) -> torch.Tensor:
    """Per-marker translation prior: the median corner displacement
    (..., C, 1, 2) broadcast over the corners, zero for slots not alive
    in both frames. Takes (C, 4, 2) slots or (S, C, 4, 2) streams."""
    med = _median(new_c - old_c, -2)
    return torch.where((new_m & old_m)[..., None, None],
                       med.expand_as(new_c), 0.0)


def refine_corners(image: torch.Tensor, corners: torch.Tensor,
                   half: int = 5, iters: int = 8) -> torch.Tensor:
    """Subpixel refinement of point features (cv2.cornerSubPix's math):
    an (H, W) frame with (N, 2) corners -> (N, 2), or a (B, H, W) batch
    with (B, N, 2). Like the JAX function on every backend, it gathers
    the patches, runs the one-stage schedule on them
    (`cuda_subpix.refine_offsets`) and adds the centres back."""
    single = image.dim() == 2
    out = cuda_subpix.refine_via_patches(
        image[None] if single else image,
        corners[None] if single else corners, ((half, iters),),
        cuda_subpix.refine_offsets)
    return out[0] if single else out


def track_markers(image: torch.Tensor, corners: torch.Tensor,
                  mask: torch.Tensor, cfg: DetectorConfig,
                  velocity: torch.Tensor | None = None,
                  slot_ids: torch.Tensor | None = None):
    """Track the previous frame's slot corners (C, 4, 2) with live mask
    (C,) into the (H, W) frame ``image``, or S streams' (S, C, ...) state
    into their (S, H, W) frames as one batch (three subpixel launches for
    all S): the search starts at corners + velocity, and a slot survives
    only if its re-decoded payload still spells its own id (``slot_ids``
    (..., C), -1 = free; None = slot index is the id). At most
    ``cfg.track_slots`` live slots a stream are tracked (the lowest
    indices first); the rest drop until the next full sweep. Returns
    this frame's (corners (..., C, 4, 2), mask (..., C))."""
    if image.dim() == 2:
        nc, nm = track_markers(
            image[None], corners[None], mask[None], cfg,
            None if velocity is None else velocity[None],
            None if slot_ids is None else slot_ids[None])
        return nc[0], nm[0]
    d = dict_mod.load(cfg.dict_name)
    s, c = mask.shape
    if velocity is None:
        velocity = torch.zeros_like(corners)
    if slot_ids is None:
        slot_ids = torch.arange(c, device=corners.device).expand(s, c)
    ts = min(cfg.track_slots, c) if cfg.track_slots else c
    if ts < c:
        # each stream's live slots (the JAX top_k under vmap), gathered
        # along the slot axis, tracked, and scattered back
        _, idx = _top_k_low_index(mask.to(torch.int32), ts)      # (S, ts)
        idx4 = idx[..., None, None].expand(s, ts, 4, 2)
        rc, ok = _track_core(image, corners.gather(1, idx4),
                             mask.gather(1, idx), velocity.gather(1, idx4),
                             cfg, d, slot_ids.gather(1, idx))
        return (corners.scatter(1, idx4, rc),
                torch.zeros_like(mask).scatter(1, idx, ok))
    return _track_core(image, corners, mask, velocity, cfg, d, slot_ids)


def _track_core(images, corners, mask, velocity, cfg: DetectorConfig, d,
                slot_ids):
    """Tracking on a (possibly compacted) set of N slot rows in each of
    S streams: two median-consensus pulls (windows track_win, then 6), a
    tight polish ((3, 4), (2, 2)) whose corners snap back to the
    consensus quad when they stray over 1.25 px, then the payload
    re-decode and the in-frame check. Returns (corners (S, N, 4, 2), ok
    (S, N))."""
    cells = d.marker_bits + 2
    _, h, w = images.shape
    s, n = mask.shape

    def refine(seed, schedule):
        return _subpix_refine(images, seed.reshape(s, -1, 2),
                              schedule).reshape(s, n, 4, 2)

    def consensus(seed, schedule):
        return seed + _median(refine(seed, schedule) - seed, -2)

    quad = consensus(corners + velocity,
                     ((cfg.track_win, cfg.subpix_iters),))
    quad = consensus(quad, ((6, 4),))
    refined = refine(quad, ((3, 4), (2, 2)))
    refined = torch.where(torch.abs(refined - quad) > 1.25, quad, refined)

    bits, border_white = _sample_cells(images, refined, cells)
    payload = bits[..., 1:-1, 1:-1].reshape(s, n, -1)
    nm = d.num_markers
    table = torch.as_tensor(d.bits.reshape(nm, -1).astype(bool),
                            device=images.device)
    expected = table[torch.clamp(slot_ids, 0, nm - 1).long()]
    hamming = (payload ^ expected).sum(-1)
    slot_live = (slot_ids >= 0) & (slot_ids < nm)
    # the final window (half 3 + 1 px of gradient border) must fit
    margin = 4.0
    xs, ys = refined[..., 0], refined[..., 1]
    in_frame = ((xs > margin) & (xs < w - margin)
                & (ys > margin) & (ys < h - margin)).all(-1)
    ok = (mask & slot_live & in_frame
          & (border_white <= cfg.border_max_white)
          & (hamming <= cfg.max_hamming))
    return refined, ok


def detect_or_track_batch(images: torch.Tensor, corners: torch.Tensor,
                          mask: torch.Tensor, velocity: torch.Tensor,
                          do_full, cfg: DetectorConfig):
    """One streaming step of S streams sharing one full/track predicate,
    slot == id layout: (S, H, W) frames, (S, C, ...) state. ``do_full`` (a
    bool or a 0-d bool tensor, read on the host) picks the branch, and
    only the branch taken runs, on all S streams as one batch: the
    candidate sweep of the S frames, or tracking with the
    constant-velocity prior. Returns (corners, mask, velocity)."""
    if bool(do_full):
        det = detect_markers(images, cfg)
        nc, nm = det.corners, det.mask
    else:
        nc, nm = track_markers(images, corners, mask, cfg, velocity)
    return nc, nm, track_velocity(nc, nm, corners, mask)


def detect_or_track_batch_mapped(images: torch.Tensor, corners: torch.Tensor,
                                 mask: torch.Tensor, velocity: torch.Tensor,
                                 table_ids: torch.Tensor, do_full,
                                 cfg: DetectorConfig):
    """`detect_or_track_batch` with the S streams' (S, C) id->slot
    tables: full sweeps claim slots through each stream's table, tracked
    frames validate each slot against its marker id. Returns (corners,
    mask, velocity, table_ids)."""
    if bool(do_full):
        det, table_ids = detect_markers_mapped(images, cfg, table_ids)
        nc, nm = det.corners, det.mask
    else:
        nc, nm = track_markers(images, corners, mask, cfg, velocity,
                               slot_ids=table_ids)
    return nc, nm, track_velocity(nc, nm, corners, mask), table_ids


def detect_or_track(image: torch.Tensor, corners: torch.Tensor,
                    mask: torch.Tensor, velocity: torch.Tensor, do_full,
                    cfg: DetectorConfig):
    """`detect_or_track_batch` of one stream: an (H, W) frame, (C, ...)
    state. Returns (corners, mask, velocity)."""
    out = detect_or_track_batch(image[None], corners[None], mask[None],
                                velocity[None], do_full, cfg)
    return tuple(x[0] for x in out)


def detect_or_track_mapped(image: torch.Tensor, corners: torch.Tensor,
                           mask: torch.Tensor, velocity: torch.Tensor,
                           table_ids: torch.Tensor, do_full,
                           cfg: DetectorConfig):
    """`detect_or_track_batch_mapped` of one stream. Returns (corners,
    mask, velocity, table_ids)."""
    out = detect_or_track_batch_mapped(
        image[None], corners[None], mask[None], velocity[None],
        table_ids[None], do_full, cfg)
    return tuple(x[0] for x in out)


def streaming_init(cfg: DetectorConfig, streams: int | None = None,
                   mapped: bool = False, device=None):
    """Initial carry (corners, mask, velocity[, table_ids], frame index)
    of `streaming_step`, with a leading (S,) axis for ``streams``; the
    frame index is a host int."""
    lead = () if streams is None else (streams,)
    cr = (torch.zeros((*lead, cfg.capacity, 4, 2), device=device),
          torch.zeros((*lead, cfg.capacity), dtype=torch.bool,
                      device=device),
          torch.zeros((*lead, cfg.capacity, 4, 2), device=device))
    if mapped:
        cr = cr + (slot_table_init(cfg.capacity, device, streams),)
    return cr + (0,)


def streaming_step(cfg: DetectorConfig, track_every: int,
                   streams: int | None = None, mapped: bool = False,
                   rescue_cohorts: int = 0):
    """The detect-every-K step ``step(carry, frames) -> (carry, (corners,
    mask))``: a full sweep on the 2 bootstrap frames of every
    ``track_every``-frame period, validated tracking in between.
    ``mapped`` adds the id->slot table to the carry.

    One stream (``streams=None``, (H, W) frames): a sweep also runs at
    once whenever tracking has nothing left (a host read of the mask).
    ``streams=S`` ((S, H, W) frames): one schedule for the whole fleet
    and no per-stream rescue, so a tracked frame reads nothing back; a
    stream that lost everything waits for the next scheduled sweep.
    ``rescue_cohorts=G`` (dividing S) splits the fleet into G cohorts
    whose schedules are staggered by K/G frames, each swept at once when
    one of its streams lost everything (`_cohort_step`)."""
    ke = track_every
    if rescue_cohorts and streams:
        if streams % rescue_cohorts:
            raise ValueError(
                f"rescue_cohorts={rescue_cohorts} must divide "
                f"streams={streams}")
        return _cohort_step(cfg, ke, streams, rescue_cohorts, mapped)
    if streams is None:
        fwd = detect_or_track_mapped if mapped else detect_or_track
    else:
        fwd = detect_or_track_batch_mapped if mapped \
            else detect_or_track_batch

    def step(cr, im):
        i = cr[-1]
        do_full, = sweep_due(i, ke, 1, cr[1] if streams is None else None)
        out = fwd(im, *cr[:-1], do_full, cfg)
        return (*out, i + 1), out[:2]

    return step


def sweep_due(i: int, ke: int, cohorts: int = 1, mask=None) -> list[bool]:
    """The detect-every-K schedule of frame ``i``: for each of ``cohorts``
    cohorts, whether it sweeps. Cohort g sweeps on the 2 bootstrap frames
    of its ``ke``-frame period, shifted by g·K // G frames, and, given the
    previous frame's ``mask`` ((C,) for one stream, or (S, C) with each
    cohort's streams in a row), also when one of its streams tracked
    nothing; those flags come to the host in one read, made only where
    the schedule leaves a cohort to track."""
    due = [((i + g * ke // cohorts) % ke) < 2 for g in range(cohorts)]
    if mask is not None and not all(due):
        dead = (~mask.reshape(cohorts, -1, mask.shape[-1]).any(-1)).any(-1)
        due = [d or x for d, x in zip(due, dead.tolist())]
    return due


def _cohort_step(cfg: DetectorConfig, ke: int, streams: int, cohorts: int,
                 mapped: bool):
    """The fleet step with G staggered cohorts (see `streaming_step`):
    cohort g, streams g·S/G to (g+1)·S/G − 1, sweeps as `sweep_due` says
    (on its shifted schedule, or when one of its streams tracked nothing
    on the previous frame; one host read a frame). Where the
    JAX package runs one branch per cohort, every stream due a sweep
    runs in one sweep batch and every other stream in one tracked batch,
    scattered back in stream order: a stream's result does not depend on
    its batch-mates, so this is the cohort-by-cohort step bit for bit,
    with at most one candidate sweep and one tracked batch a frame
    whatever G."""
    per = streams // cohorts
    fwd = detect_or_track_batch_mapped if mapped else detect_or_track_batch

    def step(cr, im):
        state, i = cr[:-1], cr[-1]
        due = sweep_due(i, ke, cohorts, state[1])
        sweep = [j for j in range(streams) if due[j // per]]
        track = [j for j in range(streams) if not due[j // per]]
        if not sweep or not track:
            out = fwd(im, *state, bool(sweep), cfg)
        else:
            dev = im.device
            parts = [fwd(*(x.index_select(0, torch.tensor(ids, device=dev))
                           for x in (im, *state)), full, cfg)
                     for ids, full in ((sweep, True), (track, False))]
            back = torch.argsort(torch.tensor(sweep + track, device=dev))
            out = tuple(torch.cat(xs).index_select(0, back)
                        for xs in zip(*parts))
        return (*out, i + 1), out[:2]

    return step
