"""B1, the detector's labeling (csrc/flood_scan.cu `flood_scan_labels`):
least time of one call on a (B, h, w) mask.

The least int32 work a pixel: a 3x3 min-stencil round is 2 vertical and
2 horizontal mins and 1 select (background stays); a segmented-scan pass
1 min and 1 select; a scan round 4 passes (rows and columns, forward and
backward). ``per`` = max(1, iters // (rounds + 1)) stencil rounds open
the schedule and follow each scan round. The mask is read once (1 byte a
pixel) and the int32 labels written once.
"""

from __future__ import annotations

from benchmark.roofline.peaks import INT32_PEAK, bound

STENCIL_OPS = 5
SCAN_PASS_OPS = 2
# the port's kernels of this schedule, by the names a device trace shows
KERNELS = ("stencil_rounds", "scan_rows", "scan_cols")


def work(shape, iters: int, rounds: int):
    """(int32 operations, bytes) of one call on a ``shape`` mask."""
    px = 1
    for d in shape:
        px *= int(d)
    per = max(1, iters // (rounds + 1)) if rounds else iters
    ops = px * (STENCIL_OPS * per * (rounds + 1) + SCAN_PASS_OPS * 4 * rounds)
    return ops, px * 5


def bound_ms(shape, iters: int, rounds: int) -> float:
    return bound(*work(shape, iters, rounds), INT32_PEAK)[0]
