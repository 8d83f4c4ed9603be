"""B2, subpixel corner refinement (csrc/subpix.cu `refine_corners`):
least time of refining n corners with a (half window, iterations)
schedule on frames of ``elem`` bytes a pixel.

Per corner: 6 flops an interior patch pixel (gradients and projection)
and 12 a window pixel an iteration (weight x gx and x gy, five
multiply-adds) over the (2 half + 1)^2 pixels of each stage's window;
the patch (p x p pixels, p = 2 rad + 1) read once, the 8-byte seed in
and the 8-byte corner out.
"""

from __future__ import annotations

from benchmark.roofline.peaks import F32_PEAK, bound

KERNELS = ("subpix_kernel",)


def patch_radius(schedule) -> int:
    """The patch radius the schedule needs: every stage's window plus a
    1-px gradient border after the earlier stages' drift."""
    cum = rad = 0
    for half, _ in schedule:
        cum += half
        rad = max(rad, cum + half + 1)
    return rad


def work(n: int, schedule, elem: int):
    p = 2 * patch_radius(schedule) + 1
    window = sum(it * (2 * half + 1) ** 2 for half, it in schedule)
    return n * (6 * (p - 2) ** 2 + 12 * window), n * (p * p * elem + 16)


def bound_ms(n: int, schedule, elem: int) -> float:
    return bound(*work(n, schedule, elem), F32_PEAK)[0]
