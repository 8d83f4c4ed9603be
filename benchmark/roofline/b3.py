"""B3, the MEKF's fused update (csrc/mekf_update.cu `fused_update`):
least time of one call on S streams of state dimension N and M
measurement rows.

The chain's f32 FLOPs: PH^T, S = HPH^T + R, ``iters`` Newton–Schulz
steps, K, K·resid, KH, the two Joseph products and KRK^T. P, H, r and
resid are read once, the innovation and P' written once.
"""

from __future__ import annotations

from benchmark.roofline.peaks import F32_PEAK, bound

KERNELS = ("gemm_kernel", "ns_cluster", "ns_cluster_cols", "newton_schulz")


def work(streams: int, n: int, m: int, iters: int = 20):
    flops = (3 * 2 * n * n * m + 2 * m * m * n + iters * 4 * m ** 3
             + 2 * n * m * m + 2 * n * m + 4 * n ** 3)
    return streams * flops, streams * 4 * (2 * n * n + m * n + 2 * m + n)


def bound_ms(streams: int, n: int, m: int, iters: int = 20) -> float:
    return bound(*work(streams, n, m, iters), F32_PEAK)[0]
