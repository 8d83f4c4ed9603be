"""Filter kernel B3 (filters/cuda_mekf.py + csrc/mekf_update.cu): the
least time of the traced calls of ``cuda_mekf.fused_update`` at their
(S, N, M) (`benchmark.roofline.b3`) over the summed device time of its
kernels' events."""

from benchmark.records import roofline_pct
from benchmark.roofline import b3


def _shapes(cov, h, r_diag, resid, ns_iters=20, *a, **k):
    s = cov.shape[0] if cov.dim() == 3 else 1
    return int(s), int(cov.shape[-1]), int(h.shape[-2]), int(ns_iters)


PROBES = {"b3": ("aruco_slam_tpu_torch.filters.cuda_mekf", "fused_update",
                 _shapes)}


def read(record):
    return roofline_pct(record, "b3", b3.KERNELS, b3.bound_ms)
