"""Detector kernel B1 (ops/cuda_cc.py + csrc/flood_scan.cu): the least
time of the traced calls of ``cuda_cc.flood_scan_labels`` at their
shapes (`benchmark.roofline.b1`) over the summed device time of its
kernels' events."""

from benchmark.records import roofline_pct
from benchmark.roofline import b1


def _shapes(fg, iters, scan_rounds, *a, **k):
    return tuple(fg.shape), int(iters), int(scan_rounds)


PROBES = {"b1": ("aruco_slam_tpu_torch.ops.cuda_cc", "flood_scan_labels",
                 _shapes)}


def read(record):
    return roofline_pct(record, "b1", b1.KERNELS, b1.bound_ms)
