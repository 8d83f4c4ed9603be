"""Detector kernel B2 (ops/cuda_subpix.py + csrc/subpix.cu): the least
time of the traced calls of ``cuda_subpix.refine_corners`` at their
corner counts, schedules and pixel sizes (`benchmark.roofline.b2`) over
the summed device time of its kernel's events."""

from benchmark.records import roofline_pct
from benchmark.roofline import b2


def _shapes(image, corners, schedule, *a, **k):
    n = corners.shape[0] * corners.shape[1]
    return int(n), tuple(tuple(int(x) for x in s) for s in schedule), \
        int(image.element_size())


PROBES = {"b2": ("aruco_slam_tpu_torch.ops.cuda_subpix", "refine_corners",
                 _shapes)}


def read(record):
    return roofline_pct(record, "b2", b2.KERNELS, b2.bound_ms)
