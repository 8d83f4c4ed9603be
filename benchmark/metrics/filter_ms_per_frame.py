"""Filter (filters/mekf.py, parallel/multi_slam.batched_mekf_scan):
``seconds["filter"]`` summed over the window's requests, in milliseconds
a frame."""

from benchmark.records import stage_ms_per_frame


def read(record):
    return stage_ms_per_frame(record, "filter")
