"""Filter, the scan (filters/mekf.py `mekf_scan`,
parallel/multi_slam.batched_mekf_scan: the eager step launched frame by
frame): the span ``filter.scan``'s seconds summed over the window's
requests, in milliseconds a frame."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("filter.scan",))
