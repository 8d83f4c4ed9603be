"""Driver and output (apps/run_slam.py, io.TrajectoryWriter, save_map,
the ATE): the span ``output.write``'s seconds summed over the window's
requests, in milliseconds a frame."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("output.write",))
