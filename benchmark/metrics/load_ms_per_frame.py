"""Driver and input layer (apps/run_slam.py, io.NpzSource): the npz load's
wall milliseconds a frame, ``RunResult.seconds["load"]`` summed over the
window's requests (a fleet request's dict once) over their frames."""

from benchmark.records import stage_ms_per_frame


def read(record):
    return stage_ms_per_frame(record, "load")
