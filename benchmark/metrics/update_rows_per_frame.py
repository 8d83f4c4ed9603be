"""Filter, the fused update's rows (filters/mekf.py, B3): the rows that
carry an observation, the counter ``filter.update_rows`` (min(accepted
observations, max_obs) x 3 a frame for point landmarks, x 7 with their
rotations), summed over the traced requests, over their frames."""

from benchmark.counters import PROBES, total, traced_frames  # noqa: F401


def read(record):
    rows = total(record, "filter.update_rows")
    frames = traced_frames(record)
    if rows is None or not frames:
        return None
    return rows / frames
