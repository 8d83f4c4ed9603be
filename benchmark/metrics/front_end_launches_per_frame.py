"""Front end: host calls that put work on the device (kernel launches,
async copies and fills) inside any ``front_end.*`` span of the traced
requests, over their frames."""

from benchmark.spans import PROBES, launches_per_frame  # noqa: F401


def read(record):
    return launches_per_frame(record, "front_end.")
