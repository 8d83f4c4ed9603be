"""Host-device copies, host to device: the spans ``front_end.upload``
(each chunk's frames, or the corners) and ``filter.upload`` (the
observations) summed over the window's requests, in milliseconds a
frame."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("front_end.upload",
                                         "filter.upload"))
