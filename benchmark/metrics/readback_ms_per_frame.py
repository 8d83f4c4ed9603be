"""Host-device copies, device to host: the spans ``front_end.readback``
and ``filter.readback`` summed over the window's requests, in
milliseconds a frame: the first read of each waits for the device's
queued work, so this is the time the host waits on the card."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("front_end.readback",
                                         "filter.readback"))
