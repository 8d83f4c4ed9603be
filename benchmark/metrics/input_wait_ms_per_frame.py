"""Driver and input layer, the npz clip's reader thread
(io.ChunkReader): the span ``input.wait``, the chunk step's wait for
the reader to finish inflating the next chunk into its ring slot,
summed over the window's requests, in milliseconds a frame. A program
without the reader has no such span, and the reader returns None."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("input.wait",))
