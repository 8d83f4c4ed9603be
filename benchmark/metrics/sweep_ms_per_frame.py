"""Front end, candidate sweep (ops/detect.py `detect_candidates_batch`:
B1, B2 and their glue over a chunk): the span ``front_end.sweep``'s
seconds summed over the window's requests, in milliseconds a frame."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("front_end.sweep",))
