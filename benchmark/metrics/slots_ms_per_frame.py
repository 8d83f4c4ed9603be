"""Front end, id->slot assignment (ops/detect.py `assign_sequence_lru`,
the sequential scan over a chunk; with ``--track-every`` the chunk's
streaming loop): the span ``front_end.slots``'s seconds summed over the
window's requests, in milliseconds a frame."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("front_end.slots",))
