"""Front end, PnP (ops/pnp.py `solve_square_pnp` and the reprojection
gate): the span ``front_end.pnp``'s seconds summed over the window's
requests, in milliseconds a frame."""

from benchmark.spans import seconds_ms_per_frame


def read(record):
    return seconds_ms_per_frame(record, ("front_end.pnp",))
