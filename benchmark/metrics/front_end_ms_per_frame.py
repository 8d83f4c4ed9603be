"""Front end (ops/detect.py, ops/pnp.py; the fleet's part of
run_multi_stream): ``seconds["front_end"] - seconds["load"]`` (the
front end's time is taken from the same start as the load) summed over
the window's requests, in milliseconds a frame."""

from benchmark.records import stage_ms_per_frame


def read(record):
    return stage_ms_per_frame(record, "front_end", minus="load")
