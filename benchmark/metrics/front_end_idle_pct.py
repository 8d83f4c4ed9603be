"""Front end: 100 x (1 - the union of the device events inside the union
of the traced requests' ``front_end.*`` spans, over that union): how much
of the front end's host time the card sat idle."""

from benchmark.spans import PROBES, idle_pct  # noqa: F401


def read(record):
    return idle_pct(record, "front_end.")
