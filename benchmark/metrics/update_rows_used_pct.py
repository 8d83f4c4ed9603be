"""Filter, the fused update's rows (filters/mekf.py, B3): 100 x the rows
that carry an observation (counter ``filter.update_rows``) over all the
rows B3 was given, M a frame (``filter.update_row_slots``), both summed
over the traced requests."""

from benchmark.counters import PROBES, total  # noqa: F401


def read(record):
    rows = total(record, "filter.update_rows")
    slots = total(record, "filter.update_row_slots")
    if rows is None or not slots:
        return None
    return 100.0 * rows / slots
