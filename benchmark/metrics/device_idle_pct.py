"""Device (H100): 100 - the share of the traced window in which some
device event (kernel, copy, fill) ran, from the union of their
intervals, so overlapping events count once."""


def read(record):
    window = record.get("window_s") or 0.0
    if window <= 0 or "busy_s" not in record:
        return None
    return 100.0 * (1.0 - record["busy_s"] / window)
