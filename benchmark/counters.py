"""What the counter readers share: the program's own counters (run_slam's
``StageTimer.count``: ``filter.update_rows``, ``filter.update_row_slots``),
read from the traced requests.

The probe ``counters`` (``PROBES``) wraps run_slam's ``_serve(argv,
timer)``, one request's body under its root span, for the traced
requests, and records each call's timer's ``counters``: the dict the
request then fills, summed over a fleet's streams. A program whose timer
keeps no counters records None, and every function here then returns
None.
"""

from __future__ import annotations


def held(*args, **kwargs):
    """The probe's record function: the counters dict of the call's
    timer, or None."""
    for x in (*args, *kwargs.values()):
        counters = getattr(x, "counters", None)
        if isinstance(counters, dict):
            return counters
    return None


PROBES = {"counters": ("aruco_slam_tpu_torch.apps.run_slam", "_serve",
                       held)}


def traced(record: dict) -> list:
    """The counters of each traced request that kept any."""
    return [c for c in (record.get("calls") or {}).get("counters") or ()
            if c]


def total(record: dict, name: str):
    """The counter ``name`` summed over the traced requests, or None
    unless each of them counted it."""
    held_ = traced(record)
    if not held_ or any(name not in c for c in held_):
        return None
    return sum(c[name] for c in held_)


def traced_frames(record: dict):
    """Frames of the traced requests: their count times the window
    requests' frames a request (one cell's requests all have the same)."""
    n = len(traced(record))
    reqs = record.get("requests") or []
    if not n or not reqs:
        return None
    return n * sum(r["frames"] for r in reqs) / len(reqs)
