"""Filter, the map's slots (filters/mekf.py, the dense state B3 and the
graphs work on): 100 x the slots that hold a landmark by each frame
(counter ``filter.map_slots_used``) over all the slots of every frame,
the capacity a frame (``filter.map_slots``), both summed over the
traced requests."""

from benchmark.counters import PROBES, total  # noqa: F401


def read(record):
    used = total(record, "filter.map_slots_used")
    slots = total(record, "filter.map_slots")
    if used is None or not slots:
        return None
    return 100.0 * used / slots
