"""What the span readers share: the program's own spans (run_slam's
``StageTimer`` stages), read two ways.

- Seconds: each window request's ``seconds`` holds every span's seconds
  summed by name (``front_end.sweep``, ``filter.scan``, ...), beside the
  three outside-in stages.
- Intervals: the traced requests' ``host_spans`` ((name, start us,
  duration us), the spans as the profiler's ``user_annotation`` ranges,
  on the device events' clock) and ``launches`` (start us of each host
  call that put work on the device), both inside the traced window, with
  the record's ``device_events``.

The intervals come from the same exported trace as the device events,
through the probe ``spans`` (``PROBES``): the traced window ends with
``torch.cuda.synchronize``, and the probe's record function hooks the
trace's next reduction once, which then hands these two lists, cut from
the same events at the same window, to a dict that the probe's calls in
the record hold. The reduction's own output is untouched.

A program without the spans gives none of these names, and every
function here then returns None.
"""

from __future__ import annotations

import bisect

from benchmark import trace
from benchmark.trace import _merged, union_seconds

REQUEST = "run_slam.request"
# host API calls that put work on the device: kernels, graphs, copies,
# fills (CUPTI may add a version suffix to a name)
LAUNCHES = ("cudaLaunchKernel", "cuLaunchKernel", "cudaGraphLaunch",
            "cudaMemcpyAsync", "cudaMemsetAsync")


def trace_keys(events: list) -> dict:
    """``host_spans`` (the annotations that start in the trace's window,
    the window's own left out) and ``launches`` (the sorted start us of
    the launching host calls in it) of Chrome-trace events."""
    win = [e for e in events if e.get("name") == trace.WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        return {}
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    spans = [(e["name"], float(e["ts"]), float(e.get("dur", 0.0)))
             for e in events if e.get("ph") == "X"
             and e.get("cat") == "user_annotation"
             and e.get("name") != trace.WINDOW and w0 <= float(e["ts"]) < w1]
    launches = sorted(float(e["ts"]) for e in events
                      if e.get("ph") == "X"
                      and e.get("cat") in ("cuda_runtime", "cuda_driver")
                      and str(e.get("name", "")).startswith(LAUNCHES)
                      and w0 <= float(e["ts"]) < w1)
    return {"host_spans": spans, "launches": launches}


def hook(*_args, **_kwargs) -> dict:
    """The probe's record function: hook ``trace.reduce_events`` for its
    next call (once, however often the probe fires) and return the dict
    that call fills with ``trace_keys`` of its events."""
    real = trace.reduce_events
    held = getattr(real, "spans_of_trace", None)
    if held is not None:
        return held
    held = {}

    def reduce_events(events, chips=1):
        trace.reduce_events = real
        out = real(events, chips)
        held.update(trace_keys(events))
        return out

    reduce_events.spans_of_trace = held
    trace.reduce_events = reduce_events
    return held


PROBES = {"spans": ("torch.cuda", "synchronize", hook)}


def traced(record: dict) -> dict:
    """The ``trace_keys`` the probe's calls hold, or {}."""
    for held in (record.get("calls") or {}).get("spans") or ():
        if held:
            return held
    return {}


def seconds_ms_per_frame(record: dict, names):
    """The named spans' seconds summed over the window's requests, in
    milliseconds a frame; None unless every request holds one of the
    names."""
    reqs = record.get("requests") or []
    if not reqs or any(not any(n in r["seconds"] for n in names)
                       for r in reqs):
        return None
    frames = sum(r["frames"] for r in reqs)
    secs = sum(r["seconds"].get(n, 0.0) for r in reqs for n in names)
    return 1e3 * secs / frames if frames else None


def merged_spans(record: dict, prefix: str) -> list:
    """The union of the traced spans whose name starts with ``prefix``,
    as sorted, disjoint [start, end] us."""
    return _merged([(a, a + d)
                    for n, a, d in traced(record).get("host_spans", ())
                    if n.startswith(prefix)])


def traced_frames(record: dict):
    """Frames of the traced requests: their count (``run_slam.request``
    spans) times the window requests' frames a request (one cell's
    requests all have the same)."""
    n = sum(1 for name, _, _ in traced(record).get("host_spans", ())
            if name == REQUEST)
    reqs = record.get("requests") or []
    if not n or not reqs:
        return None
    return n * sum(r["frames"] for r in reqs) / len(reqs)


def launches_per_frame(record: dict, prefix: str):
    """Launching host calls inside the ``prefix`` spans of the traced
    requests, over their frames."""
    spans = merged_spans(record, prefix)
    frames = traced_frames(record)
    launches = traced(record).get("launches")
    if not spans or not frames or launches is None:
        return None
    starts = [a for a, _ in spans]
    inside = 0
    for t in launches:
        j = bisect.bisect_right(starts, t) - 1
        if j >= 0 and t <= spans[j][1]:
            inside += 1
    return inside / frames


def idle_pct(record: dict, prefix: str):
    """100 x (1 - the union of the device events within the ``prefix``
    spans' union, over that union)."""
    spans = merged_spans(record, prefix)
    total = sum(b - a for a, b in spans)
    if total <= 0 or "device_events" not in record:
        return None
    starts = [a for a, _ in spans]
    busy = []
    for _, a, d in record["device_events"]:
        j = bisect.bisect_right(starts, a + d)
        while j > 0 and spans[j - 1][1] > a:
            j -= 1
            s0, s1 = spans[j]
            if min(s1, a + d) > max(s0, a):
                busy.append((max(s0, a), min(s1, a + d)))
    return 100.0 * (1.0 - union_seconds(busy) / total)
