"""The traced requests of a ``--trace 1`` run.

The requests run under torch.profiler (host and device activity) inside
one annotation, ``bench.window``, whose length is the traced window.
While they run, the kernel wrappers the cell's metric readers name in
their ``PROBES`` are wrapped so that each call's shapes are recorded
(the call itself is unchanged). From the exported trace the run keeps
the device events (kernels, copies, fills) inside the window, the union
of their intervals (``busy_s``), the ten device operations that took the
most time and the idle gaps summed by what the host was doing.
"""

from __future__ import annotations

import bisect
import contextlib
import importlib
import json
import os
import tempfile
from pathlib import Path

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
HOST_CATS = ("cpu_op", "cuda_runtime", "cuda_driver")
WINDOW = "bench.window"


def probes(per_layer) -> dict:
    """name -> (module, attribute, shape-recording function) of every
    probe the cell's readers declare."""
    out = {}
    for _, reader in per_layer:
        out.update(getattr(reader, "PROBES", {}))
    return out


@contextlib.contextmanager
def _probed(specs: dict, calls: dict):
    """Wrap each probed function for the block; record its shapes."""
    undo = []
    try:
        for name, (mod_name, attr, shapes) in specs.items():
            try:
                mod = importlib.import_module(mod_name)
            except ImportError:
                continue
            real = getattr(mod, attr, None)
            if real is None:
                continue
            calls.setdefault(name, [])

            def wrapped(*a, _real=real, _shapes=shapes, _name=name, **k):
                calls[_name].append(_shapes(*a, **k))
                return _real(*a, **k)

            wrapped.__dict__.update(real.__dict__)
            setattr(mod, attr, wrapped)
            undo.append((mod, attr, real))
        yield
    finally:
        for mod, attr, real in reversed(undo):
            setattr(mod, attr, real)


def union_seconds(intervals) -> float:
    """Length of the union of (start, end) intervals, in their unit."""
    total, end = 0.0, None
    start = None
    for a, b in sorted(intervals):
        if end is None or a > end:
            if end is not None:
                total += end - start
            start, end = a, b
        else:
            end = max(end, b)
    if end is not None:
        total += end - start
    return total


def _merged(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce_events(events: list, chips: int = 1) -> dict:
    """Chrome-trace events -> the traced record: device events inside
    the window (name, start us, duration us), ``busy_s`` (the union of
    their intervals over the chips, averaged), ``window_s`` and the
    breakdown."""
    win = [e for e in events if e.get("name") == WINDOW
           and e.get("ph") == "X" and e.get("cat") == "user_annotation"]
    if not win:
        raise ValueError("the trace holds no window annotation")
    w0 = float(win[0]["ts"])
    w1 = w0 + float(win[0]["dur"])
    dev = []
    for e in events:
        if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS:
            a = max(float(e["ts"]), w0)
            b = min(float(e["ts"]) + float(e.get("dur", 0.0)), w1)
            if b > a:
                dev.append((e["name"], a, b - a, e.get("pid")))
    by_chip = {}
    for _, a, d, pid in dev:
        by_chip.setdefault(pid, []).append((a, a + d))
    busy_us = sum(union_seconds(iv) for iv in by_chip.values())
    busy_s = busy_us * 1e-6 / max(chips, 1)
    totals = {}
    for name, _, d, _ in dev:
        name = name[:120]  # a templated kernel's name runs to hundreds
        totals[name] = totals.get(name, 0.0) + d * 1e-6
    device_ops = sorted(totals.items(), key=lambda kv: -kv[1])[:10]
    # idle gaps of the device (all chips merged), named by the host
    # operation that overlaps each most
    merged = _merged([(a, a + d) for _, a, d, _ in dev])
    gaps, prev = [], w0
    for a, b in merged:
        if a > prev:
            gaps.append((prev, a))
        prev = max(prev, b)
    if w1 > prev:
        gaps.append((prev, w1))
    host = sorted(((float(e["ts"]), float(e["ts"]) + float(e.get("dur", 0)),
                    e["name"]) for e in events
                   if e.get("ph") == "X" and e.get("cat") in HOST_CATS),
                  key=lambda h: h[0])
    starts = [h[0] for h in host]
    by_host = {}
    for a, b in gaps:
        best, label = 0.0, "host outside any op"
        j = bisect.bisect_right(starts, b)
        for h0, h1, name in host[max(0, j - 200):j]:
            ov = min(b, h1) - max(a, h0)
            if ov > best:
                best, label = ov, name
        n, s = by_host.get(label, (0, 0.0))
        by_host[label] = (n + 1, s + (b - a) * 1e-6)
    idle = sorted(((f"{k} x{n}", s) for k, (n, s) in by_host.items()),
                  key=lambda kv: -kv[1])[:10]
    return {"device_events": [(n, a, d) for n, a, d, _ in dev],
            "busy_s": busy_s, "window_s": (w1 - w0) * 1e-6,
            "breakdown": {"device_ops": [list(x) for x in device_ops],
                          "idle_gaps": [list(x) for x in idle]}}


def run(fn, specs: dict, platform: str, chips: int = 1) -> dict:
    """Run ``fn()`` traced: {"value": its value, "record": the reader
    record's trace part, "breakdown": ...}."""
    import torch
    from torch.profiler import ProfilerActivity, profile, record_function
    acts = [ProfilerActivity.CPU]
    if platform == "cuda":
        acts.append(ProfilerActivity.CUDA)
        torch.cuda.synchronize()
    calls = {}
    with profile(activities=acts) as prof:
        with _probed(specs, calls), record_function(WINDOW):
            value = fn()
            if platform == "cuda":
                torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        events = json.loads(Path(path).read_text())["traceEvents"]
    finally:
        os.unlink(path)
    red = reduce_events(events, chips)
    record = {"device_events": red["device_events"],
              "busy_s": red["busy_s"], "window_s": red["window_s"],
              "calls": calls}
    return {"value": value, "record": record,
            "breakdown": red["breakdown"]}
