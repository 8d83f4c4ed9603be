"""Stage timers, spans and device traces.

Counterpart of aruco_slam_tpu/utils/profiling.py: `StageTimer`
accumulates wall time per stage and, given the stage's result, waits
for it on its device (`torch.cuda.synchronize` for CUDA tensors), so a
stage's time is its work and not the enqueue. Each stage is also a span:
its name, start, end and enclosing span are kept in memory on the timer
(`StageTimer.spans`), and while a torch.profiler runs, and only then,
the stage opens a `record_function` range of its name, so the span lands
in the profiler's trace as a ``user_annotation`` on the device events'
clock. With no profiler running a span only reads the clock twice and
checks for one (a few microseconds of Python). Beside the spans the
timer keeps counters (`StageTimer.count`, summed by name in
`StageTimer.counters`): numbers the host already holds, counted without
touching the device. `device_trace` records
a `torch.profiler` trace (the CPU activity, and the CUDA activity where
a card is present) and writes it as ``logdir/trace.json`` (Chrome trace
format, as Perfetto and chrome://tracing read it).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path
from typing import NamedTuple

import torch


def _leaves(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, (tuple, list)):
        for x in tree:
            yield from _leaves(x)
    elif isinstance(tree, dict):
        for x in tree.values():
            yield from _leaves(x)


def _block_until_ready(result) -> None:
    """Wait for every CUDA device that holds a tensor of ``result``."""
    for dev in {x.device for x in _leaves(result) if x.is_cuda}:
        torch.cuda.synchronize(dev)


class Span(NamedTuple):
    """One timed stage: ``time.perf_counter`` seconds; ``parent`` is the
    index in `StageTimer.spans` of the span it opened inside, -1 for
    none."""

    name: str
    start: float
    end: float
    parent: int


class StageTimer:
    """Accumulating wall-clock timer by stage name, the record of every
    stage as a span, and counters by name. ``request_id`` goes with each
    span's profiler range, so the spans of one request share it."""

    def __init__(self, request_id: str | None = None) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)
        self.counters: dict[str, int] = defaultdict(int)
        # in the order they opened; an open span's place holds None
        self.spans: list[Span | None] = []
        self.request_id = request_id
        self._open: list[int] = []

    def stage(self, name: str, result=None) -> "_Stage":
        """Time the block as the span ``name``. Pass its result as
        ``result`` or set ``out["result"]`` on the yielded dict to wait
        for it before the span ends; without one the span waits for
        nothing."""
        return _Stage(self, name, result)

    def count(self, name: str, n: int) -> None:
        """Add ``n`` to the counter ``name``."""
        self.counters[name] += int(n)


class _Stage:
    """The context manager of one `StageTimer.stage` call."""

    __slots__ = ("timer", "name", "result", "out", "index", "parent",
                 "start", "annotation")

    def __init__(self, timer: StageTimer, name: str, result) -> None:
        self.timer, self.name, self.result = timer, name, result
        self.annotation = None

    def __enter__(self) -> dict:
        t = self.timer
        if torch.autograd._profiler_enabled():
            self.annotation = torch.profiler.record_function(
                self.name, t.request_id)
            self.annotation.__enter__()
        spans, stack = t.spans, t._open
        self.index = len(spans)
        self.parent = stack[-1] if stack else -1
        spans.append(None)  # the span's place, in the order spans open
        stack.append(self.index)
        self.out = {}
        self.start = time.perf_counter()
        return self.out

    def __exit__(self, exc_type, exc, tb) -> None:
        try:
            res = self.out.get("result", self.result)
            if res is not None and exc_type is None:
                _block_until_ready(res)
        finally:
            end = time.perf_counter()
            t = self.timer
            t._open.pop()
            t.spans[self.index] = Span(self.name, self.start, end,
                                       self.parent)
            t.totals[self.name] += end - self.start
            t.counts[self.name] += 1
            if self.annotation is not None:
                self.annotation.__exit__(exc_type, exc, tb)


@contextlib.contextmanager
def device_trace(logdir: str | None):
    """torch.profiler trace of the block, written to
    ``logdir/trace.json``. A falsy logdir is a no-op, so call sites can
    write ``with device_trace(args.profile):`` unconditionally."""
    if not logdir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    cuda = torch.cuda.is_available()
    activities = [ProfilerActivity.CPU] + (
        [ProfilerActivity.CUDA] if cuda else [])
    with profile(activities=activities) as prof:
        try:
            yield
        finally:
            if cuda:  # the trace holds the block's device work
                torch.cuda.synchronize()
    path = Path(logdir)
    path.mkdir(parents=True, exist_ok=True)
    prof.export_chrome_trace(str(path / "trace.json"))
