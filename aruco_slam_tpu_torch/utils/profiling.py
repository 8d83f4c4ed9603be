"""Stage timers and device traces.

Counterpart of aruco_slam_tpu/utils/profiling.py: `StageTimer`
accumulates wall time per stage and waits for the stage's result on its
device (`torch.cuda.synchronize` for CUDA tensors), so a stage's time is
its work and not the enqueue; `device_trace` records a `torch.profiler`
trace (the CPU activity, and the CUDA activity where a card is present)
and writes it as ``logdir/trace.json`` (Chrome trace format, as
Perfetto and chrome://tracing read it).
"""

from __future__ import annotations

import contextlib
import time
from collections import defaultdict
from pathlib import Path

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


class StageTimer:
    """Accumulating wall-clock timer that waits for the stage's result
    on its device, so stage costs are real and not dispatch-async
    artifacts."""

    def __init__(self) -> None:
        self.totals: dict[str, float] = defaultdict(float)
        self.counts: dict[str, int] = defaultdict(int)

    @contextlib.contextmanager
    def stage(self, name: str, result=None):
        """Time the block; pass its result as ``result`` or set
        ``out["result"]`` on the yielded dict to wait for it."""
        t0 = time.perf_counter()
        out = {}
        yield out
        res = out.get("result", result)
        if res is not None:
            _block_until_ready(res)
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def report(self) -> str:
        lines = []
        for name in sorted(self.totals, key=self.totals.get, reverse=True):
            t = self.totals[name]
            n = self.counts[name]
            lines.append(f"{name:24s} {t:8.3f}s total "
                         f"{1e3 * t / max(n, 1):8.2f} ms/call x{n}")
        return "\n".join(lines)


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
