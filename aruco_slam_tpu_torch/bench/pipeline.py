"""The corners -> PnP -> MEKF pipeline the benches time, and their
timing rule.

Counterpart of aruco_slam_tpu/bench/pipeline.py's `make_pipeline`: one
definition of the hot path that `bench/headline.py` and
`bench/large_map.py` measure, so chunking and gating cannot diverge
between them. The JAX module's on-device timing loop and XLA cost count
are TPU tooling; the benches here time with `seconds_per_call`.
"""

from __future__ import annotations

import time

import torch

from aruco_slam_tpu_torch.filters import FrameObservations, mekf_scan
from aruco_slam_tpu_torch.ops import pnp


def make_pipeline(cam, marker_size: float, fcfg, chunk: int = 16,
                  reproj_gate: float = 3.0):
    """Returns ``pipeline(state, corners_seq, mask_seq) -> (final_state,
    trajectory)``: corners (T, C, 4, 2) and mask (T, C) with trajectory
    (T, 7), or a leading stream axis on all three, corners (S, T, C, 4,
    2) with ``state`` stacked over S (`parallel.multi_slam.stack_states`)
    and trajectory (S, T, 7).

    The PnP solves are frame-independent, so they run outside the
    sequential filter, ``chunk`` frames of every stream a call, which
    bounds the solver's intermediates. A frame count that ``chunk`` does
    not divide is zero-padded to the next multiple (the padded solves
    are discarded), so a prime T costs at most one extra chunk. One
    `mekf_scan` then steps all S streams frame by frame; observations
    whose reprojection error reaches ``reproj_gate`` px are masked out.
    """

    def pipeline(state, corners_seq, mask_seq):
        t = corners_seq.shape[-4]
        ch = min(chunk, t)
        pad = (-t) % ch
        if pad:
            lead = corners_seq.shape[:-4]
            corners_seq = torch.cat([corners_seq, corners_seq.new_zeros(
                (*lead, pad, *corners_seq.shape[-3:]))], dim=-4)
        parts = [pnp.solve_square_pnp(cam, corners_seq[..., i:i + ch, :, :, :],
                                      marker_size)
                 for i in range(0, t + pad, ch)]

        def merge(name, time_axis):
            out = torch.cat([getattr(p, name) for p in parts], time_axis)
            return out.narrow(time_axis, 0, t)

        obs = FrameObservations(
            t_cl=merge("t_cl", -3), q_cl=merge("q_cl", -3),
            mask=mask_seq & (merge("err", -2) < reproj_gate))
        return mekf_scan(fcfg, state, obs)

    return pipeline


def sync(device: torch.device) -> None:
    """Wait for the card's queued work (nothing to wait for on the
    CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def device_name(device: torch.device) -> str:
    """What a bench row names its device by: the card's name, or
    "cpu"."""
    if device.type == "cuda":
        return torch.cuda.get_device_name(device)
    return "cpu"


def seconds_per_call(fn, reps: int, device: torch.device, warm=None
                     ) -> float:
    """The benches' timing rule: one warm call (``warm()``, else
    ``fn(0)``), then ``fn(0)`` .. ``fn(reps - 1)`` between two
    synchronizations of the card, on the host clock; seconds a call."""
    (warm or (lambda: fn(0)))()
    sync(device)
    t0 = time.perf_counter()
    for i in range(reps):
        fn(i)
    sync(device)
    return (time.perf_counter() - t0) / reps
