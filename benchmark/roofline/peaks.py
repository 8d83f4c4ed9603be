"""Peaks of one NVIDIA H100 SXM, and the bound that uses them.

F32_PEAK and HBM_RATE are NVIDIA's published data-sheet figures (dense,
at the 700 W limit). INT32_PEAK is derived, not published: 132 SMs x 64
int32 min/compare lanes x 1.98 GHz boost clock. A run prints the card's
power limit beside every share.
"""

from __future__ import annotations

F32_PEAK = 67e12                 # FLOP/s, f32 outside the tensor cores
INT32_PEAK = 132 * 64 * 1.98e9   # op/s, derived (see above)
HBM_RATE = 3.35e12               # bytes/s


def bound(ops: float, nbytes: float, peak: float):
    """The least time the card could take (ms) and what sets it: the
    operations at ``peak`` against the bytes at HBM_RATE."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")
