"""Device resolution and float32 precision pins.

The JAX MEKF traces its gain chain at full f32 (aruco_slam_tpu
filters/mekf.py `mekf_step`): at reduced matmul precision the
innovation covariance S = HPHᵀ + R comes out indefinite. TF32 keeps
about three decimal digits, so the port turns it off for matmuls and
for cuDNN alike.
"""

from __future__ import annotations

import torch


def pin_precision() -> None:
    """Full-f32 matmuls and convolutions (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def resolve_device(platform: str) -> torch.device:
    """``"cuda"`` or ``"cpu"`` -> a torch device. ``"cuda"`` without a
    card raises: the port never carries on on the CPU in its place."""
    if platform == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("--platform cuda: no CUDA device is "
                               "available (torch.cuda.is_available() "
                               "is False)")
        return torch.device("cuda", torch.cuda.current_device())
    if platform == "cpu":
        return torch.device("cpu")
    raise ValueError(f"unknown platform {platform!r} (cuda | cpu)")
