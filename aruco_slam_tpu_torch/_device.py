"""Device resolution, float32 precision pins and the request stream.

The JAX MEKF traces its gain chain at full f32 (aruco_slam_tpu
filters/mekf.py `mekf_step`): at reduced matmul precision the
innovation covariance S = HPHᵀ + R comes out indefinite. TF32 keeps
about three decimal digits, so the port turns it off for matmuls and
for cuDNN alike.
"""

from __future__ import annotations

import contextlib

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


_REQUEST_STREAMS: dict = {}


def request_stream(device: torch.device):
    """A context that runs a request's device work on the card's request
    stream (one stream a card, made on first use; on the CPU, nothing).

    The MEKF scan captures its CUDA graphs on the caller's stream where
    that is not the default stream, which cannot capture
    (`filters.mekf._capture_stream`). cuBLAS keeps a workspace for each
    stream it runs on (32 MiB on an H100) and a graph keeps its capture
    stream's: with the request's eager work and the graphs on one
    stream, they share one workspace."""
    if device.type != "cuda":
        return contextlib.nullcontext()
    if device not in _REQUEST_STREAMS:
        _REQUEST_STREAMS[device] = torch.cuda.Stream(device)
    return torch.cuda.stream(_REQUEST_STREAMS[device])


def sync(device: torch.device) -> None:
    """Wait for ``device``'s queued work (nothing on the CPU)."""
    if device.type == "cuda":
        torch.cuda.synchronize(device)
