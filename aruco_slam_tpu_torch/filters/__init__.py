"""Estimation backends: the point-landmark MEKF and its fused update
kernel (``cuda_mekf``)."""

from aruco_slam_tpu_torch.filters.mekf import (
    FrameObservations,
    MekfConfig,
    MekfState,
    init_state,
    mekf_scan,
    mekf_step,
)

__all__ = [
    "FrameObservations",
    "MekfConfig",
    "MekfState",
    "init_state",
    "mekf_scan",
    "mekf_step",
]
