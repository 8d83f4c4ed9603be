"""Batched SLAM over many independent sequences (data parallel).

Counterpart of aruco_slam_tpu/parallel/multi_slam.py on one card, so
without its device mesh: where the JAX package vmaps the filter over a
leading sequence axis, every field here carries that axis and a frame of
S streams steps together — one fused-update launch for all S
(`filters.mekf.mekf_step`).
"""

from __future__ import annotations

import torch

from aruco_slam_tpu_torch.filters import (
    FrameObservations, MekfConfig, MekfState, mekf_scan)


def stack_states(states: list[MekfState]) -> MekfState:
    """S unbatched states -> one state with a leading (S,) axis."""
    return MekfState(*(torch.stack(xs) for xs in zip(*states)))


def batched_mekf_scan(cfg: MekfConfig, states: MekfState,
                      obs: FrameObservations):
    """Run S independent MEKF sequences at once: ``states`` stacked over
    S (`stack_states`), ``obs`` fields (S, T, ...). Returns (final
    states (S, ...), trajectories (S, T, 7))."""
    if states.cov.dim() != 3 or obs.mask.dim() != 3:
        raise ValueError(f"batched_mekf_scan: states cov "
                         f"{tuple(states.cov.shape)}, obs mask "
                         f"{tuple(obs.mask.shape)}; expected (S, N, N) "
                         "and (S, T, C)")
    return mekf_scan(cfg, states, obs)


def batched_image_slam(dcfg, fcfg: MekfConfig, cam, marker_size: float,
                       images: torch.Tensor, states: MekfState):
    """The image->pose pipeline (slot == id detection, IPPE PnP, MEKF)
    over S streams at once: ``images`` (S, T, H, W) grayscale, ``states``
    stacked over S. Detection runs the S·T frames as one batch. Returns
    (final states (S, ...), trajectories (S, T, 7)); frames observing
    more than ``fcfg.max_obs`` slots drop the extras, counted in
    ``states.dropped_obs``."""
    from aruco_slam_tpu_torch.ops import detect, pnp
    s, t = images.shape[:2]
    det = detect.detect_markers(images.reshape(s * t, *images.shape[2:]),
                                dcfg)
    corners = det.corners.reshape(s, t, *det.corners.shape[1:])
    res = pnp.solve_square_pnp(cam, corners, marker_size)
    obs = FrameObservations(
        t_cl=res.t_cl, q_cl=res.q_cl,
        mask=det.mask.reshape(s, t, -1) & (res.err < 3.0))
    return batched_mekf_scan(fcfg, states, obs)
