"""Batched SLAM over many independent sequences (data parallel).

Counterpart of aruco_slam_tpu/parallel/multi_slam.py. Where the JAX
package vmaps the filter over a leading sequence axis, every field here
carries that axis and a frame of S streams steps together — one
fused-update launch for all S (`filters.mekf.mekf_step`).

JAX shards that axis over a device mesh. Here a stream mesh is a
sequence of torch devices, one entry per shard (`stream_mesh` gives every
card this process sees): S splits into equal contiguous blocks, block k
is copied to entry k, and the blocks' outputs come back stacked on the
first entry in stream order. Streams are independent, so the shards
exchange nothing while they filter.
"""

from __future__ import annotations

import contextlib
from typing import NamedTuple, Sequence

import torch

from aruco_slam_tpu_torch.filters import (
    FrameObservations, MekfConfig, MekfState, mekf_scan, mekf_step)
from aruco_slam_tpu_torch.filters.mekf import camera_pose


def stack_states(states: list[MekfState]) -> MekfState:
    """S unbatched states -> one state with a leading (S,) axis."""
    return MekfState(*(torch.stack(xs) for xs in zip(*states)))


def stream_mesh(device: torch.device) -> list[torch.device]:
    """The stream mesh of a process that runs on ``device``: every card it
    sees (``[cuda:0, ..., cuda:n-1]``) for a CUDA device, ``[device]``
    for the CPU — the counterpart of JAX's ``Mesh(np.array(
    jax.devices()), ("data",))``. A CUDA mesh holds no CPU entry."""
    device = torch.device(device)
    if device.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [device]


def _current(device: torch.device):
    """``device`` made current for the block (a card), or nothing to do
    (the CPU)."""
    if device.type == "cuda":
        return torch.cuda.device(device)
    return contextlib.nullcontext()


def _split(x: torch.Tensor, mesh: Sequence[torch.device]) -> list:
    """An (S, ...) tensor -> one block per mesh entry: S cut into equal
    contiguous blocks, block k copied to entry k. S not divisible by the
    mesh size raises, as JAX's sharding does."""
    s, n = x.shape[0], len(mesh)
    if n < 1 or s % n:
        raise ValueError(f"{s} streams do not split evenly over a stream "
                         f"mesh of {n} devices")
    per = s // n
    return [x[k * per:(k + 1) * per].to(dev) for k, dev in enumerate(mesh)]


def _blocks(tree: NamedTuple, mesh: Sequence[torch.device]) -> list:
    """`_split` of every field of a NamedTuple (None fields kept): one
    NamedTuple per mesh entry."""
    cols = [None if x is None else _split(x, mesh) for x in tree]
    return [type(tree)(*(None if c is None else c[k] for c in cols))
            for k in range(len(mesh))]


def _gather(parts: list, device: torch.device):
    """Per-shard outputs (a NamedTuple or a tensor each) -> one, stacked
    along the stream axis on ``device``."""
    def cat(xs):
        return torch.cat([x.to(device) for x in xs])
    if isinstance(parts[0], torch.Tensor):
        return cat(parts)
    return type(parts[0])(*(cat(xs) for xs in zip(*parts)))


def _scan_blocks(cfg: MekfConfig, states: list, obs: list,
                 mesh: Sequence[torch.device]):
    """Each shard's filter over its (S/n, T, ...) block, on its device.

    Frame by frame with the shard loop inside: frame i of every shard is
    queued before frame i + 1 of any, and nothing is read back, so each
    card starts on its first frame while the host still queues the
    others' — a shard loop outside the frame loop would leave the second
    card idle until the host had queued all T frames of the first. (One
    host thread per card would also overlap them, at the price of
    threads around PyTorch's per-thread current device.) Each step runs
    with its shard's device current; the kernels enter their tensors'
    device themselves (`_build.on_device`)."""
    trajs = [[] for _ in mesh]
    for i in range(obs[0].mask.shape[1]):
        for k, dev in enumerate(mesh):
            with _current(dev):
                states[k] = mekf_step(cfg, states[k], FrameObservations(*(
                    None if x is None else x[:, i] for x in obs[k])))
                trajs[k].append(camera_pose(states[k]))
    traj = [torch.stack(t, 1) if t else
            torch.zeros((*s.cam_t.shape[:-1], 0, 7), dtype=cfg.dtype,
                        device=s.cov.device)
            for t, s in zip(trajs, states)]
    return _gather(states, mesh[0]), _gather(traj, mesh[0])


def batched_mekf_scan(cfg: MekfConfig, states: MekfState,
                      obs: FrameObservations,
                      mesh: Sequence[torch.device] | None = None):
    """Run S independent MEKF sequences at once: ``states`` stacked over
    S (`stack_states`), ``obs`` fields (S, T, ...). With a stream
    ``mesh`` (a sequence of devices, `stream_mesh`) the S axis is split
    over its entries (S must divide evenly) and the outputs come back on
    the first. Returns (final states (S, ...), trajectories (S, T, 7))."""
    if states.cov.dim() != 3 or obs.mask.dim() != 3:
        raise ValueError(f"batched_mekf_scan: states cov "
                         f"{tuple(states.cov.shape)}, obs mask "
                         f"{tuple(obs.mask.shape)}; expected (S, N, N) "
                         "and (S, T, C)")
    if mesh is None:
        return mekf_scan(cfg, states, obs)
    return _scan_blocks(cfg, _blocks(states, mesh), _blocks(obs, mesh),
                        mesh)


def _image_observations(dcfg, cam, marker_size: float,
                        images: torch.Tensor) -> FrameObservations:
    """(S, T, H, W) frames -> (S, T, ...) observations: slot == id
    detection over the S·T frames as one batch, then IPPE PnP."""
    from aruco_slam_tpu_torch.ops import detect, pnp
    s, t = images.shape[:2]
    det = detect.detect_markers(images.reshape(s * t, *images.shape[2:]),
                                dcfg)
    corners = det.corners.reshape(s, t, *det.corners.shape[1:])
    res = pnp.solve_square_pnp(cam, corners, marker_size)
    return FrameObservations(
        t_cl=res.t_cl, q_cl=res.q_cl,
        mask=det.mask.reshape(s, t, -1) & (res.err < 3.0))


def batched_image_slam(dcfg, fcfg: MekfConfig, cam, marker_size: float,
                       images: torch.Tensor, states: MekfState,
                       mesh: Sequence[torch.device] | None = None):
    """The image->pose pipeline (slot == id detection, IPPE PnP, MEKF)
    over S streams at once: ``images`` (S, T, H, W) grayscale, ``states``
    stacked over S. Detection runs the S·T frames as one batch. With a
    stream ``mesh`` each block of streams is detected, solved and
    filtered on its own entry (its frames, states and the camera copied
    there first), as JAX's ``device_put`` of images and states shards the
    whole pipeline. Returns (final states (S, ...), trajectories (S, T,
    7)); frames observing more than ``fcfg.max_obs`` slots drop the
    extras, counted in ``states.dropped_obs``."""
    if mesh is None:
        return batched_mekf_scan(
            fcfg, states, _image_observations(dcfg, cam, marker_size,
                                              images))
    frames = _split(images, mesh)
    blocks = _blocks(states, mesh)
    obs = []
    for dev, ims in zip(mesh, frames):
        with _current(dev):
            obs.append(_image_observations(dcfg, cam.to(device=dev),
                                           marker_size, ims))
    return _scan_blocks(fcfg, blocks, obs, mesh)
