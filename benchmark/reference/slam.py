"""The plain reference of one `run_slam` request.

What `aruco_slam_tpu_torch.apps.run_slam.main` computes for an npz clip
(or a fleet of them), written again from the benchmark's frozen plain
modules: the detector with its id->slot table (`detect`, labeling and
subpixel refinement in plain PyTorch), IPPE PnP (`pnp`) and the MEKF
(`mekf`, the plain fused update). It reads the same npz files the
program reads and nothing the program made, and returns per stream the
camera trajectory, the accepted observations and the map.

A fleet with full detection is S independent streams, so it runs stream
by stream; a tracked fleet couples its streams through the rescue
cohorts' shared sweeps, so it steps all S together, as the program's
fleet does.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from benchmark.reference import camera as cam_mod
from benchmark.reference import detect, mekf, pnp

CHUNK = 32  # run_slam's front-end chunk


class StreamResult(NamedTuple):
    cam_traj: np.ndarray   # (T, 7) [xyz, quat wxyz]
    obs_mask: np.ndarray   # (T, C) accepted observations
    landmark_ids: np.ndarray  # (L,) marker ids of the map
    landmarks: np.ndarray  # (L, 3) landmark positions


def pin_precision() -> None:
    """Full-f32 matmuls and convolutions on a card (no TF32)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False


def _camera(data: dict, device) -> cam_mod.CameraModel:
    return cam_mod.CameraModel.from_matrix(
        np.asarray(data["camera_matrix"], np.float32),
        np.asarray(data["dist_coeffs"], np.float32), device=device)


def _detector_config(cfg: dict) -> detect.DetectorConfig:
    return detect.with_preset(
        detect.DetectorConfig(capacity=cfg["capacity"],
                              dict_name=cfg["dict"]), cfg["detector"])


def _mekf_config(cfg: dict, capacity: int, cam, marker_size: float
                 ) -> mekf.MekfConfig:
    f = cfg["filter_params"]
    return mekf.MekfConfig(
        capacity=capacity, max_obs=cfg["max_obs"],
        with_rotations=cfg["filter"] == "mekf_rotations",
        r_uncertainty=f["mekf_r"], q_uncertainty_cam=f["mekf_q_cam"],
        q_error_uncertainty_cam=f["mekf_q_rot"],
        q_uncertainty_lm=f["mekf_q_lm"],
        motion_model=f["mekf_motion_model"], q_vel=f["mekf_q_vel"],
        vel_decay=f["vel_decay"], matmul_precision="highest",
        pixel_sigma=f["pixel_sigma"], focal_px=float(cam.fx),
        marker_size=marker_size, gate_distance=f["gate_distance"])


def _pnp(cam, corners, marker_size: float, max_reproj: float, det_m):
    res = pnp.solve_square_pnp(cam, corners, marker_size)
    mask = det_m & (res.err < max_reproj)
    amb = res.err / torch.clamp(res.err2, min=1e-9)
    return res.t_cl, res.q_cl, mask, amb


def _stream_images(frames: np.ndarray, cam, cfg: dict, device):
    """One stream's frames through full detection (32-frame chunks, the
    tail zero-padded) and PnP: (t_cl, q_cl, mask, amb) (T, C, ...) on the
    device and the final id->slot table."""
    dcfg = _detector_config(cfg)
    table = detect.slot_table_init(dcfg.capacity, device)
    seen = torch.zeros(dcfg.capacity, dtype=torch.int32, device=device)
    outs = []
    for f0 in range(0, len(frames), CHUNK):
        ims = frames[f0:f0 + CHUNK]
        n = len(ims)
        if n < CHUNK:
            ims = np.concatenate(
                [ims, np.zeros((CHUNK - n,) + ims.shape[1:], ims.dtype)])
        det_c, det_m, _, _, table, seen, _ = detect.detect_markers_batch_lru(
            torch.from_numpy(ims).to(device), dcfg, table, seen, f0)
        outs.append([x[:n] for x in _pnp(
            cam, det_c, cfg["marker_size"], cfg["max_reproj_px"], det_m)])
    return [torch.cat([o[i] for o in outs]) for i in range(4)], table


def _fleet_tracked(frames: np.ndarray, cam, cfg: dict, track: dict,
                   device):
    """(S, T, H, W) frames through the streaming tracker, all S streams
    stepping together (one schedule, or ``rescue_cohorts`` cohorts), and
    PnP: (t_cl, q_cl, mask, amb) (S, T, C, ...) and the tables (S, C)."""
    dcfg = _detector_config(cfg)
    s = frames.shape[0]
    streams = s if s > 1 else None
    kw = dict(rescue_cohorts=track["rescue_cohorts"]) if streams else {}
    step = detect.streaming_step(dcfg, track["track_every"],
                                 streams=streams, mapped=True, **kw)
    carry = detect.streaming_init(dcfg, streams=streams, mapped=True,
                                  device=device)
    outs = []
    for f0 in range(0, frames.shape[1], CHUNK):
        ims = torch.from_numpy(np.ascontiguousarray(
            frames[:, f0:f0 + CHUNK])).to(device)
        per_frame = []
        for im in ims.transpose(0, 1).contiguous():
            carry, out = step(carry, im if streams else im[0])
            per_frame.append(out)
        det_c, det_m = (torch.stack(x, 1) if streams else
                        torch.stack(x)[None] for x in zip(*per_frame))
        outs.append(_pnp(cam, det_c, cfg["marker_size"],
                         cfg["max_reproj_px"], det_m))
    tables = carry[3] if streams else carry[3][None]
    return [torch.cat([o[i] for o in outs], 1) for i in range(4)], tables


def _filter(fcfg, t_cl, q_cl, mask, amb, device):
    """The MEKF over (T, ...) or (S, T, ...) observations: (trajectory,
    active, landmark positions)."""
    batched = mask.dim() == 3
    state = mekf.init_state(fcfg, device=device)
    if batched:
        s = mask.shape[0]
        state = mekf.MekfState(*(torch.stack([x] * s) for x in state))
    state, traj = mekf.mekf_scan(fcfg, state, mekf.FrameObservations(
        t_cl.float(), q_cl.float(), mask, amb.float(), None))
    return (traj.cpu().numpy(), state.active.cpu().numpy(),
            state.lm.cpu().numpy()[..., :3])


def run(clips: list[dict], cfg: dict, track: dict | None,
        device) -> list[StreamResult]:
    """The reference of one request: ``clips`` are the npz files' arrays
    (one a stream), ``cfg`` the configuration's run_slam settings,
    ``track`` the traffic's tracker settings (None: full detection)."""
    pin_precision()
    data = clips[0]
    cam = _camera(data, device)
    marker_size = float(data["marker_size"])
    cfg = dict(cfg, marker_size=marker_size)
    capacity = cfg["capacity"]
    fcfg = _mekf_config(cfg, capacity, cam, marker_size)
    out = []
    with torch.no_grad():
        if "corners" in data:
            for d in clips:
                t_cl, q_cl, mask, amb = _pnp(
                    cam, torch.as_tensor(d["corners"], dtype=torch.float32,
                                         device=device),
                    marker_size, cfg["max_reproj_px"],
                    torch.as_tensor(d["corner_mask"], device=device))
                traj, active, lm = _filter(fcfg, t_cl, q_cl, mask, amb,
                                           device)
                slots = np.where(active)[0]
                out.append(StreamResult(traj, mask.cpu().numpy(), slots,
                                        lm[slots]))
            return out
        tlen = min(len(d["times"]) for d in clips)
        if track:
            frames = np.stack([d["images"][:tlen] for d in clips])
            obs, tables = _fleet_tracked(frames, cam, cfg, track, device)
            traj, active, lm = _filter(fcfg, *obs, device)
            tables = tables.cpu().numpy()
            mask = obs[2].cpu().numpy()
            for i in range(len(clips)):
                slots = np.where(active[i])[0]
                out.append(StreamResult(traj[i], mask[i],
                                        tables[i][slots], lm[i][slots]))
            return out
        for d in clips:
            obs, table = _stream_images(d["images"][:tlen], cam, cfg,
                                        device)
            traj, active, lm = _filter(fcfg, *obs, device)
            slots = np.where(active)[0]
            out.append(StreamResult(traj, obs[2].cpu().numpy(),
                                    table.cpu().numpy()[slots], lm[slots]))
            del obs
    return out
