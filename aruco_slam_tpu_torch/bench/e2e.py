"""End-to-end image->pose benchmark: the full SLAM pipeline on the card.

Counterpart of aruco_slam_tpu/bench/e2e.py, flag for flag: renders a
synthetic 1080p marker sequence on the host (cached), then times the
complete pipeline on the device — image-domain detection (B1 labeling
and B2 subpixel refinement, one detection batch of ``--chunk`` frames
of every stream a call), batched IPPE PnP and the MEKF scan (B3 once a
frame) — and prints one JSON row with the stage split (detect, PnP,
MEKF ms a frame, timed on the same program shapes).

    python -m aruco_slam_tpu_torch.bench.e2e [--frames 128]     # a card
    python -m aruco_slam_tpu_torch.bench.e2e --platform cpu \\
        --frames 8 --chunk 4                                    # the CPU

Every timed call's input is varied by a wrap-safe XOR of the low pixel
bits (per rep, and per stream for a fleet), as in the JAX bench: the
markers' 255 cells stay white, so detection is unaffected, and a fleet
is eight distinct streams, not one stream eight times. Returns the row.
"""

from __future__ import annotations

import argparse
import json
import os
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.bench import synthetic
from aruco_slam_tpu_torch.bench.pipeline import (
    device_name, make_pipeline, seconds_per_call)
from aruco_slam_tpu_torch.bench.render import render_sequence
from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.filters import (
    FrameObservations, MekfConfig, init_state, mekf_scan)
from aruco_slam_tpu_torch.ops import detect, pnp
from aruco_slam_tpu_torch.parallel.multi_slam import stack_states

# the benches' 1080p camera (the JAX benches' K and distortion)
K = ((1414.9, 0.0, 967.0), (0.0, 1414.9, 544.3), (0.0, 0.0, 1.0))
DIST = (0.0614, -0.2951, 0.0005, 0.0029, 0.4387)
SIZE = (1920, 1080)
CAPACITY = 64
# timed calls: REPS for one stream, max(2, REPS // S) for S streams
REPS = 8
# rendered frames are cached here, under names of this package's own
CACHE_DIR = Path(tempfile.gettempdir())
DEGRADE = {"blur": dict(blur_sigma=1.5),
           "noise": dict(noise_sigma=8.0),
           "combined": dict(blur_sigma=1.0, noise_sigma=6.0,
                            vignette_strength=0.4)}


def camera(device=None) -> cam_mod.CameraModel:
    return cam_mod.CameraModel.from_matrix(
        np.asarray(K, np.float32), np.asarray(DIST, np.float32),
        device=device)


def rendered_frames(name: str, scene, traj) -> np.ndarray:
    """(T, 1080, 1920) uint8 frames of ``scene`` along ``traj``, rendered
    on the host once and cached as CACHE_DIR/``name``."""
    cache = CACHE_DIR / name
    try:
        frames = np.load(cache)["frames"]
        print(f"# loaded cached frames from {cache}", flush=True)
    except (FileNotFoundError, KeyError):
        t0 = time.perf_counter()
        frames = render_sequence(scene, traj, camera(), image_size=SIZE)
        # write then rename, so a reader never sees half a file
        tmp = cache.with_suffix(f".{os.getpid()}.npz")
        np.savez(tmp, frames=frames)
        os.replace(tmp, cache)
        print(f"# rendered {len(frames)} frames in "
              f"{time.perf_counter() - t0:.1f}s (host)", flush=True)
    return frames


def degraded(frames: np.ndarray, kind: str) -> np.ndarray:
    """The frames degraded by `bench.degrade` with DEGRADE[kind], frame i
    with seed i (numpy on the host, frames on a thread pool)."""
    from aruco_slam_tpu_torch.bench import degrade
    t0 = time.perf_counter()
    with ThreadPoolExecutor(min(8, os.cpu_count() or 1)) as pool:
        out = np.stack(list(pool.map(
            lambda a: degrade.degrade(a[1], seed=a[0], **DEGRADE[kind]),
            enumerate(frames))))
    print(f"# degraded ({kind}) in {time.perf_counter() - t0:.1f}s (host)",
          flush=True)
    return out


def detect_sequence(images: torch.Tensor, dcfg, chunk: int,
                    track_every: int = 0, rescue_cohorts: int = 0):
    """The bench's detection: (T, H, W) frames of one stream, or (S, T,
    H, W) of a fleet -> (corners (..., T, C, 4, 2), mask (..., T, C)),
    slot == id. Full detection runs a batch of ``chunk`` frames of every
    stream a call; with ``track_every`` K the streaming step runs frame
    by frame (a fleet's S streams at once, with ``rescue_cohorts``)."""
    lead = images.shape[:-3]
    t = images.shape[-3]
    c = dcfg.capacity
    if not track_every:
        cs, ms = [], []
        for i in range(0, t, chunk):
            ims = images[..., i:i + chunk, :, :]
            n = ims.shape[-3]
            det = detect.detect_markers(ims.reshape(-1, *ims.shape[-2:]),
                                        dcfg)
            cs.append(det.corners.reshape(*lead, n, c, 4, 2))
            ms.append(det.mask.reshape(*lead, n, c))
        return torch.cat(cs, -4), torch.cat(ms, -2)
    streams = lead[0] if lead else None
    step = detect.streaming_step(dcfg, track_every, streams=streams,
                                 rescue_cohorts=rescue_cohorts)
    carry = detect.streaming_init(dcfg, streams=streams,
                                  device=images.device)
    cs, ms = [], []
    for i in range(t):
        carry, (cr, m) = step(carry, images.select(-3, i).contiguous())
        cs.append(cr)
        ms.append(m)
    return torch.stack(cs, -4), torch.stack(ms, -2)


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=128)
    p.add_argument("--markers", type=int, default=10)
    p.add_argument("--chunk", type=int, default=16)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    p.add_argument("--detector", default="robust",
                   choices=["robust", "fast"],
                   help="robust = the default 3-pass (window x scale) "
                        "candidate sweep (survives blur/noise/clutter"
                        "); fast = single coarse pass for clean scenes")
    p.add_argument("--track-every", type=int, default=0, metavar="K",
                   help="streaming mode: full detection on 2 of every "
                        "K frames (velocity bootstrap), cheap corner "
                        "tracking + decode-validation in between "
                        "(ops/detect.streaming_step). Renders a "
                        "video-rate trajectory (10x slower orbit) so "
                        "inter-frame motion is physical. K >= 3")
    p.add_argument("--video-rate", action="store_true",
                   help="use the sliced 10x-longer orbit (what "
                        "--track-every implies) without tracking — "
                        "for apples-to-apples full-vs-tracked runs")
    p.add_argument("--streams", type=int, default=1, metavar="S",
                   help="serve S independent video streams at once "
                        "(one detection batch and one filter step for "
                        "all S). Reports aggregate and per-stream fps")
    p.add_argument("--rescue-cohorts", type=int, default=0,
                   metavar="G",
                   help="fleet streaming only: split the --streams "
                        "fleet into G schedule cohorts (staggered "
                        "K/G apart) so a stream that loses every "
                        "marker triggers an immediate full sweep of "
                        "its own cohort instead of waiting out the "
                        "period (ops/detect.streaming_step)")
    p.add_argument("--degrade", default=None,
                   choices=["blur", "noise", "combined"],
                   help="degrade the rendered frames host-side "
                        "(bench/degrade.py) before measuring — the "
                        "conditions the robust multi-pass sweep "
                        "exists for; detection quality shows up in "
                        "mean_detections_per_frame")
    return p


def main(argv=None) -> dict:
    p = _parser()
    args = p.parse_args(argv)
    if args.track_every and args.track_every < 3:
        p.error("--track-every needs K >= 3")
    device = resolve_device(args.platform)
    cam = camera(device)
    scene = synthetic.make_wall_scene(num_markers=args.markers, seed=0)
    video_rate = bool(args.track_every or args.video_rate)
    if video_rate:
        # tracking needs video-rate motion; the whole orbit squeezed
        # into `frames` jumps tens of px per frame
        traj = synthetic.Trajectory(*(a[:args.frames] for a in
                                      synthetic.make_orbit_trajectory(
                                          num_frames=10 * args.frames)))
    else:
        traj = synthetic.make_orbit_trajectory(num_frames=args.frames)
    tag = "vr" if video_rate else "orbit"
    frames = rendered_frames(
        f"aruco_slam_tpu_torch_e2e_{tag}_{args.frames}_{args.markers}.npz",
        scene, traj)
    if args.degrade:
        frames = degraded(frames, args.degrade)

    dcfg = detect.with_preset(detect.DetectorConfig(capacity=CAPACITY),
                              args.detector)
    fcfg = MekfConfig(capacity=CAPACITY)
    marker_size = scene.marker_size
    t, ch, ke, ns = args.frames, args.chunk, args.track_every, args.streams
    fleet = ns > 1
    tail = make_pipeline(cam, marker_size, fcfg, chunk=ch)

    images = torch.from_numpy(frames).to(device)
    streams = torch.arange(ns, device=device)

    def jittered(ims, i):
        """Rep i's input: one stream XORed with i % 2, or the fleet's S
        streams, stream j XORed with (j + i) % 3."""
        if not fleet:
            return ims ^ (i % 2)
        jit = ((streams + i) % 3).to(torch.uint8)[:, None, None, None]
        return ims[None] ^ jit

    if fleet:
        states0 = stack_states([init_state(fcfg, device=device)] * ns)
    else:
        states0 = init_state(fcfg, device=device)
    reps = REPS if not fleet else max(2, REPS // ns)

    def detect_seq(ims):
        return detect_sequence(ims, dcfg, ch, ke, args.rescue_cohorts)

    def e2e(ims):
        return tail(states0, *detect_seq(ims))

    dt = seconds_per_call(lambda i: e2e(jittered(images, i)), reps, device,
                          warm=lambda: e2e(jittered(images ^ 2, 0)))
    fps = ns * t / dt

    # the stage split, each stage timed alone on the program shapes of
    # the run above (a fleet's on the fleet's, per stream)
    sreps = max(2, reps)
    cs, ms = detect_seq(jittered(images, 0))
    res0 = pnp.solve_square_pnp(cam, cs, marker_size)
    obs = FrameObservations(res0.t_cl, res0.q_cl, ms & (res0.err < 3.0))
    dt_detect = seconds_per_call(
        lambda i: detect_seq(jittered(images, i)), sreps, device,
        warm=lambda: detect_seq(jittered(images ^ 2, 0))) / ns
    dt_pnp = seconds_per_call(
        lambda i: pnp.solve_square_pnp(cam, cs + (i % 2) * 1e-4,
                                       marker_size),
        sreps, device,
        warm=lambda: pnp.solve_square_pnp(cam, cs + 1e-3,
                                          marker_size)) / ns
    dt_mekf = seconds_per_call(
        lambda i: mekf_scan(fcfg, states0, obs._replace(
            t_cl=obs.t_cl + (i % 2) * 1e-6)),
        sreps, device,
        warm=lambda: mekf_scan(fcfg, states0, obs._replace(
            t_cl=obs.t_cl + 1e-3))) / ns
    totals = {"detect": dt_detect, "pnp": dt_pnp, "mekf": dt_mekf}
    for name, secs in totals.items():
        print(f"# {name:8s} {1e3 * secs / t:8.3f} ms/frame")

    row = {
        "metric": "e2e_image_to_pose_fps_per_chip",
        "value": round(fps, 1),
        "unit": "frames/s",
        "resolution": f"{SIZE[0]}x{SIZE[1]}",
        "detector": args.detector,
        "device": device_name(device),
    }
    if args.degrade:
        row["degrade"] = args.degrade
    if fleet:
        row["streams"] = ns
        row["per_stream_fps"] = round(fps / ns, 1)
        # the detect/pnp/mekf ms fields are measured on the fleet's own
        # program (per stream and frame)
        row["stage_split"] = "fleet"
    if ke:
        row["track_every"] = ke
    if args.rescue_cohorts:
        row["rescue_cohorts"] = args.rescue_cohorts
    # observation quality rides along: tracked-mode drops show up as a
    # lower per-frame detection count than a full-sweep run on the
    # same --video-rate trajectory
    row["mean_detections_per_frame"] = round(
        float(ms.reshape(-1, CAPACITY).sum(1).float().mean()), 2)
    for name, secs in totals.items():
        row[f"{name}_ms_per_frame"] = round(1e3 * secs / t, 4)
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
