"""Headline benchmark: the marker-SLAM frame pipeline, frames/s a card.

Counterpart of the JAX repository's root ``bench.py``: PnP from pixel
corners and the MEKF (`bench.pipeline.make_pipeline`, chunk 64) in two
shapes:

* one stream: one video of FRAMES frames at the default filter (the
  fused update kernel, B3, once a frame), the shape the reference's
  sequential CPU loop runs; and
* serving: BATCH independent sequences (the same geometry, pixel noise
  of their own) through one pipeline call, the filter in its XLA-form
  Newton–Schulz update at "mixed" precision, as the JAX bench runs it.

The row's value is the batched rate; ``vs_baseline`` divides it by the
reference EKF's measured CPU rate at the same observation boundary
(REFERENCE_FPS). The ride-along fields come from `bench.e2e` (robust
1080p image->pose, streaming with --track-every 8, 8-camera serving)
and `bench.large_map` (its default run and its bf16 covariance), each
from its own ``main``. A field that fails raises: the row is printed
only when every field was measured.

    python -m aruco_slam_tpu_torch.bench.headline              # a card

Prints one JSON line and returns it.
"""

from __future__ import annotations

import argparse
import contextlib
import io
import json

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.bench import e2e, large_map, synthetic
from aruco_slam_tpu_torch.bench.pipeline import (
    device_name, make_pipeline, seconds_per_call)
from aruco_slam_tpu_torch.filters import MekfConfig, init_state
from aruco_slam_tpu_torch.parallel.multi_slam import stack_states

REFERENCE_FPS = 45.1  # the reference EKF on the CPU, BASELINE_MEASURED.md

FRAMES = 512
CAPACITY = 64
MARKERS = 8
BATCH = 256
CHUNK = 64
SINGLE_REPS = 8
BATCH_REPS = 2
# the ride-along benches' arguments
E2E_FRAMES = 128
TRACK_EVERY = 8
SERVING_FRAMES = 64
SERVING_STREAMS = 8
# large_map at its defaults (3 reps), so that its standalone run and
# this row's fields are one measurement; JAX's headline passed 2
LARGE_MAP_ARGS = ()


def _quiet(main, argv) -> dict:
    """A bench's row, its own printing kept out of this one's output."""
    with contextlib.redirect_stdout(io.StringIO()):
        return main(argv)


def ride_along(platform: str) -> dict:
    """The e2e and large-map fields, each bench at the JAX headline's
    arguments (the large map's at its defaults)."""
    dev = ["--platform", platform]
    frames = ["--frames", str(E2E_FRAMES)]
    robust = _quiet(e2e.main, frames + dev)
    streaming = _quiet(e2e.main, frames + ["--track-every",
                                           str(TRACK_EVERY)] + dev)
    serving = _quiet(e2e.main, ["--frames", str(SERVING_FRAMES),
                                "--streams", str(SERVING_STREAMS)] + dev)
    big = _quiet(large_map.main, list(LARGE_MAP_ARGS) + dev)
    big16 = _quiet(large_map.main, list(LARGE_MAP_ARGS)
                   + ["--cov-dtype", "bf16"] + dev)
    return {"robust_e2e_fps": robust["value"],
            "robust_e2e_frames": E2E_FRAMES,
            "streaming_fps": streaming["value"],
            "streaming_track_every": TRACK_EVERY,
            "serving_fps_per_stream": serving["per_stream_fps"],
            "serving_streams": SERVING_STREAMS,
            "large_map_fps": big["value"],
            "large_map_ate_m": big["ate_m"],
            "ba_lm_iters_per_s": round(large_map.BA_ITERS
                                       / big["offline_ba_s"], 2),
            "large_map_bf16_fps": big16["value"],
            "large_map_bf16_ate_m": big16["ate_m"]}


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    args = p.parse_args(argv)
    device = resolve_device(args.platform)
    cam = e2e.camera(device)
    scene = synthetic.make_wall_scene(num_markers=MARKERS, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=FRAMES)
    corners, mask = synthetic.observe_corners(
        scene, traj, e2e.camera(), CAPACITY, noise_px=0.3, seed=1)

    fcfg = MekfConfig(capacity=CAPACITY)
    # serving: the XLA-form Newton-Schulz update, bf16 covariance
    # products with the gain chain pinned at f32
    fcfg_b = fcfg._replace(update_kernel=False, s_solver="ns",
                           matmul_precision="mixed")
    corners_d = torch.tensor(corners, dtype=torch.float32, device=device)
    mask_d = torch.tensor(mask, device=device)
    # BATCH sequence variants: shared geometry, distinct pixel noise
    rng = np.random.default_rng(7)
    corners_b = torch.tensor(
        corners[None] + rng.normal(0, 0.3, (BATCH,) + corners.shape),
        dtype=torch.float32, device=device)
    mask_b = mask_d.expand(BATCH, *mask.shape)

    single = make_pipeline(cam, scene.marker_size, fcfg, chunk=CHUNK)
    batched = make_pipeline(cam, scene.marker_size, fcfg_b, chunk=CHUNK)
    state0 = init_state(fcfg, device=device)
    states_b = stack_states([init_state(fcfg_b, device=device)] * BATCH)
    dt = seconds_per_call(lambda i: single(state0, corners_d, mask_d),
                          SINGLE_REPS, device)
    single_fps = FRAMES / dt
    dtb = seconds_per_call(lambda i: batched(states_b, corners_b, mask_b),
                           BATCH_REPS, device)
    batched_fps = BATCH * FRAMES / dtb
    row = {
        "metric": "mekf_pipeline_fps_per_chip",
        "value": round(batched_fps, 1),
        "unit": "frames/s",
        "device": device_name(device),
        "vs_baseline": round(batched_fps / REFERENCE_FPS, 2),
        "batch": BATCH,
        "single_stream_fps": round(single_fps, 1),
    }
    row.update(ride_along(args.platform))
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
