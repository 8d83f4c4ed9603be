#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's paths once on one GPU.

    python3 chip_smoke.py            # from the repository root, one card

Phases (each prints its own lines; any failure raises and exits
non-zero, and no result line is printed):

1. device     — torch/CUDA versions, the card, nvidia-smi's name and
                power limit; no CUDA device is an error.
2. build      — nvcc builds every kernel in aruco_slam_tpu_torch/csrc
                (one nvcc per source, in parallel).
3. kernels    — each kernel's wrapper against its plain PyTorch version
                on the card, at its path's shapes, with the stated
                tolerance: B1 labeling (the chunk's grids, the fleet
                streaming path's for 8 streams and for one cohort's 2,
                and a dist rank's 16-frame chunk), B2 subpixel
                refinement (the detector's schedule and the tracker's
                three over the chunk, the tracker's real call, one
                frame x 64 corners, the fleet streaming path's sweep
                and tracked batches, and a dist rank's 16-frame chunk;
                each also without iterations), B3 MEKF
                update (point mode N = 201, M = 48; rotation mode N =
                393, M = 112, and M = 224 at --max-obs 32; and 8
                streams in one batched launch
                against the plain version and against 8 single-stream
                launches; P' exactly symmetric; which Newton–Schulz
                path the C entry point took), B4 stencil-only labeling
                (also forced to at most 8, 6 and 4 rounds a launch),
                B5 patch-fed refinement (refine_corners' 12,288 patches
                and the calibration CLI's 24 and 12 x 24 chessboard
                corners), the PnP kernel (a corners request's 128 x 64
                slots and a chunk's 32 x 64, every output bit-identical);
                B3 also at the bench drivers' shapes (the
                large map's N = 1545, M = 144 and the headline's 256
                streams of N = 198, M = 48, inputs captured from their
                filters run with the kernel), timed beside the XLA-form
                update those drivers run. Times: `ms` and `plain_ms` are
                the median of one call on an idle card (host time
                between launches included), `device_ms` and
                `plain_device_ms` device time (20 calls queued behind a
                spin of the card, so host time between launches is not
                counted), each beside its roofline bound; B1 and B3 also
                split into launch groups by CUDA events the C entry
                point records, and B3 is timed in every Newton–Schulz
                form that takes its M.
4. main path  — 32 rendered 1920x1080 frames through
                `aruco_slam_tpu_torch.apps.run_slam.main` (robust
                detector, PnP, MEKF at the run_slam defaults): output
                files, ATE, detections, and every kernel's launch count
                in that run; then the frame rate of a second, warm run.
5. refine_corners path — `detect.refine_corners` over the 32 frames
                (launches B5, not B2): median error against the
                rendered corners.
6. stencil-only path — `detect_markers_batch_lru` on the 32 frames with
                `fine_scan_rounds=0`: B4 labels the fine pass, B1 the
                two coarse ones.
7. streaming path — `run_slam.main(... --track-every 8)` on the same
                frames, cold (which frames took a full sweep, launch
                counts, ATE, tracked-frame detections against the main
                run) and warm (frames/s beside the main path's).
8. rotations path — `run_slam.main(... --filter mekf_rotations)` on the
                same frames, cold (ATE, one update launch per frame,
                unit landmark quaternions) and warm (frames/s).
9. recycling path — a 720x405 sequence whose marker cohort changes
                mid-run (ids 0-4, then 20-24) at `--capacity 5
                --slot-max-age 2`: second-cohort ids in the map, the
                table's resets and drops on the card equal the CPU's.
10. fleet path — `run_slam.main(["--input", "s0.npz,...,s7.npz", ...])`:
                8 1080p streams (four distinct 32-frame sequences, each
                twice), cold (each stream within 1e-4 m of its
                single-stream run, duplicates identical, B1/B2/B3
                launched, B3 once per frame) and warm (aggregate
                frames/s, peak device memory).
11. fleet streaming — the same 8 streams with `--track-every 8`, one
                schedule (G = 0) and 4 rescue cohorts (G = 4), cold
                (B1 and B2 launched once a fleet frame, frame by frame
                exactly as the step's sweep decisions say: G = 0 makes
                3 B1 launches a sweep frame and 3 B2 launches a tracked
                one for all 8 streams, 24 and 80 a chunk; B3 once a
                frame; each G =
                0 stream within 1e-4 m of its own single-stream
                `--track-every 8` run, which swept only on its schedule,
                duplicates identical; cohort 0 likewise at G = 4, every
                stream's ATE under the bound) and warm (aggregate
                frames/s beside the full-detection fleet's, seconds
                split into load, front end less load, and filter).
12. prefetch    — the main path's frames, from a generator standing in
                for a video decoder, through `io.PrefetchingFrameSource`
                into the front end: the same observations as fed
                directly, and the main run's.
13. factorgraph — `run_slam.main(... --filter factorgraph)` on the main
                frames, cold (ATE, exactly 3 B1 and 1 B2 launches and no
                B3) and warm (frames/s, front end and graph seconds).
14. factorgraph online — bench/factorgraph.py's run at full size (300
                frames, 12 markers, pose budget 128, window 8, 3
                iterations): the marginalizations, exactly after frames
                125, 189 and 253; ATE under 0.1 m; warm frames/s; the
                device-busy share and device events a frame of 16 frames
                under torch.profiler; the card against the CPU at float64
                over 140 frames (trajectory and landmarks within 1e-6 m).
15. offline    — `run_offline.main` on the main frames (3 B1, 1 B2, no
                B3; ATE; the map), then the large-map batch solve: 512
                markers, a 512-frame raster, corners with 0.3 px noise,
                `--iters 40` (514 poses, H_pp 3084 x 3084): ingest and
                solve seconds, the final cost (finite, no higher than the
                ingested state's), ATE, peak device memory, and the
                solve's device-busy share under torch.profiler.
16. fleet-ba   — `run_offline --fleet 1x1` on the fleet's four image
                inputs at float64 (the four problems batched on the
                card), then `--fleet 2x2 --local-devices 4`: each sequence
                within 1e-5 m of its own single run, B1 3 and B2 1 a
                sequence, no B3; the warm solve's seconds and device
                events an iteration against one problem's.
17. sharded-ba — the large map's ingested state through
                `sharded_batch_optimize` in one process at local devices
                2 and 4: f32 seconds, events and busy share against the
                unsharded solve; f64 within 1e-8 (cost, relative) and
                1e-6 m of it.
18. dist       — two processes on the one card over Gloo:
                `run_offline --processes 2 --f64` on the main frames
                (B1 3 and B2 1 on each rank, for the chunk it owns;
                observations bit-identical to the single front end's;
                within 1e-5 m of the single run), then the large map's
                saved ingested state through the sharded solve in two
                rank processes (`chip_smoke.py --rank-child` and
                `--rank-solve` are those processes): seconds, device
                events an iteration and busy share traced on rank 0,
                the ranks' results bit-equal, f64 within 1e-6 m of the
                unsharded.
19. undistort  — `core/camera.undistort_image` on the card against the
                CPU at 1280x720 and 1920x1080 (within one gray level),
                ms a call (run with the kernels, before the paths).
20. calibrate  — `apps.calibrate.main` at the reference's configuration
                (7x5 ChArUco, 30/15 mm, AprilTag 36h11) on 12 rendered
                1280x720 views (tests/test_calibrate.py's camera and view
                recipe, seed 0), `--iters 60 --preview 2`: exactly one
                B5 launch and the detector's B1 and B2, the intrinsics
                within tests/test_calibrate.py's tolerances, the previews
                read back by `io.read_png_gray`, cold and warm stage
                seconds, the LM's device events an iteration and busy
                share; the same CLI on the CPU within 1e-4 (camera
                matrix, relative); `calibrate` on the grid board's
                correspondences, the card against the CPU at f64 within
                1e-9.
21. checkpoint — `run_slam --checkpoint-every 8` on the main frames and a
                run resumed from its last checkpoint (frame 24), in the
                default mode a user runs: bit-identical for mekf,
                mekf_rotations (B3 once a resumed frame), the factor
                graph and run_offline's ingest; for the last two also
                two uninterrupted runs bit-identical.
22. profile    — `run_slam --profile DIR`: DIR/trace.json holds device
                events of B1, B2 and B3, the trajectory bit-identical.
23. make-synthetic — the default pose-level bundle (300 frames, 12
                markers) through run_slam on the card (ATE), and
                `--images --video-rate --frames 8` bit-identical to this
                script's render of the same orbit.
24. viz        — plain `--viz-3d` (matplotlib) and `--export-video`
                (cv2, or imageio with pyav) refuse before reading or
                writing anything where their library is missing, and
                run and write their files where it is installed; then
                `run_slam --viz-2d --viz-3d --viz-3d-renderer fast
                --display` on the main frames without a display server:
                the MEKF steps once a frame (B1 3, B2 1, B3 32), the
                trajectory bit-identical to the main run's, the headless
                note, 32 overlays (540x960x3, mean above 60) and 32 map
                frames read back by `io.read_png_rgb`; warm frames/s
                beside the main path's, the host ms a frame by stage
                (step, read, draw_2d, raster_3d, png), and the
                device-busy share of a viewer run and a main-path run.
25. viz-graph  — `run_slam --filter factorgraph --viz-2d`, and
26. viz-offline — `run_offline --viz-2d --viz-3d --viz-3d-renderer
                fast`, each equal to its run without viewers: one PNG a
                frame, B1 3, B2 1, no B3.
27. degraded   — the main frames degraded by `bench/degrade.py`'s blur,
                motion, noise, lighting, combined and lowlight presets
                (tests/test_detect.py's), and `combined` on the scene
                rendered over `degrade.clutter_background((1080, 1920),
                seed=7)`: B1 3 and B2 1 a run, no id outside the ground
                truth in any frame, ATE under 0.3 m for blur, noise,
                lighting, combined and the clutter (printed for motion
                and lowlight), frames/s and detections a frame against
                the clean run.
28. bench-e2e  — `bench/e2e.py`'s main at its defaults (128 rendered
                1080p frames, chunk 16) in five modes: default,
                --track-every 8, --streams 8, --streams 8 --track-every 8
                --rescue-cohorts 4, --degrade combined: the row; B1, B2
                and B3 launched exactly 3 and 1 a detection batch, 3 B2 a
                tracked batch and 1 B3 a filter step (the calls counted
                in the run); detections a frame beside run_slam's on the
                same frames (equal in the default mode).
29. detect-profile — `bench/detect_profile.py` (16 frames): the
                detector's stages, adding up to its total.
30. large-map  — `bench/large_map.py` at its defaults (512 markers, 512
                frames, batch 8, the XLA-form update: no B3) and with
                --cov-dtype bf16: the rows, ATE under 0.3 m (default),
                peak device memory.
31. headline   — `bench/headline.py`: the 512-frame single stream (B3 a
                frame) and 256 sequences, with its ride-along fields; its
                e2e and large-map runs at [bench-e2e]'s and [large-map]'s
                arguments reuse those rows.
32. fleet-sharded — `run_slam.main` on the four distinct fleet inputs
                with the stream mesh forced to the card twice (run_slam's
                own `multi_slam.stream_mesh`, doubled): JAX's `sharding 4
                streams over 2 devices` line, each stream within 1e-4 m
                of the unsharded fleet's, B1 3, B2 1 and B3 twice a frame
                (a shard each); warm aggregate frames/s beside [fleet]'s.
33. entry      — `entry.entry()`'s frame step on the card, two frames: B3
                once a step, pose and landmarks within 1e-4 of the CPU's.
34. dryrun     — `entry.dryrun_multichip(4)` and `(8)`: JAX's checks and
                summary lines; B1 and B2 in the image step, B3 once a
                frame a shard.
35. scaling    — `bench/scaling.py` at its defaults (the sweep over 1, 2,
                4 and 8 mesh slots: 256 frames, 32 markers, 10
                iterations, 3 reps), `--fleet 2x2`, `--processes 2` (two
                ranks on the card over Gloo) and `--ingest 2` (64
                frames): each row, the workers' launch counts (run as
                `chip_smoke.py --scaling-child DIR`).

The line before the last is {"kernels": [...]} (each with its launches
on the main path, or on its own path for B4 and B5 (the calibration
CLI's, whose shapes B5's times are at), and its launches
per 32-frame chunk on every path (`degraded`: the clutter run's): the
fleet-ba runs hold four
sequences of one chunk each, the dist ranks one 16-frame chunk each;
`fleet-sharded` four streams of one chunk; `entry` two frames; `dryrun`
both dry runs; `ingest` one chunk of a `--ingest 2` rank);
`launches_bench` counts each bench driver's launches over its whole
run (warm call, timed reps and stage split; `scaling ...` each worker
process of bench/scaling.py); the last line is {"ok":
true, "device": {...}}. Imports nothing of JAX
and nothing of the JAX package (aruco_slam_tpu).
"""

from __future__ import annotations

import contextlib
import functools
import json
import statistics
import subprocess
import sys
import tempfile
import time
from concurrent.futures import ThreadPoolExecutor
from pathlib import Path

ROOT = Path(__file__).resolve().parent
SEED = 0
PLATFORM = "cuda"     # the paths' device (run_slam --platform); a
                      # rehearsal without a card patches the CUDA queries
                      # and sets "cpu", where the plain versions run
CHUNK = 32            # run_slam's detection chunk: the kernels' batch
ATE_BOUND = 0.3       # m, the bound of tests/test_detect.py's image loop
B1_TOL = 0            # labels are integers: bit-identical
B2_TOL = 2e-3         # px: float reassociation only (tests/test_detect.py
                      # holds the JAX package's two backends to this)
B3_TOL = 1e-4         # f32 gain chain in another summation order
                      # (relative to the largest entry, at least 1)
B4_TOL = 0            # labels are integers: bit-identical
B5_TOL = 2e-3         # px: B2's loop on gathered patches, as B2
PNP_TOL = 0           # bit-identical: the kernel rounds where the eager
                      # chain's kernels round (NaNs where they are NaN)
PNP_BYTES = 80         # a marker's bytes: 32 of corners in, 48 out
B4_SPLITS = (8, 6, 4)  # B4's most rounds a launch, checked and timed
SIZE = (1920, 1080)   # frame width, height
TRACK_EVERY = 8       # the streaming path's K
STREAMS = 8           # the fleet path's streams: 4 sequences, each twice
FLEET_TOL = 1e-4      # m, a fleet stream against its single-stream run
                      # (tests/test_io_apps.py's bound for the JAX fleet)
FLEET_COHORTS = 4     # the fleet streaming path's rescue cohorts (G > 0)
MAX_OBS = "16"        # shared --max-obs of the fleet and its references
# the online factor graph: bench/factorgraph.py's defaults (a 300-frame
# orbit, 12 markers, run_slam's 128-pose budget); the card against the
# CPU at f64 over the first GRAPH_CHECK_FRAMES (one marginalization)
ONLINE_FRAMES = 300
POSE_BUDGET = 128
ONLINE_ATE_BOUND = 0.1  # m, the bound of tests/test_graph.py:338
GRAPH_CHECK_FRAMES = 140
GRAPH_TOL = 1e-6      # m, the card's f64 trajectory against the CPU's
PROFILE_FRAMES = 16   # the online frames traced for the device-busy share
                      # (a longer trace's processing takes tens of seconds)
# the large-map batch solve (BASELINE config 3 at the scale of
# aruco_slam_tpu/bench/large_map.py): markers, raster frames, LM iterations
LARGE_MARKERS = 512
LARGE_FRAMES = 512
LARGE_ITERS = 40
# the distributed paths: a fleet sequence or a --processes run against its
# single run (tests/test_dist.py's CLI bound, f64); the sharded large map
# against the unsharded solve at f64; the in-process shard counts
FLEET_BA_TOL = 1e-5   # m
SHARD_COST_RTOL = 1e-8
SHARD_TOL = 1e-6      # m
SHARD_LOCAL = (2, 4)
DIST_RANKS = 2        # the [dist] phase's processes (Gloo on the one card)
# their front end's chunk: the main path's CHUNK frames spread so that
# each rank owns one chunk (front_end.observations_from_frames_sharded)
DIST_CHUNK = -(-CHUNK // DIST_RANKS)
PROFILE_ITERS = 5     # LM iterations traced for events and busy share
# calibration: tests/test_calibrate.py's camera, views and tolerances
CALIB_VIEWS = 12
CALIB_SIZE = (1280, 720)
CALIB_K = ((900.0, 0.0, 640.0), (0.0, 905.0, 360.0), (0.0, 0.0, 1.0))
CALIB_DIST = (0.08, -0.22, 0.001, 0.002, 0.11)
CALIB_ITERS = 60
CALIB_TOL = 1e-4       # the CLI's camera matrix, card against CPU, relative
CALIB_GRID_TOL = 1e-9  # calibrate() at f64, card against CPU, relative
CKPT_EVERY = CHUNK // 4  # the [checkpoint] runs' --checkpoint-every
# the detector's subpixel schedule, the tracker's three pulls and
# detect.refine_corners' default
DETECTOR_SCHED = ((6, 6), (3, 4))
TRACKER_SCHEDS = (((8, 6),), ((6, 4),), ((3, 4), (2, 2)))
REFINE_SCHED = ((5, 8),)
# the card's peaks for the roofline bound (NVIDIA's H100 SXM data sheet
# at 700 W; int32: 132 SMs x 64 min/compare lanes x 1.98 GHz)
F32_PEAK = 67e12      # FLOP/s, f32 outside the tensor cores
INT32_PEAK = 132 * 64 * 1.98e9
HBM_RATE = 3.35e12    # bytes/s
# the least int32 work of labeling, a pixel: a 3x3 min-stencil round is
# 2 vertical and 2 horizontal mins and 1 select (background stays); a
# segmented-scan pass 1 min and 1 select (a reset at background); a scan
# round is 4 passes (rows and columns, forward and backward)
STENCIL_OPS = 5
SCAN_PASS_OPS = 2
SPLIT_REPS = 10       # calls whose launch-group split is the median
SPIN_CYCLES = 100_000_000  # ~50 ms of the card's clock ahead of timed calls


T_START = time.perf_counter()


def log(msg: str) -> None:
    print(msg, flush=True)


def _elapsed(after: str) -> None:
    log(f"[time] {time.perf_counter() - T_START:.1f} s into the script, "
        f"after {after}")


def device_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Device milliseconds a call of fn(): the mean over ``reps`` calls
    queued behind a spin of the card (torch.cuda._sleep) long enough for
    the host to enqueue them, so host time between launches is not
    counted."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(SPIN_CYCLES)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def call_ms(fn, reps: int = 20, warmup: int = 3) -> float:
    """Median CUDA-event milliseconds of one call of fn() on an idle
    card, host time between its launches included."""
    import torch
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def timings(kernel, plain, plain_reps: int = 20) -> dict:
    """A kernel's times beside its plain version's on the same inputs:
    "ms" and "plain_ms" one call (`call_ms`), "device_ms" and
    "plain_device_ms" device time (`device_ms`)."""
    return {"ms": call_ms(kernel), "device_ms": device_ms(kernel),
            "plain_ms": call_ms(plain, reps=plain_reps),
            "plain_device_ms": device_ms(plain, reps=plain_reps)}


def _fmt_t(t: dict) -> str:
    return (f"kernel {t['ms']:.3f} ms a call ({t['device_ms']:.3f} device), "
            f"plain {t['plain_ms']:.3f} ms ({t['plain_device_ms']:.3f} "
            "device)")


def bound(ops: float, nbytes: float, peak: float):
    """The least time the card could take (ms) and what sets it: each
    input byte read once and each output byte written once at HBM_RATE,
    against the operations at ``peak``."""
    t_ops, t_bytes = ops / peak * 1e3, nbytes / HBM_RATE * 1e3
    return (t_ops, "operations") if t_ops >= t_bytes else (t_bytes, "bytes")


def busy_share(fn):
    """(device-busy share, wall seconds, device events) of one fn() under
    torch.profiler: the summed time of the traced device events
    (kernels, copies, fills) over the wall time (the profiler's own cost
    stays in the wall, so the share is a lower bound), and their number;
    the share None where the trace holds no device time."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # the device events alone: a CPU op's self device time is that of
    # the kernels it launched, which appear again as device events
    events = [e for e in prof.key_averages()
              if e.device_type == DeviceType.CUDA]
    device_us = sum(e.self_device_time_total for e in events)
    launches = sum(e.count for e in events)
    return (device_us * 1e-6 / wall if device_us else None), wall, launches


def _fmt(split: dict) -> str:
    return ", ".join(f"{k} {v:.4f}" if isinstance(v, float) else f"{k} {v}"
                     for k, v in split.items())


def split_median(fn, reps: int = SPLIT_REPS) -> dict:
    """Median over ``reps`` calls of each launch group's CUDA-event ms
    (fn returns one call's {group: ms})."""
    import torch
    fn()
    runs = []
    for _ in range(reps):
        torch.cuda.synchronize()
        torch.cuda._sleep(SPIN_CYCLES // 10)
        runs.append(fn())
    return {k: statistics.median(r[k] for r in runs) for k in runs[0]}


def phase_device():
    import torch
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}")
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device: torch.cuda.is_available() is "
                           "False")
    if not (ROOT / "aruco_slam_tpu_torch" / "csrc").is_dir():
        raise RuntimeError(f"{ROOT}: not a checkout of the repository "
                           "(aruco_slam_tpu_torch/csrc is missing)")
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True).stdout.strip().splitlines()[0]
    log(f"[device] {name}, {torch.cuda.device_count()} device(s)")
    log(smi)
    return name, smi


def phase_build():
    from aruco_slam_tpu_torch import _build
    t0 = time.perf_counter()
    path = _build.build()
    _build.lib()
    log(f"[build] {path.name} in {time.perf_counter() - t0:.2f} s "
        f"(nvcc {_build.last_build_seconds:.2f} s)")


def _b1(rng, dev):
    import torch
    from aruco_slam_tpu_torch.ops import cuda_cc
    # the grids run_slam labels per chunk at 1080p: 270x480 twice
    # (prop_iters 16) and 540x960 once (fine pass, max(16, 16 // 2)),
    # plus a 1080x1920 grid (the fine pass of 4K input); the fleet
    # streaming path labels the same grids for a sweep batch: all the
    # streams (one schedule) or one cohort's; the [dist] ranks for their
    # DIST_CHUNK-frame chunk
    cases = [((CHUNK, 270, 480), 16, 4), ((CHUNK, 540, 960), 16, 4),
             ((2, 1080, 1920), 16, 4)] + [
        ((n, h, w), 16, 4)
        for n in (STREAMS, STREAMS // FLEET_COHORTS, DIST_CHUNK)
        for h, w in ((270, 480), (540, 960))]
    worst = 0
    shapes = []
    for shape, iters, rounds in cases:
        fg = torch.from_numpy(rng.random(shape) < 0.45).to(dev)
        got = cuda_cc.flood_scan_labels(fg, iters, rounds)
        want = cuda_cc.flood_scan_labels_plain(fg, iters, rounds)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        worst = max(worst, bad)
        t = timings(lambda: cuda_cc.flood_scan_labels(fg, iters, rounds),
                    lambda: cuda_cc.flood_scan_labels_plain(
                        fg, iters, rounds), plain_reps=10)
        # per + rounds * per stencil rounds and 4 scan passes a round;
        # the mask in, labels out
        per = max(1, iters // (rounds + 1))
        px = shape[0] * shape[1] * shape[2]
        b_ms, b_by = bound(px * (STENCIL_OPS * per * (rounds + 1)
                                 + SCAN_PASS_OPS * 4 * rounds),
                           px * 5, INT32_PEAK)
        split = split_median(lambda: cuda_cc.split_ms(fg, iters, rounds)) \
            if dev.type == "cuda" else {}
        log(f"[B1] flood_scan_labels {shape} iters {iters} rounds "
            f"{rounds}: {bad} labels differ; {_fmt_t(t)}, bound "
            f"{b_ms:.4f} ms ({b_by}); split {_fmt(split)}")
        if bad > B1_TOL:
            raise AssertionError(f"B1 differs from its plain version at "
                                 f"{shape}: {bad} labels")
        shapes.append({"shape": list(shape), **t, "bound_ms": b_ms,
                       "bound_by": b_by, "split_ms": split})
    main = shapes[1]  # (CHUNK, 540, 960): the fine pass
    return {"name": "flood_scan_labels", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/flood_scan.cu",
            "replaces": "aruco_slam_tpu/ops/pallas_cc.py:87",
            "max_abs_err": float(worst),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "plain_device_ms", "bound_ms",
                                    "bound_by", "split_ms")},
            "library_ms": None, "shapes": shapes}


def _seeds(corners_true, mask_true, rng, per_frame: int, jitter: float):
    """(T, per_frame, 2) f32 seeds: each frame's true corners moved by
    up to ``jitter`` px, then random points anywhere in the frame."""
    w, h = SIZE
    t = len(mask_true)
    seeds = rng.uniform([0, 0], [w - 1, h - 1], size=(t, per_frame, 2))
    n_true = []
    for i in range(t):
        true = corners_true[i][mask_true[i]].reshape(-1, 2)[:per_frame]
        seeds[i, :len(true)] = true + rng.uniform(-jitter, jitter,
                                                  true.shape)
        n_true.append(len(true))
    return seeds.astype("float32"), n_true


def _subpix_work(n: int, sched, elem: int):
    """(FLOPs, bytes) that refining n corners needs: per corner 6 flops
    an interior patch pixel (gradients and projection) and 12 a window
    pixel an iteration (weight x gx and x gy, five multiply-adds) over
    the (2 half + 1)^2 pixels of each stage's window; the patch (elem
    bytes a pixel) read once, the 8-byte seed in and corner out."""
    from aruco_slam_tpu_torch.ops import cuda_subpix
    rad, _ = cuda_subpix.schedule_params(sched)
    p = 2 * rad + 1
    window = sum(it * (2 * half + 1) ** 2 for half, it in sched)
    return n * (6 * (p - 2) ** 2 + 12 * window), n * (p * p * elem + 16)


def _subpix_bound(n: int, sched, elem: int):
    return bound(*_subpix_work(n, sched, elem), F32_PEAK)


def _b2_case(img, c, sched, tag: str) -> dict:
    """B2 against its plain version at one shape: the error (raises over
    B2_TOL), the times, the bound, and the device time of the launch
    without iterations."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.ops import cuda_subpix
    got = cuda_subpix.refine_corners(img, c, sched)
    want = cuda_subpix.refine_corners_plain(img, c, sched)
    torch.cuda.synchronize()
    err = float((got - want).abs().max())
    t = timings(lambda: cuda_subpix.refine_corners(img, c, sched),
                lambda: cuda_subpix.refine_corners_plain(img, c, sched),
                plain_reps=10)
    fixed = iter_us = None
    if img.is_cuda:
        # the same launch with no iteration (the same patch: rad depends
        # on the halves alone): gather, gradients, tables and the launch
        bare = tuple((half, 0) for half, _ in sched)
        fixed = device_ms(lambda: cuda_subpix.refine_corners(img, c, bare))
        iter_us = (t["device_ms"] - fixed) / sum(
            it for _, it in sched) * 1e3
    rad, _ = cuda_subpix.schedule_params(sched)
    b_ms, b_by = _subpix_bound(c.shape[0] * c.shape[1], sched, 1)
    h, w = img.shape[1:]
    log(f"[B2] refine_corners {tuple(c.shape)} schedule {sched} (p = "
        f"{2 * rad + 1}, {tag}) on {h}x{w} uint8: max |kernel - plain| "
        f"{err:.3e} px (tol {B2_TOL}); {_fmt_t(t)}, bound {b_ms:.5f} ms "
        f"({b_by}); without iterations {fixed} ms device, an iteration "
        f"{iter_us} us")
    if not np.isfinite(err) or err > B2_TOL:
        raise AssertionError(f"B2 differs from its plain version at "
                             f"{sched} ({tag}): {err}")
    return {"shape": list(c.shape), "schedule": sched, "max_abs_err": err,
            **t, "bound_ms": b_ms, "bound_by": b_by,
            "no_iterations_device_ms": fixed, "iteration_us": iter_us}


def _b2(frames, corners_true, mask_true, rng, dev):
    import torch
    img = torch.from_numpy(frames).to(dev)
    # 384 seeds per frame (32 candidates x 3 passes x 4 corners): the
    # true corners perturbed like coarse-grid quad seeds, the rest
    # anywhere in the frame; the tracker pulls <= 64 corners (16 tracked
    # slots) of one frame a call with each of its three schedules, here
    # also batched over the chunk's frames
    shapes = []
    for sched, per_frame in [(DETECTOR_SCHED, 384)] + [
            (s, 64) for s in TRACKER_SCHEDS]:
        seeds, _ = _seeds(corners_true, mask_true, rng, per_frame, 3.0)
        shapes.append(_b2_case(img, torch.from_numpy(seeds).to(dev), sched,
                               "chunk"))
    seeds, _ = _seeds(corners_true[:1], mask_true[:1], rng, 64, 3.0)
    c = torch.from_numpy(seeds).to(dev)
    for sched in TRACKER_SCHEDS:
        shapes.append(_b2_case(img[:1], c, sched, "a tracker pull"))
    # the fleet streaming path: a sweep batch of all the streams or one
    # cohort's, a tracked batch of all the streams or of the other
    # cohorts' (one frame of each stream a call); a [dist] rank's chunk
    part = STREAMS // FLEET_COHORTS
    for sched, n, per_frame, tag in [
            (DETECTOR_SCHED, STREAMS, 384, "a fleet sweep"),
            (DETECTOR_SCHED, part, 384, "a cohort sweep"),
            (DETECTOR_SCHED, DIST_CHUNK, 384, "a dist rank's chunk")] + [
            (s, n, 64, tag) for n, tag in ((STREAMS, "a fleet pull"),
                                           (STREAMS - part, "a cohorts pull"))
            for s in TRACKER_SCHEDS]:
        seeds, _ = _seeds(corners_true[:n], mask_true[:n], rng, per_frame,
                          3.0)
        shapes.append(_b2_case(img[:n], torch.from_numpy(seeds).to(dev),
                               sched, tag))
    main = shapes[0]
    return {"name": "refine_corners", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/subpix.cu",
            "replaces": "aruco_slam_tpu/ops/pallas_subpix.py:92",
            "max_abs_err": max(s["max_abs_err"] for s in shapes),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "plain_device_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "shapes": shapes}


def _b4(rng, dev):
    import torch
    from aruco_slam_tpu_torch.ops import cuda_cc
    # the stencil-only schedule (scan_rounds 0) on run_slam's grids at
    # 1080p and on the fine grid of 4K input, at the fine pass's 16
    # rounds; each split of the rounds into launches (at most 8, 6 and 4
    # a launch) checked and timed beside the entry point's own
    cases = [(CHUNK, 270, 480), (CHUNK, 540, 960), (2, 1080, 1920)]
    iters = 16
    worst = 0
    shapes = []
    for shape in cases:
        fg = torch.from_numpy(rng.random(shape) < 0.45).to(dev)
        want = cuda_cc.flood_labels_plain(fg, iters)
        got = cuda_cc.flood_labels(fg, iters)
        torch.cuda.synchronize()
        bad = int((got != want).sum())
        t = timings(lambda: cuda_cc.flood_labels(fg, iters),
                    lambda: cuda_cc.flood_labels_plain(fg, iters),
                    plain_reps=10)
        splits = {}
        if dev.type == "cuda":
            for cap in B4_SPLITS:
                def run(cap=cap):
                    return cuda_cc.flood_labels_split(fg, iters, cap)
                bad = max(bad, int((run() != want).sum()))
                splits[cap] = {"ms": call_ms(run),
                               "device_ms": device_ms(run)}
        worst = max(worst, bad)
        px = shape[0] * shape[1] * shape[2]
        b_ms, b_by = bound(px * STENCIL_OPS * iters, px * 5, INT32_PEAK)
        log(f"[B4] flood_labels {shape} iters {iters}: {bad} labels "
            f"differ; {_fmt_t(t)}, bound {b_ms:.4f} ms ({b_by}); at most n "
            f"rounds a launch (ms a call / device) "
            + ", ".join(f"{k} {v['ms']:.4f} / {v['device_ms']:.4f}"
                        for k, v in splits.items()))
        if bad > B4_TOL:
            raise AssertionError(f"B4 differs from its plain version at "
                                 f"{shape}: {bad} labels")
        shapes.append({"shape": list(shape), **t, "bound_ms": b_ms,
                       "bound_by": b_by, "splits": splits})
    fastest = [min(s["splits"], key=lambda k: s["splits"][k]["device_ms"])
               for s in shapes if s["splits"]]
    log(f"[B4] fastest split (device ms) at each shape: {fastest}; the "
        f"entry point's own: "
        + ", ".join(f"{s['device_ms']:.4f}" for s in shapes) + " ms")
    main = shapes[1]  # (CHUNK, 540, 960): the fine pass
    return {"name": "flood_labels", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/flood_scan.cu",
            "replaces": "aruco_slam_tpu/ops/pallas_cc.py:39",
            "max_abs_err": float(worst),
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "plain_device_ms", "bound_ms",
                                    "bound_by")},
            "library_ms": None, "shapes": shapes}


def _b5(frames, corners_true, mask_true, rng, dev):
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.ops import cuda_subpix
    img = torch.from_numpy(frames).to(dev)
    seeds, _ = _seeds(corners_true, mask_true, rng, 384, 3.0)
    pts = torch.from_numpy(seeds).to(dev)
    worst = 0.0
    timing = None
    for sched in (REFINE_SCHED, DETECTOR_SCHED):
        rad, _ = cuda_subpix.schedule_params(sched)
        p = 2 * rad + 1
        patches, cx0, cy0 = cuda_subpix.gather_patches(img, pts, rad)
        c0 = cuda_subpix.start_offsets(pts, cx0, cy0, rad)
        patches, c0 = patches.reshape(-1, p, p), c0.reshape(-1, 2)
        got = cuda_subpix.refine_offsets(patches, c0, sched)
        want = cuda_subpix.refine_offsets_plain(patches, c0, sched)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        worst = max(worst, err)
        t = timings(lambda: cuda_subpix.refine_offsets(patches, c0, sched),
                    lambda: cuda_subpix.refine_offsets_plain(patches, c0,
                                                             sched),
                    plain_reps=10)
        b_ms, b_by = _subpix_bound(patches.shape[0], sched, 4)
        log(f"[B5] refine_offsets {tuple(patches.shape)} schedule {sched}: "
            f"max |kernel - plain| {err:.3e} px (tol {B5_TOL}); "
            f"{_fmt_t(t)}, bound {b_ms:.4f} ms ({b_by})")
        if not np.isfinite(err) or err > B5_TOL:
            raise AssertionError(f"B5 differs from its plain version at "
                                 f"{sched}: {err}")
        if timing is None:
            timing = {**t, "bound_ms": b_ms, "bound_by": b_by}
    return {"name": "refine_offsets", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/subpix.cu",
            "replaces": "aruco_slam_tpu/ops/pallas_subpix.py:38",
            "max_abs_err": worst, **timing, "library_ms": None}


def _spd_ops(n: int) -> int:
    """pnp_square.cu `solve_spd<n>`: the Cholesky factor's inner products
    (a product and a difference each), its n(n+1)/2 square roots and
    divisions, and the two triangular solves (n^2 each)."""
    return (n - 1) * n * (n + 1) // 3 + n * (n + 1) // 2 + 2 * n * n


def pnp_ops(refine_iters: int = 8) -> int:
    """The PnP kernel's arithmetic operations a marker, stage by stage as
    csrc/pnp_square.cu writes them: +, -, x, /, negation, sqrt, sin, cos,
    atan2 and |x| one each (it is built without FMAs); comparisons,
    clamps and selects none. Where a branch changes the count, the
    larger side: 15,280 at 8 steps. (The device code run on the host
    with a counting float type, on a marker that takes the smaller side
    in ippe and to_rotvec, counted 15,278.)"""
    # a corner: normalize (4), then 8 fixed-point steps of r^2 (3), the
    # radial factor (6), both tangential terms (8 each), two updates (4)
    undistort = 4 * (4 + 8 * (3 + 6 + 8 + 8 + 4))
    canonical = 4                      # -s in ox and oy
    # sx, sy (3 each), four differences, den (3), g and hh (3 and a
    # safe_div of 2 each), a b d e (3 each), 0.5 / s, H's rows (7 each)
    h_square = 3 + 3 + 4 + 3 + 2 * 5 + 4 * 3 + 1 + 3 * 7
    # H / H22 (2 + 9), the normal's norm (5), d0 d1 c (3), m (2), the
    # rotation to the normal (19), H' (9 x 5), A (2 + 4), A^T A (9), trace
    # and det (4), disc and gamma (4 each), gamma's products (5), c1 and
    # c2 (3 each, and c2's sign 1); each candidate's third column (9)
    # and rotation back (9 x 5), the second's negations (2)
    ippe = (11 + 5 + 3 + 2 + 19 + 45 + 6 + 9 + 4 + 8 + 5 + 7
            + 2 * (9 + 45) + 2)
    # the normal matrix's sums (8); a corner: |uv|^2 (4), R o (9), the
    # right side (8); the 3x3 solve
    translation = 8 + 4 * (4 + 9 + 10) + _spd_ops(3)
    # a corner: projection and residual (17), the Jacobian's rows (10 +
    # 9), J^T r (6 x 4), the lower triangle of J^T J (21 x 4)
    gn_corner = 17 + 10 + 9 + 6 * 4 + 21 * 4
    # then -J^T r (6), the solve, the angle and half (7), sin / th, cos
    # and the quaternion (6), its matrix (39), the left product (45) and
    # the translation (3)
    gn_step = 4 * gn_corner + 6 + _spd_ops(6) + 7 + 6 + 39 + 45 + 3
    # a corner: R o (9), depth (1), x and y (4), the squared error (8),
    # the depth penalty (2); then the RMS (2) and the penalty's sum (2)
    rms = 4 * (9 + 1 + 4 + 8 + 2) + 4
    from_matrix = 2 + 8 + 5 + 9 + 8 + 4  # the trace's pivot: 2 fewer
    to_rotvec = 1 + 3 + 5 + 1 + 2 + 2 + 3  # past the small angle: 1 fewer
    out = 4                            # the mean focal, two errors
    return (undistort + canonical + h_square + ippe
            + 2 * translation + 2 * refine_iters * gn_step + 2 * rms
            + from_matrix + to_rotvec + out)


def _pnp_inputs(corners_true, mask_true, rng, frames: int):
    """(frames, 64, 4, 2) f32 slot corners: the rendered clip's visible
    corners with 0.5 px noise (the corners traffic's), its frames cycled
    with fresh noise, empty slots zeroed as the front end pads them."""
    import numpy as np
    reps = -(-frames // len(corners_true))
    c = np.concatenate([corners_true] * reps)[:frames]
    m = np.concatenate([mask_true] * reps)[:frames]
    c = c + rng.normal(scale=0.5, size=c.shape)
    return np.where(m[..., None, None], c, 0.0).astype(np.float32), m


def _pnp(corners_true, mask_true, cam, marker_size, rng, dev):
    """The PnP kernel against its plain version on the card at the main
    path's shapes: a corners request (128 frames x 64 slots) and a
    32-frame chunk."""
    import torch
    from aruco_slam_tpu_torch.ops import pnp
    cam_d = cam.to(device=dev)
    worst = 0.0
    shapes = []
    for frames in (128, CHUNK):
        c, m = _pnp_inputs(corners_true, mask_true, rng, frames)
        c = torch.from_numpy(c).to(dev)
        got = pnp.solve_square_pnp(cam_d, c, marker_size)
        want = pnp.solve_square_pnp_plain(cam_d, c, marker_size)
        nan_alike = all(torch.equal(g.isnan(), w.isnan())
                        for g, w in zip(got, want))
        err = max(float((g.nan_to_num() - w.nan_to_num()).abs().max())
                  for g, w in zip(got, want))
        worst = max(worst, err)
        t = timings(lambda: pnp.solve_square_pnp(cam_d, c, marker_size),
                    lambda: pnp.solve_square_pnp_plain(cam_d, c,
                                                       marker_size),
                    plain_reps=5)
        n = c[..., 0, 0].numel()
        b_ms, b_by = bound(n * pnp_ops(), n * PNP_BYTES, F32_PEAK)
        log(f"[PnP] solve {tuple(c.shape)} ({int(m.sum())} markers in "
            f"view): max |kernel - plain| {err:.3e} over every output "
            f"(tol {PNP_TOL}), NaNs alike {nan_alike}; {_fmt_t(t)}, bound "
            f"{b_ms:.5f} ms ({b_by})")
        if not nan_alike or err > PNP_TOL:
            raise AssertionError(f"PnP differs from its plain version at "
                                 f"{tuple(c.shape)}: {err}, NaNs alike "
                                 f"{nan_alike}")
        shapes.append({"shape": list(c.shape), **t, "bound_ms": b_ms,
                       "bound_by": b_by})
    return {"name": "solve", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/pnp_square.cu",
            "replaces": None, "max_abs_err": worst,
            **{k: shapes[0][k] for k in ("ms", "device_ms", "plain_ms",
                                         "plain_device_ms", "bound_ms",
                                         "bound_by")},
            "library_ms": None, "shapes": shapes}


def _capture_update_inputs(corners, mask, cam, marker_size,
                           rotations: bool = False, max_obs: int = 0):
    """The fused update's inputs at every frame of a short filter run
    on the CPU (the run_slam MEKF settings: N = 201, M = 48 in point
    mode, N = 393, M = 112 with rotations and the PnP ambiguity, M = 224
    with rotations at --max-obs 32)."""
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.filters import cuda_mekf
    from aruco_slam_tpu_torch.ops import pnp
    cpu = torch.device("cpu")
    res = pnp.solve_square_pnp(cam.to(device=cpu), torch.tensor(
        corners, dtype=torch.float32), marker_size)
    amb = (res.err / torch.clamp(res.err2, min=1e-9)).numpy()
    captured = []
    real = cuda_mekf.fused_update

    def record(*args, **kw):
        captured.append([a.clone() for a in args])
        return real(*args, **kw)

    cuda_mekf.fused_update = record
    try:
        run_slam.run_mekf(SlamAppConfig(input="", max_obs=max_obs),
                          list(range(len(mask))),
                          res.t_cl.numpy(), res.q_cl.numpy(), mask, cam,
                          cpu, with_rotations=rotations, ambiguity=amb)
    finally:
        cuda_mekf.fused_update = real
    return captured


def _b3_err(got, want) -> float:
    """Largest difference relative to the largest entry (at least 1),
    over the innovation and the covariance."""
    return max(float((g - w).abs().max() / max(1.0, float(w.abs().max())))
               for g, w in zip(got, want))


def _b3_bound(streams: int, n: int, m: int, iters: int = 20):
    """Bound of the fused update: the chain's f32 FLOPs (PHᵀ, S, the
    Newton–Schulz steps, K, K·resid, KH, the two Joseph products, KRKᵀ);
    P, H, r and resid read once, the innovation and P' written once."""
    flops = (3 * 2 * n * n * m + 2 * m * m * n + iters * 4 * m ** 3
             + 2 * n * m * m + 2 * n * m + 4 * n ** 3)
    return bound(streams * flops, streams * 4 * (2 * n * n + m * n + 2 * m
                                                 + n), F32_PEAK)


def _b3_split(args, dev) -> dict:
    """The launch-group split, with the Newton–Schulz form the C entry
    point takes for this M."""
    from aruco_slam_tpu_torch.filters import cuda_mekf
    if dev.type != "cuda":
        return {}
    split = split_median(lambda: cuda_mekf.split_ms(*args))
    return {**split, "path": cuda_mekf.newton_schulz_form(args[1].shape[-2])}


def _b3_forms(args, want, dev) -> dict:
    """Every Newton–Schulz form that takes this M, forced: each held
    against the plain version (B3_TOL, P' exactly symmetric) and timed
    (ms a call, device ms), so both sides of each choice the C entry
    point makes by M are measured on the same inputs."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.filters import cuda_mekf
    if dev.type != "cuda":
        return {}
    forms = cuda_mekf.FORMS
    out = {}
    for form in forms[forms.index(cuda_mekf.newton_schulz_form(
            args[1].shape[-2])):]:
        def run(form=form):
            return cuda_mekf.fused_update_form(*args, form)
        got = run()
        err = _b3_err(got, want)
        sym = bool(torch.equal(got[1], got[1].transpose(-1, -2)))
        if not np.isfinite(err) or err > B3_TOL or not sym:
            raise AssertionError(f"B3 in the {form} form differs from its "
                                 f"plain version: {err}, symmetric {sym}")
        out[form] = {"ms": call_ms(run), "device_ms": device_ms(run),
                     "max_abs_err": err}
    return out


def _b3(captured, captured_rot, captured_rot32, dev):
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.filters import cuda_mekf
    mid = len(captured) // 2
    cov, h, r, resid = (a.to(dev) for a in captured[mid])
    n = 54  # the camera block + 16 landmarks (motion_model "none")
    cases = [("point", (cov, h, r, resid)),
             ("point, cut", (cov[:n, :n].contiguous(),
                             h[:, :n].contiguous(), r, resid)),
             ("rotations", tuple(a.to(dev) for a in captured_rot[mid])),
             ("rotations, --max-obs 32",
              tuple(a.to(dev) for a in captured_rot32[mid]))]
    worst = 0.0
    shapes = []
    for tag, args in cases:
        got = cuda_mekf.fused_update(*args)
        want = cuda_mekf.fused_update_plain(*args)
        torch.cuda.synchronize()
        err = _b3_err(got, want)
        worst = max(worst, err)
        t = timings(lambda: cuda_mekf.fused_update(*args),
                    lambda: cuda_mekf.fused_update_plain(*args))
        n_, m_ = args[0].shape[0], args[1].shape[0]
        shape = f"N={n_} M={m_}"
        b_ms, b_by = _b3_bound(1, n_, m_)
        split = _b3_split(args, dev)
        forms = _b3_forms(args, want, dev)
        # one Newton–Schulz step: the device time at 20 steps less that
        # at 0
        step_us = (t["device_ms"] - device_ms(lambda: cuda_mekf.fused_update(
            *args, ns_iters=0))) / 20 * 1e3
        sym = bool(torch.equal(got[1], got[1].T))
        log(f"[B3] fused_update {shape} ({tag}): max |kernel - plain| "
            f"{err:.3e} (tol {B3_TOL}); symmetric {sym}; {_fmt_t(t)}; a "
            f"Newton–Schulz step {step_us:.2f} us device; bound {b_ms:.4f} "
            f"ms ({b_by}); split {_fmt(split)}; forms (ms a call / device) "
            + ", ".join(f"{f} {v['ms']:.3f} / {v['device_ms']:.3f}"
                        for f, v in forms.items()))
        if not np.isfinite(err) or err > B3_TOL or not sym:
            raise AssertionError(f"B3 differs from its plain version at "
                                 f"{shape}: {err}, symmetric {sym}")
        shapes.append({"shape": shape, **t, "ns_step_us": step_us,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "split_ms": split, "forms": forms,
                       "max_abs_err": err})
    # the last STREAMS frames of the point-mode run as STREAMS streams in
    # one launch (the batched entry point), against the batched plain
    # chain and against one single-stream launch each
    frames = captured[-STREAMS:]
    batch = [torch.stack([f[j] for f in frames]).to(dev) for j in range(4)]
    got = cuda_mekf.fused_update(*batch)
    want = cuda_mekf.fused_update_plain(*batch)
    singles = [cuda_mekf.fused_update(*(a[i] for a in batch))
               for i in range(STREAMS)]
    torch.cuda.synchronize()
    err = _b3_err(got, want)
    vs_single = max(float((got[j][i] - singles[i][j]).abs().max())
                    for i in range(STREAMS) for j in range(2))
    t = timings(lambda: cuda_mekf.fused_update(*batch),
                lambda: cuda_mekf.fused_update_plain(*batch))

    def launch_singles():
        return [cuda_mekf.fused_update(*(a[i] for a in batch))
                for i in range(STREAMS)]
    singles_ms = call_ms(launch_singles)
    singles_dev = device_ms(launch_singles)
    shape = f"S={STREAMS} N={batch[0].shape[1]} M={batch[1].shape[1]}"
    b_ms, b_by = _b3_bound(STREAMS, batch[0].shape[1], batch[1].shape[1])
    split = _b3_split(batch, dev)
    log(f"[B3] fused_update batched {shape}: max |kernel - plain| "
        f"{err:.3e} (tol {B3_TOL}); max |batched - single launches| "
        f"{vs_single:.3e} (bit-equal expected); {_fmt_t(t)}, {STREAMS} "
        f"single launches {singles_ms:.3f} ms a call ({singles_dev:.3f} "
        f"device), bound {b_ms:.4f} ms ({b_by}); split {_fmt(split)}")
    # (a CPU tensor runs the plain chain, whose batched matmuls sum in
    # another order than single ones: only the kernel is bit-equal)
    exact = dev.type == "cuda"
    if not np.isfinite(err) or err > B3_TOL or (exact and vs_single != 0.0):
        raise AssertionError(f"batched B3 at {shape}: {err} against plain, "
                             f"{vs_single} against single launches")
    worst = max(worst, err)
    shapes.append({"shape": shape, "entry": "mekf_fused_update_batched",
                   **t, "single_launches_ms": singles_ms,
                   "single_launches_device_ms": singles_dev,
                   "max_abs_err": err, "max_abs_err_vs_single": vs_single,
                   "bound_ms": b_ms, "bound_by": b_by, "split_ms": split})
    main = shapes[0]
    return {"name": "fused_update", "route": "cuda",
            "source": "aruco_slam_tpu_torch/csrc/mekf_update.cu",
            "replaces": "aruco_slam_tpu/filters/pallas_mekf.py:40",
            "max_abs_err": worst,
            **{k: main[k] for k in ("ms", "device_ms", "plain_ms",
                                    "plain_device_ms", "bound_ms",
                                    "bound_by", "split_ms")},
            "library_ms": None, "shapes": shapes}


def _wrappers():
    """Every kernel wrapper, each with its launch count."""
    from aruco_slam_tpu_torch.filters import cuda_mekf
    from aruco_slam_tpu_torch.ops import cuda_cc, cuda_pnp, cuda_subpix
    return (cuda_cc.flood_scan_labels, cuda_subpix.refine_corners,
            cuda_mekf.fused_update, cuda_cc.flood_labels,
            cuda_subpix.refine_offsets, cuda_pnp.solve)


def _reset_counts() -> None:
    for fn in _wrappers():
        fn.launches = 0


def _counts() -> dict:
    import torch
    if torch.cuda.is_available():
        torch.cuda.synchronize()
    return {fn.__name__: fn.launches for fn in _wrappers()}


def _require(counts: dict, path: str, names) -> None:
    for name in names:
        if counts[name] <= 0:
            raise AssertionError(f"the {path} never launched {name}")


def _b123(launches: dict) -> list:
    return [launches[k] for k in ("flood_scan_labels", "refine_corners",
                                  "fused_update")]


@contextlib.contextmanager
def _recording_schedule(record):
    """Within the block, `detect.streaming_step` records, for every frame
    it steps, (frame index, the B1 and B2 launches that the step's own
    sweep decisions (`detect.sweep_due`) call for, the B1 and B2 launches
    made, the streams due a sweep)."""
    from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix, detect
    real_step, real_due = detect.streaming_step, detect.sweep_due
    decided = []

    def recording_due(*args, **kw):
        decided.append(real_due(*args, **kw))
        return decided[-1]

    def recording_step(cfg, ke, **kw):
        step = real_step(cfg, ke, **kw)
        streams = kw.get("streams") or 1

        def recorded(cr, im):
            before = (cuda_cc.flood_scan_labels.launches,
                      cuda_subpix.refine_corners.launches)
            decided.clear()
            out = step(cr, im)
            due, = decided
            sweep, track = any(due), not all(due)
            record.append((cr[-1], (3 * sweep, int(sweep) + 3 * track),
                           (cuda_cc.flood_scan_labels.launches - before[0],
                            cuda_subpix.refine_corners.launches - before[1]),
                           streams // len(due) * sum(due)))
            return out
        return recorded

    detect.streaming_step, detect.sweep_due = recording_step, recording_due
    try:
        yield
    finally:
        detect.streaming_step, detect.sweep_due = real_step, real_due


def _run_slam(argv, gt_t, tag: str):
    """One run_slam.main call with its checks: output files, a finite
    trajectory of every frame, ATE under the bound, more than half the
    frames with a detection."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import ate
    from aruco_slam_tpu_torch.io import read_trajectory
    res = run_slam.main(argv)
    torch.cuda.synchronize()
    traj_file, map_file = Path(res.trajectory_file), Path(res.map_file)
    if not traj_file.is_file() or not map_file.is_file():
        raise AssertionError(f"{tag}: run_slam wrote no trajectory/map file")
    _, poses = read_trajectory(traj_file)
    if poses.shape != (len(gt_t), 7) or not np.isfinite(poses).all():
        raise AssertionError(f"{tag}: trajectory {poses.shape}, finite "
                             f"{np.isfinite(poses).all()}")
    err = ate.ate_rmse(poses[:, :3], gt_t)
    det = res.obs_mask.sum(axis=1)
    log(f"[{tag}] ATE {err:.4f} m (bound {ATE_BOUND}); detections per "
        f"frame {det.tolist()}; {len(res.landmark_ids)} landmarks; "
        f"stage seconds {res.seconds}")
    if not err < ATE_BOUND:
        raise AssertionError(f"{tag}: ATE {err} m >= {ATE_BOUND} m")
    if (det >= 1).sum() * 2 <= len(det):
        raise AssertionError(f"{tag}: fewer than half the frames had a "
                             "detection")
    return res


def _warm(argv, frames: int, tag: str, smi: str,
          stage: str = "filter") -> float:
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_slam.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fps = frames / dt
    log(f"[{tag}] warm run: {frames} frames {SIZE[0]}x{SIZE[1]} in "
        f"{dt:.3f} s = {fps:.2f} frames/s end to end (front end "
        f"{warm.seconds['front_end']:.3f} s, {stage} "
        f"{warm.seconds['filter']:.3f} s) on {smi}")
    return fps


def phase_main(argv, gt_t, smi: str):
    _reset_counts()
    res = _run_slam(argv, gt_t, "main")
    launches = _counts()
    log(f"[main] launches in the run: {launches}")
    _require(launches, "main path", ("flood_scan_labels", "refine_corners",
                                     "fused_update"))
    return launches, res, _warm(argv, len(gt_t), "main", smi)


def phase_refine_corners(frames, corners_true, mask_true, rng, dev):
    """detect.refine_corners over the 32 frames: the patch path (B5),
    not the fused gather (B2), and corners back on the rendered truth."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.ops import cuda_subpix, detect
    img = torch.from_numpy(frames).to(dev)
    seeds, n_true = _seeds(corners_true, mask_true, rng, 384, 3.0)
    pts = torch.from_numpy(seeds).to(dev)
    _reset_counts()
    got = detect.refine_corners(img, pts)
    launches = _counts()
    log(f"[refine_corners] launches in the run: {launches}")
    _require(launches, "refine_corners path", ("refine_offsets",))
    if launches["refine_corners"]:
        raise AssertionError("detect.refine_corners took the fused gather "
                             "kernel (B2), not the patch path (B5)")
    want = cuda_subpix.refine_corners_plain(img, pts, REFINE_SCHED)
    err = float((got - want).abs().max())
    got = got.cpu().numpy()
    truth = np.concatenate([got[i, :n] - corners_true[i][mask_true[i]]
                            .reshape(-1, 2)[:n]
                            for i, n in enumerate(n_true)])
    med = float(np.median(np.abs(truth)))
    log(f"[refine_corners] {tuple(pts.shape)} schedule {REFINE_SCHED}: max "
        f"|kernel path - plain| {err:.3e} px (tol {B5_TOL}); median "
        f"|refined - rendered truth| {med:.4f} px over {len(truth)} "
        "corners seeded +-3 px off")
    if not np.isfinite(err) or err > B5_TOL:
        raise AssertionError(f"refine_corners differs from plain: {err}")
    if not med < 0.5:
        raise AssertionError(f"refine_corners median error {med} px")
    return launches


def phase_stencil_only(frames, dev):
    """The detector with fine_scan_rounds=0: B4 labels the fine pass,
    B1 the two coarse passes, one launch each per chunk."""
    import torch
    from aruco_slam_tpu_torch.ops import detect
    ims = torch.from_numpy(frames).to(dev)

    def sweep(cfg):
        c = cfg.capacity
        out = detect.detect_markers_batch_lru(
            ims, cfg, detect.slot_table_init(c, dev),
            torch.zeros(c, dtype=torch.int32, device=dev), 0)
        return out[1].sum(1).tolist()

    default = sweep(detect.DetectorConfig())
    _reset_counts()
    stencil = sweep(detect.DetectorConfig(fine_scan_rounds=0))
    launches = _counts()
    log(f"[stencil-only] launches in the run: {launches}")
    log(f"[stencil-only] detections per frame {stencil}; default sweep "
        f"{default}")
    if launches["flood_labels"] != 1 or launches["flood_scan_labels"] != 2:
        raise AssertionError("the stencil-only sweep should launch B4 once "
                             f"and B1 twice per chunk: {launches}")
    if sum(n >= 1 for n in stencil) * 2 <= len(stencil):
        raise AssertionError("stencil-only: fewer than half the frames had "
                             "a detection")
    return launches


def phase_streaming(argv, gt_t, main_res, main_fps: float, smi: str):
    """run_slam --track-every K: which frames took a full sweep (B1
    and B2 launched on every frame as its schedule says), ATE, and the
    tracked frames' detections against the main run's on the same
    frames."""
    argv = [*argv, "--track-every", str(TRACK_EVERY)]
    frames = []
    _reset_counts()
    with _recording_schedule(frames):
        res = _run_slam(argv, gt_t, "streaming")
    launches = _counts()
    full = [f[0] for f in frames if f[2][0]]
    log(f"[streaming] launches in the run: {launches}; full sweeps (B1) "
        f"on frames {full} of {len(frames)}")
    _require(launches, "streaming path", ("flood_scan_labels",
                                          "refine_corners", "fused_update"))
    wrong = [f[0] for f in frames if f[1] != f[2]]
    if len(frames) != len(gt_t) or wrong:
        raise AssertionError(f"streaming: B1 or B2 launched off the schedule "
                             f"on frames {wrong} ({len(frames)} frames run)")
    tracked = [f[0] for f in frames if not f[2][0]]
    got = int(res.obs_mask[tracked].sum())
    ref = int(main_res.obs_mask[tracked].sum())
    log(f"[streaming] tracked frames {tracked}: {got} detections, the main "
        f"run {ref} on the same frames (bar {ref - len(tracked)})")
    if not tracked or got < ref - len(tracked):
        raise AssertionError("streaming: tracked frames lost the full "
                             "sweep's detections")
    fps = _warm(argv, len(gt_t), "streaming", smi)
    log(f"[streaming] warm {fps:.2f} frames/s with --track-every "
        f"{TRACK_EVERY} vs {main_fps:.2f} frames/s for the main path, same "
        "call")
    return launches


def phase_rotations(argv, gt_t, main_fps: float, smi: str):
    """run_slam --filter mekf_rotations: ATE, one update launch per
    frame, finite unit landmark quaternions; warm frames/s."""
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    argv = [*argv, "--filter", "mekf_rotations"]
    final = []
    real = run_slam.mekf_scan

    def recording(cfg, state, obs):
        out = real(cfg, state, obs)
        final.append(out[0])
        return out

    _reset_counts()
    run_slam.mekf_scan = recording
    try:
        _run_slam(argv, gt_t, "rotations")
    finally:
        run_slam.mekf_scan = real
    launches = _counts()
    log(f"[rotations] launches in the run: {launches}")
    _require(launches, "rotations path", ("flood_scan_labels",
                                          "refine_corners", "fused_update"))
    if launches["fused_update"] != len(gt_t):
        raise AssertionError(f"rotations: {launches['fused_update']} update "
                             f"launches for {len(gt_t)} frames")
    quats = final[-1].lm[:, 3:7]
    norm_err = float((torch.linalg.vector_norm(quats, dim=-1) - 1).abs().max())
    log(f"[rotations] {int(final[-1].active.sum())} landmarks; max "
        f"| |q| - 1 | over the landmark quaternions {norm_err:.3e}")
    if not torch.isfinite(quats).all() or norm_err > 1e-5:
        raise AssertionError("rotations: landmark quaternions not finite "
                             "and unit")
    fps = _warm(argv, len(gt_t), "rotations", smi)
    log(f"[rotations] warm {fps:.2f} frames/s vs {main_fps:.2f} frames/s "
        "for the main path, same call")
    return launches


def phase_recycling(tmp: Path, dev):
    """The two-cohort sequence of tests/test_recycling.py (12 frames at
    720x405, ids 0-4 then 20-24) through run_slam at --capacity 5
    --slot-max-age 2: second-cohort ids in the map, and the id->slot
    table's per-frame resets, drops and ids on the card equal to the
    CPU's (the plain path the tests hold to the JAX package)."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.io import load_map, save_npz
    from aruco_slam_tpu_torch.ops import detect
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    cam = cam_mod.CameraModel.from_matrix(k, np.zeros(5))
    parts = []
    for seed, offset in ((0, 0), (1, 20)):
        scene = synthetic.make_wall_scene(num_markers=5, seed=seed)
        traj = synthetic.make_orbit_trajectory(num_frames=6, seed=seed + 1)
        parts.append((render.render_sequence(
            scene, traj, cam, image_size=(720, 405),
            marker_ids=np.arange(5) + offset), traj))
    (ims_a, tr_a), (ims_b, tr_b) = parts
    images = np.concatenate([ims_a, ims_b])
    npz = tmp / "cohorts.npz"
    save_npz(npz, images=images,
             times=np.concatenate([tr_a.times,
                                   tr_a.times[-1] + 0.04 + tr_b.times]),
             gt_cam_t=np.concatenate([tr_a.cam_t, tr_b.cam_t]),
             camera_matrix=k, dist_coeffs=np.zeros(5),
             marker_size=np.float64(0.16))
    _reset_counts()
    res = run_slam.main(["--input", str(npz), "--platform", PLATFORM,
                         "--capacity", "5", "--slot-max-age", "2",
                         "--trajectory", str(tmp / "cohorts_traj.txt"),
                         "--map", str(tmp / "cohorts_map.txt")])
    launches = _counts()
    ids = load_map(res.map_file)[0]
    log(f"[recycling] launches in the run: {launches}; map ids "
        f"{sorted(ids.tolist())}")
    _require(launches, "recycling path", ("flood_scan_labels",
                                          "refine_corners", "fused_update"))
    if not set(ids.tolist()) & set(range(20, 25)):
        raise AssertionError("recycling: no second-cohort id in the map")
    if not np.isfinite(res.cam_traj).all():
        raise AssertionError("recycling: non-finite trajectory")
    cfg = detect.DetectorConfig(capacity=5, slot_max_age=2)
    out = {}
    for d in (dev, torch.device("cpu")):
        o = detect.detect_markers_batch_lru(
            torch.from_numpy(images).to(d), cfg, detect.slot_table_init(5, d),
            torch.zeros(5, dtype=torch.int32, device=d), 0)
        out[d.type] = [x.cpu().numpy() for x in o[1:]]
    names = ("mask", "reset", "ids_seq", "table", "last_seen", "dropped")
    differ = [n for n, a, b in zip(names, out[dev.type], out["cpu"])
              if not np.array_equal(a, b)]
    log(f"[recycling] resets per frame {out['cpu'][1].sum(1).tolist()}, "
        f"sightings without a slot per frame {out['cpu'][5].tolist()}, "
        f"final table {out['cpu'][3].tolist()}; card vs CPU differ in "
        f"{differ or 'nothing'}")
    if differ:
        raise AssertionError(f"recycling: the card's table differs from the "
                             f"CPU's in {differ}")
    return launches


def _fleet_inputs(tmp: Path, seqs) -> list[Path]:
    """The distinct sequences as npz inputs s0.npz, s1.npz, ..."""
    import numpy as np
    from aruco_slam_tpu_torch.io import save_npz
    paths = []
    for i, (frames, times, gt_t, k, dist) in enumerate(seqs):
        paths.append(tmp / f"s{i}.npz")
        save_npz(paths[-1], times=times, images=frames, gt_cam_t=gt_t,
                 camera_matrix=k, dist_coeffs=dist,
                 marker_size=np.float64(0.16))
    return paths


def _fleet_argv(tmp: Path, paths, tag: str, *flags) -> list[str]:
    inputs = paths * (STREAMS // len(paths))
    return ["--input", ",".join(map(str, inputs)), "--platform", PLATFORM,
            "--max-obs", MAX_OBS, "--trajectory", str(tmp / f"{tag}.txt"),
            "--map", str(tmp / f"{tag}_map.txt"), *flags]


def _fleet_warm(argv, tlen: int, tag: str, smi: str,
                streams: int = STREAMS) -> dict:
    """A warm fleet run of ``streams`` streams: aggregate frames/s
    (streams x frames over the wall time), its stage seconds (load,
    front end less load, filter) and peak device memory."""
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    warm = run_slam.main(argv)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    sec = warm[0].seconds
    out = {"fps": streams * tlen / dt, "wall_s": dt, "load_s": sec["load"],
           "front_end_less_load_s": sec["front_end"] - sec["load"],
           "filter_s": sec["filter"], "peak_bytes": sec.get("peak_bytes")}
    peak = out["peak_bytes"]
    log(f"[{tag}] warm run: {streams} x {tlen} frames {SIZE[0]}x{SIZE[1]} "
        f"in {dt:.3f} s = {out['fps']:.2f} frames/s aggregate "
        f"({out['fps'] / streams:.2f} per stream; load {out['load_s']:.3f} "
        f"s, front end less load {out['front_end_less_load_s']:.3f} s, "
        f"filter {out['filter_s']:.3f} s; peak device memory "
        f"{'not measured' if peak is None else f'{peak / 2**30:.2f} GiB'}) "
        f"on {smi}")
    return out


def phase_fleet(tmp: Path, paths, tlen: int, main_fps: float, smi: str):
    """run_slam --input s0.npz,...: STREAMS streams, each of the distinct
    sequences twice. Cold: each stream within FLEET_TOL of its own
    single-stream run with the same map ids, duplicates identical, B1,
    B2 and B3 launched, B3 once per frame. Warm: aggregate frames/s
    (streams x frames over wall time) and peak device memory."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.io import load_map
    argv = _fleet_argv(tmp, paths, "fleet")
    _reset_counts()
    fleet = run_slam.main(argv)
    launches = _counts()
    log(f"[fleet] launches in the run: {launches}")
    _require(launches, "fleet path", ("flood_scan_labels", "refine_corners",
                                      "fused_update"))
    if launches["fused_update"] != tlen:
        raise AssertionError(f"fleet: {launches['fused_update']} update "
                             f"launches for {tlen} frames of {STREAMS} "
                             "streams (one per frame expected)")
    worst = 0.0
    for i, path in enumerate(paths):
        one = run_slam.main(["--input", str(path), "--platform", PLATFORM,
                             "--max-obs", MAX_OBS,
                             "--trajectory", str(tmp / f"one{i}.txt"),
                             "--map", str(tmp / f"one{i}_map.txt")])
        for j in range(i, STREAMS, len(paths)):
            err = float(np.abs(fleet[j].cam_traj - one.cam_traj).max())
            worst = max(worst, err)
            same_ids = np.array_equal(load_map(fleet[j].map_file)[0],
                                      load_map(one.map_file)[0])
            if not err <= FLEET_TOL or not same_ids:
                raise AssertionError(f"fleet stream {j}: {err} m from its "
                                     f"single-stream run, map ids equal "
                                     f"{same_ids}")
        twin = fleet[i + len(paths)]
        if not (np.array_equal(fleet[i].cam_traj, twin.cam_traj)
                and Path(fleet[i].map_file).read_text()
                == Path(twin.map_file).read_text()):
            raise AssertionError(f"fleet: streams {i} and {i + len(paths)} "
                                 "(the same input) differ")
    ates = [None if r.ate is None else round(r.ate, 4) for r in fleet]
    log(f"[fleet] {STREAMS} streams x {tlen} frames: max |fleet - single| "
        f"{worst:.3e} m (tol {FLEET_TOL}); duplicate streams identical; "
        f"ATE per stream {ates}; detections per stream "
        f"{[int(r.obs_mask.sum()) for r in fleet]}")
    warm = _fleet_warm(argv, tlen, "fleet", smi)
    log(f"[fleet] warm {warm['fps']:.2f} frames/s aggregate vs "
        f"{main_fps:.2f} frames/s for the single-stream main path, same call")
    return launches, warm, fleet


def phase_fleet_sharded(tmp: Path, paths, tlen: int, fleet, full_warm: dict,
                        smi: str):
    """run_slam on the distinct fleet inputs (one stream each) with the
    stream mesh forced to the card twice: `multi_slam.stream_mesh`, which
    run_slam calls, doubled, as two cards would give. JAX's sharding
    line; each stream within FLEET_TOL of the unsharded [fleet] run's
    stream of the same input; B1 3 and B2 1 (the front end's one
    detection batch, unsharded as in JAX) and B3 twice a frame (once a
    shard). Warm: aggregate frames/s beside [fleet]'s."""
    import io
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.parallel import multi_slam
    n = len(paths)
    argv = ["--input", ",".join(map(str, paths)), "--platform", PLATFORM,
            "--max-obs", MAX_OBS, "--trajectory",
            str(tmp / "fleet_sharded.txt"), "--map",
            str(tmp / "fleet_sharded_map.txt")]
    real = multi_slam.stream_mesh
    multi_slam.stream_mesh = lambda device: real(device) * 2
    try:
        _reset_counts()
        out = io.StringIO()
        with contextlib.redirect_stdout(out):
            sharded = run_slam.main(argv)
        launches = _counts()
        printed = out.getvalue()
        log(printed.rstrip())
        line = f"sharding {n} streams over 2 devices"
        if line not in printed:
            raise AssertionError(f"fleet-sharded: no '{line}' line")
        worst = max(float(np.abs(sharded[i].cam_traj
                                 - fleet[i].cam_traj).max())
                    for i in range(n))
        log(f"[fleet-sharded] {n} streams x {tlen} frames over a stream mesh "
            f"of 2 shards on the one card: launches in the run {launches} "
            f"(expected B1 3, B2 1, B3 {2 * tlen}); max |sharded - "
            f"unsharded fleet| {worst:.3e} m (tol {FLEET_TOL})")
        if _b123(launches) != [3, 1, 2 * tlen] or not worst <= FLEET_TOL:
            raise AssertionError(f"fleet-sharded: B1/B2/B3 "
                                 f"{_b123(launches)}, {worst} m from the "
                                 "unsharded fleet")
        warm = _fleet_warm(argv, tlen, "fleet-sharded", smi, streams=n)
    finally:
        multi_slam.stream_mesh = real
    log(f"[fleet-sharded] warm {warm['fps']:.2f} frames/s aggregate ({n} "
        f"streams, 2 shards on one card) beside [fleet]'s "
        f"{full_warm['fps']:.2f} ({STREAMS} streams, one batch), same call: "
        "two shards on one card are mechanics, not speed")
    return launches


def _entry_frames():
    """Frames 0 and 1 of `entry()`'s orbit: corners (2, 64, 4, 2) f32 and
    masks (2, 64), made as entry() makes frame 0."""
    import numpy as np
    from aruco_slam_tpu_torch import entry
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    corners, mask = synthetic.observe_corners(
        synthetic.make_wall_scene(num_markers=8, seed=0),
        synthetic.make_orbit_trajectory(num_frames=2),
        cam_mod.CameraModel.from_matrix(np.asarray(entry.K, np.float32),
                                        np.asarray(entry.DIST, np.float32)),
        entry.CAPACITY, seed=1)
    return corners.astype(np.float32), mask


def phase_entry(dev):
    """`entry()`'s frame step on the card, two steps (frame 0, the
    example, then frame 1): B3 once a step; pose and landmarks against
    the same steps on the CPU within FLEET_TOL."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch import entry
    corners, mask = _entry_frames()
    got = []
    for d in (dev, torch.device("cpu")):
        step, (state, c0, m0) = entry.entry(d)
        if not (np.array_equal(c0.cpu().numpy(), corners[0])
                and np.array_equal(m0.cpu().numpy(), mask[0])):
            raise AssertionError("entry: example inputs are not frame 0")
        _reset_counts()
        for i in range(2):
            state, pose = step(state, torch.tensor(corners[i], device=d),
                               torch.tensor(mask[i], device=d))
        got.append((_counts(), pose.cpu().numpy(), state.lm.cpu().numpy()))
    (launches, pose, lm), (_, pose_cpu, lm_cpu) = got
    dp, dl = _max_diff(pose, pose_cpu), _max_diff(lm, lm_cpu)
    log(f"[entry] two frame steps: launches {launches}; pose "
        f"{np.round(pose, 5).tolist()}; max |card - cpu| pose "
        f"{dp:.3e}, landmarks {dl:.3e} (tol {FLEET_TOL})")
    if _b123(launches) != [0, 0, 2] or not (dp <= FLEET_TOL
                                             and dl <= FLEET_TOL):
        raise AssertionError(f"entry: B1/B2/B3 {_b123(launches)} (0/0/2 "
                             f"expected), pose {dp}, landmarks {dl}")
    return launches


def phase_dryrun(smi: str):
    """`entry.dryrun_multichip(4)` and `(8)` on the card: each raises on a
    failed check (JAX's thresholds) and prints JAX's summary line. B3 once
    a frame a shard: 4 frames over n shards and the 4-frame per-sequence
    scan, 2 image frames over n shards; B1 and B2 in the image step."""
    from aruco_slam_tpu_torch import entry
    _reset_counts()
    for n in (4, 8):
        t0 = time.perf_counter()
        entry.dryrun_multichip(n, platform=PLATFORM)
        log(f"[dryrun] dryrun_multichip({n}) in "
            f"{time.perf_counter() - t0:.3f} s on {smi}")
    launches = _counts()
    want = sum(6 * n + 4 for n in (4, 8))
    log(f"[dryrun] launches {launches} (B3 {want} expected)")
    _require(launches, "dry run", ("flood_scan_labels", "refine_corners",
                                   "fused_update"))
    if launches["fused_update"] != want:
        raise AssertionError(f"dryrun: {launches['fused_update']} B3 "
                             f"launches, {want} expected")
    return launches


SCALING_SIZES = (1, 2, 4, 8)   # bench/scaling.py's defaults, its sweep


def scaling_child(out_dir: str, argv) -> int:
    """A bench/scaling.py worker process (--worker or --ingest-worker):
    scaling.main(argv) with the launch counts reset first, then this
    rank's counts into out_dir."""
    import os
    sys.path.insert(0, str(ROOT))
    from aruco_slam_tpu_torch.bench import scaling
    _reset_counts()
    scaling.main(argv)
    mode = "ingest" if "--ingest-worker" in argv else "worker"
    name = (f"{mode}{os.environ['SLAM_NUM_PROCESSES']}_rank"
            f"{os.environ['SLAM_PROCESS_ID']}.json")
    (Path(out_dir) / name).write_text(json.dumps(_counts()))
    return 0


def phase_scaling(tmp: Path, smi: str) -> dict:
    """bench/scaling.py's four modes at its defaults: the sweep (256
    frames, 32 markers, 10 iterations, 3 reps over 1, 2, 4 and 8 mesh
    slots), --fleet 2x2, --processes 2 (two ranks on the card over Gloo)
    and --ingest 2 (64 frames; one process, then two, each pinned to a
    core). Each row is finite and carries JAX's fields; the workers run
    as `chip_smoke.py --scaling-child DIR` for their launch counts: the
    solves none, an ingest call 3 B1 and 1 B2 a 32-frame chunk a process
    (a warm call and 3 reps)."""
    import math
    from aruco_slam_tpu_torch.bench import scaling
    base = ["--platform", PLATFORM]
    rows = scaling.main(base)
    sizes = tuple(r["devices"] for r in rows)
    bad = [r for r in rows if not (math.isfinite(r["seconds"])
                                   and (r["collective_s"] > 0)
                                   == (r["devices"] > 1))]
    if sizes != SCALING_SIZES or bad:
        raise AssertionError(f"scaling sweep: sizes {sizes}, rows {bad}")
    fleet = scaling.main(base + ["--fleet", "2x2"])
    children = tmp / "scaling"
    children.mkdir()
    real = scaling._worker_command
    scaling._worker_command = lambda: [
        sys.executable, str(ROOT / "chip_smoke.py"), "--scaling-child",
        str(children)]
    try:
        procs = scaling.main(base + ["--processes", "2"])
        ingest = scaling.main(base + ["--ingest", "2"])
    finally:
        scaling._worker_command = real
    counts = {f.stem: json.loads(f.read_text())
              for f in sorted(children.glob("*.json"))}
    log(f"[scaling] rows above; worker launches {counts} on {smi}")
    calls = 4  # _ingest_once: a warm call and 3 reps
    # one process: 32-frame chunks; two (at most 64 frames): one each
    chunks = -(-ingest["frames"] // 32)
    want = {"ingest1_rank0": [3 * chunks * calls, chunks * calls, 0],
            "ingest2_rank0": [3 * calls, calls, 0],
            "ingest2_rank1": [3 * calls, calls, 0],
            "worker2_rank0": [0, 0, 0], "worker2_rank1": [0, 0, 0]}
    got = {k: _b123(v) for k, v in counts.items()}
    if got != want or procs["processes"] != 2 \
            or not math.isfinite(fleet["seconds"]) \
            or not ingest["ingest_2proc_s"] > 0:
        raise AssertionError(f"scaling: worker B1/B2/B3 {got}, expected "
                             f"{want}; rows {procs}, {fleet}, {ingest}")
    per_chunk = {k: v // calls for k, v in counts["ingest2_rank0"].items()}
    return {"per_chunk": per_chunk,
            "bench": {f"scaling {k}": v for k, v in counts.items()}}


def phase_fleet_streaming(tmp: Path, paths, seqs, full_warm: dict,
                          smi: str):
    """run_slam --input s0.npz,... --track-every K with one schedule (G =
    0) and with FLEET_COHORTS rescue cohorts: on every frame B1 and B2
    launch as the schedule and the dead flags say (a sweep batch: 3 B1
    and 1 B2 launches; a tracked batch: 3 B2 launches, for all the
    streams in it), B3 once a frame. G = 0: each stream within FLEET_TOL
    of its own single-stream --track-every K run (which must have swept
    only on its schedule), with the same map ids, duplicates identical.
    G > 0: cohort 0 (streams 0 and 1 at 8 streams in 4 cohorts) likewise,
    every stream's ATE under the bound. Warm: aggregate frames/s of both
    beside the full-detection fleet's."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.io import load_map
    ke = str(TRACK_EVERY)
    tlen = len(seqs[0][1])
    singles = []
    for i, path in enumerate(paths):
        record = []
        with _recording_schedule(record):
            singles.append(run_slam.main(
                ["--input", str(path), "--platform", PLATFORM,
                 "--max-obs", MAX_OBS, "--track-every", ke,
                 "--trajectory", str(tmp / f"stream{i}.txt"),
                 "--map", str(tmp / f"stream{i}_map.txt")]))
        off = [f[0] for f in record if bool(f[2][0]) != (f[0] % TRACK_EVERY
                                                          < 2)]
        if len(record) != tlen or off:
            raise AssertionError(f"fleet streaming: single-stream run {i} "
                                 f"swept off its schedule on frames {off}")
    log(f"[fleet-streaming] {len(paths)} single-stream --track-every {ke} "
        "runs swept on their schedule alone")
    paths_launches, warm = {}, {}
    for cohorts, tag in ((0, "fleet-streaming"),
                         (FLEET_COHORTS, "fleet-cohorts")):
        argv = _fleet_argv(tmp, paths, tag, "--track-every", ke,
                           "--rescue-cohorts", str(cohorts))
        record = []
        _reset_counts()
        with _recording_schedule(record):
            fleet = run_slam.main(argv)
        launches = _counts()
        want = [sum(f[1][j] for f in record) for j in range(2)]
        if not cohorts:
            # one schedule, no dead flags: the counts follow from K alone
            sweeps = sum(i % TRACK_EVERY < 2 for i in range(tlen))
            want = [3 * sweeps, sweeps + 3 * (tlen - sweeps)]
        wrong = [(f[0], f[1], f[2]) for f in record if f[1] != f[2]]
        log(f"[{tag}] G = {cohorts}: launches in the run: {launches}; "
            f"expected from the step's sweep decisions: B1 "
            f"{want[0]}, B2 {want[1]}, B3 {tlen}; streams due a sweep per "
            f"frame {[f[3] for f in record]}")
        _require(launches, f"{tag} path", ("flood_scan_labels",
                                           "refine_corners", "fused_update"))
        if (len(record) != tlen or wrong
                or [launches["flood_scan_labels"],
                    launches["refine_corners"]] != want
                or launches["fused_update"] != tlen):
            raise AssertionError(f"{tag}: launches off the schedule: frames "
                                 f"(index, expected, made) {wrong}; run "
                                 f"{launches}, expected {want} and B3 {tlen}")
        # the streams whose single-stream run each must match: all at G =
        # 0, cohort 0 at G > 0
        same = range(STREAMS if not cohorts else STREAMS // cohorts)
        worst = 0.0
        for j in same:
            one = singles[j % len(paths)]
            err = float(np.abs(fleet[j].cam_traj - one.cam_traj).max())
            worst = max(worst, err)
            same_ids = np.array_equal(load_map(fleet[j].map_file)[0],
                                      load_map(one.map_file)[0])
            if not err <= FLEET_TOL or not same_ids:
                raise AssertionError(f"{tag} stream {j}: {err} m from its "
                                     f"single-stream run, map ids equal "
                                     f"{same_ids}")
        if not cohorts:
            for j in range(len(paths)):
                twin = fleet[j + len(paths)]
                if not (np.array_equal(fleet[j].cam_traj, twin.cam_traj)
                        and Path(fleet[j].map_file).read_text()
                        == Path(twin.map_file).read_text()):
                    raise AssertionError(f"{tag}: streams {j} and "
                                         f"{j + len(paths)} (the same "
                                         "input) differ")
        ates = [round(r.ate, 4) for r in fleet]
        log(f"[{tag}] streams {list(same)}: max |fleet - single| "
            f"{worst:.3e} m (tol {FLEET_TOL}); "
            f"{'duplicate streams identical; ' if not cohorts else ''}ATE "
            f"per stream {ates} (bound {ATE_BOUND}); detections per stream "
            f"{[int(r.obs_mask.sum()) for r in fleet]}")
        if not max(ates) < ATE_BOUND:
            raise AssertionError(f"{tag}: ATE {max(ates)} m >= {ATE_BOUND}")
        paths_launches[tag] = launches
        warm[tag] = _fleet_warm(argv, tlen, tag, smi)
    log("[fleet-streaming] warm aggregate frames/s, same call: full "
        f"detection {full_warm['fps']:.2f}, --track-every {ke} "
        f"{warm['fleet-streaming']['fps']:.2f}, with {FLEET_COHORTS} rescue "
        f"cohorts {warm['fleet-cohorts']['fps']:.2f}; front end less load "
        f"(s): {full_warm['front_end_less_load_s']:.3f} / "
        f"{warm['fleet-streaming']['front_end_less_load_s']:.3f} / "
        f"{warm['fleet-cohorts']['front_end_less_load_s']:.3f}")
    return paths_launches


def phase_prefetch(npz: Path, main_res, dev):
    """The main path's frames, from a generator standing in for a video
    decoder, through `io.PrefetchingFrameSource` into the image front
    end: the same observations as the frames fed directly, and the main
    run's accepted observations."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import front_end
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.io import NpzSource, PrefetchingFrameSource
    src = NpzSource(npz)
    images = src["images"]
    cfg = SlamAppConfig(input=str(npz),
                        marker_size=float(src["marker_size"]))
    cam = front_end.camera(src["camera_matrix"], src["dist_coeffs"], dev)

    def decoded():
        for ts, im in zip(src.times, images):
            yield float(ts), im

    out = {}
    for tag, frames in (("direct", decoded),
                        ("ring", lambda: PrefetchingFrameSource(
                            decoded(), images.shape[1:], capacity=16))):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        obs = front_end.observations_from_frames(frames(), cam, cfg, dev)
        torch.cuda.synchronize()
        out[tag] = (obs, time.perf_counter() - t0)
    (direct, t_direct), (ring, t_ring) = out["direct"], out["ring"]
    # (unobserved slots' poses are NaN on both)
    same = all(np.array_equal(a, b, equal_nan=True) for j, (a, b) in
               enumerate(zip(direct, ring)) if j != 4 and a is not None)
    as_main = np.array_equal(ring[3], main_res.obs_mask)
    log(f"[prefetch] {len(images)} frames {SIZE[0]}x{SIZE[1]} through "
        f"PrefetchingFrameSource (capacity 16): observations identical to "
        f"the direct feed {same}, accepted observations equal to the main "
        f"run's {as_main}; front end {t_ring:.3f} s through the ring, "
        f"{t_direct:.3f} s fed directly")
    if not (same and as_main):
        raise AssertionError("prefetch: the ring changed the front end's "
                             "observations")


def phase_factorgraph(argv, gt_t, main_fps: float, smi: str):
    """run_slam --filter factorgraph on the main path's frames (34 poses,
    no marginalization, Huber and depth whitening on): output files,
    ATE, exactly 3 B1 and 1 B2 launches in the chunk and no B3; warm
    frames/s with seconds split into front end and graph."""
    argv = [*argv, "--filter", "factorgraph"]
    _reset_counts()
    _run_slam(argv, gt_t, "factorgraph")
    launches = _counts()
    log(f"[factorgraph] launches in the run: {launches}")
    got = _b123(launches)
    if got != [3, 1, 0]:
        raise AssertionError(f"factorgraph: B1/B2/B3 launches {got}, "
                             "expected [3, 1, 0] in one chunk")
    fps = _warm(argv, len(gt_t), "factorgraph", smi, stage="graph")
    log(f"[factorgraph] warm {fps:.2f} frames/s vs {main_fps:.2f} frames/s "
        "for the main path (MEKF), same call")
    return launches


def phase_factorgraph_online(dev, smi: str) -> dict:
    """bench/factorgraph.py's run at full size through
    `run_slam.run_factorgraph`: a 300-frame orbit at the 128-pose budget,
    window 8, 3 iterations. Cold: the marginalizations, made exactly
    after frames 125, 189 and 253 (counted by the frame they follow),
    and ATE under ONLINE_ATE_BOUND; warm: frames/s. Then the card
    against the CPU at float64 over the first GRAPH_CHECK_FRAMES frames
    (which cross one marginalization): trajectories within GRAPH_TOL."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import factorgraph as fg_bench
    from aruco_slam_tpu_torch.bench.ate import ate_rmse
    from aruco_slam_tpu_torch.config import SlamAppConfig
    traj, obs, cam = fg_bench.inputs(ONLINE_FRAMES, 12)
    cfg = SlamAppConfig(input="", filter="factorgraph", window=8,
                        pose_budget=POSE_BUDGET)

    def run_all(n, device, dtype=torch.float32):
        return run_slam.run_factorgraph(
            cfg, traj.times[:n], obs.t_cl[:n], obs.q_cl[:n], obs.mask[:n],
            cam, device, dtype=dtype)

    def run(n, device):
        return run_all(n, device)[0]

    added, marginalized = [0], []
    real_add, real_marg = run_slam.add_frame, run_slam.marginalize_poses

    def add(*a, **k):
        added[0] += 1
        return real_add(*a, **k)

    def marginalize(*a, **k):
        marginalized.append(added[0] - 1)
        return real_marg(*a, **k)

    run_slam.add_frame, run_slam.marginalize_poses = add, marginalize
    try:
        cold = run(ONLINE_FRAMES, dev)
    finally:
        run_slam.add_frame, run_slam.marginalize_poses = real_add, real_marg
    err = ate_rmse(cold[:, :3], traj.cam_t)
    want = list(range(POSE_BUDGET - 3, ONLINE_FRAMES, POSE_BUDGET // 2))
    log(f"[factorgraph-online] {ONLINE_FRAMES} frames, pose budget "
        f"{POSE_BUDGET}: marginalized after frames {marginalized} (expected "
        f"{want}); ATE {err:.4f} m (bound {ONLINE_ATE_BOUND})")
    if marginalized != want or not np.isfinite(cold).all() \
            or not err < ONLINE_ATE_BOUND:
        raise AssertionError(f"factorgraph-online: marginalized after "
                             f"{marginalized}, ATE {err}")
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    run(ONLINE_FRAMES, dev)
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    fps = ONLINE_FRAMES / dt
    log(f"[factorgraph-online] warm run: {ONLINE_FRAMES} frames in {dt:.3f} "
        f"s = {fps:.2f} frames/s on {smi}")
    busy, wall, events = busy_share(lambda: run(PROFILE_FRAMES, dev))
    log(f"[factorgraph-online] device busy {busy} of the wall over the "
        f"first {PROFILE_FRAMES} frames under torch.profiler ({wall:.3f} s); "
        f"{events} device events, {events / PROFILE_FRAMES:.1f} a frame")
    n = GRAPH_CHECK_FRAMES
    t0 = time.perf_counter()
    card = run_all(n, dev, torch.float64)
    t_card = time.perf_counter() - t0
    t0 = time.perf_counter()
    host = run_all(n, torch.device("cpu"), torch.float64)
    t_host = time.perf_counter() - t0
    # the trajectory as run_slam writes it (float32, as the JAX run_slam)
    # and the landmarks at the solve's float64
    traj_diff = float(np.abs(card[0] - host[0]).max())
    lm_diff = float(np.abs(card[2] - host[2]).max())
    diff = max(traj_diff, lm_diff)
    log(f"[factorgraph-online] f64, first {n} frames: max |card - CPU| "
        f"{traj_diff:.3e} m on the float32 trajectory, {lm_diff:.3e} m on "
        f"the float64 landmarks (tol {GRAPH_TOL}); {t_card:.3f} s on the "
        f"card, {t_host:.3f} s on the CPU")
    if not diff <= GRAPH_TOL:
        raise AssertionError(f"factorgraph-online: the card's f64 "
                             f"trajectory is {diff} m from the CPU's")
    return {"fps": fps, "ate_m": err, "marginalized_after": marginalized,
            "card_vs_cpu_m": diff, "busy": busy}


def phase_offline(npz: Path, tmp: Path, smi: str):
    """run_offline on the main npz (3 B1, 1 B2 and no B3 launches; ATE
    under ATE_BOUND; the map written), then the large-map batch solve:
    LARGE_MARKERS markers (extent 11, depth 4.5, seed 0) surveyed by a
    LARGE_FRAMES-frame 4-row raster, corners with 0.3 px noise (seed 1)
    saved as a corners npz, `run_offline --iters LARGE_ITERS`: ingest
    and solve seconds, the final cost (finite, no higher than the
    ingested state's), ATE and peak device memory."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_offline
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.graph import ba
    from aruco_slam_tpu_torch.io import load_map, save_npz
    _reset_counts()
    res = run_offline.main(["--input", str(npz), "--platform", PLATFORM,
                            "--trajectory", str(tmp / "offline.txt"),
                            "--map", str(tmp / "offline_map.txt")])
    launches = _counts()
    got = _b123(launches)
    ids = load_map(res.map_file)[0]
    log(f"[offline] launches in the run: {launches}; ATE {res.ate:.4f} m "
        f"(bound {ATE_BOUND}); {len(ids)} landmarks; final cost "
        f"{res.cost:.3f}; seconds {res.seconds}")
    if got != [3, 1, 0] or not res.ate < ATE_BOUND or not len(ids) \
            or not np.isfinite(res.cam_traj).all():
        raise AssertionError(f"offline: B1/B2/B3 launches {got} (expected "
                             f"[3, 1, 0]), ATE {res.ate}, {len(ids)} "
                             "landmarks")

    # the large map
    t0 = time.perf_counter()
    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    d = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    extent = 11.0 * np.sqrt(LARGE_MARKERS / 512.0)
    scene = synthetic.make_wall_scene(num_markers=LARGE_MARKERS, seed=0,
                                      extent=float(extent), depth=4.5)
    traj = synthetic.make_raster_trajectory(
        num_frames=LARGE_FRAMES, rows=4, extent_x=float(extent - 2.0),
        extent_y=float(0.4 * extent))
    corners, cmask = synthetic.observe_corners(
        scene, traj, cam_mod.CameraModel.from_matrix(k, d), LARGE_MARKERS,
        noise_px=0.3, seed=1)
    large = tmp / "large_map.npz"
    save_npz(large, times=traj.times, corners=corners, corner_mask=cmask,
             gt_cam_t=traj.cam_t, camera_matrix=k, dist_coeffs=d,
             marker_size=np.float64(scene.marker_size))
    log(f"[offline] large map: {LARGE_MARKERS} markers, {LARGE_FRAMES} "
        f"raster frames, {cmask.sum(1).mean():.1f} visible a frame on "
        f"average; made in {time.perf_counter() - t0:.1f} s")
    ingested = []
    real = run_offline.batch_optimize

    def recording(cfg, state, iters):
        ingested.append((float(ba._cost_only(cfg, state)), cfg, state))
        return real(cfg, state, iters=iters)

    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    run_offline.batch_optimize = recording
    t0 = time.perf_counter()
    try:
        big = run_offline.main(["--input", str(large), "--platform", PLATFORM,
                                "--iters", str(LARGE_ITERS),
                                "--trajectory", str(tmp / "large.txt"),
                                "--map", str(tmp / "large_map.txt")])
    finally:
        run_offline.batch_optimize = real
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    cost0, gcfg, state = ingested[0]
    # the solve again from the same ingested state, under the profiler
    busy, busy_wall, events = busy_share(lambda: ba.batch_optimize(
        gcfg, state, iters=LARGE_ITERS))
    t = LARGE_FRAMES + 2
    out = {"poses": t, "h_pp": 6 * t, "markers": LARGE_MARKERS,
           "landmarks": len(big.landmark_ids), "iters": LARGE_ITERS,
           **{f"{k}_s": v for k, v in big.seconds.items()}, "wall_s": wall,
           "ingest_cost": cost0, "final_cost": big.cost, "ate_m": big.ate,
           "peak_bytes": peak, "solve_busy": busy}
    log(f"[offline] large map: {t} poses (H_pp {6 * t} x {6 * t}), "
        f"{out['landmarks']} landmarks; front end {out['front_end_s']:.3f} "
        f"s, ingest {out['ingest_s']:.3f} s, {LARGE_ITERS}-iteration solve "
        f"{out['solve_s']:.3f} s ({wall:.3f} s wall); cost {cost0:.3f} "
        f"ingested -> {big.cost:.3f}; ATE {big.ate:.4f} m; peak device "
        f"memory {peak / 2**30:.2f} GiB; solve device busy {busy} under "
        f"torch.profiler ({busy_wall:.3f} s, {events / LARGE_ITERS:.1f} "
        f"device events an iteration) on {smi}")
    if not np.isfinite(big.cost) or big.cost > cost0 \
            or not big.ate < ATE_BOUND:
        raise AssertionError(f"offline large map: cost {cost0} -> "
                             f"{big.cost}, ATE {big.ate}")
    return launches, out, (cost0, gcfg, state, traj.cam_t)


def _warm_s(fn):
    """(seconds, result) of a second call of fn() (the first warms it),
    synced."""
    import torch
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return time.perf_counter() - t0, out


def _max_diff(a, b) -> float:
    import numpy as np
    return float(np.abs(np.asarray(a, np.float64)
                        - np.asarray(b, np.float64)).max())


def _offline_argv(inputs, tmp: Path, tag: str, *flags) -> list[str]:
    return ["--input", ",".join(map(str, inputs)), "--platform", PLATFORM,
            "--f64", "--trajectory", str(tmp / f"{tag}.txt"),
            "--map", str(tmp / f"{tag}_map.txt"), *flags]


def phase_fleet_ba(tmp: Path, paths, smi: str) -> dict:
    """run_offline --fleet on the fleet's four image inputs at float64:
    1x1 (the four problems batched on the card) and 2x2 with
    --local-devices 4 (two problems a data row, each landmark-sharded
    over 2): each sequence within FLEET_BA_TOL of its own single run, B1 3
    and B2 1 a sequence, B3 none. Then each solve again, warm, from the
    ingested states: seconds and device events an iteration, against one
    problem's."""
    import torch
    from aruco_slam_tpu_torch.apps import run_offline
    from aruco_slam_tpu_torch.graph import ba
    from aruco_slam_tpu_torch.parallel import sharded_ba
    singles, captured = [], {}
    real_batch = run_offline.batch_optimize
    real_fleet = run_offline.sharded_fleet_optimize

    def batch(cfg, state, iters):
        captured["one"] = (cfg, state, iters)
        return real_batch(cfg, state, iters=iters)

    def fleet(cfg, states, mesh, iters):
        captured["fleet"] = (cfg, states, mesh, iters)
        return real_fleet(cfg, states, mesh, iters=iters)

    run_offline.batch_optimize = batch
    run_offline.sharded_fleet_optimize = fleet
    counts, out = {}, {}
    try:
        for i, path in enumerate(paths):
            singles.append(run_offline.main(_offline_argv(
                [path], tmp, f"fba_one{i}")))
        for shape, flags in (("1x1", ()), ("2x2", ("--local-devices", "4"))):
            _reset_counts()
            res = run_offline.main(_offline_argv(
                paths, tmp, f"fba_{shape}", "--fleet", shape, *flags))
            counts[shape] = _counts()
            got = [counts[shape][k] for k in ("flood_scan_labels",
                                              "refine_corners",
                                              "fused_update")]
            worst = max(_max_diff(r.cam_traj, one.cam_traj)
                        for r, one in zip(res, singles))
            log(f"[fleet-ba] --fleet {' '.join((shape, *flags))}: "
                f"{len(res)} sequences, launches "
                f"{counts[shape]}; max |fleet - single| {worst:.3e} m (tol "
                f"{FLEET_BA_TOL}); solve {res[0].seconds['solve']:.3f} s, "
                f"ingest {res[0].seconds['ingest']:.3f} s in the run")
            if got != [3 * len(paths), len(paths), 0] \
                    or not worst <= FLEET_BA_TOL:
                raise AssertionError(f"fleet-ba {shape}: B1/B2/B3 {got}, "
                                     f"{worst} m from the single runs")
            cfg, states, mesh, iters = captured["fleet"]
            sec, _ = _warm_s(functools.partial(
                sharded_ba.sharded_fleet_optimize, cfg, states, mesh,
                iters=iters))
            busy, _, events = busy_share(functools.partial(
                sharded_ba.sharded_fleet_optimize, cfg, states, mesh,
                iters=PROFILE_ITERS))
            out[shape] = {"solve_s": sec, "busy": busy,
                          "events_per_iter": events / PROFILE_ITERS}
    finally:
        run_offline.batch_optimize = real_batch
        run_offline.sharded_fleet_optimize = real_fleet
    cfg, state, iters = captured["one"]
    sec, _ = _warm_s(functools.partial(ba.batch_optimize, cfg, state,
                                       iters=iters))
    busy, _, events = busy_share(functools.partial(
        ba.batch_optimize, cfg, state, iters=PROFILE_ITERS))
    out["one"] = {"solve_s": sec, "busy": busy,
                  "events_per_iter": events / PROFILE_ITERS}
    for k, v in out.items():
        what = "one problem" if k == "one" else \
            f"{len(paths)} problems, --fleet {k}"
        log(f"[fleet-ba] warm {iters}-iteration f64 solve, {what}: "
            f"{v['solve_s']:.3f} s, {v['events_per_iter']:.1f} device events "
            f"an iteration, device busy {v['busy']} (torch.profiler, "
            f"{PROFILE_ITERS} iterations) on {smi}")
    return {"fleet-ba 1x1": counts["1x1"], "fleet-ba 2x2": counts["2x2"],
            "times": out}


def _to_f64(cfg, state):
    import torch
    from aruco_slam_tpu_torch.graph import ba
    cfg64 = cfg._replace(dtype=torch.float64)
    return cfg64, ba.state_from_numpy(cfg64, ba.state_to_numpy(state),
                                      device=state.pose_q.device)


def phase_sharded_ba(ingested, smi: str) -> dict:
    """The large map's ingested state through `sharded_batch_optimize` in
    one process at local_devices 2 and 4: float32 warm seconds, device
    events an iteration and busy share against the unsharded solve (cost
    finite, no higher than ingested); then float64, sharded against
    unsharded: cost within SHARD_COST_RTOL, trajectory and landmarks
    within SHARD_TOL."""
    import numpy as np
    from aruco_slam_tpu_torch.bench.ate import ate_rmse
    from aruco_slam_tpu_torch.graph import ba
    from aruco_slam_tpu_torch.parallel import dist, sharded_ba
    cost0, cfg, state, gt_t = ingested
    t = len(gt_t)
    runs = {"unsharded": lambda c, s, n: ba.batch_optimize(c, s, iters=n)}
    for m in SHARD_LOCAL:
        mesh = dist.make_mesh(local_devices=m)
        runs[f"local {m}"] = lambda c, s, n, mesh=mesh: \
            sharded_ba.sharded_batch_optimize(c, s, mesh, iters=n)
    out, f32 = {}, {}
    for name, run in runs.items():
        sec, (res, cost) = _warm_s(lambda: run(cfg, state, LARGE_ITERS))
        busy, _, events = busy_share(lambda: run(cfg, state, PROFILE_ITERS))
        cost = float(cost)
        err = ate_rmse(res.pose_t[:t].cpu().numpy(), gt_t)
        f32[name] = res.pose_t[:t].cpu().numpy()
        out[name] = {"solve_s": sec, "busy": busy, "cost": cost,
                     "ate_m": err, "events_per_iter": events / PROFILE_ITERS}
        log(f"[sharded-ba] f32 {name}: {LARGE_ITERS}-iteration solve "
            f"{sec:.3f} s warm; over {PROFILE_ITERS} iterations under "
            f"torch.profiler {events / PROFILE_ITERS:.1f} device events an "
            f"iteration, device busy {busy}; cost {cost0:.3f} ingested -> "
            f"{cost:.3f}; ATE {err:.4f} m; max |pose - unsharded| "
            f"{_max_diff(f32[name], f32['unsharded']):.3e} m on {smi}")
        if not np.isfinite(cost) or cost > cost0 or not err < ATE_BOUND:
            raise AssertionError(f"sharded-ba f32 {name}: cost {cost0} -> "
                                 f"{cost}, ATE {err}")
    cfg64, state64 = _to_f64(cfg, state)
    ref = None
    for name, run in runs.items():
        res, cost = run(cfg64, state64, LARGE_ITERS)
        got = (float(cost), res.pose_t[:t].cpu().numpy(),
               res.lm.cpu().numpy())
        if ref is None:
            ref = got
            out["f64_unsharded"] = {"cost": got[0], "pose_t": got[1],
                                    "lm": got[2]}
            continue
        rel = abs(got[0] - ref[0]) / abs(ref[0])
        dt, dl = _max_diff(got[1], ref[1]), _max_diff(got[2], ref[2])
        log(f"[sharded-ba] f64 {name} against unsharded: cost {got[0]:.9f} "
            f"vs {ref[0]:.9f} (rel {rel:.2e}, tol {SHARD_COST_RTOL}); max "
            f"|pose_t| diff {dt:.3e} m, |lm| diff {dl:.3e} m (tol "
            f"{SHARD_TOL})")
        if not (rel <= SHARD_COST_RTOL and dt <= SHARD_TOL
                and dl <= SHARD_TOL):
            raise AssertionError(f"sharded-ba f64 {name}: cost rel {rel}, "
                                 f"pose {dt} m, landmarks {dl} m")
    return out


def _free_port() -> int:
    import socket
    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def _spawn_ranks(args) -> None:
    """DIST_RANKS processes of `chip_smoke.py *args` joined as one run,
    launched as run_offline --processes launches its children."""
    from aruco_slam_tpu_torch.apps import run_offline
    rc = run_offline._spawn(
        [sys.executable, str(ROOT / "chip_smoke.py"), *args], DIST_RANKS,
        f"127.0.0.1:{_free_port()}")
    if any(rc):
        raise AssertionError(f"rank processes {args[0]} failed: exit codes "
                             f"{rc}")


def rank_child(out_dir: str, argv) -> int:
    """A `run_offline --processes` child: run_offline.main(argv) with the
    launch counts reset first, then this rank's counts and observations
    into out_dir."""
    import os
    import numpy as np
    sys.path.insert(0, str(ROOT))
    from aruco_slam_tpu_torch.apps import run_offline
    obs = []
    real = run_offline.load_observations

    def load(*a, **k):
        obs.append(real(*a, **k))
        return obs[-1]

    run_offline.load_observations = load
    _reset_counts()
    run_offline.main(argv)
    pid = os.environ["SLAM_PROCESS_ID"]
    (Path(out_dir) / f"rank{pid}.json").write_text(json.dumps(_counts()))
    o, = obs
    np.savez(Path(out_dir) / f"obs{pid}.npz", t_cl=o[1], q_cl=o[2],
             mask=o[3], slot_ids=o[6])
    return 0


def rank_solve(out_dir: str, platform: str) -> int:
    """One rank of the two-process large-map solve: the saved ingested
    state through `sharded_batch_optimize` over every rank (float32 twice,
    the second timed warm, then PROFILE_ITERS iterations that rank 0
    traces for device events and busy share, then float64); rank 0
    prints the backend."""
    import numpy as np
    import torch
    sys.path.insert(0, str(ROOT))
    from aruco_slam_tpu_torch._device import resolve_device
    from aruco_slam_tpu_torch.graph import ba
    from aruco_slam_tpu_torch.parallel import dist, sharded_ba
    dist.initialize(platform=platform)
    dev = resolve_device(platform)
    out = Path(out_dir)
    spec = json.loads((out / "cfg.json").read_text())
    arrays = dict(np.load(out / "state.npz"))
    mesh = dist.make_mesh()
    res = {}
    for dt in (torch.float32, torch.float64):
        cfg = ba.GraphConfig(**spec, dtype=dt)
        state = ba.state_from_numpy(cfg, arrays, device=dev)
        secs = []
        for _ in range(2 if dt == torch.float32 else 1):
            if dev.type == "cuda":
                torch.cuda.synchronize()
            t0 = time.perf_counter()
            o, cost = sharded_ba.sharded_batch_optimize(cfg, state, mesh,
                                                        iters=LARGE_ITERS)
            float(cost)
            secs.append(time.perf_counter() - t0)
        tag = "f32" if dt == torch.float32 else "f64"
        if dt == torch.float32:
            # every rank runs the traced solve's collectives; rank 0 traces
            def profiled():
                float(sharded_ba.sharded_batch_optimize(
                    cfg, state, mesh, iters=PROFILE_ITERS)[1])
            if dist.process_index() == 0:
                busy, _, events = busy_share(profiled)
                res["profile"] = np.asarray(
                    [np.nan if busy is None else busy, events])
            else:
                profiled()
        res.update({f"{tag}_cost": cost.cpu().numpy(),
                    f"{tag}_seconds": np.asarray(secs),
                    **{f"{tag}_{k}": getattr(o, k).cpu().numpy()
                       for k in ("pose_q", "pose_t", "lm", "lm_q")}})
    np.savez(out / f"solve{dist.process_index()}.npz", **res)
    return 0


def phase_dist(npz: Path, tmp: Path, ingested, f64_ref, smi: str) -> dict:
    """Two processes over torch.distributed on the card (Gloo over CUDA
    tensors: they share it). run_offline --processes 2 --f64 on the main
    frames: each rank launches B1 and B2 only for the chunk it owns,
    the observations of both ranks against the single-process front
    end's, the trajectory within FLEET_BA_TOL of the single run. Then the
    large map's ingested state, saved with state_to_numpy, through the
    sharded solve in two rank processes: seconds, the two ranks' poses
    bit-equal, f64 within SHARD_TOL of the unsharded solve."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_offline
    from aruco_slam_tpu_torch.graph import ba
    obs = []
    real_load = run_offline.load_observations

    def load(*a, **k):
        obs.append(real_load(*a, **k))
        return obs[-1]

    run_offline.load_observations = load
    try:
        single = run_offline.main(_offline_argv([npz], tmp, "dist_single"))
    finally:
        run_offline.load_observations = real_load
    want = obs[0]
    ranks = tmp / "ranks"
    ranks.mkdir()
    real_cmd = run_offline._child_command
    run_offline._child_command = lambda: [
        sys.executable, str(ROOT / "chip_smoke.py"), "--rank-child",
        str(ranks)]
    t0 = time.perf_counter()
    try:
        run_offline.main(_offline_argv(
            [npz], tmp, "dist_multi", "--processes", str(DIST_RANKS),
            "--coordinator",
            f"127.0.0.1:{_free_port()}"))
    finally:
        run_offline._child_command = real_cmd
    wall = time.perf_counter() - t0
    from aruco_slam_tpu_torch.io import read_trajectory
    multi = read_trajectory(tmp / "dist_multi.txt")[1]
    diff = _max_diff(multi, single.cam_traj)
    counts = [json.loads((ranks / f"rank{r}.json").read_text())
              for r in range(DIST_RANKS)]
    same = []
    for r in range(DIST_RANKS):
        got = np.load(ranks / f"obs{r}.npz")
        same.append(all(np.array_equal(got[k], w, equal_nan=True)
                        for k, w in (("t_cl", want[1]), ("q_cl", want[2]),
                                     ("mask", want[3]),
                                     ("slot_ids", want[6]))))
    log(f"[dist] run_offline --processes {DIST_RANKS} --f64 on the main "
        f"frames: {wall:.3f} s wall (the processes' start included); "
        f"launches per rank "
        f"{counts}; observations bit-identical to the single-process front "
        f"end per rank {same}; max |multi - single| {diff:.3e} m (tol "
        f"{FLEET_BA_TOL})")
    b = [_b123(c) for c in counts]
    if b != [[3, 1, 0]] * DIST_RANKS or not all(same) \
            or not diff <= FLEET_BA_TOL:
        raise AssertionError(f"dist: B1/B2/B3 per rank {b} (one "
                             f"{DIST_CHUNK}-frame chunk each expected), "
                             f"observations identical "
                             f"{same}, {diff} m from the single run")

    cost0, cfg, state, gt_t = ingested
    solve = tmp / "solve"
    solve.mkdir()
    spec = {k: v for k, v in cfg._asdict().items() if k != "dtype"}
    (solve / "cfg.json").write_text(json.dumps(spec))
    np.savez(solve / "state.npz", **ba.state_to_numpy(state))
    t0 = time.perf_counter()
    _spawn_ranks(["--rank-solve", str(solve), PLATFORM])
    wall = time.perf_counter() - t0
    r0, r1 = (np.load(solve / f"solve{r}.npz") for r in range(2))
    equal = all(r0[k].tobytes() == r1[k].tobytes()
                for tag in ("f32", "f64")
                for k in (f"{tag}_{e}" for e in ("cost", "pose_q", "pose_t",
                                                 "lm", "lm_q")))
    busy, events = r0["profile"].tolist()
    busy = None if np.isnan(busy) else busy
    t = len(gt_t)
    rel = abs(float(r0["f64_cost"]) - f64_ref["cost"]) / abs(f64_ref["cost"])
    dt = _max_diff(r0["f64_pose_t"][:t], f64_ref["pose_t"])
    dl = _max_diff(r0["f64_lm"], f64_ref["lm"])
    c32 = float(r0["f32_cost"])
    secs = r0["f32_seconds"].tolist()
    log(f"[dist] large map over {DIST_RANKS} processes ({DIST_RANKS} "
        f"shards): f32 {LARGE_ITERS}-iteration solve {secs[0]:.3f} s cold, "
        f"{secs[1]:.3f} s warm; over {PROFILE_ITERS} iterations under "
        f"torch.profiler on rank 0 {events / PROFILE_ITERS:.1f} device "
        f"events an iteration, device busy {busy}; f64 "
        f"{float(r0['f64_seconds'][0]):.3f} s; "
        f"{wall:.3f} s wall with the processes' start; f32 cost {cost0:.3f} "
        f"ingested -> {c32:.3f}; ranks' results bit-equal {equal}; f64 "
        f"against unsharded: cost rel {rel:.2e}, max |pose_t| {dt:.3e} m, "
        f"|lm| {dl:.3e} m (tol {SHARD_TOL}) on {smi}")
    if not (equal and np.isfinite(c32) and c32 <= cost0
            and rel <= SHARD_COST_RTOL and dt <= SHARD_TOL
            and dl <= SHARD_TOL):
        raise AssertionError("dist large map: ranks equal "
                             f"{equal}, f32 cost {c32}, f64 rel {rel}, "
                             f"pose {dt} m, landmarks {dl} m")
    return {**{f"dist rank{r}": c for r, c in enumerate(counts)},
            "large_f32_s": secs, "obs_identical": same}


def calibration_views(n_views: int = CALIB_VIEWS, seed: int = SEED):
    """tests/test_calibrate.py make_charuco_views' views of the
    reference's board (7x5 squares, 30/15 mm, AprilTag 36h11, 96 px a
    square) at CALIB_SIZE under CALIB_K / CALIB_DIST: (board, the (V, H,
    W) uint8 views, each view's (24, 2) true chessboard-corner pixels)."""
    import numpy as np
    from scipy.spatial.transform import Rotation
    from aruco_slam_tpu_torch.bench import render
    from aruco_slam_tpu_torch.bench.synthetic import project_np
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.ops import calibrate as cal
    from aruco_slam_tpu_torch.ops import dictionary
    board = cal.charuco_board(7, 5, 0.03, 0.015)
    cam = cam_mod.CameraModel.from_matrix(np.asarray(CALIB_K),
                                          np.asarray(CALIB_DIST))
    rng = np.random.default_rng(seed)
    ex, ey = 7 * 0.03, 5 * 0.03
    center = np.array([ex / 2, ey / 2, 0.0])
    flip = Rotation.from_euler("x", np.pi).as_matrix()  # face the camera
    poses, chess = [], []
    pts3 = np.concatenate([board.chess_pts, np.zeros((24, 1))], -1)
    for _ in range(n_views):
        rot = Rotation.from_euler(
            "xyz", rng.uniform(-0.35, 0.35, 3)).as_matrix() @ flip
        dist = rng.uniform(0.30, 0.42)
        t = np.array([rng.uniform(-0.02, 0.02),
                      rng.uniform(-0.02, 0.02), dist]) - rot @ center
        poses.append(np.concatenate(
            [Rotation.from_matrix(rot).as_rotvec(), t]))
        chess.append(project_np(cam, pts3 @ rot.T + t))
    bmp = render.charuco_bitmap(board, dictionary.load("apriltag_36h11"),
                                px_per_square=96)
    views = render.render_plane_views(bmp, (ex, ey), cam, np.asarray(poses),
                                      CALIB_SIZE)
    return board, views, np.asarray(chess)


def grid_views(n_views: int = CALIB_VIEWS, noise_px: float = 0.1,
               seed: int = SEED):
    """tests/test_calibrate.py make_views' correspondences, projected by
    the port's camera: the 4x3 grid board from tilted poses, (board,
    corners (V, 12, 4, 2), mask (V, 12))."""
    import numpy as np
    from scipy.spatial.transform import Rotation
    from aruco_slam_tpu_torch.bench.synthetic import project_np
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.ops import calibrate as cal
    board = cal.grid_board(4, 3, marker_size=0.05, gap=0.015)
    cam = cam_mod.CameraModel.from_matrix(np.asarray(CALIB_K),
                                          np.asarray(CALIB_DIST))
    rng = np.random.default_rng(seed)
    m = len(board.ids)
    pts_board = np.concatenate([board.corners, np.zeros((m, 4, 1))], -1)
    center = pts_board.reshape(-1, 3).mean(0)
    w, h = CALIB_SIZE
    corners = np.zeros((n_views, m, 4, 2))
    mask = np.zeros((n_views, m), bool)
    for i in range(n_views):
        r = Rotation.from_euler("xyz", rng.uniform(-0.45, 0.45, 3)
                                ).as_matrix()
        t = np.array([rng.uniform(-0.05, 0.05), rng.uniform(-0.05, 0.05),
                      rng.uniform(0.35, 0.7)])
        pts_cam = (pts_board - center) @ r.T + t
        px = project_np(cam, pts_cam)
        px += rng.normal(scale=noise_px, size=px.shape)
        ok = ((pts_cam[..., 2] > 0.05).all(-1)
              & (px[..., 0] > 5).all(-1) & (px[..., 0] < w - 5).all(-1)
              & (px[..., 1] > 5).all(-1) & (px[..., 1] < h - 5).all(-1))
        corners[i][ok] = px[ok]
        mask[i] = ok
    return board, corners, mask


def _b5_calibration(views, chess, rng, dev) -> list:
    """B5 at the calibration CLI's shapes: the 24 chessboard corners of
    one view and of all CALIB_VIEWS views (the CLI's one batched call),
    seeded up to 1.5 px off the true corners on the float32 views, as
    the CLI gathers them."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.ops import cuda_subpix
    rad, _ = cuda_subpix.schedule_params(REFINE_SCHED)
    p = 2 * rad + 1
    img = torch.from_numpy(views).to(dev).to(torch.float32)
    seeds = chess + rng.uniform(-1.5, 1.5, chess.shape)
    pts = torch.as_tensor(seeds, dtype=torch.float32, device=dev)
    cases = []
    for v in (1, len(views)):
        patches, cx0, cy0 = cuda_subpix.gather_patches(img[:v], pts[:v], rad)
        c0 = cuda_subpix.start_offsets(pts[:v], cx0, cy0, rad)
        patches, c0 = patches.reshape(-1, p, p), c0.reshape(-1, 2)
        got = cuda_subpix.refine_offsets(patches, c0, REFINE_SCHED)
        want = cuda_subpix.refine_offsets_plain(patches, c0, REFINE_SCHED)
        torch.cuda.synchronize()
        err = float((got - want).abs().max())
        t = timings(lambda: cuda_subpix.refine_offsets(patches, c0,
                                                       REFINE_SCHED),
                    lambda: cuda_subpix.refine_offsets_plain(patches, c0,
                                                             REFINE_SCHED))
        b_ms, b_by = _subpix_bound(patches.shape[0], REFINE_SCHED, 4)
        log(f"[B5] calibration: refine_offsets {tuple(patches.shape)} "
            f"({v} view(s) x 24 chessboard corners) schedule "
            f"{REFINE_SCHED}: max |kernel - plain| {err:.3e} px (tol "
            f"{B5_TOL}); {_fmt_t(t)}, bound {b_ms:.6f} ms ({b_by})")
        if not np.isfinite(err) or err > B5_TOL:
            raise AssertionError(f"B5 differs from its plain version at "
                                 f"{v} x 24 patches: {err}")
        cases.append({"shape": list(patches.shape), "max_abs_err": err, **t,
                      "bound_ms": b_ms, "bound_by": b_by})
    return cases


def phase_undistort(images, cams, dev, smi: str) -> None:
    """core/camera.undistort_image on the card against the CPU, at each
    image's size: within one gray level (a rounding tie at .5 may fall
    either way); ms a call on the card."""
    import torch
    from aruco_slam_tpu_torch.core import camera as cam_mod
    for img, cam in zip(images, cams):
        h, w = img.shape
        cpu_img = torch.from_numpy(img)
        t0 = time.perf_counter()
        want = cam_mod.undistort_image(cam, cpu_img)
        cpu_s = time.perf_counter() - t0
        cam_d, img_d = cam.to(device=dev), cpu_img.to(dev)
        got = cam_mod.undistort_image(cam_d, img_d).cpu()
        diff = (got.int() - want.int()).abs()
        off = int((diff > 0).sum())
        ms = call_ms(lambda: cam_mod.undistort_image(cam_d, img_d))
        log(f"[undistort] {w}x{h}: max |card - cpu| {int(diff.max())} gray "
            f"levels, {off} of {img.size} pixels off by one; {ms:.3f} ms a "
            f"call on the card ({1e3 * cpu_s:.1f} ms one call on the host "
            f"CPU) on {smi}")
        if int(diff.max()) > 1:
            raise AssertionError(f"undistort_image {w}x{h}: the card is "
                                 f"{int(diff.max())} levels off the CPU")


def _max_rel(got, want) -> float:
    """The largest relative difference over the nonzero entries of
    ``want``."""
    import numpy as np
    nz = want != 0
    return float((np.abs(got - want)[nz] / np.abs(want[nz])).max())


CALIB_ARGS = ["--board", "charuco", "--grid", "7x5", "--square-size",
              "0.03", "--marker-size", "0.015", "--dict", "apriltag_36h11",
              "--iters", str(CALIB_ITERS), "--preview", "2"]


def phase_calibrate(tmp: Path, board, views, dev, smi: str) -> dict:
    """The calibration CLI at the reference's configuration on the card,
    cold (its launches: exactly one B5, the detector's B1 and B2; the
    intrinsics within tests/test_calibrate.py's tolerances; the previews
    read back) and warm (stage seconds; the LM's device events and busy
    share), against the same CLI on the CPU; then `calibrate` on the
    grid board's correspondences, the card against the CPU at f64."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import calibrate as cli
    from aruco_slam_tpu_torch.io import read_png_gray, save_npz
    from aruco_slam_tpu_torch.ops import calibrate as cal
    npz = tmp / "calib_views.npz"
    save_npz(npz, images=views)
    argv = ["--images", str(npz), *CALIB_ARGS]
    _reset_counts()
    cold = cli.main(argv + ["--platform", PLATFORM,
                            "--out", str(tmp / "calib")])
    launches = _counts()
    k = cold.result.camera_matrix
    log(f"[calibrate] {len(views)} views {CALIB_SIZE[0]}x{CALIB_SIZE[1]}: "
        f"launches in the run: {launches}; fx {k[0, 0]:.3f} fy "
        f"{k[1, 1]:.3f} cx {k[0, 2]:.3f} cy {k[1, 2]:.3f}, dist "
        f"{np.round(cold.result.dist_coeffs, 5).tolist()}, rms "
        f"{cold.result.rms_px:.4f} px; cold stage seconds {cold.seconds}")
    if launches["refine_offsets"] != 1:
        raise AssertionError(f"calibrate: {launches['refine_offsets']} B5 "
                             "launches (one batched call expected)")
    _require(launches, "calibrate path", ("flood_scan_labels",
                                          "refine_corners"))
    ok = (abs(k[0, 0] / CALIB_K[0][0] - 1) <= 0.015
          and abs(k[1, 1] / CALIB_K[1][1] - 1) <= 0.015
          and abs(k[0, 2] - CALIB_K[0][2]) <= 6
          and abs(k[1, 2] - CALIB_K[1][2]) <= 6
          and cold.result.rms_px < 0.6)
    if not ok:
        raise AssertionError(f"calibrate: intrinsics {k.tolist()}, rms "
                             f"{cold.result.rms_px} outside the tolerances")
    for path in cold.previews:
        im = read_png_gray(path)
        if im.shape != views[0].shape or not im.max() > 100:
            raise AssertionError(f"preview {path.name}: {im.shape}, max "
                                 f"{im.max()}")
    log(f"[calibrate] previews {[p.name for p in cold.previews]} decode "
        f"({views[0].shape[1]}x{views[0].shape[0]})")

    captured = []
    real = cal._lm_calibrate

    def capture(*args, **kw):
        captured.append((args, kw))
        return real(*args, **kw)

    cal._lm_calibrate = capture
    try:
        warm = cli.main(argv + ["--platform", PLATFORM,
                                "--out", str(tmp / "calib_warm")])
    finally:
        cal._lm_calibrate = real
    args, kw = captured[0]
    busy, wall, events = busy_share(lambda: real(*args, **kw))
    fmt = {s: f"{cold.seconds[s]:.3f} / {warm.seconds[s]:.3f}"
           for s in warm.seconds}
    log(f"[calibrate] seconds cold / warm: detect {fmt['detect']}, "
        f"interpolate {fmt['interpolate']}, refine {fmt['refine']}, "
        f"calibrate (IPPE init + {CALIB_ITERS} LM iterations) "
        f"{fmt['calibrate']}, previews {fmt['preview']}; the LM alone "
        f"under torch.profiler: {wall:.3f} s, {events / CALIB_ITERS:.1f} "
        f"device events an iteration, device busy {busy} on {smi}")
    cpu = cli.main(argv + ["--platform", "cpu",
                           "--out", str(tmp / "calib_cpu")])
    kc = cpu.result.camera_matrix
    rel = _max_rel(k, kc)
    log(f"[calibrate] the card against the CPU: camera matrix max relative "
        f"difference {rel:.3e} (tol {CALIB_TOL}); CPU stage seconds "
        f"{cpu.seconds}")
    if not rel <= CALIB_TOL:
        raise AssertionError(f"calibrate: card {k.tolist()} vs CPU "
                             f"{kc.tolist()}")

    gboard, corners, mask = grid_views()
    want = cal.calibrate(gboard, corners, mask, CALIB_SIZE,
                         iters=CALIB_ITERS)
    got = cal.calibrate(gboard, corners, mask, CALIB_SIZE,
                        iters=CALIB_ITERS, device=dev)
    torch.cuda.synchronize()
    grel = _max_rel(got.camera_matrix, want.camera_matrix)
    log(f"[calibrate] grid board ({int(mask.sum())} marker views of 12 x "
        f"12): the card against the CPU at f64, camera matrix max relative "
        f"difference {grel:.3e} (tol {CALIB_GRID_TOL}), rms "
        f"{got.rms_px:.4f} px")
    if not grel <= CALIB_GRID_TOL:
        raise AssertionError(f"calibrate grid: card vs CPU {grel}")
    return launches


def _resume_pair(mod, npz: Path, tmp: Path, tag: str, flags):
    """``mod.main`` with --checkpoint-every CKPT_EVERY, then resumed from
    the checkpoint it last wrote: (uninterrupted result, resumed result,
    the resumed run's launches, the frame the checkpoint holds)."""
    import numpy as np
    ck = tmp / f"{tag}_ck.npz"

    def argv(run, *extra):
        return ["--input", str(npz), "--platform", PLATFORM,
                "--trajectory", str(tmp / f"{tag}_{run}.txt"),
                "--map", str(tmp / f"{tag}_{run}_map.txt"), *flags, *extra]

    full = mod.main(argv("full", "--checkpoint-every", str(CKPT_EVERY),
                         "--checkpoint", str(ck)))
    _reset_counts()
    res = mod.main(argv("resumed", "--resume", str(ck)))
    launches = _counts()
    # (state, frames done, trajectory); run_offline's ingest saves no
    # trajectory
    last = 1 if mod.__name__.endswith("run_offline") else 2
    with np.load(ck) as data:
        done = int(data[f"leaf_{int(data['num_leaves']) - last}"])
    if done != CHUNK - CKPT_EVERY:
        raise AssertionError(f"checkpoint {tag}: the last checkpoint holds "
                             f"frame {done}, not {CHUNK - CKPT_EVERY}")
    return full, res, launches, done


def phase_checkpoint(npz: Path, tmp: Path, main_res, smi: str) -> dict:
    """run_slam --checkpoint-every CKPT_EVERY on the main frames, then a
    run that resumes from the checkpoint it last wrote (frame CHUNK -
    CKPT_EVERY, 24 of 32): bit-identical trajectories and maps for mekf,
    mekf_rotations, the factor graph and run_offline's ingest, in the
    default mode a user runs (the graph's sums are in a fixed order), B3
    launched once a resumed frame on the MEKF paths; for the factor graph
    and run_offline also a second uninterrupted run, bit-identical to the
    first. Returns the resumed mekf run's launches."""
    import torch
    from aruco_slam_tpu_torch.apps import run_offline, run_slam
    out = {}
    for tag, mod, flags in (("mekf", run_slam, []),
                            ("mekf_rotations", run_slam,
                             ["--filter", "mekf_rotations"]),
                            ("factorgraph", run_slam,
                             ["--filter", "factorgraph"]),
                            ("offline", run_offline, [])):
        full, res, launches, done = _resume_pair(mod, npz, tmp, tag, flags)
        diff = _max_diff(res.cam_traj, full.cam_traj)
        same_map = Path(res.map_file).read_text() \
            == Path(full.map_file).read_text()
        log(f"[checkpoint] {tag}: resumed at frame {done}; max |resumed - "
            f"uninterrupted| {diff:.3e} m, maps identical {same_map}; "
            f"launches in the resumed run {launches}"
            + (f"; the checkpointing run against the main run "
               f"{_max_diff(full.cam_traj, main_res.cam_traj):.3e} m"
               if tag == "mekf" else ""))
        out[tag] = launches
        if diff != 0 or not same_map:
            raise AssertionError(f"checkpoint {tag}: the resumed run is "
                                 f"not bit-identical ({diff} m)")
        if tag.startswith("mekf"):
            if launches["fused_update"] != CHUNK - done:
                raise AssertionError(
                    f"checkpoint {tag}: {launches['fused_update']} B3 "
                    f"launches for {CHUNK - done} resumed frames")
            continue
        again = _resume_pair(mod, npz, tmp, tag + "_again", flags)[0]
        spread = _max_diff(again.cam_traj, full.cam_traj)
        same_map = Path(again.map_file).read_text() \
            == Path(full.map_file).read_text()
        log(f"[checkpoint] {tag}: two uninterrupted runs differ by "
            f"{spread:.3e} m, maps identical {same_map} (default mode, "
            f"torch.use_deterministic_algorithms "
            f"{torch.are_deterministic_algorithms_enabled()}) on {smi}")
        if spread != 0 or not same_map:
            raise AssertionError(f"checkpoint {tag}: two uninterrupted "
                                 f"runs differ by {spread} m")
    return out["mekf"]


# the port's kernels by the names a device trace shows
TRACE_NAMES = {"flood_scan_labels": ("stencil_rounds",),
               "refine_corners": ("subpix_kernel",),
               "fused_update": ("ns_cluster", "newton_schulz")}


def phase_profile(npz: Path, tmp: Path, main_res) -> None:
    """run_slam --profile DIR on the main frames: DIR/trace.json holds
    device kernel events of B1, B2 and B3, and the trajectory is the
    unprofiled main run's, bit for bit."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_slam
    out = tmp / "profile"
    res = run_slam.main(["--input", str(npz), "--platform", PLATFORM,
                         "--trajectory", str(tmp / "profiled.txt"),
                         "--map", str(tmp / "profiled_map.txt"),
                         "--profile", str(out)])
    trace = out / "trace.json"
    events = json.loads(trace.read_text())["traceEvents"]
    kernels = {}
    for e in events:
        if e.get("cat") == "kernel":
            kernels[e["name"]] = kernels.get(e["name"], 0) + 1
    found = {k: sum(n for name, n in kernels.items()
                    if any(s in name for s in subs))
             for k, subs in TRACE_NAMES.items()}
    same = np.array_equal(res.cam_traj, main_res.cam_traj)
    log(f"[profile] {trace.name}: {trace.stat().st_size / 2**20:.1f} MiB, "
        f"{len(events)} events, {sum(kernels.values())} kernel events of "
        f"{len(kernels)} kernels; the port's kernels' events {found}; "
        f"trajectory bit-identical to the unprofiled run {same}")
    if not all(found.values()) or not same:
        raise AssertionError(f"profile: kernel events {found}, trajectory "
                             f"equal {same}")


def phase_make_synthetic(tmp: Path, smi: str) -> None:
    """make_synthetic's pose-level default (300 frames, 12 markers)
    through run_slam --filter mekf on the card (ATE under ATE_BOUND),
    and its --images --video-rate frames against this script's own
    render of the same orbit, bit for bit."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import make_synthetic, run_slam
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    pose = tmp / "synthetic.npz"
    t0 = time.perf_counter()
    make_synthetic.main(["--out", str(pose), "--frames", "300",
                         "--markers", "12"])
    made = time.perf_counter() - t0
    res = run_slam.main(["--input", str(pose), "--platform", PLATFORM,
                         "--filter", "mekf",
                         "--trajectory", str(tmp / "synthetic.txt"),
                         "--map", str(tmp / "synthetic_map.txt")])
    log(f"[make-synthetic] 300 frames, 12 markers (pose level) made in "
        f"{made:.2f} s; run_slam --filter mekf: ATE {res.ate:.4f} m (bound "
        f"{ATE_BOUND}), stage seconds {res.seconds} on {smi}")
    if not res.ate < ATE_BOUND:
        raise AssertionError(f"make-synthetic: ATE {res.ate} m")
    images = tmp / "synthetic_images.npz"
    make_synthetic.main(["--out", str(images), "--images", "--video-rate",
                         "--frames", "8"])
    with np.load(images) as data:
        got = data["images"]
    cam = cam_mod.CameraModel.from_matrix(
        np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]]),
        np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387]))
    traj = synthetic.Trajectory(*(a[:8] for a in
                                  synthetic.make_orbit_trajectory(80)))
    want = render.render_sequence(synthetic.make_wall_scene(12, seed=0),
                                  traj, cam, image_size=(1920, 1080))
    same = got.shape == want.shape and np.array_equal(got, want)
    log(f"[make-synthetic] --images --video-rate --frames 8: {got.shape} "
        f"bit-identical to this script's render of the orbit {same}")
    if not same:
        raise AssertionError("make-synthetic: images differ from the "
                             "render")


# the viewer phases' flags: the 2D overlay and the 3D map by the numpy
# raster (matplotlib, imageio and cv2 may be absent)
VIZ_FLAGS = ["--viz-2d", "--viz-3d", "--viz-3d-renderer", "fast"]
# the viewer loop's host stages (RunResult.seconds), per frame
HOST_STAGES = ("step", "read", "draw_2d", "raster_3d", "png")
# tests/test_detect.py's presets that need no PIL
DEGRADATIONS = {
    "blur": dict(blur_sigma=1.5),
    "motion": dict(motion_len=7, motion_angle=30.0),
    "noise": dict(noise_sigma=8.0),
    "lighting": dict(vignette_strength=0.55, gradient_strength=0.35),
    "combined": dict(blur_sigma=1.0, noise_sigma=6.0,
                     vignette_strength=0.4),
    "lowlight": dict(low_light_exposure=0.12),
}
# the degraded runs held to ATE_BOUND (motion and lowlight are printed)
DEGRADED_BOUNDED = ("blur", "noise", "lighting", "combined", "clutter")
# the degraded runs' ground truth: markers in front of the camera whose
# corners all lie in the frame or within this many px of its border (the
# detector, the JAX one too, decodes a marker the border clips by a few
# px: the noise preset's frame 12 shows id 0, a corner 2.7 px out)
GT_MARGIN_PX = 16


@contextlib.contextmanager
def _headless():
    """No display server within the block: --display exports headless."""
    import os
    saved = {k: os.environ.pop(k) for k in ("DISPLAY", "WAYLAND_DISPLAY")
             if k in os.environ}
    try:
        yield
    finally:
        os.environ.update(saved)


def _pngs(folder: Path, pattern: str, n: int, shape, tag: str) -> list:
    """The n PNGs of a viewer folder, read by the port's own reader, each
    of the given shape."""
    from aruco_slam_tpu_torch.io import read_png_rgb
    files = sorted(folder.glob(pattern))
    if len(files) != n:
        raise AssertionError(f"{tag}: {len(files)} {pattern} in "
                             f"{folder.name}, expected {n}")
    imgs = [read_png_rgb(f) for f in files]
    bad = [f.name for f, im in zip(files, imgs) if im.shape != shape]
    if bad:
        raise AssertionError(f"{tag}: {bad} not of shape {shape}")
    return imgs


def _viz_argv(npz: Path, tmp: Path, tag: str, *flags) -> list[str]:
    return ["--input", str(npz), "--platform", PLATFORM,
            "--trajectory", str(tmp / f"{tag}.txt"),
            "--map", str(tmp / f"{tag}_map.txt"),
            "--viz-dir", str(tmp / f"{tag}_viz"), *flags]


def _viz_libraries(npz: Path, tmp: Path) -> None:
    """The viewers that need a library: where it is missing, plain
    --viz-3d (the mpl renderer) and --export-video refuse before they
    read or write anything; where it is installed, they run and write
    their files."""
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.viz.video import encoder_available, installed
    log("[viz] installed: " + ", ".join(
        m for m in ("matplotlib", "cv2", "imageio", "av") if installed(m)))
    for tag, flags, ok, want in (
            ("mpl", ["--viz-3d"], installed("matplotlib"),
             "3d/map_00001.png"),
            ("video", ["--viz-2d", "--export-video"], encoder_available(),
             "2d.mp4")):
        out = tmp / f"lib_{tag}"
        try:
            run_slam.main(_viz_argv(npz, out, tag, *flags))
        except ImportError as e:
            if ok:
                raise
            if out.exists():
                raise AssertionError(
                    f"viz: the refused {flags} run wrote "
                    f"{sorted(p.name for p in out.iterdir())}") from e
            log(f"[viz] {' '.join(flags)} refused before writing "
                f"anything: {e}")
            continue
        if not ok:
            raise AssertionError(f"viz: {flags} ran without its library")
        f = out / f"{tag}_viz" / want
        if not f.is_file() or not f.stat().st_size:
            raise AssertionError(f"viz: {flags} wrote no {want}")
        log(f"[viz] {' '.join(flags)} ran with its library: {want} "
            f"{f.stat().st_size} bytes")


def phase_viz(npz: Path, tmp: Path, main_argv, main_res, main_fps: float,
              smi: str) -> dict:
    """run_slam --viz-2d --viz-3d --viz-3d-renderer fast --display on the
    main frames, without a display server: the per-frame MEKF loop (B1
    3, B2 1, B3 once a frame), the trajectory bit-identical to the main
    run's (and its map ids), the headless note, CHUNK overlay and map
    PNGs read
    back (the overlay on the real frame: mean above 60); warm frames/s
    beside the main path's, the host seconds a frame by stage, and the
    device-busy share of a viewer run and of a main-path run under
    torch.profiler. First `_viz_libraries`: the viewers that need a
    library refuse where it is missing and run where it is installed."""
    import io
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    t_phase = time.perf_counter()
    _viz_libraries(npz, tmp)
    argv = _viz_argv(npz, tmp, "viz", *VIZ_FLAGS, "--display")
    out = io.StringIO()
    with _headless(), contextlib.redirect_stdout(out):
        _reset_counts()
        res = run_slam.main(argv)
        launches = _counts()
    note = "--display falls back to headless PNG/mp4 export" \
        in out.getvalue()
    same = np.array_equal(res.cam_traj, main_res.cam_traj) and \
        np.array_equal(res.landmark_ids, main_res.landmark_ids)
    viz = tmp / "viz_viz"
    over = _pngs(viz / "2d", "frame_*.png", CHUNK, (540, 960, 3), "viz")
    maps = _pngs(viz / "3d", "map_*.png", CHUNK, (480, 640, 3), "viz")
    mean2 = float(np.mean([im.mean() for im in over]))
    log(f"[viz] launches in the run: {launches}; trajectory bit-identical "
        f"to the main run's, same map ids {same}; headless note {note}; "
        f"{len(over)} overlays (mean {mean2:.1f}), {len(maps)} map frames "
        f"(mean {np.mean([im.mean() for im in maps]):.1f})")
    if _b123(launches) != [3, 1, CHUNK] or not same or not note \
            or not mean2 > 60:
        raise AssertionError(f"viz: B1/B2/B3 {_b123(launches)} (expected "
                             f"[3, 1, {CHUNK}]), bit-identical {same}, "
                             f"note {note}, overlay mean {mean2}")
    with _headless(), contextlib.redirect_stdout(io.StringIO()):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        warm = run_slam.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
    split = {k: round(1e3 * warm.seconds.get(k, 0.0) / CHUNK, 3)
             for k in HOST_STAGES}
    log(f"[viz] warm run: {CHUNK} frames in {dt:.3f} s = {CHUNK / dt:.2f} "
        f"frames/s end to end with the viewers, against {main_fps:.2f} "
        f"frames/s for the main path, same call (front end "
        f"{warm.seconds['front_end']:.3f} s, filter and viewers "
        f"{warm.seconds['filter']:.3f} s); host ms a frame {split} on {smi}")
    with _headless(), contextlib.redirect_stdout(io.StringIO()):
        shares = {tag: busy_share(lambda a=a: run_slam.main(a))
                  for tag, a in (("viewers", argv), ("main path", main_argv))}
    log("[viz] under torch.profiler: " + "; ".join(
        f"{tag} {100 * sh:.1f}% device-busy ({n} device events, "
        f"{wall:.3f} s)" if sh is not None else f"{tag}: no device time"
        for tag, (sh, wall, n) in shares.items()))
    log(f"[viz] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_viz_graph(npz: Path, tmp: Path) -> dict:
    """run_slam --filter factorgraph --viz-2d on the main frames: the
    trajectory equal to the same run's without the viewer, B1 3, B2 1,
    no B3, one overlay a frame."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_slam
    t_phase = time.perf_counter()
    plain = run_slam.main(_viz_argv(npz, tmp, "viz_graph_plain",
                                    "--filter", "factorgraph"))
    _reset_counts()
    res = run_slam.main(_viz_argv(npz, tmp, "viz_graph", "--filter",
                                  "factorgraph", "--viz-2d"))
    launches = _counts()
    same = np.array_equal(res.cam_traj, plain.cam_traj)
    over = _pngs(tmp / "viz_graph_viz" / "2d", "frame_*.png", CHUNK,
                 (540, 960, 3), "viz-graph")
    log(f"[viz-graph] launches in the run: {launches}; trajectory equal to "
        f"the run without the viewer {same}; {len(over)} overlays; host "
        f"seconds {({k: round(res.seconds[k], 3) for k in HOST_STAGES if k in res.seconds})}")
    if _b123(launches) != [3, 1, 0] or not same:
        raise AssertionError(f"viz-graph: B1/B2/B3 {_b123(launches)}, "
                             f"trajectory equal {same}")
    log(f"[viz-graph] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_viz_offline(npz: Path, tmp: Path) -> dict:
    """run_offline --viz-2d --viz-3d --viz-3d-renderer fast (pass-2
    replay): the trajectory equal to the same run's without viewers, B1
    3, B2 1, no B3, one overlay and one map frame a frame."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_offline
    t_phase = time.perf_counter()
    plain = run_offline.main(_viz_argv(npz, tmp, "viz_offline_plain"))
    _reset_counts()
    t0 = time.perf_counter()
    res = run_offline.main(_viz_argv(npz, tmp, "viz_offline", *VIZ_FLAGS))
    dt = time.perf_counter() - t0
    launches = _counts()
    same = np.array_equal(res.cam_traj, plain.cam_traj)
    viz = tmp / "viz_offline_viz"
    over = _pngs(viz / "2d", "frame_*.png", CHUNK, (540, 960, 3),
                 "viz-offline")
    maps = _pngs(viz / "3d", "map_*.png", CHUNK, (480, 640, 3),
                 "viz-offline")
    log(f"[viz-offline] launches in the run: {launches}; trajectory equal "
        f"to the run without viewers {same}; {len(over)} overlays, "
        f"{len(maps)} map frames; {dt:.3f} s with the replay against "
        f"{sum(plain.seconds.values()):.3f} s of stages without")
    if _b123(launches) != [3, 1, 0] or not same:
        raise AssertionError(f"viz-offline: B1/B2/B3 {_b123(launches)}, "
                             f"trajectory equal {same}")
    log(f"[viz-offline] phase {time.perf_counter() - t_phase:.1f} s")
    return launches


def phase_degraded(frames, traj, cam, scene, k, dist, tmp: Path, main_res,
                   main_fps: float, smi: str) -> dict:
    """The main frames degraded by each preset of DEGRADATIONS (seed =
    frame index), and `combined` on the main scene rendered over
    `degrade.clutter_background` (seed 7), each through run_slam.main:
    B1 3 and B2 1, no marker id outside the ground truth in any frame
    (the markers in front of the camera with every corner within
    GT_MARGIN_PX of the frame; the detections of markers that lie only
    partly in the frame are counted and printed), ATE under ATE_BOUND
    for DEGRADED_BOUNDED (printed for the others); frames/s and
    detections a frame against the clean main run."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import degrade, render, synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    inside = synthetic.observe_corners(scene, traj, cam, 64,
                                       image_size=SIZE)[1]
    # the same projection shifted by the margin, on a canvas grown by it
    m = GT_MARGIN_PX
    k_pad = np.array(k, np.float64)
    k_pad[:2, 2] += m
    present = synthetic.observe_corners(
        scene, traj, cam_mod.CameraModel.from_matrix(
            np.asarray(k_pad, np.float32), np.asarray(dist, np.float32)),
        64, image_size=(SIZE[0] + 2 * m, SIZE[1] + 2 * m))[1]
    clean = float(main_res.obs_mask.sum(1).mean())
    t_phase = t0 = time.perf_counter()
    bg = degrade.clutter_background((SIZE[1], SIZE[0]), seed=7)
    cluttered = render.render_sequence(scene, traj, cam, image_size=SIZE,
                                       background=bg)
    log(f"[degraded] rendered the cluttered sequence in "
        f"{time.perf_counter() - t0:.1f} s")
    runs = [(name, frames, kw) for name, kw in DEGRADATIONS.items()]
    runs.append(("clutter", cluttered, DEGRADATIONS["combined"]))
    real = run_slam.load_observations
    captured = []

    def recording(*a, **kw):
        captured.append(real(*a, **kw))
        return captured[-1]

    out, failed = {}, []
    for name, base, kw in runs:
        t0 = time.perf_counter()
        # a frame a thread (numpy's array work releases the GIL); each
        # frame's own seed, so the frames are those of a serial loop
        with ThreadPoolExecutor(8) as pool:
            imgs = np.stack(list(pool.map(
                lambda f: degrade.degrade(base[f], seed=f, **kw),
                range(len(base)))))
        made = time.perf_counter() - t0
        npz = tmp / f"degraded_{name}.npz"
        np.savez(npz, times=traj.times, images=imgs, gt_cam_t=traj.cam_t,
                 camera_matrix=k, dist_coeffs=dist,
                 marker_size=np.float64(scene.marker_size))
        run_slam.load_observations = recording
        try:
            _reset_counts()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            res = run_slam.main(_viz_argv(npz, tmp, f"degraded_{name}"))
            torch.cuda.synchronize()
            dt = time.perf_counter() - t0
            launches = _counts()
        finally:
            run_slam.load_observations = real
        obs = captured[-1]
        mask, slot_ids = obs[3], obs[6]
        seen = [(t, int(slot_ids[j])) for t in range(len(mask))
                for j in np.where(mask[t])[0]]
        outside = sorted({i for t, i in seen if not present[t, i]})
        clipped = [(t, i) for t, i in seen if present[t, i]
                   and not inside[t, i]]
        err = res.ate
        det = float(res.obs_mask.sum(1).mean())
        bounded = name in DEGRADED_BOUNDED
        log(f"[degraded] {name}: {CHUNK / dt:.2f} frames/s end to end "
            f"(main path, clean, warm: {main_fps:.2f}); detections a frame "
            f"{det:.2f} (clean {clean:.2f}), per frame "
            f"{res.obs_mask.sum(1).tolist()}; ids outside the ground truth "
            f"{outside}; (frame, id) of markers partly out of the frame "
            f"{clipped}; ATE {err:.4f} m"
            + (f" (bound {ATE_BOUND})" if bounded else " (no bound)")
            + f"; launches {launches}; degraded on the host in {made:.1f} s")
        if _b123(launches)[:2] != [3, 1] or outside \
                or (bounded and not err < ATE_BOUND):
            failed.append(name)
        out[name] = launches
    log(f"[degraded] on {smi}; phase {time.perf_counter() - t_phase:.1f} s")
    if failed:
        raise AssertionError(f"degraded: {failed} failed (launches, ids "
                             "outside the ground truth or ATE)")
    return out["clutter"]


# ---------------------------------------------------------------------------
# The bench drivers (aruco_slam_tpu_torch/bench): e2e, detect_profile,
# large_map, headline, each through its own main at its defaults.
# ---------------------------------------------------------------------------

E2E_MODES = (("default", ()),
             ("track-every 8", ("--track-every", "8")),
             ("streams 8", ("--streams", "8")),
             ("streams 8, track-every 8, 4 cohorts",
              ("--streams", "8", "--track-every", "8", "--rescue-cohorts",
               "4")),
             ("degrade combined", ("--degrade", "combined")))
E2E_FRAMES = 128         # bench/e2e.py's default --frames
B3_CAPTURE_FRAMES = 64   # large-map frames filtered before B3's capture
HEADLINE_CAPTURE_FRAMES = 16


@contextlib.contextmanager
def _counting_calls(calls: dict):
    """Within the block, count the detection batches
    (`detect.detect_markers`: B1 3 launches, B2 1 each), the tracked
    batches (`detect.track_markers`: B2 3 each) and the filter steps
    (`mekf.mekf_step`, and ``runner_steps``, the frames `mekf_scan`'s
    CUDA-graph runners step: B3 1 each on the kernel's configurations,
    all streams at once) that the drivers make."""
    from aruco_slam_tpu_torch.filters import mekf
    from aruco_slam_tpu_torch.ops import detect
    real = {(detect, "detect_markers"): detect.detect_markers,
            (detect, "track_markers"): detect.track_markers,
            (mekf, "mekf_step"): mekf.mekf_step}

    def counting(name, fn):
        def wrapped(*args, **kw):
            calls[name] += 1
            return fn(*args, **kw)
        return wrapped

    def runner_steps():
        return mekf.mekf_scan.graph_steps + mekf.mekf_scan.eager_steps

    for (mod, name), fn in real.items():
        calls[name] = 0
        setattr(mod, name, counting(name, fn))
    before = runner_steps()
    try:
        yield
    finally:
        for (mod, name), fn in real.items():
            setattr(mod, name, fn)
        calls["runner_steps"] = runner_steps() - before


def _expected_b123(calls: dict) -> list:
    return [3 * calls["detect_markers"],
            calls["detect_markers"] + 3 * calls["track_markers"],
            calls["mekf_step"] + calls["runner_steps"]]


def _e2e_run_slam(tmp: Path, frames, flags, tag: str):
    """run_slam.main on the e2e bench's frames (one stream: a fleet's
    streams are that sequence XORed in the low bits), with its
    --track-every: the mean accepted detections a frame."""
    import numpy as np
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import e2e, synthetic
    npz = tmp / f"e2e_{tag.replace(' ', '_').replace(',', '')}.npz"
    # uncompressed: zlib over 128 1080p frames costs seconds
    np.savez(npz, times=np.arange(len(frames)) / 30.0, images=frames,
             camera_matrix=np.asarray(e2e.K),
             dist_coeffs=np.asarray(e2e.DIST),
             marker_size=np.float64(synthetic.make_wall_scene(
                 num_markers=10, seed=0).marker_size))
    extra = []
    if "--track-every" in flags:
        extra = ["--track-every", flags[flags.index("--track-every") + 1]]
    res = run_slam.main(["--input", str(npz), "--platform", PLATFORM,
                         "--trajectory", str(tmp / "e2e_t.txt"),
                         "--map", str(tmp / "e2e_m.txt"), *extra])
    npz.unlink()
    return float(res.obs_mask.sum(1).mean())


def _e2e_argv(flags) -> list:
    return ["--frames", str(E2E_FRAMES), *flags, "--platform", PLATFORM]


def phase_bench_e2e(tmp: Path, smi: str):
    """bench/e2e.py in each of E2E_MODES at its defaults (128 rendered
    1080p frames, chunk 16): the row; B1, B2 and B3 launched exactly as
    the run's detection batches, tracked batches and filter steps call
    for; detections a frame beside run_slam's on the same frames (equal
    on the default mode). Returns ({path: launches}, {mode: row})."""
    import numpy as np
    from aruco_slam_tpu_torch.bench import e2e
    e2e.CACHE_DIR = tmp
    paths, rows = {}, {}
    for tag, flags in E2E_MODES:
        t0 = time.perf_counter()
        calls = {}
        _reset_counts()
        with _counting_calls(calls):
            row = e2e.main(_e2e_argv(flags))
        launches = _counts()
        want = _expected_b123(calls)
        kind = "vr" if "--track-every" in flags else "orbit"
        frames = np.load(tmp / f"aruco_slam_tpu_torch_e2e_{kind}_"
                         f"{E2E_FRAMES}_10.npz")["frames"]
        if "--degrade" in flags:
            frames = e2e.degraded(frames, flags[flags.index("--degrade") + 1])
        ref = _e2e_run_slam(tmp, frames, flags, tag)
        log(f"[bench-e2e] {tag}: {json.dumps(row)}")
        log(f"[bench-e2e] {tag}: launches {_b123(launches)} (B1/B2/B3), "
            f"expected {want} from {calls}; detections a frame "
            f"{row['mean_detections_per_frame']} against run_slam's "
            f"{ref:.2f} on the same frames; {time.perf_counter() - t0:.1f} "
            f"s on {smi}")
        if _b123(launches) != want or min(want) <= 0:
            raise AssertionError(f"bench-e2e {tag}: launches "
                                 f"{_b123(launches)}, expected {want}")
        if not row["value"] > 0 or not row["mean_detections_per_frame"] >= 3:
            raise AssertionError(f"bench-e2e {tag}: row {row}")
        if tag == "default" and abs(row["mean_detections_per_frame"]
                                    - ref) > 0.01:
            raise AssertionError(f"bench-e2e default: "
                                 f"{row['mean_detections_per_frame']} "
                                 f"detections a frame, run_slam {ref}")
        paths[f"bench-e2e {tag}"] = launches
        rows[tag] = row
    return paths, rows


def phase_detect_profile(smi: str) -> dict:
    """bench/detect_profile.py at its defaults (16 frames, 4 reps): the
    stages are the detector's, adding up to its total; B1 and B2
    launched."""
    from aruco_slam_tpu_torch.bench import detect_profile
    from aruco_slam_tpu_torch.ops import detect
    t0 = time.perf_counter()
    calls = {}
    _reset_counts()
    with _counting_calls(calls):
        row = detect_profile.main(["--platform", PLATFORM])
    launches = _counts()
    stages = list(detect.candidate_stage_names()) + ["slots+rest"]
    total = sum(row[k] for k in stages)
    log(f"[detect-profile] {json.dumps(row)}")
    log(f"[detect-profile] stages add up to {total:.3f} of "
        f"{row['total_ms']:.3f} ms a frame; launches {_b123(launches)}; "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    if list(row)[4:] != stages or abs(total - row["total_ms"]) > 0.02 \
            or _b123(launches)[0] < 3 * calls["detect_markers"] \
            or not launches["refine_corners"]:
        raise AssertionError(f"detect-profile: {row}, {launches}")
    return launches


def phase_large_map(smi: str):
    """bench/large_map.py at its defaults (512 markers, 512 raster
    frames, batch 8, max-obs 48, the XLA-form update: no B3), then with
    --cov-dtype bf16: the rows, the default run's ATE under ATE_BOUND,
    peak device memory. Returns ({path: launches}, [(argv, row)])."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.bench import large_map
    paths, rows = {}, []
    for flags in ((), ("--cov-dtype", "bf16")):
        t0 = time.perf_counter()
        tag = "large-map" + "".join(f" {f}" for f in flags)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        _reset_counts()
        argv = ["--markers", str(LARGE_MARKERS), "--frames",
                str(LARGE_FRAMES), *flags, "--platform", PLATFORM]
        row = large_map.main(argv)
        launches = _counts()
        peak = torch.cuda.max_memory_allocated()
        log(f"[large-map] {json.dumps(row)}")
        log(f"[large-map] {tag}: launches {_b123(launches)}; peak device "
            f"memory {peak / 2**30:.2f} GiB; "
            f"{time.perf_counter() - t0:.1f} s on {smi}")
        if _b123(launches)[2] or not np.isfinite(row["ate_m"]) \
                or (not flags and not row["ate_m"] < ATE_BOUND):
            raise AssertionError(f"{tag}: {row}, {launches}")
        paths[tag] = launches
        rows.append((argv, row))
    return paths, rows


def phase_headline(smi: str, e2e_rows: dict, lm_rows: list) -> dict:
    """bench/headline.py: the single-stream pipeline (B3 once a frame)
    and the 256-sequence batched one (the XLA-form update), with its
    ride-along fields. Its e2e and large-map runs at the arguments that
    [bench-e2e] and [large-map] ran in this call come from those runs'
    rows (the same main, the same parsed arguments); the rest run here.
    Returns the launches."""
    from aruco_slam_tpu_torch.bench import e2e, headline, large_map
    t0 = time.perf_counter()
    ran = {_args_key(e2e, _e2e_argv(flags)): e2e_rows[tag]
           for tag, flags in E2E_MODES}
    ran.update({_args_key(large_map, argv): row for argv, row in lm_rows})
    real = {mod: mod.main for mod in (e2e, large_map)}

    def reusing(mod):
        def main(argv=None):
            key = _args_key(mod, argv)
            return ran[key] if key in ran else real[mod](argv)
        return main

    calls = {}
    _reset_counts()
    for mod in real:
        mod.main = reusing(mod)
    try:
        with _counting_calls(calls):
            row = headline.main(["--platform", PLATFORM])
    finally:
        for mod, fn in real.items():
            mod.main = fn
    launches = _counts()
    log(f"[headline] {json.dumps(row)}")
    log(f"[headline] launches {_b123(launches)} (B3: the single stream's "
        f"{headline.FRAMES} a call and the e2e ride-alongs'); "
        f"{time.perf_counter() - t0:.1f} s on {smi}")
    if not row["value"] > 0 or not row["single_stream_fps"] > 0 \
            or not launches["fused_update"] \
            or not row["large_map_ate_m"] < ATE_BOUND:
        raise AssertionError(f"headline: {row}, {launches}")
    return launches


def _args_key(mod, argv) -> tuple:
    """A bench main's parsed arguments, as a dict key."""
    return tuple(sorted(vars(mod._parser().parse_args(argv)).items()))


def _capture_bench_updates(dev):
    """B3's inputs at the bench shapes: the large map's filter (N 1545,
    M 144) after B3_CAPTURE_FRAMES of its survey, and the headline's 256
    sequences (N 198, M 48) after HEADLINE_CAPTURE_FRAMES frames, each
    run with the kernel; with each, the XLA-form configuration its
    driver runs (update_kernel=False, s_solver="ns", "mixed")."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.bench import e2e, headline, large_map
    from aruco_slam_tpu_torch.bench.pipeline import make_pipeline
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.filters import MekfConfig, cuda_mekf, init_state
    from aruco_slam_tpu_torch.parallel.multi_slam import stack_states
    last = []
    real = cuda_mekf.fused_update

    def record(*args, **kw):
        last[:] = [[a.clone() for a in args]]
        return real(*args, **kw)
    # the wrapper counts its launches on the name it is called by; these
    # capture runs are not a path's, so their count is dropped
    record.launches = 0

    cam, cam_cpu = e2e.camera(dev), e2e.camera()
    scene, _, corners, mask = large_map.survey(LARGE_MARKERS, LARGE_FRAMES,
                                               cam_cpu)
    xla_big = large_map.filter_config(LARGE_MARKERS, 48, "mixed", "f32")
    hscene = synthetic.make_wall_scene(num_markers=headline.MARKERS, seed=0)
    hc, hm = synthetic.observe_corners(
        hscene, synthetic.make_orbit_trajectory(num_frames=headline.FRAMES),
        cam_cpu, headline.CAPACITY, noise_px=0.3, seed=1)
    rng = np.random.default_rng(7)
    n = HEADLINE_CAPTURE_FRAMES
    hb = hc[None, :n] + rng.normal(0, 0.3, (headline.BATCH, n)
                                   + hc.shape[1:])
    xla_head = MekfConfig(capacity=headline.CAPACITY)._replace(
        update_kernel=False, s_solver="ns", matmul_precision="mixed")
    out = []
    cuda_mekf.fused_update = record
    try:
        for cfg, sc, cs, ms, streams in (
                (xla_big, scene, corners[:B3_CAPTURE_FRAMES],
                 mask[:B3_CAPTURE_FRAMES], 0),
                (xla_head, hscene, hb, np.broadcast_to(
                    hm[:n], (headline.BATCH, n, hm.shape[1])),
                 headline.BATCH)):
            kcfg = cfg._replace(update_kernel=True)
            state = init_state(kcfg, device=dev)
            if streams:
                state = stack_states([state] * streams)
            make_pipeline(cam, sc.marker_size, kcfg)(
                state, torch.tensor(cs, dtype=torch.float32, device=dev),
                torch.tensor(np.ascontiguousarray(ms), device=dev))
            out.append((cfg, last[0]))
    finally:
        cuda_mekf.fused_update = real
    return out


def _b3_bench_shapes(dev, smi: str) -> list:
    """B3 at the bench shapes no earlier chip run measured, each held
    against its plain version (B3_TOL, P' exactly symmetric) and timed
    beside the plain chain and the XLA-form update its driver runs."""
    import numpy as np
    import torch
    from aruco_slam_tpu_torch.filters import cuda_mekf
    from aruco_slam_tpu_torch.filters import mekf
    shapes = []
    for cfg, args in _capture_bench_updates(dev):
        got = cuda_mekf.fused_update(*args)
        want = cuda_mekf.fused_update_plain(*args)
        torch.cuda.synchronize()
        err = _b3_err(got, want)
        sym = bool(torch.equal(got[1], got[1].transpose(-1, -2)))
        t = timings(lambda: cuda_mekf.fused_update(*args),
                    lambda: cuda_mekf.fused_update_plain(*args))

        def xla(args=args, cfg=cfg):
            return mekf._update_xla_form(cfg, *args)
        x_err = _b3_err(xla(), want)
        x_ms, x_dev = call_ms(xla), device_ms(xla)
        batched = args[0].dim() == 3
        s = args[0].shape[0] if batched else 1
        n, m = args[0].shape[-1], args[1].shape[-2]
        shape = (f"S={s} N={n} M={m}" if batched else f"N={n} M={m}")
        b_ms, b_by = _b3_bound(s, n, m)
        form = cuda_mekf.newton_schulz_form(m) if dev.type == "cuda" \
            else None
        faster = "kernel" if t["device_ms"] < x_dev else "XLA-form chain"
        log(f"[B3] fused_update {shape} (bench): max |kernel - plain| "
            f"{err:.3e} (tol {B3_TOL}); symmetric {sym}; {_fmt_t(t)}; the "
            f"XLA-form update its driver runs (s_solver ns, "
            f"{cfg.matmul_precision}) {x_ms:.3f} ms a call ({x_dev:.3f} "
            f"device), {x_err:.3e} from the plain chain; {faster} faster "
            f"on device; {form} form; bound {b_ms:.4f} ms ({b_by}) on {smi}")
        if not np.isfinite(err) or err > B3_TOL or not sym:
            raise AssertionError(f"B3 differs from its plain version at "
                                 f"{shape}: {err}, symmetric {sym}")
        shapes.append({"shape": shape, "path": "bench", "form": form, **t,
                       "xla_form_ms": x_ms, "xla_form_device_ms": x_dev,
                       "xla_form_precision": cfg.matmul_precision,
                       "bound_ms": b_ms, "bound_by": b_by,
                       "max_abs_err": err})
    return shapes


def main() -> int:
    import torch
    name, smi = phase_device()
    sys.path.insert(0, str(ROOT))
    import numpy as np
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.io import save_npz

    phase_build()
    dev = torch.device(PLATFORM)
    rng = np.random.default_rng(SEED)
    app = SlamAppConfig(input="")
    # the run_slam camera at 1920x1080 (scaled with a smaller SIZE)
    k = np.asarray(app.camera_matrix) * (SIZE[0] / 1920.0)
    k[2, 2] = 1.0
    cam = cam_mod.CameraModel.from_matrix(
        np.asarray(k, np.float32), np.asarray(app.dist_coeffs, np.float32))
    scene = synthetic.make_wall_scene(num_markers=10, seed=SEED)
    # the first chunk of the default 300-frame (10 s, 30 fps) orbit:
    # hand-held video-rate motion (a whole orbit squeezed into 32 frames
    # moves ~0.16 m per frame and the filter lags it by decimeters)
    traj = synthetic.Trajectory(*(
        a[:CHUNK] for a in synthetic.make_orbit_trajectory()))
    t0 = time.perf_counter()
    frames = render.render_sequence(scene, traj, cam, image_size=SIZE)
    corners, mask = synthetic.observe_corners(scene, traj, cam, 64,
                                              image_size=SIZE)
    log(f"[data] rendered {frames.shape} in "
        f"{time.perf_counter() - t0:.1f} s; visible markers per frame "
        f"{mask.sum(1).tolist()}")
    t0 = time.perf_counter()
    board, cviews, chess = calibration_views()
    log(f"[data] rendered the calibration views {cviews.shape} in "
        f"{time.perf_counter() - t0:.1f} s")

    kernels = [_b1(rng, dev), _b2(frames, corners, mask, rng, dev)]
    captured = _capture_update_inputs(corners, mask, cam,
                                      scene.marker_size)
    captured_rot = _capture_update_inputs(corners, mask, cam,
                                          scene.marker_size, rotations=True)
    captured_rot32 = _capture_update_inputs(corners, mask, cam,
                                            scene.marker_size, rotations=True,
                                            max_obs=32)
    kernels += [_b3(captured, captured_rot, captured_rot32, dev),
                _b4(rng, dev),
                _b5(frames, corners, mask, rng, dev),
                _pnp(corners, mask, cam, scene.marker_size, rng, dev)]
    b3_bench = _b3_bench_shapes(dev, smi)
    _elapsed("the kernels' checks")
    kernels[2]["shapes"] += b3_bench
    kernels[2]["max_abs_err"] = max(kernels[2]["max_abs_err"],
                                    *(c["max_abs_err"] for c in b3_bench))
    # B5's user path is the calibration CLI: its line carries the CLI's
    # batched call (all views' chessboard corners)
    b5_cal = _b5_calibration(cviews, chess, np.random.default_rng(SEED + 1),
                             dev)
    kernels[4].update({k: b5_cal[-1][k] for k in (
        "ms", "device_ms", "plain_ms", "plain_device_ms", "bound_ms",
        "bound_by")})
    kernels[4]["max_abs_err"] = max(kernels[4]["max_abs_err"],
                                    *(c["max_abs_err"] for c in b5_cal))
    kernels[4]["shapes"] = [c["shape"] for c in b5_cal]
    phase_undistort(
        [cviews[0], frames[0]],
        [cam_mod.CameraModel.from_matrix(np.asarray(CALIB_K, np.float32),
                                         np.asarray(CALIB_DIST, np.float32)),
         cam], dev, smi)
    # the fleet's second scene: another wall (seed 1), the same orbit
    t0 = time.perf_counter()
    frames2 = render.render_sequence(
        synthetic.make_wall_scene(num_markers=10, seed=SEED + 1), traj, cam,
        image_size=SIZE)
    log(f"[data] rendered the fleet's second scene {frames2.shape} in "
        f"{time.perf_counter() - t0:.1f} s")

    with tempfile.TemporaryDirectory() as tmp:
        npz = Path(tmp) / "seq.npz"
        save_npz(npz, times=traj.times, images=frames,
                 gt_cam_t=traj.cam_t, gt_cam_q=traj.cam_q,
                 camera_matrix=k,
                 dist_coeffs=np.asarray(app.dist_coeffs),
                 marker_size=np.float64(scene.marker_size))
        argv = ["--input", str(npz), "--platform", PLATFORM,
                "--trajectory", str(Path(tmp) / "trajectory.txt"),
                "--map", str(Path(tmp) / "map.txt")]
        main_launches, main_res, main_fps = phase_main(argv, traj.cam_t,
                                                       smi)
        # every path runs one chunk: CHUNK frames (the fleets: CHUNK
        # frames of each stream; recycling: its 12 frames)
        paths = {"main": main_launches,
                 "stencil-only": phase_stencil_only(frames, dev),
                 "refine_corners": phase_refine_corners(frames, corners,
                                                        mask, rng, dev),
                 "streaming": phase_streaming(argv, traj.cam_t, main_res,
                                              main_fps, smi),
                 "rotations": phase_rotations(argv, traj.cam_t, main_fps,
                                              smi),
                 "recycling": phase_recycling(Path(tmp), dev)}
        phase_prefetch(npz, main_res, dev)
        _elapsed("the single-stream paths")
        dist = np.asarray(app.dist_coeffs)
        seqs = [(f, traj.times, gt, k, dist)
                for f, gt in ((frames, traj.cam_t),
                              (frames[::-1], traj.cam_t[::-1]),
                              (frames2, traj.cam_t),
                              (frames2[::-1], traj.cam_t[::-1]))]
        fleet_paths = _fleet_inputs(Path(tmp), seqs)
        paths["fleet"], full_warm, fleet_runs = phase_fleet(
            Path(tmp), fleet_paths, CHUNK, main_fps, smi)
        paths.update(phase_fleet_streaming(Path(tmp), fleet_paths, seqs,
                                           full_warm, smi))
        _elapsed("the fleets")
        paths["fleet-sharded"] = phase_fleet_sharded(
            Path(tmp), fleet_paths, CHUNK, fleet_runs, full_warm, smi)
        _elapsed("the sharded fleet")
        paths["factorgraph"] = phase_factorgraph(argv, traj.cam_t, main_fps,
                                                 smi)
        phase_factorgraph_online(dev, smi)
        _elapsed("the online graph")
        paths["offline"], _, ingested = phase_offline(npz, Path(tmp), smi)
        _elapsed("the factor graph and offline")
        fleet_ba = phase_fleet_ba(Path(tmp), fleet_paths, smi)
        paths["fleet-ba 1x1"] = fleet_ba["fleet-ba 1x1"]
        paths["fleet-ba 2x2"] = fleet_ba["fleet-ba 2x2"]
        _reset_counts()
        sharded = phase_sharded_ba(ingested, smi)
        _elapsed("the fleet and sharded solves")
        paths["sharded-ba"] = _counts()
        ranks = phase_dist(npz, Path(tmp), ingested,
                           sharded["f64_unsharded"], smi)
        paths.update({k: v for k, v in ranks.items()
                      if k.startswith("dist rank")})
        _elapsed("distribution")
        paths["entry"] = phase_entry(dev)
        _elapsed("the entry step")
        paths["dryrun"] = phase_dryrun(smi)
        _elapsed("the dry runs")
        scaling = phase_scaling(Path(tmp), smi)
        paths["ingest"] = scaling["per_chunk"]
        _elapsed("bench/scaling.py")
        paths["calibrate"] = phase_calibrate(Path(tmp), board, cviews, dev,
                                             smi)
        paths["checkpoint-resume"] = phase_checkpoint(npz, Path(tmp),
                                                      main_res, smi)
        _elapsed("calibration and checkpoints")
        phase_profile(npz, Path(tmp), main_res)
        phase_make_synthetic(Path(tmp), smi)
        paths["viz"] = phase_viz(npz, Path(tmp), argv, main_res, main_fps,
                                 smi)
        paths["viz-graph"] = phase_viz_graph(npz, Path(tmp))
        paths["viz-offline"] = phase_viz_offline(npz, Path(tmp))
        paths["degraded"] = phase_degraded(
            frames, traj, cam, scene, k, np.asarray(app.dist_coeffs),
            Path(tmp), main_res, main_fps, smi)
        _elapsed("the viewers and degraded frames")
        # the bench drivers: launches over each whole bench run
        bench, e2e_rows = phase_bench_e2e(Path(tmp), smi)
        bench["detect-profile"] = phase_detect_profile(smi)
        lm_paths, lm_rows = phase_large_map(smi)
        bench.update(lm_paths)
        bench["headline"] = phase_headline(smi, e2e_rows, lm_rows)
        bench.update(scaling["bench"])
        _elapsed("the bench drivers")
    # launches: the main path's, or for B4 and B5 (which the main path
    # does not run) their own path's: B5's is the calibration CLI
    own = {"flood_labels": "stencil-only", "refine_offsets": "calibrate"}
    for k in kernels:
        k["launches"] = paths[own.get(k["name"], "main")][k["name"]]
        k["launches_per_chunk"] = {p: c[k["name"]] for p, c in paths.items()}
        k["launches_bench"] = {p: c[k["name"]] for p, c in bench.items()}
    print(json.dumps({"kernels": kernels}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": name,
        "count": torch.cuda.device_count()}}), flush=True)
    return 0


if __name__ == "__main__":
    # the rank processes of the [dist] phase
    if sys.argv[1:2] == ["--rank-child"]:
        sys.exit(rank_child(sys.argv[2], sys.argv[3:]))
    if sys.argv[1:2] == ["--rank-solve"]:
        sys.exit(rank_solve(sys.argv[2], sys.argv[3]))
    # the worker processes of the [scaling] phase
    if sys.argv[1:2] == ["--scaling-child"]:
        sys.exit(scaling_child(sys.argv[2], sys.argv[3:]))
    sys.exit(main())
