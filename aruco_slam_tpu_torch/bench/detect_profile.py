"""Stage-level profile of the robust detector on the card.

Counterpart of aruco_slam_tpu/bench/detect_profile.py, flag for flag:
times the full detector over a batch of rendered 1080p frames, then each
prefix of `ops/detect._detect_candidates` up to a stage of
`candidate_stage_names()` (``stop=``), each timed alone, so a stage's
cost is the difference between successive prefixes and ``slots+rest``
is what the full detector spends after the last one.

    python -m aruco_slam_tpu_torch.bench.detect_profile [--frames 16]
    python -m aruco_slam_tpu_torch.bench.detect_profile --platform cpu \\
        --frames 2 --reps 1

Prints one ms/frame line per stage and one JSON row, and returns the
row. Each timed call's frames are XORed with (rep % 2), as in the JAX
bench (wrap-safe: detection is unaffected).
"""

from __future__ import annotations

import argparse
import json

import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.bench import e2e, synthetic
from aruco_slam_tpu_torch.bench.pipeline import device_name, seconds_per_call
from aruco_slam_tpu_torch.ops import detect


def main(argv=None) -> dict:
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--frames", type=int, default=16)
    p.add_argument("--markers", type=int, default=10)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    p.add_argument("--detector", default="robust",
                   choices=["robust", "fast"])
    p.add_argument("--reps", type=int, default=4)
    p.add_argument("--stages", default=None,
                   help="comma-separated subset of stage stops to "
                        "profile (default: all); 'none' = full "
                        "detector only")
    args = p.parse_args(argv)
    device = resolve_device(args.platform)
    scene = synthetic.make_wall_scene(num_markers=args.markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=args.frames)
    frames = e2e.rendered_frames(
        f"aruco_slam_tpu_torch_detect_profile_{args.frames}_"
        f"{args.markers}.npz", scene, traj)
    images = torch.from_numpy(frames).to(device)
    t = args.frames
    cfg = detect.with_preset(detect.DetectorConfig(), args.detector)

    def timeit(name, fn):
        secs = seconds_per_call(lambda i: fn(images ^ (i % 2)), args.reps,
                                device, warm=lambda: fn(images ^ 2))
        ms = 1e3 * secs / t
        print(f"# {name:<28s} {ms:8.3f} ms/frame", flush=True)
        return ms

    full_ms = timeit("detect_markers (full)",
                     lambda im: detect.detect_markers_batch(im, cfg)[:2])
    stages = detect.candidate_stage_names()
    if args.stages == "none":
        stages = ()
    elif args.stages:
        want = set(args.stages.split(","))
        stages = tuple(s_ for s_ in stages if s_ in want)
    prev = 0.0
    rows = {}
    for s in stages:
        ms = timeit(f"prefix:{s}", lambda im, s=s: detect._detect_candidates(
            im, cfg, stop=s))
        rows[s] = ms - prev
        prev = ms
    rows["slots+rest"] = full_ms - prev
    row = {"metric": "detect_stage_ms_per_frame",
           "detector": args.detector,
           "device": device_name(device),
           "total_ms": round(full_ms, 3),
           **{k: round(v, 3) for k, v in rows.items()}}
    print(json.dumps(row), flush=True)
    return row


if __name__ == "__main__":
    main()
