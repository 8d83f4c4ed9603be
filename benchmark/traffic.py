"""The one traffic generator: a cell's pool of recorded clips, from --seed.

A traffic file (``traffic/<mix>.json``) holds parameters only:

- ``kind``: ``images`` (rendered grayscale frames) or ``corners``
  (corner-level observations with seeded pixel noise);
- ``frames``: frames of a clip, per stream;
- ``orbit_frames``: length of the orbit the clips are cut from (10x the
  clip for video-rate motion);
- ``pool_offsets``: the first orbit frame of each clip of the pool (one
  request per offset, cycling);
- ``grid``: (rows, columns) of markers on each stream's wall, each
  moved from its grid point by up to ``jitter`` metres (a quarter of a
  cell by default), at 3 +- 0.3 m, tilted as `make_wall_scene`'s;
  ``wall_extent``: the wall's half width in metres (its half height is
  0.6 of it). A grid keeps the number of markers in view about the same
  on every seed, so the seed changes where they are, not the work, and
  keeps 4 or more in view on every frame, so that the pose, and with it
  the comparison with the plain reference, is well-posed: with 1 to 3 in
  view, f32 rounding alone moves the pose by centimetres. Sparse views
  and camera noise, which real recordings have, are left to later mixes;
- ``noise_px``: corner noise (``corners`` only);
- ``run_slam``: the traffic's own run_slam flags (the tracker's);
- ``trace_requests``: requests under the profiler in a ``--trace 1``
  run; ``check_entries``: pool entries the correctness check samples.

Each stream of the configuration gets its own wall (a scene seed) and
direction along the orbit, drawn from (--seed, stream). The same seed
gives the same files, bit for bit. A pool is written once per seed and
what the generator reads of the configuration and traffic, under
``benchmark/.cache/pools/``, and read from there after; frames are
rendered on a pool of host processes.
"""

from __future__ import annotations

import hashlib
import json
import multiprocessing
import os
import shutil
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
CACHE = HERE / ".cache" / "pools"
RENDER_BATCH = 8  # frames a render task


def stream_draw(seed: int, stream: int) -> tuple[int, bool]:
    """(scene seed, reversed) of one stream, from (--seed, stream)."""
    rng = np.random.default_rng(np.random.SeedSequence([int(seed), stream]))
    return int(rng.integers(0, 2**31 - 1)), bool(rng.integers(0, 2))


def _camera(cfg: dict):
    from benchmark.reference import camera as cam_mod
    return cam_mod.CameraModel.from_matrix(
        np.asarray(cfg["camera_matrix"], np.float64),
        np.asarray(cfg["dist_coeffs"], np.float64))


def grid_wall_scene(rows: int, cols: int, extent: float, seed: int,
                    marker_size: float, jitter: float | None = None):
    """Markers on a rows x cols grid over a wall at z~3 m facing -z,
    each jittered from ``seed``; orientation as `make_wall_scene`."""
    from benchmark.traffic_gen import synthetic as syn
    rng = np.random.default_rng(seed)
    ey = 0.6 * extent
    xs = (np.arange(cols) + 0.5) / cols * 2 * extent - extent
    ys = (np.arange(rows) + 0.5) / rows * 2 * ey - ey
    gx, gy = np.meshgrid(xs, ys)
    n = rows * cols
    if jitter is None:
        jitter = 0.25 * min(2 * extent / cols, 2 * ey / rows)
    pos = np.stack([gx.ravel() + rng.uniform(-jitter, jitter, n),
                    gy.ravel() + rng.uniform(-jitter, jitter, n),
                    3.0 + rng.uniform(-0.3, 0.3, n)], -1)
    base = syn._quat_from_rotvec(np.array([[np.pi, 0.0, 0.0]]))
    tilt = syn._quat_from_rotvec(rng.normal(scale=0.12, size=(n, 3)))
    return syn.Scene(pos, syn._quat_mul(tilt, np.broadcast_to(base, (n, 4))),
                     marker_size)


def _trajectory(traffic: dict, reverse: bool, offset: int):
    from benchmark.traffic_gen import synthetic
    orbit = synthetic.make_orbit_trajectory(
        num_frames=traffic["orbit_frames"])
    cam_t, cam_q = orbit.cam_t, orbit.cam_q
    if reverse:
        cam_t, cam_q = cam_t[::-1], cam_q[::-1]
    sl = slice(offset, offset + traffic["frames"])
    return synthetic.Trajectory(np.ascontiguousarray(cam_t[sl]),
                                np.ascontiguousarray(cam_q[sl]),
                                orbit.times[sl])


# --- render workers (spawned processes: state set by _init) -------------
_WORKER = {}


def _init(cfg: dict) -> None:
    import torch
    torch.set_num_threads(1)
    from benchmark.reference import dictionary
    from benchmark.traffic_gen import render
    cam = _camera(cfg)
    w, h = cfg["image_size"]
    _WORKER.update(cam=cam, norm=render._undistort_map(cam, w, h),
                   dict=dictionary.load(cfg["dict"]))


def _render(task):
    from benchmark.traffic_gen import render
    scene_args, cam_q, cam_t = task
    scene = grid_wall_scene(**scene_args)
    return np.stack([render.render_frame(scene, q, t, _WORKER["cam"],
                                         _WORKER["norm"], _WORKER["dict"])
                     for q, t in zip(cam_q, cam_t)])


def _render_all(cfg: dict, jobs: list, processes: int) -> list:
    """Frames (T, H, W) uint8 of each (scene args, trajectory) job."""
    tasks, spans = [], []
    for scene_args, traj in jobs:
        start = len(tasks)
        for i in range(0, len(traj.times), RENDER_BATCH):
            tasks.append((scene_args, traj.cam_q[i:i + RENDER_BATCH],
                          traj.cam_t[i:i + RENDER_BATCH]))
        spans.append((start, len(tasks)))
    ctx = multiprocessing.get_context("spawn")
    with ctx.Pool(processes, initializer=_init, initargs=(cfg,)) as pool:
        parts = pool.map(_render, tasks, chunksize=1)
    return [np.concatenate(parts[a:b]) for a, b in spans]


# what the generator reads: cells whose clips agree share a pool
CLIP_KEYS = ("kind", "frames", "orbit_frames", "pool_offsets", "grid",
             "wall_extent", "noise_px")
CAMERA_KEYS = ("streams", "image_size", "camera_matrix", "dist_coeffs",
               "marker_size", "dict", "capacity")


def _key(cfg: dict, traffic: dict, seed: int) -> str:
    blob = json.dumps([{k: cfg.get(k) for k in CAMERA_KEYS},
                       {k: traffic.get(k) for k in CLIP_KEYS}, int(seed)],
                      sort_keys=True)
    return hashlib.sha256(blob.encode()).hexdigest()[:16]


def build_pool(cfg: dict, traffic: dict, seed: int,
               cache: Path = CACHE, processes: int | None = None
               ) -> list[list[Path]]:
    """The cell's pool: per pool entry, one npz clip a stream (the port's
    npz format, ``np.savez_compressed``). Read from the cache when it is
    there."""
    out = cache / f"{int(seed)}-{_key(cfg, traffic, seed)}"
    streams = int(cfg["streams"])
    offsets = traffic["pool_offsets"]
    paths = [[out / f"p{p}_s{s}.npz" for s in range(streams)]
             for p in range(len(offsets))]
    if (out / "complete").is_file():
        return paths
    shutil.rmtree(out, ignore_errors=True)
    tmp = out.with_name(out.name + ".partial")
    shutil.rmtree(tmp, ignore_errors=True)
    tmp.mkdir(parents=True)
    clips = {}
    for s in range(streams):
        scene_seed, reverse = stream_draw(seed, s)
        rows, cols = traffic["grid"]
        scene_args = dict(rows=rows, cols=cols, seed=scene_seed,
                          marker_size=cfg["marker_size"],
                          extent=traffic["wall_extent"])
        for p, off in enumerate(offsets):
            clips[p, s] = (scene_args, _trajectory(traffic, reverse, off))
    common = dict(camera_matrix=np.asarray(cfg["camera_matrix"], np.float64),
                  dist_coeffs=np.asarray(cfg["dist_coeffs"], np.float64),
                  marker_size=np.float64(cfg["marker_size"]))
    keys = sorted(clips)
    if traffic["kind"] == "images":
        frames = _render_all(cfg, [clips[k] for k in keys],
                             processes or min(8, os.cpu_count() or 1))
        payload = {k: dict(images=f) for k, f in zip(keys, frames)}
    elif traffic["kind"] == "corners":
        from benchmark.traffic_gen import synthetic
        cam = _camera(cfg)
        payload = {}
        for p, s in keys:
            scene_args, traj = clips[p, s]
            scene = grid_wall_scene(**scene_args)
            noise_seed = int(np.random.default_rng(np.random.SeedSequence(
                [int(seed), s, p, 3])).integers(0, 2**31 - 1))
            corners, cmask = synthetic.observe_corners(
                scene, traj, cam, cfg["capacity"],
                noise_px=traffic["noise_px"], seed=noise_seed,
                image_size=tuple(cfg["image_size"]))
            payload[p, s] = dict(corners=corners, corner_mask=cmask)
    else:
        raise ValueError(f"unknown traffic kind {traffic['kind']!r}")
    for (p, s), arrays in payload.items():
        traj = clips[p, s][1]
        save_npz(tmp / f"p{p}_s{s}.npz", times=traj.times,
                 gt_cam_t=traj.cam_t, **arrays, **common)
    (tmp / "complete").write_text("")
    os.replace(tmp, out)
    return paths


def save_npz(path, **arrays) -> None:
    """The port's npz writer (``io.save_npz``), frozen."""
    Path(path).parent.mkdir(parents=True, exist_ok=True)
    np.savez_compressed(path, **arrays)
