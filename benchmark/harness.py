"""One run of one cell: set-up, the measured window, the trace, the check.

Each request is one call of the port's command line,
``aruco_slam_tpu_torch.apps.run_slam.main(argv)``, on one recorded clip
(an npz file; a fleet request lists one a camera), with its outputs in a
temporary directory. The loop is closed with one request in flight, the
clips cycling through the cell's pool. The window opens after a warm-up
request at the cell's own shapes and closes when the first request that
ends after ``--seconds`` completes.

End-to-end metrics (``--trace 0``): ``frames_per_s`` (all frames of all
the window's requests, summed over streams, over the window's wall
time), ``peak_mem_gib`` (the largest ``max_memory_allocated`` of any of
its requests, the peak reset before each) and ``setup_s`` (process start
to the window's opening, less the build of the cell's input pool: the
benchmark's own inputs, rendered once a seed and read from the cache
after, which no change of the program moves; its time is logged apart). With ``--trace 1`` the same window runs, then
``trace_requests`` more requests under torch.profiler, and each
per-layer metric's reader takes its number from the record (stage
seconds of the window, device events and kernel-call shapes of the
traced requests).

After the window the plain reference (`benchmark.reference.slam`) runs
on the pool entries the check samples from the seed, and every
request's outputs of those entries are compared with it
(`benchmark.check`).
"""

from __future__ import annotations

import argparse
import contextlib
import gc
import io
import json
import shutil
import sys
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np

from benchmark import check, manifest, traffic

BANNED = ("jax", "jaxlib", "flax", "aruco_slam_tpu")
CACHE = Path(__file__).resolve().parent / ".cache"


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="one run of one cell")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=[0, 1], default=0)
    return p


def check_devices(chips: int) -> None:
    """Refuse to run without the cards the cell asks for."""
    import torch
    if not torch.cuda.is_available():
        raise SystemExit("no CUDA device: torch.cuda.is_available() is "
                         "False; the benchmark runs on the card only")
    if torch.cuda.device_count() < chips:
        raise SystemExit(f"the cell needs {chips} cards, "
                         f"{torch.cuda.device_count()} are visible")


def banned_modules() -> list[str]:
    """Top-level names of loaded modules that the program must not load,
    compared whole."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(BANNED))


def power_limit() -> str:
    """The card's power limit as nvidia-smi reads it (the roofline peaks
    assume 700 W), or why it could not be read."""
    import subprocess
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20, check=True).stdout.strip()
    except (OSError, subprocess.SubprocessError) as e:
        return f"not read ({type(e).__name__})"
    return out or "not read (no output)"


def config_flags(cfg: dict) -> list[str]:
    """The configuration's run_slam flags."""
    flags = ["--filter", cfg["filter"], "--detector", cfg["detector"],
             "--capacity", str(cfg["capacity"]), "--dict", cfg["dict"],
             "--max-obs", str(cfg["max_obs"]),
             "--precision", cfg["precision"]]
    for key, val in cfg["filter_params"].items():
        flags += ["--" + key.replace("_", "-"), str(val)]
    return flags


class Request:
    """One completed request: its pool entry, frames, stage seconds,
    peak memory and outputs."""

    def __init__(self, index, entry, results, peak, files):
        self.index = index
        self.entry = entry
        self.frames = int(sum(len(r.cam_traj) for r in results))
        self.seconds = dict(results[0].seconds)
        self.peak = peak
        self.streams = [check.Output(r.cam_traj, r.obs_mask,
                                     r.landmark_ids, traj, mp)
                        for r, (traj, mp) in zip(results, files)]


class Runner:
    """Issues requests of one cell on one device."""

    def __init__(self, cell: manifest.Cell, pool, out_dir: Path,
                 platform: str, extra: tuple = ()):
        from aruco_slam_tpu_torch.apps import run_slam
        self.main = run_slam.main
        self.pool = pool
        self.out = out_dir
        self.platform = platform
        self.flags = config_flags(cell.config) \
            + [str(f) for f in cell.traffic.get("run_slam", [])] \
            + list(extra)
        self.count = 0
        self.last_output = ""

    def _files(self, i: int):
        traj = self.out / f"traj_{i}.txt"
        mp = self.out / f"map_{i}.txt"
        n = len(self.pool[0])
        if n == 1:
            return traj, mp, [(traj, mp)]
        return traj, mp, [(traj.with_name(f"traj_{i}_s{k}.txt"),
                           mp.with_name(f"map_{i}_s{k}.txt"))
                          for k in range(n)]

    def request(self) -> Request:
        import torch
        i = self.count
        self.count += 1
        entry = i % len(self.pool)
        traj, mp, files = self._files(i)
        argv = ["--input", ",".join(str(p) for p in self.pool[entry]),
                "--platform", self.platform, "--trajectory", str(traj),
                "--map", str(mp), *self.flags]
        cuda = self.platform == "cuda"
        if cuda:
            torch.cuda.reset_peak_memory_stats()
        sink = io.StringIO()
        with contextlib.redirect_stdout(sink):
            res = self.main(argv)
        self.last_output = sink.getvalue()
        peak = 0
        if cuda:
            torch.cuda.synchronize()
            peak = torch.cuda.max_memory_allocated()
        results = res if isinstance(res, list) else [res]
        return Request(i, entry, results, peak, files)


def _window(runner: Runner, seconds: float):
    """Requests back to back until the first that ends after
    ``seconds``: (requests, wall seconds, error text or None)."""
    reqs = []
    t0 = time.perf_counter()
    while True:
        try:
            reqs.append(runner.request())
        except Exception:  # a failed request ends the window
            return reqs, time.perf_counter() - t0, traceback.format_exc()
        t = time.perf_counter() - t0
        if t >= seconds:
            return reqs, t, None


def _reference(cell: manifest.Cell, pool, entries, device) -> dict:
    """The plain reference of each sampled pool entry."""
    from benchmark.reference import slam
    track = None
    flags = [str(f) for f in cell.traffic.get("run_slam", [])]
    if "--track-every" in flags:
        def flag(name, default=0):
            return int(flags[flags.index(name) + 1]) if name in flags \
                else default
        track = dict(track_every=flag("--track-every"),
                     rescue_cohorts=flag("--rescue-cohorts"))
    out = {}
    for e in entries:
        clips = []
        for p in pool[e]:
            with np.load(p) as z:
                clips.append({k: z[k] for k in z.files})
        out[e] = slam.run(clips, cell.config, track, device)
    return out


def run_cell(cell: manifest.Cell, seed: int, seconds: float, trace: bool,
             t_start: float, platform: str = "cuda", extra: tuple = (),
             cache: Path = CACHE / "pools") -> dict:
    """One run: {"result": the last line's object, "log": the earlier
    lines}."""
    import torch
    log = []
    device = torch.device(platform)
    t0 = time.perf_counter()
    pool = traffic.build_pool(cell.config, cell.traffic, seed, cache=cache)
    t_pool = time.perf_counter() - t0
    frames_per_req = cell.traffic["frames"] * int(cell.config["streams"])
    log.append(f"# pool: {len(pool)} requests of {len(pool[0])} clip(s) x "
               f"{cell.traffic['frames']} frames ({frames_per_req} frames "
               f"a request)")
    out_dir = Path(tempfile.mkdtemp(prefix="bench_out_"))
    try:
        runner = Runner(cell, pool, out_dir, platform, extra)
        t0 = time.perf_counter()
        warm = runner.request()  # the cell's own shapes
        t_open = time.perf_counter()
        # the pool is the benchmark's own input: its build is not set-up
        setup_s = t_open - t_start - t_pool
        log.append(f"# set-up {setup_s:.3f} s: warm-up request "
                   f"{t_open - t0:.3f} s, before it "
                   f"{setup_s - (t_open - t0):.3f} s; not counted: the "
                   f"pool's build {t_pool:.3f} s")
        reqs, window_s, error = _window(runner, seconds)
        done = [warm] + reqs
        traced = None
        if trace and error is None:
            from benchmark import trace as trace_mod
            n = int(cell.traffic.get("trace_requests", 1))
            probes = trace_mod.probes(cell.per_layer)
            traced = trace_mod.run(lambda: [runner.request()
                                            for _ in range(n)],
                                   probes, platform, cell.chips)
            done += traced["value"]
        peak = max(r.peak for r in done)
        n_frames = sum(r.frames for r in reqs)
        gc.collect()
        if platform == "cuda":
            torch.cuda.empty_cache()
        # the check: the sampled pool entries' reference, every request
        # of those entries held to it
        rng = np.random.default_rng(np.random.SeedSequence([seed, 7]))
        k = min(int(cell.traffic.get("check_entries", len(pool))),
                len(pool))
        entries = sorted(int(e) for e in rng.choice(len(pool), k,
                                                    replace=False))
        t_ref = time.perf_counter()
        refs = _reference(cell, pool, entries, device)
        ref_s = time.perf_counter() - t_ref
        numbers = check.compare(
            [(r.streams, refs[r.entry]) for r in done if r.entry in refs])
        checks = {name: {"value": numbers[name], "limit": lim}
                  for name, lim in cell.limits.items()}
        correct = error is None and bool(reqs) and check.passes(checks)
    finally:
        shutil.rmtree(out_dir, ignore_errors=True)
    if error is not None:
        log.append("# request failed:\n" + error)
        log.append(runner.last_output[-4000:])
    log.append(f"# window: {len(reqs)} requests, {n_frames} frames in "
               f"{window_s:.3f} s; reference of entries {entries} in "
               f"{ref_s:.1f} s")
    stage_keys = ("load", "front_end", "filter")
    for r in reqs:
        log.append("# request {} (entry {}): {} frames, {}".format(
            r.index, r.entry, r.frames, ", ".join(
                f"{k} {r.seconds[k]:.4f} s" for k in stage_keys
                if k in r.seconds)))
    if traced is not None:
        log.append(f"# roofline peaks: 67 TFLOP/s f32, 3.35 TB/s (published,"
                   f" 700 W), int32 132 x 64 x 1.98 GHz (derived); card "
                   f"and power limit: {power_limit()}")
        calls = traced["record"]["calls"]
        log.append(f"# traced: {len(traced['value'])} requests in "
                   f"{traced['record']['window_s']:.3f} s, "
                   f"{len(traced['record']['device_events'])} device "
                   "events; probed calls "
                   + str({k: len(v) for k, v in calls.items()}))
    if trace:
        record = dict(requests=[dict(frames=r.frames, seconds=r.seconds)
                                for r in reqs])
        if traced is not None:
            record.update(traced["record"])
        metrics = {}
        for m, reader in cell.per_layer:
            v = reader.read(record)
            if v is not None:
                metrics[m["name"]] = {"value": float(v), "unit": m["unit"]}
    else:
        rate = n_frames / window_s if window_s > 0 else 0.0
        metrics = {"frames_per_s": {"value": rate, "unit": "frames/s"},
                   "peak_mem_gib": {"value": peak / 2**30, "unit": "GiB"},
                   "setup_s": {"value": setup_s, "unit": "s"}}
        metrics = {k: v for k, v in metrics.items()
                   if k in {m["name"] for m in cell.end_to_end}}
    dev = {"platform": "gpu" if platform == "cuda" else platform,
           "kind": (torch.cuda.get_device_name() if platform == "cuda"
                    else "cpu"),
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    result = {"correct": bool(correct), "attempted": len(reqs) + (
        1 if error else 0), "failed": 1 if error else 0,
        "metrics": metrics, "device": dev}
    if traced is not None:
        dev.update(busy_s=traced["record"]["busy_s"],
                   window_s=traced["record"]["window_s"])
        result["breakdown"] = traced["breakdown"]
    # a number that could not be read (inf) prints as the largest float
    result["checks"] = {k: {"value": min(c["value"], 1.7e308),
                            "limit": c["limit"]} for k, c in checks.items()}
    return {"result": result, "log": log}


def main(argv=None, t_start: float | None = None) -> int:
    t_start = time.perf_counter() if t_start is None else t_start
    args = _parser().parse_args(argv)
    cell = manifest.resolve(args.workload)
    check_devices(cell.chips)
    import aruco_slam_tpu_torch
    import torch
    here = Path(aruco_slam_tpu_torch.__file__).resolve().parent.parent
    if here != manifest.ROOT:  # the program of this checkout, no other
        raise SystemExit(f"aruco_slam_tpu_torch was loaded from {here}, "
                         f"not from the checkout {manifest.ROOT}")
    torch.set_num_threads(min(4, torch.get_num_threads()))
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), t_start)
    for line in out["log"]:
        print(line)
    print(f"# device: {out['result']['device']}")
    banned = banned_modules()
    if banned:
        print(f"loaded modules the benchmark must not load: {banned}",
              file=sys.stderr)
        return 3
    checks = out["result"]["checks"]
    for name, c in checks.items():
        print(f"{name} {c['value']!r} limit {c['limit']!r}",
              file=sys.stderr)
    print(json.dumps(out["result"]), flush=True)
    return 0
