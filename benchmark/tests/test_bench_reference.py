"""The plain reference against run_slam.main --platform cpu, through the
harness, on CPU-sized clips; and with the timed path broken underneath,
``correct`` comes out false."""

import time

import numpy as np
import pytest
import torch

from benchmark import harness, manifest
from conftest import tiny_root


def _run(tmp_path, kind="corners", streams=1, flags=(), frames=4):
    root = tiny_root(tmp_path, kind=kind, streams=streams, flags=flags,
                     frames=frames)
    cell = manifest.resolve("tiny.t", root)
    return harness.run_cell(cell, 3 * 2**31 + 1, 0.01, False,
                            time.perf_counter(), platform="cpu",
                            cache=tmp_path / "pools")["result"]


@pytest.mark.parametrize("kind,streams,flags", [
    ("corners", 1, ()),
    ("images", 1, ()),
    ("images", 2, ("--track-every", "3", "--rescue-cohorts", "2")),
])
def test_reference_agrees_with_run_slam_on_the_cpu(tmp_path, kind, streams,
                                                   flags):
    res = _run(tmp_path, kind, streams, flags)
    assert res["correct"] is True, res["checks"]
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["obs_diff"] == 0 and checks["map_ids_diff"] == 0
    # the program and the reference compute the same on the CPU: the TUM
    # file's six decimals are the gap
    assert checks["traj_gap_m"] < 2e-6


def test_setup_leaves_out_the_pools_build(tmp_path, monkeypatch):
    """The pool is the benchmark's own input, cached a seed: a run that
    builds it and one that reads it pay the same set-up."""
    from benchmark import traffic
    real_pool, real_request = traffic.build_pool, harness.Runner.request
    pool_s, ends = [], []

    def slow_pool(*args, **kwargs):
        t0 = time.perf_counter()
        time.sleep(1.0)
        out = real_pool(*args, **kwargs)
        pool_s.append(time.perf_counter() - t0)
        return out

    def request(self):
        out = real_request(self)
        ends.append(time.perf_counter())
        return out
    monkeypatch.setattr(traffic, "build_pool", slow_pool)
    monkeypatch.setattr(harness.Runner, "request", request)
    root = tiny_root(tmp_path)
    t_start = time.perf_counter()
    res = harness.run_cell(manifest.resolve("tiny.t", root), 5, 0.01,
                           False, t_start, platform="cpu",
                           cache=tmp_path / "pools")["result"]
    setup_s = res["metrics"]["setup_s"]["value"]
    # the warm-up request's end opens the window
    assert abs(setup_s - (ends[0] - t_start - pool_s[0])) < 0.05
    assert setup_s < ends[0] - t_start - 1.0


def _state_unchanged(monkeypatch):
    from aruco_slam_tpu_torch.filters import mekf
    monkeypatch.setattr(mekf, "mekf_step", lambda cfg, state, obs: state)


def _half_the_batch(monkeypatch):
    from aruco_slam_tpu_torch.ops import pnp
    real = pnp.solve_square_pnp

    def half(cam, corners, size):
        res = real(cam, corners, size)
        err = res.err.clone()
        err[err.shape[0] // 2:] = float("inf")  # frames left out
        return res._replace(err=err)
    monkeypatch.setattr(pnp, "solve_square_pnp", half)


def _answer_altered(monkeypatch):
    from aruco_slam_tpu_torch import io
    real = io.TrajectoryWriter.write

    def write(self, t, pose):
        pose = np.array(pose, np.float64)
        pose[0] += 1e-3 * (t > 0.05)
        return real(self, t, pose)
    monkeypatch.setattr(io.TrajectoryWriter, "write", write)


@pytest.mark.parametrize("fault", [_state_unchanged, _half_the_batch,
                                   _answer_altered])
def test_a_broken_timed_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tmp_path, frames=6)
    assert res["correct"] is False, res["checks"]


@pytest.mark.cuda
@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load_manifest()["workloads"]])
def test_control_is_not_correct_on_the_card(cuda_device, cell):
    """The control, run_slam --precision high (TF32 in the filter's
    non-kernel matmuls), at the cell's own size on a short window."""
    from benchmark import control
    c = manifest.resolve(cell)
    out = harness.run_cell(c, 6 * 10**9 + 7, 0.5, False,
                           time.perf_counter(),
                           extra=control.CONTROL_FLAGS)["result"]
    assert out["correct"] is False, out["checks"]
    assert torch.cuda.is_available()
