"""The port's factor-graph drivers against the JAX package's, on the CPU:
`run_slam --filter factorgraph`, `run_offline` and `bench.factorgraph`.

Both drivers of each package read the same npz files: a corners-level
sequence (the port's `observe_corners` + `save_npz`: PnP runs in float32
in the port and in float64 in the JAX driver under the x64 test mode)
and a pose-level one (identical inputs to both graphs); image input is
tests/test_torch_offline_images.py's. Tolerances are stated beside each
comparison.
"""

import os
import signal
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from aruco_slam_tpu.apps import run_offline as joff
from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.io import load_map
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu_torch.apps import run_offline as toff
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.bench import synthetic
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.io import save_npz

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
K1 = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3], [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
FRAMES = 30
# whole float32 runs: the two graphs at f32 from PnP inputs that differ
# by f32 rounding (port) against f64 (JAX under x64)
F32_TRAJ = 2e-3   # m, per pose (the slice tests' bound)
F32_ATE = 1e-3    # m, ATE against JAX's
F64_RUN = 1e-6    # m, whole f64 runs from identical inputs


@pytest.fixture(scope="module")
def sequences(tmp_path_factory):
    """A 30-frame orbit before a 10-marker wall (seed 0) at 1920x1080:
    corners-level (noise 0.3 px, seed 3, capacity 16) and pose-level
    (noise 5 mm / 0.02 rad, seed 2) npz files."""
    root = tmp_path_factory.mktemp("graph_seq")
    cam = tcam.CameraModel.from_matrix(K1, DIST)
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=FRAMES)
    corners, cmask = synthetic.observe_corners(scene, traj, cam, 16,
                                               noise_px=0.3, seed=3)
    poses = synthetic.observe_poses(scene, traj, 16, noise_t=0.005,
                                    noise_r=0.02, fov_limit=0.75)
    common = dict(times=traj.times, gt_cam_t=traj.cam_t,
                  gt_cam_q=traj.cam_q, camera_matrix=K1, dist_coeffs=DIST,
                  marker_size=np.float64(scene.marker_size))
    save_npz(root / "corners.npz", corners=corners, corner_mask=cmask,
             **common)
    save_npz(root / "poses.npz", t_cl=poses.t_cl, q_cl=poses.q_cl,
             mask=poses.mask, **common)
    return root / "corners.npz", root / "poses.npz"


def _both(jmod, tmod, npz, tmp_path, flags=()):
    """Run a driver of each package on ``npz``; returns {package:
    (trajectory (T, 7), map (ids, positions, uncertainties))}."""
    out = {}
    for name, mod in (("jax", jmod), ("torch", tmod)):
        traj_f = tmp_path / f"{name}_traj.txt"
        map_f = tmp_path / f"{name}_map.txt"
        mod.main(["--input", str(npz), "--platform", "cpu",
                  "--trajectory", str(traj_f), "--map", str(map_f), *flags])
        out[name] = (read_trajectory(traj_f)[1], load_map(map_f))
    return out


def _ate(traj, npz) -> float:
    from aruco_slam_tpu.bench.ate import ate_rmse
    return ate_rmse(traj[:, :3], np.load(npz)["gt_cam_t"])


def _assert_runs_close(out, npz, traj_tol, map_tol, ate_tol=None):
    (tj, mj), (tt, mt) = out["jax"], out["torch"]
    assert tt.shape == tj.shape == (FRAMES, 7)
    assert np.isfinite(tt).all()
    np.testing.assert_allclose(tt, tj, atol=traj_tol)
    np.testing.assert_array_equal(mt[0], mj[0])
    assert mt[1].shape == mj[1].shape
    np.testing.assert_allclose(mt[1], mj[1], atol=map_tol)
    if ate_tol is not None:
        assert abs(_ate(tt, npz) - _ate(tj, npz)) < ate_tol
    # the whole 30-frame orbit moves ~0.16 m a frame: both online graphs
    # lag it by ~0.12 m; the batch solve recovers it
    assert _ate(tt, npz) < 0.3


@pytest.mark.parametrize("flags", [[], ["--ba-rotations"]],
                         ids=["point", "rotations"])
def test_run_slam_factorgraph_matches_jax(sequences, tmp_path, flags):
    """--filter factorgraph at the run_slam defaults (window 8, 128-pose
    budget: no marginalization in 30 frames; Huber 2 and depth whitening
    on), corners-level input."""
    npz = sequences[0]
    out = _both(jrun, trun, npz, tmp_path, ["--filter", "factorgraph",
                                            *flags])
    _assert_runs_close(out, npz, F32_TRAJ, F32_TRAJ, F32_ATE)


def test_run_slam_factorgraph_marginalizes_like_jax(sequences, tmp_path):
    """--pose-budget 20 --window 6: the 30 frames cross marginalizations;
    pose-level input (the same observations in both graphs)."""
    npz = sequences[1]
    out = _both(jrun, trun, npz, tmp_path, ["--filter", "factorgraph",
                                            "--pose-budget", "20",
                                            "--window", "6"])
    _assert_runs_close(out, npz, F32_TRAJ, F32_TRAJ, F32_ATE)


@pytest.mark.parametrize("case", ["point", "rotations", "f64"])
def test_run_offline_matches_jax(sequences, tmp_path, case):
    """run_offline --iters 15 against the JAX run_offline: point and
    --ba-rotations (7-column map records [xyz, quat wxyz]) at f32 on
    corners-level input; --f64 on pose-level input (identical inputs to
    both graphs: within 1e-6 m)."""
    npz = sequences[1] if case == "f64" else sequences[0]
    flags = {"point": [], "rotations": ["--ba-rotations"],
             "f64": ["--f64"]}[case]
    out = _both(joff, toff, npz, tmp_path, ["--iters", "15", *flags])
    if case == "f64":
        _assert_runs_close(out, npz, F64_RUN, F64_RUN)
    else:
        _assert_runs_close(out, npz, F32_TRAJ, F32_TRAJ, F32_ATE)
    width = 7 if case == "rotations" else 3
    assert out["torch"][1][1].shape[1] == width
    if case == "rotations":
        q = out["torch"][1][1][:, 3:]
        np.testing.assert_allclose(np.linalg.norm(q, axis=1), 1.0, atol=1e-5)


def test_run_offline_result(sequences, tmp_path):
    """main returns what it wrote: the smoothed trajectory, map ids, the
    finite final cost, and the stage seconds."""
    npz = sequences[0]
    res = toff.main(["--input", str(npz), "--platform", "cpu", "--iters",
                     "10", "--trajectory", str(tmp_path / "t.txt"),
                     "--map", str(tmp_path / "m.txt")])
    np.testing.assert_allclose(read_trajectory(res.trajectory_file)[1],
                               res.cam_traj, atol=1e-6)
    np.testing.assert_array_equal(load_map(res.map_file)[0],
                                  res.landmark_ids)
    assert np.isfinite(res.cost) and res.ate < 0.3
    assert set(res.seconds) == {"front_end", "ingest", "solve"}


def _run_group(args):
    """run_offline as a command in its own session: --processes starts
    grandchildren, and a run past 120 s kills the whole group."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aruco_slam_tpu_torch.apps.run_offline",
         *args], cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=120)
    except subprocess.TimeoutExpired:
        pytest.fail("run_offline --processes hung")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    assert proc.returncode == 0, f"{out}\n{err}"


@pytest.mark.parametrize("flags", [["--distributed"], ["--fleet", "1x1"],
                                   ["--processes", "2"]],
                         ids=lambda f: f[0])
def test_run_offline_distributed_flags_match_plain_run(sequences, tmp_path,
                                                       flags):
    """The distributed flags on one sequence give the plain run's
    trajectory and map (f64, pose-level input, within 1e-6 m): alone,
    --distributed is one process and the plain solve; --fleet 1x1 solves
    a fleet of one through the batched fleet LM; --processes 2 shards the
    solve over two OS processes joined over Gloo."""
    npz = sequences[1]
    base = ["--input", str(npz), "--platform", "cpu", "--iters", "15",
            "--f64"]
    toff.main([*base, "--trajectory", str(tmp_path / "plain.txt"),
               "--map", str(tmp_path / "plain_map.txt")])
    args = [*base, "--trajectory", str(tmp_path / "t.txt"), "--map",
            str(tmp_path / "m.txt"), *flags]
    if flags[0] == "--processes":
        port = socket.socket()
        port.bind(("127.0.0.1", 0))
        with port:
            addr = f"127.0.0.1:{port.getsockname()[1]}"
        _run_group([*args, "--coordinator", addr])
    else:
        toff.main(args)
    np.testing.assert_allclose(read_trajectory(tmp_path / "t.txt")[1],
                               read_trajectory(tmp_path / "plain.txt")[1],
                               atol=F64_RUN)
    got, want = load_map(tmp_path / "m.txt"), load_map(
        tmp_path / "plain_map.txt")
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_allclose(got[1], want[1], atol=F64_RUN)


@pytest.mark.parametrize("flags", [
    ["--local-devices", "2"], ["--coordinator", "127.0.0.1:1"],
    ["--checkpoint", "{tmp}/ck.npz"], ["--viz-dir", "{tmp}/viz"],
    ["--viz-3d-renderer", "fast"]], ids=lambda f: f[0])
def test_run_offline_accepts_modifiers(sequences, tmp_path, flags):
    """Modifier flags without the flag they modify parse and change
    nothing (--local-devices and --coordinator act with --distributed,
    --processes or --fleet)."""
    flags = [f.format(tmp=tmp_path) for f in flags]
    res = toff.main(["--input", str(sequences[1]), "--platform", "cpu",
                     "--iters", "2", "--trajectory", str(tmp_path / "t.txt"),
                     "--map", str(tmp_path / "m.txt"), *flags])
    assert sorted(p.name for p in tmp_path.iterdir()) == ["m.txt", "t.txt"]
    assert np.isfinite(res.cam_traj).all()


USAGE = [["--input", "a.npz,b.npz"],
         ["--input", "a.npz,b.npz", "--fleet", "2x1", "--viz-2d"],
         ["--input", "a.npz,b.npz", "--fleet", "2x1", "--resume", "x.npz"],
         ["--input", "a.npz", "--track-every", "2"],
         ["--input", "a.npz,b.npz", "--track-every", "2", "--viz-3d"]]


@pytest.mark.parametrize("argv", USAGE, ids=lambda a: " ".join(a[2:]))
def test_run_offline_usage_errors_match_jax(argv, capsys):
    """The JAX run_offline's usage errors, the same one first when
    several apply."""
    errors = []
    for mod in (joff, toff):
        with pytest.raises(SystemExit) as exc:
            mod.main(argv)
        assert exc.value.code == 2
        errors.append(capsys.readouterr().err.strip().splitlines()[-1])
    assert errors[1].split(": error: ")[1] == errors[0].split(": error: ")[1]


def test_factorgraph_bench_row(capsys):
    """bench.factorgraph at dev scale (tests/test_graph.py:322's):
    marginalization exercised, ATE under 0.1 m, one JSON line."""
    import json
    from aruco_slam_tpu_torch.bench import factorgraph
    out = factorgraph.main(["--frames", "80", "--pose-budget", "48",
                            "--platform", "cpu"])
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert line == out
    assert out["metric"] == "factorgraph_online_fps" and out["value"] > 0
    assert out["ate_m"] < 0.1 and out["n_landmarks"] >= 6


def _python(args):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *args], cwd=ROOT, env=env,
                          capture_output=True, text=True, timeout=120)


@pytest.mark.parametrize("module", ["aruco_slam_tpu_torch.apps.run_offline",
                                    "aruco_slam_tpu_torch.bench.factorgraph"])
def test_platform_cuda_refuses_without_card(sequences, module):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --platform cuda is valid")
    extra = ["--input", str(sequences[0])] if "run_offline" in module else []
    proc = _python(["-m", module, *extra])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "wrote" not in proc.stdout and "metric" not in proc.stdout


def test_run_offline_parses_every_jax_flag():
    """The port's run_offline declares exactly the JAX run_offline's
    options."""
    jflags = {a for act in _jax_parser_actions() for a in act}
    tflags = {a for act in toff._parser()._actions
              for a in act.option_strings}
    assert tflags == jflags


def _jax_parser_actions():
    """The JAX run_offline parser's option strings (its parser is built
    inside main: recover it by stopping main at parse_args)."""
    import argparse
    seen = []
    real = argparse.ArgumentParser.parse_args

    def grab(self, *a, **k):
        seen.extend(act.option_strings for act in self._actions)
        raise SystemExit(0)
    argparse.ArgumentParser.parse_args = grab
    try:
        with pytest.raises(SystemExit):
            joff.main(["--input", "x.npz"])
    finally:
        argparse.ArgumentParser.parse_args = real
    return seen
