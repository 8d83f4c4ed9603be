"""The port's pixels->pose slice end to end, against the JAX run_slam.

`aruco_slam_tpu_torch.apps.run_slam` and `aruco_slam_tpu.apps.run_slam`
run on the same rendered npz on the CPU, with full detection on every
frame, with the streaming tracker (``--track-every``), with 6-dof
landmarks (``--filter mekf_rotations``), a preloaded map
(``--load-map``) and slot recycling (``--slot-max-age``); the JAX
run_slam's flags, the fleet's viewer note and video through the decode
ring; plus the port's import hygiene (no jax) and its refusal to run
"cuda" without a card. The factor-graph backend's parity is
tests/test_torch_offline.py's.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.io import load_map
from aruco_slam_tpu.io.sources import save_npz
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu_torch.apps import front_end
from aruco_slam_tpu_torch.apps import run_slam as trun

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """8 rendered 960x540 frames (the first of a 30-frame orbit)."""
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2),
                                       jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    traj = synthetic.Trajectory(*(a[:8] for a in traj))
    frames = render.render_sequence(scene, traj, cam, image_size=(960, 540))
    path = tmp_path_factory.mktemp("slice") / "seq.npz"
    save_npz(path, times=traj.times, images=frames, gt_cam_t=traj.cam_t,
             camera_matrix=K2, dist_coeffs=DIST,
             marker_size=np.float64(scene.marker_size))
    return path


@pytest.fixture(scope="module")
def video_rate(tmp_path_factory):
    """12 rendered 960x540 frames at video rate (the first of a
    300-frame orbit), the streaming tracker's motion regime."""
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2),
                                       jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=300)
    traj = synthetic.Trajectory(*(a[:12] for a in traj))
    frames = render.render_sequence(scene, traj, cam, image_size=(960, 540))
    path = tmp_path_factory.mktemp("video") / "seq.npz"
    save_npz(path, times=traj.times, images=frames, gt_cam_t=traj.cam_t,
             camera_matrix=K2, dist_coeffs=DIST,
             marker_size=np.float64(scene.marker_size))
    return path


def _run_both(npz, tmp_path, monkeypatch, flags=()):
    # the JAX run_slam takes its fused Pallas update only on a TPU; here
    # it runs that kernel in interpret mode, as the port's update is its
    # counterpart (on the CPU the JAX default is a Cholesky gain, which
    # the 20-step Newton–Schulz gain does not reproduce)
    make_cfg = jrun._mekf_config
    monkeypatch.setattr(jrun, "_mekf_config", lambda *a, **k: make_cfg(
        *a, **k)._replace(pallas_update=True))
    out = {}
    for name, mod in (("jax", jrun), ("torch", trun)):
        traj_f = tmp_path / f"{name}_traj.txt"
        map_f = tmp_path / f"{name}_map.txt"
        res = mod.main(["--input", str(npz), "--platform", "cpu",
                        "--trajectory", str(traj_f), "--map", str(map_f),
                        *flags])
        out[name] = (read_trajectory(traj_f)[1], load_map(map_f))
    return res, out["jax"], out["torch"]


def _assert_close(tj, mj, tt, mt):
    # corners agree to 1e-3 px and the JAX PnP runs in float64 here
    # (x64 test mode) against the port's float32: 2e-3 m / 2e-3 on the
    # quaternion, far inside the 1 px corner noise the filter assumes
    np.testing.assert_allclose(tt, tj, atol=2e-3)
    np.testing.assert_array_equal(np.sort(mt[0]), np.sort(mj[0]))
    order_t, order_j = np.argsort(mt[0]), np.argsort(mj[0])
    np.testing.assert_allclose(mt[1][order_t], mj[1][order_j], atol=2e-3)


def test_run_slam_matches_jax(sequence, tmp_path, monkeypatch):
    res, (tj, mj), (tt, mt) = _run_both(sequence, tmp_path, monkeypatch)
    assert res.ate is not None and res.ate < 0.3
    assert res.obs_mask.sum(axis=1).min() >= 1
    assert tt.shape == tj.shape == (8, 7)
    _assert_close(tj, mj, tt, mt)


def test_run_slam_track_every_matches_jax(video_rate, tmp_path,
                                          monkeypatch):
    """--track-every 4: full sweeps on frames 0, 1, 4, 5, 8, 9, tracking
    on the rest, the carry crossing the (single, short) chunk."""
    res, (tj, mj), (tt, mt) = _run_both(video_rate, tmp_path, monkeypatch,
                                        ["--track-every", "4"])
    assert res.ate is not None and res.ate < 0.3
    counts = res.obs_mask.sum(axis=1)
    assert counts.min() >= 3, counts
    assert tt.shape == tj.shape == (12, 7)
    _assert_close(tj, mj, tt, mt)


def test_run_slam_track_every_chunks(video_rate, tmp_path, monkeypatch):
    """The streaming carry crosses chunk boundaries: chunks of 5 frames
    give the same trajectory as one chunk."""
    out = []
    real = front_end.observations_from_frames
    for chunk in (32, 5):
        monkeypatch.setattr(front_end, "observations_from_frames",
                            lambda *a, _c=chunk: real(*a, chunk=_c))
        res = trun.main(["--input", str(video_rate), "--platform", "cpu",
                         "--track-every", "4",
                         "--trajectory", str(tmp_path / f"t{chunk}.txt"),
                         "--map", str(tmp_path / f"m{chunk}.txt")])
        out.append(res)
    np.testing.assert_array_equal(out[0].obs_mask, out[1].obs_mask)
    np.testing.assert_allclose(out[0].cam_traj, out[1].cam_traj, atol=1e-5)


@pytest.mark.parametrize("flags,error", [
    (["--track-every", "2"], SystemExit),
    (["--track-every", "4", "--slot-max-age", "8"], ValueError)])
def test_track_every_refusals(video_rate, flags, error):
    """As the JAX run_slam: K < 3 is a usage error, and the streaming
    carry does not thread the LRU table."""
    with pytest.raises(error):
        trun.main(["--input", str(video_rate), "--platform", "cpu", *flags])


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    """A pose-level bundle (12 frames, 6 markers): the filter alone."""
    from aruco_slam_tpu.apps import make_synthetic
    b = make_synthetic.build(frames=12, markers=6, capacity=16,
                             noise_t=0.005, noise_r=0.005)
    path = tmp_path_factory.mktemp("poses") / "poses.npz"
    save_npz(path, **{k: b[k] for k in ("times", "t_cl", "q_cl", "mask",
                                        "gt_cam_t", "marker_size")})
    return path


# every flag of the JAX run_slam the port once rejected as unknown
JAX_FLAGS = [["--window", "4"], ["--pose-budget", "64"],
             ["--meas-sigma-t", "0.02"], ["--odom-sigma-t", "0.5"],
             ["--odom-sigma-rot", "0.5"], ["--huber-delta", "1.0"],
             ["--ba-rotations"], ["--checkpoint", "{tmp}/ck.npz"],
             ["--viz-dir", "{tmp}/viz"], ["--viz-3d-renderer", "fast"],
             ["--export-video"], ["--profile", "{tmp}/prof"]]


@pytest.mark.parametrize("flags", JAX_FLAGS, ids=lambda f: f[0])
def test_jax_run_slam_flags_parse(poses, tmp_path, flags):
    """Each flag parses. The factor graph's tuning, --checkpoint and the
    viewer modifiers leave an MEKF run as it was without them (as in
    the JAX run_slam) and write nothing of their own; --profile leaves
    the trajectory equal and writes its trace, DIR/trace.json."""
    flags = [f.format(tmp=tmp_path) for f in flags]

    def run(tag, *extra):
        return trun.main(["--input", str(poses), "--platform", "cpu",
                          "--filter", "mekf",
                          "--trajectory", str(tmp_path / f"{tag}.txt"),
                          "--map", str(tmp_path / f"{tag}_map.txt"), *extra])

    base, got = run("base"), run("flag", *flags)
    np.testing.assert_array_equal(got.cam_traj, base.cam_traj)
    assert Path(got.map_file).read_text() == Path(base.map_file).read_text()
    written = ["base.txt", "base_map.txt", "flag.txt", "flag_map.txt"]
    if flags[0] == "--profile":
        written.append("prof")
        assert (tmp_path / "prof" / "trace.json").stat().st_size > 0
    assert sorted(p.name for p in tmp_path.iterdir()) == written


@pytest.fixture(scope="module")
def blank_streams(tmp_path_factory):
    """Two 3-frame 160x96 image streams with nothing in view."""
    root = tmp_path_factory.mktemp("blank")
    paths = [root / f"b{i}.npz" for i in range(2)]
    for i, path in enumerate(paths):
        save_npz(path, times=np.arange(3) / 30.0,
                 images=np.full((3, 96, 160), 120 + 40 * i, np.uint8))
    return paths


@pytest.mark.parametrize("flag", ["--viz-2d", "--viz-3d", "--display"])
def test_fleet_serves_with_viewer_flags(blank_streams, tmp_path, capsys,
                                        flag):
    """With several inputs the viewer flags print the JAX run_slam's
    note and the fleet is served as without them."""
    out = {}
    for tag, extra in (("with", [flag]), ("without", [])):
        out[tag] = trun.main(
            ["--input", ",".join(map(str, blank_streams)), "--platform",
             "cpu", "--track-every", "4",
             "--trajectory", str(tmp_path / f"{tag}.txt"),
             "--map", str(tmp_path / f"{tag}_map.txt"), *extra])
        out[tag + "_log"] = capsys.readouterr().out
    assert "note: viz/display are per-stream features" in out["with_log"]
    assert "note:" not in out["without_log"]
    assert len(out["with"]) == 2
    for a, b in zip(out["with"], out["without"]):
        np.testing.assert_array_equal(a.cam_traj, b.cam_traj)
        assert Path(a.trajectory_file).is_file()


def test_run_slam_video_through_the_ring(video_rate, tmp_path, monkeypatch):
    """A video input (a cv2 MJPG .avi of the video-rate frames) goes
    through `io.PrefetchingFrameSource`, and gives exactly the
    trajectory and map of the same run decoding in the calling thread."""
    import cv2
    from aruco_slam_tpu_torch import io as tio
    seq = np.load(video_rate)
    path = tmp_path / "clip.avi"
    h, w = seq["images"].shape[1:]
    out = cv2.VideoWriter(str(path), cv2.VideoWriter_fourcc(*"MJPG"), 30.0,
                          (w, h))
    assert out.isOpened()
    for im in seq["images"]:
        out.write(cv2.cvtColor(im, cv2.COLOR_GRAY2BGR))
    out.release()
    calib = tmp_path / "calib"
    calib.mkdir()
    np.save(calib / "camera_matrix.npy", seq["camera_matrix"])
    np.save(calib / "dist_coeffs.npy", seq["dist_coeffs"])
    rings = []

    class Recorded(tio.PrefetchingFrameSource):
        def __init__(self, *a, **k):
            super().__init__(*a, **k)
            rings.append(self)

    def run(tag):
        return trun.main(["--input", str(path), "--platform", "cpu",
                          "--calib", str(calib), "--track-every", "4",
                          "--trajectory", str(tmp_path / f"{tag}.txt"),
                          "--map", str(tmp_path / f"{tag}_map.txt")])

    monkeypatch.setattr(front_end, "PrefetchingFrameSource", Recorded)
    ring = run("ring")
    assert len(rings) == 1
    rings[0].thread.join(timeout=10)
    assert not rings[0].thread.is_alive()
    monkeypatch.setattr(front_end, "PrefetchingFrameSource",
                        lambda frames, shape: frames)
    sync = run("sync")
    assert ring.cam_traj.shape == (len(seq["images"]), 7)
    assert ring.obs_mask.sum(axis=1).min() >= 3
    np.testing.assert_array_equal(ring.cam_traj, sync.cam_traj)
    assert Path(ring.map_file).read_text() == Path(sync.map_file).read_text()


def test_run_slam_rotations_matches_jax(sequence, tmp_path, monkeypatch):
    """--filter mekf_rotations (6-dof landmarks, the ambiguity-weighted
    attitude rows, double-cover alignment) against the JAX run_slam: the
    slice bound; the map ids equal."""
    res, (tj, mj), (tt, mt) = _run_both(sequence, tmp_path, monkeypatch,
                                        ["--filter", "mekf_rotations"])
    assert res.ate is not None and res.ate < 0.3
    assert tt.shape == tj.shape == (8, 7)
    _assert_close(tj, mj, tt, mt)


def test_run_slam_load_map_matches_jax(sequence, tmp_path, monkeypatch):
    """--load-map seeds the filter with a saved map (true marker ids
    translated through the id->slot table) in both drivers alike."""
    seed_map = tmp_path / "seed_map.txt"
    jrun.main(["--input", str(sequence), "--platform", "cpu",
               "--trajectory", str(tmp_path / "seed_traj.txt"),
               "--map", str(seed_map)])
    ids, pos, unc = load_map(seed_map)
    # keep all but one landmark, and add one marker the sequence never
    # sees (skipped by both)
    from aruco_slam_tpu.io import save_map
    save_map(seed_map, np.append(ids[1:], 49), np.vstack([pos[1:], pos[:1]]),
             np.vstack([unc[1:], unc[:1]]))
    res, (tj, mj), (tt, mt) = _run_both(
        sequence, tmp_path, monkeypatch, ["--load-map", str(seed_map)])
    assert res.ate is not None and res.ate < 0.3
    _assert_close(tj, mj, tt, mt)


@pytest.fixture(scope="module")
def two_cohorts(tmp_path_factory):
    """tests/test_recycling.py's image sequence whose marker cohort
    changes mid-run: ids 0-4 for 6 frames, then ids 20-24."""
    from aruco_slam_tpu.apps import make_synthetic
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    a, b = (make_synthetic.build(
        frames=6, markers=5, capacity=16, noise_px=0.2, seed=seed,
        camera_matrix=k, dist_coeffs=np.zeros(5), with_images=True,
        image_size=(720, 405), marker_ids=np.arange(5) + off)
        for seed, off in ((0, 0), (1, 20)))
    seq = dict(a)
    seq["images"] = np.concatenate([a["images"], b["images"]])
    seq["times"] = np.concatenate(
        [a["times"], a["times"][-1] + 0.04 + b["times"]])
    for key in ("gt_cam_t", "gt_cam_q"):
        seq[key] = np.concatenate([a[key], b[key]])
    path = tmp_path_factory.mktemp("cohorts") / "corridor.npz"
    save_npz(path, **seq)
    return path


def test_run_slam_slot_recycling_matches_jax(two_cohorts, tmp_path,
                                             monkeypatch):
    """--capacity 5 --slot-max-age 2 on the two-cohort sequence: the
    second cohort is mapped through recycled slots, and the trajectory
    and map match the JAX run_slam's."""
    res, (tj, mj), (tt, mt) = _run_both(
        two_cohorts, tmp_path, monkeypatch,
        ["--capacity", "5", "--slot-max-age", "2"])
    assert set(mt[0].tolist()) & set(range(20, 25))
    assert np.isfinite(tt).all()
    _assert_close(tj, mj, tt, mt)


def _python(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120, **kw)


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the JAX
    package (the machine with the card has no jax), and the viewers
    import no image, plotting or video library when they are imported
    (one without them imports the port all the same)."""
    proc = _python(["-c", (
        "import sys\n"
        "import chip_smoke\n"
        "import aruco_slam_tpu_torch.apps.run_slam\n"
        "import aruco_slam_tpu_torch.bench.render\n"
        "import aruco_slam_tpu_torch.ops.detect\n"
        "import aruco_slam_tpu_torch.parallel.multi_slam\n"
        "import aruco_slam_tpu_torch.parallel.dist\n"
        "import aruco_slam_tpu_torch.parallel.sharded_ba\n"
        "import aruco_slam_tpu_torch.apps.run_offline\n"
        "import aruco_slam_tpu_torch.apps.calibrate\n"
        "import aruco_slam_tpu_torch.apps.make_synthetic\n"
        "import aruco_slam_tpu_torch.core.lie\n"
        "import aruco_slam_tpu_torch.ops.calibrate\n"
        "import aruco_slam_tpu_torch.utils.checkpoint\n"
        "import aruco_slam_tpu_torch.utils.profiling\n"
        "import aruco_slam_tpu_torch.viz\n"
        "import aruco_slam_tpu_torch.viz.draw\n"
        "import aruco_slam_tpu_torch.viz.video\n"
        "import aruco_slam_tpu_torch.apps.sinks\n"
        "import aruco_slam_tpu_torch.bench.degrade\n"
        "import aruco_slam_tpu_torch.bench.pipeline\n"
        "import aruco_slam_tpu_torch.bench.e2e\n"
        "import aruco_slam_tpu_torch.bench.detect_profile\n"
        "import aruco_slam_tpu_torch.bench.large_map\n"
        "import aruco_slam_tpu_torch.bench.headline\n"
        "import aruco_slam_tpu_torch.bench.scaling\n"
        "import aruco_slam_tpu_torch.entry\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aruco_slam_tpu', 'cv2', 'imageio', "
        "'matplotlib', 'PIL', 'av'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


@pytest.mark.parametrize("schedule,elem,want", [
    # 6 flops x 25^2 interior pixels + 12 x (6 x 13^2 + 4 x 7^2) window
    # pixel-iterations; 27^2 bytes of patch + 16 of seed and corner
    (((6, 6), (3, 4)), 1, (18270, 745)),
    (((6, 6), (3, 4)), 4, (18270, 2932)),
    # 6 x 33^2 + 12 x 6 x 17^2; 35^2 + 16
    (((8, 6),), 1, (27342, 1241))])
def test_subpix_bound_counts_the_window(schedule, elem, want):
    """chip_smoke.py's B2/B5 bound counts the work the inputs need (the
    window's pixels, not the whole patch, each iteration): pinned per
    corner and at the detector's 32 x 384 corners."""
    proc = _python(["-c", (
        "import chip_smoke as c\n"
        f"print(c._subpix_work(1, {schedule!r}, {elem}))\n"
        f"print(c._subpix_work(12288, {schedule!r}, {elem}))\n"
        f"print(c._subpix_bound(12288, {schedule!r}, {elem}))\n")])
    assert proc.returncode == 0, proc.stderr
    one, chunk, bound = (eval(line) for line in proc.stdout.splitlines())
    assert one == want
    assert chunk == (12288 * want[0], 12288 * want[1])
    ops_ms = 12288 * want[0] / 67e12 * 1e3
    bytes_ms = 12288 * want[1] / 3.35e12 * 1e3
    assert bound == ((ops_ms, "operations") if ops_ms >= bytes_ms
                     else (bytes_ms, "bytes"))


def test_platform_cuda_refuses_without_card(sequence):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --platform cuda is valid")
    proc = _python(["-m", "aruco_slam_tpu_torch.apps.run_slam", "--input",
                    str(sequence), "--platform", "cuda"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "wrote" not in proc.stdout
