"""The port's checkpoints, resumes, profiling and synthetic-sequence tool
against the JAX package's, on the CPU.

`utils/checkpoint.py` writes the JAX package's file format, so state
crosses between the packages both ways; `run_slam --checkpoint-every /
--resume` (the MEKF paths and the factor graph) and `run_offline`'s
ingest resume bit-identically to the uninterrupted checkpointing run, as
tests/test_io_apps.py holds the JAX apps; `--profile` writes a trace
and leaves the trajectory as it was; `apps/make_synthetic.build` gives
JAX's arrays.

Sequences: a 40-frame pose-level bundle (8 markers, 5 mm / 5 mrad
noise) for the apps. A JAX-written checkpoint resumed in the port
matches the JAX resumed run within 2e-3 m (the bound of
tests/test_torch_slice.py's run_slam parity tests).
"""

import numpy as np
import pytest
import torch

from aruco_slam_tpu.apps import make_synthetic as jsyn
from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.filters import mekf as jm
from aruco_slam_tpu.io.sources import save_npz
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu.utils import checkpoint as jck
from aruco_slam_tpu_torch.apps import make_synthetic as tsyn
from aruco_slam_tpu_torch.apps import run_offline as toff
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.filters import mekf as tm
from aruco_slam_tpu_torch.graph import (
    GraphConfig, add_frame, init_graph, optimize_window)
from aruco_slam_tpu_torch.utils import checkpoint as tck
from aruco_slam_tpu_torch.utils import profiling

torch.set_num_threads(2)

PARITY = 2e-3  # m: tests/test_torch_slice.py's run_slam parity bound


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    b = jsyn.build(frames=40, markers=8, capacity=16, noise_t=0.005,
                   noise_r=0.005)
    path = tmp_path_factory.mktemp("ck") / "poses.npz"
    save_npz(path, **{k: b[k] for k in ("times", "t_cl", "q_cl", "mask",
                                        "gt_cam_t", "marker_size")})
    return path


def _obs(frames=6, capacity=8):
    rng = np.random.default_rng(0)
    t_cl = (rng.normal(size=(frames, capacity, 3)) * 0.3
            + [0, 0, 2]).astype(np.float32)
    q_cl = np.tile(np.float32([1, 0, 0, 0]), (frames, capacity, 1))
    mask = rng.random((frames, capacity)) < 0.6
    return t_cl, q_cl, mask


def _mekf_run(cfg, frames=6):
    t_cl, q_cl, mask = _obs(frames, cfg.capacity)
    obs = tm.FrameObservations(torch.tensor(t_cl), torch.tensor(q_cl),
                               torch.tensor(mask))
    return tm.mekf_scan(cfg, tm.init_state(cfg), obs)[0], obs


@pytest.mark.parametrize("kw", [
    dict(), dict(with_rotations=True), dict(cov_dtype=torch.bfloat16)],
    ids=["point", "rotations", "bf16-cov"])
def test_mekf_state_roundtrip(tmp_path, kw):
    """A mid-run MekfState saves and loads to every bit (a bf16
    covariance widened to f32 in the file and cast back), and the loaded
    state continues exactly as the saved one."""
    cfg = tm.MekfConfig(capacity=8, **kw)
    state, obs = _mekf_run(cfg)
    tck.save_checkpoint(tmp_path / "s.npz", state)
    with np.load(tmp_path / "s.npz") as data:
        assert int(data["num_leaves"]) == len(state) == 7
        assert data["leaf_3"].dtype == np.float32
    back = tck.load_checkpoint(tmp_path / "s.npz", tm.init_state(cfg))
    assert type(back) is tm.MekfState
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)
    nxt = [tm.mekf_scan(cfg, s, obs)[0] for s in (state, back)]
    for a, b in zip(*nxt):
        assert torch.equal(a, b)


def test_graph_state_roundtrip(tmp_path):
    cfg = GraphConfig(max_poses=8, max_landmarks=4, max_factors=16)
    state = init_graph(cfg)
    for t in ([[0.0, 0, 2]] * 4, [[0.1, 0, 2]] * 4):
        state = add_frame(cfg, state, torch.tensor(t),
                          torch.tensor([True, False, True, True]))
        state, _ = optimize_window(cfg, state)
    tck.save_checkpoint(tmp_path / "g.npz", (state, np.int64(2)))
    back, done = tck.load_checkpoint(tmp_path / "g.npz",
                                     (init_graph(cfg), np.int64(0)))
    assert int(done) == 2 and int(back.num_poses) == 3
    for a, b in zip(state, back):
        assert a.dtype == b.dtype and torch.equal(a, b)


def test_state_fields_match_jax():
    """The tree order the file format relies on: the port's state
    NamedTuples have the JAX fields in the JAX order."""
    from aruco_slam_tpu.graph import ba as jba
    from aruco_slam_tpu_torch.graph import ba as tba
    assert tm.MekfState._fields == jm.MekfState._fields
    assert tba.GraphState._fields == jba.GraphState._fields


def test_leaf_count_refusal_and_forward_migration(tmp_path):
    cfg = tm.MekfConfig(capacity=8)
    state, _ = _mekf_run(cfg)
    tck.save_checkpoint(tmp_path / "c.npz", state)
    with pytest.raises(ValueError, match="7 leaves, template has 1"):
        tck.load_checkpoint(tmp_path / "c.npz", (torch.zeros(3),))
    # a checkpoint written before a trailing field was appended: the
    # missing leaf comes from the template
    tck.save_checkpoint(tmp_path / "old.npz", tuple(state[:-1]))
    template = tm.init_state(cfg)._replace(
        dropped_obs=torch.tensor(5, dtype=torch.int32))
    back = tck.load_checkpoint(tmp_path / "old.npz", template)
    for a, b in zip(state[:-1], back[:-1]):
        assert torch.equal(a, b)
    assert int(back.dropped_obs) == 5


def test_nests_none_and_dicts_like_jax(tmp_path):
    """None is an empty subtree and dict keys go in sorted order, as in
    jax.tree: a nest written by one package loads in the other."""
    nest = {"b": np.arange(3), "a": (None, np.float32(2.5)),
            "c": [np.ones((2, 2))]}
    tck.save_checkpoint(tmp_path / "t.npz", nest)
    back = jck.load_checkpoint(tmp_path / "t.npz", nest)
    np.testing.assert_array_equal(back["b"], nest["b"])
    assert float(back["a"][1]) == 2.5 and back["a"][0] is None
    jck.save_checkpoint(tmp_path / "j.npz", nest)
    back = tck.load_checkpoint(tmp_path / "j.npz", nest)
    assert list(back) == ["b", "a", "c"]
    np.testing.assert_array_equal(back["c"][0], nest["c"][0])


def test_port_checkpoint_loads_in_jax(tmp_path):
    jcfg = jm.MekfConfig(capacity=8, with_rotations=True)
    tcfg = tm.config_from_jax(jcfg._asdict())
    state, _ = _mekf_run(tcfg)
    tck.save_checkpoint(tmp_path / "p.npz", (state, np.int64(6)))
    back, done = jck.load_checkpoint(tmp_path / "p.npz",
                                     (jm.init_state(jcfg), np.int64(0)))
    assert int(done) == 6
    for name, a in state._asdict().items():
        b = np.asarray(getattr(back, name))
        assert b.dtype == a.numpy().dtype, name
        np.testing.assert_array_equal(b, a.numpy())


def _argv(npz, tmp_path, tag, *flags):
    return ["--input", str(npz), "--platform", "cpu",
            "--trajectory", str(tmp_path / f"{tag}.txt"),
            "--map", str(tmp_path / f"{tag}_map.txt"), *flags]


@pytest.mark.parametrize("filt", ["mekf", "mekf_rotations", "factorgraph"])
def test_run_slam_resume_bit_identical(poses, tmp_path, filt, capsys):
    """Killed at frame 30 and resumed from the checkpoint: the
    trajectory and map of the uninterrupted checkpointing run, bit for
    bit; the checkpoint holds 30 frames done and their trajectory."""
    ck = tmp_path / "ck.npz"
    full = trun.main(_argv(poses, tmp_path, "full", "--filter", filt,
                           "--checkpoint-every", "10", "--checkpoint",
                           str(ck)))
    with np.load(ck) as data:
        n = int(data["num_leaves"])
        assert int(data[f"leaf_{n - 2}"]) == 30
        np.testing.assert_array_equal(data[f"leaf_{n - 1}"],
                                      full.cam_traj[:30])
    res = trun.main(_argv(poses, tmp_path, "res", "--filter", filt,
                          "--checkpoint-every", "10", "--checkpoint",
                          str(tmp_path / "ck2.npz"), "--resume", str(ck)))
    assert "resumed from" in capsys.readouterr().out
    np.testing.assert_array_equal(res.cam_traj, full.cam_traj)
    np.testing.assert_array_equal(read_trajectory(res.trajectory_file)[1],
                                  read_trajectory(full.trajectory_file)[1])
    assert open(res.map_file).read() == open(full.map_file).read()
    plain = trun.main(_argv(poses, tmp_path, "plain", "--filter", filt))
    np.testing.assert_allclose(plain.cam_traj, full.cam_traj, atol=1e-6)


@pytest.fixture(scope="module")
def video_rate(tmp_path_factory):
    """tests/test_torch_slice.py's video-rate frames: 12 rendered 960x540
    frames, the first of a 300-frame orbit, 10 markers."""
    k = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
                  [0.0, 0.0, 1.0]])
    b = tsyn.build(frames=12, markers=10, capacity=16, with_images=True,
                   image_size=(960, 540), orbit_frames=300,
                   camera_matrix=k)
    path = tmp_path_factory.mktemp("ck_images") / "seq.npz"
    save_npz(path, **{k: b[k] for k in ("times", "images", "gt_cam_t",
                                        "camera_matrix", "dist_coeffs",
                                        "marker_size")})
    return path


def test_run_slam_track_every_resume_bit_identical(video_rate, tmp_path):
    """--track-every 4 on image input: the resumed run re-runs the
    streaming front end over the whole input and the filter from the
    checkpoint (frame 8), and equals the uninterrupted run."""
    ck = tmp_path / "ck.npz"
    full = trun.main(_argv(video_rate, tmp_path, "full", "--track-every",
                           "4", "--checkpoint-every", "4", "--checkpoint",
                           str(ck)))
    res = trun.main(_argv(video_rate, tmp_path, "res", "--track-every",
                          "4", "--resume", str(ck)))
    assert full.obs_mask.sum(1).min() >= 3
    np.testing.assert_array_equal(res.obs_mask, full.obs_mask)
    np.testing.assert_array_equal(res.cam_traj, full.cam_traj)
    assert open(res.map_file).read() == open(full.map_file).read()


def test_jax_checkpoint_resumes_in_the_port(poses, tmp_path, monkeypatch):
    """A checkpoint the JAX run_slam wrote (--checkpoint-every 10, its
    fused update in interpret mode, which the port's update follows)
    resumes in the port's run_slam: the frames before it equal JAX's
    exactly, the rest within the run_slam parity bound of JAX's own
    resumed run."""
    make_cfg = jrun._mekf_config
    monkeypatch.setattr(jrun, "_mekf_config", lambda *a, **k: make_cfg(
        *a, **k)._replace(pallas_update=True))
    ck = tmp_path / "jck.npz"
    jrun.main(_argv(poses, tmp_path, "jfull", "--checkpoint-every", "10",
                    "--checkpoint", str(ck)))
    jrun.main(_argv(poses, tmp_path, "jres", "--resume", str(ck)))
    want = read_trajectory(tmp_path / "jres.txt")[1]
    got = trun.main(_argv(poses, tmp_path, "tres", "--resume", str(ck)))
    head = read_trajectory(tmp_path / "jfull.txt")[1][:30]
    np.testing.assert_allclose(got.cam_traj[:30], head, atol=1e-6)
    np.testing.assert_allclose(got.cam_traj, want, atol=PARITY)


def test_run_offline_resume_bit_identical(poses, tmp_path):
    ck = tmp_path / "ck.npz"
    common = ["--iters", "10"]
    full = toff.main(_argv(poses, tmp_path, "full", *common,
                           "--checkpoint-every", "10", "--checkpoint",
                           str(ck)))
    with np.load(ck) as data:
        assert int(data["num_leaves"]) == 16
        assert int(data["leaf_15"]) == 30
    res = toff.main(_argv(poses, tmp_path, "res", *common, "--resume",
                          str(ck)))
    np.testing.assert_array_equal(res.cam_traj, full.cam_traj)
    assert res.cost == full.cost
    assert open(res.map_file).read() == open(full.map_file).read()


def test_run_offline_profile(poses, tmp_path):
    """--profile writes DIR/trace.json with the run's events and leaves
    the result as it was."""
    import json
    base = toff.main(_argv(poses, tmp_path, "base", "--iters", "5"))
    prof = toff.main(_argv(poses, tmp_path, "prof", "--iters", "5",
                           "--profile", str(tmp_path / "trace")))
    np.testing.assert_array_equal(prof.cam_traj, base.cam_traj)
    events = json.loads((tmp_path / "trace" / "trace.json").read_text())
    names = {e.get("name", "") for e in events["traceEvents"]}
    assert len(names) > 10 and any("linalg" in n for n in names)


def test_device_trace_is_a_no_op_without_a_dir():
    with profiling.device_trace(None):
        x = torch.ones(3) * 2
    with profiling.device_trace(""):
        x = x + 1
    assert x.tolist() == [3.0, 3.0, 3.0]


def test_stage_timer_report():
    """The timer's record: totals and counts by name, and one span a
    stage in the order they opened, each with its enclosing span."""
    timer = profiling.StageTimer()
    for _ in range(3):
        with timer.stage("small", torch.ones(2)):
            pass
    with timer.stage("big") as out:
        out["result"] = (torch.ones(4), [torch.zeros(1)])
        with timer.stage("big.part"):
            sum(range(200_000))
    assert timer.counts == {"small": 3, "big": 1, "big.part": 1}
    assert [(s.name, s.parent) for s in timer.spans] == [
        ("small", -1)] * 3 + [("big", -1), ("big.part", 3)]
    for name in timer.totals:
        assert timer.totals[name] == pytest.approx(sum(
            s.end - s.start for s in timer.spans if s.name == name))
    assert timer.totals["big"] >= timer.totals["big.part"] > 0


@pytest.mark.parametrize("kw", [
    dict(frames=20, markers=6, noise_px=0.3, noise_t=0.01, noise_r=0.01),
    dict(frames=12, markers=5, capacity=16, seed=3, orbit_frames=120),
    dict(frames=4, markers=5, capacity=16, with_images=True,
         image_size=(480, 270), marker_ids=np.arange(5) + 20)],
    ids=["noisy", "video-rate", "images"])
def test_make_synthetic_build_matches_jax(kw):
    """Every array of the bundle: the pose and corner arrays within
    1e-6, the rest (masks, ground truth, images) equal."""
    want, got = jsyn.build(**kw), tsyn.build(**kw)
    assert sorted(got) == sorted(want)
    for k in want:
        w, g = np.asarray(want[k]), np.asarray(got[k])
        assert g.shape == w.shape, k
        if k in ("t_cl", "q_cl", "corners"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=k)
        else:
            np.testing.assert_array_equal(g, w, err_msg=k)


def test_make_synthetic_cli_feeds_run_slam(tmp_path):
    """A video-rate pose-level bundle (30 frames of a 300-frame orbit)
    that run_slam --platform cpu reads and tracks within the ATE bound
    of the image paths (0.3 m)."""
    out = tmp_path / "seq.npz"
    tsyn.main(["--out", str(out), "--frames", "30", "--markers", "8",
               "--noise-t", "0.005", "--noise-r", "0.005", "--video-rate"])
    with np.load(out) as data:
        assert data["t_cl"].shape == (30, 64, 3)
        assert "images" not in data.files
    res = trun.main(_argv(out, tmp_path, "run"))
    assert res.cam_traj.shape == (30, 7) and res.ate < 0.3
