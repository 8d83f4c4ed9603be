"""The port's distribution layer (aruco_slam_tpu_torch.parallel.dist and
sharded_ba, run_offline --distributed / --processes / --fleet, the
sharded image front end) against the JAX package's, on the CPU over Gloo.

The JAX references run in this process on tests/conftest.py's 8 virtual
devices. Multi-process cases start fresh interpreters that import only
torch, numpy and the port (never JAX), on a port chosen at run time;
every wait has its own timeout and kills the whole process group on
expiry. Tolerances are the JAX tests' own (tests/test_parallel.py,
tests/test_dist.py): f64 cost rtol 1e-8, poses and landmarks atol 1e-7,
CLI trajectories atol 1e-5 (the files' rounding); observations of the
sharded front end bit-identical.
"""

import json
import os
import signal
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.apps import run_offline as joff
from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.bench import synthetic as jsyn
from aruco_slam_tpu.bench.ate import ate_rmse
from aruco_slam_tpu.graph import ba as jba
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu.parallel import dist as jdist
from aruco_slam_tpu.parallel import make_mesh as jmake_mesh
from aruco_slam_tpu.parallel import sharded_ba as jsb
from aruco_slam_tpu_torch.apps import run_offline as toff
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.graph import ba as tba
from aruco_slam_tpu_torch.io import NpzSource
from aruco_slam_tpu_torch.parallel import dist as tdist
from aruco_slam_tpu_torch.parallel import sharded_ba as tsb

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
COST_RTOL = 1e-8
STATE_ATOL = 1e-7
CLI_ATOL = 1e-5
WAIT_S = 120        # each multi-process wait
ITERS = 10


def jax_graph(frames=24, seed=0, dtype=jnp.float64, markers=8):
    """tests/test_dist.py's build_graph: an orbit before a wall, pose
    observations (5 mm noise) ingested without a solve."""
    cfg = jba.GraphConfig(max_poses=frames + 2, max_landmarks=16,
                          max_factors=frames * 10, dtype=dtype,
                          meas_sigma_t=0.01, odom_sigma_t=1.0,
                          odom_sigma_rot=1.0)
    scene = jsyn.make_wall_scene(num_markers=markers, seed=seed)
    traj = jsyn.make_orbit_trajectory(num_frames=frames)
    obs = jsyn.observe_poses(scene, traj, cfg.max_landmarks, noise_t=0.005,
                             fov_limit=0.75, seed=seed)
    state = jba.init_graph(cfg)
    for i in range(frames):
        state = jba.add_frame(cfg, state, jnp.asarray(obs.t_cl[i]),
                              jnp.asarray(obs.mask[i]))
    return cfg, state, traj


def arrays(state) -> dict:
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def to_port(jcfg, jstate, dtype=torch.float64):
    """The same problem as the port's config and state."""
    tcfg = tba.GraphConfig(**{**jcfg._asdict(), "dtype": dtype})
    return tcfg, tba.state_from_numpy(tcfg, arrays(jstate))


def assert_solve_close(cost, pose_t, lm, want_cost, want_pose_t, want_lm):
    np.testing.assert_allclose(float(cost), float(want_cost), rtol=COST_RTOL)
    np.testing.assert_allclose(np.asarray(pose_t), np.asarray(want_pose_t),
                               atol=STATE_ATOL)
    np.testing.assert_allclose(np.asarray(lm), np.asarray(want_lm),
                               atol=STATE_ATOL)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_processes(cmds, env=None, per_process=None):
    """Start each command in its own session (``per_process`` maps an
    environment variable to each command's value), wait for all (each
    wait bounded by WAIT_S), kill every process group on expiry; returns
    [(rc, stdout, stderr)]."""
    env = dict(os.environ if env is None else env,
               PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    procs = []
    for i, c in enumerate(cmds):
        own = {k: str(v[i]) for k, v in (per_process or {}).items()}
        procs.append(subprocess.Popen(
            c, cwd=ROOT, env={**env, **own}, text=True,
            stdout=subprocess.PIPE, stderr=subprocess.PIPE,
            start_new_session=True))
    outs = []
    try:
        for p in procs:
            out, err = p.communicate(timeout=WAIT_S)
            outs.append((p.returncode, out, err))
    except subprocess.TimeoutExpired:
        pytest.fail("multi-process run hung")
    finally:
        for p in procs:
            if p.poll() is None:
                os.killpg(p.pid, signal.SIGKILL)
                p.wait()
    return outs


_WORKER = textwrap.dedent("""
    import json, sys
    pid, nproc, port, mode, work = sys.argv[1:6]
    pid, nproc = int(pid), int(nproc)
    sys.path.insert(0, {root!r})
    import numpy as np, torch
    from aruco_slam_tpu_torch.parallel import dist
    if mode == "ba":
        dist.initialize(coordinator_address="127.0.0.1:" + port,
                        num_processes=nproc, process_id=pid, local_devices=2,
                        platform="cpu")
        assert dist.process_count() == nproc
        assert dist.device_count() == 2 * nproc
        from aruco_slam_tpu_torch.graph import ba
        from aruco_slam_tpu_torch.parallel import (
            make_mesh, sharded_batch_optimize)
        spec = json.load(open(work + "/cfg.json"))
        cfg = ba.GraphConfig(**spec, dtype=torch.float64)
        state = ba.state_from_numpy(cfg, dict(np.load(work + "/state.npz")))
        mesh = make_mesh()
        out, cost = sharded_batch_optimize(cfg, state, mesh, iters={iters})
        np.savez(f"{{work}}/rank{{pid}}.npz", cost=cost.numpy(),
                 **{{k: getattr(out, k).numpy()
                    for k in ("pose_q", "pose_t", "lm", "lm_q")}})
    else:
        from aruco_slam_tpu_torch.apps import run_offline
        from aruco_slam_tpu_torch.ops import detect
        chunks, obs = [], []
        real_cands = detect.detect_candidates_batch
        real_load = run_offline.load_observations

        def counted(images, cfg):
            chunks.append(images.shape[0])
            return real_cands(images, cfg)

        def load(*a, **k):
            obs.append(real_load(*a, **k))
            return obs[-1]
        detect.detect_candidates_batch = counted
        run_offline.load_observations = load
        run_offline.main(["--input", work + "/img.npz", "--f64", "--iters",
                          "{iters}", "--platform", "cpu", "--distributed",
                          "--trajectory", work + "/traj.txt",
                          "--map", work + "/map.txt"])
        keys = ("times", "t_cl", "q_cl", "mask", "amb", "slot_ids")
        o, = obs
        np.savez(f"{{work}}/obs{{pid}}.npz", **dict(zip(keys, o[:4] + o[5:7])))
        json.dump(chunks, open(f"{{work}}/chunks{{pid}}.json", "w"))
""")


def run_workers(tmp_path, mode: str, nproc: int = 2):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER.format(root=str(ROOT), iters=ITERS))
    port = str(free_port())
    # a run_offline --processes child's environment (the "ingest" mode
    # joins through run_offline --distributed)
    env = dict(os.environ, SLAM_COORDINATOR=f"127.0.0.1:{port}",
               SLAM_NUM_PROCESSES=str(nproc))
    outs = run_processes([[sys.executable, str(worker), str(i), str(nproc),
                           port, mode, str(tmp_path)] for i in range(nproc)],
                         env=env,
                         per_process={"SLAM_PROCESS_ID": range(nproc)})
    for rc, out, err in outs:
        assert rc == 0, f"worker failed:\n{out}\n{err}"


# ---------------------------------------------------------------------------
# the landmark partition and the sharded solve, in one process
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("n", [2, 4, 8])
def test_partition_by_landmark_matches_jax(n):
    """The repartitioned capacities and every array equal JAX's exactly:
    landmarks padded to a multiple of n, factors grouped by their
    landmark's shard with shard-local f_lm, lane-aligned shard capacity,
    identity quaternions and meas_sigma_t in the padding."""
    jcfg, jstate, _ = jax_graph(frames=24, seed=3)
    tcfg, tstate = to_port(jcfg, jstate)
    jc2, js2 = jsb.partition_by_landmark(jcfg, jstate, n)
    tc2, ts2 = tsb.partition_by_landmark(tcfg, tstate, n)
    assert (tc2.max_factors, tc2.max_landmarks) == (jc2.max_factors,
                                                    jc2.max_landmarks)
    assert tsb._shard_capacity(tcfg, tstate, n) == \
        jsb._shard_capacity(jcfg, jstate, n)
    for k, want in arrays(js2).items():
        got = getattr(ts2, k).numpy()
        assert got.shape == want.shape, k
        np.testing.assert_array_equal(got, want, err_msg=k)


@pytest.fixture(scope="module")
def orbit40():
    """tests/test_parallel.py's 40-frame problem and the JAX solves of
    it: landmark-sharded on make_mesh(8) and on one device."""
    jcfg, jstate, traj = jax_graph(frames=40, seed=0)
    js, jcost = jsb.sharded_batch_optimize(jcfg, jstate, jmake_mesh(8),
                                           iters=15)
    jb, jbcost = jba.batch_optimize(jcfg, jstate, iters=15)
    return jcfg, jstate, traj, (js, jcost), (jb, jbcost)


@pytest.mark.parametrize("local", [2, 4, 8])
def test_sharded_batch_matches_jax(orbit40, local):
    """sharded_batch_optimize in one process over ``local`` mesh devices
    (shards batched on the CPU device) against JAX's sharded solve on 8
    devices and its single-device solve."""
    jcfg, jstate, traj, (js, jcost), (jb, jbcost) = orbit40
    tcfg, tstate = to_port(jcfg, jstate)
    mesh = tdist.make_mesh(local_devices=local)
    assert mesh.shape == {"kf": local} and mesh.group is None
    out, cost = tsb.sharded_batch_optimize(tcfg, tstate, mesh, iters=15)
    for ref, rcost in ((js, jcost), (jb, jbcost)):
        assert_solve_close(cost, out.pose_t, out.lm, rcost, ref.pose_t,
                           ref.lm)
    assert ate_rmse(out.pose_t.numpy()[:40], traj.cam_t[:40]) < 0.02


def test_sharded_batch_f32():
    """float32 over 4 mesh devices: a finite cost and the trajectory
    recovered (tests/test_parallel.py's f32 case)."""
    jcfg, jstate, traj = jax_graph(frames=30, seed=1)
    tcfg, tstate = to_port(jcfg, jstate, torch.float32)
    out, cost = tsb.sharded_batch_optimize(
        tcfg, tstate, tdist.make_mesh(local_devices=4), iters=ITERS)
    assert np.isfinite(float(cost))
    assert ate_rmse(out.pose_t.numpy()[:30], traj.cam_t[:30]) < 0.02


def test_sharded_fleet_matches_jax():
    """Four problems on a 4x2 (data x kf) mesh, batched in one process,
    against JAX's sharded_fleet_optimize on make_mesh2d(4, 2) and each
    problem's single-device solve (tests/test_dist.py's fleet case)."""
    frames, iters = 24, 12
    built = [jax_graph(frames=frames, seed=s) for s in range(4)]
    jcfg = built[0][0]
    jfleet = jsb.stack_graphs([b[1] for b in built])
    jout, jcosts = jsb.sharded_fleet_optimize(
        jcfg, jfleet, jdist.make_mesh2d(4, 2), iters=iters)
    tcfg = to_port(jcfg, built[0][1])[0]
    mesh = tdist.make_mesh2d(4, 2, local_devices=8)
    assert mesh.shape == {"data": 4, "kf": 2}
    tfleet = tsb.stack_graphs([to_port(jcfg, b[1])[1] for b in built])
    out, costs = tsb.sharded_fleet_optimize(tcfg, tfleet, mesh, iters=iters)
    assert costs.shape == (4,)
    for s, (_, jstate, _) in enumerate(built):
        single, scost = jba.batch_optimize(jcfg, jstate, iters=iters)
        for want_cost, want_t, want_lm in (
                (jcosts[s], jout.pose_t[s], jout.lm[s]),
                (scost, single.pose_t, single.lm)):
            assert_solve_close(costs[s], out.pose_t[s], out.lm[s],
                               want_cost, want_t, want_lm)


def test_two_processes_match_jax(tmp_path):
    """Two OS processes over Gloo, two mesh devices each (4 landmark
    shards, the kf row spanning both): the solve matches JAX's single-
    device solve, and both processes hold bit-equal poses and landmarks."""
    jcfg, jstate, _ = jax_graph(frames=24, seed=3)
    spec = {k: v for k, v in jcfg._asdict().items() if k != "dtype"}
    (tmp_path / "cfg.json").write_text(json.dumps(spec))
    np.savez(tmp_path / "state.npz", **arrays(jstate))
    run_workers(tmp_path, "ba")
    r0, r1 = (np.load(tmp_path / f"rank{i}.npz") for i in range(2))
    single, cost = jba.batch_optimize(jcfg, jstate, iters=ITERS)
    assert_solve_close(r0["cost"], r0["pose_t"], r0["lm"], cost,
                       single.pose_t, single.lm)
    for k in ("cost", "pose_q", "pose_t", "lm", "lm_q"):
        assert r0[k].tobytes() == r1[k].tobytes(), k


# ---------------------------------------------------------------------------
# run_offline's distributed paths
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def seq_files(tmp_path_factory):
    """Four pose-level 24-frame sequences (6-marker walls, seeds 0-3, 5 mm
    / 0.02 rad noise): both packages' graphs get identical inputs (on
    corner input the port's PnP runs in float32, JAX's in float64 under
    the test suite's x64 mode)."""
    from aruco_slam_tpu.io.sources import save_npz
    d = tmp_path_factory.mktemp("dist_seqs")
    k = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3],
                  [0.0, 0.0, 1.0]])
    paths = []
    for s in range(4):
        scene = jsyn.make_wall_scene(num_markers=6, seed=s)
        traj = jsyn.make_orbit_trajectory(num_frames=24)
        obs = jsyn.observe_poses(scene, traj, 16, noise_t=0.005,
                                 noise_r=0.02, fov_limit=0.75, seed=s)
        paths.append(d / f"seq{s}.npz")
        save_npz(paths[-1], times=traj.times, t_cl=obs.t_cl, q_cl=obs.q_cl,
                 mask=obs.mask, gt_cam_t=traj.cam_t, camera_matrix=k,
                 dist_coeffs=np.zeros(5),
                 marker_size=np.float64(scene.marker_size))
    return paths


def _offline(mod, inputs, out: Path, *flags, platform=True):
    plat = ["--platform", "cpu"] if platform else []
    mod.main(["--input", ",".join(map(str, inputs)), "--iters", str(ITERS),
              "--f64", *plat, "--trajectory", str(out / "traj.txt"),
              "--map", str(out / "map.txt"), *flags])


def _cli(out: Path, *args):
    """run_offline as a command (--processes launches grandchildren)."""
    rc, so, se = run_processes([[
        sys.executable, "-m", "aruco_slam_tpu_torch.apps.run_offline",
        "--iters", str(ITERS), "--f64", "--platform", "cpu",
        "--coordinator", f"127.0.0.1:{free_port()}",
        "--trajectory", str(out / "traj.txt"), "--map", str(out / "map.txt"),
        *args]])[0]
    assert rc == 0, f"{so}\n{se}"
    return so


def _traj(path) -> np.ndarray:
    return read_trajectory(path)[1]


@pytest.fixture(scope="module")
def singles(seq_files, tmp_path_factory):
    """Each sequence's single-device run_offline --f64 trajectory, and
    JAX's of sequence 0."""
    out = {}
    runs = [("torch", toff, i) for i in range(4)] + [("jax", joff, 0)]
    for name, mod, i in runs:
        d = tmp_path_factory.mktemp(f"single_{name}{i}")
        _offline(mod, [seq_files[i]], d, platform=name == "torch")
        out[name, i] = _traj(d / "traj.txt")
    return out


def test_fleet_cli_matches_single_and_jax(seq_files, singles, tmp_path):
    """--fleet 4x2 --local-devices 8: each sequence's trajectory file
    against its single run and against JAX's --fleet 4x2 file."""
    (tmp_path / "t").mkdir()
    (tmp_path / "j").mkdir()
    _offline(toff, seq_files, tmp_path / "t", "--fleet", "4x2",
             "--local-devices", "8")
    _offline(joff, seq_files, tmp_path / "j", "--fleet", "4x2",
             platform=False)
    for i in range(4):
        got = _traj(tmp_path / "t" / f"traj_seq{i}.txt")
        assert got.shape == (24, 7) and np.isfinite(got).all()
        np.testing.assert_allclose(got, singles["torch", i], atol=CLI_ATOL)
        np.testing.assert_allclose(
            got, _traj(tmp_path / "j" / f"traj_seq{i}.txt"), atol=CLI_ATOL)


def test_fleet_misfit_error_matches_jax(seq_files, tmp_path):
    """--fleet 4x2 in one process without --local-devices: the error JAX
    gives on a one-device host, before any input is read."""
    with pytest.raises(ValueError) as want:
        jdist.make_mesh2d(4, 2, devices=jax.devices()[:1])
    with pytest.raises(ValueError) as got:
        toff.main(["--input", "missing_a.npz,missing_b.npz", "--fleet",
                   "4x2", "--platform", "cpu", "--trajectory",
                   str(tmp_path / "t.txt"), "--map", str(tmp_path / "m.txt")])
    assert str(got.value) == str(want.value)


@pytest.mark.parametrize("case", ["processes", "fleet_processes"])
def test_processes_cli_matches_single_and_jax(seq_files, singles, tmp_path,
                                              case):
    """--processes 2 --local-devices 2: the batch solve landmark-sharded
    over 4 mesh devices in two OS processes (process 0 writes), against
    the single run and JAX's; and --fleet 2x2 over two processes (pass 1
    round-robin, graph states all-gathered, each process solving its
    two sequences) against the single runs."""
    if case == "processes":
        _cli(tmp_path, "--input", str(seq_files[0]), "--processes", "2",
             "--local-devices", "2")
        got = {0: _traj(tmp_path / "traj.txt")}
    else:
        _cli(tmp_path, "--input", ",".join(map(str, seq_files)), "--fleet",
             "2x2", "--processes", "2", "--local-devices", "2")
        got = {i: _traj(tmp_path / f"traj_seq{i}.txt") for i in range(4)}
    for i, traj in got.items():
        assert traj.shape == (24, 7)
        np.testing.assert_allclose(traj, singles["torch", i], atol=CLI_ATOL)
    np.testing.assert_allclose(got[0], singles["jax", 0], atol=CLI_ATOL)


@pytest.fixture(scope="module")
def image_bundle(tmp_path_factory):
    """tests/test_dist.py's 10-frame 720x405 image sequence."""
    from aruco_slam_tpu.apps import make_synthetic
    from aruco_slam_tpu.io import sources
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    bundle = make_synthetic.build(
        frames=10, markers=6, capacity=16, noise_px=0.2, seed=0,
        camera_matrix=k, dist_coeffs=np.zeros(5), with_images=True,
        image_size=(720, 405))
    path = tmp_path_factory.mktemp("img") / "img.npz"
    sources.save_npz(path, **bundle)
    return path


def test_sharded_image_ingest(image_bundle, tmp_path, monkeypatch):
    """run_offline --distributed in two processes (a --processes child's
    environment) on the image bundle: each process runs the candidate
    pipeline on its own 5-frame chunk only, both get observations
    bit-identical to the single-process front end's, and the trajectory
    matches the single run."""
    import shutil
    shutil.copy(image_bundle, tmp_path / "img.npz")
    run_workers(tmp_path, "ingest")
    single = []
    real = toff.load_observations

    def load(*a, **k):
        single.append(real(*a, **k))
        return single[-1]
    monkeypatch.setattr(toff, "load_observations", load)
    (tmp_path / "single").mkdir()
    _offline(toff, [image_bundle], tmp_path / "single")
    want, = single
    want = dict(zip(("times", "t_cl", "q_cl", "mask", "amb", "slot_ids"),
                    want[:4] + want[5:7]))
    for pid in range(2):
        assert json.loads((tmp_path / f"chunks{pid}.json").read_text()) == [5]
        got = np.load(tmp_path / f"obs{pid}.npz")
        for k, w in want.items():
            assert got[k].dtype == np.asarray(w).dtype, k
            assert np.array_equal(got[k], w, equal_nan=got[k].dtype.kind
                                  == "f"), k
    multi = _traj(tmp_path / "traj.txt")
    assert multi.shape == (10, 7)
    np.testing.assert_allclose(multi, _traj(tmp_path / "single" / "traj.txt"),
                               atol=CLI_ATOL)


# ---------------------------------------------------------------------------
# usage errors and the backend rule
# ---------------------------------------------------------------------------

def test_fleet_divisibility_error_matches_jax():
    """Three problems on a 2-row data axis."""
    jcfg, jstate, _ = jax_graph(frames=8, seed=0)
    with pytest.raises(ValueError) as want:
        jsb.sharded_fleet_optimize(jcfg, jsb.stack_graphs([jstate] * 3),
                                   jdist.make_mesh2d(2, 1), iters=1)
    tcfg, tstate = to_port(jcfg, jstate)
    with pytest.raises(ValueError) as got:
        tsb.sharded_fleet_optimize(tcfg, tsb.stack_graphs([tstate] * 3),
                                   tdist.make_mesh2d(2, 1, local_devices=2),
                                   iters=1)
    assert str(got.value) == str(want.value) == \
        "fleet size 3 not divisible by data axis 2"


@pytest.mark.parametrize("shape", [(3, 3), (9, None), (0, 2)])
def test_make_mesh2d_misfit_matches_jax(shape, capsys):
    """A grid larger than the 8 devices (or empty): JAX's error, word for
    word; a smaller one uses a prefix of the devices, as JAX says."""
    with pytest.raises(ValueError) as want:
        jdist.make_mesh2d(*shape)
    with pytest.raises(ValueError) as got:
        tdist.make_mesh2d(*shape, local_devices=8)
    assert str(got.value) == str(want.value)
    jdist.make_mesh2d(3, 2)
    jline = capsys.readouterr().out
    assert tdist.make_mesh2d(3, 2, local_devices=8).shape == \
        {"data": 3, "kf": 2}
    assert capsys.readouterr().out == jline == "make_mesh2d: 3x2 uses 6/8 " \
        "devices\n"


def test_track_every_with_distributed_ingest_matches_jax(image_bundle):
    """--track-every with the sharded front end: JAX's ValueError, raised
    before any collective."""
    errors = []
    for mod, cfg_mod in ((jrun, None), (trun, SlamAppConfig)):
        if cfg_mod is None:
            from aruco_slam_tpu.config import SlamAppConfig as cfg_mod
            from aruco_slam_tpu.io.sources import NpzSource as src_mod
            extra = ()
        else:
            src_mod, extra = NpzSource, (torch.device("cpu"),)
        cfg = cfg_mod(input=str(image_bundle), track_every=8)
        with pytest.raises(ValueError) as exc:
            mod.load_observations(src_mod(image_bundle), cfg, *extra,
                                  shard=(0, 2))
        errors.append(str(exc.value))
    assert errors[0] == errors[1] and "--track-every" in errors[0]


@pytest.mark.parametrize("platform,world,cards,want", [
    ("cpu", 2, 0, "gloo"), ("cuda", 2, 1, "gloo"), ("cuda", 1, 1, "nccl"),
    ("cuda", 4, 4, "nccl"), ("cuda", 8, 4, "gloo")])
def test_backend_rule(platform, world, cards, want):
    """NCCL when every rank has a card of its own, else Gloo."""
    assert tdist.choose_backend(platform, world, cards)[0] == want
