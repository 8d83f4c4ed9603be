"""PyTorch port vs the JAX package: multi-stream serving.

S independent filters step together on a leading stream axis (the JAX
fleet vmaps its filter): `filters.mekf.mekf_step` and the fused update
batched, `ops.detect` slot assignment over S tables at once,
`parallel.multi_slam` and `run_slam --input a,b,...`. Each stream must
get what its own single-stream run gets, and what the JAX fleet gets.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.apps import make_synthetic
from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.filters import mekf as jm
from aruco_slam_tpu.io import load_map
from aruco_slam_tpu.io.sources import save_npz
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu.parallel import multi_slam as jms
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.filters import cuda_mekf
from aruco_slam_tpu_torch.filters import mekf as tm
from aruco_slam_tpu_torch.ops import detect as td
from aruco_slam_tpu_torch.parallel import multi_slam as tms

torch.set_num_threads(2)

# run_slam's filter settings (aruco_slam_tpu/config.py SlamAppConfig)
RUN_SLAM = dict(motion_model="cv", pixel_sigma=1.0, gate_distance=1.0,
                r_uncertainty=0.005, q_uncertainty_cam=1.0,
                q_error_uncertainty_cam=1.0, q_uncertainty_lm=0.0,
                q_vel=2e-3, vel_decay=0.99)
# a stream of the batched filter against its own single-stream run, on
# the CPU: the same arithmetic, but batched and unbatched f32 matmuls sum
# in other orders (measured up to 2.0e-5 m on trajectories and 5.6e-5 m
# on landmarks over 24 frames), so the bound is tests/test_io_apps.py's
# 1e-4 for the JAX fleet; a Cholesky gain amplifies that order to ~1e-3
# (tests/test_torch_mekf.py CHO_F32_TOL). On the card the kernel gives
# each stream its single-stream result bit for bit
# (tests/test_torch_cuda.py).
FLEET_TOL = dict(atol=1e-4, rtol=0.0)
CHO_F32_TOL = dict(atol=5e-3, rtol=5e-3)
# the port against JAX: tests/test_torch_mekf.py's bounds
TRAJ_TOL = dict(atol=5e-4, rtol=1e-3)


def _streams(s, capacity, frames, markers):
    """S observation sequences: one scene, S noise seeds; (S, T, ...)
    numpy arrays (t_cl, q_cl, mask, ambiguity)."""
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    outs = []
    for i in range(s):
        obs = synthetic.observe_poses(scene, traj, capacity, noise_t=0.005,
                                      noise_r=0.005, fov_limit=0.75,
                                      seed=10 + i)
        amb = np.random.default_rng(i).uniform(0.0, 0.8, obs.mask.shape)
        outs.append((obs.t_cl, obs.q_cl, obs.mask, amb))
    return [np.stack([o[j] for o in outs]).astype(
        np.float32 if j != 2 else bool) for j in range(4)]


def _tobs(arrays, i=None):
    pick = (lambda a: a) if i is None else (lambda a: a[i])
    return tm.FrameObservations(*(torch.tensor(pick(a)) for a in arrays))


@pytest.mark.parametrize("streams", [1, 3])
def test_fused_update_plain_batched(streams):
    """The plain update with a leading stream axis gives each stream what
    the single-stream call gives it (FLEET_TOL), and the wrapper takes
    both forms."""
    rng = np.random.default_rng(streams)
    n, m = 54, 24
    a = rng.normal(size=(streams, n, n)) / np.sqrt(n)
    cov = torch.tensor(a @ a.transpose(0, 2, 1) * 0.05 + 0.01 * np.eye(n),
                       dtype=torch.float32)
    h = torch.tensor(rng.normal(size=(streams, m, n)) * 0.3,
                     dtype=torch.float32)
    r = torch.tensor(rng.uniform(1e-3, 1e-2, (streams, m)),
                     dtype=torch.float32)
    resid = torch.tensor(0.01 * rng.normal(size=(streams, m)),
                         dtype=torch.float32)
    inn, pn = cuda_mekf.fused_update(cov, h, r, resid)
    assert inn.shape == (streams, n) and pn.shape == (streams, n, n)
    for i in range(streams):
        inn1, pn1 = cuda_mekf.fused_update(cov[i], h[i], r[i], resid[i])
        np.testing.assert_allclose(inn[i].numpy(), inn1.numpy(), **FLEET_TOL)
        np.testing.assert_allclose(pn[i].numpy(), pn1.numpy(), **FLEET_TOL)
    with pytest.raises(ValueError):
        cuda_mekf.fused_update(cov, h[:, 1:], r, resid)


@pytest.mark.parametrize("mode", [
    dict(), dict(with_rotations=True), dict(update_kernel=False),
    dict(update_kernel=False, s_solver="ns")])
def test_batched_scan_matches_per_stream(mode):
    """`batched_mekf_scan` over 3 streams (`stack_states`) against each
    stream's own `mekf_scan`, in both landmark modes and both update
    forms: FLEET_TOL (CHO_F32_TOL for the Cholesky gain); state fields
    and drop counts per stream."""
    arrays = _streams(3, 12, frames=24, markers=8)
    cfg = tm.MekfConfig(capacity=12, max_obs=5, **RUN_SLAM, **mode)
    states = tms.stack_states([tm.init_state(cfg)] * 3)
    assert states.cov.shape == (3, cfg.err_dim, cfg.err_dim)
    fin, trajs = tms.batched_mekf_scan(cfg, states, _tobs(arrays))
    assert trajs.shape == (3, 24, 7)
    tol = CHO_F32_TOL if mode.get("update_kernel") is False \
        and mode.get("s_solver") != "ns" else FLEET_TOL
    for i in range(3):
        one, traj = tm.mekf_scan(cfg, tm.init_state(cfg), _tobs(arrays, i))
        np.testing.assert_allclose(trajs[i].numpy(), traj.numpy(), **tol)
        np.testing.assert_allclose(fin.lm[i].numpy(), one.lm.numpy(), **tol)
        np.testing.assert_array_equal(fin.active[i].numpy(),
                                      one.active.numpy())
        assert int(fin.dropped_obs[i]) == int(one.dropped_obs)
    with pytest.raises(ValueError):
        tms.batched_mekf_scan(cfg, tm.init_state(cfg), _tobs(arrays, 0))


@pytest.mark.parametrize("rotations", [False, True])
def test_batched_scan_matches_jax(rotations):
    """The port's fleet filter against the JAX `batched_mekf_scan`, whose
    vmapped filter runs the Pallas update in interpret mode: each stream
    at the port-vs-JAX bound of tests/test_torch_mekf.py."""
    arrays = _streams(2, 12, frames=20, markers=8)
    jcfg = jm.MekfConfig(capacity=12, max_obs=5, with_rotations=rotations,
                         pallas_update=True, **RUN_SLAM)
    tcfg = tm.config_from_jax(jcfg._asdict())
    jstates = jms.stack_states([jm.init_state(jcfg)] * 2)
    jobs = jm.FrameObservations(*(jnp.asarray(a) for a in arrays))
    jfin, jtraj = jms.batched_mekf_scan(jcfg, jstates, jobs)
    tstates = tm.state_from_numpy(
        {k: np.asarray(v) for k, v in jstates._asdict().items()})
    tfin, ttraj = tms.batched_mekf_scan(tcfg, tstates, _tobs(arrays))
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), **TRAJ_TOL)
    np.testing.assert_array_equal(tfin.active.numpy(),
                                  np.asarray(jfin.active))
    np.testing.assert_allclose(tfin.lm.numpy(), np.asarray(jfin.lm),
                               **TRAJ_TOL)


def _corridor_cands(offset, t_frames=96):
    """A corridor of candidates for one stream (tests/test_recycling.py's
    geometry, shifted by ``offset`` markers): (T, K, ...) numpy."""
    lm_x = np.arange(64) * 0.25
    cam_x = np.linspace(0.0, 14.0, t_frames)
    outs = []
    for i in range(t_frames):
        vis = offset + np.where(np.abs(lm_x - cam_x[i]) < 1.2)[0]
        ids = np.full(16, -1, np.int32)
        ids[:len(vis)] = vis
        ok = ids >= 0
        outs.append((np.broadcast_to(ids[:, None, None], (16, 4, 2)
                                     ).astype(np.float32),
                     ids, ok, np.where(ok, 100, 0).astype(np.int32)))
    return [np.stack([o[j] for o in outs]) for j in range(4)]


@pytest.mark.parametrize("max_age", [0, 6])
def test_assign_sequence_streams_bit_identical(max_age):
    """Slot assignment over 3 streams at once (T steps for all S) is
    bit-identical to each stream's own sequence, and to the JAX
    `assign_sequence_lru` of that stream."""
    cap = 12
    cfg = td.DetectorConfig(capacity=cap, slot_max_age=max_age)
    jcfg = jd.DetectorConfig(capacity=cap, slot_max_age=max_age)
    per = [_corridor_cands(off) for off in (0, 7, 100)]
    batched = [torch.tensor(np.stack([p[j] for p in per])) for j in range(4)]
    got = td.assign_sequence_lru(
        cfg, td.slot_table_init(cap, streams=3),
        torch.zeros((3, cap), dtype=torch.int32), 5, *batched)
    assert got[0].shape == (3, 96, cap, 4, 2)
    for i, cands in enumerate(per):
        one = td.assign_sequence_lru(
            cfg, td.slot_table_init(cap), torch.zeros(cap, dtype=torch.int32),
            5, *(torch.tensor(a) for a in cands))
        want = jd.assign_sequence_lru(
            jcfg, jd.slot_table_init(cap), jnp.zeros(cap, jnp.int32), 5,
            *(jnp.asarray(a) for a in cands))
        for g, o, w in zip(got, one, want):
            np.testing.assert_array_equal(g[i].numpy(), o.numpy())
            np.testing.assert_array_equal(o.numpy(), np.asarray(w))
    if max_age:
        assert int(got[2].sum()) > 0  # slots were recycled


K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])


def test_batched_image_slam_matches_jax():
    """The pixels->pose fleet pipeline (slot == id detection over the S·T
    frames, PnP, batched filter) on 2 streams of 4 rendered 960x540
    frames against the JAX `batched_image_slam` (Pallas update in
    interpret mode): the slice bound of tests/test_torch_slice.py."""
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2), jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    frames = render.render_sequence(scene, synthetic.Trajectory(
        *(a[:4] for a in traj)), cam, image_size=(960, 540))
    images = np.stack([frames, frames[::-1]])
    jdcfg = jd.DetectorConfig()
    jfcfg = jm.MekfConfig(capacity=64, max_obs=16, pallas_update=True,
                          **RUN_SLAM)
    jst = jms.stack_states([jm.init_state(jfcfg)] * 2)
    _, jtraj = jms.batched_image_slam(jdcfg, jfcfg, cam,
                                      scene.marker_size,
                                      jnp.asarray(images), jst)
    tfcfg = tm.config_from_jax(jfcfg._asdict())
    tst = tms.stack_states([tm.init_state(tfcfg)] * 2)
    _, ttraj = tms.batched_image_slam(
        td.config_from_jax(jdcfg._asdict()), tfcfg,
        tcam.CameraModel.from_matrix(K2.astype(np.float32),
                                     DIST.astype(np.float32)),
        scene.marker_size, torch.tensor(images), tst)
    assert np.isfinite(ttraj.numpy()).all()
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), atol=2e-3)


@pytest.fixture(scope="module")
def stream_files(tmp_path_factory):
    """tests/test_io_apps.py's two 6-frame 720x405 image streams."""
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    root = tmp_path_factory.mktemp("streams")
    paths = []
    for i in range(2):
        bundle = make_synthetic.build(
            frames=6, markers=6, capacity=16, noise_px=0.2, seed=i,
            camera_matrix=k, dist_coeffs=np.zeros(5), with_images=True,
            image_size=(720, 405))
        paths.append(root / f"s{i}.npz")
        save_npz(paths[-1], **bundle)
    return paths


@pytest.mark.parametrize("filt", ["mekf", "mekf_rotations"])
def test_run_slam_fleet_matches_single(stream_files, tmp_path, filt):
    """`run_slam --input a,b`: each stream's trajectory within 1e-4 m of
    its single-stream run (tests/test_io_apps.py's bound for the JAX
    fleet) and the same map ids; one fused update per frame for both
    streams."""
    launches = cuda_mekf.fused_update.launches
    fleet = trun.main(["--input", ",".join(map(str, stream_files)),
                       "--platform", "cpu", "--filter", filt,
                       "--trajectory", str(tmp_path / "traj.txt"),
                       "--map", str(tmp_path / "map.txt"),
                       "--max-obs", "16"])
    assert len(fleet) == 2
    for i, path in enumerate(stream_files):
        ts, poses = read_trajectory(tmp_path / f"traj_s{i}.txt")
        assert len(ts) == 6 and np.isfinite(poses).all()
        one = trun.main(["--input", str(path), "--platform", "cpu",
                         "--filter", filt,
                         "--trajectory", str(tmp_path / f"one{i}.txt"),
                         "--map", str(tmp_path / f"mone{i}.txt"),
                         "--max-obs", "16"])
        np.testing.assert_allclose(poses, read_trajectory(
            one.trajectory_file)[1], atol=1e-4)
        np.testing.assert_allclose(fleet[i].cam_traj, one.cam_traj,
                                   atol=1e-4)
        ids_f, pos_f, _ = load_map(tmp_path / f"map_s{i}.txt")
        ids_s, pos_s, _ = load_map(one.map_file)
        np.testing.assert_array_equal(ids_f, ids_s)
        np.testing.assert_allclose(pos_f, pos_s, atol=2e-3)
    # wrapper calls on CPU tensors do not count; the plain path runs
    assert cuda_mekf.fused_update.launches == launches


def test_run_slam_fleet_matches_jax(stream_files, tmp_path, monkeypatch):
    """The port's fleet against the JAX run_slam's, its vmapped filter
    on the Pallas update (interpret): the slice bound, map ids equal."""
    make_cfg = jrun._mekf_config
    monkeypatch.setattr(jrun, "_mekf_config", lambda *a, **k: make_cfg(
        *a, **k)._replace(pallas_update=True))
    inputs = ",".join(map(str, stream_files))
    for name, mod in (("jax", jrun), ("torch", trun)):
        mod.main(["--input", inputs, "--platform", "cpu",
                  "--trajectory", str(tmp_path / f"{name}.txt"),
                  "--map", str(tmp_path / f"{name}_map.txt")])
    for i in range(2):
        tj = read_trajectory(tmp_path / f"jax_s{i}.txt")[1]
        tt = read_trajectory(tmp_path / f"torch_s{i}.txt")[1]
        np.testing.assert_allclose(tt, tj, atol=2e-3)
        mj = load_map(tmp_path / f"jax_map_s{i}.txt")
        mt = load_map(tmp_path / f"torch_map_s{i}.txt")
        np.testing.assert_array_equal(mt[0], mj[0])
        np.testing.assert_allclose(mt[1], mj[1], atol=2e-3)


@pytest.mark.parametrize("flags,error", [
    (["--slot-max-age", "9"], SystemExit),
    (["--filter", "factorgraph"], SystemExit),
    (["--track-every", "4", "--rescue-cohorts", "3"], ValueError)])
def test_fleet_refusals(tmp_path, flags, error):
    """As the JAX run_slam: recycling and the factor graph refuse with
    several inputs, and rescue cohorts must divide the stream count (a
    check made before any input is read). Nothing runs."""
    with pytest.raises(error):
        trun.main(["--input", "a.npz,b.npz", "--platform", "cpu",
                   "--trajectory", str(tmp_path / "t.txt"),
                   "--map", str(tmp_path / "m.txt"), *flags])
    assert not list(tmp_path.iterdir())
