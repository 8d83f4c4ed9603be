"""PyTorch port vs the JAX package: the stream axis sharded over a mesh.

`parallel.multi_slam.batched_mekf_scan` / `batched_image_slam` with a
stream mesh (a list of devices; here the CPU listed n times) against
JAX's sharded calls on tests/conftest.py's 8 virtual devices, at
tests/test_parallel.py's shapes; `run_slam`'s fleet branch with a
forced mesh; and the kernel wrappers' device guard (`_build.on_device`),
checked on meta tensors, which take the CUDA route of every wrapper
without a card.

Tolerances: a sharded fleet sequence against JAX's within 2e-5 (JAX's
own bound for its sharded fleet against the per-sequence scan,
__graft_entry__.dryrun_multichip; both sides run the 20-step
Newton–Schulz update, JAX's in interpret mode, in f32); the image
fleet within the port's FLEET_TOL (tests/test_torch_multi.py).
"""

import contextlib

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.apps import make_synthetic
from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.filters import mekf as jm
from aruco_slam_tpu.io.sources import save_npz
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu.parallel import make_mesh as jmake_mesh
from aruco_slam_tpu.parallel import multi_slam as jms
from aruco_slam_tpu_torch import _build
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.core import camera as tcam
from aruco_slam_tpu_torch.filters import cuda_mekf
from aruco_slam_tpu_torch.filters import mekf as tm
from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix
from aruco_slam_tpu_torch.ops import detect as td
from aruco_slam_tpu_torch.parallel import multi_slam as tms

torch.set_num_threads(2)

CPU = torch.device("cpu")
KF_TOL = dict(atol=2e-5, rtol=0.0)
FLEET_TOL = dict(atol=1e-4, rtol=0.0)


def _obs_arrays(n_seq=8, frames=20):
    """tests/test_parallel.py's random fleet, cast to f32 by hand."""
    rng = np.random.default_rng(0)
    t_cl = rng.normal(size=(n_seq, frames, 8, 3)) + np.array([0, 0, 3.0])
    q_cl = np.zeros((n_seq, frames, 8, 4))
    q_cl[..., 1] = 1.0
    mask = rng.random((n_seq, frames, 8)) < 0.6
    return t_cl.astype(np.float32), q_cl.astype(np.float32), mask


def _tobs(arrays):
    return tm.FrameObservations(*(torch.tensor(a) for a in arrays))


@pytest.fixture(scope="module")
def jax_fleet():
    """JAX's batched_mekf_scan sharded over its 8 virtual devices, the
    Pallas update in interpret mode."""
    arrays = _obs_arrays()
    jcfg = jm.MekfConfig(capacity=8, pallas_update=True)
    jst = jms.stack_states([jm.init_state(jcfg) for _ in range(8)])
    _, traj = jms.batched_mekf_scan(
        jcfg, jst, jm.FrameObservations(*(jnp.asarray(a) for a in arrays)),
        mesh=jmake_mesh(8))
    return tm.config_from_jax(jcfg._asdict()), arrays, np.asarray(traj)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_sharded_mekf_scan_matches_jax(jax_fleet, n):
    """8 sequences over a stream mesh of n entries: JAX's sharded result
    and the port's unsharded one within KF_TOL; final states stacked in
    stream order on the first entry."""
    cfg, arrays, jtraj = jax_fleet
    states = tms.stack_states([tm.init_state(cfg) for _ in range(8)])
    fin, traj = tms.batched_mekf_scan(cfg, states, _tobs(arrays),
                                      mesh=[CPU] * n)
    assert traj.shape == (8, 20, 7) and fin.cov.shape[0] == 8
    np.testing.assert_allclose(traj.numpy(), jtraj, **KF_TOL)
    one, plain = tms.batched_mekf_scan(cfg, states, _tobs(arrays))
    np.testing.assert_allclose(traj.numpy(), plain.numpy(), **KF_TOL)
    np.testing.assert_array_equal(fin.active.numpy(), one.active.numpy())
    np.testing.assert_allclose(fin.lm.numpy(), one.lm.numpy(), **KF_TOL)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_identical_streams_bit_equal_across_shards(n):
    """One sequence eight times over n shards: every stream's trajectory
    and final covariance bit-equal, whichever shard it ran in."""
    t_cl, q_cl, mask = (np.repeat(a[:1], 8, 0) for a in _obs_arrays())
    cfg = tm.MekfConfig(capacity=8)
    states = tms.stack_states([tm.init_state(cfg) for _ in range(8)])
    fin, traj = tms.batched_mekf_scan(cfg, states, _tobs((t_cl, q_cl, mask)),
                                      mesh=[CPU] * n)
    for s in range(1, 8):
        assert torch.equal(traj[s], traj[0]), s
        assert torch.equal(fin.cov[s], fin.cov[0]), s


def test_sharded_scan_refuses_uneven_split():
    """S not divisible by the mesh size raises, as JAX's sharding does,
    and so do unbatched states."""
    cfg = tm.MekfConfig(capacity=8)
    arrays = _obs_arrays(n_seq=4, frames=3)
    states = tms.stack_states([tm.init_state(cfg) for _ in range(4)])
    with pytest.raises(ValueError, match="split evenly"):
        tms.batched_mekf_scan(cfg, states, _tobs(arrays), mesh=[CPU] * 3)
    with pytest.raises(ValueError):
        tms.batched_mekf_scan(cfg, tm.init_state(cfg), _tobs(arrays),
                              mesh=[CPU] * 2)


def test_stream_mesh(monkeypatch):
    """Every card the process sees for a CUDA device, never a CPU entry;
    the device itself for the CPU."""
    assert tms.stream_mesh(CPU) == [CPU]
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 3)
    assert tms.stream_mesh(torch.device("cuda", 1)) == [
        torch.device("cuda", i) for i in range(3)]


def test_sharded_image_slam_matches_jax():
    """tests/test_parallel.py's pixel fleet (8 identical 480x270 streams
    of 4 frames) over a stream mesh of 4 entries against JAX's sharded
    over 8 devices: identical streams identical across shards, and every
    stream within FLEET_TOL of JAX's. Camera and updates in f32 on both
    sides (the Pallas update in interpret mode)."""
    k = np.array([[700.0, 0.0, 240.0], [0.0, 700.0, 135.0],
                  [0.0, 0.0, 1.0]], np.float32)
    cam = jcam.CameraModel.from_matrix(jnp.asarray(k),
                                       jnp.zeros(5, jnp.float32))
    scene = synthetic.make_wall_scene(num_markers=6, seed=4)
    traj = synthetic.Trajectory(*(
        a[:4] for a in synthetic.make_orbit_trajectory(num_frames=40)))
    frames = render.render_sequence(scene, traj, cam, image_size=(480, 270))
    images = np.broadcast_to(frames, (8,) + frames.shape).copy()
    jdcfg = jd.DetectorConfig(capacity=16, downscale=2, passes=((9, 2),),
                              min_area=12)
    jfcfg = jm.MekfConfig(capacity=16, max_obs=8, pallas_update=True)
    _, jtraj = jms.batched_image_slam(
        jdcfg, jfcfg, cam, scene.marker_size, jnp.asarray(images),
        jms.stack_states([jm.init_state(jfcfg)] * 8), jmake_mesh(8))
    tfcfg = tm.config_from_jax(jfcfg._asdict())
    fin, ttraj = tms.batched_image_slam(
        td.config_from_jax(jdcfg._asdict()), tfcfg,
        tcam.CameraModel.from_matrix(k, np.zeros(5, np.float32)),
        scene.marker_size, torch.tensor(images),
        tms.stack_states([tm.init_state(tfcfg)] * 8), [CPU] * 4)
    assert ttraj.shape == (8, 4, 7) and np.isfinite(ttraj.numpy()).all()
    assert int(fin.active.sum()) > 0, "scene produced no detections"
    assert torch.equal(ttraj[0], ttraj[5])
    np.testing.assert_allclose(ttraj.numpy(), np.asarray(jtraj), **FLEET_TOL)


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


def _fleet(inputs, out, tag):
    return trun.main(["--input", ",".join(map(str, inputs)),
                      "--platform", "cpu", "--max-obs", "16",
                      "--detector", "fast",
                      "--trajectory", str(out / f"{tag}.txt"),
                      "--map", str(out / f"{tag}_map.txt")])


@pytest.mark.parametrize("streams,sharded", [(4, True), (3, False)])
def test_run_slam_shards_as_jax(stream_files, tmp_path, monkeypatch, capsys,
                                streams, sharded):
    """run_slam with a 2-entry stream mesh (as two cards would give)
    shards the filter scan exactly when JAX does (ndev > 1 and S % ndev
    == 0), printing JAX's line; every stream's trajectory file equals the
    unsharded run's."""
    inputs = (stream_files * 2)[:streams]
    want = _fleet(inputs, tmp_path, "one")
    assert "sharding" not in capsys.readouterr().out
    meshes = []

    def two(device):
        meshes.append(device)
        return [device, device]

    monkeypatch.setattr(tms, "stream_mesh", two)
    got = _fleet(inputs, tmp_path, "mesh")
    out = capsys.readouterr().out
    assert meshes == [CPU]
    assert (f"sharding {streams} streams over 2 devices" in out) == sharded
    for i in range(streams):
        a = (tmp_path / f"mesh_s{i}.txt").read_text()
        assert a == (tmp_path / f"one_s{i}.txt").read_text(), i
        assert np.isfinite(read_trajectory(tmp_path / f"mesh_s{i}.txt")[1]
                           ).all()
        np.testing.assert_array_equal(got[i].landmark_ids,
                                      want[i].landmark_ids)
        assert got[i].obs_mask.sum() > 0


# ---------------------------------------------------------------------------
# the wrappers' device guard (repair: launch on the tensors' device)
# ---------------------------------------------------------------------------

def _meta(*shape, dtype=torch.float32):
    return torch.empty(shape, dtype=dtype, device="meta")


WRAPPERS = {
    "flood_scan_labels": lambda: cuda_cc.flood_scan_labels(
        _meta(2, 16, 16, dtype=torch.bool), 4, 1),
    "flood_labels": lambda: cuda_cc.flood_labels(
        _meta(2, 16, 16, dtype=torch.bool), 4),
    "refine_corners": lambda: cuda_subpix.refine_corners(
        _meta(2, 64, 64, dtype=torch.uint8), _meta(2, 4, 2), ((3, 2),)),
    "refine_offsets": lambda: cuda_subpix.refine_offsets(
        _meta(5, 15, 15), _meta(5, 2), ((3, 2),)),
    "fused_update": lambda: cuda_mekf.fused_update(
        _meta(12, 12), _meta(6, 12), _meta(6), _meta(6)),
}


@pytest.mark.parametrize("name", sorted(WRAPPERS))
def test_wrapper_launches_on_its_tensors_device(name, monkeypatch):
    """Every kernel wrapper calls its C entry point inside its tensors'
    device (`_build.on_device`), with that device's stream: the CUDA
    route taken on meta tensors, the device switch, stream and C call
    recorded by stand-ins."""
    entered, calls = [], []

    @contextlib.contextmanager
    def device(dev):
        entered.append(torch.device(dev))
        yield
        entered.pop()

    class Stream:
        def __init__(self, dev):
            self.cuda_stream = 1000 + len(calls)
            self.device = dev

    def call(fn, *args):
        calls.append((list(entered), args[-1].value))

    monkeypatch.setattr(torch.cuda, "device", device)
    monkeypatch.setattr(torch.cuda, "current_stream", Stream)
    monkeypatch.setattr(_build, "check_cuda", lambda *a: None)
    monkeypatch.setattr(_build, "function",
                        lambda *a, **k: (lambda *x: 1))
    monkeypatch.setattr(_build, "call", call)
    wrapper = {"flood_scan_labels": cuda_cc.flood_scan_labels,
               "flood_labels": cuda_cc.flood_labels,
               "refine_corners": cuda_subpix.refine_corners,
               "refine_offsets": cuda_subpix.refine_offsets,
               "fused_update": cuda_mekf.fused_update}[name]
    monkeypatch.setattr(wrapper, "launches", wrapper.launches)
    before = wrapper.launches
    WRAPPERS[name]()
    assert calls == [([torch.device("meta")], 1000)]
    assert wrapper.launches == before + 1


def test_on_device_refuses_mixed_devices():
    """Arguments on more than one device raise ValueError before the
    block runs."""
    ran = []
    with pytest.raises(ValueError, match="more than one device"):
        with _build.on_device(torch.zeros(2), _meta(2)):
            ran.append(True)
    assert not ran
