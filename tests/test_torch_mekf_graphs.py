"""The MEKF scan's CUDA-graph runner (filters/mekf.py `_GraphedStep`),
as far as the CPU reaches it.

On a card `mekf_scan` replays each frame from two CUDA graphs around the
fused update; tests/test_torch_cuda.py holds that path against the eager
one there. Here: the step split where the graphs split it (`_linearize`,
the update, `_correct`) and the runner's static buffers stepped eagerly,
each against `mekf_step` bit for bit; which configs and states take the
runner; and what its cache keys tell apart.
"""

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch.bench import synthetic
from aruco_slam_tpu_torch.filters import cuda_mekf
from aruco_slam_tpu_torch.filters import mekf as tm

torch.set_num_threads(2)

# run_slam's filter settings, the benchmark cells' (capacity 64,
# max_obs 16 at run_slam's default)
RUN_SLAM = dict(motion_model="cv", pixel_sigma=1.0, gate_distance=1.0,
                r_uncertainty=0.005, q_uncertainty_cam=1.0,
                q_error_uncertainty_cam=1.0, q_uncertainty_lm=0.0,
                q_vel=2e-3, vel_decay=0.99)

MODES = {
    "run_slam": dict(capacity=12, max_obs=5, **RUN_SLAM),
    "rotations": dict(capacity=12, max_obs=5, with_rotations=True,
                      **RUN_SLAM),
    "smoothing": dict(capacity=12, max_obs=5, pixel_sigma=1.0,
                      vel_smoothing=0.5, gate_distance=1.0),
    "no_compaction": dict(capacity=12, max_obs=12, **RUN_SLAM),
}


def _sequence(streams, frames, capacity=12, markers=8, extras=False):
    """(T, ...) observations, or (S, T, ...) for ``streams``; with
    ``extras`` an ambiguity and a reset of slot 0 at frame 5."""
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    seqs = []
    for s in range(streams or 1):
        obs = synthetic.observe_poses(scene, traj, capacity, noise_t=0.005,
                                      noise_r=0.005, fov_limit=0.75,
                                      seed=10 + s)
        amb = reset = None
        if extras:
            amb = np.random.default_rng(s).uniform(0.0, 0.8, obs.mask.shape)
            reset = np.zeros(obs.mask.shape, bool)
            reset[5, 0] = True
        seqs.append([obs.t_cl.astype(np.float32),
                     obs.q_cl.astype(np.float32), obs.mask,
                     None if amb is None else amb.astype(np.float32), reset])
    fields = []
    for j in range(5):
        if seqs[0][j] is None:
            fields.append(None)
            continue
        a = np.stack([x[j] for x in seqs]) if streams else seqs[0][j]
        fields.append(torch.tensor(a))
    return tm.FrameObservations(*fields)


def _init(cfg, streams):
    state = tm.init_state(cfg)
    if not streams:
        return state
    return tm.MekfState(*(torch.stack([x] * streams) for x in state))


def _split_step(cfg, state, obs):
    """The step as the runner splits it: `_linearize`, the update,
    `_correct`."""
    pred, h, r, e, prev_t = tm._linearize(cfg, state, obs)
    inn, cov = cuda_mekf.fused_update(pred.cov, h, r, e,
                                      ns_iters=cfg.ns_iters)
    return tm._correct(cfg, pred, inn, cov, prev_t)


def _assert_equal(got, want):
    for name, a, b in zip(tm.MekfState._fields, got, want):
        assert torch.equal(a, b), name


@pytest.mark.parametrize("streams", [None, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_split_step_is_the_step(mode, streams):
    """`_linearize`, the update and `_correct` over 24 frames (slot
    resets and ambiguities among them): `mekf_step`'s state bit for
    bit."""
    cfg = tm.MekfConfig(**MODES[mode])
    obs = _sequence(streams, 24, extras=True)
    axis = 1 if streams else 0
    want = got = _init(cfg, streams)
    for i in range(24):
        frame = tm._frame(obs, i, axis)
        want = tm.mekf_step(cfg, want, frame)
        got = _split_step(cfg, got, frame)
    _assert_equal(got, want)
    assert int(want.active.sum()) > 0


@pytest.mark.parametrize("streams", [None, 3])
@pytest.mark.parametrize("mode", list(MODES))
def test_runner_buffers_step_as_mekf_step(mode, streams):
    """A runner's static buffers stepped eagerly (a frame's packed
    observations copied in, graph A's work, the update, graph B's), its
    state reloaded after 8 of 20 frames as `mekf_scan` does at a new
    chunk: every pose and the final state bit for bit what `mekf_step`
    gives."""
    cfg = tm.MekfConfig(**MODES[mode])
    obs = _sequence(streams, 20, extras=True)
    axis = 1 if streams else 0
    want = _init(cfg, streams)
    run = tm._GraphedStep(cfg, want, tm._frame(obs, 0, axis), None)
    state = want
    for lo, hi in ((0, 8), (8, 20)):
        tm._assign(run.state, state)
        packed = run.pack(tm.FrameObservations(*(
            None if x is None else x.narrow(axis, lo, hi - lo)
            for x in obs)), axis)
        for i in range(lo, hi):
            want = tm.mekf_step(cfg, want, tm._frame(obs, i, axis))
            run.packed.copy_(packed[i - lo])
            run.predict()
            run.update()
            run.correct()
            assert torch.equal(run.pose, tm.camera_pose(want))
        state = tm.MekfState(*(x.clone() for x in run.state))
    _assert_equal(state, want)


@pytest.mark.parametrize("field,value", [
    (None, None), ("update_kernel", False), ("cov_dtype", torch.bfloat16),
    ("joseph_form", False)])
def test_runner_never_chosen_here(field, value):
    """A CPU state never takes the runner, whatever the config (nor, on a
    card, one whose update is the XLA form): the counters stay 0 and the
    scan is the `mekf_step` loop bit for bit."""
    mode = dict(MODES["run_slam"])
    if field is not None:
        mode[field] = value
    cfg = tm.MekfConfig(**mode)
    assert tm._validate(cfg) == (field is None)
    obs = _sequence(None, 10)
    state = tm.init_state(cfg)
    assert not tm._graphable(cfg, state)
    before = (tm.mekf_scan.captures, tm.mekf_scan.graph_steps,
              tm.mekf_scan.eager_steps)
    fin, traj = tm.mekf_scan(cfg, state, obs)
    assert (tm.mekf_scan.captures, tm.mekf_scan.graph_steps,
            tm.mekf_scan.eager_steps) == before
    poses = []
    for i in range(10):
        state = tm.mekf_step(cfg, state, tm._frame(obs, i, 0))
        poses.append(tm.camera_pose(state))
    assert torch.equal(traj, torch.stack(poses))
    _assert_equal(fin, state)


def test_runner_keys_tell_apart_what_the_graphs_fix():
    """Configs, the stream count, the optional fields and the stream the
    graphs replay on give their own runners; the sequence length does
    not."""
    cfg = tm.MekfConfig(**MODES["run_slam"])

    def key(cfg, streams, frames=6, extras=False, stream=None):
        obs = _sequence(streams, frames, extras=extras)
        return tm._runner_key(cfg, _init(cfg, streams),
                              tm._frame(obs, 0, 1 if streams else 0), stream)

    base = key(cfg, None)
    assert key(cfg, None, frames=9) == base
    assert key(cfg, 3) == key(cfg, 3, frames=11)
    others = [key(cfg._replace(vel_decay=1.0), None),
              key(cfg._replace(max_obs=4), None), key(cfg, 3), key(cfg, 2),
              key(cfg, None, extras=True), key(cfg, None, stream="other")]
    obs = _sequence(None, 6, extras=True)
    for drop in ("ambiguity", "reset"):
        frame = tm._frame(obs._replace(**{drop: None}), 0, 0)
        others.append(tm._runner_key(cfg, tm.init_state(cfg), frame))
    assert len({base, *others}) == len(others) + 1


def test_fused_update_writes_into_out():
    """``out`` takes the update's results (the runner's fixed
    buffers) and is what the call returns."""
    rng = np.random.default_rng(0)
    n, m = 30, 12
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    args = [torch.tensor(x, dtype=torch.float32) for x in (
        a @ a.T * 0.05 + 0.01 * np.eye(n), rng.normal(size=(m, n)) * 0.3,
        rng.uniform(1e-3, 1e-2, m), 0.01 * rng.normal(size=m))]
    want = cuda_mekf.fused_update(*args)
    out = (torch.empty(n), torch.empty(n, n))
    got = cuda_mekf.fused_update(*args, out=out)
    assert got[0] is out[0] and got[1] is out[1]
    for g, w in zip(got, want):
        assert torch.equal(g, w)
