"""PyTorch port vs the JAX package: fleet streaming.

S video streams step together through the detect-every-K tracker: the
stream axis of `track_velocity` and `track_markers`, the fleet steps
`detect_or_track_batch[_mapped]`, `streaming_step(streams=S)` with one
schedule (G = 0) and with G staggered rescue cohorts, and `run_slam
--input a,b --track-every K [--rescue-cohorts G]`. The streams are cut
from the first 12 frames of a 300-frame (video-rate) orbit at 960x540
(tests/test_torch_tracking.py's), each a different window of it, one
reversed. On the CPU the port runs its kernels' plain versions; the
JAX side runs its XLA paths (its Pallas update in interpret mode for
run_slam). Corners agree within CORNER_ATOL; masks, slot tables and
frame indices are bit-identical.
"""

import functools

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.io import load_map
from aruco_slam_tpu.io.sources import save_npz
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.ops import detect as td

torch.set_num_threads(2)

K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
JCFG = jd.DetectorConfig()
TCFG = td.config_from_jax(JCFG._asdict())
# the two sides sum the subpixel structure tensor in different orders
CORNER_ATOL = 1e-3
KE = 4


@pytest.fixture(scope="module")
def video():
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2), jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.Trajectory(*(
        a[:12] for a in synthetic.make_orbit_trajectory(num_frames=300)))
    frames = render.render_sequence(scene, traj, cam, image_size=(960, 540))
    return frames, traj, scene.marker_size


def _streams(frames):
    """Four 8-frame streams (S, T, H, W): two windows of the orbit
    forward, two reversed."""
    return np.stack([frames[:8], frames[4:12], frames[11:3:-1],
                     frames[7::-1]])


def _sweep(frames, mapped):
    """Frame 0 of every stream through the JAX detector: (corners, mask,
    tables or None) numpy."""
    jim = jnp.asarray(frames)
    if mapped:
        det, tab = jax.vmap(lambda im: jd.detect_markers_mapped(
            im, JCFG, jd.slot_table_init(64)))(jim)
        return np.asarray(det.corners), np.asarray(det.mask), np.asarray(tab)
    det = jax.vmap(lambda im: jd.detect_markers(im, JCFG))(jim)
    return np.asarray(det.corners), np.asarray(det.mask), None


def test_track_velocity_stream_axis_exact():
    """(S, C, 4, 2): the median over each marker's 4 corners of each
    stream, against `jax.vmap(track_velocity)` (streams differ)."""
    rng = np.random.default_rng(3)
    new_c, old_c = (rng.normal(size=(3, 64, 4, 2)).astype(np.float32) * 3
                    for _ in range(2))
    new_m, old_m = (rng.random((3, 64)) < 0.6 for _ in range(2))
    want = jax.vmap(jd.track_velocity)(*(
        jnp.asarray(a) for a in (new_c, new_m, old_c, old_m)))
    got = td.track_velocity(*(torch.tensor(a)
                              for a in (new_c, new_m, old_c, old_m)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy()[1] != got.numpy()[0]).any()


@pytest.mark.parametrize("mode", ["slot_is_id", "mapped", "uncompacted"])
def test_track_markers_streams_match_vmap(video, mode):
    """Three streams tracked from their own full sweeps for two frames,
    as one batch, against `jax.vmap(track_markers)`: masks equal,
    corners within CORNER_ATOL; "slot_is_id" and "mapped" compact each
    stream to track_slots = 16 of 64 slots."""
    seq = _streams(video[0])[:3]
    jcfg = JCFG._replace(track_slots=0) if mode == "uncompacted" else JCFG
    tcfg = td.config_from_jax(jcfg._asdict())
    c, m, tab = _sweep(seq[:, 0], mode == "mapped")
    assert (m.sum(-1) >= 4).all() and not (m[0] == m[2]).all()
    ids = np.broadcast_to(np.arange(64), m.shape) if tab is None else tab
    track = jax.vmap(lambda im, c_, m_, v_, t_: jd.track_markers(
        im, c_, m_, jcfg, v_, t_))
    v = np.zeros_like(c)
    for f in (1, 2):
        jc, jm = (np.asarray(x) for x in track(
            *(jnp.asarray(a) for a in (seq[:, f], c, m, v, ids))))
        kw = {} if tab is None else dict(slot_ids=torch.tensor(tab))
        tc, tm = td.track_markers(*(torch.tensor(a) for a in (
            seq[:, f], c, m)), tcfg, torch.tensor(v), **kw)
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_allclose(tc.numpy(), jc, atol=CORNER_ATOL)
        assert (jm.sum(-1) >= 3).all()
        v = np.asarray(jax.vmap(jd.track_velocity)(
            jnp.asarray(jc), jnp.asarray(jm), jnp.asarray(c),
            jnp.asarray(m)))
        c, m = jc, jm


@pytest.mark.parametrize("mapped", [False, True])
def test_detect_or_track_batch_matches_jax(video, mapped):
    """One full fleet frame, then two tracked ones, through the JAX
    `detect_or_track_batch[_mapped]` and the port's: masks, velocities'
    support and tables equal, corners within CORNER_ATOL."""
    seq = _streams(video[0])[:3]
    s = len(seq)
    jfn = jax.jit(jd.detect_or_track_batch_mapped if mapped
                  else jd.detect_or_track_batch, static_argnums=(6 if mapped
                                                                 else 5,))
    tfn = td.detect_or_track_batch_mapped if mapped \
        else td.detect_or_track_batch
    jst = (jnp.zeros((s, 64, 4, 2), jnp.float32), jnp.zeros((s, 64), bool),
           jnp.zeros((s, 64, 4, 2), jnp.float32))
    tst = tuple(torch.tensor(np.asarray(x)) for x in jst)
    if mapped:
        jst += (jd.slot_table_init(64, s),)
        tst += (td.slot_table_init(64, streams=s),)
    for f, full in ((0, True), (1, False), (2, False)):
        jst = jfn(jnp.asarray(seq[:, f]), *jst, jnp.asarray(full), JCFG)
        tst = tfn(torch.tensor(seq[:, f]), *tst, full, TCFG)
        np.testing.assert_array_equal(tst[1].numpy(), np.asarray(jst[1]))
        for j in (0, 2):
            np.testing.assert_allclose(tst[j].numpy(), np.asarray(jst[j]),
                                       atol=CORNER_ATOL)
        if mapped:
            np.testing.assert_array_equal(tst[3].numpy(), np.asarray(jst[3]))
    assert (tst[1].numpy().sum(-1) >= 4).all()


def _scan_jax(seq, cohorts, mapped):
    step = jd.streaming_step(JCFG, KE, streams=len(seq), mapped=mapped,
                             rescue_cohorts=cohorts)
    cr = jd.streaming_init(JCFG, streams=len(seq), mapped=mapped)
    cr, (cs, ms) = jax.lax.scan(
        step, cr, jnp.asarray(np.swapaxes(seq, 0, 1), jnp.float32))
    return cr, np.asarray(cs), np.asarray(ms)


def _scan_torch(seq, cohorts, mapped, step=None):
    step = step or td.streaming_step(TCFG, KE, streams=len(seq),
                                     mapped=mapped, rescue_cohorts=cohorts)
    cr = td.streaming_init(TCFG, streams=len(seq), mapped=mapped)
    cs, ms = [], []
    for im in torch.tensor(np.swapaxes(seq, 0, 1), dtype=torch.float32):
        cr, (c, m) = step(cr, im)
        cs.append(c)
        ms.append(m)
    return cr, torch.stack(cs), torch.stack(ms)


@pytest.mark.parametrize("cohorts,mapped", [(0, True), (0, False),
                                            (2, True), (2, False)])
def test_streaming_step_fleet_matches_scan(video, cohorts, mapped):
    """`streaming_step(streams=4)` at K = 4, one schedule (G = 0) or two
    staggered cohorts (G = 2), against the JAX `lax.scan`: masks (and
    tables) equal at every frame, corners within CORNER_ATOL, the frame
    index in the carry."""
    seq = _streams(video[0])
    jcr, jcs, jms = _scan_jax(seq, cohorts, mapped)
    tcr, tcs, tms = _scan_torch(seq, cohorts, mapped)
    np.testing.assert_array_equal(tms.numpy(), jms)
    np.testing.assert_allclose(tcs.numpy(), jcs, atol=CORNER_ATOL)
    if mapped:
        np.testing.assert_array_equal(tcr[3].numpy(), np.asarray(jcr[3]))
    assert tcr[-1] == int(jcr[-1]) == seq.shape[1]
    assert (jms.sum(-1) >= 3).all()


def test_fleet_cohort_rescue(video):
    """tests/test_detect.py's test_fleet_cohort_rescue on the port: a
    stream that loses every marker mid-period re-acquires at the next
    frame with G = 2 (its cohort's dead-stream sweep) and stays blind
    until the next scheduled sweep with G = 0; masks equal to JAX's."""
    frames = video[0]
    ke, t = 8, 7
    s0 = np.stack([frames[0]] * t)
    s1 = s0.copy()
    s1[2:4] = 178  # background gray: stream 1 blanks at frames 2, 3
    seq = np.stack([s0, s1])
    masks = {}
    for g in (2, 0):
        step = td.streaming_step(TCFG, ke, streams=2, rescue_cohorts=g)
        _, _, tm = _scan_torch(seq, g, False, step)
        jstep = jd.streaming_step(JCFG, ke, streams=2, rescue_cohorts=g)
        _, (_, jm) = jax.lax.scan(
            jstep, jd.streaming_init(JCFG, streams=2),
            jnp.asarray(np.swapaxes(seq, 0, 1), jnp.float32))
        np.testing.assert_array_equal(tm.numpy(), np.asarray(jm))
        masks[g] = tm.numpy()
    m = masks[2]
    assert m[1, 1].any() and not m[3, 1].any()
    assert m[4, 1].any(), "cohort rescue must re-acquire at frame 4"
    assert m[4, 0].sum() >= m[1, 0].sum() - 1
    assert not masks[0][4:, 1].any()


def _per_cohort_step(cohorts, streams, mapped):
    """The JAX `_cohort_step`'s structure on the port: one branch per
    cohort, each on that cohort's streams alone."""
    per = streams // cohorts
    fwd = td.detect_or_track_batch_mapped if mapped \
        else td.detect_or_track_batch

    def step(cr, im):
        state, i = cr[:-1], cr[-1]
        parts = []
        for g in range(cohorts):
            sl = slice(g * per, (g + 1) * per)
            due = ((i + g * KE // cohorts) % KE) < 2 \
                or bool((~state[1][sl].any(-1)).any())
            parts.append(fwd(im[sl], *(x[sl] for x in state), due, TCFG))
        out = tuple(torch.cat(xs) for xs in zip(*parts))
        return (*out, i + 1), out[:2]

    return step


@pytest.mark.parametrize("cohorts,mapped", [(2, True), (4, False)])
def test_cohort_batching_bit_identical(video, cohorts, mapped):
    """One sweep batch and one tracked batch a frame give every stream
    exactly what one branch per cohort gives it; each frame runs at most
    one candidate sweep (B1's three calls) and one tracked batch."""
    from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix
    seq = _streams(video[0])
    calls = []
    real = (cuda_cc.flood_scan_labels, cuda_subpix.refine_corners)

    def counting(fn, name):
        @functools.wraps(fn)
        def wrapped(*a, **k):
            calls[-1][name] += 1
            return fn(*a, **k)
        return wrapped

    step = td.streaming_step(TCFG, KE, streams=4, mapped=mapped,
                             rescue_cohorts=cohorts)

    def counted(cr, im):
        calls.append({"b1": 0, "b2": 0})
        return step(cr, im)

    try:
        cuda_cc.flood_scan_labels = counting(real[0], "b1")
        cuda_subpix.refine_corners = counting(real[1], "b2")
        got = _scan_torch(seq, cohorts, mapped, counted)
    finally:
        cuda_cc.flood_scan_labels, cuda_subpix.refine_corners = real
    want = _scan_torch(seq, cohorts, mapped,
                       _per_cohort_step(cohorts, 4, mapped))
    for g, w in zip((*got[0][:-1], *got[1:]), (*want[0][:-1], *want[1:])):
        assert torch.equal(g, w)
    assert got[0][-1] == want[0][-1] == seq.shape[1]
    assert all(c["b1"] in (0, 3) and c["b2"] <= 4 for c in calls), calls
    # past frame 0, every frame has a cohort sweeping and one tracking
    assert all(c == {"b1": 3, "b2": 4} for c in calls[1:]), calls


def test_rescue_cohorts_must_divide_streams():
    for step in (jd.streaming_step, td.streaming_step):
        cfg = JCFG if step is jd.streaming_step else TCFG
        with pytest.raises(ValueError, match="rescue_cohorts=3 must divide "
                                             "streams=4"):
            step(cfg, KE, streams=4, rescue_cohorts=3)


@pytest.fixture(scope="module")
def fleet_files(video, tmp_path_factory):
    """Two 8-frame video-rate npz streams: the orbit's first 8 frames,
    and frames 11 down to 4."""
    frames, traj, marker_size = video
    root = tmp_path_factory.mktemp("fleet")
    paths = []
    for name, idx in (("fwd", np.arange(8)), ("rev", np.arange(11, 3, -1))):
        paths.append(root / f"{name}.npz")
        save_npz(paths[-1], times=traj.times[:8], images=frames[idx],
                 gt_cam_t=traj.cam_t[idx], camera_matrix=K2,
                 dist_coeffs=DIST, marker_size=np.float64(marker_size))
    return paths


def _fleet_argv(paths, out, *flags):
    return ["--input", ",".join(map(str, paths)), "--platform", "cpu",
            "--track-every", str(KE), "--max-obs", "16",
            "--trajectory", str(out / "traj.txt"),
            "--map", str(out / "map.txt"), *flags]


@pytest.mark.parametrize("cohorts", [0, 2])
def test_run_slam_fleet_streaming_matches_jax(fleet_files, tmp_path,
                                              monkeypatch, cohorts):
    """`run_slam --input a,b --track-every 4 [--rescue-cohorts 2]`
    against the JAX run_slam (its filter on the Pallas update in
    interpret mode, its chunk cut to the 8 frames so it pads none):
    trajectories within 2e-3 m, map ids equal."""
    make_cfg = jrun._mekf_config
    monkeypatch.setattr(jrun, "_mekf_config", lambda *a, **k: make_cfg(
        *a, **k)._replace(pallas_update=True))
    monkeypatch.setattr(jrun, "run_multi_stream", functools.partial(
        jrun.run_multi_stream, chunk=8))
    flags = ["--rescue-cohorts", str(cohorts)]
    for name, mod in (("jax", jrun), ("torch", trun)):
        (tmp_path / name).mkdir()
        res = mod.main(_fleet_argv(fleet_files, tmp_path / name, *flags))
    assert all(r.ate < 0.3 for r in res)
    for i in range(2):
        tj = read_trajectory(tmp_path / "jax" / f"traj_s{i}.txt")[1]
        tt = read_trajectory(tmp_path / "torch" / f"traj_s{i}.txt")[1]
        assert tt.shape == tj.shape == (8, 7)
        np.testing.assert_allclose(tt, tj, atol=2e-3)
        mj = load_map(tmp_path / "jax" / f"map_s{i}.txt")
        mt = load_map(tmp_path / "torch" / f"map_s{i}.txt")
        np.testing.assert_array_equal(mt[0], mj[0])
        np.testing.assert_allclose(mt[1], mj[1], atol=2e-3)


def test_run_slam_fleet_streaming_matches_single(fleet_files, tmp_path,
                                                 monkeypatch):
    """With one schedule (G = 0) each fleet stream is within 1e-4 m of
    its own single-stream --track-every 4 run, with the same map ids —
    once that run is shown never to have swept off the schedule (its
    ~mask.any() rescue, which the fleet does not have)."""
    fleet = trun.main(_fleet_argv(fleet_files, tmp_path))
    real = td.streaming_step
    rescued = []

    def recording(cfg, ke, **kw):
        step = real(cfg, ke, **kw)

        def recorded(cr, im):
            if cr[-1] % ke >= 2 and not bool(cr[1].any()):
                rescued.append(cr[-1])
            return step(cr, im)
        return recorded

    monkeypatch.setattr(td, "streaming_step", recording)
    for i, path in enumerate(fleet_files):
        one = trun.main(["--input", str(path), "--platform", "cpu",
                         "--track-every", str(KE), "--max-obs", "16",
                         "--trajectory", str(tmp_path / f"one{i}.txt"),
                         "--map", str(tmp_path / f"one{i}_map.txt")])
        assert not rescued
        np.testing.assert_array_equal(fleet[i].obs_mask, one.obs_mask)
        np.testing.assert_allclose(fleet[i].cam_traj, one.cam_traj,
                                   atol=1e-4)
        np.testing.assert_array_equal(fleet[i].landmark_ids,
                                      one.landmark_ids)


def test_run_slam_fleet_streaming_chunks(fleet_files, tmp_path, monkeypatch):
    """The fleet's streaming carry (cohort schedules included) crosses
    a chunk boundary that falls mid-period: chunks of 5 frames give what
    one chunk gives."""
    real = trun.run_multi_stream
    out = []
    for chunk in (32, 5):
        monkeypatch.setattr(trun, "run_multi_stream",
                            functools.partial(real, chunk=chunk))
        (tmp_path / str(chunk)).mkdir()
        out.append(trun.main(_fleet_argv(fleet_files, tmp_path / str(chunk),
                                         "--rescue-cohorts", "2")))
    for a, b in zip(*out):
        np.testing.assert_array_equal(a.obs_mask, b.obs_mask)
        np.testing.assert_allclose(a.cam_traj, b.cam_traj, atol=1e-5)
