"""PyTorch port vs the JAX package: the streaming tracker.

The first 12 frames of a 300-frame (video-rate) orbit, rendered at
960x540 with tests/test_detect.py's camera, go through the JAX tracker
and the port: `track_velocity`, `refine_corners`, `track_markers` with
and without an id->slot table, and the mapped detect-every-K loop of
`streaming_step`. On the CPU the port runs its kernels' plain versions;
the JAX side runs its XLA patch path, which both sides' patch loops
follow term for term.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu_torch.ops import detect as td

torch.set_num_threads(2)

K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
SIZE = (960, 540)
JCFG = jd.DetectorConfig()
TCFG = td.config_from_jax(JCFG._asdict())
# the two sides sum the subpixel structure tensor in different orders
CORNER_ATOL = 1e-3


@pytest.fixture(scope="module")
def video():
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2), jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.Trajectory(*(
        a[:12] for a in synthetic.make_orbit_trajectory(num_frames=300)))
    frames = render.render_sequence(scene, traj, cam, image_size=SIZE)
    gt, vis = synthetic.observe_corners(scene, traj, cam, 64,
                                        image_size=SIZE)
    return frames, gt, vis


def test_median_is_jnp_median():
    """An even count takes the mean of the two middle values; the lower
    median (torch.median) would differ here."""
    x = np.array([[[0.0, 1.0], [4.0, -2.0], [1.0, 5.0], [10.0, 0.5]]],
                 np.float32)
    got = td._median(torch.tensor(x), 1).numpy()
    np.testing.assert_array_equal(got, np.asarray(
        jnp.median(jnp.asarray(x), axis=1, keepdims=True)))
    assert got[0, 0, 0] == 2.5
    assert torch.median(torch.tensor(x), 1).values[0, 0].item() == 1.0


def test_track_velocity_exact():
    rng = np.random.default_rng(11)
    new_c = rng.normal(size=(64, 4, 2)).astype(np.float32) * 3
    old_c = rng.normal(size=(64, 4, 2)).astype(np.float32) * 3
    new_m = rng.random(64) < 0.6
    old_m = rng.random(64) < 0.6
    want = jd.track_velocity(*(jnp.asarray(a)
                               for a in (new_c, new_m, old_c, old_m)))
    got = td.track_velocity(*(torch.tensor(a)
                              for a in (new_c, new_m, old_c, old_m)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert (got.numpy() != 0).any()


def test_refine_corners_matches_jax(video):
    frames, gt, vis = video
    rng = np.random.default_rng(5)
    seeds = np.concatenate([gt[0][vis[0]].reshape(-1, 2),
                            rng.uniform([10, 10], [950, 530], (16, 2))])
    seeds = (seeds + rng.uniform(-2, 2, seeds.shape)).astype(np.float32)
    want = np.asarray(jd.refine_corners(jnp.asarray(frames[0]),
                                        jnp.asarray(seeds)))
    got = td.refine_corners(torch.tensor(frames[0]), torch.tensor(seeds))
    assert got.shape == (len(seeds), 2)
    np.testing.assert_allclose(got.numpy(), want, atol=CORNER_ATOL)
    # the batched form gives the same corners
    both = td.refine_corners(torch.tensor(frames[:2]),
                             torch.tensor(np.stack([seeds, seeds])))
    np.testing.assert_array_equal(both[0].numpy(), got.numpy())
    # and refines: true corners seeded 2 px off come back within 0.5 px
    n = int(vis[0].sum()) * 4
    err = np.abs(got.numpy()[:n] - gt[0][vis[0]].reshape(-1, 2))
    assert np.median(err) < 0.5


@pytest.mark.parametrize("mode", ["slot_is_id", "mapped", "uncompacted"])
def test_track_markers_matches_jax(video, mode):
    """Two tracked frames from a full sweep of frame 0 (the second with
    the velocity prior): masks equal, corners within CORNER_ATOL.
    "slot_is_id" and "mapped" compact to track_slots = 16 of 64 slots."""
    frames = video[0]
    jcfg = JCFG._replace(track_slots=0) if mode == "uncompacted" else JCFG
    tcfg = td.config_from_jax(jcfg._asdict())
    if mode == "mapped":
        det, table = jd.detect_markers_mapped(jnp.asarray(frames[0]), jcfg,
                                              jd.slot_table_init(64))
        kw_j = dict(slot_ids=table)
        kw_t = dict(slot_ids=torch.tensor(np.asarray(table)))
    else:
        det = jd.detect_markers(jnp.asarray(frames[0]), jcfg)
        kw_j, kw_t = {}, {}
    c = np.asarray(det.corners)
    m = np.asarray(det.mask)
    assert m.sum() >= 4
    v = np.zeros_like(c)
    for f in (1, 2):
        jc, jm = jd.track_markers(jnp.asarray(frames[f]), jnp.asarray(c),
                                  jnp.asarray(m), jcfg, jnp.asarray(v),
                                  **kw_j)
        tc, tm = td.track_markers(torch.tensor(frames[f]), torch.tensor(c),
                                  torch.tensor(m), tcfg, torch.tensor(v),
                                  **kw_t)
        jc, jm = np.asarray(jc), np.asarray(jm)
        np.testing.assert_array_equal(tm.numpy(), jm)
        np.testing.assert_allclose(tc.numpy(), jc, atol=CORNER_ATOL)
        assert jm.sum() >= m.sum() - 1
        v = np.asarray(jd.track_velocity(jnp.asarray(jc), jnp.asarray(jm),
                                         jnp.asarray(c), jnp.asarray(m)))
        c, m = jc, jm


def test_streaming_step_mapped_matches_scan(video):
    """The mapped detect-every-K loop at K = 4 against the JAX
    `lax.scan`: tables and masks equal at every frame, corners within
    CORNER_ATOL; frames 2, 3, 6, 7, 10, 11 are tracked."""
    frames = video[0]
    jcr = jd.streaming_init(JCFG, mapped=True)
    jcr, (jcs, jms) = jax.lax.scan(jd.streaming_step(JCFG, 4, mapped=True),
                                   jcr, jnp.asarray(frames))
    step = td.streaming_step(TCFG, 4, mapped=True)
    cr = td.streaming_init(TCFG, mapped=True)
    tcs, tms = [], []
    for im in torch.tensor(frames):
        cr, (c, m) = step(cr, im)
        tcs.append(c)
        tms.append(m)
    jms = np.asarray(jms)
    np.testing.assert_array_equal(torch.stack(tms).numpy(), jms)
    np.testing.assert_allclose(torch.stack(tcs).numpy(), np.asarray(jcs),
                               atol=CORNER_ATOL)
    np.testing.assert_array_equal(cr[3].numpy(), np.asarray(jcr[3]))
    assert cr[4] == len(frames)
    # tracked frames keep what the sweep before them found
    for f in (2, 3, 6, 7, 10, 11):
        assert jms[f].sum() >= max(jms[f - 1].sum() - 1, 3), f

