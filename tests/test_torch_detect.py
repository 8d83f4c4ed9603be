"""PyTorch port vs the JAX package: the image-domain detector.

Rendered 960x540 frames (tests/test_detect.py's camera) go through the
JAX detector and the port stage by stage (`_detect_candidates`'s
``stop=`` hook) and end to end (`detect_markers_batch_lru`). On the CPU
the port runs its kernels' plain versions; the JAX side runs its XLA
paths, or the Pallas kernel in interpret mode where stated.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix
from aruco_slam_tpu_torch.ops import detect as td

torch.set_num_threads(2)

K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
SIZE = (960, 540)
JCFG = jd.DetectorConfig()
TCFG = td.config_from_jax(JCFG._asdict())
# corners: JAX's own two backends agree to 1e-4 px
# (test_detect.py::test_pallas_detect_matches_default); the port sums
# the subpixel structure tensor in another order — 1e-3 px
CORNER_ATOL = 1e-3


@pytest.fixture(scope="module")
def rendered():
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2),
                                       jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    traj = synthetic.Trajectory(*(a[::5] for a in traj))
    frames = render.render_sequence(scene, traj, cam, image_size=SIZE)
    corners, mask = synthetic.observe_corners(scene, traj, cam, 64,
                                              image_size=SIZE)
    return frames, corners, mask


def test_config_from_jax_and_presets():
    assert TCFG == td.DetectorConfig()
    fast = td.with_preset(TCFG, "fast")
    assert fast.passes == jd.with_preset(JCFG, "fast").passes
    assert td.with_preset(TCFG, "robust") is TCFG
    with pytest.raises(ValueError):
        td.with_preset(TCFG, "nope")


@pytest.mark.parametrize("shape,iters,rounds", [
    ((48, 64), 32, 4), ((130, 100), 16, 4), ((270, 480), 32, 4),
    ((540, 960), 16, 4), ((270, 480), 16, 0), ((64, 128), 8, 2)])
def test_flood_plain_bit_identical(shape, iters, rounds):
    """B1's plain version == the JAX XLA labeling path (which
    test_detect.py holds bit-identical to the Pallas kernel)."""
    rng = np.random.default_rng(7)
    fg = rng.random((2,) + shape) < 0.3
    got = cuda_cc.flood_scan_labels(torch.tensor(fg), iters, rounds)
    assert got.dtype == torch.int32 and got.shape == fg.shape
    for b in range(2):
        want = jd._connected_components(jnp.asarray(fg[b]), iters,
                                        scan_rounds=rounds,
                                        pallas_mode="off")
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


def test_subpix_plain_matches_interpret(rendered):
    """B2's plain version vs the Pallas kernel in interpret mode:
    2e-3 px, the bound JAX holds its own two backends to."""
    frames, corners, mask = rendered
    rng = np.random.default_rng(3)
    seeds = np.concatenate([
        corners[0][mask[0]].reshape(-1, 2),
        rng.uniform([20, 20], [940, 520], (12, 2))])
    seeds = (seeds + rng.uniform(-3, 3, seeds.shape)).astype(np.float32)
    sched = ((6, 6), (3, 4))
    want = jd._subpix_refine(jnp.asarray(frames[0]), jnp.asarray(seeds),
                             sched, pallas_mode="interpret")
    got = cuda_subpix.refine_corners(torch.tensor(frames[:1]),
                                     torch.tensor(seeds[None]), sched)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want),
                               atol=2e-3)
    # the f32 image path gives the same refinement
    got32 = cuda_subpix.refine_corners(
        torch.tensor(frames[:1]).float(), torch.tensor(seeds[None]), sched)
    np.testing.assert_allclose(got32.numpy(), got.numpy(), atol=0)


@pytest.mark.parametrize("stop", ["rawpools", "pools"])
def test_pool_stages_exact(rendered, stop):
    """Pools of uint8 frames are exact in f32 on both sides."""
    frames = rendered[0][:2]
    got = td._detect_candidates(torch.tensor(frames), TCFG, stop=stop)
    for b, f in enumerate(frames):
        want = jd._detect_candidates(jnp.asarray(f), JCFG, stop=stop)
        assert len(got) == len(want)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g[b].numpy(), np.asarray(w))


def test_flood_stage_on_detector_masks(rendered):
    """The labeling stage on the detector's own threshold masks. Both
    sides label the SAME fg (built from the JAX pools): the box-mean
    integral image sums f32 past 2**24, so its rounding — and a pixel
    sitting exactly at the threshold — depends on the cumsum order."""
    frames = rendered[0][:2]
    passes = td._passes(TCFG)
    base_ds = max(ds for _, ds in passes)
    for f in frames:
        raw = jd._detect_candidates(jnp.asarray(f), JCFG, stop="rawpools")
        by_ds = dict(zip(sorted({d for _, d in passes}),
                         zip(raw[0::2], raw[1::2])))
        for wf, ds in passes:
            small_min, small_avg = by_ds[ds]
            win = max(3, wf // ds) | 1
            mean = jd._box_mean_multi(small_avg, (win,))[0]
            fg = (small_min < mean - JCFG.thresh_c) \
                & (small_avg < mean - 0.5 * JCFG.thresh_c)
            fine = ds < base_ds
            iters = max(16, JCFG.prop_iters // 2) if fine \
                else JCFG.prop_iters
            want = jd._connected_components(fg, iters, JCFG.scan_rounds,
                                            pallas_mode="off")
            got = td._connected_components(
                torch.tensor(np.asarray(fg))[None], iters,
                TCFG.scan_rounds)
            np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


def test_harvest_stage(rendered):
    """Scores and candidate flags exact; quads of real candidates
    within one label-grid pixel (JAX sorts the harvest unstably, so
    distance ties may pick another pixel of the same extreme)."""
    frames = rendered[0][:3]
    got = td._detect_candidates(torch.tensor(frames), TCFG,
                                stop="harvest")
    for b, f in enumerate(frames):
        quads, score, ok = jd._detect_candidates(jnp.asarray(f), JCFG,
                                                 stop="harvest")
        ok = np.asarray(ok)
        np.testing.assert_array_equal(got[1][b].numpy(), np.asarray(score))
        np.testing.assert_array_equal(got[2][b].numpy(), ok)
        assert ok.any()
        np.testing.assert_allclose(got[0][b].numpy()[ok],
                                   np.asarray(quads)[ok], atol=1.0)


@pytest.mark.parametrize("stop", ["subpix", None])
def test_refine_and_decode_stages(rendered, stop):
    frames = rendered[0][:3]
    got = td._detect_candidates(torch.tensor(frames), TCFG, stop=stop)
    for b, f in enumerate(frames):
        want = [np.asarray(a) for a in
                jd._detect_candidates(jnp.asarray(f), JCFG, stop=stop)]
        if stop == "subpix":
            refined, score, ok = want
            np.testing.assert_array_equal(got[1][b].numpy(), score)
            np.testing.assert_array_equal(got[2][b].numpy(), ok)
            np.testing.assert_allclose(got[0][b].numpy()[ok], refined[ok],
                                       atol=CORNER_ATOL)
        else:
            canon, ids, decoded, score = want
            np.testing.assert_array_equal(got[1][b].numpy(), ids)
            np.testing.assert_array_equal(got[2][b].numpy(), decoded)
            np.testing.assert_array_equal(got[3][b].numpy(), score)
            assert decoded.any()
            np.testing.assert_allclose(got[0][b].numpy()[decoded],
                                       canon[decoded], atol=CORNER_ATOL)


def test_homography_and_sampling(rendered):
    """Decode's geometry on the same refined quads: cell homographies
    to f32 roundoff, sampled bits of real candidates exact."""
    frames = rendered[0][:1]
    refined, _, ok = jd._detect_candidates(jnp.asarray(frames[0]), JCFG,
                                           stop="subpix")
    ok = np.asarray(ok)
    quads = np.asarray(refined)[ok]
    want_h = np.asarray(jd._homography_cells(jnp.asarray(quads), 7))
    got_h = td._homography_cells(torch.tensor(quads), 7).numpy()
    np.testing.assert_allclose(got_h, want_h, rtol=1e-4, atol=1e-3)
    wb, wborder = jd._sample_cells(jnp.asarray(frames[0], jnp.float32),
                                   jnp.asarray(quads), 7)
    gb, gborder = td._sample_cells(torch.tensor(frames).float(),
                                   torch.tensor(quads)[None], 7)
    np.testing.assert_array_equal(gb[0].numpy(), np.asarray(wb))
    np.testing.assert_array_equal(gborder[0].numpy(), np.asarray(wborder))


def test_detect_markers_batch_lru(rendered):
    """The slice's detection entry point: masks, reset flags and the
    id->slot table identical, corners within CORNER_ATOL."""
    frames = rendered[0]
    c = JCFG.capacity
    want = jd.detect_markers_batch_lru(
        jnp.asarray(frames), JCFG, jd.slot_table_init(c),
        jnp.zeros(c, jnp.int32), 0)
    got = td.detect_markers_batch_lru(
        torch.tensor(frames), TCFG, td.slot_table_init(c),
        torch.zeros(c, dtype=torch.int32), 0)
    want = [np.asarray(a) for a in want]
    got = [a.numpy() for a in got]
    slot_c, slot_m = want[0], want[1]
    assert slot_m.sum() >= 10
    np.testing.assert_array_equal(got[1], slot_m)
    np.testing.assert_allclose(got[0], slot_c, atol=CORNER_ATOL)
    for i in range(2, 7):  # reset, ids_seq, table_ids, last_seen, dropped
        np.testing.assert_array_equal(got[i], want[i])


def test_detect_markers_slot_is_id(rendered):
    frames, corners, mask = rendered
    want = jd.detect_markers(jnp.asarray(frames[1]), JCFG)
    got = td.detect_markers(torch.tensor(frames[1]), TCFG)
    np.testing.assert_array_equal(got.mask.numpy(), np.asarray(want.mask))
    np.testing.assert_allclose(got.corners.numpy(),
                               np.asarray(want.corners), atol=CORNER_ATOL)
    # and the detections are right: ids visible, corners near truth
    ids = np.where(got.mask.numpy())[0]
    assert set(ids) <= set(np.where(mask[1])[0]) and len(ids) >= 4
    assert np.abs(got.corners.numpy()[ids] - corners[1][ids]).max() < 1.5


def test_slot_recycling_refused():
    cand = torch.zeros((1, 4, 2))
    with pytest.raises(NotImplementedError, match="not ported yet"):
        td.assign_slots_lru(td.slot_table_init(4),
                            torch.zeros(4, dtype=torch.int32), 0, 5, cand,
                            torch.zeros(1, dtype=torch.int64),
                            torch.ones(1, dtype=torch.bool),
                            torch.ones(1, dtype=torch.int64))
