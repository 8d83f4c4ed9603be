"""PyTorch port vs the JAX package: the image-domain detector.

Rendered 960x540 frames (tests/test_detect.py's camera) go through the
JAX detector and the port stage by stage (`_detect_candidates`'s
``stop=`` hook) and end to end (`detect_markers_batch_lru`). On the CPU
the port runs its kernels' plain versions; the JAX side runs its XLA
paths, or the Pallas kernel in interpret mode where stated.
"""

import itertools

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.ops import detect as jd
from aruco_slam_tpu.ops import pallas_cc, pallas_subpix
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


@pytest.mark.parametrize("shape", [(48, 64), (270, 480), (540, 960)])
def test_flood_labels_plain_matches_interpret(shape):
    """B4's plain version == the Pallas `flood_labels` kernel in
    interpret mode, bit for bit. The JAX kernel expects the 1-px ring
    cleared by its caller; the port clears it itself."""
    rng = np.random.default_rng(9)
    fg = rng.random((2,) + shape) < 0.4
    cleared = fg.copy()
    cleared[:, [0, -1], :] = False
    cleared[:, :, [0, -1]] = False
    got = cuda_cc.flood_labels(torch.tensor(fg), 16)
    assert got.dtype == torch.int32 and got.shape == fg.shape
    for b in range(2):
        want = pallas_cc.flood_labels(jnp.asarray(cleared[b]), 16,
                                      interpret=True)
        np.testing.assert_array_equal(got[b].numpy(), np.asarray(want))


@pytest.mark.parametrize("rounds", [0, 4])
def test_connected_components_dispatch(monkeypatch, rounds):
    """The stencil-only schedule (scan_rounds == 0) goes to B4, every
    other one to B1; both equal the JAX labeling schedule."""
    calls = []

    def spy(name):
        real = getattr(cuda_cc, name)

        def wrapped(*args):
            calls.append(name)
            return real(*args)
        return wrapped

    for name in ("flood_labels", "flood_scan_labels"):
        monkeypatch.setattr(cuda_cc, name, spy(name))
    fg = np.random.default_rng(4).random((1, 130, 100)) < 0.3
    got = td._connected_components(torch.tensor(fg), 16, scan_rounds=rounds)
    assert calls == ["flood_labels" if rounds == 0 else "flood_scan_labels"]
    want = jd._connected_components(jnp.asarray(fg[0]), 16,
                                    scan_rounds=rounds, pallas_mode="off")
    np.testing.assert_array_equal(got[0].numpy(), np.asarray(want))


# the detector's schedule, the tracker's three and refine_corners' default
SCHEDULES = [((6, 6), (3, 4)), ((8, 6),), ((6, 4),), ((3, 4), (2, 2)),
             ((5, 8),)]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_refine_offsets_plain_matches_interpret(rendered, schedule):
    """B5's plain version vs the Pallas `refine_offsets` kernel in
    interpret mode on the same gathered patches: 2e-3 px."""
    frames, corners, mask = rendered
    rng = np.random.default_rng(6)
    seeds = np.concatenate([corners[1][mask[1]].reshape(-1, 2),
                            rng.uniform([20, 20], [940, 520], (8, 2))])
    seeds = (seeds + rng.uniform(-3, 3, seeds.shape)).astype(np.float32)
    rad, sched = cuda_subpix.schedule_params(schedule)
    pts = torch.tensor(seeds[None])
    patches, cx0, cy0 = cuda_subpix.gather_patches(
        torch.tensor(frames[1:2]), pts, rad)
    c0 = cuda_subpix.start_offsets(pts, cx0, cy0, rad)[0]
    got = cuda_subpix.refine_offsets(patches[0], c0, schedule)
    want = pallas_subpix.refine_offsets(jnp.asarray(patches[0].numpy()),
                                        jnp.asarray(c0.numpy()), sched,
                                        interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=2e-3)
    with pytest.raises(ValueError):
        cuda_subpix.refine_offsets(patches[0][:, 1:, 1:], c0, schedule)


def _refine_window_only(patch, c, schedule, clamped):
    """One patch through the refinement as ``csrc/subpix.cu`` sums it:
    each iteration over the (2 half + 1)^2 window alone, clamped to the
    gradient interior [1, p - 2], with its weights from the stage's
    table (the reference's expression on integer offsets). Appends
    (stage, iteration) to ``clamped`` where the clamp cut the window."""
    rad, sched = cuda_subpix.schedule_params(schedule)
    p = 2 * rad + 1
    gx = torch.zeros(p, p)
    gy = torch.zeros(p, p)
    gx[1:-1, 1:-1] = 0.5 * (patch[1:-1, 2:] - patch[1:-1, :-2])
    gy[1:-1, 1:-1] = 0.5 * (patch[2:, 1:-1] - patch[:-2, 1:-1])
    off = torch.arange(p, dtype=torch.float32) - rad
    proj = gx * off[None, :] + gy * off[:, None]
    cx, cy = c[0].clone(), c[1].clone()
    for s, (half, iters, sigma2, drift) in enumerate(sched):
        d = torch.arange(-half, half + 1, dtype=torch.float32)
        table = torch.exp(-0.5 * (d[None, :] ** 2 + d[:, None] ** 2)
                          / sigma2)
        for it in range(iters):
            ox = rad + int(torch.round(cx)) - half
            oy = rad + int(torch.round(cy)) - half
            c0, c1 = max(ox, 1), min(ox + 2 * half, p - 2) + 1
            r0, r1 = max(oy, 1), min(oy + 2 * half, p - 2) + 1
            if (c0, c1, r0, r1) != (ox, ox + 2 * half + 1, oy,
                                    oy + 2 * half + 1):
                clamped.append((s, it))
            c1, r1 = max(c0, c1), max(r0, r1)
            wgt = table[r0 - oy:r1 - oy, c0 - ox:c1 - ox]
            g_x, g_y = gx[r0:r1, c0:c1], gy[r0:r1, c0:c1]
            pj = proj[r0:r1, c0:c1]
            wgx, wgy = wgt * g_x, wgt * g_y
            wxx, wxy = (wgx * g_x).sum(), (wgx * g_y).sum()
            wyy = (wgy * g_y).sum()
            bx, by = (wgx * pj).sum(), (wgy * pj).sum()
            det = wxx * wyy - wxy * wxy
            nx, ny = cx, cy
            if torch.abs(det) > 1e-9:
                nx = (wyy * bx - wxy * by) / det
                ny = (wxx * by - wxy * bx) / det
            nx = torch.clamp(nx, cx - half, cx + half)
            ny = torch.clamp(ny, cy - half, cy + half)
            cx = torch.clamp(nx, -drift, drift)
            cy = torch.clamp(ny, -drift, drift)
    return torch.stack([cx, cy])


@pytest.mark.parametrize("schedule", SCHEDULES + [((16, 3),), ((24, 2),)])
def test_window_only_refinement_matches_plain(rendered, schedule):
    """The kernel's design, in PyTorch: summing only the clamped window
    with a weight table a stage gives the plain loop's offsets (1e-5 px:
    the same terms in another order), on the rendered corners and on
    start offsets of exactly +-(rad - 1), whose first window the clamp
    cuts; the clamp cuts no later window. Also at windows wider than a
    warp (half 16) and patches wider than three (p = 99)."""
    frames, corners, mask = rendered
    rng = np.random.default_rng(11)
    seeds = np.concatenate([corners[2][mask[2]].reshape(-1, 2),
                            rng.uniform([40, 40], [920, 500], (6, 2))])
    seeds = (seeds + rng.uniform(-3, 3, seeds.shape)).astype(np.float32)
    rad, _ = cuda_subpix.schedule_params(schedule)
    pts = torch.tensor(seeds[None])
    patches, cx0, cy0 = cuda_subpix.gather_patches(
        torch.tensor(frames[2:3]), pts, rad)
    patches = patches[0]
    c0 = cuda_subpix.start_offsets(pts, cx0, cy0, rad)[0]
    edge = float(rad - 1)
    corners4 = torch.tensor([[edge, edge], [-edge, edge], [edge, -edge],
                             [-edge, -edge]])
    patches = torch.cat([patches, patches[:4]])
    c0 = torch.cat([c0, corners4])
    want = cuda_subpix.refine_offsets_plain(patches, c0, schedule)
    clamped = []
    got = torch.stack([_refine_window_only(pt, c, schedule, clamped)
                       for pt, c in zip(patches, c0)])
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    assert (0, 0) in clamped and set(clamped) == {(0, 0)}


def test_windows_lie_inside_after_the_first_iteration():
    """For every schedule of 1-4 stages with halves 1-8, every window
    after the first iteration of the first stage lies inside the
    gradient interior [1, p - 2], stage changes included: the estimate
    entering an iteration is clipped to its stage's drift or the previous
    stage's, and `schedule_params` keeps drift + half <= rad - 1 for both.
    Checked on the derived numbers of all 4680 schedules, and on 40
    seeded refinement runs from starts anywhere in the first window's
    range."""
    count = 0
    for stages in range(1, 5):
        for halves in itertools.product(range(1, 9), repeat=stages):
            rad, sched = cuda_subpix.schedule_params(
                tuple((half, 1) for half in halves))
            for s, (half, _, _, drift) in enumerate(sched):
                assert drift + half <= rad - 1
                if s:
                    assert sched[s - 1][3] + half <= rad - 1
            count += 1
    assert count == 8 + 8 ** 2 + 8 ** 3 + 8 ** 4
    rng = np.random.default_rng(15)
    for _ in range(40):
        schedule = tuple((int(rng.integers(1, 9)), int(rng.integers(1, 6)))
                         for _ in range(rng.integers(1, 5)))
        rad, _ = cuda_subpix.schedule_params(schedule)
        p = 2 * rad + 1
        patch = torch.tensor(rng.integers(0, 256, (p, p)),
                             dtype=torch.float32)
        c = torch.tensor(rng.uniform(-1.0, 1.0, 2),
                         dtype=torch.float32) * (rad - 1)
        clamped = []
        _refine_window_only(patch, c, schedule, clamped)
        assert set(clamped) <= {(0, 0)}


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


def _cands(ids, k=8, score0=100):
    """tests/test_recycling.py's synthetic decoded candidates, as numpy:
    (canon, cand_ids, decoded, score); canon carries the id so that the
    slot corners show which candidate landed where."""
    cand_ids = np.full(k, -1, np.int32)
    cand_ids[:len(ids)] = ids
    decoded = cand_ids >= 0
    score = np.where(decoded, score0, 0).astype(np.int32)
    canon = np.broadcast_to(cand_ids[:, None, None], (k, 4, 2)).astype(
        np.float32)
    return canon, cand_ids, decoded, score


def _assign_both(table, seen, frame, max_age, cands):
    want = jd.assign_slots_lru(jnp.asarray(table), jnp.asarray(seen), frame,
                               max_age, *(jnp.asarray(a) for a in cands))
    got = td.assign_slots_lru(torch.tensor(table), torch.tensor(seen), frame,
                              max_age, *(torch.tensor(a) for a in cands))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    return [g.numpy() for g in got]


# tests/test_recycling.py TestAssignSlotsLru's cases: (table, last_seen,
# frame, max_age, candidate ids)
LRU_CASES = {
    "fresh_full_table_drops": ([10, 11], [4, 4], 5, 3, [12]),
    "evicts_stalest": ([10, 11, 12], [8, 2, 5], 10, 3, [77]),
    "free_before_eviction": ([10, -1, 12], [0, 0, 0], 9, 3, [77]),
    "observed_slot_protected": ([10, 11], [0, 5], 20, 3, [10, 77]),
    "age_zero_counts_drops": ([5, -1, -1], [0, 0, 0], 50, 0,
                              [5, 9, 9, 3, 4]),
    "stale_ties_to_lowest_slot": ([3, 4, 5, 6], [1, 7, 1, 1], 30, 5,
                                  [40, 41, 6]),
}


@pytest.mark.parametrize("case", sorted(LRU_CASES))
def test_assign_slots_lru_cases(case):
    """Each eviction rule of tests/test_recycling.py, bit-identical to the
    JAX `assign_slots_lru` (corners, mask, table, last_seen, evicted,
    dropped)."""
    table, seen, frame, max_age, ids = LRU_CASES[case]
    _assign_both(np.asarray(table, np.int32), np.asarray(seen, np.int32),
                 frame, max_age, _cands(ids))


def test_assign_slots_lru_corridor():
    """The corridor of tests/test_recycling.py (128 markers passing a
    64-slot table, max_age 20): every frame's assignment bit-identical
    to JAX, the table recycles (no drop, the last cohort mapped), and at
    max_age 0 the table saturates and counts the drops."""
    n_markers, cap, t_frames = 128, 64, 256
    lm_x = np.arange(n_markers) * 0.25
    cam_x = np.linspace(0.0, 31.0, t_frames)
    for max_age in (20, 0):
        table = np.full(cap, -1, np.int32)
        seen = np.zeros(cap, np.int32)
        dropped = evicted = 0
        for i in range(t_frames):
            vis = np.where(np.abs(lm_x - cam_x[i]) < 2.5)[0]
            _, _, table, seen, ev, dr = _assign_both(
                table, seen, i, max_age, _cands(vis, k=32))
            dropped += int(dr)
            evicted += int(ev.sum())
        if max_age:
            assert dropped == 0 and evicted > 0
            assert table.max() == n_markers - 1
        else:
            assert dropped > 0 and evicted == 0
