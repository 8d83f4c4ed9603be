"""The port's CUDA kernels against their plain PyTorch versions, on a card.

A CUDA kernel has no CPU mode, so every test here is marked ``cuda``
and skips without a device. On a machine with a card (no jax needed):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_cuda.py
"""

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch.filters import cuda_mekf
from aruco_slam_tpu_torch.ops import cuda_cc, cuda_subpix

pytestmark = pytest.mark.cuda


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernels have no CPU mode")
    return torch.device("cuda")


@pytest.mark.parametrize("shape,iters,rounds", [
    ((3, 48, 64), 32, 4), ((2, 130, 100), 16, 4), ((4, 270, 480), 16, 4),
    ((2, 540, 960), 16, 4), ((2, 270, 480), 16, 0), ((1, 64, 128), 8, 2)])
def test_flood_scan_bit_identical(device, shape, iters, rounds):
    rng = np.random.default_rng(7)
    fg = torch.from_numpy(rng.random(shape) < 0.4).to(device)
    before = cuda_cc.flood_scan_labels.launches
    got = cuda_cc.flood_scan_labels(fg, iters, rounds)
    assert cuda_cc.flood_scan_labels.launches == before + 1
    want = cuda_cc.flood_scan_labels_plain(fg, iters, rounds)
    assert torch.equal(got, want)


def _serpentine(h, w, transpose=False):
    """A one-pixel-wide path that runs along every fourth row (or
    column) and turns at alternate ends, across many warp tiles and scan
    chunks."""
    if transpose:
        return _serpentine(w, h).T
    fg = np.zeros((h, w), bool)
    fg[1:h - 1:4, 1:w - 1] = True
    for k, y in enumerate(range(1, h - 4, 4)):
        x = w - 2 if k % 2 == 0 else 1
        fg[y:y + 5, x] = True
    return fg


@pytest.mark.parametrize("shape", [(3, 37, 1001), (1, 1079, 1917)])
def test_flood_scan_ragged_grids_bit_identical(device, shape):
    """Grids whose sides cut the warp tiles, the scan chunks and the
    column groups raggedly."""
    rng = np.random.default_rng(9)
    fg = torch.from_numpy(rng.random(shape) < 0.45).to(device)
    got = cuda_cc.flood_scan_labels(fg, 16, 4)
    assert torch.equal(got, cuda_cc.flood_scan_labels_plain(fg, 16, 4))


@pytest.mark.parametrize("kind", ["all_fg", "all_bg", "serpentine_rows",
                                  "serpentine_cols"])
def test_flood_scan_extreme_masks_bit_identical(device, kind):
    h, w = 403, 1000
    if kind == "all_fg":
        fg = np.ones((2, h, w), bool)
    elif kind == "all_bg":
        fg = np.zeros((2, h, w), bool)
    else:
        fg = _serpentine(h, w, kind == "serpentine_cols")[None]
    fg = torch.from_numpy(fg).to(device)
    for iters, rounds in ((16, 4), (32, 2)):
        got = cuda_cc.flood_scan_labels(fg, iters, rounds)
        assert torch.equal(got, cuda_cc.flood_scan_labels_plain(
            fg, iters, rounds))
    if kind == "all_bg":
        assert bool((got == h * w).all())


@pytest.mark.parametrize("shape,iters", [
    ((3, 48, 64), 16), ((4, 270, 480), 16), ((2, 540, 960), 16),
    ((2, 64, 128), 5), ((1, 33, 47), 0), ((2, 100, 70), 23)])
def test_flood_labels_bit_identical(device, shape, iters):
    rng = np.random.default_rng(8)
    fg = torch.from_numpy(rng.random(shape) < 0.4).to(device)
    before = cuda_cc.flood_labels.launches
    got = cuda_cc.flood_labels(fg, iters)
    assert cuda_cc.flood_labels.launches == before + 1
    want = cuda_cc.flood_labels_plain(fg, iters)
    assert torch.equal(got, want)


def _stencil_masks(kind):
    """B1's grids and extreme masks for the stencil-only schedule."""
    rng = np.random.default_rng(10)
    if kind == "ragged_small":
        return rng.random((3, 37, 1001)) < 0.45
    if kind == "ragged_large":
        return rng.random((1, 1079, 1917)) < 0.45
    if kind == "all_fg":
        return np.ones((2, 403, 1000), bool)
    if kind == "all_bg":
        return np.zeros((2, 403, 1000), bool)
    return _serpentine(403, 1000, kind == "serpentine_cols")[None]


@pytest.mark.parametrize("per_launch", [None, 8, 6, 4])
@pytest.mark.parametrize("kind", ["ragged_small", "ragged_large", "all_fg",
                                  "all_bg", "serpentine_rows",
                                  "serpentine_cols"])
def test_flood_labels_masks_and_splits_bit_identical(device, kind,
                                                     per_launch):
    """The stencil-only schedule on B1's register warp tiles: ragged
    grids and extreme masks, at the entry point's own rounds a launch
    (None, counted once) and forced to at most 8, 6 and 4 (not
    counted)."""
    fg = torch.from_numpy(_stencil_masks(kind)).to(device)
    before = cuda_cc.flood_labels.launches
    for iters in (16, 13):
        if per_launch is None:
            got = cuda_cc.flood_labels(fg, iters)
        else:
            got = cuda_cc.flood_labels_split(fg, iters, per_launch)
        assert torch.equal(got, cuda_cc.flood_labels_plain(fg, iters))
    assert cuda_cc.flood_labels.launches == before + 2 * (per_launch is None)
    if kind == "all_bg":
        assert bool((got == fg.shape[1] * fg.shape[2]).all())


def _smooth_image(rng, device, dtype=torch.uint8):
    img = torch.from_numpy(rng.integers(0, 256, (2, 240, 320),
                                        dtype=np.uint8)).to(device)
    return torch.nn.functional.avg_pool2d(
        img[:, None].float(), 5, 1, 2)[:, 0].to(dtype)  # smooth corners


# the detector's schedule, the tracker's three and refine_corners' default
SCHEDULES = [((6, 6), (3, 4)), ((8, 6),), ((6, 4),), ((3, 4), (2, 2)),
             ((5, 8),)]


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_subpix_schedules_match_plain(device, schedule):
    rng = np.random.default_rng(4)
    img = _smooth_image(rng, device)
    seeds = torch.tensor(rng.uniform([0, 0], [319, 239], (2, 64, 2)),
                         dtype=torch.float32, device=device)
    got = cuda_subpix.refine_corners(img, seeds, schedule)
    want = cuda_subpix.refine_corners_plain(img, seeds, schedule)
    assert (got - want).abs().max().item() <= 2e-3  # px, reassociation


@pytest.mark.parametrize("schedule", SCHEDULES[1:4])
def test_subpix_tracker_pull_matches_plain(device, schedule):
    """B2 at the tracker's real call: one frame, 64 corners (16 slots x
    4), each of its three schedules; one launch counted."""
    rng = np.random.default_rng(12)
    img = _smooth_image(rng, device)[:1]
    seeds = torch.tensor(rng.uniform([0, 0], [319, 239], (1, 64, 2)),
                         dtype=torch.float32, device=device)
    before = cuda_subpix.refine_corners.launches
    got = cuda_subpix.refine_corners(img, seeds, schedule)
    assert cuda_subpix.refine_corners.launches == before + 1
    want = cuda_subpix.refine_corners_plain(img, seeds, schedule)
    assert (got - want).abs().max().item() <= 2e-3


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_subpix_at_the_patch_edge_matches_plain(device, schedule):
    """B2 on corners within rad of the frame border (the patch clipped
    into the frame, the start clipped to +-(rad - 1)) and B5 from start
    offsets of exactly +-(rad - 1): the first window leaves the gradient
    interior and is clamped."""
    rng = np.random.default_rng(13)
    img = _smooth_image(rng, device)
    rad, _ = cuda_subpix.schedule_params(schedule)
    h, w = img.shape[1:]
    near = rng.uniform(-2.0, rad, (2, 48, 2))
    far = np.array([w - 1, h - 1]) - rng.uniform(-2.0, rad, (2, 48, 2))
    pick = rng.random((2, 48, 2)) < 0.5
    edge = np.where(pick, near, far)
    inner = rng.uniform([0, 0], [w - 1, h - 1], (2, 48, 2))
    edge[:, ::2, 1] = inner[:, ::2, 1]   # one side at the border
    seeds = torch.tensor(edge, dtype=torch.float32, device=device)
    want = cuda_subpix.refine_corners_plain(img, seeds, schedule)
    got = cuda_subpix.refine_corners(img, seeds, schedule)
    assert (got - want).abs().max().item() <= 2e-3
    p = 2 * rad + 1
    patches, _, _ = cuda_subpix.gather_patches(img, seeds, rad)
    patches = patches.reshape(-1, p, p)
    lim = float(rad - 1)
    signs = torch.tensor(rng.choice([-1.0, 1.0], (patches.shape[0], 2)),
                         dtype=torch.float32, device=device)
    c0 = signs * lim
    c0[::3, 0] = torch.tensor(rng.uniform(-lim, lim, c0[::3].shape[0]),
                              dtype=torch.float32, device=device)
    got = cuda_subpix.refine_offsets(patches, c0, schedule)
    want = cuda_subpix.refine_offsets_plain(patches, c0, schedule)
    assert (got - want).abs().max().item() <= 2e-3


@pytest.mark.parametrize("schedule", [
    SCHEDULES[0],
    ((16, 3),),         # a window wider than a warp: 33 columns
    ((24, 2),),         # a patch wider than three warps: p = 99
    ((0, 2), (4, 3))])  # half 0: a 0/0 weight, no step (as the reference)
@pytest.mark.parametrize("frames,corners", [(1, 64), (2, 512)])
def test_subpix_any_half_and_launch_size_match_plain(device, schedule,
                                                     frames, corners):
    """B2 and B5 at any half window the patch fits in shared memory,
    at a tracker pull's launch size (4 corners a block) and at a
    detector's (8 a block), each counted once."""
    rng = np.random.default_rng(14)
    img = _smooth_image(rng, device)[:frames]
    seeds = torch.tensor(rng.uniform([0, 0], [319, 239],
                                     (frames, corners, 2)),
                         dtype=torch.float32, device=device)
    before = cuda_subpix.refine_corners.launches
    got = cuda_subpix.refine_corners(img, seeds, schedule)
    assert cuda_subpix.refine_corners.launches == before + 1
    want = cuda_subpix.refine_corners_plain(img, seeds, schedule)
    assert (got - want).abs().max().item() <= 2e-3
    rad, _ = cuda_subpix.schedule_params(schedule)
    p = 2 * rad + 1
    patches, cx0, cy0 = cuda_subpix.gather_patches(img, seeds, rad)
    c0 = cuda_subpix.start_offsets(seeds, cx0, cy0, rad)
    patches, c0 = patches.reshape(-1, p, p), c0.reshape(-1, 2)
    got = cuda_subpix.refine_offsets(patches, c0, schedule)
    want = cuda_subpix.refine_offsets_plain(patches, c0, schedule)
    assert (got - want).abs().max().item() <= 2e-3


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_refine_offsets_matches_plain(device, schedule):
    rng = np.random.default_rng(5)
    img = _smooth_image(rng, device)
    seeds = torch.tensor(rng.uniform([0, 0], [319, 239], (2, 96, 2)),
                         dtype=torch.float32, device=device)
    rad, _ = cuda_subpix.schedule_params(schedule)
    patches, cx0, cy0 = cuda_subpix.gather_patches(img, seeds, rad)
    c0 = cuda_subpix.start_offsets(seeds, cx0, cy0, rad)
    p = 2 * rad + 1
    patches, c0 = patches.reshape(-1, p, p), c0.reshape(-1, 2)
    before = cuda_subpix.refine_offsets.launches
    got = cuda_subpix.refine_offsets(patches, c0, schedule)
    assert cuda_subpix.refine_offsets.launches == before + 1
    want = cuda_subpix.refine_offsets_plain(patches, c0, schedule)
    assert (got - want).abs().max().item() <= 2e-3  # px, reassociation


@pytest.mark.parametrize("schedule", SCHEDULES)
def test_subpix_singular_tensor_matches_plain(device, schedule):
    """On a 45° step edge gx == gy at every pixel, so the structure
    tensor is exactly rank 1 and the reference's det is exactly 0: no
    step. An FMA-contracted det leaves a rounding residue above 1e-9
    and jumps up to +-half (seen at ((3, 4), (2, 2)): 2.97 px)."""
    yy, xx = np.mgrid[:240, :320]
    img = torch.from_numpy(np.where(xx + yy > 280, 220, 30).astype(
        np.uint8))[None].to(device)
    t = torch.linspace(-60.0, 60.0, 48, device=device)
    seeds = torch.stack([160.0 + t + 0.3, 120.0 - t + 0.2], -1)[None]
    rad, _ = cuda_subpix.schedule_params(schedule)
    got = cuda_subpix.refine_corners(img, seeds, schedule)
    want = cuda_subpix.refine_corners_plain(img, seeds, schedule)
    assert (got - want).abs().max().item() <= 2e-3
    patches, cx0, cy0 = cuda_subpix.gather_patches(img, seeds, rad)
    c0 = cuda_subpix.start_offsets(seeds, cx0, cy0, rad)
    p = 2 * rad + 1
    got = cuda_subpix.refine_offsets(patches.reshape(-1, p, p),
                                     c0.reshape(-1, 2), schedule)
    want = cuda_subpix.refine_offsets_plain(patches.reshape(-1, p, p),
                                            c0.reshape(-1, 2), schedule)
    assert (got - want).abs().max().item() <= 2e-3


def test_refine_corners_takes_the_patch_kernel(device):
    """detect.refine_corners launches B5 (the patch path, as the JAX
    function on every backend), not B2."""
    from aruco_slam_tpu_torch.ops import detect
    rng = np.random.default_rng(6)
    img = _smooth_image(rng, device)[0]
    pts = torch.tensor(rng.uniform([0, 0], [319, 239], (50, 2)),
                       dtype=torch.float32, device=device)
    b2 = cuda_subpix.refine_corners.launches
    b5 = cuda_subpix.refine_offsets.launches
    got = detect.refine_corners(img, pts)
    assert cuda_subpix.refine_offsets.launches == b5 + 1
    assert cuda_subpix.refine_corners.launches == b2
    want = cuda_subpix.refine_corners_plain(img[None], pts[None], ((5, 8),))
    assert (got - want[0]).abs().max().item() <= 2e-3


@pytest.mark.parametrize("dtype", [torch.uint8, torch.float32])
def test_subpix_matches_plain(device, dtype):
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.integers(0, 256, (2, 240, 320),
                                        dtype=np.uint8)).to(device)
    img = torch.nn.functional.avg_pool2d(
        img[:, None].float(), 5, 1, 2)[:, 0].to(dtype)  # smooth corners
    seeds = torch.tensor(rng.uniform([0, 0], [319, 239], (2, 64, 2)),
                         dtype=torch.float32, device=device)
    sched = ((6, 6), (3, 4))
    got = cuda_subpix.refine_corners(img, seeds, sched)
    want = cuda_subpix.refine_corners_plain(img, seeds, sched)
    assert (got - want).abs().max().item() <= 2e-3  # px, reassociation


def test_fused_update_matches_plain(device):
    rng = np.random.default_rng(5)
    n, m = 201, 48
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    cov = torch.tensor(a @ a.T * 0.05 + 0.01 * np.eye(n),
                       dtype=torch.float32, device=device)
    h = torch.tensor(rng.normal(size=(m, n)) * 0.3, dtype=torch.float32,
                     device=device)
    r = torch.tensor(rng.uniform(1e-3, 1e-2, m), dtype=torch.float32,
                     device=device)
    resid = torch.tensor(0.01 * rng.normal(size=m), dtype=torch.float32,
                         device=device)
    inn, pn = cuda_mekf.fused_update(cov, h, r, resid)
    inn_p, pn_p = cuda_mekf.fused_update_plain(cov, h, r, resid)
    assert (inn - inn_p).abs().max().item() <= 1e-4
    assert (pn - pn_p).abs().max().item() <= 1e-4
    assert torch.equal(pn, pn.T)


def _update_inputs(rng, device, n, m, streams=None):
    lead = () if streams is None else (streams,)
    a = rng.normal(size=(*lead, n, n)) / np.sqrt(n)
    cov = a @ np.swapaxes(a, -1, -2) * 0.05 + 0.01 * np.eye(n)
    return [torch.tensor(x, dtype=torch.float32, device=device) for x in (
        cov, rng.normal(size=(*lead, m, n)) * 0.3,
        rng.uniform(1e-3, 1e-2, (*lead, m)),
        0.01 * rng.normal(size=(*lead, m)))]


def _rel_err(got, want):
    return (got - want).abs().max().item() / max(1.0,
                                                 want.abs().max().item())


@pytest.mark.parametrize("n,m", [(201, 48), (393, 112), (81, 35),
                                 (300, 264)])
def test_fused_update_batched_matches_single_launches(device, n, m):
    """Eight streams in one launch sequence: each stream's innovation and
    covariance bit-equal to its own single-stream launch (the same
    arithmetic, the stream in blockIdx), within 1e-4 of the batched
    plain version and exactly symmetric; one launch counted."""
    args = _update_inputs(np.random.default_rng(n), device, n, m, 8)
    before = cuda_mekf.fused_update.launches
    inn, pn = cuda_mekf.fused_update(*args)
    assert cuda_mekf.fused_update.launches == before + 1
    inn_p, pn_p = cuda_mekf.fused_update_plain(*args)
    assert _rel_err(inn, inn_p) <= 1e-4 and _rel_err(pn, pn_p) <= 1e-4
    assert torch.equal(pn, pn.transpose(-1, -2))
    for i in range(8):
        inn1, pn1 = cuda_mekf.fused_update(*(a[i] for a in args))
        assert torch.equal(inn[i], inn1) and torch.equal(pn[i], pn1)


@pytest.mark.parametrize("n,m,path", [
    (81, 35, "columns"), (201, 81, "columns"), (54, 48, "columns"),
    (9, 6, "columns"), (201, 128, "columns"), (300, 160, "rows"),
    (393, 224, "rows"), (300, 256, "rows"), (300, 264, "block"),
    (450, 448, "block")])
def test_fused_update_shapes_and_paths(device, n, m, path):
    """Ragged M (not a multiple of the 8-CTA cluster), the form the
    kernel takes for each M (column slabs to M = 128, row slabs to 256,
    the single block above) and every later form forced at the same M:
    1e-4 relative of the plain version, exactly symmetric."""
    assert cuda_mekf.newton_schulz_form(m) == path
    args = _update_inputs(np.random.default_rng(m), device, n, m)
    inn_p, pn_p = cuda_mekf.fused_update_plain(*args)
    runs = [cuda_mekf.fused_update(*args)] + [
        cuda_mekf.fused_update_form(*args, form) for form in
        cuda_mekf.FORMS[cuda_mekf.FORMS.index(path):]]
    for inn, pn in runs:
        assert _rel_err(inn, inn_p) <= 1e-4 and _rel_err(pn, pn_p) <= 1e-4
        assert torch.equal(pn, pn.T)


def test_fused_update_refuses_a_form_that_cannot_take_m(device):
    args = _update_inputs(np.random.default_rng(0), device, 201, 160)
    with pytest.raises(RuntimeError, match="CUDA error"):
        cuda_mekf.fused_update_form(*args, "columns")


def test_fused_update_rotation_size(device):
    """B3 at rotation mode's size (N = 9 + 64·6 = 393, M = 16·7 = 112)
    against its plain version: 1e-4 relative, symmetric."""
    args = _update_inputs(np.random.default_rng(7), device, 393, 112)
    inn, pn = cuda_mekf.fused_update(*args)
    inn_p, pn_p = cuda_mekf.fused_update_plain(*args)
    assert _rel_err(inn, inn_p) <= 1e-4 and _rel_err(pn, pn_p) <= 1e-4
    assert torch.equal(pn, pn.T)


def test_mekf_fleet_step_cuda_matches_cpu(device):
    """Three rotation-mode filters stepping together on the card (one
    update launch per frame) against the same on the CPU (plain
    versions)."""
    from aruco_slam_tpu_torch.filters import mekf as tm
    from aruco_slam_tpu_torch.parallel import multi_slam as tms
    rng = np.random.default_rng(2)
    cfg = tm.MekfConfig(capacity=12, max_obs=5, with_rotations=True,
                        motion_model="cv", pixel_sigma=1.0,
                        r_uncertainty=0.005, q_uncertainty_cam=1.0,
                        q_error_uncertainty_cam=1.0, q_uncertainty_lm=0.0)
    t, s, c = 16, 3, 12
    lm = rng.uniform([-1, -1, 2.5], [1, 1, 3.5], (c, 3))
    t_cl = (lm[None, None] - np.linspace(0, 0.3, t)[None, :, None, None]
            * np.array([1.0, 0, 0]) + rng.normal(0, 0.003, (s, t, c, 3)))
    q = rng.normal(size=(s, t, c, 4)) * 0.02 + [1.0, 0, 0, 0]
    mask = rng.random((s, t, c)) < 0.6
    out = {}
    for dev in (device, torch.device("cpu")):
        obs = tm.FrameObservations(*(torch.tensor(x, device=dev) for x in (
            t_cl.astype(np.float32), q.astype(np.float32), mask)))
        before = cuda_mekf.fused_update.launches
        states = tms.stack_states([tm.init_state(cfg, device=dev)] * s)
        _, traj = tms.batched_mekf_scan(cfg, states, obs)
        out[dev.type] = (traj.cpu().numpy(),
                         cuda_mekf.fused_update.launches - before)
    assert out["cuda"][1] == t and out["cpu"][1] == 0
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=2e-3)


def test_wrappers_refuse_what_the_kernels_do_not_take(device):
    img = torch.zeros((1, 64, 64), dtype=torch.int16, device=device)
    with pytest.raises(ValueError):
        cuda_subpix.refine_corners(img, torch.zeros((1, 4, 2),
                                                    device=device),
                                   ((6, 6),))
    img = torch.zeros((1, 200, 200), dtype=torch.uint8, device=device)
    with pytest.raises(ValueError):  # a negative half window
        cuda_subpix.refine_corners(img, torch.zeros((1, 4, 2),
                                                    device=device),
                                   ((-1, 2),))
    with pytest.raises(RuntimeError):  # p = 163: over the shared memory
        cuda_subpix.refine_corners(img, torch.zeros((1, 4, 2),
                                                    device=device),
                                   ((40, 1),))
    cov = torch.eye(6, device=device)
    with pytest.raises(ValueError):
        cuda_mekf.fused_update(cov.double(), torch.zeros((3, 6),
                                                         device=device),
                               torch.ones(3, device=device),
                               torch.zeros(3, device=device))


def test_wrappers_refuse_mixed_device_arguments(device):
    """A launch whose tensors lie on more than one device raises
    ValueError before anything launches (`_build.on_device`): a CPU
    argument beside a card's, and with two cards one on each."""
    other = [torch.device("cpu")]
    if torch.cuda.device_count() > 1:
        other.append(torch.device("cuda", 1))
    img = torch.zeros((1, 64, 64), dtype=torch.uint8, device=device)
    patches = torch.zeros((2, 15, 15), device=device)
    cov = torch.eye(6, device=device)
    for dev in other:
        before = (cuda_subpix.refine_corners.launches,
                  cuda_subpix.refine_offsets.launches,
                  cuda_mekf.fused_update.launches)
        with pytest.raises(ValueError):
            cuda_subpix.refine_corners(img, torch.zeros((1, 4, 2),
                                                        device=dev),
                                       ((3, 2),))
        with pytest.raises(ValueError):
            cuda_subpix.refine_offsets(patches, torch.zeros((2, 2),
                                                            device=dev),
                                       ((3, 2),))
        if dev.type == "cuda":
            with pytest.raises(ValueError):
                cuda_mekf.fused_update(cov, torch.zeros((3, 6), device=dev),
                                       torch.ones(3, device=device),
                                       torch.zeros(3, device=device))
        torch.cuda.synchronize()
        assert before == (cuda_subpix.refine_corners.launches,
                          cuda_subpix.refine_offsets.launches,
                          cuda_mekf.fused_update.launches)


def test_sharded_fleet_scan_on_card(device):
    """The stream axis over a mesh that lists the card twice (and over
    every card, where there are several): B3 once a frame per shard,
    the trajectories within 2e-5 of the unsharded scan, the outputs on
    the first entry."""
    from aruco_slam_tpu_torch.filters import mekf
    from aruco_slam_tpu_torch.parallel import multi_slam
    rng = np.random.default_rng(0)
    s, t = 4, 12
    t_cl = rng.normal(size=(s, t, 8, 3)) + np.array([0, 0, 3.0])
    q_cl = np.zeros((s, t, 8, 4))
    q_cl[..., 1] = 1.0
    obs = mekf.FrameObservations(
        torch.tensor(t_cl, dtype=torch.float32, device=device),
        torch.tensor(q_cl, dtype=torch.float32, device=device),
        torch.tensor(rng.random((s, t, 8)) < 0.6, device=device))
    cfg = mekf.MekfConfig(capacity=8)
    states = multi_slam.stack_states([mekf.init_state(cfg, device=device)
                                      for _ in range(s)])
    _, want = multi_slam.batched_mekf_scan(cfg, states, obs)
    meshes = [[device] * 2]
    if torch.cuda.device_count() > 1:
        meshes.append(multi_slam.stream_mesh(device)[:2])
    for mesh in meshes:
        before = cuda_mekf.fused_update.launches
        fin, got = multi_slam.batched_mekf_scan(cfg, states, obs, mesh=mesh)
        torch.cuda.synchronize()
        assert cuda_mekf.fused_update.launches - before == t * len(mesh)
        first = torch.empty(0, device=mesh[0]).device
        assert got.device == first and fin.cov.device == first
        np.testing.assert_allclose(got.cpu().numpy(), want.cpu().numpy(),
                                   atol=2e-5)


def _run_slam_both(tmp_path, orbit_frames, frames, flags=()):
    """run_slam on the card and on the CPU (plain versions) over the
    first ``frames`` frames of an ``orbit_frames`` orbit at 960x540."""
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    from aruco_slam_tpu_torch.io import read_trajectory, save_npz
    k = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
                  [0.0, 0.0, 1.0]])
    dist = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=orbit_frames)
    traj = synthetic.Trajectory(*(a[:frames] for a in traj))
    images = render.render_sequence(
        scene, traj, cam_mod.CameraModel.from_matrix(k, dist),
        image_size=(960, 540))
    npz = tmp_path / "seq.npz"
    save_npz(npz, times=traj.times, images=images, gt_cam_t=traj.cam_t,
             camera_matrix=k, dist_coeffs=dist,
             marker_size=np.float64(scene.marker_size))
    out = {}
    for platform in ("cuda", "cpu"):
        res = run_slam.main(["--input", str(npz), "--platform", platform,
                             "--trajectory", str(tmp_path / f"{platform}.txt"),
                             "--map", str(tmp_path / f"{platform}_map.txt"),
                             *flags])
        out[platform] = (read_trajectory(res.trajectory_file)[1], res)
    return out


def test_run_slam_track_every_cuda_matches_cpu(device, tmp_path):
    """The streaming path (--track-every 4) on the card against the CPU,
    on 12 video-rate frames."""
    out = _run_slam_both(tmp_path, 300, 12, ["--track-every", "4"])
    (tc, rc), (tp, rp) = out["cuda"], out["cpu"]
    assert np.array_equal(rc.obs_mask, rp.obs_mask)
    assert np.array_equal(np.sort(rc.landmark_ids), np.sort(rp.landmark_ids))
    np.testing.assert_allclose(tc, tp, atol=2e-3)
    assert rc.ate < 0.3


def test_run_slam_cuda_matches_cpu(device, tmp_path):
    """The whole slice on the card against the same slice on the CPU
    (plain versions), on 8 rendered 960x540 frames."""
    out = _run_slam_both(tmp_path, 30, 8)
    (tc, rc), (tp, rp) = out["cuda"], out["cpu"]
    assert np.array_equal(rc.obs_mask, rp.obs_mask)
    assert np.array_equal(np.sort(rc.landmark_ids), np.sort(rp.landmark_ids))
    # same math; sums (cumsum, GEMMs, reductions) in other orders
    np.testing.assert_allclose(tc, tp, atol=2e-3)
    assert rc.ate < 0.3


def _fleet_streams():
    """Four 8-frame video-rate 720x405 streams (S, T, H, W): windows of
    the first 12 frames of a 300-frame orbit, two of them reversed."""
    from aruco_slam_tpu_torch.bench import render, synthetic
    from aruco_slam_tpu_torch.core import camera as cam_mod
    k = np.array([[530.59, 0.0, 362.63], [0.0, 530.59, 204.11],
                  [0.0, 0.0, 1.0]])
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=300)
    traj = synthetic.Trajectory(*(a[:12] for a in traj))
    frames = render.render_sequence(
        scene, traj, cam_mod.CameraModel.from_matrix(k, np.zeros(5)),
        image_size=(720, 405))
    return np.stack([frames[:8], frames[4:12], frames[11:3:-1],
                     frames[7::-1]])


def _fleet_scan(seq, dev, step):
    """Step the (S, T, H, W) streams frame by frame on ``dev``: the final
    carry and the (T, S, ...) corners and masks."""
    from aruco_slam_tpu_torch.ops import detect
    cfg = detect.DetectorConfig()
    cr = detect.streaming_init(cfg, streams=len(seq), mapped=True,
                               device=dev)
    cs, ms = [], []
    for im in torch.from_numpy(np.swapaxes(seq, 0, 1).copy()).to(dev):
        cr, (c, m) = step(cr, im)
        cs.append(c)
        ms.append(m)
    return cr, torch.stack(cs), torch.stack(ms)


@pytest.mark.parametrize("cohorts", [0, 2])
def test_fleet_streaming_cuda_matches_cpu(device, cohorts):
    """`streaming_step(streams=4, mapped=True)` at K = 4 on the card
    against the CPU (plain versions): masks and slot tables equal,
    corners within B2's 2e-3 px."""
    from aruco_slam_tpu_torch.ops import detect
    seq = _fleet_streams()
    out = {}
    for dev in (device, torch.device("cpu")):
        step = detect.streaming_step(detect.DetectorConfig(), 4, streams=4,
                                     mapped=True, rescue_cohorts=cohorts)
        cr, cs, ms = _fleet_scan(seq, dev, step)
        out[dev.type] = (cr[3].cpu(), cr[-1], cs.cpu(), ms.cpu())
    (tab, idx, cs, ms), (tab_p, idx_p, cs_p, ms_p) = out["cuda"], out["cpu"]
    assert torch.equal(ms, ms_p) and torch.equal(tab, tab_p)
    assert idx == idx_p == seq.shape[1]
    assert float((cs - cs_p).abs().max()) <= 2e-3
    assert int(ms_p.sum(-1).min()) >= 2


def test_tracked_fleet_frame_launches_b2_three_times(device):
    """A tracked frame of 4 streams makes 3 B2 launches (one a tracker
    schedule for all streams) and no B1 launch; a full frame 3 B1
    launches and 1 B2 launch."""
    from aruco_slam_tpu_torch.ops import detect
    cfg = detect.DetectorConfig()
    seq = torch.from_numpy(_fleet_streams()).to(device)
    state = detect.streaming_init(cfg, streams=4, mapped=True,
                                  device=device)[:-1]
    for f, full, b1, b2 in ((0, True, 3, 1), (1, False, 0, 3),
                            (2, False, 0, 3)):
        before = (cuda_cc.flood_scan_labels.launches,
                  cuda_subpix.refine_corners.launches)
        state = detect.detect_or_track_batch_mapped(seq[:, f], *state, full,
                                                    cfg)
        torch.cuda.synchronize()
        assert (cuda_cc.flood_scan_labels.launches - before[0],
                cuda_subpix.refine_corners.launches - before[1]) == (b1, b2)
    assert int(state[1].sum(-1).min()) >= 2


@pytest.mark.parametrize("cohorts", [2, 4])
def test_cohort_batching_bit_identical_on_card(device, cohorts):
    """The cohort step's one sweep batch and one tracked batch a frame
    give each stream exactly what one branch per cohort (the JAX
    package's structure) gives it on the card."""
    from aruco_slam_tpu_torch.ops import detect
    cfg = detect.DetectorConfig()
    per = 4 // cohorts

    def per_cohort(cr, im):
        state, i = cr[:-1], cr[-1]
        parts = []
        for g in range(cohorts):
            sl = slice(g * per, (g + 1) * per)
            due = ((i + g * 4 // cohorts) % 4) < 2 \
                or bool((~state[1][sl].any(-1)).any())
            parts.append(detect.detect_or_track_batch_mapped(
                im[sl], *(x[sl] for x in state), due, cfg))
        out = tuple(torch.cat(xs) for xs in zip(*parts))
        return (*out, i + 1), out[:2]

    seq = _fleet_streams()
    got = _fleet_scan(seq, device, detect.streaming_step(
        cfg, 4, streams=4, mapped=True, rescue_cohorts=cohorts))
    want = _fleet_scan(seq, device, per_cohort)
    for g, w in zip((*got[0][:-1], *got[1:]), (*want[0][:-1], *want[1:])):
        assert torch.equal(g, w)


def _graph_orbit(frames: int, max_poses: int, rotations: bool = False):
    """A pose-level orbit (8 markers, capacity 16, 5 mm noise) and an f64
    GraphConfig at the run_slam defaults (Huber 2, depth whitening)."""
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.graph import GraphConfig
    scene = synthetic.make_wall_scene(num_markers=8, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    obs = synthetic.observe_poses(scene, traj, 16, noise_t=0.005,
                                  noise_r=0.02, fov_limit=0.75)
    cfg = GraphConfig(max_poses=max_poses, max_landmarks=16,
                      max_factors=max_poses * 10, meas_sigma_t=0.01,
                      odom_sigma_t=1.0, odom_sigma_rot=1.0, pixel_sigma=1.0,
                      huber_delta=2.0, with_rotations=rotations,
                      dtype=torch.float64)
    return obs, cfg


def _graph_ingest(cfg, obs, dev, frames: int, rotations: bool = False):
    from aruco_slam_tpu_torch import graph
    state = graph.init_graph(cfg, device=dev)
    for i in range(frames):
        state = graph.add_frame(
            cfg, state, torch.tensor(obs.t_cl[i], device=dev),
            torch.tensor(obs.mask[i], device=dev),
            torch.tensor(obs.q_cl[i], device=dev) if rotations else None)
    return state


@pytest.mark.parametrize("rotations", [False, True],
                         ids=["point", "rotations"])
def test_graph_batch_optimize_cuda_matches_cpu(device, rotations):
    """batch_optimize (15 iterations, f64) on the card: poses and
    landmarks within 1e-6 m of the CPU's, the cost within 1e-9."""
    from aruco_slam_tpu_torch import graph
    obs, cfg = _graph_orbit(40, 42, rotations)
    out = {}
    for dev in (device, torch.device("cpu")):
        state, cost = graph.batch_optimize(
            cfg, _graph_ingest(cfg, obs, dev, 40, rotations), iters=15)
        out[dev.type] = (state.pose_t.cpu(), state.lm.cpu(), float(cost))
    (pt, lm, cost), (pt_c, lm_c, cost_c) = out["cuda"], out["cpu"]
    assert float((pt - pt_c).abs().max()) < 1e-6
    assert float((lm - lm_c).abs().max()) < 1e-6
    assert abs(cost - cost_c) <= 1e-9 * cost_c


def test_graph_online_marginalizing_cuda_matches_cpu(device):
    """The bounded online run (60 frames, 24-pose budget, window 8, 3
    iterations, four marginalizations; f64) on the card: every frame's
    pose within 1e-6 m of the CPU's, the priors within 1e-8 relative."""
    from aruco_slam_tpu_torch import graph
    obs, cfg = _graph_orbit(60, 24)
    out = {}
    for dev in (device, torch.device("cpu")):
        state = graph.init_graph(cfg, device=dev)
        est, num = [], 1
        for i in range(60):
            state = graph.add_frame(cfg, state,
                                    torch.tensor(obs.t_cl[i], device=dev),
                                    torch.tensor(obs.mask[i], device=dev))
            state, _ = graph.optimize_window(cfg, state, window=8, iters=3)
            num = min(num + 1, 24)
            est.append(state.pose_t[num - 2])
            if num >= 23:
                state = graph.marginalize_poses(cfg, state, 12)
                num = max(num - 12, 1)
        out[dev.type] = (torch.stack(est).cpu(), state.prior_lm_h.cpu(),
                         state.prior_lm_mean.cpu())
    (est, h, m), (est_c, h_c, m_c) = out["cuda"], out["cpu"]
    assert float((est - est_c).abs().max()) < 1e-6
    assert float((h - h_c).abs().max() / h_c.abs().max()) < 1e-8
    assert float((m - m_c).abs().max() / m_c.abs().max()) < 1e-8


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_graph_solves_read_nothing_back(device, dtype):
    """add_frame, optimize_window and batch_optimize under
    torch.cuda.set_sync_debug_mode("error"): the LM loop chooses accept
    or reject on the device and never waits for it."""
    from aruco_slam_tpu_torch import graph
    obs, cfg = _graph_orbit(20, 22)
    cfg = cfg._replace(dtype=dtype)
    state = _graph_ingest(cfg, obs, device, 19)
    t_cl = torch.tensor(obs.t_cl[19], device=device)
    mask = torch.tensor(obs.mask[19], device=device)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        state = graph.add_frame(cfg, state, t_cl, mask)
        state, _ = graph.optimize_window(cfg, state, window=8, iters=3)
        state, cost = graph.batch_optimize(cfg, state, iters=5)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert bool(torch.isfinite(cost)) and int(state.num_poses) == 21


@pytest.fixture(scope="module")
def large_map_state():
    """The large map's ingested graph (bench/large_map.py: 512 markers, a
    512-frame raster, f32, the PnP of its noisy corners) on the card,
    or None without one."""
    if not torch.cuda.is_available():
        return None
    from aruco_slam_tpu_torch import graph
    from aruco_slam_tpu_torch.bench import e2e, large_map
    from aruco_slam_tpu_torch.ops import pnp
    dev = torch.device("cuda")
    scene, _, corners, mask = large_map.survey(512, 512, e2e.camera())
    res = pnp.solve_square_pnp(e2e.camera(dev), torch.tensor(
        corners, dtype=torch.float32, device=dev), scene.marker_size)
    ok = torch.tensor(mask, device=dev) & (res.err < 3.0)
    cfg = graph.GraphConfig(max_poses=514, max_landmarks=512,
                            max_factors=int(ok.sum()) + 512 + 64,
                            pixel_sigma=0.3, huber_delta=2.0)
    state = graph.init_graph(cfg, device=dev)
    for i in range(512):
        state = graph.add_frame(cfg, state, res.t_cl[i], ok[i])
    return cfg, state


def _bit_equal(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in zip(a, b))


@pytest.mark.parametrize("solve", ["batch_optimize", "optimize_window",
                                   "sharded local 2"])
def test_graph_solves_repeat_bit_for_bit(device, large_map_state, solve):
    """The large map's solve run twice from the same state on the card,
    in the default mode a user runs (no torch.use_deterministic_algorithms):
    the graph's sums are in a fixed order, so the estimates and the cost
    are bit-equal; also under torch.func.vmap, as `parallel.sharded_ba`
    runs `_linearize` over two local mesh devices."""
    from aruco_slam_tpu_torch import graph
    from aruco_slam_tpu_torch.parallel import dist, sharded_ba
    assert not torch.are_deterministic_algorithms_enabled()
    cfg, state = large_map_state
    run = {"batch_optimize": lambda: graph.batch_optimize(cfg, state,
                                                          iters=5),
           "optimize_window": lambda: graph.optimize_window(
               cfg, state, window=64, iters=3),
           "sharded local 2": lambda: sharded_ba.sharded_batch_optimize(
               cfg, state, dist.make_mesh(local_devices=2), iters=5)}[solve]
    (a, cost_a), (b, cost_b) = run(), run()
    assert torch.equal(cost_a, cost_b) and bool(torch.isfinite(cost_a))
    assert _bit_equal((a.pose_q, a.pose_t, a.lm), (b.pose_q, b.pose_t, b.lm))


def test_marginalize_poses_repeats_bit_for_bit(device):
    """`marginalize_poses` (its sums over the dropped poses' factors)
    twice from the same f32 state on the card: bit-equal priors."""
    from aruco_slam_tpu_torch import graph
    obs, cfg = _graph_orbit(40, 42)
    cfg = cfg._replace(dtype=torch.float32)
    state, _ = graph.batch_optimize(cfg, _graph_ingest(cfg, obs, device, 40),
                                    iters=3)
    a = graph.marginalize_poses(cfg, state, 16)
    b = graph.marginalize_poses(cfg, state, 16)
    assert _bit_equal(a, b)


@pytest.mark.parametrize("streams", [0, 4])
def test_make_pipeline_cuda_matches_cpu(device, streams):
    """bench/pipeline.make_pipeline (the headline's corners, 48 frames in
    chunks of 16, the default filter: B3 once a frame on the card, its
    plain version on the CPU), one stream and four at once: the
    trajectories within 2e-3 m (tests/test_torch_cuda.py's slice bound:
    the same math summed in other orders)."""
    from aruco_slam_tpu_torch.bench import e2e, synthetic
    from aruco_slam_tpu_torch.bench.pipeline import make_pipeline
    from aruco_slam_tpu_torch.filters import MekfConfig, init_state
    from aruco_slam_tpu_torch.parallel.multi_slam import stack_states
    scene = synthetic.make_wall_scene(num_markers=8, seed=0)
    corners, mask = synthetic.observe_corners(
        scene, synthetic.make_orbit_trajectory(num_frames=48), e2e.camera(),
        64, noise_px=0.3, seed=1)
    if streams:
        rng = np.random.default_rng(7)
        corners = corners[None] + rng.normal(0, 0.3, (streams,)
                                             + corners.shape)
        mask = np.broadcast_to(mask, (streams,) + mask.shape).copy()
    cfg = MekfConfig(capacity=64)
    out = {}
    for dev in (device, torch.device("cpu")):
        state = init_state(cfg, device=dev)
        if streams:
            state = stack_states([state] * streams)
        before = cuda_mekf.fused_update.launches
        _, traj = make_pipeline(e2e.camera(dev), scene.marker_size, cfg)(
            state, torch.tensor(corners, dtype=torch.float32, device=dev),
            torch.tensor(mask, device=dev))
        out[dev.type] = (traj.cpu().numpy(),
                         cuda_mekf.fused_update.launches - before)
    assert out["cuda"][1] == 48 and out["cpu"][1] == 0
    assert np.isfinite(out["cuda"][0]).all()
    np.testing.assert_allclose(out["cuda"][0], out["cpu"][0], atol=2e-3)


@pytest.mark.parametrize("local", [1, 2, 4])
def test_sharded_lm_cuda_matches_cpu_reads_nothing_back(device, local,
                                                         monkeypatch):
    """parallel/sharded_ba's landmark-sharded LM on the card (f64,
    ``local`` mesh devices batched by vmap in one process): poses and
    landmarks within 1e-6 m of the CPU's, and its loop (`_lm_iterations`)
    under torch.cuda.set_sync_debug_mode("error")."""
    from aruco_slam_tpu_torch.parallel import dist, sharded_ba
    obs, cfg = _graph_orbit(20, 22)
    mesh = dist.make_mesh(local_devices=local)
    want, want_cost = sharded_ba.sharded_batch_optimize(
        cfg, _graph_ingest(cfg, obs, torch.device("cpu"), 20), mesh,
        iters=10)
    real = sharded_ba._lm_iterations

    def guarded(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(sharded_ba, "_lm_iterations", guarded)
    got, cost = sharded_ba.sharded_batch_optimize(
        cfg, _graph_ingest(cfg, obs, device, 20), mesh, iters=10)
    assert abs(float(cost) - float(want_cost)) <= 1e-9 * abs(float(want_cost))
    for k in ("pose_t", "lm"):
        diff = (getattr(got, k).cpu() - getattr(want, k)).abs().max()
        assert float(diff) < 1e-6, k


def test_calibration_lm_matches_cpu_reads_nothing_back(device, monkeypatch):
    """ops/calibrate's float64 LM on the card: the camera matrix within
    rtol 1e-9 of the CPU's, and its loop (`_lm_iterations`, 60 steps of
    residuals, jacfwd, solve and the accept/reject) under
    torch.cuda.set_sync_debug_mode("error")."""
    import sys
    from pathlib import Path
    sys.path.insert(0, str(Path(__file__).resolve().parents[1]))
    import chip_smoke
    from aruco_slam_tpu_torch.ops import calibrate as cal
    # tests/test_calibrate.py make_views' correspondences
    board, corners, mask = chip_smoke.grid_views()
    want = cal.calibrate(board, corners, mask, (1280, 720), iters=60)
    real = cal._lm_iterations

    def guarded(*args, **kw):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            return real(*args, **kw)
        finally:
            torch.cuda.set_sync_debug_mode(0)

    monkeypatch.setattr(cal, "_lm_iterations", guarded)
    got = cal.calibrate(board, corners, mask, (1280, 720), iters=60,
                        device=device)
    np.testing.assert_allclose(got.camera_matrix, want.camera_matrix,
                               rtol=1e-9)
    np.testing.assert_allclose(got.dist_coeffs, want.dist_coeffs, atol=1e-8)
    assert got.rms_px < 0.3


@pytest.mark.parametrize("views", [1, 12])
def test_refine_offsets_at_calibration_shapes(device, views):
    """B5 at the calibration CLI's call: 24 chessboard corners a view,
    one view (24 patches) or the 12-view batch (288), p 23."""
    rng = np.random.default_rng(views)
    img = _smooth_image(rng, device)[:1].repeat(views, 1, 1)
    seeds = torch.tensor(rng.uniform([20, 20], [300, 220], (views, 24, 2)),
                         dtype=torch.float32, device=device)
    rad, _ = cuda_subpix.schedule_params(((5, 8),))
    patches, cx0, cy0 = cuda_subpix.gather_patches(img, seeds, rad)
    c0 = cuda_subpix.start_offsets(seeds, cx0, cy0, rad)
    patches = patches.reshape(-1, 2 * rad + 1, 2 * rad + 1)
    c0 = c0.reshape(-1, 2)
    assert patches.shape == (views * 24, 23, 23)
    before = cuda_subpix.refine_offsets.launches
    got = cuda_subpix.refine_offsets(patches, c0, ((5, 8),))
    assert cuda_subpix.refine_offsets.launches == before + 1
    want = cuda_subpix.refine_offsets_plain(patches, c0, ((5, 8),))
    assert (got - want).abs().max().item() <= 2e-3  # px, reassociation


@pytest.mark.parametrize("size", [(1280, 720), (1920, 1080)])
def test_undistort_image_matches_cpu(device, size):
    """core/camera.undistort_image on the card against the CPU: within
    one gray level (a rounding tie at .5 may fall either way)."""
    from aruco_slam_tpu_torch.core import camera as cam_mod
    w, h = size
    rng = np.random.default_rng(w)
    img = torch.from_numpy(rng.integers(0, 256, (h, w), dtype=np.uint8))
    cam = cam_mod.CameraModel.from_matrix(
        np.float32([[0.7 * w, 0, w / 2], [0, 0.7 * w, h / 2], [0, 0, 1]]),
        np.float32([0.08, -0.22, 0.001, 0.002, 0.11]))
    want = cam_mod.undistort_image(cam, img)
    got = cam_mod.undistort_image(cam.to(device=device), img.to(device))
    assert got.dtype == torch.uint8 and got.is_cuda
    diff = (got.cpu().int() - want.int()).abs()
    assert diff.max().item() <= 1
    assert (diff > 0).sum().item() < img.numel() // 1000


@pytest.fixture(scope="module")
def image_seq(tmp_path_factory):
    """tests/test_io_apps.py's bundle: 6 rendered 720x405 frames."""
    from aruco_slam_tpu_torch.apps import make_synthetic
    from aruco_slam_tpu_torch.io import save_npz
    path = tmp_path_factory.mktemp("imgseq") / "seq.npz"
    k = np.array([[530.0, 0.0, 360.0], [0.0, 530.0, 202.0],
                  [0.0, 0.0, 1.0]])
    save_npz(path, **make_synthetic.build(
        frames=6, markers=6, capacity=16, noise_px=0.2, camera_matrix=k,
        dist_coeffs=np.zeros(5), with_images=True, image_size=(720, 405)))
    return path


def test_viewer_path_on_card(device, image_seq, tmp_path):
    """run_slam --viz-2d --viz-3d --viz-3d-renderer fast on the card: the
    trajectory bit-identical to the card's run without viewers, B3 once
    a frame, and each overlay and map frame within 0.5% of its pixels of
    the CPU run's (the card's f32 filter differs from the CPU's in the
    last bits, and the map dots follow it)."""
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.io import read_png_rgb

    def run(tag, platform, *flags):
        return run_slam.main([
            "--input", str(image_seq), "--platform", platform,
            "--trajectory", str(tmp_path / f"{tag}.txt"),
            "--map", str(tmp_path / f"{tag}_map.txt"),
            "--viz-dir", str(tmp_path / tag), *flags])

    flags = ["--viz-2d", "--viz-3d", "--viz-3d-renderer", "fast"]
    before = cuda_mekf.fused_update.launches
    card = run("card", "cuda", *flags)
    assert cuda_mekf.fused_update.launches == before + 6
    plain = run("plain", "cuda")
    assert np.array_equal(card.cam_traj, plain.cam_traj)
    run("cpu", "cpu", *flags)
    for sub, pattern in (("2d", "frame_*.png"), ("3d", "map_*.png")):
        names = sorted(p.name for p in (tmp_path / "cpu" / sub).glob(pattern))
        assert len(names) == 6
        for name in names:
            got = read_png_rgb(tmp_path / "card" / sub / name)
            want = read_png_rgb(tmp_path / "cpu" / sub / name)
            differ = (got != want).any(axis=-1).sum()
            assert differ <= 0.005 * got.shape[0] * got.shape[1], name


# the benchmark cells' filter: run_slam's defaults at capacity 64 and
# max_obs 16 (N 201, M 48; N 393, M 112 with rotations)
GRAPH_CELL = dict(capacity=64, max_obs=16, motion_model="cv",
                  pixel_sigma=1.0, gate_distance=1.0, r_uncertainty=0.005,
                  q_uncertainty_cam=1.0, q_error_uncertainty_cam=1.0,
                  q_uncertainty_lm=0.0, q_vel=2e-3, vel_decay=0.99)


def _graph_cell_obs(device, streams, frames):
    """(T, ...) observations of a 12-marker wall along an orbit, or
    (S, T, ...) with one noise seed a stream."""
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.filters import mekf as tm
    scene = synthetic.make_wall_scene(num_markers=12, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    seqs = [synthetic.observe_poses(scene, traj, 64, noise_t=0.005,
                                    noise_r=0.005, fov_limit=0.75,
                                    seed=10 + s) for s in range(streams or 1)]
    fields = []
    for k in ("t_cl", "q_cl", "mask"):
        a = np.stack([getattr(o, k) for o in seqs]) if streams \
            else getattr(seqs[0], k)
        fields.append(torch.tensor(
            a if a.dtype == bool else a.astype(np.float32), device=device))
    return tm.FrameObservations(*fields)


def _graph_counts():
    from aruco_slam_tpu_torch.filters import mekf as tm
    return np.array([tm.mekf_scan.captures, tm.mekf_scan.graph_steps,
                     tm.mekf_scan.eager_steps, cuda_mekf.fused_update.launches])


@pytest.mark.parametrize("streams,rotations", [(None, False), (8, False),
                                               (None, True)])
def test_graphed_scan_is_the_eager_scan(device, monkeypatch, streams,
                                        rotations):
    """`mekf_scan` on the card replays its runner's two graphs around B3.
    At the benchmark cells' filter config, over 128 frames and over the
    same frames split 32 + 96: every state field and the trajectory bit
    for bit the `mekf_step` loop's; one capture for the key (the split
    scans replay it); every frame counted once, as a replay or as the
    runner's eager first frame; B3 once a frame; and the first scan's
    results its own (the later scans leave them as they were)."""
    from aruco_slam_tpu_torch.filters import mekf as tm
    from aruco_slam_tpu_torch.parallel import multi_slam
    monkeypatch.setattr(tm, "_RUNNERS", {})
    cfg = tm.MekfConfig(**GRAPH_CELL, with_rotations=rotations)
    obs = _graph_cell_obs(device, streams, 128)
    axis = 1 if streams else 0
    state0 = tm.init_state(cfg, device=device)
    if streams:
        state0 = multi_slam.stack_states([state0] * streams)
    want, poses = state0, []
    for i in range(128):
        want = tm.mekf_step(cfg, want, tm._frame(obs, i, axis))
        poses.append(tm.camera_pose(want))
    want_traj = torch.stack(poses, axis)
    c0 = _graph_counts()
    got, traj = tm.mekf_scan(cfg, state0, obs)
    c1 = _graph_counts()

    def cut(lo, hi):
        return tm.FrameObservations(*(x.narrow(axis, lo, hi - lo)
                                      for x in obs[:3]))

    mid, traj_a = tm.mekf_scan(cfg, state0, cut(0, 32))
    got2, traj_b = tm.mekf_scan(cfg, mid, cut(32, 128))
    c2 = _graph_counts()
    torch.cuda.synchronize()
    assert list(c1 - c0) == [1, 127, 1, 128]
    assert list(c2 - c1) == [0, 128, 0, 128]
    assert len(tm._RUNNERS) == 1
    for name, a, b, c in zip(tm.MekfState._fields, got, want, got2):
        assert torch.equal(a, b) and torch.equal(c, b), name
    assert torch.equal(traj, want_traj)
    assert torch.equal(torch.cat([traj_a, traj_b], axis), want_traj)


def test_graphed_step_reads_nothing_back(device, monkeypatch):
    """Graph A's work, the update and graph B's, run eagerly on the
    runner's buffers, then a whole replayed scan, under
    torch.cuda.set_sync_debug_mode("error"): nothing waits on the
    card."""
    from aruco_slam_tpu_torch.filters import mekf as tm
    monkeypatch.setattr(tm, "_RUNNERS", {})
    cfg = tm.MekfConfig(**GRAPH_CELL)
    obs = _graph_cell_obs(device, None, 8)
    state = tm.init_state(cfg, device=device)
    tm.mekf_scan(cfg, state, obs)  # the capture
    run, = tm._RUNNERS.values()
    before = tm.mekf_scan.graph_steps
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        run.predict()
        run.update()
        run.correct()
        _, traj = tm.mekf_scan(cfg, state, obs)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert tm.mekf_scan.graph_steps - before == 8
    assert bool(torch.isfinite(traj).all())


def test_run_slam_graphs_share_its_stream(device, tmp_path, monkeypatch):
    """run_slam runs a request on the card's request stream, and its
    filter's graphs are captured and replayed there (so cuBLAS keeps no
    workspace for another stream): a second request replays the first
    one's runner and ends holding the device memory the first left."""
    from aruco_slam_tpu_torch import _device
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.bench import synthetic
    from aruco_slam_tpu_torch.filters import mekf as tm
    from aruco_slam_tpu_torch.io import save_npz
    monkeypatch.setattr(tm, "_RUNNERS", {})
    scene = synthetic.make_wall_scene(num_markers=12, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=48)
    obs = synthetic.observe_poses(scene, traj, 64, noise_t=0.005,
                                  noise_r=0.005, fov_limit=0.75)
    npz = tmp_path / "poses.npz"
    save_npz(npz, times=traj.times, t_cl=obs.t_cl.astype(np.float32),
             q_cl=obs.q_cl.astype(np.float32), mask=obs.mask)
    argv = ["--input", str(npz), "--platform", "cuda", "--max-obs", "16",
            "--trajectory", str(tmp_path / "t.txt"),
            "--map", str(tmp_path / "m.txt")]
    first = run_slam.main(argv)
    torch.cuda.synchronize()
    held = torch.cuda.memory_allocated()
    c0 = _graph_counts()
    second = run_slam.main(argv)
    torch.cuda.synchronize()
    assert torch.cuda.memory_allocated() == held
    assert list(_graph_counts() - c0) == [0, 48, 0, 48]
    run, = tm._RUNNERS.values()
    stream = _device._REQUEST_STREAMS[torch.device("cuda", 0)]
    assert run.stream == stream
    assert np.array_equal(first.cam_traj, second.cam_traj)
