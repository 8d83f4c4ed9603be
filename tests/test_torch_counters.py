"""The port's counters (`utils.profiling.StageTimer.count`): run_slam's
count of the fused update's rows, ``filter.update_rows`` and
``filter.update_row_slots``, and of the map's slots,
``filter.map_slots_used`` and ``filter.map_slots``, against a hand
count from the accepted observations it returns, and of the frames
whose update took the wide GEMM tiling, ``filter.b3_wide_frames`` (none
where the update is not the kernel's), on the CPU (point and
rotation landmarks, a chunked scan, the viewers' per-frame loop and a
two-stream fleet); its count of the markers PnP solved,
``front_end.pnp_markers``, on every front end, with no launch of the
PnP kernel on the CPU (`cuda_pnp.solve.launches` before and after); and
on a card, that counting reads nothing back and launches nothing."""

import functools

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch.apps import front_end
from aruco_slam_tpu_torch.apps import make_synthetic as tsyn
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.io import save_npz
from aruco_slam_tpu_torch.ops import cuda_pnp
from aruco_slam_tpu_torch.utils import profiling

ROWS, SLOTS = "filter.update_rows", "filter.update_row_slots"
USED, MAP = "filter.map_slots_used", "filter.map_slots"
WIDE = "filter.b3_wide_frames"
PNP = "front_end.pnp_markers"
# the 1080p camera at half scale, for 960x540 frames
HALF_K = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
                   [0.0, 0.0, 1.0]])


@pytest.fixture(scope="module")
def bundles(tmp_path_factory):
    """An 8-frame pose-level bundle and a 4-frame 960x540 image bundle."""
    root = tmp_path_factory.mktemp("counters")
    poses = tsyn.build(frames=8, markers=12, capacity=16)
    img = tsyn.build(frames=4, markers=12, capacity=16, with_images=True,
                     image_size=(960, 540), camera_matrix=HALF_K)
    paths = {"poses": root / "poses.npz", "images": root / "img.npz"}
    save_npz(paths["poses"], **{k: v for k, v in poses.items()
                                if k not in ("corners", "corner_mask")})
    save_npz(paths["images"], **img)
    paths["corners"] = root / "corners.npz"
    save_npz(paths["corners"], **poses)
    return paths


def _argv(inp, out, *flags):
    return ["--input", inp, "--platform", "cpu",
            "--trajectory", str(out / "traj.txt"),
            "--map", str(out / "map.txt"), *flags]


def hand_count(masks, max_obs: int, capacity: int, meas_dims: int):
    """(rows that carry an observation, all rows) over the frames of
    every (T, C) mask, counted frame by frame."""
    k = min(max_obs, capacity)
    rows = slots = 0
    for mask in masks:
        for frame in np.asarray(mask):
            rows += min(int(np.count_nonzero(frame)), k) * meas_dims
            slots += k * meas_dims
    return rows, slots


def map_count(masks, filled=None):
    """(slots that hold a landmark by each frame, all slots) over the
    frames of every (T, C) mask, counted frame by frame: a slot holds
    one from its first accepted observation on, or from the start where
    ``filled`` (a list of slot lists, one a mask) names it."""
    used = slots = 0
    for k, mask in enumerate(masks):
        have = set() if filled is None else {int(j) for j in filled[k]}
        for frame in np.asarray(mask):
            have |= {int(j) for j in np.flatnonzero(frame)}
            used += len(have)
            slots += len(frame)
    return used, slots


def counted(rows_slots, masks, pnp=None, wide=0):
    """The counters a MEKF request should hold: the update's rows, the
    map's slots from ``masks``, the frames its update ran in the wide
    tiling (none on the CPU and at these shapes) and, where given, the
    PnP markers."""
    want = dict(zip((ROWS, SLOTS), rows_slots))
    want.update(zip((USED, MAP), map_count(masks)))
    want[WIDE] = wide
    if pnp is not None:
        want[PNP] = pnp
    return want


def test_counters_add_by_name():
    timer = profiling.StageTimer()
    assert timer.counters == {}
    timer.count("a", 3)
    timer.count("b", np.int64(2))
    timer.count("a", 4)
    assert timer.counters == {"a": 7, "b": 2}
    assert all(type(v) is int for v in timer.counters.values())


@pytest.mark.parametrize("filt,meas_dims", [("mekf", 3),
                                            ("mekf_rotations", 7)])
@pytest.mark.parametrize("flags,max_obs", [
    ((), 16), (("--max-obs", "2"), 2), (("--checkpoint-every", "3"), 16)])
def test_run_slam_counts_the_update_rows(bundles, tmp_path, filt, meas_dims,
                                         flags, max_obs):
    """One stream, point and rotation landmarks: the counters equal the
    hand count from RunResult.obs_mask, with the update's width cut below
    the densest frame and with the scan in checkpoint chunks."""
    if "--checkpoint-every" in flags:
        flags = (*flags, "--checkpoint", str(tmp_path / "ck.npz"))
    res = trun.main(_argv(str(bundles["poses"]), tmp_path, "--filter",
                          filt, "--capacity", "16", *flags))
    rows, slots = hand_count([res.obs_mask], max_obs, 16, meas_dims)
    assert res.counters == counted((rows, slots), [res.obs_mask])
    assert slots == len(res.obs_mask) * max_obs * meas_dims
    assert 0 < rows <= slots


def test_viewer_loop_counts_every_frame(bundles, tmp_path, monkeypatch):
    """The viewers' per-frame steps count as the scan does."""
    real = front_end.observations_from_frames
    monkeypatch.setattr(front_end, "observations_from_frames",
                        lambda *a: real(*a, chunk=4))
    launches = cuda_pnp.solve.launches
    res = trun.main(_argv(str(bundles["images"]), tmp_path, "--filter",
                          "mekf_rotations", "--capacity", "16", "--viz-2d",
                          "--viz-dir", str(tmp_path / "viz")))
    want = hand_count([res.obs_mask], 16, 16, 7)
    assert res.counters == counted(want, [res.obs_mask], 4 * 16)
    assert cuda_pnp.solve.launches == launches
    assert want == (7 * int(res.obs_mask.sum()), 4 * 16 * 7)


@pytest.mark.parametrize("filt,meas_dims", [("mekf", 3),
                                            ("mekf_rotations", 7)])
def test_fleet_counts_its_streams_together(bundles, tmp_path, monkeypatch,
                                           filt, meas_dims):
    """A two-stream fleet: every stream's result holds the request's
    counters, the hand count over both streams' masks."""
    monkeypatch.setattr(trun, "run_multi_stream", functools.partial(
        trun.run_multi_stream, chunk=4))
    inp = ",".join([str(bundles["images"])] * 2)
    launches = cuda_pnp.solve.launches
    res = trun.main(_argv(inp, tmp_path, "--filter", filt, "--capacity",
                          "16"))
    assert len(res) == 2 and res[0].counters is res[1].counters
    want = hand_count([r.obs_mask for r in res], 16, 16, meas_dims)
    assert res[0].counters == counted(want, [r.obs_mask for r in res],
                                      2 * 4 * 16)
    assert cuda_pnp.solve.launches == launches
    assert want[0] > 0


@pytest.mark.parametrize("inp,chunk,markers", [
    ("corners", None, 8 * 16), ("images", 4, 4 * 16),
    ("images", 3, 6 * 16), ("images", None, 32 * 16)])
def test_run_slam_counts_the_pnp_markers(bundles, tmp_path, monkeypatch,
                                         inp, chunk, markers):
    """One stream from corners (one PnP call a request) and from images
    (one a chunk, the tail chunk padded to the chunk's frames, which PnP
    solves too): every slot of every call counts, and the kernel
    launches nothing on the CPU."""
    if chunk:
        real = front_end.observations_from_frames
        monkeypatch.setattr(front_end, "observations_from_frames",
                            lambda *a: real(*a, chunk=chunk))
    launches = cuda_pnp.solve.launches
    res = trun.main(_argv(str(bundles[inp]), tmp_path, "--capacity", "16"))
    assert res.counters[PNP] == markers
    assert cuda_pnp.solve.launches == launches


def test_sharded_ingest_counts_the_pnp_markers(bundles):
    """The distributed image front end's replicated PnP counts as the
    single front end's, chunk by chunk (one process here)."""
    from aruco_slam_tpu_torch.config import SlamAppConfig
    from aruco_slam_tpu_torch.io import NpzSource
    src = NpzSource(str(bundles["images"]))
    cfg = SlamAppConfig(input=str(bundles["images"]), capacity=16)
    cpu = torch.device("cpu")
    cam = front_end.camera(src["camera_matrix"], src["dist_coeffs"], cpu)
    timers = [profiling.StageTimer(), profiling.StageTimer()]
    launches = cuda_pnp.solve.launches
    front_end.observations_from_frames_sharded(
        zip(src.times, src["images"]), cam, cfg, cpu, 0, 1, chunk=3,
        timer=timers[0])
    front_end.observations_from_frames(
        zip(src.times, src["images"]), cam, cfg, cpu, timers[1], chunk=3)
    assert timers[0].counters == timers[1].counters == {PNP: 6 * 16}
    assert cuda_pnp.solve.launches == launches
    assert timers[0].totals["front_end.pnp"] > 0


def test_factor_graph_counts_no_update_rows(bundles, tmp_path):
    res = trun.main(_argv(str(bundles["poses"]), tmp_path, "--filter",
                          "factorgraph"))
    assert res.counters == {}


@pytest.mark.cuda
@pytest.mark.parametrize("rotations", [False, True])
def test_counting_reads_nothing_back_and_launches_nothing(tmp_path,
                                                          monkeypatch,
                                                          rotations):
    """run_slam on the card, its scan replayed from the graphs: the count
    after each scan runs under torch.cuda.set_sync_debug_mode("error")
    and under a profiler that sees no device work and no launch in it;
    a second request's scan replays the first one's graphs, and its
    counters equal the hand count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphed scan runs on a card")
    from torch.profiler import ProfilerActivity, profile

    from aruco_slam_tpu_torch.filters import mekf as tm
    npz = tmp_path / "poses.npz"
    poses = tsyn.build(frames=48, markers=12, capacity=64)
    save_npz(npz, **{k: v for k, v in poses.items()
                     if k not in ("corners", "corner_mask")})
    real = trun._count_update_rows
    seen = []

    def count(timer, fcfg, mask):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                real(timer, fcfg, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen.append([e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     or "Launch" in e.name or "Memcpy" in e.name])
    monkeypatch.setattr(trun, "_count_update_rows", count)
    argv = ["--input", str(npz), "--platform", "cuda", "--max-obs", "16",
            "--trajectory", str(tmp_path / "t.txt"),
            "--map", str(tmp_path / "m.txt")]
    if rotations:
        argv += ["--filter", "mekf_rotations"]
    trun.main(argv)
    steps = tm.mekf_scan.graph_steps
    res = trun.main(argv)
    assert tm.mekf_scan.graph_steps - steps == 48
    assert seen == [[], []]
    assert res.counters == counted(hand_count(
        [res.obs_mask], 16, 64, 7 if rotations else 3), [res.obs_mask])
