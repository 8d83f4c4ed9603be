"""The 512-marker survey (the benchmark's ``survey512-mekf`` configuration:
``run_slam --capacity 512 --max-obs 48 --dict dict_5x5_1000``, N 1545,
M 144) and the map-slot counters.

On the CPU: run_slam.main at the configuration's flags on a short clip of
the survey traffic agrees with the benchmark's plain reference
(`benchmark.reference.slam`), through the filter's blocked augmentation
(N >= 768); ``filter.map_slots_used`` and ``filter.map_slots`` equal a
hand count from the accepted observations for the survey's stream, a
run seeded by ``--load-map`` and one resumed from a checkpoint (the
fleet's and the viewers' counts: tests/test_torch_counters.py).
On a card: counting reads nothing back and launches nothing in the
graphed scan at capacity 512, and B3 at (N 1545, M 144) runs its "rows"
Newton-Schulz form and agrees with its plain version."""

import json
from pathlib import Path

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch.apps import make_synthetic as tsyn
from aruco_slam_tpu_torch.apps import run_slam as trun
from aruco_slam_tpu_torch.filters import mekf as tm
from aruco_slam_tpu_torch.io import load_map, save_npz
from benchmark import check, harness, traffic
from benchmark.reference import slam
from test_torch_counters import MAP, USED, map_count

ROOT = Path(__file__).resolve().parents[1]
CONFIG = json.loads((ROOT / "benchmark/configs/survey512-mekf.json")
                    .read_text())
TRAFFIC = json.loads((ROOT / "benchmark/traffic/survey-corners.json")
                     .read_text())


def survey_clip(tmp_path, frames: int, seed: int = 2**31 + 221) -> Path:
    """One corner clip of the survey traffic, ``frames`` long."""
    tr = dict(TRAFFIC, frames=frames, pool_offsets=[0])
    return traffic.build_pool(CONFIG, tr, seed, cache=tmp_path / "pools",
                              processes=1)[0][0]


def _argv(inp, out, *flags, platform="cpu"):
    return ["--input", str(inp), "--platform", platform,
            "--trajectory", str(out / "traj.txt"),
            "--map", str(out / "map.txt"), *flags]


def test_survey_agrees_with_the_reference_on_the_cpu(tmp_path, monkeypatch):
    """12 frames at N 1545: the accepted observations and the map's ids
    equal the reference's, the trajectory and map within the output
    files' rounding; every frame augments through the blocked branch,
    and the map-slot counters equal the hand count."""
    npz = survey_clip(tmp_path, 12)
    branch = []
    real = tm._augment_consistent

    def augment(cfg, *args, **kwargs):
        branch.append(cfg.err_dim)
        return real(cfg, *args, **kwargs)
    monkeypatch.setattr(tm, "_augment_consistent", augment)
    res = trun.main(_argv(npz, tmp_path, *harness.config_flags(CONFIG)))
    assert branch and set(branch) == {9 + 512 * 3}
    with np.load(npz) as z:
        ref = slam.run([{k: z[k] for k in z.files}], CONFIG, None,
                       torch.device("cpu"))[0]
    got = check.compare_stream(check.Output(
        res.cam_traj, res.obs_mask, res.landmark_ids,
        Path(res.trajectory_file), Path(res.map_file)), ref)
    assert got["obs_diff"] == 0 and got["map_ids_diff"] == 0, got
    assert got["traj_gap_m"] < 2e-6 and got["map_gap_m"] < 2e-6, got
    assert res.obs_mask.shape == (12, 512)
    assert 4 <= res.obs_mask.sum(1).min() and res.obs_mask.sum(1).max() <= 48
    used, slots = map_count([res.obs_mask])
    assert (res.counters[USED], res.counters[MAP]) == (used, slots)
    assert slots == 12 * 512 and 0 < used < slots


@pytest.fixture(scope="module")
def poses(tmp_path_factory):
    """A 9-frame pose-level bundle at capacity 16."""
    path = tmp_path_factory.mktemp("survey") / "poses.npz"
    b = tsyn.build(frames=9, markers=12, capacity=16)
    save_npz(path, **{k: v for k, v in b.items()
                      if k not in ("corners", "corner_mask")})
    return path


def test_a_loaded_map_fills_its_slots_from_the_first_frame(poses, tmp_path):
    """``--load-map``: the map file's landmarks hold their slots before
    the first frame, those the run then observes join them. The map
    keeps the landmarks the run first observes after its first frame."""
    first = trun.main(_argv(poses, tmp_path / "a", "--capacity", "16"))
    ids = load_map(first.map_file)[0]
    first_seen = first.obs_mask.argmax(0)[ids]
    late = np.flatnonzero(first_seen > 0)
    assert len(late)
    lines = Path(first.map_file).read_text().splitlines(keepends=True)
    keep = tmp_path / "kept.txt"  # four header lines, four lines a record
    keep.write_text("".join(lines[:4] + [ln for k in late for ln in
                                         lines[4 + 4 * k:8 + 4 * k]]))
    res = trun.main(_argv(poses, tmp_path / "b", "--capacity", "16",
                          "--load-map", str(keep)))
    used, slots = map_count([res.obs_mask], [ids[late]])
    assert (res.counters[USED], res.counters[MAP]) == (used, slots)
    assert used > map_count([res.obs_mask])[0]


def test_a_resumed_run_counts_from_its_checkpoint(poses, tmp_path):
    """``--resume``: the frames after the checkpoint count, the slots the
    checkpoint's state holds filled from the first of them."""
    ck = tmp_path / "ck.npz"
    trun.main(_argv(poses, tmp_path / "a", "--capacity", "16",
                    "--checkpoint-every", "4", "--checkpoint", str(ck)))
    res = trun.main(_argv(poses, tmp_path / "b", "--capacity", "16",
                          "--resume", str(ck)))
    state = trun.load_checkpoint(ck, (tm.init_state(tm.MekfConfig(
        capacity=16)), np.int64(0), np.zeros((1, 7))))
    start, active = int(state[1]), state[0].active.numpy()
    assert start == 8 and active.any()
    used, slots = map_count([res.obs_mask[start:]],
                            [np.flatnonzero(active)])
    assert (res.counters[USED], res.counters[MAP]) == (used, slots)
    assert slots == (9 - start) * 16


@pytest.mark.cuda
def test_counting_the_map_slots_reads_nothing_back(tmp_path, monkeypatch):
    """run_slam on the card at the survey's flags, its scan replayed from
    the graphs at N 1545: the map-slot count after each scan runs under
    torch.cuda.set_sync_debug_mode("error") and under a profiler that
    sees no device work and no launch in it; a second request replays
    the first one's graphs and counts as the hand count."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the graphed scan runs on a card")
    from torch.profiler import ProfilerActivity, profile
    npz = survey_clip(tmp_path, 48)
    real = trun._count_map_slots
    seen = []

    def count(timer, filled, mask):
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                out = real(timer, filled, mask)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        seen.append([e.name for e in prof.events()
                     if e.device_type == torch.autograd.DeviceType.CUDA
                     or "Launch" in e.name or "Memcpy" in e.name])
        return out
    monkeypatch.setattr(trun, "_count_map_slots", count)
    argv = _argv(npz, tmp_path, *harness.config_flags(CONFIG),
                 platform="cuda")
    trun.main(argv)
    steps = tm.mekf_scan.graph_steps
    res = trun.main(argv)
    assert tm.mekf_scan.graph_steps - steps == 48
    assert seen == [[], []]
    assert (res.counters[USED], res.counters[MAP]) == map_count(
        [res.obs_mask])


@pytest.mark.cuda
def test_b3_at_the_survey_shape_runs_the_rows_form():
    """B3 at (N 1545, M 144): the "rows" Newton-Schulz form, 1e-4
    relative of the plain version (B3's tolerance at every shape),
    exactly symmetric."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: B3 is a CUDA kernel")
    from aruco_slam_tpu_torch.filters import cuda_mekf
    n, m = 9 + 512 * 3, 48 * 3
    assert cuda_mekf.newton_schulz_form(m) == "rows"
    rng = np.random.default_rng(1545)
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    args = [torch.tensor(x, dtype=torch.float32, device="cuda") for x in (
        a @ a.T * 0.05 + 0.01 * np.eye(n), rng.normal(size=(m, n)) * 0.3,
        rng.uniform(1e-3, 1e-2, m), 0.01 * rng.normal(size=m))]
    inn, pn = cuda_mekf.fused_update(*args)
    inn_p, pn_p = cuda_mekf.fused_update_plain(*args)
    for got, want in ((inn, inn_p), (pn, pn_p)):
        err = (got - want).abs().max().item()
        assert err <= 1e-4 * max(1.0, want.abs().max().item())
    assert torch.equal(pn, pn.T)
