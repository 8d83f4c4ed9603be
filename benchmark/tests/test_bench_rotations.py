"""The configuration with landmark rotations (``--filter mekf_rotations``)
through the harness on CPU-sized clips: the plain reference agrees with
run_slam.main --platform cpu; breaking the program's rotation path
underneath reads ``correct`` false; and a traced run reads the update's
rows from the program's counters, 7 a landmark observation where point
landmarks give 3."""

import json
import time

import pytest
import torch

from benchmark import counters, harness, manifest
from conftest import ROOT, tiny_root

NEW = ("update_rows_per_frame", "update_rows_used_pct")


def _root(tmp_path, kind="corners", frames=4, filt="mekf_rotations"):
    root = tiny_root(tmp_path, kind=kind, frames=frames)
    path = root / "benchmark/configs/tiny.json"
    cfg = json.loads(path.read_text())
    cfg["filter"] = filt
    path.write_text(json.dumps(cfg))
    return root


def _run(tmp_path, kind="corners", frames=4, trace=False,
         filt="mekf_rotations", seed=3 * 2**31 + 1):
    cell = manifest.resolve("tiny.t", _root(tmp_path, kind, frames, filt))
    return harness.run_cell(cell, seed, 0.01, trace, time.perf_counter(),
                            platform="cpu", cache=tmp_path / "pools")


@pytest.mark.parametrize("kind", ["corners", "images"])
def test_reference_agrees_with_run_slam_on_the_cpu(tmp_path, kind):
    res = _run(tmp_path, kind)["result"]
    assert res["correct"] is True, res["checks"]
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["obs_diff"] == 0 and checks["map_ids_diff"] == 0
    # the TUM file's six decimals are the gap
    assert checks["traj_gap_m"] < 2e-6


def _no_attitude_rows(monkeypatch):
    """The observed orientation tells the filter nothing: the attitude
    rows' Jacobians are zero."""
    from aruco_slam_tpu_torch.filters import mekf
    real = mekf._pose_jacobians

    def jacobians(*args, **kwargs):
        h_all, j_cam, j_lm = real(*args, **kwargs)
        j_cam, j_lm = j_cam.clone(), j_lm.clone()
        j_cam[..., 3:, :] = 0.0
        j_lm[..., 3:, :] = 0.0
        return h_all, j_cam, j_lm
    monkeypatch.setattr(mekf, "_pose_jacobians", jacobians)


def _landmark_rotations_frozen(monkeypatch):
    """The update's correction of each landmark's quaternion is zeroed."""
    from aruco_slam_tpu_torch.filters import mekf
    real = mekf._correct

    def correct(cfg, pred, innovation, cov, prev_t):
        inn = innovation.clone()
        lm = inn[..., cfg.cam_edims:].unflatten(-1, (cfg.capacity,
                                                     cfg.lm_edims))
        lm[..., 3:6] = 0.0
        return real(cfg, pred, inn, cov, prev_t)
    monkeypatch.setattr(mekf, "_correct", correct)


def _point_landmarks(monkeypatch):
    """The run filters point landmarks where the configuration asks for
    their rotations."""
    from aruco_slam_tpu_torch.apps import run_slam
    real = run_slam._mekf_config

    def config(cfg, capacity, max_obs, with_rotations, cam):
        return real(cfg, capacity, max_obs, False, cam)
    monkeypatch.setattr(run_slam, "_mekf_config", config)


@pytest.mark.parametrize("fault", [_no_attitude_rows,
                                   _landmark_rotations_frozen,
                                   _point_landmarks])
def test_a_broken_rotation_path_is_not_correct(tmp_path, monkeypatch, fault):
    fault(monkeypatch)
    res = _run(tmp_path, frames=6)["result"]
    assert res["correct"] is False, res["checks"]


def test_a_traced_run_reads_the_update_rows(tmp_path):
    """Both new metrics read from the counters on the CPU; on the same
    seed the rotation cell gives 7/3 the rows of the point cell and the
    same share of B3's rows (the clips, so the masks, are the same)."""
    got = {}
    for filt in ("mekf_rotations", "mekf"):
        out = _run(tmp_path / filt, trace=True, filt=filt)
        res = out["result"]
        assert res["correct"] is True, res["checks"]
        got[filt] = {k: res["metrics"][k]["value"] for k in NEW}
        assert got[filt]["update_rows_per_frame"] > 0
        assert 0 < got[filt]["update_rows_used_pct"] <= 100
    rot, pt = got["mekf_rotations"], got["mekf"]
    assert rot["update_rows_per_frame"] == pytest.approx(
        7 / 3 * pt["update_rows_per_frame"], rel=1e-12)
    assert rot["update_rows_used_pct"] == pytest.approx(
        pt["update_rows_used_pct"], rel=1e-12)


def test_the_probe_reads_nothing_from_a_program_without_counters():
    """The parent's program: its timer keeps no counters, the probe
    records None, and each new reader returns None without raising."""
    from aruco_slam_tpu_torch.utils.profiling import StageTimer

    class OldTimer:
        totals = {}

    assert counters.held(["--input", "x"], OldTimer()) is None
    timer = StageTimer()
    assert counters.held(["--input", "x"], timer) is timer.counters
    reqs = [{"frames": 128, "seconds": {}}]
    for calls in ({}, {"counters": []}, {"counters": [None, None]},
                  {"counters": [{}]}):
        rec = {"requests": reqs, "calls": calls}
        for name in NEW:
            reader = manifest.load_reader(ROOT / "benchmark/metrics"
                                          / f"{name}.py")
            assert reader.read(rec) is None, (name, calls)
    rec = {"requests": reqs, "calls": {"counters": [
        {"filter.update_rows": 700, "filter.update_row_slots": 14336},
        {"filter.update_rows": 700, "filter.update_row_slots": 14336}]}}
    assert manifest.load_reader(
        ROOT / "benchmark/metrics/update_rows_per_frame.py").read(rec) == \
        pytest.approx(1400 / 256)
    assert manifest.load_reader(
        ROOT / "benchmark/metrics/update_rows_used_pct.py").read(rec) == \
        pytest.approx(100 * 700 / 14336)


def test_the_cell_and_its_metrics_are_declared():
    """The configuration differs from mono1080-mekf's in its name, its
    deployment, its source, its filter and what it assumes; the cell
    reports every per-layer metric the point-landmark corners cell does,
    and the two new ones in all three cells."""
    man = manifest.load_manifest()
    mono = json.loads((ROOT / "benchmark/configs/mono1080-mekf.json")
                      .read_text())
    rot = json.loads((ROOT / "benchmark/configs/mono1080-rot.json")
                     .read_text())
    differ = {k for k in mono if mono[k] != rot.get(k)}
    assert differ == {"name", "deployment", "source", "filter", "assumed"}
    assert rot["filter"] == "mekf_rotations" and rot["reduced"] == []
    cell = manifest.resolve("mono1080-rot.corners")
    point = manifest.resolve("mono1080-mekf.corners")
    assert cell.traffic == point.traffic
    names = [m["name"] for m, _ in cell.per_layer]
    assert names == [m["name"] for m, _ in point.per_layer]
    assert set(NEW) <= set(names)
    entries = {m["name"]: m for m in man["per_layer"]}
    for name in NEW:
        assert entries[name]["layer"] == "filter"
        assert entries[name]["workloads"] == [w["name"] for w in
                                              man["workloads"]]


@pytest.mark.cuda
def test_the_traced_cell_probes_b3_at_its_shape_on_the_card(cuda_device):
    """On the card, a traced run of the rotation cell at the real size
    for a short window: B3's probed shapes are (1, 393, 112) and the rows
    come from the counters."""
    from benchmark import trace
    real = trace.run
    records = []

    def run(*args, **kwargs):
        out = real(*args, **kwargs)
        records.append(out["record"])
        return out
    cell = manifest.resolve("mono1080-rot.corners")
    try:
        trace.run = run
        out = harness.run_cell(cell, 7 * 10**9 + 3, 0.5, True,
                               time.perf_counter())["result"]
    finally:
        trace.run = real
    assert out["correct"] is True, out["checks"]
    assert {c[:3] for c in records[0]["calls"]["b3"]} == {(1, 393, 112)}
    for name in NEW:
        assert out["metrics"][name]["value"] > 0
    assert torch.cuda.is_available()
