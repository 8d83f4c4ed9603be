"""The 512-marker survey configuration (``survey512-mekf``: capacity 512,
``--max-obs 48``, ``dict_5x5_1000``, so N 1545 and M 144) through the
harness on CPU-sized clips of its 16 x 32 grid wall: the plain reference
agrees with run_slam.main --platform cpu; a fault in the filter's
blocked augmentation (N >= 768) reads ``correct`` false; and a traced run
reads the map's used slots from the program's counters, equal to a hand
count from the traced requests' accepted observations."""

import json
import time

import numpy as np
import pytest
import torch

from benchmark import counters, harness, manifest, trace
from conftest import ROOT, tiny_root

NEW = "map_slots_used_pct"
CELL = "survey512-mekf.corners"


def _root(tmp_path, frames=4):
    root = tiny_root(tmp_path, kind="corners", frames=frames)
    path = root / "benchmark/configs/tiny.json"
    cfg = json.loads(path.read_text())
    cfg.update(capacity=512, max_obs=48, dict="dict_5x5_1000")
    path.write_text(json.dumps(cfg))
    path = root / "benchmark/traffic/tiny.json"
    tr = json.loads(path.read_text())
    tr.update(grid=[16, 32], wall_extent=7.0)
    path.write_text(json.dumps(tr))
    return root


def _traced(cell, seed, seconds, platform, cache=None):
    """A traced run of ``cell`` and the traced requests' results."""
    real = trace.run
    values = []

    def run(*args, **kwargs):
        out = real(*args, **kwargs)
        values.append((out["value"], out["record"]))
        return out
    kw = {} if cache is None else dict(cache=cache)
    try:
        trace.run = run
        out = harness.run_cell(cell, seed, seconds, True, time.perf_counter(),
                               platform=platform, **kw)["result"]
    finally:
        trace.run = real
    return out, values[0]


def hand_pct(requests) -> float:
    """100 x the slots observed at or before each frame over all slots of
    every frame, from each traced request's accepted observations."""
    used = slots = 0
    for req in requests:
        for stream in req.streams:
            mask = np.asarray(stream.obs_mask, bool)
            used += int(np.logical_or.accumulate(mask, 0).sum())
            slots += mask.size
    return 100.0 * used / slots


def test_survey_agrees_and_reads_its_map_slots_on_the_cpu(tmp_path):
    """The tiny survey cell is correct, and its traced run reads
    ``map_slots_used_pct`` as the hand count from the traced requests'
    masks."""
    cell = manifest.resolve("tiny.t", _root(tmp_path))
    assert cell.config["capacity"] == 512
    res, (reqs, record) = _traced(cell, 3 * 2**31 + 5, 0.01, "cpu",
                                  tmp_path / "pools")
    assert res["correct"] is True, res["checks"]
    checks = {k: v["value"] for k, v in res["checks"].items()}
    assert checks["obs_diff"] == 0 and checks["map_ids_diff"] == 0
    assert checks["traj_gap_m"] < 2e-6
    got = res["metrics"][NEW]["value"]
    assert got == pytest.approx(hand_pct(reqs), abs=1e-9)
    assert 0 < got < 100
    assert record["calls"]["counters"][0]["filter.map_slots"] == 4 * 512


def _augmentation_without_epe(monkeypatch):
    """The blocked augmentation (N >= 768) drops its G P_cc G^T term: a
    new landmark's covariance no longer takes the camera's."""
    from aruco_slam_tpu_torch.filters import mekf
    real = mekf._augment_consistent

    def augment(cfg, state, new, new_dims, t_cl, q_cl, r_init,
                mm=torch.matmul):
        cov = real(cfg, state, new, new_dims, t_cl, q_cl, r_init, mm)
        assert cfg.err_dim >= 768  # the blocked branch
        ce = cfg.cam_edims
        j_cam = mekf._init_jacobians(state.cam_q, t_cl, ce,
                                     cfg.with_rotations)[0]
        g = torch.where(new[..., None, None], j_cam, 0.0).reshape(
            *new.shape[:-1], -1, ce)
        p_cc = state.cov[..., :ce, :ce]
        cut = cov.clone()
        cut[..., ce:, ce:] -= g @ p_cc @ g.transpose(-1, -2)
        return torch.where(new.any(-1)[..., None, None], cut, cov)
    monkeypatch.setattr(mekf, "_augment_consistent", augment)


def test_a_broken_blocked_augmentation_is_not_correct(tmp_path,
                                                      monkeypatch):
    _augmentation_without_epe(monkeypatch)
    cell = manifest.resolve("tiny.t", _root(tmp_path, frames=6))
    res = harness.run_cell(cell, 3 * 2**31 + 5, 0.01, False,
                           time.perf_counter(), platform="cpu",
                           cache=tmp_path / "pools")["result"]
    assert res["correct"] is False, res["checks"]


def test_the_probe_reads_no_map_slots_from_a_program_without_them():
    """The parent's program keeps no map-slot counters: the reader
    returns None without raising; with them it is their ratio."""
    reader = manifest.load_reader(ROOT / "benchmark/metrics" / f"{NEW}.py")
    assert reader.PROBES is counters.PROBES
    reqs = [{"frames": 128, "seconds": {}}]
    old = {"filter.update_rows": 700, "filter.update_row_slots": 14336}
    for calls in ({}, {"counters": []}, {"counters": [None]},
                  {"counters": [old, old]}):
        assert reader.read({"requests": reqs, "calls": calls}) is None
    rec = {"requests": reqs, "calls": {"counters": [
        dict(old, **{"filter.map_slots_used": 6000,
                     "filter.map_slots": 65536}),
        dict(old, **{"filter.map_slots_used": 7000,
                     "filter.map_slots": 65536})]}}
    assert reader.read(rec) == pytest.approx(100 * 13000 / 131072)


def test_the_cell_and_its_metric_are_declared():
    """The configuration differs from mono1080-mekf's in its name,
    deployment, source, dictionary, capacity, max_obs and what it
    assumes; the cell reports every per-layer metric the rotation
    corners cell does, the new one in all four cells."""
    man = manifest.load_manifest()
    mono = json.loads((ROOT / "benchmark/configs/mono1080-mekf.json")
                      .read_text())
    survey = json.loads((ROOT / "benchmark/configs/survey512-mekf.json")
                        .read_text())
    differ = {k for k in mono if mono[k] != survey.get(k)}
    assert differ == {"name", "deployment", "source", "dict", "capacity",
                      "max_obs", "assumed"}
    assert (survey["capacity"], survey["max_obs"], survey["reduced"]) == (
        512, 48, [])
    cell = manifest.resolve(CELL)
    rot = manifest.resolve("mono1080-rot.corners")
    assert cell.traffic["kind"] == "corners"
    assert cell.traffic["grid"] == [16, 32]
    names = [m["name"] for m, _ in cell.per_layer]
    assert names == [m["name"] for m, _ in rot.per_layer]
    assert NEW in names
    entry = {m["name"]: m for m in man["per_layer"]}[NEW]
    assert entry["layer"] == "filter" and entry["moves"] == "frames_per_s"
    assert entry["workloads"] == [w["name"] for w in man["workloads"]]
    assert man["workloads"][-1]["name"] == CELL


@pytest.mark.cuda
def test_the_traced_survey_probes_b3_in_its_rows_form(cuda_device):
    """On the card, a traced run of the survey cell at the real size for
    a short window: B3's probed shapes are (1, 1545, 144), its traced
    kernels include the rows form's ``ns_cluster``, and the map's used
    slots read as the hand count from the traced requests."""
    from benchmark.records import kernel_id
    res, (reqs, record) = _traced(manifest.resolve(CELL), 7 * 10**9 + 23,
                                  0.5, "cuda")
    assert res["correct"] is True, res["checks"]
    assert {c[:3] for c in record["calls"]["b3"]} == {(1, 1545, 144)}
    kernels = {kernel_id(n) for n, _, _ in record["device_events"]}
    assert "ns_cluster" in kernels and "ns_cluster_cols" not in kernels
    assert res["metrics"][NEW]["value"] == pytest.approx(hand_pct(reqs),
                                                         abs=0.1)
