"""BENCHMARK.json against the contract's shape, the files it names, and
the harness's refusals."""

import ast
import json
import re
import subprocess
import sys
import time

import pytest

from benchmark import harness, manifest
from conftest import ROOT, tiny_root

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def test_manifest_keys_and_names():
    man = manifest.load_manifest()
    assert set(man) == {"command", "paths", "run_seconds", "configs",
                        "workloads", "end_to_end", "per_layer"}
    assert man["paths"] == ["benchmark"]
    assert 1 <= man["run_seconds"] <= 51
    for c in man["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith("benchmark/") and c["reduced"] == []
    names = [x["name"] for k in ("configs", "workloads", "end_to_end",
                                 "per_layer") for x in man[k]]
    assert all(NAME.match(n) for n in names)
    e2e = {m["name"] for m in man["end_to_end"]}
    assert "setup_s" in e2e
    for m in man["end_to_end"]:
        assert UNIT.match(m["unit"]) and m["source"] in (
            "host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    cells = {w["name"] for w in man["workloads"]}
    for m in man["per_layer"]:
        assert UNIT.match(m["unit"]) and m["moves"] in e2e
        assert set(m["workloads"]) <= cells
    for w in man["workloads"]:
        assert w["chips"] == 1 and len(w["why"]) <= 200
    assert len(json.dumps(man)) < 64 * 1024


@pytest.mark.parametrize("cell", [w["name"] for w in
                                  manifest.load_manifest()["workloads"]])
def test_every_cell_resolves(cell):
    c = manifest.resolve(cell)
    assert c.config["name"] == cell.split(".")[0]
    assert set(c.limits) == {"traj_gap_m", "rot_gap_rad", "obs_diff",
                             "map_ids_diff", "map_gap_m"}
    assert {m["name"] for m in c.end_to_end} == {"frames_per_s",
                                                 "peak_mem_gib", "setup_s"}
    assert len(c.per_layer) >= 1
    for m, reader in c.per_layer:
        assert m["moves"] == "frames_per_s" and callable(reader.read)


def test_added_files_are_taken_up_without_an_edit(tmp_path):
    """A cell, configuration, traffic mix and per-layer metric added as
    files and entries run through the harness: the existing files stay
    as they are."""
    root = tiny_root(tmp_path)
    (root / "benchmark/metrics/dummy_requests.py").write_text(
        "def read(record):\n    return float(len(record['requests']))\n")
    man = json.loads((root / "BENCHMARK.json").read_text())
    man["per_layer"].append({"name": "dummy_requests", "unit": "count",
                             "better": "higher", "source": "program_span",
                             "layer": "driver and input",
                             "moves": "frames_per_s",
                             "workloads": ["tiny.t"]})
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    cell = manifest.resolve("tiny.t", root)
    out = harness.run_cell(cell, 2**31 + 17, 0.01, True, time.perf_counter(),
                           platform="cpu", cache=tmp_path / "pools")
    res = out["result"]
    assert res["correct"] is True, res["checks"]
    assert res["metrics"]["dummy_requests"]["value"] >= 1
    assert "filter_ms_per_frame" in res["metrics"]
    assert list(res)[-1] == "checks"


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module \
                and node.level == 0:
            yield node.module


def test_no_module_imports_jax_or_the_jax_package():
    """Top-level names compared whole: aruco_slam_tpu_torch is the port,
    aruco_slam_tpu the JAX package."""
    banned = {"jax", "jaxlib", "flax", "aruco_slam_tpu"}
    for path in (ROOT / "benchmark").rglob("*.py"):
        if "tests" in path.parts:
            continue
        tops = {m.split(".")[0] for m in _imports(path)}
        assert not tops & banned, (path, tops & banned)


def test_reference_and_yardstick_import_nothing_of_the_program():
    for sub in ("reference", "traffic_gen", "roofline", "metrics"):
        for path in (ROOT / "benchmark" / sub).rglob("*.py"):
            tops = {m.split(".")[0] for m in _imports(path)}
            assert "aruco_slam_tpu_torch" not in tops, path
    for name in ("traffic.py", "check.py", "records.py", "manifest.py"):
        tops = {m.split(".")[0] for m in _imports(ROOT / "benchmark" / name)}
        assert "aruco_slam_tpu_torch" not in tops, name


def test_banned_modules_compares_whole_names(monkeypatch):
    monkeypatch.setitem(sys.modules, "aruco_slam_tpu_torch_x", sys)
    assert "aruco_slam_tpu" not in harness.banned_modules()
    monkeypatch.setitem(sys.modules, "aruco_slam_tpu.core", sys)
    assert harness.banned_modules() == ["aruco_slam_tpu"]


def test_command_refuses_to_run_without_a_card():
    import torch
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    p = subprocess.run([sys.executable, str(ROOT / "benchmark/run.py"),
                        "--workload", "mono1080-mekf.full", "--seed",
                        "5000000001", "--seconds", "1", "--trace", "0"],
                       capture_output=True, text=True, timeout=120,
                       cwd=ROOT)
    assert p.returncode != 0
    assert "no CUDA device" in p.stderr
    assert '"correct"' not in p.stdout
