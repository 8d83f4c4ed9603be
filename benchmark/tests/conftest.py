"""The benchmark's own tests: ``python -m pytest benchmark/tests`` from the
repository root (CPU; the tests marked ``cuda`` run on a card)."""

import json
import shutil
import sys
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# a 960x540 camera (the 1080p one at half scale) for CPU-sized cells
HALF_K = [[707.45, 0.0, 483.5], [0.0, 707.45, 272.15], [0.0, 0.0, 1.0]]


@pytest.fixture
def cuda_device():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def tiny_root(tmp: Path, kind: str = "corners", streams: int = 1,
              frames: int = 4, flags=(), limit: float = 1e-4) -> Path:
    """A copy of the benchmark's data files with one more cell,
    ``tiny.t``: a 960x540 configuration and a ``frames``-frame traffic
    mix, added as files and entries only."""
    root = Path(tmp) / "root"
    (root / "benchmark").mkdir(parents=True)
    for d in ("configs", "traffic", "limits", "metrics"):
        shutil.copytree(ROOT / "benchmark" / d, root / "benchmark" / d)
    man = json.loads((ROOT / "BENCHMARK.json").read_text())
    cfg = json.loads((ROOT / "benchmark/configs/mono1080-mekf.json")
                     .read_text())
    cfg.update(name="tiny", streams=streams, image_size=[960, 540],
               camera_matrix=HALF_K)
    (root / "benchmark/configs/tiny.json").write_text(json.dumps(cfg))
    tr = json.loads((ROOT / "benchmark/traffic/full.json").read_text())
    tr.update(kind=kind, frames=frames, pool_offsets=[0, 40],
              noise_px=0.5, run_slam=list(flags), trace_requests=1,
              check_entries=2)
    (root / "benchmark/traffic/tiny.json").write_text(json.dumps(tr))
    (root / "benchmark/limits/tiny.t.json").write_text(json.dumps(
        {"traj_gap_m": limit, "rot_gap_rad": limit, "obs_diff": 0,
         "map_ids_diff": 0, "map_gap_m": limit}))
    man["configs"].append({"name": "tiny", "source": "test",
                           "file": "benchmark/configs/tiny.json",
                           "reduced": [], "why": "a CPU-sized cell"})
    man["workloads"].append({"name": "tiny.t", "config": "tiny",
                             "traffic": "tiny", "chips": 1,
                             "why": "a CPU-sized cell"})
    for m in man["per_layer"]:
        if "workloads" in m and (kind == "images"
                                 or not m["name"].startswith(("b1", "b2"))):
            m["workloads"].append("tiny.t")
    (root / "BENCHMARK.json").write_text(json.dumps(man))
    return root
