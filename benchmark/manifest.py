"""BENCHMARK.json and the files it names.

Everything of one configuration, traffic mix, per-layer metric or cell
sits in a file of its own, found by name:

- ``configs/<config>.json``: the deployment (camera, dictionary, map
  capacity, filter settings, cameras on the card);
- ``traffic/<traffic>.json``: the parameters of the one generator
  (`benchmark.traffic`);
- ``metrics/<metric>.py``: a reader with ``read(record) -> float | None``
  and, where it needs call shapes, ``PROBES``;
- ``limits/<workload>.json``: the numbers the correctness check compares,
  each with its limit.

A cell, configuration or metric is added by adding files and entries;
no file here changes.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import NamedTuple

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


class Cell(NamedTuple):
    name: str
    chips: int
    config: dict
    traffic: dict
    limits: dict
    end_to_end: list   # the end-to-end metric entries this cell reports
    per_layer: list    # (entry, reader module) this cell reports


def load_manifest(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def _json(path: Path) -> dict:
    if not path.is_file():
        raise FileNotFoundError(f"{path} is missing")
    return json.loads(path.read_text())


def load_reader(path: Path) -> ModuleType:
    """A metric's reader module, loaded from its file (metric names may
    hold dots and dashes, which no import statement takes)."""
    spec = importlib.util.spec_from_file_location(
        f"benchmark_metric_{path.stem.replace('.', '_').replace('-', '_')}",
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    if not callable(getattr(mod, "read", None)):
        raise ValueError(f"{path}: a metric reader defines read(record)")
    return mod


def _applies(metric: dict, workload: str, reported: set) -> bool:
    """A metric with ``workloads`` is of those cells alone; an end-to-end
    one without is of every cell; a per-layer one without is of every
    cell that reports the end-to-end metric it ``moves``."""
    if "workloads" in metric:
        return workload in metric["workloads"]
    return "moves" not in metric or metric["moves"] in reported


def resolve(name: str, root: Path = ROOT) -> Cell:
    """The cell ``name`` with its configuration, traffic, limits and the
    metrics it reports."""
    man = load_manifest(root)
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise KeyError(f"unknown workload {name!r} (known: "
                       f"{', '.join(sorted(cells))})")
    w = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    cfg = _json(root / configs[w["config"]]["file"])
    traffic = _json(root / "benchmark" / "traffic" / f"{w['traffic']}.json")
    limits = _json(root / "benchmark" / "limits" / f"{name}.json")
    e2e = [m for m in man["end_to_end"] if _applies(m, name, set())]
    reported = {m["name"] for m in e2e}
    per_layer = [(m, load_reader(root / "benchmark" / "metrics"
                                 / f"{m['name']}.py"))
                 for m in man["per_layer"] if _applies(m, name, reported)]
    return Cell(name, int(w["chips"]), cfg, traffic, limits, e2e,
                per_layer)
