"""The comparison that decides ``correct``.

Each request of a sampled pool entry is held, stream by stream, to the
plain reference of that entry (`benchmark.reference.slam`):

- ``traj_gap_m``: the largest camera-position gap over every frame, of
  the returned trajectory (``RunResult.cam_traj``) and of the TUM file;
- ``rot_gap_rad``: the largest camera-rotation gap, the same way;
- ``obs_diff``: accepted observations (frame, slot) that differ from the
  reference's (the detector's and PnP's decisions);
- ``map_ids_diff``: marker ids in one map and not the other (the map
  file and ``RunResult.landmark_ids``);
- ``map_gap_m``: the largest landmark-position gap of the map file over
  the ids both maps hold.

A missing file, a trajectory of the wrong length or a number that is not
finite reads as infinite. Each number's limit is in
``limits/<workload>.json``.
"""

from __future__ import annotations

import math
from pathlib import Path
from typing import NamedTuple

import numpy as np

INF = math.inf
NAMES = ("traj_gap_m", "rot_gap_rad", "obs_diff", "map_ids_diff",
         "map_gap_m")


class Output(NamedTuple):
    cam_traj: np.ndarray   # (T, 7) [xyz, quat wxyz]
    obs_mask: np.ndarray   # (T, C)
    landmark_ids: np.ndarray
    traj_file: Path
    map_file: Path


def read_tum(path: Path) -> np.ndarray:
    """TUM lines ``t x y z qx qy qz qw`` -> (T, 7) [xyz, quat wxyz]."""
    rows = [ln.split() for ln in Path(path).read_text().splitlines()
            if ln.strip() and not ln.startswith("#")]
    a = np.asarray(rows, np.float64)[:, 1:]
    return np.concatenate([a[:, :3], a[:, 6:7], a[:, 3:6]], 1)


def read_map(path: Path):
    """Map records (id, position, uncertainty, blank; four header lines)
    -> (ids (L,), positions (L, 3))."""
    lines = Path(path).read_text().splitlines()[4:]
    ids, pos = [], []
    for i in range(0, len(lines) - 2, 4):
        ids.append(int(lines[i].strip()))
        pos.append([float(v) for v in lines[i + 1].split(",")][:3])
    return np.asarray(ids, np.int64), np.asarray(pos, np.float64).reshape(
        -1, 3)


def _rot_gap(qa: np.ndarray, qb: np.ndarray) -> float:
    """Largest rotation angle between (T, 4) wxyz quaternions."""
    qa = qa / np.linalg.norm(qa, axis=-1, keepdims=True)
    qb = qb / np.linalg.norm(qb, axis=-1, keepdims=True)
    dot = np.abs((qa * qb).sum(-1))
    # the angle from the vector part of qa^-1 qb, exact for small angles
    w = qa[:, :1] * qb[:, 1:] - qb[:, :1] * qa[:, 1:] \
        - np.cross(qa[:, 1:], qb[:, 1:])
    return float(np.max(2.0 * np.arctan2(np.linalg.norm(w, axis=-1), dot)))


def _traj_gaps(got: np.ndarray, want: np.ndarray):
    if got.shape != want.shape or not np.isfinite(got).all():
        return INF, INF
    t = float(np.max(np.linalg.norm(got[:, :3] - want[:, :3], axis=-1)))
    return t, _rot_gap(got[:, 3:7].astype(np.float64),
                       want[:, 3:7].astype(np.float64))


def compare_stream(out: Output, ref) -> dict:
    """The numbers of one stream of one request against its reference
    (``ref``: cam_traj, obs_mask, landmark_ids, landmarks)."""
    want = np.asarray(ref.cam_traj, np.float64)
    t1, r1 = _traj_gaps(np.asarray(out.cam_traj, np.float64), want)
    try:
        t2, r2 = _traj_gaps(read_tum(out.traj_file), want)
    except (OSError, ValueError, IndexError):
        t2 = r2 = INF
    mask = np.asarray(out.obs_mask, bool)
    obs = float((mask != ref.obs_mask).sum()) \
        if mask.shape == ref.obs_mask.shape else INF
    ref_ids = np.asarray(ref.landmark_ids, np.int64)
    try:
        ids, pos = read_map(out.map_file)
    except (OSError, ValueError, IndexError):
        ids, pos = None, None
    if ids is None:
        id_diff = gap = INF
    else:
        id_diff = float(len(set(ids.tolist()) ^ set(ref_ids.tolist()))
                        + len(set(np.asarray(out.landmark_ids).tolist())
                              ^ set(ref_ids.tolist())))
        lut = {int(i): k for k, i in enumerate(ref_ids)}
        common = [(k, lut[int(i)]) for k, i in enumerate(ids)
                  if int(i) in lut]
        gap = 0.0
        if common:
            a, b = (np.asarray(x) for x in zip(*common))
            d = np.linalg.norm(pos[a] - np.asarray(ref.landmarks)[b], axis=-1)
            gap = float(d.max()) if np.isfinite(d).all() else INF
    return {"traj_gap_m": max(t1, t2), "rot_gap_rad": max(r1, r2),
            "obs_diff": obs, "map_ids_diff": id_diff, "map_gap_m": gap}


def compare(pairs) -> dict:
    """The largest of each number over (outputs, references) pairs, one
    pair a request; every number infinite when nothing was compared."""
    worst = dict.fromkeys(NAMES, -INF)
    for outs, refs in pairs:
        if len(outs) != len(refs):
            return dict.fromkeys(NAMES, INF)
        for out, ref in zip(outs, refs):
            for k, v in compare_stream(out, ref).items():
                worst[k] = max(worst[k], v if math.isfinite(v) else INF)
    return {k: (INF if v == -INF else v) for k, v in worst.items()}


def passes(checks: dict) -> bool:
    return all(math.isfinite(c["value"]) and c["value"] <= c["limit"]
               for c in checks.values())
