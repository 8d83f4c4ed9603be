"""The apps' front end (`apps/front_end.py`) on the CPU: one chunk
step serves one stream and a fleet alike, and one gate accepts PnP's
poses wherever the front end runs."""

import ast
from pathlib import Path

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch.apps import front_end
from aruco_slam_tpu_torch.apps import make_synthetic as tsyn
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.ops import pnp

APPS = Path(front_end.__file__).parent
PACKAGE = APPS.parent
# the 1080p camera at half scale, for 960x540 frames
HALF_K = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
                   [0.0, 0.0, 1.0]])
EXACT = dict(rtol=0, atol=0, equal_nan=True)


@pytest.fixture(scope="module")
def clip():
    """5 rendered 960x540 frames of 12 markers."""
    return tsyn.build(frames=5, markers=12, capacity=16, with_images=True,
                      image_size=(960, 540), camera_matrix=HALF_K)


def _step_all(step, frames, chunk: int, axis: int):
    """Every chunk of ``frames`` through ``step``: (last carry, chunks)."""
    carry, chunks = step.init(), []
    for c0 in range(0, frames.shape[axis], chunk):
        carry, out = step(carry, frames.take(
            range(c0, min(c0 + chunk, frames.shape[axis])), axis))
        chunks.append(out)
    return carry, chunks


def test_one_stream_is_a_fleet_of_one(clip):
    """Full detection at a table too small for the clip (4 slots, 12
    markers; stale slots recycled after a frame): the chunk step on one
    stream's (T, H, W) chunks and on a fleet of one's (1, T, H, W)
    chunks, the tail chunk padded, gives bit-identical observations,
    slot resets and dropped sightings, and the same carry."""
    cfg = SlamAppConfig(input="", capacity=4, slot_max_age=1,
                        marker_size=float(clip["marker_size"]))
    cpu = torch.device("cpu")
    cam = front_end.camera(clip["camera_matrix"], clip["dist_coeffs"], cpu)
    frames = clip["images"]
    one, one_chunks = _step_all(front_end.ChunkStep(cam, cfg, cpu, chunk=3),
                                frames, 3, 0)
    fleet, fleet_chunks = _step_all(
        front_end.ChunkStep(cam, cfg, cpu, chunk=3, streams=1),
        frames[None], 3, 1)
    assert [len(c.mask) for c in one_chunks] == [3, 2]
    for a, b in zip(one_chunks, fleet_chunks):
        for name, x, y in zip(a._fields, a, b):
            torch.testing.assert_close(y[0], x, **EXACT, msg=name)
    torch.testing.assert_close(fleet.table[0], one.table, **EXACT)
    torch.testing.assert_close(fleet.seen[0], one.seen, **EXACT)
    assert fleet.frame == one.frame == 5
    dropped = torch.cat([c.dropped for c in one_chunks])
    reset = torch.cat([c.reset for c in one_chunks])
    assert int(dropped.sum()) > 0 and bool(reset.any())
    assert bool(torch.cat([c.mask for c in one_chunks]).any())


def test_gate_is_the_expression_it_replaced():
    """`accept` on a PnP result with NaN errors and zero second-solution
    errors: the mask and ambiguity of ``det_m & (err < max_reproj_px)``
    and ``err / clamp(err2, min=1e-9)``, bit for bit."""
    gen = torch.Generator().manual_seed(0)
    shape = (3, 8)
    err = torch.rand(shape, generator=gen) * 6.0
    err2 = torch.rand(shape, generator=gen) * 6.0
    err[0, :3] = float("nan")
    err2[1, :4] = 0.0
    err2[0, 0] = 0.0                      # NaN over zero
    err[2, 5] = 0.0
    err2[2, 5] = 0.0                      # zero over zero
    det_m = torch.rand(shape, generator=gen) > 0.3
    zeros = torch.zeros((*shape, 3))
    res = pnp.PnPResult(zeros, torch.zeros((*shape, 4)), zeros, err, err2)
    mask, amb = front_end.accept(res, det_m, 3.0)
    torch.testing.assert_close(mask, det_m & (err < 3.0), **EXACT)
    torch.testing.assert_close(amb, err / torch.clamp(err2, min=1e-9),
                               **EXACT)
    assert not mask[0, :3].any() and amb[0, :3].isnan().all()
    assert bool(mask.any())


def _imports(path: Path):
    """(module, names) of every ``from module import names`` in path."""
    tree = ast.parse(path.read_text())
    return [(n.module or "", [a.name for a in n.names])
            for n in ast.walk(tree) if isinstance(n, ast.ImportFrom)]


def test_no_module_imports_a_private_name_of_the_apps():
    """run_offline, bench/scaling and the rest use the public names of
    run_slam and the front end."""
    apps = ("aruco_slam_tpu_torch.apps.run_slam",
            "aruco_slam_tpu_torch.apps.front_end")
    assert [(p.name, m, n) for p in PACKAGE.rglob("*.py")
            for m, names in _imports(p) if m in apps
            for n in names if n.startswith("_")] == []


def test_the_apps_leave_the_pnp_kernel_to_ops_pnp():
    """Nothing under apps/ imports the PnP kernel's wrapper:
    `ops.pnp.solve_square_pnp` picks it by device."""
    assert [(p.name, m) for p in APPS.glob("*.py")
            for m, names in _imports(p)
            if m.endswith("cuda_pnp") or "cuda_pnp" in names] == []


def test_the_slot_scan_is_called_from_the_chunk_step_alone():
    assert [(p.name, p.read_text().count("assign_sequence_lru("))
            for p in APPS.glob("*.py")
            if "assign_sequence_lru(" in p.read_text()] == [
        ("front_end.py", 1)]
