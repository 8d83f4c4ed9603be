"""PyTorch port vs the JAX package: the scaling harness
(`aruco_slam_tpu_torch.bench.scaling` against aruco_slam_tpu/bench/
scaling.py) on the CPU at a small size.

The sweep's rows carry JAX's fields, JAX's reduction payload formula and
JAX's per-shard factor capacity on the same problem; the solves of every
mesh size agree within the CLI tolerance of tests/test_torch_dist.py
(1e-5 m: float32 sums over the slots in another order). The process
modes run as subprocesses in their own sessions, each wait bounded and
the whole group killed on expiry.
"""

import json
import os
import signal
import subprocess
import sys
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from aruco_slam_tpu.bench import scaling as jscaling
from aruco_slam_tpu.parallel import sharded_ba as jsb
from aruco_slam_tpu_torch.bench import scaling
from aruco_slam_tpu_torch.parallel import dist as tdist
from aruco_slam_tpu_torch.parallel import sharded_ba as tsb
from test_torch_bench import _flags, _parser_of

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
WAIT_S = 120
SOLVE_ATOL = 1e-5
SMALL = ["--platform", "cpu", "--frames", "24", "--markers", "8",
         "--iters", "2", "--reps", "1"]
SWEEP_KEYS = {"devices", "seconds", "speedup", "efficiency",
              "factors_per_device", "psum_bytes_per_iter", "collective_s",
              "collective_frac", "note"}


def test_scaling_flags_match_jax(monkeypatch):
    """Every JAX flag with its default, choices and type (the hidden
    worker flags too); --platform is the port's: cuda | cpu, cuda by
    default."""
    want = _flags(_parser_of(jscaling.main, monkeypatch))
    got = _flags(_parser_of(scaling.main, monkeypatch))
    assert want.pop("--platform")[1] is None
    dest, default, choices = got.pop("--platform")[:3]
    assert (dest, default, list(choices)) == ("platform", "cuda",
                                              ["cuda", "cpu"])
    assert got == want


def test_sweep_rows_match_jax():
    """Sizes 1, 2 and 4: JAX's row fields, its payload formula and its
    shard capacities on the same problem, and every size's solve within
    SOLVE_ATOL of the one-slot solve."""
    rows = scaling.main(SMALL + ["--sizes", "1,2,4"])
    assert [r["devices"] for r in rows] == [1, 2, 4]
    jcfg, jstate = jscaling._build_problem(24, 8)
    tcap, t6 = jcfg.max_poses, jcfg.max_poses * 6
    itemsize = jnp.dtype(jcfg.dtype).itemsize
    want_bytes = itemsize * (tcap * 36 + tcap * 6 + 1 + t6 * t6 + t6 + 1)
    for r in rows:
        assert set(r) == SWEEP_KEYS
        assert r["psum_bytes_per_iter"] == want_bytes
        assert r["factors_per_device"] == jsb._shard_capacity(
            jcfg, jstate, r["devices"])
        assert r["seconds"] > 0 and np.isfinite(r["efficiency"])
        assert (r["collective_s"] == 0.0) == (r["devices"] == 1)
        assert "NOT speedup" in r["note"] and "cpu" in r["note"]
    assert rows[0]["speedup"] == 1.0

    cfg, state = scaling._build_problem(24, 8)
    ref = None
    for n in (1, 2, 4):
        out, cost = tsb.sharded_batch_optimize(
            cfg, state, tdist.make_mesh(n, local_devices=n), iters=2)
        assert np.isfinite(float(cost))
        if ref is None:
            ref = out.pose_t.numpy()
        np.testing.assert_allclose(out.pose_t.numpy(), ref, atol=SOLVE_ATOL)


def test_fleet_row():
    """--fleet 2x2: two problems, each over two slots, in one process."""
    row = scaling.main(SMALL + ["--fleet", "2x2"])
    assert set(row) == {"mesh", "problems", "seconds", "problems_per_s",
                        "note"}
    assert row["mesh"] == "2x2 (data x kf)" and row["problems"] == 2
    assert row["problems_per_s"] == pytest.approx(2 / row["seconds"])


def _bounded(args) -> tuple[int, str, str]:
    """The scaling CLI in a subprocess of its own session (its workers
    in it), waited for at most WAIT_S; the group is killed on expiry."""
    env = dict(os.environ, PYTHONPATH=str(ROOT), OMP_NUM_THREADS="1")
    proc = subprocess.Popen(
        [sys.executable, "-m", "aruco_slam_tpu_torch.bench.scaling", *args],
        cwd=ROOT, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE, start_new_session=True)
    try:
        out, err = proc.communicate(timeout=WAIT_S)
    except subprocess.TimeoutExpired:
        pytest.fail("scaling run hung")
    finally:
        if proc.poll() is None:
            os.killpg(proc.pid, signal.SIGKILL)
            proc.wait()
    return proc.returncode, out, err


def _rows(out: str) -> list[dict]:
    return [json.loads(ln) for ln in out.splitlines() if ln.startswith("{")]


def test_processes_row():
    """--processes 2: two worker processes over Gloo, two mesh slots
    each; process 0 prints the row with the reductions over the group."""
    rc, out, err = _bounded(SMALL + ["--processes", "2"])
    assert rc == 0, err
    row, = _rows(out)
    assert row["devices"] == 4 and row["processes"] == 2
    assert row["backend"] == "gloo" and row["collective_s"] > 0
    assert "2 processes on cpu over gloo" in row["note"]


def test_processes_worker_failure_fails_the_run():
    """A worker that fails (here: --platform cuda without a card) ends
    the run with a nonzero exit and no row."""
    args = [a if a != "cpu" else "cuda" for a in SMALL]
    rc, out, _ = _bounded(args + ["--processes", "2"])
    assert rc != 0 and not _rows(out)


def test_ingest_row():
    """--ingest 2 at 8 frames: the one-process baseline and two sharded
    processes, each in fresh processes pinned to a core."""
    rc, out, err = _bounded(["--platform", "cpu", "--ingest", "2",
                             "--frames", "8"])
    assert rc == 0, err
    row, = _rows(out)
    assert row["metric"] == "sharded_ingest_scaling" and row["frames"] == 8
    assert row["ingest_1proc_s"] > 0 and row["ingest_2proc_s"] > 0
    assert row["speedup"] == pytest.approx(row["ingest_1proc_s"]
                                           / row["ingest_2proc_s"])
