"""The port's pixels->pose slice end to end, against the JAX run_slam.

`aruco_slam_tpu_torch.apps.run_slam` and `aruco_slam_tpu.apps.run_slam`
run on the same rendered npz on the CPU; plus the port's import
hygiene (no jax) and its refusal to run "cuda" without a card.
"""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.apps import run_slam as jrun
from aruco_slam_tpu.bench import render, synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.io import load_map
from aruco_slam_tpu.io.sources import save_npz
from aruco_slam_tpu.io.trajectory import read_trajectory
from aruco_slam_tpu_torch.apps import run_slam as trun

torch.set_num_threads(2)

ROOT = Path(__file__).resolve().parents[1]
K2 = np.array([[707.45, 0.0, 483.5], [0.0, 707.45, 272.15],
               [0.0, 0.0, 1.0]])
DIST = np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387])


@pytest.fixture(scope="module")
def sequence(tmp_path_factory):
    """8 rendered 960x540 frames (the first of a 30-frame orbit)."""
    cam = jcam.CameraModel.from_matrix(jnp.asarray(K2),
                                       jnp.asarray(DIST))
    scene = synthetic.make_wall_scene(num_markers=10, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=30)
    traj = synthetic.Trajectory(*(a[:8] for a in traj))
    frames = render.render_sequence(scene, traj, cam, image_size=(960, 540))
    path = tmp_path_factory.mktemp("slice") / "seq.npz"
    save_npz(path, times=traj.times, images=frames, gt_cam_t=traj.cam_t,
             camera_matrix=K2, dist_coeffs=DIST,
             marker_size=np.float64(scene.marker_size))
    return path


def test_run_slam_matches_jax(sequence, tmp_path, monkeypatch):
    # the JAX run_slam takes its fused Pallas update only on a TPU; here
    # it runs that kernel in interpret mode, as the port's update is its
    # counterpart (on the CPU the JAX default is a Cholesky gain, which
    # the 20-step Newton–Schulz gain does not reproduce)
    make_cfg = jrun._mekf_config
    monkeypatch.setattr(jrun, "_mekf_config", lambda *a, **k: make_cfg(
        *a, **k)._replace(pallas_update=True))
    out = {}
    for name, mod in (("jax", jrun), ("torch", trun)):
        traj_f = tmp_path / f"{name}_traj.txt"
        map_f = tmp_path / f"{name}_map.txt"
        res = mod.main(["--input", str(sequence), "--platform", "cpu",
                        "--trajectory", str(traj_f), "--map", str(map_f)])
        out[name] = (read_trajectory(traj_f)[1], load_map(map_f))
    assert res.ate is not None and res.ate < 0.3
    assert res.obs_mask.sum(axis=1).min() >= 1
    (tj, mj), (tt, mt) = out["jax"], out["torch"]
    assert tt.shape == tj.shape == (8, 7)
    # corners agree to 1e-3 px and the JAX PnP runs in float64 here
    # (x64 test mode) against the port's float32: 2e-3 m / 2e-3 on the
    # quaternion, far inside the 1 px corner noise the filter assumes
    np.testing.assert_allclose(tt, tj, atol=2e-3)
    np.testing.assert_array_equal(np.sort(mt[0]), np.sort(mj[0]))
    order_t, order_j = np.argsort(mt[0]), np.argsort(mj[0])
    np.testing.assert_allclose(mt[1][order_t], mj[1][order_j], atol=2e-3)


@pytest.mark.parametrize("flags", [
    ["--filter", "factorgraph"], ["--track-every", "3"], ["--viz-2d"],
    ["--checkpoint-every", "4"], ["--load-map", "map.txt"]])
def test_unported_paths_refuse(sequence, flags):
    with pytest.raises(NotImplementedError, match="not ported yet"):
        trun.main(["--input", str(sequence), "--platform", "cpu", *flags])


def _python(code_or_args, **kw):
    env = dict(os.environ, PYTHONPATH=str(ROOT))
    return subprocess.run([sys.executable, *code_or_args], cwd=ROOT,
                          env=env, capture_output=True, text=True,
                          timeout=120, **kw)


def test_port_imports_no_jax():
    """The port and chip_smoke.py import neither jax nor the JAX
    package (the machine with the card has no jax)."""
    proc = _python(["-c", (
        "import sys\n"
        "import chip_smoke\n"
        "import aruco_slam_tpu_torch.apps.run_slam\n"
        "import aruco_slam_tpu_torch.bench.render\n"
        "import aruco_slam_tpu_torch.ops.detect\n"
        "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
        "('jax', 'jaxlib', 'aruco_slam_tpu'))\n"
        "assert not bad, bad\n"
        "print('ok')\n")])
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_platform_cuda_refuses_without_card(sequence):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present: --platform cuda is valid")
    proc = _python(["-m", "aruco_slam_tpu_torch.apps.run_slam", "--input",
                    str(sequence), "--platform", "cuda"])
    assert proc.returncode != 0
    assert "no CUDA device" in proc.stderr
    assert "wrote" not in proc.stdout
