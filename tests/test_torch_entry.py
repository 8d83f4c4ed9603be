"""PyTorch port vs the JAX package: the flagship frame step and the
multi-device dry run (`aruco_slam_tpu_torch.entry` against the root's
`__graft_entry__`).

`entry()`'s step runs the port's PnP and MEKF with the plain update on
the CPU; JAX's step runs its Pallas update in interpret mode (its CPU
default is a Cholesky gain, which the 20-step Newton–Schulz gain does
not reproduce). Both at f32: the step's pose and landmarks within
tests/test_torch_mekf.py's port-against-JAX bound. The dry run holds
itself to JAX's thresholds (|dpose| and relative |dcost| under 1e-6 at
f64, the fleet within 2e-5) and raises RuntimeError where one fails.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

import __graft_entry__ as graft
import aruco_slam_tpu.filters as jfilters
from aruco_slam_tpu.bench import synthetic
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu_torch import entry

torch.set_num_threads(2)

# tests/test_torch_mekf.py: the port's filter against JAX's
TRAJ_TOL = dict(atol=5e-4, rtol=1e-3)


def test_entry_step_matches_jax(monkeypatch):
    """Two steps of `entry()`'s frame step (frame 0, the example, then
    the orbit's frame 1) against JAX's: identical example inputs, the
    camera pose, landmarks and covariance within TRAJ_TOL."""
    real = jfilters.MekfConfig
    monkeypatch.setattr(jfilters, "MekfConfig",
                        lambda **kw: real(**kw, pallas_update=True))
    jstep, jargs = graft.entry()
    monkeypatch.undo()
    jstep = jax.jit(jstep)
    tstep, targs = entry.entry("cpu")
    assert targs[0].cov.device.type == "cpu"
    np.testing.assert_array_equal(targs[1].numpy(), np.asarray(jargs[1]))
    np.testing.assert_array_equal(targs[2].numpy(), np.asarray(jargs[2]))

    k = np.asarray(entry.K, np.float32)
    d = np.asarray(entry.DIST, np.float32)
    corners, mask = synthetic.observe_corners(
        synthetic.make_wall_scene(num_markers=8, seed=0),
        synthetic.make_orbit_trajectory(num_frames=2),
        jcam.CameraModel.from_matrix(jnp.asarray(k), jnp.asarray(d)),
        entry.CAPACITY, seed=1)
    corners = corners.astype(np.float32)
    jstate, tstate = jargs[0], targs[0]
    for i in range(2):
        jstate, jpose = jstep(jstate, jnp.asarray(corners[i]),
                              jnp.asarray(mask[i]))
        tstate, tpose = tstep(tstate, torch.tensor(corners[i]),
                              torch.tensor(mask[i]))
        np.testing.assert_allclose(tpose.numpy(), np.asarray(jpose),
                                   **TRAJ_TOL)
        np.testing.assert_allclose(tstate.lm.numpy(), np.asarray(jstate.lm),
                                   **TRAJ_TOL)
        np.testing.assert_allclose(tstate.cov.numpy(),
                                   np.asarray(jstate.cov), **TRAJ_TOL)
    assert float(np.abs(tpose.numpy()[:3]).max()) > 1e-3  # it moved


def test_entry_defaults_to_the_card(monkeypatch):
    """No device given: the card, which raises without one."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.entry()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        entry.dryrun_multichip(2)


@pytest.mark.parametrize("n", [2, 4, 8])
def test_dryrun_multichip(n, capsys):
    """Every multi-device path's step on n slots / n stream shards, each
    under JAX's threshold, and JAX's summary line."""
    out = entry.dryrun_multichip(n, platform="cpu")
    line = capsys.readouterr().out
    assert line.startswith(f"dryrun_multichip({n}): sharded BA == "
                           "single-device")
    assert out["ba_dpose"] < entry.BA_POSE_TOL
    assert out["ba_dcost"] < entry.BA_COST_RTOL * max(1.0, abs(out["cost"]))
    assert out["kf_dtraj"] < entry.KF_TRAJ_TOL
    assert out["mesh2d"] == (n // 2, 2)
    assert f"({n // 2}x2) data*kf fleet BA ok; {n}-stream image pipeline " \
           "ok" in line


def test_dryrun_failed_check_raises(monkeypatch):
    """A check that fails raises RuntimeError (not an assert, which -O
    strips)."""
    monkeypatch.setattr(entry, "KF_TRAJ_TOL", -1.0)
    with pytest.raises(RuntimeError, match="fleet MEKF diverges"):
        entry.dryrun_multichip(2, platform="cpu")
