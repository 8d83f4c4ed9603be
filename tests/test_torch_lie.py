"""The port's core/lie.py and the quaternion helpers from_euler_xyz,
apply_small_angle and angle_between against the JAX package's, on the
CPU.

The inputs are tests/test_lie.py's cases (random unit quaternions and
translations, rotation vectors inside π, the near-zero tangent vectors
of test_se3_exp_small), made from seeds with numpy and given to both
packages at float32 (cast by hand on both sides: tests/conftest.py
turns on x64) and at float64. Tolerance: 1e-6 at float32, 1e-12 at
float64, relative to values of order one.
"""

import numpy as np
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.core import lie as jlie
from aruco_slam_tpu.core import quaternion as jquat
from aruco_slam_tpu_torch.core import lie as tlie
from aruco_slam_tpu_torch.core import quaternion as tquat

TOL = {np.float32: 1e-6, np.float64: 1e-12}
DTYPES = [np.float32, np.float64]


def _poses(seed, n=16):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(n, 4))
    q /= np.linalg.norm(q, axis=-1, keepdims=True)
    return q, rng.normal(size=(n, 3))


def _tangents(seed=3):
    """test_lie.py's round-trip rotation vectors (inside 0.9 π), its
    near-zero cases, and a zero vector."""
    rng = np.random.default_rng(seed)
    xi = rng.normal(size=(64, 6))
    xi[:, :3] *= 0.9 * np.pi / np.maximum(
        np.linalg.norm(xi[:, :3], axis=-1, keepdims=True), np.pi)
    small = np.array([[1e-9, 0, 0, 1e-3, 2e-3, -1e-3], np.zeros(6)])
    return np.concatenate([xi, small])


def _j(x, dt):
    return jnp.asarray(np.asarray(x, dt))


def _t(x, dt):
    return torch.from_numpy(np.asarray(x, dt))


def _np(x):
    if isinstance(x, tuple):
        return np.concatenate([_np(a).reshape(len(a), -1) if a.ndim > 1
                               else _np(a).reshape(1, -1) for a in x], -1)
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def _pose_args(dt, conv, seed):
    q, t = _poses(seed)
    return (jlie.Pose(*(_j(a, dt) for a in (q, t))) if conv == "jax"
            else tlie.Pose(*(_t(a, dt) for a in (q, t))))


CASES = {
    # name: (function name, builds the arguments for one package)
    "compose": lambda conv, dt: (_pose_args(dt, conv, 1),
                                 _pose_args(dt, conv, 2)),
    "between": lambda conv, dt: (_pose_args(dt, conv, 1),
                                 _pose_args(dt, conv, 2)),
    "inverse": lambda conv, dt: (_pose_args(dt, conv, 0),),
    "transform": lambda conv, dt: (
        _pose_args(dt, conv, 2),
        (_j if conv == "jax" else _t)(
            np.random.default_rng(12).normal(size=(16, 3)), dt)),
    "pose_to_matrix": lambda conv, dt: (_pose_args(dt, conv, 1),),
    "se3_log": lambda conv, dt: (_pose_args(dt, conv, 4),),
    "retract": lambda conv, dt: (
        _pose_args(dt, conv, 7),
        (_j if conv == "jax" else _t)(_tangents()[:16] * 0.1, dt)),
    "se3_exp": lambda conv, dt: (
        (_j if conv == "jax" else _t)(_tangents(), dt),),
    "skew": lambda conv, dt: (
        (_j if conv == "jax" else _t)(_tangents()[:, :3], dt),),
    "so3_right_jacobian": lambda conv, dt: (
        (_j if conv == "jax" else _t)(_tangents(6)[:, :3], dt),),
    "so3_right_jacobian_inv": lambda conv, dt: (
        (_j if conv == "jax" else _t)(
            np.random.default_rng(6).normal(size=(16, 3)), dt),),
}


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", sorted(CASES))
def test_lie_matches_jax(name, dt):
    want = getattr(jlie, name)(*CASES[name]("jax", dt))
    got = getattr(tlie, name)(*CASES[name]("torch", dt))
    got, want = _np(got), _np(want)
    assert got.dtype == want.dtype
    np.testing.assert_allclose(got, want, rtol=TOL[dt], atol=TOL[dt])


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_identity_pose_matches_jax(dt):
    want = jlie.identity_pose(jnp.dtype(dt))
    got = tlie.identity_pose(getattr(torch, np.dtype(dt).name))
    np.testing.assert_array_equal(_np(got), _np(want))
    assert _np(got).dtype == _np(want).dtype


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
def test_exp_log_roundtrip(dt):
    """se3_log(se3_exp(xi)) = xi in the port too (test_lie.py's
    round trip, at the dtype's tolerance scaled by the 1/θ² cancellation
    near zero: 1e-4 at float32, 1e-7 at float64 as test_lie.py)."""
    xi = _tangents()
    back = tlie.se3_log(tlie.se3_exp(_t(xi, dt))).numpy()
    np.testing.assert_allclose(back, xi, atol={np.float32: 1e-4,
                                               np.float64: 1e-7}[dt])


@pytest.mark.parametrize("dt", DTYPES, ids=["f32", "f64"])
@pytest.mark.parametrize("name", ["from_euler_xyz", "apply_small_angle",
                                  "angle_between"])
def test_quaternion_helpers_match_jax(name, dt):
    rng = np.random.default_rng(8)
    q, _ = _poses(9)
    args = {"from_euler_xyz": (rng.uniform(-np.pi, np.pi, (16, 3)),),
            "apply_small_angle": (q, rng.normal(size=(16, 3)) * 0.05),
            "angle_between": (q, _poses(10)[0])}[name]
    want = getattr(jquat, name)(*(_j(a, dt) for a in args))
    got = getattr(tquat, name)(*(_t(a, dt) for a in args))
    np.testing.assert_allclose(_np(got), _np(want), rtol=TOL[dt],
                               atol=TOL[dt])
