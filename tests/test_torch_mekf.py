"""PyTorch port vs the JAX package: the MEKF and its fused update.

Both filters start from the same state and config, carried across with
`state_from_numpy` / `config_from_jax`. The JAX side runs the fused
Pallas update in interpret mode (``pallas_update=True``) — the path the
JAX package takes on a TPU and the one the port's kernel replaces.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import synthetic
from aruco_slam_tpu.core import quaternion as jquat
from aruco_slam_tpu.filters import mekf as jm
from aruco_slam_tpu.filters import pallas_mekf
from aruco_slam_tpu_torch.filters import cuda_mekf
from aruco_slam_tpu_torch.filters import mekf as tm

torch.set_num_threads(2)

# run_slam's filter settings (aruco_slam_tpu/config.py SlamAppConfig)
RUN_SLAM = dict(motion_model="cv", pixel_sigma=1.0, gate_distance=1.0,
                r_uncertainty=0.005, q_uncertainty_cam=1.0,
                q_error_uncertainty_cam=1.0, q_uncertainty_lm=0.0,
                q_vel=2e-3, vel_decay=0.99)
# tests/test_mekf.py::test_pallas_fused_update_matches_cholesky's bounds
TRAJ_TOL = dict(atol=5e-4, rtol=1e-3)
COV_TOL = dict(atol=5e-3, rtol=5e-3)


def jax_state_np(state):
    return {k: np.asarray(v) for k, v in state._asdict().items()}


def obs_seq(capacity, frames, markers, seed_noise=0.005):
    scene = synthetic.make_wall_scene(num_markers=markers, seed=0)
    traj = synthetic.make_orbit_trajectory(num_frames=frames)
    obs = synthetic.observe_poses(scene, traj, capacity,
                                  noise_t=seed_noise, noise_r=seed_noise,
                                  fov_limit=0.75)
    return (obs.t_cl.astype(np.float32), obs.q_cl.astype(np.float32),
            obs.mask, traj)


def run_both(jcfg, t_cl, q_cl, mask, reset=None):
    tcfg = tm.config_from_jax(jcfg._asdict())
    j0 = jm.init_state(jcfg)
    jfinal, jtraj = jm.mekf_scan(jcfg, j0, jm.FrameObservations(
        jnp.asarray(t_cl), jnp.asarray(q_cl), jnp.asarray(mask), None,
        None if reset is None else jnp.asarray(reset)))
    tfinal, ttraj = tm.mekf_scan(
        tcfg, tm.state_from_numpy(jax_state_np(j0)),
        tm.FrameObservations(torch.tensor(t_cl), torch.tensor(q_cl),
                             torch.tensor(mask), None,
                             None if reset is None else torch.tensor(reset)))
    return jfinal, np.asarray(jtraj), tfinal, ttraj.numpy()


@pytest.mark.parametrize("n,m", [(54, 48), (201, 48)])
def test_fused_update_plain_matches_interpret(n, m):
    """B3's plain version vs the Pallas kernel (interpret): the same f32
    chain in another summation order."""
    rng = np.random.default_rng(n)
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    cov = (a @ a.T * 0.05 + 0.01 * np.eye(n)).astype(np.float32)
    h = np.zeros((m, n), np.float32)
    h[:, :6] = rng.normal(size=(m, 6))
    for k in range(m // 3):  # one landmark block per observation
        j = 6 + 3 * (k % ((n - 6) // 3))
        h[3 * k:3 * k + 3, j:j + 3] = np.eye(3) + 0.1 * rng.normal(
            size=(3, 3))
    r = rng.uniform(1e-3, 1e-2, m).astype(np.float32)
    resid = (0.01 * rng.normal(size=m)).astype(np.float32)
    inn_j, cov_j = pallas_mekf.fused_update(
        jnp.asarray(cov), jnp.asarray(h), jnp.asarray(r),
        jnp.asarray(resid), ns_iters=20, interpret=True)
    inn_t, cov_t = cuda_mekf.fused_update(
        torch.tensor(cov), torch.tensor(h), torch.tensor(r),
        torch.tensor(resid), ns_iters=20)
    np.testing.assert_allclose(inn_t.numpy(), np.asarray(inn_j),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_allclose(cov_t.numpy(), np.asarray(cov_j),
                               atol=1e-5, rtol=1e-4)
    np.testing.assert_array_equal(cov_t.numpy(), cov_t.numpy().T)


def test_jacobians_match_jacfwd():
    """The closed-form Jacobians are jax.jacfwd's of the JAX models."""
    rng = np.random.default_rng(4)
    q = rng.normal(size=4)
    cam_q = (q / np.linalg.norm(q)).astype(np.float32)
    cam_t = rng.normal(size=3).astype(np.float32)
    lm = (rng.normal(size=(8, 3)) + [0, 0, 3]).astype(np.float32)
    ce = 9
    zc, zl = jnp.zeros(ce, jnp.float32), jnp.zeros(3, jnp.float32)

    def jac(lm_j):
        return jax.jacfwd(jm._h_point, argnums=(0, 1))(
            zc, zl, jnp.asarray(cam_t), jnp.asarray(cam_q), lm_j)

    j_cam, j_lm = jax.vmap(jac)(jnp.asarray(lm))
    h, t_cam, t_lm = tm._point_jacobians(
        torch.tensor(cam_t), torch.tensor(cam_q), torch.tensor(lm), ce)
    want_h = jax.vmap(lambda l: jm._h_point(
        zc, zl, jnp.asarray(cam_t), jnp.asarray(cam_q), l))(jnp.asarray(lm))
    np.testing.assert_allclose(h.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(t_cam.numpy(), np.asarray(j_cam), atol=1e-5)
    np.testing.assert_allclose(t_lm.numpy(), np.asarray(j_lm), atol=1e-5)

    def g_init(eps_c, z, tcl):  # filters/mekf.py _augment_consistent
        q_wc = jm._perturb(jnp.asarray(cam_q), eps_c[3:6])
        xyz = jquat.rotate(q_wc, tcl + z) + jnp.asarray(cam_t) + eps_c[:3]
        return xyz - (jquat.rotate(jnp.asarray(cam_q), tcl)
                      + jnp.asarray(cam_t))

    j_ci, j_z = jax.vmap(lambda t: jax.jacfwd(g_init, argnums=(0, 1))(
        zc, zl, t))(jnp.asarray(lm))
    g_ci, g_z = tm._init_jacobians(torch.tensor(cam_q), torch.tensor(lm),
                                   ce)
    np.testing.assert_allclose(g_ci.numpy(), np.asarray(j_ci), atol=1e-5)
    np.testing.assert_allclose(g_z.numpy(), np.asarray(j_z), atol=1e-5)


def test_mekf_scan_run_slam_config():
    """The run_slam filter (cv model, depth-scaled R, gate) with the
    max_obs compaction dropping observations, a slot reset and a NaN
    observation for the divergence guard."""
    t_cl, q_cl, mask, _ = obs_seq(16, frames=40, markers=8)
    t_cl[25, np.argmax(mask[25])] = np.nan
    reset = np.zeros_like(mask)
    reset[30, np.argmax(mask[30])] = True
    jcfg = jm.MekfConfig(capacity=16, max_obs=4, pallas_update=True,
                         **RUN_SLAM)
    jf, jt, tf, tt = run_both(jcfg, t_cl, q_cl, mask, reset)
    assert int(jf.dropped_obs) > 0
    assert int(tf.dropped_obs) == int(jf.dropped_obs)
    np.testing.assert_array_equal(tf.active.numpy(), np.asarray(jf.active))
    assert np.isfinite(tt).all()
    np.testing.assert_allclose(tt, jt, **TRAJ_TOL)
    np.testing.assert_allclose(tf.cov.numpy(), np.asarray(jf.cov),
                               **COV_TOL)
    np.testing.assert_allclose(tf.lm.numpy(), np.asarray(jf.lm),
                               **TRAJ_TOL)


def test_mekf_scan_reference_config():
    """The reference tuning: static predict, constant R, no gate, and
    the full (uncompacted) measurement block."""
    t_cl, q_cl, mask, _ = obs_seq(8, frames=30, markers=6)
    jcfg = jm.MekfConfig(capacity=8, max_obs=8, pallas_update=True,
                         r_uncertainty=1e-3, q_uncertainty_cam=0.05,
                         q_error_uncertainty_cam=0.05,
                         q_uncertainty_lm=1e-5)
    jf, jt, tf, tt = run_both(jcfg, t_cl, q_cl, mask)
    np.testing.assert_allclose(tt, jt, **TRAJ_TOL)
    np.testing.assert_allclose(tf.cov.numpy(), np.asarray(jf.cov),
                               **COV_TOL)
    unc_j = np.asarray(jm.landmark_uncertainties(jcfg, jf))
    unc_t = tm.landmark_uncertainties(tm.config_from_jax(jcfg._asdict()),
                                      tf).numpy()
    np.testing.assert_allclose(unc_t, unc_j, **COV_TOL)
    np.testing.assert_allclose(tm.camera_pose(tf).numpy(), jt[-1],
                               **TRAJ_TOL)


@pytest.mark.parametrize("capacity", [16, 256])
def test_augment_consistent_both_branches(capacity):
    """Dense G P Gᵀ (N < 768) and the blocked rank-ce form (N >= 768)
    against the JAX augmentation on the same state."""
    rng = np.random.default_rng(capacity)
    jcfg = jm.MekfConfig(capacity=capacity, motion_model="cv",
                         pixel_sigma=1.0)
    tcfg = tm.config_from_jax(jcfg._asdict())
    n = jcfg.err_dim
    a = rng.normal(size=(n, n)) / np.sqrt(n)
    st = jax_state_np(jm.init_state(jcfg))
    st["cov"] = (a @ a.T * 0.1 + 0.05 * np.eye(n)).astype(np.float32)
    q = rng.normal(size=4)
    st["cam_q"] = (q / np.linalg.norm(q)).astype(np.float32)
    st["cam_t"] = rng.normal(size=3).astype(np.float32)
    new = rng.random(capacity) < 0.2
    t_cl = (rng.normal(size=(capacity, 3)) + [0, 0, 3]).astype(np.float32)
    r_init = rng.uniform(1e-4, 1e-2, (capacity, 3)).astype(np.float32)
    new_dims = np.concatenate([np.zeros(9, bool), np.repeat(new, 3)])
    jstate = jm.MekfState(**{k: jnp.asarray(v) for k, v in st.items()})
    want = jm._augment_consistent(
        jcfg, jstate, jnp.asarray(new), jnp.asarray(new_dims),
        jnp.asarray(t_cl), jnp.zeros((capacity, 4), jnp.float32),
        jnp.asarray(r_init))
    got = tm._augment_consistent(
        tcfg, tm.state_from_numpy(st), torch.tensor(new),
        torch.tensor(new_dims), torch.tensor(t_cl), torch.tensor(r_init))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5)


def test_state_carried_across():
    """A mid-run JAX state continues in the port as it does in JAX."""
    t_cl, q_cl, mask, _ = obs_seq(16, frames=30, markers=8)
    jcfg = jm.MekfConfig(capacity=16, pallas_update=True, **RUN_SLAM)
    tcfg = tm.config_from_jax(jcfg._asdict())
    obs = jm.FrameObservations(jnp.asarray(t_cl), jnp.asarray(q_cl),
                               jnp.asarray(mask))
    mid, _ = jm.mekf_scan(jcfg, jm.init_state(jcfg),
                          jax.tree.map(lambda a: a[:20], obs))
    want, _ = jm.mekf_scan(jcfg, mid, jax.tree.map(lambda a: a[20:], obs))
    arrays = jax_state_np(mid)
    state = tm.state_from_numpy(arrays)
    back = tm.state_to_numpy(state)
    for k, v in arrays.items():
        np.testing.assert_array_equal(back[k], v)
        assert back[k].dtype == v.dtype
    got, _ = tm.mekf_scan(tcfg, state, tm.FrameObservations(
        torch.tensor(t_cl[20:]), torch.tensor(q_cl[20:]),
        torch.tensor(mask[20:])))
    np.testing.assert_allclose(got.cam_t.numpy(), np.asarray(want.cam_t),
                               **TRAJ_TOL)
    np.testing.assert_allclose(got.cov.numpy(), np.asarray(want.cov),
                               **COV_TOL)


@pytest.mark.parametrize("field,value", [
    ("with_rotations", True), ("joseph_form", False),
    ("matmul_precision", "mixed"), ("cov_dtype", torch.bfloat16)])
def test_unported_options_raise(field, value):
    cfg = tm.MekfConfig(capacity=4)._replace(**{field: value})
    with pytest.raises(NotImplementedError, match="not ported yet"):
        tm.init_state(cfg)
