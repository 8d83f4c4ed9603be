"""PyTorch port vs the JAX package: the MEKF and its fused update.

Both filters start from the same state and config, carried across with
`state_from_numpy` / `config_from_jax`. With ``pallas_update=True`` the
JAX side runs the fused Pallas update in interpret mode — the path the
JAX package takes on a TPU and the one the port's kernel replaces; with
``pallas_update=False`` (the port's ``update_kernel=False``) both run
the XLA-form update (Cholesky or Newton–Schulz gain, rank-M covariance).
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
        torch.tensor(new_dims), torch.tensor(t_cl), None,
        torch.tensor(r_init))
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




def _jax_cfg_state(jcfg):
    """The port's config and the JAX initial state carried across."""
    return tm.config_from_jax(jcfg._asdict()), jm.init_state(jcfg)


def test_rotation_jacobians_match_jacfwd():
    """Rotation mode: the closed-form Jacobians of _h_pose and of the
    6-dof landmark initialization are jax.jacfwd's, at 1e-5."""
    rng = np.random.default_rng(11)

    def unit(x):
        return (x / np.linalg.norm(x, axis=-1, keepdims=True)).astype(
            np.float32)

    cam_q = unit(rng.normal(size=4))
    cam_t = rng.normal(size=3).astype(np.float32)
    lm = np.concatenate([rng.normal(size=(8, 3)) + [0, 0, 3],
                         unit(rng.normal(size=(8, 4)))], 1).astype(np.float32)
    ce = 9
    zc, zl = jnp.zeros(ce, jnp.float32), jnp.zeros(6, jnp.float32)
    jt, jq = jnp.asarray(cam_t), jnp.asarray(cam_q)

    def h(eps_c, eps_l, lm_j):
        return jm._h_pose(eps_c, eps_l, jt, jq, lm_j[:3], lm_j[3:7])

    want_h = jax.vmap(lambda l: h(zc, zl, l))(jnp.asarray(lm))
    j_cam, j_lm = jax.vmap(lambda l: jax.jacfwd(h, argnums=(0, 1))(
        zc, zl, l))(jnp.asarray(lm))
    got_h, t_cam, t_lm = tm._pose_jacobians(
        torch.tensor(cam_t), torch.tensor(cam_q), torch.tensor(lm), ce)
    np.testing.assert_allclose(got_h.numpy(), np.asarray(want_h), atol=1e-5)
    np.testing.assert_allclose(t_cam.numpy(), np.asarray(j_cam), atol=1e-5)
    np.testing.assert_allclose(t_lm.numpy(), np.asarray(j_lm), atol=1e-5)

    def g_init(eps_c, z, tcl, qcl):  # filters/mekf.py _augment_consistent
        q_wc = jm._perturb(jq, eps_c[3:6])
        xyz = jquat.rotate(q_wc, tcl + z[:3]) + jt + eps_c[:3]
        q_wl = jquat.multiply(q_wc, jm._perturb(qcl, z[3:6]))
        q0 = jquat.multiply(jq, qcl)
        return jnp.concatenate([
            xyz - (jquat.rotate(jq, tcl) + jt),
            jquat.to_rotvec(jquat.multiply(q_wl, jquat.conjugate(q0)))])

    t_cl = jnp.asarray(lm[:, :3])
    q_cl = jnp.asarray(unit(rng.normal(size=(8, 4))))
    j_ci, j_z = jax.vmap(lambda t, q: jax.jacfwd(g_init, argnums=(0, 1))(
        zc, zl, t, q))(t_cl, q_cl)
    g_ci, g_z = tm._init_jacobians(torch.tensor(cam_q), torch.tensor(lm[:, :3]),
                                   ce, with_rotations=True)
    np.testing.assert_allclose(g_ci.numpy(), np.asarray(j_ci), atol=1e-5)
    np.testing.assert_allclose(g_z.numpy(), np.asarray(j_z), atol=1e-5)


def _ambiguity(mask, seed=2):
    """IPPE ambiguity ratios in [0, 1], a quarter of them over the 0.6
    de-weighting threshold."""
    return np.random.default_rng(seed).uniform(
        0.0, 0.8, mask.shape).astype(np.float32)


def test_rotation_mode_scan_matches_jax():
    """mekf_rotations as run_slam configures it (cv model, depth-scaled R
    with ambiguity de-weighting, gate) through the fused update, against
    the JAX Pallas update (interpret), with compaction dropping
    observations: TRAJ_TOL / COV_TOL, landmark quaternions unit."""
    t_cl, q_cl, mask, _ = obs_seq(12, frames=30, markers=8)
    amb = _ambiguity(mask)
    jcfg = jm.MekfConfig(capacity=12, max_obs=5, with_rotations=True,
                         pallas_update=True, **RUN_SLAM)
    tcfg, j0 = _jax_cfg_state(jcfg)
    jf, jt = jm.mekf_scan(jcfg, j0, jm.FrameObservations(
        jnp.asarray(t_cl), jnp.asarray(q_cl), jnp.asarray(mask),
        jnp.asarray(amb)))
    tf, tt = tm.mekf_scan(tcfg, tm.state_from_numpy(jax_state_np(j0)),
                          tm.FrameObservations(
                              torch.tensor(t_cl), torch.tensor(q_cl),
                              torch.tensor(mask), torch.tensor(amb)))
    assert int(jf.dropped_obs) > 0
    assert int(tf.dropped_obs) == int(jf.dropped_obs)
    np.testing.assert_array_equal(tf.active.numpy(), np.asarray(jf.active))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **TRAJ_TOL)
    np.testing.assert_allclose(tf.cov.numpy(), np.asarray(jf.cov), **COV_TOL)
    np.testing.assert_allclose(tf.lm.numpy(), np.asarray(jf.lm), **TRAJ_TOL)
    norms = np.linalg.norm(tf.lm.numpy()[:, 3:7], axis=-1)
    np.testing.assert_allclose(norms, 1.0, atol=1e-6)


# The JAX package's XLA update forms. In f64 both packages agree to
# ~1e-12, so the algorithm is the same; in f32 a Cholesky of S (unit
# diagonal after equilibration, condition ~1e4 with HPHᵀ ~1 against
# R ~1e-4) amplifies the two LAPACKs' different blocking to ~2e-3 m over
# 30 frames, where Newton–Schulz (matmuls only) stays at ~1e-5.
CHO_F32_TOL = dict(atol=5e-3, rtol=5e-3)
F64_TOL = dict(atol=1e-9, rtol=1e-9)


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.float64])
@pytest.mark.parametrize("form", [dict(s_solver="cho"),
                                  dict(s_solver="ns"),
                                  dict(joseph_form=False)])
def test_xla_update_forms_match_jax(form, dtype):
    """update_kernel=False: the Cholesky and Newton–Schulz gains and the
    non-Joseph (I−KH)P form against JAX with pallas_update=False, in f64
    at F64_TOL and in f32 at TRAJ_TOL (Newton–Schulz) or CHO_F32_TOL."""
    t_cl, q_cl, mask, _ = obs_seq(16, frames=30, markers=8)
    jcfg = jm.MekfConfig(capacity=16, max_obs=6, pallas_update=False,
                         dtype=dtype, **RUN_SLAM, **form)
    jf, jt, tf, tt = run_both(jcfg, t_cl.astype(dtype), q_cl.astype(dtype),
                              mask)
    assert tm.config_from_jax(jcfg._asdict()).update_kernel is False
    if dtype == jnp.float64:
        tol = F64_TOL
    else:
        tol = TRAJ_TOL if form.get("s_solver") == "ns" else CHO_F32_TOL
    np.testing.assert_allclose(tt, jt, **tol)
    np.testing.assert_allclose(tf.cov.numpy(), np.asarray(jf.cov),
                               **(F64_TOL if dtype == jnp.float64
                                  else CHO_F32_TOL))


# bf16 covariance STORAGE: the two frameworks round at other places
# (XLA may keep excess precision across a fused bf16 chain, PyTorch
# rounds every op). Both runs agree to 1e-4 until their roundings first
# part (frame 4 here), then drift as far apart as bf16 storage moves
# either one from its own f32 run (0.10 m on this sequence, 0.4 m on
# the 8-slot one): the bound is that drift's size.
BF16_TRAJ_TOL = dict(atol=0.15, rtol=0.0)
BF16_SAME_FRAMES = 4


def test_bf16_covariance_matches_jax():
    """cov_dtype bf16 (the XLA-form update, gain chain f32) against JAX
    bf16: the state carries across in bf16, the covariance stays bf16,
    the first frames agree to 1e-4 and the trajectory stays within
    BF16_TRAJ_TOL."""
    t_cl, q_cl, mask, _ = obs_seq(16, frames=30, markers=8)
    jcfg = jm.MekfConfig(capacity=16, cov_dtype=jnp.bfloat16, s_solver="ns",
                         **RUN_SLAM)
    tcfg, j0 = _jax_cfg_state(jcfg)
    st0 = tm.state_from_numpy(jax_state_np(j0))
    assert st0.cov.dtype == torch.bfloat16
    np.testing.assert_array_equal(st0.cov.float().numpy(),
                                  np.asarray(j0.cov, np.float32))
    jf, jt = jm.mekf_scan(jcfg, j0, jm.FrameObservations(
        jnp.asarray(t_cl), jnp.asarray(q_cl), jnp.asarray(mask)))
    tf, tt = tm.mekf_scan(tcfg, st0, tm.FrameObservations(
        torch.tensor(t_cl), torch.tensor(q_cl), torch.tensor(mask)))
    assert tf.cov.dtype == torch.bfloat16
    assert np.isfinite(tt.numpy()).all()
    k = BF16_SAME_FRAMES
    np.testing.assert_allclose(tt.numpy()[:k], np.asarray(jt)[:k], atol=1e-4)
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), **BF16_TRAJ_TOL)


@pytest.mark.parametrize("update_kernel", [None, False])
def test_mixed_precision_is_highest_on_cpu(update_kernel):
    """On the CPU every matmul_precision computes f32, as XLA:CPU does:
    "mixed" and "high" give exactly what "highest" gives."""
    t_cl, q_cl, mask, _ = obs_seq(16, frames=12, markers=8)
    obs = tm.FrameObservations(torch.tensor(t_cl), torch.tensor(q_cl),
                               torch.tensor(mask))
    out = []
    for prec in ("highest", "mixed", "high"):
        cfg = tm.MekfConfig(capacity=16, matmul_precision=prec,
                            update_kernel=update_kernel)
        out.append(tm.mekf_scan(cfg, tm.init_state(cfg), obs)[1].numpy())
    np.testing.assert_array_equal(out[1], out[0])
    np.testing.assert_array_equal(out[2], out[0])


@pytest.mark.parametrize("field,value", [
    ("with_rotations", True), ("joseph_form", False),
    ("matmul_precision", "mixed"), ("cov_dtype", jnp.bfloat16)])
def test_options_run_and_match_jax(field, value):
    """Each option the port once refused now runs and matches the JAX
    filter on the same config (the XLA-form Newton–Schulz update, which
    the port takes with update_kernel=False): f32 options at TRAJ_TOL,
    bf16 at BF16_TRAJ_TOL."""
    t_cl, q_cl, mask, _ = obs_seq(8, frames=16, markers=6)
    jcfg = jm.MekfConfig(capacity=8, pallas_update=False, s_solver="ns",
                         **RUN_SLAM)._replace(**{field: value})
    jf, jt, tf, tt = run_both(jcfg, t_cl, q_cl, mask)
    assert np.isfinite(tt).all()
    tol = BF16_TRAJ_TOL if field == "cov_dtype" else TRAJ_TOL
    np.testing.assert_allclose(tt, jt, **tol)


def test_update_kernel_true_refuses_what_it_cannot_serve():
    """The JAX package silently drops its kernel under a bf16 covariance
    (ROADMAP Queue C); the port refuses the request instead."""
    for bad in (dict(cov_dtype=torch.bfloat16), dict(joseph_form=False)):
        cfg = tm.MekfConfig(capacity=4, update_kernel=True, **bad)
        with pytest.raises(ValueError, match="update_kernel=True"):
            tm.init_state(cfg)
    with pytest.raises(ValueError, match="matmul_precision"):
        tm.init_state(tm.MekfConfig(capacity=4, matmul_precision="fast"))


def test_preload_map_and_gates_match_jax():
    """preload_map (slots, positions, variances) and both standalone
    gates against JAX on a mid-run rotation-mode state: masks
    identical."""
    t_cl, q_cl, mask, _ = obs_seq(12, frames=20, markers=8)
    jcfg = jm.MekfConfig(capacity=12, with_rotations=True, max_obs=12,
                         pallas_update=True, **RUN_SLAM)
    tcfg, j0 = _jax_cfg_state(jcfg)
    ids = np.array([1, 4, 9])
    pos = np.random.default_rng(3).normal(size=(3, 3)) + [0, 0, 3]
    unc = np.full((3, 3), 0.02)
    for u in (None, unc):
        want = jm.preload_map(jcfg, j0, ids, pos, u)
        got = tm.preload_map(tcfg, tm.state_from_numpy(jax_state_np(j0)),
                             ids, pos, u)
        for k in ("lm", "cov", "active"):
            np.testing.assert_allclose(getattr(got, k).numpy(),
                                       np.asarray(getattr(want, k)),
                                       atol=1e-7)
    obs = jm.FrameObservations(jnp.asarray(t_cl), jnp.asarray(q_cl),
                               jnp.asarray(mask))
    mid, _ = jm.mekf_scan(jcfg, j0, jax.tree.map(lambda a: a[:10], obs))
    st = tm.state_from_numpy(jax_state_np(mid))
    rng = np.random.default_rng(5)
    for i in range(10, 20):
        # corrupt some observations so that both gates have work
        tc, qc = t_cl[i].copy(), q_cl[i].copy()
        bad = rng.random(len(tc)) < 0.3
        tc[bad] += rng.normal(scale=1.0, size=(bad.sum(), 3))
        qc[bad] = rng.normal(size=(bad.sum(), 4))
        jo = jm.FrameObservations(jnp.asarray(tc), jnp.asarray(qc),
                                  jnp.asarray(mask[i]))
        to = tm.FrameObservations(torch.tensor(tc), torch.tensor(qc),
                                  torch.tensor(mask[i]))
        for jgate, tgate, arg in (
                (jm.rotation_consistency_gate, tm.rotation_consistency_gate,
                 50.0),
                (jm.innovation_gate, tm.innovation_gate, 0.5)):
            want = jgate(jcfg, mid, jo, arg).mask
            got = tgate(tcfg, st, to, arg).mask
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    with pytest.raises(ValueError):
        tm.rotation_consistency_gate(tcfg._replace(with_rotations=False),
                                     st, to)


def test_config_fields_match_jax():
    """The port's MekfConfig has the JAX one's fields and defaults
    (``pallas_update`` as ``update_kernel``), and config_from_jax maps
    every one of them."""
    jfields = jm.MekfConfig._field_defaults
    tfields = tm.MekfConfig._field_defaults
    assert set(tfields) == set(jfields) - {"pallas_update"} | {
        "update_kernel"}
    mapped = tm.config_from_jax(jm.MekfConfig()._asdict())
    assert mapped == tm.MekfConfig()
    for prec in ("highest", "high", "mixed", "default"):
        tm.init_state(tm.MekfConfig(capacity=4, matmul_precision=prec))
