"""The port's factor graph (aruco_slam_tpu_torch.graph) against the JAX
package's (aruco_slam_tpu.graph), on the CPU.

Pose-level inputs come from both packages' `observe_poses` (bit-
identical). Most comparisons start both packages from the same state:
a JAX `GraphState` carried over with `state_from_numpy`. Tolerances:
float64 linearizations, Schur solves and covariances 1e-9 / 1e-8
relative to the largest entry, whole float64 runs 1e-6 m; float32
per-call 1e-4 relative, whole float32 runs' ATE within 1e-3 m of JAX's
(tests/conftest.py turns on jax_enable_x64, so f32 is cast by hand on
both sides).
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import synthetic as jsyn
from aruco_slam_tpu.bench.ate import ate_rmse
from aruco_slam_tpu.graph import ba as jba
from aruco_slam_tpu_torch.bench import synthetic as tsyn
from aruco_slam_tpu_torch.graph import ba as tba

torch.set_num_threads(2)

FRAMES = 24
TUNED = dict(meas_sigma_t=0.01, odom_sigma_t=1.0, odom_sigma_rot=1.0)
DTYPES = {"f64": (jnp.float64, torch.float64, np.float64),
          "f32": (jnp.float32, torch.float32, np.float32)}


def rel_err(got, want) -> float:
    """Largest difference relative to the largest entry of ``want``."""
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-300))


def configs(dtype="f64", **kw):
    """The JAX GraphConfig and the port's, with the same fields."""
    jdt, tdt, _ = DTYPES[dtype]
    jc = jba.GraphConfig(**{**dict(max_poses=FRAMES + 2, max_landmarks=16,
                                   max_factors=FRAMES * 10), **kw,
                            "dtype": jdt})
    return jc, tba.GraphConfig(**{**jc._asdict(), "dtype": tdt})


def to_jax(arrays: dict, dtype=None):
    """numpy state arrays -> a JAX GraphState (floats cast to dtype)."""
    def conv(a):
        a = np.asarray(a)
        return jnp.asarray(a.astype(dtype) if dtype is not None
                           and a.dtype.kind == "f" else a)
    return jba.GraphState(**{k: conv(arrays[k])
                             for k in jba.GraphState._fields})


def jax_arrays(state) -> dict:
    return {k: np.array(v) for k, v in state._asdict().items()}


@pytest.fixture(scope="module")
def orbit():
    """24 frames of an orbit before an 8-marker wall, pose-level
    observations at capacity 16 (noise 5 mm / 0.02 rad)."""
    scene = jsyn.make_wall_scene(num_markers=8, seed=0)
    traj = jsyn.make_orbit_trajectory(num_frames=FRAMES)
    obs = jsyn.observe_poses(scene, traj, 16, noise_t=0.005, noise_r=0.02,
                             fov_limit=0.75)
    return scene, traj, obs


def jax_ingest(jc, obs, rotations: bool):
    st = jba.init_graph(jc)
    for i in range(FRAMES):
        st = jba.add_frame(jc, st, jnp.asarray(obs.t_cl[i]),
                           jnp.asarray(obs.mask[i]),
                           jnp.asarray(obs.q_cl[i]) if rotations else None)
    return st


@pytest.fixture(scope="module")
def mid_states(orbit):
    """A mid-run f64 state per (rotations, pixel_sigma): the JAX ingest
    of the orbit, its poses and landmarks then moved to the ground truth
    plus noise (seed 5), so every pose and landmark differs."""
    scene, traj, obs = orbit
    rng = np.random.default_rng(5)
    out = {}
    for rot in (False, True):
        for ps in (0.0, 1.0):
            jc, _ = configs(with_rotations=rot, pixel_sigma=ps, **TUNED)
            a = jax_arrays(jax_ingest(jc, obs, rot))
            a["pose_t"][:FRAMES] = traj.cam_t + rng.normal(
                0, 0.02, (FRAMES, 3))
            dq = jsyn._quat_from_rotvec(rng.normal(0, 0.02, (FRAMES, 3)))
            a["pose_q"][:FRAMES] = jsyn._quat_mul(traj.cam_q, dq)
            a["pose_q"][0] = traj.cam_q[0]
            m = len(scene.marker_pos)
            a["lm"][:m] = np.where(a["lm_active"][:m, None], scene.marker_pos
                                   + rng.normal(0, 0.02, (m, 3)), 0.0)
            lq = jsyn._quat_mul(jsyn._quat_from_rotvec(
                rng.normal(0, 0.05, (m, 3))), scene.marker_quat)
            a["lm_q"][:m] = np.where(a["lm_active"][:m, None], lq,
                                     a["lm_q"][:m])
            out[rot, ps] = a
    return out


def test_synthetic_matches_jax():
    """observe_poses and make_raster_trajectory: bit-identical."""
    scene = jsyn.make_wall_scene(num_markers=12, seed=0)
    for j, t in ((jsyn.make_raster_trajectory(num_frames=40, rows=4,
                                              extent_x=9.0, extent_y=4.4),
                  tsyn.make_raster_trajectory(num_frames=40, rows=4,
                                              extent_x=9.0, extent_y=4.4)),
                 (jsyn.make_orbit_trajectory(num_frames=30),
                  tsyn.make_orbit_trajectory(num_frames=30))):
        for a, b in zip(j, t):
            np.testing.assert_array_equal(b, a)
        jo = jsyn.observe_poses(scene, j, 64, noise_t=0.01, noise_r=0.01,
                                fov_limit=0.75, seed=1)
        to = tsyn.observe_poses(tsyn.make_wall_scene(num_markers=12, seed=0),
                                t, 64, noise_t=0.01, noise_r=0.01,
                                fov_limit=0.75, seed=1)
        assert isinstance(to, tsyn.PoseObservations)
        for a, b in zip(jo, to):
            np.testing.assert_array_equal(b, a)
        assert jo.mask.any()


def test_state_round_trip(mid_states):
    """state_from_numpy / state_to_numpy keep every field, dtype and
    value (floats at the config's dtype, indices int32, masks bool)."""
    a = mid_states[True, 1.0]
    _, tc = configs(with_rotations=True)
    st = tba.state_from_numpy(tc, a)
    assert st.num_poses.dtype == torch.int32 and st.f_valid.dtype == torch.bool
    assert st.pose_q.dtype == torch.float64
    back = tba.state_to_numpy(st)
    assert set(back) == set(a)
    for k in a:
        np.testing.assert_array_equal(back[k], a[k])
        assert back[k].dtype == a[k].dtype, k
    st32 = tba.state_from_numpy(tc._replace(dtype=torch.float32), a)
    assert st32.lm.dtype == torch.float32 and st32.f_lm.dtype == torch.int32


def test_states_with_indices_out_of_range_are_refused(mid_states):
    """The solves sum by the factors' pose and landmark indices without a
    range check of their own: a state that enters with an index outside
    the capacities (state_from_numpy, `check_indices` after a checkpoint
    load) raises, and so does a frame with more slots than landmarks."""
    a = dict(mid_states[True, 1.0])
    _, tc = configs(with_rotations=True)
    for field, bad in (("f_lm", tc.max_landmarks), ("f_pose", -1)):
        b = dict(a)
        b[field] = a[field].copy()
        b[field][0] = bad
        with pytest.raises(ValueError, match=field):
            tba.state_from_numpy(tc, b)
    st = tba.state_from_numpy(tc, a)
    assert tba.check_indices(tc, st) is st
    c = tc.max_landmarks + 1
    with pytest.raises(ValueError, match="max_landmarks"):
        tba.add_frame(tc, st, torch.zeros(c, 3, dtype=tc.dtype),
                      torch.ones(c, dtype=torch.bool))


@pytest.mark.parametrize("case", ["point", "rotations", "pixel_sigma",
                                  "overflow"])
def test_add_frame_matches_jax(orbit, case):
    """Every field after ingesting the orbit: integers and masks
    bit-identical, floats (f64) within 1e-12 relative. "overflow" holds
    20 factors for ~100 observations (tests/test_graph.py:98)."""
    _, _, obs = orbit
    rot = case == "rotations"
    jc, tc = configs(with_rotations=rot,
                     pixel_sigma=1.0 if case == "pixel_sigma" else 0.0,
                     **TUNED)
    if case == "overflow":
        jc, tc = jc._replace(max_factors=20), tc._replace(max_factors=20)
    js = jax_ingest(jc, obs, rot)
    ts = tba.init_graph(tc)
    for i in range(FRAMES):
        ts = tba.add_frame(tc, ts, torch.tensor(obs.t_cl[i]),
                           torch.tensor(obs.mask[i]),
                           torch.tensor(obs.q_cl[i]) if rot else None)
    got, want = tba.state_to_numpy(ts), jax_arrays(js)
    for k in want:
        assert got[k].shape == want[k].shape, k
        if want[k].dtype.kind == "f":
            assert rel_err(got[k], want[k]) < 1e-12, k
        else:
            np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if case == "overflow":
        assert int(ts.f_count) == 20 and obs.mask.sum() > 20


@pytest.mark.parametrize("dtype", ["f64", "f32"])
@pytest.mark.parametrize("pixel_sigma", [0.0, 1.0])
@pytest.mark.parametrize("huber", [0.0, 2.0])
@pytest.mark.parametrize("rot", [False, True], ids=["point", "rotations"])
def test_linearize_matches_jax(mid_states, rot, huber, pixel_sigma, dtype):
    """h_pp, w, h_ll, g_p, g_l and the cost from the same mid-run state,
    window from pose 9: f64 within 1e-9, f32 within 1e-4 of the largest
    entry."""
    jc, tc = configs(dtype, with_rotations=rot, pixel_sigma=pixel_sigma,
                     huber_delta=huber, **TUNED)
    npdt = DTYPES[dtype][2]
    a = mid_states[rot, pixel_sigma]
    want = jax.jit(jba._linearize, static_argnums=0)(
        jc, to_jax(a, npdt), jnp.asarray(9, jnp.int32))
    got = tba._linearize(tc, tba.state_from_numpy(tc, a), torch.tensor(9))
    tol = 1e-9 if dtype == "f64" else 1e-4
    for name, g, w in zip(("h_pp", "w", "h_ll", "g_p", "g_l", "cost"),
                          got, want):
        assert g.dtype == DTYPES[dtype][1], name
        assert g.shape == w.shape, name
        assert rel_err(g.numpy(), w) < tol, name


def _jax_jacobians(fn, eps, *args):
    """JAX residuals and their jacfwd Jacobians at zero, vmapped over
    the factor arrays (trailing scalars broadcast)."""
    n = sum(1 for a in args if np.ndim(a))

    def one(*xs):
        full = (*xs, *args[n:])
        jac = jax.jacfwd(fn, argnums=(0, 1))(*eps, *full)
        return (fn(*eps, *full), *jac)
    return [np.asarray(x) for x in jax.jit(jax.vmap(one))(
        *(jnp.asarray(a) for a in args[:n]))]


def test_closed_form_jacobians_match_jacfwd():
    """The port's closed-form residual Jacobians against `jax.jacfwd` of
    the JAX residuals (f64, 1e-9 relative): random poses and landmarks,
    plus identical pose pairs and rotations of 1e-7 rad (the Taylor
    branches of the rotation log)."""
    rng = np.random.default_rng(11)
    n = 64

    def quats(scale):
        return jsyn._quat_from_rotvec(rng.normal(0, scale, (n, 3)))

    qa, qb = quats(0.6), quats(0.6)
    qb[:8] = qa[:8]                                     # identical poses
    qb[8:16] = jsyn._quat_mul(qa[8:16], jsyn._quat_from_rotvec(
        rng.normal(0, 1e-7, (8, 3))))                   # tiny rotations
    ta, tb = rng.normal(0, 1, (n, 3)), rng.normal(0, 1, (n, 3))
    tb[:8] = ta[:8]
    lm, tcl = rng.normal(0, 2, (n, 3)), rng.normal(0, 2, (n, 3))
    sig = rng.uniform(0.005, 0.05, (n, 3))
    lq, qcl = quats(1.0), quats(1.0)
    qcl[:8] = jsyn._quat_mul(jsyn._quat_conj(qa[:8]), lq[:8])  # φ ≈ 0
    z6, z3 = np.zeros(6), np.zeros(3)
    t = torch.tensor
    cases = [
        (_jax_jacobians(jba._odom_residual, (z6, z6), qa, ta, qb, tb, 0.3,
                        0.2),
         tba._odom(t(qa), t(ta), t(qb), t(tb), 0.3, 0.2)),
        (_jax_jacobians(jba._meas_residual, (z6, z3), qa, ta, lm, tcl, sig),
         tba._meas_point(t(qa), t(ta), t(lm), t(tcl), t(sig))),
        (_jax_jacobians(jba._meas_residual_rot, (z6, z6), qa, ta, lm, lq,
                        tcl, qcl, sig, 0.35),
         tba._meas_pose(t(qa), t(ta), t(lm), t(lq), t(tcl), t(qcl), t(sig),
                        0.35))]
    for want, got in cases:
        for w, g in zip(want, got):
            assert g.shape == w.shape
            assert rel_err(g.numpy(), w) < 1e-9


def test_schur_solve_matches_jax(mid_states):
    """_schur_solve (f64, 1e-9) on the JAX linearization of a 6-dof
    state, damping 1e-3."""
    jc, tc = configs(with_rotations=True, pixel_sigma=1.0, huber_delta=2.0,
                     **TUNED)
    lin = jax.jit(jba._linearize, static_argnums=0)(
        jc, to_jax(mid_states[True, 1.0]), jnp.asarray(1, jnp.int32))
    want = jax.jit(jba._schur_solve, static_argnums=0)(
        jc, *lin[:5], jnp.asarray(1e-3))
    got = tba._schur_solve(tc, *(torch.tensor(np.asarray(x))
                                 for x in lin[:5]), torch.tensor(1e-3))
    for g, w in zip(got, want):
        assert g.shape == w.shape
        assert rel_err(g.numpy(), w) < 1e-9


@pytest.fixture(scope="module")
def batch_runs(orbit):
    """batch_optimize (12 iterations) from the same ingested state, both
    packages, point mode with Huber and depth whitening, in f64 and
    f32."""
    _, traj, obs = orbit
    out = {}
    for dtype, (jdt, tdt, npdt) in DTYPES.items():
        jc, tc = configs(dtype, pixel_sigma=1.0, huber_delta=2.0, **TUNED)
        a = jax_arrays(jax_ingest(configs(pixel_sigma=1.0, huber_delta=2.0,
                                          **TUNED)[0], obs, False))
        js, jcost = jba.batch_optimize(jc, to_jax(a, npdt), iters=12)
        ts0 = tba.state_from_numpy(tc, a)
        ts, tcost = tba.batch_optimize(tc, ts0, iters=12)
        out[dtype] = (jc, tc, js, jcost, ts0, ts, tcost)
    return out


def test_batch_optimize_matches_jax(orbit, batch_runs):
    """f64: poses and landmarks within 1e-6 m and the cost within 1e-9;
    f32: ATE within 1e-3 m of JAX's; the gauge pose 0 bit-unchanged."""
    _, traj, _ = orbit
    jc, tc, js, jcost, ts0, ts, tcost = batch_runs["f64"]
    for k in ("pose_t", "lm"):
        assert np.abs(getattr(ts, k).numpy() - np.asarray(getattr(js, k))
                      ).max() < 1e-6, k
    assert np.abs(ts.pose_q.numpy() - np.asarray(js.pose_q)).max() < 1e-6
    assert abs(float(tcost) - float(jcost)) <= 1e-9 * float(jcost)
    ate64 = ate_rmse(ts.pose_t.numpy()[:FRAMES], traj.cam_t)
    assert ate64 < 0.05
    jc, tc, js, jcost, ts0, ts, tcost = batch_runs["f32"]
    assert ts.pose_t.dtype == torch.float32 and torch.isfinite(tcost)
    ate_t = ate_rmse(ts.pose_t.numpy()[:FRAMES].astype(np.float64),
                     traj.cam_t)
    ate_j = ate_rmse(np.asarray(js.pose_t)[:FRAMES].astype(np.float64),
                     traj.cam_t)
    assert abs(ate_t - ate_j) < 1e-3, (ate_t, ate_j)
    assert torch.equal(ts.pose_t[0], ts0.pose_t[0])
    assert torch.equal(ts.pose_q[0], ts0.pose_q[0])


@pytest.mark.parametrize("rot", [False, True], ids=["point", "rotations"])
def test_landmark_covariances_match_jax(mid_states, rot):
    """Marginal landmark covariance blocks (f64, 1e-8 relative)."""
    jc, tc = configs(with_rotations=rot, pixel_sigma=1.0, huber_delta=2.0,
                     **TUNED)
    a = mid_states[rot, 1.0]
    want = jba.landmark_covariances(jc, to_jax(a))
    got = tba.landmark_covariances(tc, tba.state_from_numpy(tc, a))
    assert got.shape == want.shape == (16, tc.lm_dim, tc.lm_dim)
    assert rel_err(got.numpy(), want) < 1e-8


def test_online_marginalization_matches_jax():
    """A bounded online run (tests/test_graph.py:214 at 60 frames and a
    24-pose budget: four marginalizations), driven as run_factorgraph
    drives it: the per-frame poses within 1e-6 m (f64), the priors
    within 1e-8 relative after every marginalization."""
    frames, mp = 60, 24
    scene = jsyn.make_wall_scene(num_markers=8, seed=0)
    traj = jsyn.make_orbit_trajectory(num_frames=frames)
    obs = jsyn.observe_poses(scene, traj, 16, noise_t=0.005, fov_limit=0.75)
    jc, tc = configs(max_poses=mp, max_factors=mp * 8, huber_delta=2.0,
                     pixel_sigma=1.0, **TUNED)
    js, ts = jba.init_graph(jc), tba.init_graph(tc)
    est_j, est_t = np.zeros((frames, 3)), np.zeros((frames, 3))
    num, marg = 1, 0
    for i in range(frames):
        js = jba.add_frame(jc, js, jnp.asarray(obs.t_cl[i]),
                           jnp.asarray(obs.mask[i]))
        js, _ = jba.optimize_window(jc, js, window=8, iters=3)
        ts = tba.add_frame(tc, ts, torch.tensor(obs.t_cl[i]),
                           torch.tensor(obs.mask[i]))
        ts, _ = tba.optimize_window(tc, ts, window=8, iters=3)
        num = min(num + 1, mp)
        est_j[i] = np.asarray(js.pose_t[num - 2])
        est_t[i] = ts.pose_t[num - 2].numpy()
        if num >= mp - 1:
            js = jba.marginalize_poses(jc, js, mp // 2)
            ts = tba.marginalize_poses(tc, ts, mp // 2)
            num = max(num - mp // 2, 1)
            marg += 1
            got, want = tba.state_to_numpy(ts), jax_arrays(js)
            for k in ("prior_lm_h", "prior_lm_mean"):
                assert rel_err(got[k], want[k]) < 1e-8, k
            for k in ("num_poses", "f_pose", "f_lm", "f_valid", "f_count"):
                np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    assert marg == 4 and int(ts.num_poses) == num
    assert np.abs(est_t - est_j).max() < 1e-6
    assert ate_rmse(est_t, traj.cam_t) < 0.05
