"""Multiplicative-error-state Kalman filter (MEKF) for marker SLAM, point mode.

Counterpart of aruco_slam_tpu/filters/mekf.py with the same state
layout, noise model and step order (activate → predict → update):

* fixed-capacity landmark state with an ``active`` mask;
* error-state covariance over [δt, δθ] (+ [δv] under the constant-
  velocity model) and 3 position dims per landmark;
* the consistent augmentation P ← G P Gᵀ + B R Bᵀ for new landmarks
  (both size branches), the depth-scaled R (``pixel_sigma``), the
  innovation gate, ``max_obs`` measurement compaction, slot ``reset``
  and the divergence guard;
* the update runs `cuda_mekf.fused_update` (Newton–Schulz gain and the
  Joseph form, f32) — where the JAX package takes its Pallas kernel
  (``MekfConfig(pallas_update=True)``). As there, ``s_solver`` does not
  apply to that path.

The Jacobians are closed form: with R = R(q) and v = l − t,
h = Rᵀ v has ∂h/∂δt = −Rᵀ, ∂h/∂δθ = Rᵀ[v]ₓ, ∂h/∂δl = Rᵀ; a new landmark
x = R(dq ⊗ q)(t_cl + z) + t has ∂x/∂δt = I, ∂x/∂δθ = −[R t_cl]ₓ,
∂x/∂z = R. They are the first derivatives `jax.jacfwd` takes of the
same functions (tests/test_torch_mekf.py holds them together).

Not ported yet: ``with_rotations``, ``cov_dtype`` other than ``dtype``,
``joseph_form=False``, ``matmul_precision`` other than "highest",
``preload_map`` and the standalone rotation/innovation gates.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch.core import quaternion as quat
from aruco_slam_tpu_torch.filters import cuda_mekf

CAM_EDIMS = 6
CAM_EDIMS_CV = 9
_DT = slice(0, 3)
_DTH = slice(3, 6)
_DV = slice(6, 9)


class MekfConfig(NamedTuple):
    """Filter tuning; field names and defaults are the JAX package's
    (without ``pallas_update``: the port always takes its kernel)."""

    capacity: int = 64
    with_rotations: bool = False
    initial_camera_uncertainty: float = 0.1
    initial_landmark_uncertainty: float = 0.7
    r_uncertainty: float = 0.9
    q_uncertainty_cam: float = 0.3
    q_error_uncertainty_cam: float = 0.5
    q_uncertainty_lm: float = 0.01
    joseph_form: bool = True
    consistent_init: bool = True
    dtype: torch.dtype = torch.float32
    cov_dtype: torch.dtype | None = None
    ns_iters: int = 20
    s_solver: str = "cho"
    vel_smoothing: float = 0.0
    motion_model: str = "none"
    q_vel: float = 2e-3
    q_pos_cv: float = 1e-4
    initial_vel_uncertainty: float = 0.01
    vel_decay: float = 1.0
    matmul_precision: str = "highest"
    divergence_guard: bool = True
    max_obs: int = 16
    pixel_sigma: float = 0.0
    focal_px: float = 1414.9
    marker_size: float = 0.16
    gate_distance: float = 0.0

    @property
    def lm_dims(self) -> int:
        return 7 if self.with_rotations else 3

    @property
    def lm_edims(self) -> int:
        return 6 if self.with_rotations else 3

    @property
    def meas_dims(self) -> int:
        return 7 if self.with_rotations else 3

    @property
    def cam_edims(self) -> int:
        return CAM_EDIMS_CV if self.motion_model == "cv" else CAM_EDIMS

    @property
    def err_dim(self) -> int:
        return self.cam_edims + self.capacity * self.lm_edims


class MekfState(NamedTuple):
    cam_t: torch.Tensor        # (3,)
    cam_q: torch.Tensor        # (4,) wxyz, camera-to-world
    lm: torch.Tensor           # (C, 3)
    cov: torch.Tensor          # (N, N)
    active: torch.Tensor       # (C,) bool
    vel: torch.Tensor          # (3,)
    dropped_obs: torch.Tensor  # () int32


class FrameObservations(NamedTuple):
    """One frame's observations by landmark slot (leading (T,) axis in
    `mekf_scan`)."""

    t_cl: torch.Tensor
    q_cl: torch.Tensor
    mask: torch.Tensor
    ambiguity: torch.Tensor | None = None
    reset: torch.Tensor | None = None


def _torch_dtype(dt) -> torch.dtype | None:
    if dt is None or isinstance(dt, torch.dtype):
        return dt
    return getattr(torch, np.dtype(dt).name)


def config_from_jax(fields: dict) -> MekfConfig:
    """A JAX ``MekfConfig._asdict()`` -> the port's config (dtypes
    mapped, ``pallas_update`` dropped)."""
    fields = dict(fields)
    fields.pop("pallas_update", None)
    fields["dtype"] = _torch_dtype(fields.get("dtype", np.float32))
    fields["cov_dtype"] = _torch_dtype(fields.get("cov_dtype"))
    return MekfConfig(**fields)


def state_from_numpy(arrays: dict, device=None) -> MekfState:
    """MekfState from numpy arrays keyed by the JAX field names."""
    return MekfState(**{k: torch.tensor(np.asarray(arrays[k]),
                                        device=device)
                        for k in MekfState._fields})


def state_to_numpy(state: MekfState) -> dict:
    return {k: v.detach().cpu().numpy()
            for k, v in state._asdict().items()}


def _check_supported(cfg: MekfConfig) -> None:
    if cfg.with_rotations:
        raise NotImplementedError("MEKF with_rotations: not ported yet")
    if cfg.cov_dtype not in (None, cfg.dtype):
        raise NotImplementedError("MEKF cov_dtype: not ported yet")
    if not cfg.joseph_form:
        raise NotImplementedError("MEKF joseph_form=False: not ported yet")
    if cfg.matmul_precision != "highest":
        raise NotImplementedError(
            f"MEKF matmul_precision={cfg.matmul_precision!r}: not ported "
            "yet (the port runs full f32)")
    if cfg.motion_model not in ("none", "cv"):
        raise ValueError(f"unknown motion_model {cfg.motion_model!r}")


def init_state(cfg: MekfConfig, cam_t=None, cam_q=None,
               device=None) -> MekfState:
    """Initial state: camera at the given pose, no active landmarks."""
    _check_supported(cfg)
    dt = cfg.dtype
    cam_t = torch.zeros(3, dtype=dt, device=device) if cam_t is None \
        else torch.as_tensor(cam_t, dtype=dt, device=device)
    cam_q = quat.identity(dt, device) if cam_q is None \
        else torch.as_tensor(cam_q, dtype=dt, device=device)
    n = cfg.err_dim
    diag = torch.full((n,), cfg.initial_landmark_uncertainty, dtype=dt,
                      device=device)
    diag[:CAM_EDIMS] = cfg.initial_camera_uncertainty
    if cfg.motion_model == "cv":
        diag[_DV] = cfg.initial_vel_uncertainty
    return MekfState(
        cam_t=cam_t, cam_q=cam_q,
        lm=torch.zeros((cfg.capacity, cfg.lm_dims), dtype=dt,
                       device=device),
        cov=torch.diag(diag),
        active=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        vel=torch.zeros(3, dtype=dt, device=device),
        dropped_obs=torch.zeros((), dtype=torch.int32, device=device))


def _skew(v: torch.Tensor) -> torch.Tensor:
    """[v]ₓ for (..., 3) -> (..., 3, 3)."""
    x, y, z = v.unbind(-1)
    o = torch.zeros_like(x)
    return torch.stack([torch.stack([o, -z, y], -1),
                        torch.stack([z, o, -x], -1),
                        torch.stack([-y, x, o], -1)], -2)


def _perturb(q: torch.Tensor, dth: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative rotation-vector perturbation dq(δθ) ⊗ q."""
    dq = torch.cat([torch.ones_like(dth[..., :1]), 0.5 * dth], dim=-1)
    return quat.multiply(dq, q)


def _point_jacobians(cam_t, cam_q, lm, ce: int):
    """h = Rᵀ (l − t) for every slot and its Jacobians at zero error:
    (h (C, 3), j_cam (C, 3, ce), j_lm (C, 3, 3))."""
    c = lm.shape[0]
    rot = quat.to_matrix(cam_q)
    rel = lm - cam_t
    h = quat.rotate(quat.conjugate(cam_q)[None, :], rel)
    rt = rot.T.expand(c, 3, 3)
    j_cam = torch.zeros((c, 3, ce), dtype=lm.dtype, device=lm.device)
    j_cam[:, :, _DT] = -rt
    j_cam[:, :, _DTH] = rt @ _skew(rel)
    return h, j_cam, rt


def _init_jacobians(cam_q, t_cl, ce: int):
    """Jacobians of a new landmark x = R(dq ⊗ q)(t_cl + z) + t at zero
    error: (j_cam (C, 3, ce), j_z (C, 3, 3))."""
    c = t_cl.shape[0]
    rot = quat.to_matrix(cam_q)
    j_cam = torch.zeros((c, 3, ce), dtype=t_cl.dtype, device=t_cl.device)
    j_cam[:, :, _DT] = torch.eye(3, dtype=t_cl.dtype, device=t_cl.device)
    j_cam[:, :, _DTH] = -_skew(t_cl @ rot.T)
    return j_cam, rot.expand(c, 3, 3)


def _meas_variances(cfg: MekfConfig, t_cl: torch.Tensor):
    """(r_rows (C, 3), r_init (C, 3)): constant R, or the depth-scaled
    planar-PnP variances when pixel_sigma > 0."""
    c, dt = cfg.capacity, cfg.dtype
    if cfg.pixel_sigma <= 0.0:
        r = torch.full((c, 3), cfg.r_uncertainty, dtype=dt,
                       device=t_cl.device)
        return r, r
    depth = torch.clamp(t_cl[:, 2], min=0.2)
    sig_z = cfg.pixel_sigma * depth * depth \
        / (cfg.focal_px * cfg.marker_size)
    var_z = torch.clamp(sig_z * sig_z, min=1e-8)
    var_xy = var_z / 9.0
    r_pos = torch.stack([var_xy, var_xy, var_z], dim=-1).to(dt)
    return r_pos, r_pos


def _augment_consistent(cfg: MekfConfig, state: MekfState, new, new_dims,
                        t_cl, r_init) -> torch.Tensor:
    """P ← G P Gᵀ + B R Bᵀ for the newly activated landmarks; the
    state's covariance unchanged when no landmark is new."""
    c, le, n, dt = cfg.capacity, cfg.lm_edims, cfg.err_dim, cfg.dtype
    ce = cfg.cam_edims
    dev = t_cl.device
    j_cam_init, j_z_init = _init_jacobians(state.cam_q, t_cl, ce)
    g_cam = torch.where(new[:, None, None], j_cam_init, 0.0)
    keep = (~new_dims).to(dt)
    p = state.cov
    if n < 768:
        g_mat = torch.eye(n, dtype=dt, device=dev) * keep[:, None]
        g_mat[ce:, :ce] = g_cam.reshape(c * le, ce)
        cov = g_mat @ p @ g_mat.T
    else:
        g_full = torch.zeros((n, ce), dtype=dt, device=dev)
        g_full[ce:, :] = g_cam.reshape(c * le, ce)
        mpm = p * (keep[:, None] * keep[None, :])
        epm = (g_full @ p[:ce, :]) * keep[None, :]
        epmt = (keep[:, None] * p[:, :ce]) @ g_full.T
        epe = g_full @ (p[:ce, :ce] @ g_full.T)
        cov = mpm + epm + epmt + epe
    b = torch.where(new[:, None, None], j_z_init, 0.0)
    brb = torch.einsum("jlz,jmz,jz->jlm", b, b, r_init)
    eye_c = torch.eye(c, dtype=dt, device=dev)
    brb_full = torch.einsum("jc,jlm->jlcm", eye_c, brb).reshape(
        c * le, c * le)
    cov = cov.clone()
    cov[ce:, ce:] += brb_full
    return torch.where(new.any(), cov, state.cov)


def mekf_step(cfg: MekfConfig, state: MekfState,
              obs: FrameObservations) -> MekfState:
    """One frame: activate new landmarks → predict → update."""
    _check_supported(cfg)
    c, le, md = cfg.capacity, cfg.lm_edims, cfg.meas_dims
    n = cfg.err_dim
    ce = cfg.cam_edims
    dt = cfg.dtype
    dev = state.cov.device

    mask = obs.mask.to(torch.bool)
    if cfg.divergence_guard:
        mask = mask & torch.isfinite(obs.t_cl).all(-1) \
            & torch.isfinite(obs.q_cl).all(-1)
    # point mode measures positions only: q_cl enters through the
    # finiteness guard above and nowhere else
    t_cl = torch.where(mask[:, None], obs.t_cl.to(dt), 0.0)

    prev_t = state.cam_t
    if cfg.motion_model == "cv":
        cov0 = state.cov.clone()
        if cfg.vel_decay < 1.0:
            rho = torch.tensor(cfg.vel_decay, dtype=dt, device=dev)
            state = state._replace(vel=rho * state.vel)
            cov0[_DV, :] *= rho
            cov0[:, _DV] *= rho
        state = state._replace(cam_t=state.cam_t + state.vel)
        cov0[_DT, :] += cov0[_DV, :]
        cov0[:, _DT] += cov0[:, _DV]
        state = state._replace(cov=cov0)
    elif cfg.vel_smoothing > 0.0:
        state = state._replace(cam_t=state.cam_t + state.vel)

    if obs.reset is not None:
        state = state._replace(active=state.active & ~obs.reset)

    new = mask & ~state.active
    lm_xyz_init = quat.rotate(state.cam_q[None, :], t_cl) + state.cam_t
    lm = torch.where(new[:, None], lm_xyz_init, state.lm)
    active = state.active | mask

    new_dims = torch.cat([torch.zeros(ce, dtype=torch.bool, device=dev),
                          torch.repeat_interleave(new, le)])
    r_rows, r_init = _meas_variances(cfg, t_cl)
    if cfg.consistent_init:
        cov = _augment_consistent(cfg, state, new, new_dims, t_cl, r_init)
    else:
        keep = ~new_dims
        cov = state.cov * (keep[:, None] & keep[None, :])
        cov = cov + torch.diag(torch.where(
            new_dims, cfg.initial_landmark_uncertainty, 0.0).to(dt))

    q_diag = torch.zeros(n, dtype=dt, device=dev)
    if cfg.motion_model == "cv":
        q_diag[_DT] = cfg.q_pos_cv
        q_diag[_DTH] = cfg.q_error_uncertainty_cam
        q_diag[_DV] = cfg.q_vel
    else:
        q_diag[_DT] = cfg.q_uncertainty_cam
        q_diag[_DTH] = cfg.q_error_uncertainty_cam
    q_diag[ce:] = torch.where(torch.repeat_interleave(active, le),
                              cfg.q_uncertainty_lm, 0.0).to(dt)
    cov = cov + torch.diag(q_diag)

    h_all, j_cam, j_lm = _point_jacobians(state.cam_t, state.cam_q, lm, ce)
    z = t_cl

    if cfg.gate_distance > 0.0:
        pos_resid = torch.linalg.vector_norm(z - h_all, dim=-1)
        mask = mask & (~state.active | (pos_resid < cfg.gate_distance))

    w = mask[:, None].to(dt)
    resid_rows = (z - h_all) * w

    k_obs = min(cfg.max_obs, c)
    dropped_obs = state.dropped_obs
    if k_obs < c:
        dropped_obs = dropped_obs + torch.clamp(
            mask.sum(dtype=torch.int32) - k_obs, min=0)
        # lax.top_k over the 0/1 mask: ties break to the lowest index,
        # which a stable descending sort reproduces
        sel = torch.sort(mask.to(torch.int32), descending=True,
                         stable=True).indices[:k_obs]
        sel_valid = mask[sel].to(dt)
        h_cam = (j_cam[sel] * sel_valid[:, None, None]).reshape(
            k_obs * md, ce)
        onehot = (sel[:, None] == torch.arange(c, device=dev)[None, :]
                  ).to(dt) * sel_valid[:, None]
        h_lm = torch.einsum("kc,kml->kmcl", onehot, j_lm[sel])
        h_mat = torch.cat([h_cam, h_lm.reshape(k_obs * md, c * le)], 1)
        resid = (resid_rows[sel] * sel_valid[:, None]).reshape(-1)
        r_diag = torch.where(torch.repeat_interleave(sel_valid > 0, md),
                             r_rows[sel].reshape(-1), 1.0).to(dt)
    else:
        h_cam = (j_cam * w[:, :, None]).reshape(c * md, ce)
        eye_c = torch.eye(c, dtype=dt, device=dev)
        h_lm = torch.einsum("jc,jml->jmcl", eye_c, j_lm * w[:, :, None])
        h_mat = torch.cat([h_cam, h_lm.reshape(c * md, c * le)], 1)
        resid = resid_rows.reshape(-1)
        r_diag = torch.where(torch.repeat_interleave(mask, md),
                             r_rows.reshape(-1), 1.0).to(dt)
    cov_pred = cov
    innovation, new_cov = cuda_mekf.fused_update(
        cov.contiguous(), h_mat.contiguous(), r_diag.contiguous(),
        resid.contiguous(), ns_iters=cfg.ns_iters)

    if cfg.divergence_guard:
        innovation = torch.where(torch.isfinite(innovation).all(),
                                 innovation, 0.0)
    cam_t = state.cam_t + innovation[_DT]
    cam_q = quat.normalize(_perturb(state.cam_q, innovation[_DTH]))
    lm = lm + innovation[ce:].reshape(c, le)
    cov = new_cov
    if cfg.divergence_guard:
        cov = torch.where(torch.isfinite(cov).all(), cov, cov_pred)

    if cfg.motion_model == "cv":
        vel = state.vel + innovation[_DV]
    elif cfg.vel_smoothing > 0.0:
        b = cfg.vel_smoothing
        vel = b * state.vel + (1.0 - b) * (cam_t - prev_t)
    else:
        vel = state.vel
    return MekfState(cam_t=cam_t, cam_q=cam_q, lm=lm, cov=cov,
                     active=active, vel=vel, dropped_obs=dropped_obs)


def mekf_scan(cfg: MekfConfig, state: MekfState,
              obs_seq: FrameObservations):
    """Filter a (T, ...) observation sequence frame by frame. Returns
    the final state and the (T, 7) camera trajectory [xyz, quat wxyz]."""
    traj = []
    for i in range(obs_seq.mask.shape[0]):
        state = mekf_step(cfg, state, FrameObservations(
            *(None if x is None else x[i] for x in obs_seq)))
        traj.append(torch.cat([state.cam_t, state.cam_q]))
    if not traj:
        return state, torch.zeros((0, 7), dtype=cfg.dtype,
                                  device=state.cov.device)
    return state, torch.stack(traj)


def landmark_uncertainties(cfg: MekfConfig, state: MekfState
                           ) -> torch.Tensor:
    """Per-landmark error covariance diagonals (C, lm_edims)."""
    diag = torch.diagonal(state.cov)[cfg.cam_edims:]
    return diag.reshape(cfg.capacity, cfg.lm_edims)


def camera_pose(state: MekfState) -> torch.Tensor:
    """Camera pose as [xyz, quat wxyz] (7,)."""
    return torch.cat([state.cam_t, state.cam_q])
