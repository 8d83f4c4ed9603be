"""Multiplicative-error-state Kalman filter (MEKF) for marker SLAM.

Counterpart of aruco_slam_tpu/filters/mekf.py with the same state
layout, noise model and step order (activate → predict → update), in
both landmark modes (point: [xyz]; ``with_rotations``: [xyz, quat]):

* fixed-capacity landmark state with an ``active`` mask;
* error-state covariance over [δt, δθ] (+ [δv] under the constant-
  velocity model) and 3 (point) or 6 (rotation) dims per landmark;
* the consistent augmentation P ← G P Gᵀ + B R Bᵀ for new landmarks
  (both size branches), the depth-scaled R (``pixel_sigma``; in rotation
  mode with the attitude rows and their ambiguity de-weighting), the
  double-cover sign alignment, the innovation gate, ``max_obs``
  measurement compaction, slot ``reset`` and the divergence guard;
* the update runs `cuda_mekf.fused_update` (Newton–Schulz gain and the
  Joseph form, f32) where the JAX package takes its Pallas kernel; with
  ``update_kernel=False``, or where the kernel cannot serve (a bf16
  ``cov_dtype``, ``joseph_form=False``, f64), the JAX package's XLA
  update: an equilibrated Cholesky (``s_solver="cho"``) or Newton–Schulz
  (``"ns"``) gain and the rank-M covariance form.

Every function takes the state with or without a leading stream axis
(S, ...): S independent filters step together and their update is one
`cuda_mekf.fused_update` launch — the JAX fleet's ``vmap``.

The Jacobians are closed form: with R = R(q) and v = l − t,
h = Rᵀ v has ∂h/∂δt = −Rᵀ, ∂h/∂δθ = Rᵀ[v]ₓ, ∂h/∂δl = Rᵀ; the relative
rotation q_cl = q̄ ⊗ q_l has ∂/∂δθ_cam = −½ q̄⊗eᵢ⊗q_l and
∂/∂δθ_lm = +½ q̄⊗eᵢ⊗q_l; a new landmark x = R(dq ⊗ q)(t_cl + z) + t has
∂x/∂δt = I, ∂x/∂δθ = −[R t_cl]ₓ, ∂x/∂z = R, and its rotation-vector
error ∂/∂δθ = I, ∂/∂z_rot = R. They are the first derivatives
`jax.jacfwd` takes of the same functions (tests/test_torch_mekf.py
holds them together).

``matmul_precision`` acts on a card as on a TPU: "high" runs the
non-kernel update's and the augmentation's matmuls in TF32, "default" in
bf16, "mixed" keeps the gain chain (PHᵀ, S, S⁻¹, K, innovation) in f32
and runs the covariance products in bf16. On the CPU every mode computes
f32, as XLA:CPU does. The kernel is f32 in every mode, as the JAX one.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch.core import lie
from aruco_slam_tpu_torch.core import quaternion as quat
from aruco_slam_tpu_torch.filters import cuda_mekf

CAM_EDIMS = 6
CAM_EDIMS_CV = 9
_DT = slice(0, 3)
_DTH = slice(3, 6)
_DV = slice(6, 9)

# matmul_precision -> (gain chain, covariance products) arithmetic on a
# card; the aliases are the other names jax.default_matmul_precision takes
_PRECISION = {"highest": ("ieee", "ieee"), "float32": ("ieee", "ieee"),
              "high": ("tf32", "tf32"), "tensorfloat32": ("tf32", "tf32"),
              "default": ("bf16", "bf16"), "bfloat16": ("bf16", "bf16"),
              "mixed": ("ieee", "bf16")}


class MekfConfig(NamedTuple):
    """Filter tuning; field names and defaults are the JAX package's,
    with ``update_kernel`` for its ``pallas_update``: None takes the
    fused kernel whenever it can serve (f32 covariance, Joseph form),
    False takes the XLA-form update, True insists on the kernel and
    raises where it cannot serve."""

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
    update_kernel: bool | None = None
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

    @property
    def cov_storage(self) -> torch.dtype:
        return self.cov_dtype or self.dtype


class MekfState(NamedTuple):
    cam_t: torch.Tensor        # (..., 3)
    cam_q: torch.Tensor        # (..., 4) wxyz, camera-to-world
    lm: torch.Tensor           # (..., C, 3) or (..., C, 7) [xyz, quat]
    cov: torch.Tensor          # (..., N, N), cfg.cov_storage
    active: torch.Tensor       # (..., C) bool
    vel: torch.Tensor          # (..., 3)
    dropped_obs: torch.Tensor  # (...) int32


class FrameObservations(NamedTuple):
    """One frame's observations by landmark slot (leading (T,) axis in
    `mekf_scan`, (S,) in a batched step)."""

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
    mapped, ``pallas_update`` as ``update_kernel``)."""
    fields = dict(fields)
    fields["update_kernel"] = fields.pop("pallas_update", None)
    fields["dtype"] = _torch_dtype(fields.get("dtype", np.float32))
    fields["cov_dtype"] = _torch_dtype(fields.get("cov_dtype"))
    return MekfConfig(**fields)


def _tensor_from_numpy(a, device=None) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":  # ml_dtypes, which torch cannot read
        return torch.from_numpy(a.view(np.uint16).copy()).view(
            torch.bfloat16).to(device)
    return torch.tensor(a, device=device)


def state_from_numpy(arrays: dict, device=None) -> MekfState:
    """MekfState from numpy arrays keyed by the JAX field names (a JAX
    bf16 covariance included)."""
    return MekfState(**{k: _tensor_from_numpy(arrays[k], device)
                        for k in MekfState._fields})


def state_to_numpy(state: MekfState) -> dict:
    """numpy arrays keyed by field name (a bf16 covariance as f32,
    exactly)."""
    return {k: (v.float() if v.dtype == torch.bfloat16 else v)
            .detach().cpu().numpy() for k, v in state._asdict().items()}


def _validate(cfg: MekfConfig) -> bool:
    """Raise on a config the filter cannot run; return whether the
    update takes the fused kernel (f32 covariance and the Joseph form
    only, as the JAX kernel)."""
    if cfg.motion_model not in ("none", "cv"):
        raise ValueError(f"unknown motion_model {cfg.motion_model!r}")
    if cfg.matmul_precision not in _PRECISION:
        raise ValueError(f"unknown matmul_precision {cfg.matmul_precision!r}")
    can = (cfg.joseph_form and cfg.dtype == torch.float32
           and cfg.cov_storage == torch.float32)
    if cfg.update_kernel and not can:
        raise ValueError(
            "update_kernel=True: the fused update is f32 with the Joseph "
            f"form only (dtype {cfg.dtype}, cov_dtype {cfg.cov_dtype}, "
            f"joseph_form {cfg.joseph_form})")
    return can if cfg.update_kernel is None else cfg.update_kernel


def init_state(cfg: MekfConfig, cam_t=None, cam_q=None,
               device=None) -> MekfState:
    """Initial state: camera at the given pose, no active landmarks."""
    _validate(cfg)
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
    lm = torch.zeros((cfg.capacity, cfg.lm_dims), dtype=dt, device=device)
    if cfg.with_rotations:
        lm[:, 3] = 1.0  # identity quaternions
    return MekfState(
        cam_t=cam_t, cam_q=cam_q, lm=lm,
        cov=torch.diag(diag).to(cfg.cov_storage),
        active=torch.zeros(cfg.capacity, dtype=torch.bool, device=device),
        vel=torch.zeros(3, dtype=dt, device=device),
        dropped_obs=torch.zeros((), dtype=torch.int32, device=device))


@contextlib.contextmanager
def _tf32():
    """TF32 float32 matmuls for the duration of the block only (the flag
    `_device.pin_precision` clears at import)."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = True
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def _matmul(mode: str, device: torch.device):
    """A matmul of the given arithmetic: "ieee" f32, "tf32", or "bf16"
    (bf16 operands on the tensor cores, f32 accumulation, the result
    rounded to bf16 and returned at the first operand's dtype). On the
    CPU every mode is f32."""
    if device.type != "cuda" or mode == "ieee":
        return torch.matmul
    if mode == "bf16":
        return lambda a, b: torch.matmul(
            a.to(torch.bfloat16), b.to(torch.bfloat16)).to(a.dtype)

    def tf32(a, b):
        with _tf32():
            return torch.matmul(a, b)
    return tf32


def _perturb(q: torch.Tensor, dth: torch.Tensor) -> torch.Tensor:
    """Left-multiplicative rotation-vector perturbation dq(δθ) ⊗ q."""
    dq = torch.cat([torch.ones_like(dth[..., :1]), 0.5 * dth], dim=-1)
    return quat.multiply(dq, q)


def _point_jacobians(cam_t, cam_q, lm, ce: int):
    """h = Rᵀ (l − t) for every slot and its Jacobians at zero error:
    (h (..., C, 3), j_cam (..., C, 3, ce), j_lm (..., C, 3, 3))."""
    lead = lm.shape[:-1]
    rot = quat.to_matrix(cam_q)
    rel = lm - cam_t[..., None, :]
    h = quat.rotate(quat.conjugate(cam_q)[..., None, :], rel)
    rt = rot.transpose(-1, -2)[..., None, :, :].expand(*lead, 3, 3)
    j_cam = torch.zeros((*lead, 3, ce), dtype=lm.dtype, device=lm.device)
    j_cam[..., _DT] = -rt
    j_cam[..., _DTH] = rt @ lie.skew(rel)
    return h, j_cam, rt


def _pose_jacobians(cam_t, cam_q, lm, ce: int):
    """h = [Rᵀ (l − t), q̄ ⊗ q_l] for every slot and its Jacobians at
    zero error: (h (..., C, 7), j_cam (..., C, 7, ce), j_lm (..., C, 7,
    6))."""
    lead = lm.shape[:-1]
    h_p, jc_p, jl_p = _point_jacobians(cam_t, cam_q, lm[..., :3], ce)
    lq = lm[..., 3:7]
    qbar = quat.conjugate(cam_q)[..., None, :]
    e = torch.eye(4, dtype=lm.dtype, device=lm.device)[1:]  # pure x, y, z
    # q̄ ⊗ eᵢ ⊗ q_l for i = x, y, z: (..., C, 3, 4) -> (..., C, 4, 3)
    m = quat.multiply(quat.multiply(qbar[..., None, :], e),
                      lq[..., None, :]).transpose(-1, -2)
    j_cam = torch.zeros((*lead, 7, ce), dtype=lm.dtype, device=lm.device)
    j_cam[..., :3, :] = jc_p
    j_cam[..., 3:, _DTH] = -0.5 * m
    j_lm = torch.zeros((*lead, 7, 6), dtype=lm.dtype, device=lm.device)
    j_lm[..., :3, :3] = jl_p
    j_lm[..., 3:, 3:] = 0.5 * m
    return torch.cat([h_p, quat.multiply(qbar, lq)], -1), j_cam, j_lm


def _init_jacobians(cam_q, t_cl, ce: int, with_rotations: bool = False):
    """Jacobians of a new landmark's error (position x = R(dq ⊗ q)(t_cl
    + z) + t, and in rotation mode the rotation vector of its attitude
    offset) at zero error: (j_cam (..., C, le, ce), j_z (..., C, le,
    le))."""
    lead = t_cl.shape[:-1]
    le = 6 if with_rotations else 3
    dt, dev = t_cl.dtype, t_cl.device
    rot = quat.to_matrix(cam_q)
    rot_c = rot[..., None, :, :].expand(*lead, 3, 3)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    j_cam = torch.zeros((*lead, le, ce), dtype=dt, device=dev)
    j_cam[..., :3, _DT] = eye3
    j_cam[..., :3, _DTH] = -lie.skew(t_cl @ rot.transpose(-1, -2))
    if not with_rotations:
        return j_cam, rot_c
    j_cam[..., 3:, _DTH] = eye3
    j_z = torch.zeros((*lead, 6, 6), dtype=dt, device=dev)
    j_z[..., :3, :3] = rot_c
    j_z[..., 3:, 3:] = rot_c
    return j_cam, j_z


def _meas_variances(cfg: MekfConfig, t_cl: torch.Tensor, ambiguity=None):
    """(r_rows (..., C, md), r_init (..., C, zdim)): the update rows'
    variances and the augmentation's init noise (zdim 3, or 6 with a
    rotation VECTOR in rotation mode: var_rotvec = 4·var_quat).
    Constant R, or the depth-scaled planar-PnP variances when
    pixel_sigma > 0, with ambiguous rotations (ratio > 0.6) de-weighted
    by 1e6."""
    lead, dt, dev = t_cl.shape[:-1], cfg.dtype, t_cl.device
    if cfg.pixel_sigma <= 0.0:
        zdim = 6 if cfg.with_rotations else 3
        return (torch.full((*lead, cfg.meas_dims), cfg.r_uncertainty,
                           dtype=dt, device=dev),
                torch.full((*lead, zdim), cfg.r_uncertainty, dtype=dt,
                           device=dev))
    depth = torch.clamp(t_cl[..., 2], min=0.2)
    sig_z = cfg.pixel_sigma * depth * depth \
        / (cfg.focal_px * cfg.marker_size)
    var_z = torch.clamp(sig_z * sig_z, min=1e-8)
    var_xy = var_z / 9.0
    r_pos = torch.stack([var_xy, var_xy, var_z], dim=-1)
    if not cfg.with_rotations:
        return r_pos.to(dt), r_pos.to(dt)
    sig_th = 3.0 * cfg.pixel_sigma * depth \
        / (cfg.focal_px * cfg.marker_size)
    var_q = torch.clamp(sig_th * sig_th, min=1e-8)
    if ambiguity is not None:
        var_q = var_q * torch.where(ambiguity > 0.6, 1e6, 1.0)
    r_rows = torch.cat([r_pos, var_q[..., None].expand(*lead, 4)], -1)
    r_init = torch.cat([r_pos, (4.0 * var_q)[..., None].expand(*lead, 3)],
                       -1)
    return r_rows.to(dt), r_init.to(dt)


def _augment_consistent(cfg: MekfConfig, state: MekfState, new, new_dims,
                        t_cl, q_cl, r_init, mm=torch.matmul
                        ) -> torch.Tensor:
    """P ← G P Gᵀ + B R Bᵀ for the newly activated landmarks, per
    stream; a stream's covariance unchanged when none is new. ``mm``
    runs the covariance products (its precision)."""
    c, le, n, dt = cfg.capacity, cfg.lm_edims, cfg.err_dim, cfg.dtype
    ce = cfg.cam_edims
    lead = new.shape[:-1]
    dev = t_cl.device
    j_cam_init, j_z_init = _init_jacobians(state.cam_q, t_cl, ce,
                                           cfg.with_rotations)
    g_cam = torch.where(new[..., None, None], j_cam_init, 0.0)
    keep = (~new_dims).to(dt)
    p = state.cov
    cdt = p.dtype
    if n < 768:
        g_mat = torch.eye(n, dtype=dt, device=dev) * keep[..., :, None]
        g_mat[..., ce:, :ce] = g_cam.reshape(*lead, c * le, ce)
        cov = mm(mm(g_mat, p.to(dt)), g_mat.transpose(-1, -2)).to(cdt)
    else:
        g_full = torch.zeros((*lead, n, ce), dtype=dt, device=dev)
        g_full[..., ce:, :] = g_cam.reshape(*lead, c * le, ce)
        mpm = p * (keep[..., :, None] * keep[..., None, :]).to(cdt)
        epm = (mm(g_full, p[..., :ce, :].to(dt))
               * keep[..., None, :]).to(cdt)
        epmt = mm(keep[..., :, None] * p[..., :, :ce].to(dt),
                  g_full.transpose(-1, -2)).to(cdt)
        epe = mm(g_full, mm(p[..., :ce, :ce].to(dt),
                            g_full.transpose(-1, -2))).to(cdt)
        cov = mpm + epm + epmt + epe
    b = torch.where(new[..., None, None], j_z_init, 0.0)
    brb = torch.einsum("...jlz,...jmz,...jz->...jlm", b, b, r_init)
    eye_c = torch.eye(c, dtype=dt, device=dev)
    brb_full = torch.einsum("jc,...jlm->...jlcm", eye_c, brb).reshape(
        *lead, c * le, c * le)
    cov = cov.clone()
    cov[..., ce:, ce:] += brb_full.to(cdt)
    return torch.where(new.any(-1)[..., None, None], cov, state.cov)


def _rows(x: torch.Tensor, idx: torch.Tensor) -> torch.Tensor:
    """x[..., idx, ...] along the slot axis (the one after the leading
    dims of ``idx``)."""
    d = idx.dim() - 1
    shape = (*idx.shape, *x.shape[d + 1:])
    return torch.gather(x, d, idx.reshape(*idx.shape, *[1] * (x.dim() - d - 1)
                                          ).expand(shape))


def _update_xla_form(cfg: MekfConfig, cov, h_mat, r_diag, resid):
    """The JAX package's non-kernel update: gain by the equilibrated,
    jittered Cholesky ("cho") or Newton–Schulz ("ns"), then the rank-M
    covariance form (I−KH)P(I−KH)ᵀ + KRKᵀ = P − K(HP) − (HP)ᵀKᵀ + KSKᵀ,
    or (I−KH)P without Joseph. Returns (innovation, new cov)."""
    dt, cdt, dev = cfg.dtype, cov.dtype, cov.device
    gain_mode, cov_mode = _PRECISION[cfg.matmul_precision]
    mg, mc = _matmul(gain_mode, dev), _matmul(cov_mode, dev)
    ph_t = mg(cov.to(dt), h_mat.transpose(-1, -2))          # (..., N, M)
    s = mg(h_mat, ph_t) + torch.diag_embed(r_diag)          # (..., M, M)
    m_dim = s.shape[-1]
    eye_m = torch.eye(m_dim, dtype=dt, device=dev)
    if cfg.s_solver == "ns":
        norm1 = torch.amax(torch.sum(torch.abs(s), dim=-2), dim=-1)
        x = s / (norm1 * norm1)[..., None, None]
        for _ in range(cfg.ns_iters):
            x = mg(x, 2.0 * eye_m - mg(s, x))
        gain = mg(ph_t, x)
    else:
        d_inv = torch.rsqrt(torch.clamp(
            torch.diagonal(s, dim1=-2, dim2=-1), min=1e-30))
        s_eq = s * d_inv[..., :, None] * d_inv[..., None, :] + 1e-5 * eye_m
        low, info = torch.linalg.cholesky_ex(s_eq)
        gain = torch.cholesky_solve(
            (ph_t * d_inv[..., None, :]).transpose(-1, -2), low
        ).transpose(-1, -2) * d_inv[..., None, :]
        # a failed factorization NaNs the gain, as LAPACK's does in
        # JAX, so the divergence guard drops the frame
        gain = torch.where((info == 0)[..., None, None], gain, math.nan)
    innovation = mg(gain, resid[..., None])[..., 0]
    a = mc(gain, ph_t.transpose(-1, -2)).to(cdt)            # K (HP)
    if cfg.joseph_form:
        ksk = mc(mc(gain, s), gain.transpose(-1, -2)).to(cdt)
        cov = cov - a - a.transpose(-1, -2) + ksk
    else:
        cov = cov - a
    return innovation, (0.5 * (cov + cov.transpose(-1, -2))).to(cdt)


def _linearize(cfg: MekfConfig, state: MekfState, obs: FrameObservations):
    """A step up to its update: activate new landmarks, predict, and the
    update's rows. Returns (pred, h_mat, r_diag, resid, prev_t): ``pred``
    is the state the update corrects (predicted pose and velocity, the
    landmarks and slots activated, the dropped count, the predicted and
    augmented covariance), then the update's inputs and the camera
    position before the prediction."""
    c, le, md = cfg.capacity, cfg.lm_edims, cfg.meas_dims
    n = cfg.err_dim
    ce = cfg.cam_edims
    dt, cdt = cfg.dtype, cfg.cov_storage
    dev = state.cov.device
    lead = state.active.shape[:-1]
    _, cov_mode = _PRECISION[cfg.matmul_precision]

    mask = obs.mask.to(torch.bool)
    if cfg.divergence_guard:
        mask = mask & torch.isfinite(obs.t_cl).all(-1) \
            & torch.isfinite(obs.q_cl).all(-1)
    t_cl = torch.where(mask[..., None], obs.t_cl.to(dt), 0.0)
    q_cl = None
    if cfg.with_rotations:
        ident_q = torch.zeros_like(obs.q_cl)
        ident_q[..., 0] = 1.0
        q_cl = quat.normalize(
            torch.where(mask[..., None], obs.q_cl, ident_q).to(dt))

    prev_t = state.cam_t
    if cfg.motion_model == "cv":
        cov0 = state.cov.clone()
        if cfg.vel_decay < 1.0:
            # a fill on the device, not a copy from the host (which a
            # CUDA graph cannot capture): the same f32 rounding of vel_decay
            rho = torch.full((), cfg.vel_decay, dtype=dt, device=dev)
            state = state._replace(vel=rho * state.vel)
            rho_c = rho.to(cdt)  # bf16-cov storage rounds rho first
            cov0[..., _DV, :] *= rho_c
            cov0[..., :, _DV] *= rho_c
        state = state._replace(cam_t=state.cam_t + state.vel)
        cov0[..., _DT, :] += cov0[..., _DV, :]
        cov0[..., :, _DT] += cov0[..., :, _DV]
        state = state._replace(cov=cov0)
    elif cfg.vel_smoothing > 0.0:
        state = state._replace(cam_t=state.cam_t + state.vel)

    if obs.reset is not None:
        state = state._replace(active=state.active & ~obs.reset)

    new = mask & ~state.active
    lm_xyz_init = quat.rotate(state.cam_q[..., None, :], t_cl) \
        + state.cam_t[..., None, :]
    lm = state.lm.clone()
    lm[..., :3] = torch.where(new[..., None], lm_xyz_init, state.lm[..., :3])
    if cfg.with_rotations:
        q_wl_init = quat.normalize(
            quat.multiply(state.cam_q[..., None, :], q_cl))
        lm[..., 3:7] = torch.where(new[..., None], q_wl_init, lm[..., 3:7])
    active = state.active | mask

    new_dims = torch.cat([
        torch.zeros((*lead, ce), dtype=torch.bool, device=dev),
        torch.repeat_interleave(new, le, dim=-1)], -1)
    amb = None
    if obs.ambiguity is not None:
        amb = torch.where(mask, obs.ambiguity.to(dt), 0.0)
    r_rows, r_init = _meas_variances(cfg, t_cl, amb)
    if cfg.consistent_init:
        cov = _augment_consistent(cfg, state, new, new_dims, t_cl, q_cl,
                                  r_init, _matmul(cov_mode, dev))
    else:
        keep = ~new_dims
        cov = state.cov * (keep[..., :, None] & keep[..., None, :])
        cov = cov + torch.diag_embed(torch.where(
            new_dims, cfg.initial_landmark_uncertainty, 0.0).to(dt))

    q_diag = torch.zeros((*lead, n), dtype=dt, device=dev)
    if cfg.motion_model == "cv":
        q_diag[..., _DT] = cfg.q_pos_cv
        q_diag[..., _DTH] = cfg.q_error_uncertainty_cam
        q_diag[..., _DV] = cfg.q_vel
    else:
        q_diag[..., _DT] = cfg.q_uncertainty_cam
        q_diag[..., _DTH] = cfg.q_error_uncertainty_cam
    q_diag[..., ce:] = torch.where(
        torch.repeat_interleave(active, le, dim=-1),
        cfg.q_uncertainty_lm, 0.0).to(dt)
    cov = (cov + torch.diag_embed(q_diag)).to(cdt)

    if cfg.with_rotations:
        h_all, j_cam, j_lm = _pose_jacobians(state.cam_t, state.cam_q, lm,
                                             ce)
        # double cover: sign-align the observed quaternion to the
        # prediction
        flip = torch.sum(q_cl * h_all[..., 3:7], dim=-1) < 0
        z = torch.cat([t_cl, torch.where(flip[..., None], -q_cl, q_cl)],
                      -1)
    else:
        h_all, j_cam, j_lm = _point_jacobians(state.cam_t, state.cam_q, lm,
                                              ce)
        z = t_cl

    if cfg.gate_distance > 0.0:
        pos_resid = torch.linalg.vector_norm(z[..., :3] - h_all[..., :3],
                                             dim=-1)
        mask = mask & (~state.active | (pos_resid < cfg.gate_distance))

    w = mask[..., None].to(dt)
    resid_rows = (z - h_all) * w

    k_obs = min(cfg.max_obs, c)
    dropped_obs = state.dropped_obs
    if k_obs < c:
        dropped_obs = dropped_obs + torch.clamp(
            mask.sum(-1, dtype=torch.int32) - k_obs, min=0)
        # lax.top_k over the 0/1 mask: ties break to the lowest index,
        # which a stable descending sort reproduces
        sel = torch.sort(mask.to(torch.int32), dim=-1, descending=True,
                         stable=True).indices[..., :k_obs]
        sel_valid = torch.gather(mask, -1, sel).to(dt)
        h_cam = (_rows(j_cam, sel) * sel_valid[..., None, None]).reshape(
            *lead, k_obs * md, ce)
        onehot = (sel[..., None] == torch.arange(c, device=dev)
                  ).to(dt) * sel_valid[..., None]
        h_lm = torch.einsum("...kc,...kml->...kmcl", onehot,
                            _rows(j_lm, sel))
        h_mat = torch.cat([h_cam, h_lm.reshape(*lead, k_obs * md, c * le)],
                          -1)
        resid = (_rows(resid_rows, sel) * sel_valid[..., None]).reshape(
            *lead, -1)
        r_diag = torch.where(
            torch.repeat_interleave(sel_valid > 0, md, dim=-1),
            _rows(r_rows, sel).reshape(*lead, -1), 1.0).to(dt)
    else:
        h_cam = (j_cam * w[..., None]).reshape(*lead, c * md, ce)
        eye_c = torch.eye(c, dtype=dt, device=dev)
        h_lm = torch.einsum("jc,...jml->...jmcl", eye_c, j_lm * w[..., None])
        h_mat = torch.cat([h_cam, h_lm.reshape(*lead, c * md, c * le)], -1)
        resid = resid_rows.reshape(*lead, -1)
        r_diag = torch.where(torch.repeat_interleave(mask, md, dim=-1),
                             r_rows.reshape(*lead, -1), 1.0).to(dt)
    pred = MekfState(cam_t=state.cam_t, cam_q=state.cam_q, lm=lm, cov=cov,
                     active=active, vel=state.vel, dropped_obs=dropped_obs)
    return pred, h_mat, r_diag, resid, prev_t


def _correct(cfg: MekfConfig, pred: MekfState, innovation: torch.Tensor,
             cov: torch.Tensor, prev_t: torch.Tensor) -> MekfState:
    """A step after its update: the innovation and the updated
    covariance ``cov`` applied to `_linearize`'s ``pred``, under the
    divergence guard (whose fallback is ``pred.cov``). Updates
    ``pred.lm`` in place."""
    c, le, ce = cfg.capacity, cfg.lm_edims, cfg.cam_edims
    lead = pred.active.shape[:-1]
    if cfg.divergence_guard:
        innovation = torch.where(
            torch.isfinite(innovation).all(-1, keepdim=True), innovation,
            0.0)
    cam_t = pred.cam_t + innovation[..., _DT]
    cam_q = quat.normalize(_perturb(pred.cam_q, innovation[..., _DTH]))
    lm = pred.lm
    lm_inn = innovation[..., ce:].reshape(*lead, c, le)
    lm[..., :3] += lm_inn[..., :3]
    if cfg.with_rotations:
        lm[..., 3:7] = quat.normalize(_perturb(lm[..., 3:7],
                                               lm_inn[..., 3:6]))
    if cfg.divergence_guard:
        cov = torch.where(
            torch.isfinite(cov).all(-1).all(-1)[..., None, None], cov,
            pred.cov)

    if cfg.motion_model == "cv":
        vel = pred.vel + innovation[..., _DV]
    elif cfg.vel_smoothing > 0.0:
        b = cfg.vel_smoothing
        vel = b * pred.vel + (1.0 - b) * (cam_t - prev_t)
    else:
        vel = pred.vel
    return MekfState(cam_t=cam_t, cam_q=cam_q, lm=lm, cov=cov,
                     active=pred.active, vel=vel,
                     dropped_obs=pred.dropped_obs)


def mekf_step(cfg: MekfConfig, state: MekfState,
              obs: FrameObservations) -> MekfState:
    """One frame: activate new landmarks → predict → update. With a
    leading stream axis on every field, S filters step at once and the
    update is one kernel launch."""
    use_kernel = _validate(cfg)
    pred, h_mat, r_diag, resid, prev_t = _linearize(cfg, state, obs)
    if use_kernel:
        innovation, cov = cuda_mekf.fused_update(
            pred.cov.contiguous(), h_mat.contiguous(), r_diag.contiguous(),
            resid.contiguous(), ns_iters=cfg.ns_iters)
    else:
        innovation, cov = _update_xla_form(cfg, pred.cov, h_mat, r_diag,
                                           resid)
    return _correct(cfg, pred, innovation, cov, prev_t)


def _frame(seq: FrameObservations, i: int, axis: int) -> FrameObservations:
    return FrameObservations(*(None if x is None else x.select(axis, i)
                               for x in seq))


def _assign(dst: NamedTuple, src: NamedTuple) -> None:
    """Copy each field of ``src`` into ``dst``'s (None fields and a
    field that is ``dst``'s own tensor skipped)."""
    for d, x in zip(dst, src):
        if d is not None and x is not d:
            d.copy_(x)


class _GraphedStep:
    """`mekf_step` for one `_runner_key` as two CUDA graphs around the
    fused update, on static buffers: the state, one frame's
    observations (every field a view of one byte buffer, ``packed``, so
    that one copy loads a frame), the update's outputs and the pose.

    Graph A runs `_linearize` and writes the predicted state, its
    covariance included, back into the static state. The fused update
    (B3) is called eagerly between the graphs, so that its launch
    counter and a wrapper around it see every frame; it writes buffers
    of its own. Graph B runs `_correct` and writes the new state and
    the pose back. The rows graph A leaves for B3 live in the graphs'
    memory pool and are read in the frame that writes them, so all the
    runners of a device share one pool."""

    def __init__(self, cfg: MekfConfig, state: MekfState,
                 frame: FrameObservations, stream):
        self.cfg = cfg
        self.stream = stream  # the capture stream (`_capture_stream`)

        def like(x, shape=None):
            return torch.empty(x.shape if shape is None else shape,
                               dtype=x.dtype, device=x.device)
        self.state = MekfState(*map(like, state))
        # byte ranges of the present fields, wider elements first so that
        # each field starts at a multiple of its element size
        self.layout, start = [], 0
        for i in sorted((i for i, x in enumerate(frame) if x is not None),
                        key=lambda i: -frame[i].element_size()):
            end = start + frame[i].numel() * frame[i].element_size()
            self.layout.append((i, start, end))
            start = end
        self.packed = torch.empty(start, dtype=torch.uint8,
                                  device=state.cov.device)
        views = [None] * len(frame)
        for i, a, b in self.layout:
            views[i] = self.packed[a:b].view(frame[i].dtype).view(
                frame[i].shape)
        self.obs = FrameObservations(*views)
        self.prev_t = like(state.cam_t)
        self.inn = like(state.cov, state.cov.shape[:-1])
        self.cov_new = like(state.cov)
        self.pose = like(state.cam_t, (*state.cam_t.shape[:-1], 7))
        self.rows = None    # graph A's h_mat, r_diag and resid
        self.graphs = None  # (graph A, graph B) once captured

    def pack(self, obs_seq: FrameObservations, axis: int) -> torch.Tensor:
        """A sequence's observations as (T, bytes a frame) rows in the
        layout of ``packed``."""
        t = obs_seq.mask.shape[axis]
        return torch.cat([obs_seq[i].movedim(axis, 0).reshape(t, -1)
                          .view(torch.uint8) for i, _, _ in self.layout], 1)

    def predict(self) -> None:
        """Graph A's work."""
        pred, *rows, prev_t = _linearize(self.cfg, self.state, self.obs)
        self.prev_t.copy_(prev_t)
        _assign(self.state, pred)
        self.rows = [x.contiguous() for x in rows]

    def update(self) -> None:
        """B3 on the predicted covariance, into ``inn`` and ``cov_new``."""
        cuda_mekf.fused_update(self.state.cov, *self.rows,
                               ns_iters=self.cfg.ns_iters,
                               out=(self.inn, self.cov_new))

    def correct(self) -> None:
        """Graph B's work."""
        _assign(self.state, _correct(self.cfg, self.state, self.inn,
                                     self.cov_new, self.prev_t))
        torch.cat([self.state.cam_t, self.state.cam_q], -1, out=self.pose)

    def step(self) -> None:
        """One frame on the static buffers: replayed once captured; the
        first frame eagerly, then the capture."""
        if self.graphs is None:
            self._capture()
            mekf_scan.eager_steps += 1
            return
        graph_a, graph_b = self.graphs
        graph_a.replay()
        self.update()
        graph_b.replay()
        mekf_scan.graph_steps += 1

    def _capture(self) -> None:
        """Step the frame eagerly on the capture stream (what initialises
        lazily, cuBLAS's workspace for the stream among it, does so
        outside the capture), then capture graph A and graph B."""
        dev = self.state.cov.device
        if dev not in _GRAPH_POOLS:
            _GRAPH_POOLS[dev] = torch.cuda.graph_pool_handle()
        caller = torch.cuda.current_stream(dev)
        self.stream.wait_stream(caller)
        with torch.cuda.stream(self.stream):
            self.predict()
            self.update()
            self.correct()
        caller.wait_stream(self.stream)
        graphs = (torch.cuda.CUDAGraph(), torch.cuda.CUDAGraph())
        for graph, part in zip(graphs, (self.predict, self.correct)):
            with torch.cuda.graph(graph, pool=_GRAPH_POOLS[dev],
                                  stream=self.stream,
                                  capture_error_mode="thread_local"):
                part()
        self.graphs = graphs
        mekf_scan.captures += 1


# a device's graph memory pool and side stream; the runners by key
_GRAPH_POOLS: dict = {}
_SIDE_STREAMS: dict = {}
_RUNNERS: dict = {}


def _capture_stream(dev: torch.device):
    """The stream a runner for the caller's current stream captures on:
    that stream, or, where it is the default stream (which cannot
    capture), a side stream of the device's own. cuBLAS keeps a
    workspace for each stream it runs on (32 MiB on an H100) and a graph
    keeps its capture stream's, so graphs captured on the stream that
    the caller's eager work runs on add none: `apps.run_slam` runs its
    requests on a stream of their own (`_device.request_stream`) for
    this."""
    current = torch.cuda.current_stream(dev)
    if current != torch.cuda.default_stream(dev):
        return current
    if dev not in _SIDE_STREAMS:
        _SIDE_STREAMS[dev] = torch.cuda.Stream(dev)
    return _SIDE_STREAMS[dev]


def _graphable(cfg: MekfConfig, state: MekfState) -> bool:
    """Whether `mekf_scan` replays the step from CUDA graphs: a state on
    a card, an update by the fused kernel (`_validate`; the XLA-form one
    factorises with cuSOLVER, which is not captured), and a stream not
    capturing already."""
    return (state.cov.device.type == "cuda" and _validate(cfg)
            and not torch.cuda.is_current_stream_capturing())


def _runner_key(cfg: MekfConfig, state: MekfState,
                frame: FrameObservations, stream=None) -> tuple:
    """What a runner's graphs are fixed to: the config, the dtype,
    shape and device of every state field (the stream count S among
    them) and of one frame's observations (None for an absent optional
    field), and the stream they replay on. Not the sequence length:
    every chunk replays the same graphs."""
    def sig(x):
        return None if x is None else (x.dtype, tuple(x.shape), x.device)
    return (cfg, tuple(map(sig, state)), tuple(map(sig, frame)), stream)


def _graphed_scan(cfg: MekfConfig, state: MekfState,
                  obs_seq: FrameObservations, axis: int, t: int):
    dev = state.cov.device
    frame = _frame(obs_seq, 0, axis)
    key = _runner_key(cfg, state, frame, torch.cuda.current_stream(dev))
    run = _RUNNERS.get(key)
    if run is None:
        run = _RUNNERS[key] = _GraphedStep(cfg, state, frame,
                                           _capture_stream(dev))
    with torch.cuda.device(dev):
        _assign(run.state, state)
        traj = torch.empty((*state.cam_t.shape[:-1], t, 7),
                           dtype=state.cam_t.dtype, device=dev)
        packed = run.pack(obs_seq, axis)
        for i in range(t):
            run.packed.copy_(packed[i])
            run.step()
            traj.select(axis, i).copy_(run.pose)
        return MekfState(*(x.clone() for x in run.state)), traj


def mekf_scan(cfg: MekfConfig, state: MekfState,
              obs_seq: FrameObservations):
    """Filter a (T, ...) observation sequence frame by frame — or, for a
    state with a leading stream axis, an (S, T, ...) one, the S streams
    stepping together. Returns the final state and the camera trajectory
    (T, 7) or (S, T, 7) [xyz, quat wxyz], tensors of the caller's own.

    Where `_graphable` holds, each frame copies its observations in (one
    copy), replays graph A, calls the fused update and replays graph B
    (`_GraphedStep`, one a `_runner_key`, captured on its first frame):
    the kernels `mekf_step` launches, in its order, from two graph
    launches and B3's own. Elsewhere the frames run `mekf_step`. Counters: ``captures``,
    ``graph_steps`` (frames replayed) and ``eager_steps`` (the runners'
    first frames, stepped before their capture)."""
    batched = state.cov.dim() == 3
    axis = 1 if batched else 0
    t = obs_seq.mask.shape[axis]
    if t and _graphable(cfg, state):
        return _graphed_scan(cfg, state, obs_seq, axis, t)
    traj = []
    for i in range(t):
        state = mekf_step(cfg, state, _frame(obs_seq, i, axis))
        traj.append(torch.cat([state.cam_t, state.cam_q], -1))
    if not traj:
        return state, torch.zeros((*state.cam_t.shape[:-1], 0, 7),
                                  dtype=cfg.dtype, device=state.cov.device)
    return state, torch.stack(traj, axis)


mekf_scan.captures = 0
mekf_scan.graph_steps = 0
mekf_scan.eager_steps = 0


def preload_map(cfg: MekfConfig, state: MekfState, ids, positions,
                uncertainties=None) -> MekfState:
    """Activate landmarks from a saved map before filtering (the JAX
    package's fixed version of the reference's load-map path):
    positions into slots ``ids``, the per-landmark position variances
    from ``uncertainties`` (default the initial landmark uncertainty)."""
    dev = state.cov.device
    ids = torch.as_tensor(np.asarray(ids), dtype=torch.long, device=dev)
    pos = torch.as_tensor(np.asarray(positions), dtype=cfg.dtype,
                          device=dev)
    lm = state.lm.clone()
    lm[ids, :3] = pos[:, :3]
    active = state.active.clone()
    active[ids] = True
    if uncertainties is None:
        unc = torch.full((len(ids), 3), cfg.initial_landmark_uncertainty,
                         dtype=cfg.dtype, device=dev)
    else:
        unc = torch.as_tensor(np.asarray(uncertainties), dtype=cfg.dtype,
                              device=dev)[:, :3]
    rows = (cfg.cam_edims + ids[:, None] * cfg.lm_edims
            + torch.arange(3, device=dev)).reshape(-1)
    cov = state.cov.clone()
    cov[rows, rows] = unc.reshape(-1).to(cov.dtype)
    return state._replace(lm=lm, active=active, cov=cov)


def rotation_consistency_gate(cfg: MekfConfig, state: MekfState,
                              obs: FrameObservations,
                              threshold_deg: float = 50.0
                              ) -> FrameObservations:
    """Drop observations of active landmarks whose implied map-frame
    rotation q_wc ⊗ q_cl is more than ``threshold_deg`` from the
    landmark's (double cover folded); new slots pass. Rotation mode
    only."""
    if not cfg.with_rotations:
        raise ValueError("rotation gate needs with_rotations=True")
    q_obs = quat.multiply(state.cam_q[..., None, :], obs.q_cl)
    dot = torch.abs(torch.sum(quat.normalize(q_obs)
                              * quat.normalize(state.lm[..., 3:7]), dim=-1))
    angle = 2.0 * torch.arccos(torch.clamp(dot, 0.0, 1.0))
    ok = angle < math.radians(threshold_deg)
    keep = torch.where(state.active, ok, True) & obs.mask
    return obs._replace(mask=keep)


def innovation_gate(cfg: MekfConfig, state: MekfState,
                    obs: FrameObservations,
                    max_distance_m: float = 1.0) -> FrameObservations:
    """Drop observations of active landmarks whose camera-frame position
    is more than ``max_distance_m`` from the prediction; new slots
    pass. Either landmark mode."""
    pred = quat.rotate(quat.conjugate(state.cam_q)[..., None, :],
                       state.lm[..., :3] - state.cam_t[..., None, :])
    dist = torch.linalg.vector_norm(obs.t_cl - pred, dim=-1)
    keep = torch.where(state.active, dist < max_distance_m, True) & obs.mask
    return obs._replace(mask=keep)


def landmark_uncertainties(cfg: MekfConfig, state: MekfState
                           ) -> torch.Tensor:
    """Per-landmark error covariance diagonals (..., C, lm_edims), at
    the state dtype (a bf16 covariance widens exactly)."""
    diag = torch.diagonal(state.cov, dim1=-2, dim2=-1)[..., cfg.cam_edims:]
    diag = diag.to(cfg.dtype)
    return diag.reshape(*diag.shape[:-1], cfg.capacity, cfg.lm_edims)


def camera_pose(state: MekfState) -> torch.Tensor:
    """Camera pose as [xyz, quat wxyz] (..., 7)."""
    return torch.cat([state.cam_t, state.cam_q], -1)
