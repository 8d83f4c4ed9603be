"""Batched Schur-complement bundle adjustment on marker pose graphs.

Counterpart of aruco_slam_tpu/graph/ba.py, with the same problem, state
layout and step order:

* pose variables X_0 .. X_{n-1} (camera-to-world), landmark positions
  L_j (3-vectors, or 6-dof [position, orientation] with
  ``with_rotations``), X_0 frozen as the gauge;
* identity-motion odometry factors between consecutive poses and
  camera→landmark factors r = R_iᵀ(l_j − t_i) − t_cl, whitened per axis;
* residuals and their closed-form Jacobian blocks batched over the
  factor arrays, normal equations assembled by accumulating
  index-adds into dense blocks, landmarks eliminated by a dense Schur
  complement S = H_pp − W H_ll⁻¹ Wᵀ, the reduced camera system solved
  by Cholesky.

Fixed capacities everywhere (`max_poses`, `max_landmarks`,
`max_factors`) with validity masks, as in the JAX package. What JAX gets
from its semantics the port does by hand: scatters that JAX drops out
of range go to one spare row that is cut off; a failed factorization
gives NaN (``cholesky_ex``/``inv_ex``/``solve_ex`` without error checks,
so the LM rejects the trial as JAX does and nothing syncs the host);
the LM's accept/reject is a ``torch.where`` on device values, so a
solve reads nothing back. The products run at full f32 (no TF32) on a
card, as the JAX solve traces at "highest" precision.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch.core import lie
from aruco_slam_tpu_torch.core import quaternion as quat

_PI = 3.141592653589793


class GraphConfig(NamedTuple):
    """Capacities and noise model: the JAX package's fields and defaults
    (its module documents each), ``dtype`` a torch dtype."""

    max_poses: int = 128
    max_landmarks: int = 64
    max_factors: int = 1024
    odom_sigma_rot: float = 20.0 * _PI / 180.0
    odom_sigma_t: float = 0.1
    meas_sigma_t: float = 0.5
    pixel_sigma: float = 0.0
    focal_px: float = 1414.9
    marker_size: float = 0.16
    with_rotations: bool = False
    meas_sigma_rot: float = 0.35
    lm_init_lambda: float = 1e-4
    lm_factor: float = 4.0
    huber_delta: float = 0.0
    dtype: torch.dtype = torch.float32

    @property
    def lm_dim(self) -> int:
        """Landmark error-state dimension: 3 (point) or 6 (pose)."""
        return 6 if self.with_rotations else 3


class GraphState(NamedTuple):
    """Fixed-capacity pose-graph problem and current estimates; the
    per-landmark priors carry the information of marginalized poses."""

    pose_q: torch.Tensor        # (T, 4) wxyz camera-to-world
    pose_t: torch.Tensor        # (T, 3)
    lm: torch.Tensor            # (L, 3) marker positions (world)
    lm_q: torch.Tensor          # (L, 4) marker orientations (wxyz)
    lm_active: torch.Tensor     # (L,) bool
    num_poses: torch.Tensor     # () int32: poses 0..num_poses-1 are live
    f_pose: torch.Tensor        # (F,) int32 observing pose index
    f_lm: torch.Tensor          # (F,) int32 observed landmark index
    f_tcl: torch.Tensor         # (F, 3) measured marker position, camera
    f_qcl: torch.Tensor         # (F, 4) measured marker orientation
    f_sig: torch.Tensor         # (F, 3) per-axis whitening sigmas
    f_valid: torch.Tensor       # (F,) bool
    f_count: torch.Tensor       # () int32
    prior_lm_h: torch.Tensor    # (L, 3, 3) information (position block)
    prior_lm_mean: torch.Tensor  # (L, 3)


_INT_FIELDS = ("num_poses", "f_pose", "f_lm", "f_count")
_BOOL_FIELDS = ("lm_active", "f_valid")
# the fields an LM step changes
_ESTIMATES = ("pose_q", "pose_t", "lm", "lm_q")


def state_from_numpy(cfg: GraphConfig, arrays: dict,
                     device=None) -> GraphState:
    """GraphState from numpy arrays keyed by the field names (a JAX
    GraphState's ``_asdict()``): floats at ``cfg.dtype``, counts and
    indices int32, masks bool."""
    def conv(k):
        a = np.asarray(arrays[k])
        dt = torch.int32 if k in _INT_FIELDS else torch.bool \
            if k in _BOOL_FIELDS else cfg.dtype
        return torch.tensor(a, device=device).to(dt)
    return GraphState(**{k: conv(k) for k in GraphState._fields})


def state_to_numpy(state: GraphState) -> dict:
    """numpy arrays keyed by field name."""
    return {k: v.detach().cpu().numpy() for k, v in state._asdict().items()}


@contextlib.contextmanager
def _full_f32():
    """IEEE f32 matmuls for the block (the JAX solve's "highest"
    precision): TF32 off, restored after."""
    matmul = torch.backends.cuda.matmul
    prev = matmul.allow_tf32
    matmul.allow_tf32 = False
    try:
        yield
    finally:
        matmul.allow_tf32 = prev


def init_graph(cfg: GraphConfig, cam_t=None, cam_q=None,
               device=None) -> GraphState:
    dt, t, lc, f = cfg.dtype, cfg.max_poses, cfg.max_landmarks, \
        cfg.max_factors

    def zeros(*shape, dtype=dt):
        return torch.zeros(shape, dtype=dtype, device=device)

    def unit_quats(n):
        q = zeros(n, 4)
        q[:, 0] = 1.0
        return q

    pose_q, pose_t = unit_quats(t), zeros(t, 3)
    if cam_q is not None:
        pose_q[0] = torch.as_tensor(cam_q, dtype=dt, device=device)
    if cam_t is not None:
        pose_t[0] = torch.as_tensor(cam_t, dtype=dt, device=device)
    return GraphState(
        pose_q=pose_q, pose_t=pose_t, lm=zeros(lc, 3), lm_q=unit_quats(lc),
        lm_active=zeros(lc, dtype=torch.bool),
        num_poses=torch.ones((), dtype=torch.int32, device=device),
        f_pose=zeros(f, dtype=torch.int32), f_lm=zeros(f, dtype=torch.int32),
        f_tcl=zeros(f, 3), f_qcl=unit_quats(f),
        f_sig=torch.full((f, 3), cfg.meas_sigma_t, dtype=dt, device=device),
        f_valid=zeros(f, dtype=torch.bool),
        f_count=zeros(dtype=torch.int32),
        prior_lm_h=zeros(lc, 3, 3), prior_lm_mean=zeros(lc, 3))


def _scatter_drop(arr: torch.Tensor, dest: torch.Tensor,
                  vals: torch.Tensor) -> torch.Tensor:
    """``arr.at[dest].set(vals, mode="drop")`` for ``dest`` in [0, len]:
    index ``len(arr)`` lands in a spare row that is cut off."""
    buf = torch.cat([arr, arr[:1]])
    buf.index_copy_(0, dest, vals.to(arr.dtype))
    return buf[:-1]


def _block_add(buf: torch.Tensor, rows, cols, vals) -> torch.Tensor:
    """Accumulate (F, m, n) blocks into ``buf`` (R, C, m, n) at (rows[f],
    cols[f]); blocks that share a position add up."""
    r, c = buf.shape[:2]
    return buf.reshape(r * c, *buf.shape[2:]).index_add_(
        0, rows * c + cols, vals).view(buf.shape)


def _outer(a, b):
    """Σ_m a[f, m, i] b[f, m, j] -> (F, i, j)."""
    return a.transpose(-1, -2) @ b


def _gradient(j, r):
    """−Σ_m j[f, m, i] r[f, m] -> (F, i)."""
    return -(j.transpose(-1, -2) @ r[..., None])[..., 0]


def _nan_unless(ok: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
    """x where the factorization succeeded, NaN where it failed (what
    JAX's factorizations return)."""
    return torch.where(ok, x, torch.full_like(x, math.nan))


def _row(x: torch.Tensor, i: torch.Tensor) -> torch.Tensor:
    """x[i] for a 0-dim device index, without reading it back."""
    return x.index_select(0, i.reshape(1).long())


def add_frame(cfg: GraphConfig, state: GraphState, t_cl: torch.Tensor,
              mask: torch.Tensor, q_cl: torch.Tensor | None = None
              ) -> GraphState:
    """Ingest one frame: measurement factors for the observed slots,
    first sightings initialized in the world frame, and the next pose at
    the current estimate (identity motion). ``t_cl`` (C, 3) and ``q_cl``
    (C, 4) are slot-indexed (slot == landmark index), ``mask`` (C,) bool;
    observations beyond factor capacity are dropped."""
    dt = cfg.dtype
    dev = state.pose_q.device
    i = state.num_poses - 1
    cam_q, cam_t = _row(state.pose_q, i), _row(state.pose_t, i)  # (1, .)
    t_cl = torch.where(mask[:, None], t_cl.to(dt), 0.0)
    c = mask.shape[0]
    ident = quat.identity(dt, dev).expand(c, 4)
    q_cl = ident if q_cl is None else torch.where(
        mask[:, None], quat.normalize(q_cl.to(dt)), ident)

    new = mask & ~state.lm_active
    lm = torch.where(new[:, None], quat.rotate(cam_q, t_cl) + cam_t,
                     state.lm)
    lm_q = torch.where(new[:, None], quat.multiply(cam_q, q_cl), state.lm_q)
    lm_active = state.lm_active | mask

    # append measurement factors at f_count + rank(slot in mask);
    # masked-off slots and overflow go to the spare row
    rank = torch.cumsum(mask, 0, dtype=torch.int64) - 1
    dest = state.f_count.long() + rank
    ok = mask & (dest < cfg.max_factors)
    dest = torch.where(ok, dest, cfg.max_factors)
    slots = torch.arange(c, dtype=torch.int32, device=dev)
    if cfg.pixel_sigma > 0.0:
        depth = torch.clamp(t_cl[:, 2], min=0.2)
        sig_z = torch.clamp(cfg.pixel_sigma * depth * depth
                            / (cfg.focal_px * cfg.marker_size), min=1e-4)
        sig = torch.stack([sig_z / 3.0, sig_z / 3.0, sig_z], dim=-1)
    else:
        sig = torch.full((c, 3), cfg.meas_sigma_t, dtype=dt, device=dev)
    f_count = torch.clamp(state.f_count + mask.sum(dtype=torch.int32),
                          max=cfg.max_factors)

    # next pose: identity motion model (estimate = current pose)
    nxt = torch.clamp(state.num_poses, max=cfg.max_poses - 1).reshape(1)
    return state._replace(
        pose_q=state.pose_q.index_copy(0, nxt.long(), cam_q),
        pose_t=state.pose_t.index_copy(0, nxt.long(), cam_t),
        lm=lm, lm_q=lm_q, lm_active=lm_active,
        num_poses=torch.clamp(state.num_poses + 1, max=cfg.max_poses),
        f_pose=_scatter_drop(state.f_pose, dest,
                             i.to(torch.int32).expand(c)),
        f_lm=_scatter_drop(state.f_lm, dest, slots),
        f_tcl=_scatter_drop(state.f_tcl, dest, t_cl),
        f_qcl=_scatter_drop(state.f_qcl, dest, q_cl),
        f_sig=_scatter_drop(state.f_sig, dest, sig),
        f_valid=_scatter_drop(state.f_valid, dest, ok),
        f_count=f_count)


# ---------------------------------------------------------------------------
# Residuals (whitened) and their Jacobian blocks, batched per factor.
# ---------------------------------------------------------------------------

def _meas_residual(pose_q, pose_t, lm, t_cl, sigma_t):
    """Whitened point-observation residual (F, 3): the marker predicted
    in the camera frame, Rᵀ(l − t), less the measured one; ``sigma_t``
    (F, 3) per camera axis."""
    pred = quat.rotate(quat.conjugate(pose_q), lm - pose_t)
    return (pred - t_cl) / sigma_t


def _meas_residual_rot(pose_q, pose_t, lm, lm_q, t_cl, q_cl, sigma_t,
                       sigma_rot):
    """Whitened 6-dof observation residual (F, 6): [position / sigma_t,
    Log(q_cl_meas⁻¹ ⊗ q̄ ⊗ q_l) / sigma_rot]."""
    pred_q = quat.multiply(quat.conjugate(pose_q), lm_q)
    r_r = quat.to_rotvec(quat.multiply(quat.conjugate(q_cl), pred_q))
    return torch.cat([_meas_residual(pose_q, pose_t, lm, t_cl, sigma_t),
                      r_r / sigma_rot], dim=-1)


def _odom_residual(qa, ta, qb, tb, sig_rot, sig_t):
    """Whitened identity-motion residual (F, 6) for the pose pairs (a =
    X_i, b = X_{i-1}): [Log(R_aᵀ R_b), R_aᵀ(t_b − t_a)]."""
    r_rot = quat.to_rotvec(quat.multiply(quat.conjugate(qa), qb)) / sig_rot
    r_t = quat.rotate(quat.conjugate(qa), tb - ta) / sig_t
    return torch.cat([r_rot, r_t], dim=-1)


# The Jacobians below are closed form, in the JAX package's perturbation
# convention: a pose moves by [δθ, δt] as (q ⊗ Exp(δθ), t + δt), a landmark
# by δl (and q_l ⊗ Exp(δθ_l)). They are the derivatives `jax.jacfwd` takes
# of the JAX residuals at zero perturbation (tests/test_torch_graph.py
# holds them together, the small-angle branches included).

def _blocks(a, b, c, d) -> torch.Tensor:
    """[[a, b], [c, d]] over the last two axes."""
    return torch.cat([torch.cat([a, b], -1), torch.cat([c, d], -1)], -2)


def _meas_point(pose_q, pose_t, lm, t_cl, sig):
    """The point residual at zero perturbation and its Jacobians: r (F,
    3), ∂r/∂[δθ, δt] = [[pred]ₓ, −Rᵀ]/σ (F, 3, 6), ∂r/∂δl = Rᵀ/σ (F, 3,
    3), with pred = Rᵀ(l − t); the rows divide by the per-axis σ."""
    rt = quat.to_matrix(pose_q).transpose(-1, -2)
    pred = quat.rotate(quat.conjugate(pose_q), lm - pose_t)
    s = sig[..., None]
    return ((pred - t_cl) / sig, torch.cat([lie.skew(pred), -rt], -1) / s,
            rt / s)


def _meas_pose(pose_q, pose_t, lm, lm_q, t_cl, q_cl, sig, sig_rot):
    """The 6-dof residual and its Jacobians: the point rows as
    `_meas_point`; with φ = Log(q_cl⁻¹ ⊗ B), B = q̄ ⊗ q_l, the rotation
    rows are ∂/∂δθ = −Jr⁻¹(φ) R_Bᵀ and ∂/∂δθ_l = Jr⁻¹(φ), over σ_rot."""
    r_t, jp_t, jl_t = _meas_point(pose_q, pose_t, lm, t_cl, sig)
    pred_q = quat.multiply(quat.conjugate(pose_q), lm_q)
    phi = quat.to_rotvec(quat.multiply(quat.conjugate(q_cl), pred_q))
    jr = lie.so3_right_jacobian_inv(phi) / sig_rot
    z = torch.zeros_like(jr)
    rbt = quat.to_matrix(pred_q).transpose(-1, -2)
    return (torch.cat([r_t, phi / sig_rot], -1),
            torch.cat([jp_t, torch.cat([-jr @ rbt, z], -1)], -2),
            _blocks(jl_t, z, z, jr))


def _odom(qa, ta, qb, tb, sig_rot, sig_t):
    """The odometry residual [φ, p] (φ = Log(q̄_a ⊗ q_b), p = R_aᵀ(t_b −
    t_a)) and its Jacobians in the perturbations of a and b:
    ∂/∂a = [[−Jr⁻¹(φ) R_relᵀ, 0], [[p]ₓ, −R_aᵀ]], ∂/∂b = [[Jr⁻¹(φ), 0],
    [0, R_aᵀ]], rotation rows over σ_rot and translation rows over σ_t."""
    rel = quat.multiply(quat.conjugate(qa), qb)
    phi = quat.to_rotvec(rel)
    p = quat.rotate(quat.conjugate(qa), tb - ta)
    jr = lie.so3_right_jacobian_inv(phi) / sig_rot
    rat = quat.to_matrix(qa).transpose(-1, -2) / sig_t
    z = torch.zeros_like(jr)
    ja = _blocks(-jr @ quat.to_matrix(rel).transpose(-1, -2), z,
                 lie.skew(p) / sig_t, -rat)
    return torch.cat([phi / sig_rot, p / sig_t], -1), ja, _blocks(jr, z, z,
                                                                   rat)


def _huber(cfg: GraphConfig, r, *jacs):
    """IRLS Huber weights sqrt(min(1, delta/|r|)) on the residuals and
    their Jacobians (identity without ``huber_delta``)."""
    if cfg.huber_delta <= 0.0:
        return (r, *jacs)
    rn = torch.linalg.vector_norm(r, dim=-1)
    w = torch.sqrt(torch.clamp(cfg.huber_delta / torch.clamp(rn, min=1e-12),
                               max=1.0))
    return (r * w[:, None], *(j * w[:, None, None] for j in jacs))


def _odom_linearize(cfg: GraphConfig, state: GraphState):
    """Odometry residuals and Jacobians of every consecutive pair (a =
    1..T-1, b = a-1), live or not."""
    return _odom(state.pose_q[1:], state.pose_t[1:], state.pose_q[:-1],
                 state.pose_t[:-1], cfg.odom_sigma_rot, cfg.odom_sigma_t)


class MeasTerms(NamedTuple):
    """Measurement-factor contributions to the normal equations: plain
    sums over factors, so partial results from factor shards combine by
    one all-reduce. D = cfg.lm_dim."""

    diag: torch.Tensor   # (T, 6, 6) pose diagonal blocks
    w4: torch.Tensor     # (T, 6, L, D) pose-landmark coupling
    h_ll: torch.Tensor   # (L, D, D) landmark blocks
    g_p: torch.Tensor    # (T, 6)
    g_l: torch.Tensor    # (L, D)
    cost: torch.Tensor   # ()


def _meas_linearize(cfg: GraphConfig, state: GraphState):
    """Per-factor residuals and Jacobian blocks: (r (F, m), jp (F, m, 6),
    jl (F, m, D)) with m = 3 or 6."""
    fp, fl_i = state.f_pose.long(), state.f_lm.long()
    fq, ft, fl = state.pose_q[fp], state.pose_t[fp], state.lm[fl_i]
    if cfg.with_rotations:
        return _meas_pose(fq, ft, fl, state.lm_q[fl_i], state.f_tcl,
                          state.f_qcl, state.f_sig, cfg.meas_sigma_rot)
    return _meas_point(fq, ft, fl, state.f_tcl, state.f_sig)


def _meas_terms(cfg: GraphConfig, state: GraphState, pose_free
                ) -> MeasTerms:
    """Linearize the measurement factors carried by `state` into summed
    normal-equation contributions."""
    tcap, lcap, ld = cfg.max_poses, cfg.max_landmarks, cfg.lm_dim
    fp, fl = state.f_pose.long(), state.f_lm.long()
    r_m, jp_m, jl_m = _huber(cfg, *_meas_linearize(cfg, state))
    valid = state.f_valid
    r_m = torch.where(valid[:, None], r_m, 0.0)
    jp_m = torch.where((valid & pose_free[fp])[:, None, None], jp_m, 0.0)
    jl_m = torch.where(valid[:, None, None], jl_m, 0.0)

    def zeros(*shape):
        # made from a factor tensor, so that under torch.func.vmap (the
        # sharded and fleet solves, parallel/sharded_ba.py) the buffer
        # carries the batch and the index-adds accumulate per problem
        return r_m.new_zeros(shape)

    w4 = _block_add(zeros(tcap, lcap, 6, ld), fp, fl, _outer(jp_m, jl_m))
    return MeasTerms(
        diag=zeros(tcap, 6, 6).index_add_(0, fp, _outer(jp_m, jp_m)),
        w4=w4.permute(0, 2, 1, 3),
        h_ll=zeros(lcap, ld, ld).index_add_(0, fl, _outer(jl_m, jl_m)),
        g_p=zeros(tcap, 6).index_add_(0, fp, _gradient(jp_m, r_m)),
        g_l=zeros(lcap, ld).index_add_(0, fl, _gradient(jl_m, r_m)),
        cost=torch.sum(r_m * r_m))


def pose_free_mask(cfg: GraphConfig, state: GraphState, free_from):
    idx = torch.arange(cfg.max_poses, device=state.pose_q.device)
    return (idx >= torch.clamp(torch.as_tensor(free_from), min=1)) \
        & (idx < state.num_poses)


def _pose_system(cfg: GraphConfig, state: GraphState, pose_free,
                 meas: MeasTerms):
    """Odometry factors and the measurement pose blocks -> the dense
    pose-pose system: (h_pp (T6, T6), g_p (T6,), cost of measurements
    and odometry). The odometry pairs are consecutive, so H_pp is block
    tridiagonal plus nothing: its blocks are written on the block
    diagonals of the (T, 6, T, 6) layout."""
    dt, dev = cfg.dtype, state.pose_q.device
    tcap = cfg.max_poses
    o_valid = torch.arange(1, tcap, device=dev) < state.num_poses
    r_o, ja_o, jb_o = _odom_linearize(cfg, state)
    r_o = torch.where(o_valid[:, None], r_o, 0.0)
    ja_o = torch.where((o_valid & pose_free[1:])[:, None, None], ja_o, 0.0)
    jb_o = torch.where((o_valid & pose_free[:-1])[:, None, None], jb_o, 0.0)
    cost = meas.cost + torch.sum(r_o * r_o)

    diag = meas.diag.clone()
    diag[1:] += _outer(ja_o, ja_o)
    diag[:-1] += _outer(jb_o, jb_o)
    # frozen poses: identity diagonal so the dense solve stays SPD
    eye6 = torch.eye(6, dtype=dt, device=dev)
    diag = diag + torch.where(~pose_free[:, None, None], eye6, 0.0)
    cross = _outer(ja_o, jb_o)                  # block (a, b) = (i+1, i)
    h4 = diag.new_zeros((tcap, 6, tcap, 6))  # batched under vmap
    h4.diagonal(0, 0, 2).copy_(diag.permute(1, 2, 0))
    h4.diagonal(-1, 0, 2).copy_(cross.permute(1, 2, 0))
    h4.diagonal(1, 0, 2).copy_(cross.permute(2, 1, 0))

    g_p = meas.g_p.clone()
    g_p[1:] += _gradient(ja_o, r_o)
    g_p[:-1] += _gradient(jb_o, r_o)
    return h4.reshape(tcap * 6, tcap * 6), g_p.reshape(tcap * 6), cost


def _landmark_system(cfg: GraphConfig, lm, lm_active, prior_h,
                     prior_mean, meas_h_ll, meas_g_l):
    """Landmark blocks and the marginalization priors (position block
    only), on the full landmark set or one shard of it: (h_ll (l, D, D),
    g_l (l, D), prior cost)."""
    ld = cfg.lm_dim
    eye = torch.eye(ld, dtype=cfg.dtype, device=lm.device)
    # inactive landmarks: identity so the block inverse is well defined
    h_ll = meas_h_ll + torch.where(lm_active[:, None, None], 0.0, 1.0) * eye
    h_ll[:, :3, :3] += prior_h
    prior_r = prior_mean - lm
    hp = torch.einsum("lij,lj->li", prior_h, prior_r)
    g_l = meas_g_l.clone()
    g_l[:, :3] += hp
    return h_ll, g_l, torch.sum(prior_r * hp)


def _linearize(cfg: GraphConfig, state: GraphState, free_from,
               meas: MeasTerms | None = None):
    """The dense Schur-ready normal equations. Poses before
    ``free_from``, the gauge pose 0 and padded poses are frozen.
    Returns (h_pp (T6, T6), w (T6, L·D), h_ll (L, D, D), g_p (T6,), g_l
    (L·D,), cost)."""
    tcap, lcap = cfg.max_poses, cfg.max_landmarks
    pose_free = pose_free_mask(cfg, state, free_from)
    if meas is None:
        meas = _meas_terms(cfg, state, pose_free)
    h_pp, g_p, cost = _pose_system(cfg, state, pose_free, meas)
    h_ll, g_l4, prior_cost = _landmark_system(
        cfg, state.lm, state.lm_active, state.prior_lm_h,
        state.prior_lm_mean, meas.h_ll, meas.g_l)
    w = meas.w4.reshape(tcap * 6, lcap * cfg.lm_dim)
    return h_pp, w, h_ll, g_p, g_l4.reshape(lcap * cfg.lm_dim), \
        cost + prior_cost


def _schur_reduce(h_ll, w3, g_l3, damping):
    """Per-landmark(-shard) half of the Schur complement, every output a
    plain sum over landmarks. h_ll (l, D, D), w3 (T6, l, D), g_l3 (l,
    D). Returns (h_ll_inv, w_hinv, s_meas (T6, T6), g_s_meas (T6,))."""
    n = w3.shape[0]
    eye = torch.eye(h_ll.shape[-1], dtype=w3.dtype, device=w3.device)
    h_ll_inv, info = torch.linalg.inv_ex(h_ll + damping * eye)
    h_ll_inv = _nan_unless((info == 0)[:, None, None], h_ll_inv)
    w_hinv = torch.einsum("nlk,lkm->nlm", w3, h_ll_inv)
    s_meas = w_hinv.reshape(n, -1) @ w3.reshape(n, -1).T
    g_s_meas = w_hinv.reshape(n, -1) @ g_l3.reshape(-1)
    return h_ll_inv, w_hinv, s_meas, g_s_meas


def _cho_solve(a, b):
    """a⁻¹ b by Cholesky (NaN where a is not positive definite)."""
    chol, info = torch.linalg.cholesky_ex(a)
    return _nan_unless(info == 0, torch.cholesky_solve(b, chol))


def _schur_pose_solve(h_pp, g_p, s_meas, g_s_meas, damping):
    """Solve the reduced camera system S dp = g_s."""
    s = h_pp - s_meas
    s = s + damping * torch.eye(s.shape[0], dtype=s.dtype, device=s.device)
    return _cho_solve(s, (g_p - g_s_meas)[:, None])[:, 0]


def _schur_back_substitute(h_ll_inv, w3, g_l3, dp):
    """dl = H_ll⁻¹ (g_l − Wᵀ dp), per landmark(-shard)."""
    rhs_l = g_l3 - torch.einsum("nlm,n->lm", w3, dp)
    return torch.einsum("lkm,lm->lk", h_ll_inv, rhs_l)


def _schur_solve(cfg: GraphConfig, h_pp, w, h_ll, g_p, g_l, damping):
    """Schur-eliminate landmarks, solve the reduced camera system."""
    lcap = cfg.max_landmarks
    w3 = w.reshape(-1, lcap, cfg.lm_dim)
    g_l3 = g_l.reshape(lcap, cfg.lm_dim)
    h_ll_inv, _, s_meas, g_s_meas = _schur_reduce(h_ll, w3, g_l3, damping)
    dp = _schur_pose_solve(h_pp, g_p, s_meas, g_s_meas, damping)
    dl = _schur_back_substitute(h_ll_inv, w3, g_l3, dp)
    return dp.reshape(-1, 6), dl


def _retract(state: GraphState, dp, dl, free_from):
    """dl: (L, 3) point or (L, 6) [δl, δθ] landmark updates."""
    idx = torch.arange(state.pose_q.shape[0], device=dp.device)
    pose_free = (idx >= torch.clamp(torch.as_tensor(free_from), min=1)) \
        & (idx < state.num_poses)
    dp = torch.where(pose_free[:, None], dp, 0.0)
    pose_q = quat.normalize(
        quat.multiply(state.pose_q, quat.from_rotvec(dp[:, :3])))
    pose_t = state.pose_t + dp[:, 3:]
    dl = torch.where(state.lm_active[:, None], dl, 0.0)
    lm_q = state.lm_q
    if dl.shape[-1] == 6:
        lm_q = quat.normalize(quat.multiply(lm_q, quat.from_rotvec(dl[:, 3:])))
    return state._replace(pose_q=pose_q, pose_t=pose_t,
                          lm=state.lm + dl[:, :3], lm_q=lm_q)


def _shard_cost(cfg: GraphConfig, state: GraphState) -> torch.Tensor:
    """Whitened squared error of the measurements and the landmark priors:
    a sum over factors and landmarks, so shards of them add up."""
    fp, fl_i = state.f_pose.long(), state.f_lm.long()
    fq, ft, fl = state.pose_q[fp], state.pose_t[fp], state.lm[fl_i]
    if cfg.with_rotations:
        r_m = _meas_residual_rot(fq, ft, fl, state.lm_q[fl_i], state.f_tcl,
                                 state.f_qcl, state.f_sig, cfg.meas_sigma_rot)
    else:
        r_m = _meas_residual(fq, ft, fl, state.f_tcl, state.f_sig)
    r_m, = _huber(cfg, r_m)
    r_m = torch.where(state.f_valid[:, None], r_m, 0.0)
    pr = state.lm - state.prior_lm_mean
    prior_cost = torch.sum(pr * torch.einsum("lij,lj->li",
                                             state.prior_lm_h, pr))
    return torch.sum(r_m * r_m) + prior_cost


def _odom_cost(cfg: GraphConfig, state: GraphState) -> torch.Tensor:
    """Whitened squared error of the odometry factors (poses only)."""
    r_o = _odom_residual(state.pose_q[1:], state.pose_t[1:],
                         state.pose_q[:-1], state.pose_t[:-1],
                         cfg.odom_sigma_rot, cfg.odom_sigma_t)
    live = torch.arange(1, cfg.max_poses,
                        device=state.pose_q.device) < state.num_poses
    r_o = torch.where(live[:, None], r_o, 0.0)
    return torch.sum(r_o * r_o)


def _cost_only(cfg: GraphConfig, state: GraphState) -> torch.Tensor:
    """Total whitened squared error at the current estimate."""
    return _shard_cost(cfg, state) + _odom_cost(cfg, state)


def _optimize(cfg: GraphConfig, state: GraphState, iters: int, free_from
              ) -> tuple[GraphState, torch.Tensor]:
    """Levenberg-Marquardt: `iters` trial steps with adaptive damping,
    each accepted only if the true cost decreases. The accept/reject is
    chosen on the device: the loop reads nothing back."""
    with _full_f32():
        cost = _cost_only(cfg, state)
        lam = torch.full((), cfg.lm_init_lambda, dtype=cfg.dtype,
                         device=state.pose_q.device)
        for _ in range(iters):
            h_pp, w, h_ll, g_p, g_l, _ = _linearize(cfg, state, free_from)
            dp, dl = _schur_solve(cfg, h_pp, w, h_ll, g_p, g_l, lam)
            trial = _retract(state, dp, dl, free_from)
            state, cost, lam = _lm_accept(cfg, trial, state,
                                          _cost_only(cfg, trial), cost, lam)
    return state, cost


def _lm_accept(cfg: GraphConfig, trial: GraphState, state: GraphState,
               new_cost, cost, lam):
    """The LM accept/reject and damping update, chosen on the device:
    (the trial's estimates where its cost fell, else the state's; the
    lower cost; lambda divided by lm_factor on accept, multiplied on
    reject, within [1e-9, 1e6]). ``cost`` may carry a leading problem
    axis, which the estimates share."""
    accept = new_cost < cost

    def pick(a, b):
        return torch.where(
            accept.view(*accept.shape, *[1] * (a.dim() - accept.dim())),
            a, b)

    state = state._replace(**{k: pick(getattr(trial, k), getattr(state, k))
                              for k in _ESTIMATES})
    lam = torch.clamp(torch.where(accept, lam / cfg.lm_factor,
                                  lam * cfg.lm_factor), 1e-9, 1e6)
    return state, torch.where(accept, new_cost, cost), lam


def optimize_window(cfg: GraphConfig, state: GraphState,
                    window: int = 8, iters: int = 3
                    ) -> tuple[GraphState, torch.Tensor]:
    """Incremental smoothing: re-linearized LM over the trailing `window`
    poses (earlier poses frozen) and all landmarks."""
    free_from = torch.clamp(state.num_poses - window, min=1)
    return _optimize(cfg, state, iters, free_from)


def batch_optimize(cfg: GraphConfig, state: GraphState,
                   iters: int = 50) -> tuple[GraphState, torch.Tensor]:
    """Full-batch LM over every pose."""
    free_from = torch.ones((), dtype=torch.int32, device=state.pose_q.device)
    return _optimize(cfg, state, iters, free_from)


def marginalize_poses(cfg: GraphConfig, state: GraphState,
                      n_drop: int) -> GraphState:
    """Drop the oldest `n_drop` poses, absorbing their information into
    per-landmark Gaussian priors (bounded-memory online mode).

    The dropped subsystem (every factor touching a pose < n_drop) is
    linearized at the current estimate and its poses Schur-eliminated
    jointly; of the fill-in the landmark block diagonal is kept. Pose
    0's Jacobians are dropped (it is the frozen gauge)."""
    dt, dev = cfg.dtype, state.pose_q.device
    tcap, lcap, fcap = cfg.max_poses, cfg.max_landmarks, cfg.max_factors
    d6 = n_drop * 6
    f_pose, f_lm = state.f_pose.long(), state.f_lm.long()

    def zeros(*shape):
        return torch.zeros(shape, dtype=dt, device=dev)

    dropped = state.f_valid & (f_pose < n_drop)
    r_m, jp_m, jl_m = _huber(cfg, *_meas_point(
        state.pose_q[f_pose], state.pose_t[f_pose], state.lm[f_lm],
        state.f_tcl, state.f_sig))
    r_m = torch.where(dropped[:, None], r_m, 0.0)
    jp_m = torch.where((dropped & (f_pose > 0))[:, None, None], jp_m, 0.0)
    jl_m = torch.where(dropped[:, None, None], jl_m, 0.0)

    # dropped-pose system H_dd, clamped block indices
    fp = torch.clamp(f_pose, max=n_drop - 1)
    h_dd4 = zeros(n_drop, n_drop, 6, 6)
    _block_add(h_dd4, fp, fp, _outer(jp_m, jp_m))
    g_d = zeros(n_drop, 6).index_add_(0, fp, _gradient(jp_m, r_m))

    # odometry among dropped poses (a = i, b = i-1, a < n_drop) and the
    # boundary pair a = n_drop (kept, fixed): only its J_b enters
    idx_a = torch.arange(1, tcap, device=dev)
    idx_b = idx_a - 1
    r_o, ja_o, jb_o = _odom_linearize(cfg, state)
    o_drop = (idx_a < state.num_poses) & (idx_a <= n_drop)
    r_o = torch.where(o_drop[:, None], r_o, 0.0)
    ja_o = torch.where((o_drop & (idx_a < n_drop))[:, None, None], ja_o, 0.0)
    jb_o = torch.where((o_drop & (idx_b > 0))[:, None, None], jb_o, 0.0)
    oa = torch.clamp(idx_a, max=n_drop - 1)
    ob = torch.clamp(idx_b, max=n_drop - 1)
    _block_add(h_dd4, oa, oa, _outer(ja_o, ja_o))
    _block_add(h_dd4, ob, ob, _outer(jb_o, jb_o))
    cross = _outer(ja_o, jb_o)
    _block_add(h_dd4, oa, ob, cross)
    _block_add(h_dd4, ob, oa, cross.transpose(-1, -2))
    g_d.index_add_(0, oa, _gradient(ja_o, r_o))
    g_d.index_add_(0, ob, _gradient(jb_o, r_o))
    h_dd = h_dd4.permute(0, 2, 1, 3).reshape(d6, d6) \
        + 1e-6 * torch.eye(d6, dtype=dt, device=dev)

    # coupling W (6D, L, 3) and the dropped factors' landmark blocks
    w_d = _block_add(zeros(n_drop, lcap, 6, 3), fp, f_lm,
                     _outer(jp_m, jl_m)).permute(0, 2, 1, 3).reshape(
                         d6, lcap, 3)
    h_ll_f = zeros(lcap, 3, 3).index_add_(0, f_lm, _outer(jl_m, jl_m))
    g_lf = zeros(lcap, 3).index_add_(0, f_lm, _gradient(jl_m, r_m))

    # Schur: Λ_add[j] = H_j − W_jᵀ H_dd⁻¹ W_j ; g'_j = g_j − W_jᵀ H_dd⁻¹ g_d
    hinv = _cho_solve(h_dd, torch.cat(
        [w_d.reshape(d6, lcap * 3), g_d.reshape(d6, 1)], dim=1))
    hinv_w = hinv[:, :-1].reshape(d6, lcap, 3)
    lam_add = h_ll_f - torch.einsum("nlj,nlk->ljk", w_d, hinv_w)
    lam_add = 0.5 * (lam_add + lam_add.transpose(-1, -2))
    g_sch = g_lf - torch.einsum("nlj,n->lj", w_d, hinv[:, -1])

    # fold into the existing prior (information-weighted mean, no solve
    # against the possibly singular Λ_add)
    eye3 = torch.eye(3, dtype=dt, device=dev)
    lam_new = state.prior_lm_h + lam_add
    num = torch.einsum("lij,lj->li", state.prior_lm_h, state.prior_lm_mean) \
        + torch.einsum("lij,lj->li", lam_add, state.lm) + g_sch
    m_new, info = torch.linalg.solve_ex(lam_new + 1e-8 * eye3, num[..., None])
    m_new = _nan_unless((info == 0)[:, None], m_new[..., 0])
    touched = torch.zeros(lcap + 1, dtype=torch.bool, device=dev).index_fill_(
        0, torch.where(dropped, f_lm, lcap), True)[:lcap]
    prior_lm_h = torch.where(touched[:, None, None], lam_new,
                             state.prior_lm_h)
    prior_lm_mean = torch.where(touched[:, None], m_new, state.prior_lm_mean)

    # compact: drop the absorbed factors, shift pose indices down
    keep = state.f_valid & (f_pose >= n_drop)
    dest = torch.where(keep, torch.cumsum(keep, 0) - 1, fcap)

    def compact(arr, fill=0):
        out = torch.full((fcap + 1,) + arr.shape[1:], fill, dtype=arr.dtype,
                         device=dev)
        return out.index_copy_(0, dest, arr)[:-1]

    valid_c = compact(state.f_valid)
    # invalid slots: identity quaternion, and a nonzero sigma (residuals
    # divide by it before the validity mask zeroes them)
    f_qcl = compact(state.f_qcl)
    f_qcl[:, 0] += 1.0 - valid_c.to(dt)
    return state._replace(
        pose_q=torch.roll(state.pose_q, -n_drop, 0),
        pose_t=torch.roll(state.pose_t, -n_drop, 0),
        num_poses=torch.clamp(state.num_poses - n_drop, min=1),
        f_pose=torch.clamp(compact(state.f_pose) - n_drop, min=0),
        f_lm=compact(state.f_lm), f_tcl=compact(state.f_tcl), f_qcl=f_qcl,
        f_sig=compact(state.f_sig, fill=cfg.meas_sigma_t), f_valid=valid_c,
        f_count=keep.sum(dtype=torch.int32),
        prior_lm_h=prior_lm_h, prior_lm_mean=prior_lm_mean)


def landmark_covariances(cfg: GraphConfig, state: GraphState
                         ) -> torch.Tensor:
    """Marginal covariance blocks (L, D, D) of the landmarks:
    Cov_ll = H_ll⁻¹ + H_ll⁻¹ Wᵀ S⁻¹ W H_ll⁻¹ (block-diagonal part)."""
    with _full_f32():
        free_from = torch.ones((), dtype=torch.int32,
                               device=state.pose_q.device)
        h_pp, w, h_ll, _, _, _ = _linearize(cfg, state, free_from)
        eps = 1e-6
        eye = torch.eye(cfg.lm_dim, dtype=cfg.dtype, device=w.device)
        h_ll_inv, info = torch.linalg.inv_ex(h_ll + eps * eye)
        h_ll_inv = _nan_unless((info == 0)[:, None, None], h_ll_inv)
        w3 = w.reshape(-1, cfg.max_landmarks, cfg.lm_dim)
        n = w3.shape[0]
        m = torch.einsum("nlk,lkm->nlm", w3, h_ll_inv)      # W H_ll⁻¹
        s = h_pp - m.reshape(n, -1) @ w3.reshape(n, -1).T
        s = s + eps * torch.eye(n, dtype=s.dtype, device=s.device)
        y = _cho_solve(s, m.reshape(n, -1)).reshape(m.shape)
        return h_ll_inv + torch.einsum("nlk,nlm->lkm", m, y)
