"""Landmark-sharded Schur-complement bundle adjustment on torch.distributed.

Counterpart of aruco_slam_tpu/parallel/sharded_ba.py, built on the same
fact of marker SLAM: every measurement factor touches exactly one
landmark. Partitioning the factors by the shard of the landmark they
observe makes the whole landmark side of the normal equations local to a
shard: H_ll, the coupling columns of W and g_l are assembled exactly on
the shard, and an LM iteration needs three pose-sized sums over a
problem's shards, each one `all_reduce` where JAX has a psum:

* the measurement pose blocks, gradient and cost (T·36 + T·6 + 1
  values);
* the partial Schur complement Σ W H_ll⁻¹ Wᵀ and its gradient (T6² + T6);
* the trial's measurement-and-prior cost (1).

The reduced camera system is solved on every process from the same
summed values, so the poses stay bit-equal everywhere and every process
takes the same accept/reject; the landmark back-substitution is local
again. Everything else is `graph/ba.py`'s functions on a shard.

A process runs the mesh devices it holds (parallel/dist.py) on its one
device as a batch, through `torch.func.vmap`: its problems (the data
axis, JAX's vmap over a fleet) and, within each, its landmark shards,
whose pose-side sums are added on the device before the all_reduce. The
LM's accept/reject is a `torch.where` on device values: the loop reads
nothing back. The result equals `graph.batch_optimize` up to float
reduction order (tests/test_torch_dist.py: f64, atol 1e-7).
"""

from __future__ import annotations

import numpy as np
import torch
from torch.func import vmap

from aruco_slam_tpu_torch.graph import ba
from aruco_slam_tpu_torch.graph.ba import GraphConfig, GraphState
from aruco_slam_tpu_torch.parallel import dist as pdist

# fields every shard of a problem shares (replicated); the rest shard
# with the landmarks and factors
_PROBLEM = ("pose_q", "pose_t", "num_poses", "f_count")
# vmap in_dims of a shard view over its shard axis
_PER_SHARD = GraphState(**{k: None if k in _PROBLEM else 0
                           for k in GraphState._fields})


def _np(x) -> np.ndarray:
    return x.detach().cpu().numpy()


def _shard_assignment(cfg: GraphConfig, state: GraphState, n: int):
    """(shard id per factor (-1 = invalid), landmarks per shard): host
    values shared by capacity sizing and repartitioning."""
    lcap2 = -(-cfg.max_landmarks // n) * n
    lm_per = lcap2 // n
    return np.where(_np(state.f_valid), _np(state.f_lm) // lm_per,
                    -1), lm_per


def _shard_capacity(cfg: GraphConfig, state: GraphState, n: int,
                    shard=None) -> int:
    """Most factors any landmark shard holds, lane-aligned to 8."""
    if shard is None:
        shard, _ = _shard_assignment(cfg, state, n)
    counts = np.bincount(shard[shard >= 0], minlength=n)[:n]
    return max(-(-int(counts.max()) // 8) * 8, 8)


def partition_by_landmark(cfg: GraphConfig, state: GraphState, n: int,
                          f_shard: int | None = None
                          ) -> tuple[GraphConfig, GraphState]:
    """Host repartition, the JAX package's layout exactly: landmark
    capacity padded to a multiple of ``n`` (shard s owns landmarks
    [s·L/n, (s+1)·L/n), order not permuted); the factors observing shard
    s packed into [s·F̂, s·F̂ + count_s) with ``f_lm`` made shard-local,
    F̂ the largest shard's count lane-aligned to 8; the rest invalid
    padding (identity quaternion, sigma meas_sigma_t). Returns the
    repartitioned config and state, on the state's device."""
    lcap = cfg.max_landmarks
    lcap2 = -(-lcap // n) * n
    dev = state.pose_q.device
    f_lm = _np(state.f_lm)
    shard, lm_per = _shard_assignment(cfg, state, n)
    if f_shard is None:
        f_shard = _shard_capacity(cfg, state, n, shard=shard)
    f2 = f_shard * n

    dest = np.full(f_lm.shape[0], -1, np.int64)
    for s in range(n):
        idx = np.nonzero(shard == s)[0]
        dest[idx] = s * f_shard + np.arange(idx.shape[0])
    src = np.nonzero(dest >= 0)[0]
    d = dest[src]

    def scatter(a, fill=0):
        a = a if isinstance(a, np.ndarray) else _np(a)
        out = np.full((f2,) + a.shape[1:], fill, a.dtype)
        out[d] = a[src]
        return torch.from_numpy(out).to(dev)

    def pad_lm(arr, fill=0):
        a = _np(arr)
        out = np.full((lcap2,) + a.shape[1:], fill, a.dtype)
        out[:lcap] = a
        return torch.from_numpy(out).to(dev)

    unit = np.array([1.0, 0.0, 0.0, 0.0])   # identity quaternion (wxyz)
    cfg2 = cfg._replace(max_factors=f2, max_landmarks=lcap2)
    state2 = state._replace(
        lm=pad_lm(state.lm), lm_q=pad_lm(state.lm_q, fill=unit),
        lm_active=pad_lm(state.lm_active),
        f_pose=scatter(state.f_pose),
        f_lm=scatter((f_lm - np.maximum(shard, 0) * lm_per)
                     .astype(np.int32)),
        f_tcl=scatter(state.f_tcl), f_qcl=scatter(state.f_qcl, fill=unit),
        f_sig=scatter(state.f_sig, fill=float(cfg.meas_sigma_t)),
        f_valid=scatter(state.f_valid),
        prior_lm_h=pad_lm(state.prior_lm_h),
        prior_lm_mean=pad_lm(state.prior_lm_mean))
    return cfg2, state2


def stack_graphs(states: list[GraphState]) -> GraphState:
    """Stack same-capacity problems along a new leading fleet axis."""
    return GraphState(*(torch.stack(xs) for xs in zip(*states)))


def _lm_iterations(cfg: GraphConfig, lcfg: GraphConfig, group,
                   st: GraphState, free_from, iters: int):
    """The LM loop over a process's view of its problems: problem fields
    (B, ...), shard fields (B, S, ...) of S landmark shards at ``lcfg``'s
    capacities (ba's functions are written per shard, so they apply to
    one as they are). ``group`` sums over the processes sharing the
    problems' kf row (None: all their shards are here). Returns (st, cost
    (B,))."""
    def per_shard(fn, dims):
        return vmap(vmap(fn, in_dims=dims), in_dims=0)

    shard_cost = per_shard(lambda s: ba._shard_cost(lcfg, s), (_PER_SHARD,))
    odom_cost = vmap(lambda s: ba._odom_cost(cfg, s))
    pose_free = vmap(lambda s: ba.pose_free_mask(cfg, s, free_from))
    meas_terms = per_shard(lambda s, pf: ba._meas_terms(lcfg, s, pf),
                           (_PER_SHARD, None))

    def pose_fn(s, pf, diag, g_p, cost):
        meas = ba.MeasTerms(diag, None, None, g_p, None, cost)
        return ba._pose_system(cfg, s, pf, meas)[:2]

    def reduce_fn(s, h_ll, g_l, w4, lam):
        h_ll, g_l3, _ = ba._landmark_system(
            lcfg, s.lm, s.lm_active, s.prior_lm_h, s.prior_lm_mean, h_ll,
            g_l)
        w3 = w4.reshape(cfg.max_poses * 6, -1, lcfg.lm_dim)
        h_ll_inv, _, s_part, g_s_part = ba._schur_reduce(h_ll, w3, g_l3, lam)
        return h_ll_inv, w3, g_l3, s_part, g_s_part

    def retract_fn(s, h_ll_inv, w3, g_l3, dp):
        dl = ba._schur_back_substitute(h_ll_inv, w3, g_l3, dp)
        return ba._retract(s, dp.reshape(-1, 6), dl, free_from)

    pose_system = vmap(pose_fn)
    schur_reduce = per_shard(reduce_fn, (_PER_SHARD, 0, 0, 0, None))
    pose_solve = vmap(ba._schur_pose_solve)
    retract = per_shard(retract_fn, (_PER_SHARD, 0, 0, 0, None))

    def cost_of(s):
        part, = pdist.all_reduce_sum([shard_cost(s).sum(1)], group)
        return part + odom_cost(s)

    cost = cost_of(st)
    lam = torch.full_like(cost, cfg.lm_init_lambda)
    for _ in range(iters):
        free = pose_free(st)
        meas = meas_terms(st, free)
        # the pose-side partial sums, this process's shards added first
        diag, g_p, mcost = pdist.all_reduce_sum(
            [meas.diag.sum(1), meas.g_p.sum(1), meas.cost.sum(1)], group)
        h_pp, g_p6 = pose_system(st, free, diag, g_p, mcost)
        h_ll_inv, w3, g_l3, s_part, g_s_part = schur_reduce(
            st, meas.h_ll, meas.g_l, meas.w4, lam)
        s_meas, g_s_meas = pdist.all_reduce_sum(
            [s_part.sum(1), g_s_part.sum(1)], group)
        dp = pose_solve(h_pp, g_p6, s_meas, g_s_meas, lam)
        trial = retract(st, h_ll_inv, w3, g_l3, dp)
        # the poses came out of the shard vmap broadcast over the shards
        trial = st._replace(pose_q=trial.pose_q[:, 0],
                            pose_t=trial.pose_t[:, 0], lm=trial.lm,
                            lm_q=trial.lm_q)
        st, cost, lam = ba._lm_accept(cfg, trial, st, cost_of(trial), cost,
                                      lam)
    return st, cost


def _shard_view(st: GraphState, n: int, k0: int, s: int) -> GraphState:
    """Stacked (B, ...) problems -> problem fields as they are, shard
    fields (B, n·x, ...) -> (B, s, x, ...): shards k0 .. k0+s-1."""
    def cut(k, v):
        if k in _PROBLEM:
            return v
        return v.reshape(v.shape[0], n, -1, *v.shape[2:])[:, k0:k0 + s]
    return GraphState(**{k: cut(k, v) for k, v in st._asdict().items()})


def _solve(cfg: GraphConfig, problems: list[GraphState], mesh, iters: int):
    """LM on every problem, landmark-sharded over the mesh's kf axis (its
    last), the problems split over its data axis: (pose_q, pose_t, lm,
    lm_q, cost), each stacked over the problems and readable on every
    process."""
    grid = mesh.devices.reshape(-1, mesh.devices.shape[-1])
    n_data, n_kf = grid.shape
    g = len(problems)
    rows, k0, s = mesh.layout()
    per_row = g // n_data
    mine = [p for d in rows for p in range(d * per_row, (d + 1) * per_row)]
    # one common per-shard factor capacity, so the problems stack
    f_shard = max(_shard_capacity(cfg, p, n_kf) for p in problems)
    lcap2 = -(-cfg.max_landmarks // n_kf) * n_kf
    cfg2 = cfg._replace(max_factors=f_shard * n_kf, max_landmarks=lcap2)
    lcfg = cfg2._replace(max_factors=f_shard, max_landmarks=lcap2 // n_kf)
    like = problems[0]
    pose_q = like.pose_q.new_zeros((g, *like.pose_q.shape))
    pose_t = like.pose_t.new_zeros((g, *like.pose_t.shape))
    lm = like.lm.new_zeros((g, lcap2, like.lm.shape[-1]))
    lm_q = like.lm_q.new_zeros((g, lcap2, like.lm_q.shape[-1]))
    cost = like.pose_q.new_zeros(g)
    if mine:
        view = _shard_view(stack_graphs([
            partition_by_landmark(cfg, problems[i], n_kf, f_shard)[1]
            for i in mine]), n_kf, k0, s)
        free_from = torch.ones((), dtype=torch.int32,
                               device=like.pose_q.device)
        with ba._full_f32():
            res, c = _lm_iterations(cfg2, lcfg, mesh.group, view, free_from,
                                    iters)
        idx = torch.tensor(mine, device=cost.device)
        if k0 == 0:     # the kf row's first process writes its poses
            pose_q[idx], pose_t[idx], cost[idx] = res.pose_q, res.pose_t, c
        span = slice(k0 * lcfg.max_landmarks, (k0 + s) * lcfg.max_landmarks)
        lm[idx, span] = res.lm.flatten(1, 2)
        lm_q[idx, span] = res.lm_q.flatten(1, 2)
    pose_q, pose_t, lm, lm_q, cost = pdist.replicate_to_hosts(
        (pose_q, pose_t, lm, lm_q, cost))
    lcap = cfg.max_landmarks
    return pose_q, pose_t, lm[:, :lcap], lm_q[:, :lcap], cost


def sharded_batch_optimize(cfg: GraphConfig, state: GraphState, mesh,
                           iters: int = 50
                           ) -> tuple[GraphState, torch.Tensor]:
    """Full-batch LM with the landmark blocks and factors sharded over a
    1-D mesh (`make_mesh`): the counterpart of `graph.batch_optimize`
    (same inputs, same outputs up to float reduction order). Every
    process passes the same state and gets the whole result back."""
    if mesh.axis_names != ("kf",):
        raise ValueError(f"sharded_batch_optimize shards over a 1-D mesh; "
                         f"got axes {mesh.axis_names} (fleets: "
                         "sharded_fleet_optimize)")
    pose_q, pose_t, lm, lm_q, cost = _solve(cfg, [state], mesh, iters)
    return state._replace(pose_q=pose_q[0], pose_t=pose_t[0], lm=lm[0],
                          lm_q=lm_q[0]), cost[0]


def sharded_fleet_optimize(cfg: GraphConfig, states: GraphState, mesh,
                           iters: int = 50
                           ) -> tuple[GraphState, torch.Tensor]:
    """Batch-LM a fleet of independent problems on a ('data', 'kf') mesh
    (`make_mesh2d`): ``states`` stacked on a leading fleet axis
    (`stack_graphs`), split over data (each process batches its
    problems), each problem's landmarks and factors sharded over kf.
    Returns (the fleet with every process's estimates, per-problem final
    costs)."""
    if mesh.axis_names != ("data", "kf"):
        raise ValueError(f"sharded_fleet_optimize runs on a ('data', 'kf') "
                         f"mesh; got axes {mesh.axis_names}")
    n_data = mesh.shape["data"]
    g = int(states.num_poses.shape[0])
    if g % n_data:
        raise ValueError(f"fleet size {g} not divisible by "
                         f"data axis {n_data}")
    problems = [GraphState(*(x[i] for x in states)) for i in range(g)]
    pose_q, pose_t, lm, lm_q, cost = _solve(cfg, problems, mesh, iters)
    return states._replace(pose_q=pose_q, pose_t=pose_t, lm=lm,
                           lm_q=lm_q), cost
