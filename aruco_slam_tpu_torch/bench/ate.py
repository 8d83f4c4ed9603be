"""Trajectory error (counterpart of aruco_slam_tpu/bench/ate.py): the
absolute error (Umeyama alignment, then the RMSE over translations) and
the relative one (translation drift over a frame delta)."""

from __future__ import annotations

import numpy as np


def umeyama_alignment(src: np.ndarray, dst: np.ndarray,
                      with_scale: bool = False):
    """Least-squares similarity transform: dst ≈ s R src + t."""
    mu_s = src.mean(axis=0)
    mu_d = dst.mean(axis=0)
    xs = src - mu_s
    xd = dst - mu_d
    cov = xd.T @ xs / len(src)
    u, d, vt = np.linalg.svd(cov)
    ss = np.ones(3)
    ss[-1] = np.sign(np.linalg.det(u @ vt))
    r = u @ np.diag(ss) @ vt
    s = float((d * ss).sum() / ((xs ** 2).sum() / len(src))) \
        if with_scale else 1.0
    return s, r, mu_d - s * r @ mu_s


def ate_rmse(est_t: np.ndarray, gt_t: np.ndarray,
             with_scale: bool = False) -> float:
    """Absolute trajectory error (RMSE, meters) after alignment."""
    s, r, t = umeyama_alignment(est_t, gt_t, with_scale)
    aligned = (s * (r @ est_t.T)).T + t
    return float(np.sqrt(((aligned - gt_t) ** 2).sum(axis=-1).mean()))


def rpe_rmse(est_t: np.ndarray, gt_t: np.ndarray, delta: int = 1) -> float:
    """Relative pose (translation drift) error over a frame delta."""
    de = est_t[delta:] - est_t[:-delta]
    dg = gt_t[delta:] - gt_t[:-delta]
    return float(np.sqrt(((de - dg) ** 2).sum(axis=-1).mean()))
