"""The MEKF's fused update, plain PyTorch: the benchmark's frozen copy of
`fused_update_plain` in aruco_slam_tpu_torch/filters/cuda_mekf.py
(Newton–Schulz gain, innovation, Joseph form), which the card's kernel
B3 (csrc/mekf_update.cu) matches to float reassociation noise.
"""

from __future__ import annotations

import torch


def fused_update_plain(cov: torch.Tensor, h: torch.Tensor,
                       r_diag: torch.Tensor, resid: torch.Tensor,
                       ns_iters: int = 20):
    """Returns (innovation (..., N), new_cov (..., N, N)), f32; a leading
    stream axis batches every matmul."""
    m = h.shape[-2]
    n = h.shape[-1]
    ph_t = cov @ h.transpose(-1, -2)                   # (..., N, M)
    eye_m = torch.eye(m, dtype=cov.dtype, device=cov.device)
    s = h @ ph_t + eye_m * r_diag[..., None, :]
    norm1 = torch.amax(torch.sum(torch.abs(s), dim=-2), dim=-1)
    x = s / (norm1 * norm1)[..., None, None]
    for _ in range(ns_iters):
        x = x @ (2.0 * eye_m - s @ x)
    gain = ph_t @ x                                    # (..., N, M)
    inn = (gain @ resid[..., None])[..., 0]
    eye_n = torch.eye(n, dtype=cov.dtype, device=cov.device)
    i_kh = eye_n - gain @ h
    joseph = (i_kh @ cov) @ i_kh.transpose(-1, -2)
    krk = (gain * r_diag[..., None, :]) @ gain.transpose(-1, -2)
    new_cov = joseph + krk
    return inn, 0.5 * (new_cov + new_cov.transpose(-1, -2))


fused_update = fused_update_plain
