"""Fused MEKF measurement update: the CUDA kernel and its plain version.

Counterpart of aruco_slam_tpu/filters/pallas_mekf.py `fused_update`:
PHᵀ; S = HPHᵀ + diag(r); S⁻¹ by Newton–Schulz; K = PHᵀS⁻¹;
inn = K·resid; P' = sym((I−KH)P(I−KH)ᵀ + K diag(r) Kᵀ). The kernel is
``csrc/mekf_update.cu`` (every product in the repo's own tiled GEMM,
no cuBLAS); `fused_update_plain` is the same chain in PyTorch matmuls
at full f32 and is what a CPU tensor runs.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch import _build


def fused_update_plain(cov: torch.Tensor, h: torch.Tensor,
                       r_diag: torch.Tensor, resid: torch.Tensor,
                       ns_iters: int = 20):
    """Returns (innovation (N,), new_cov (N, N)), f32."""
    m = h.shape[0]
    n = h.shape[1]
    ph_t = cov @ h.T                                   # (N, M)
    eye_m = torch.eye(m, dtype=cov.dtype, device=cov.device)
    s = h @ ph_t + eye_m * r_diag[None, :]
    norm1 = torch.max(torch.sum(torch.abs(s), dim=0))
    x = s / (norm1 * norm1)
    for _ in range(ns_iters):
        x = x @ (2.0 * eye_m - s @ x)
    gain = ph_t @ x                                    # (N, M)
    inn = (gain @ resid[:, None])[:, 0]
    eye_n = torch.eye(n, dtype=cov.dtype, device=cov.device)
    i_kh = eye_n - gain @ h
    joseph = (i_kh @ cov) @ i_kh.T
    krk = (gain * r_diag[None, :]) @ gain.T
    new_cov = joseph + krk
    return inn, 0.5 * (new_cov + new_cov.T)


def fused_update(cov: torch.Tensor, h: torch.Tensor, r_diag: torch.Tensor,
                 resid: torch.Tensor, ns_iters: int = 20):
    """Fused gain/innovation/Joseph update, f32. Returns (innovation
    (N,), new_cov (N, N)). A CUDA tensor launches
    ``csrc/mekf_update.cu``; a CPU tensor runs `fused_update_plain`."""
    n = cov.shape[0]
    m = h.shape[0]
    if cov.shape != (n, n) or h.shape != (m, n) or r_diag.shape != (m,) \
            or resid.shape != (m,):
        raise ValueError(f"fused_update: cov {tuple(cov.shape)}, h "
                         f"{tuple(h.shape)}, r {tuple(r_diag.shape)}, "
                         f"resid {tuple(resid.shape)}")
    if cov.device.type == "cpu":
        return fused_update_plain(cov, h, r_diag, resid, ns_iters)
    return _launch(cov, h, r_diag, resid, ns_iters)


fused_update.launches = 0


def _launch(cov, h, r_diag, resid, ns_iters):
    args = [t.contiguous() for t in (cov, h, r_diag, resid)]
    for name, t, nd in zip(("cov", "h", "r_diag", "resid"), args,
                           (2, 2, 1, 1)):
        _build.check_cuda(name, t, torch.float32, nd)
        if t.device != cov.device:
            raise ValueError(f"fused_update: {name} on {t.device}, cov on "
                             f"{cov.device}")
    cov, h, r_diag, resid = args
    n = cov.shape[0]
    m = h.shape[0]
    size = _build.function("mekf_update_scratch_floats",
                           [ctypes.c_int, ctypes.c_int])
    size.restype = ctypes.c_longlong
    scratch = torch.empty(size(n, m), dtype=torch.float32,
                          device=cov.device)
    inn = torch.empty(n, dtype=torch.float32, device=cov.device)
    new_cov = torch.empty_like(cov)
    fn = _build.function("mekf_fused_update", [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int, ctypes.c_int, ctypes.c_int,
        ctypes.c_void_p])
    _build.call(fn, _build.ptr(cov), _build.ptr(h), _build.ptr(r_diag),
                _build.ptr(resid), _build.ptr(inn), _build.ptr(new_cov),
                _build.ptr(scratch), n, m, ns_iters, _build.stream())
    fused_update.launches += 1
    return inn, new_cov
