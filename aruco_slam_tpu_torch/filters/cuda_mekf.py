"""Fused MEKF measurement update: the CUDA kernel and its plain version.

Counterpart of aruco_slam_tpu/filters/pallas_mekf.py `fused_update`:
PHᵀ; S = HPHᵀ + diag(r); S⁻¹ by Newton–Schulz; K = PHᵀS⁻¹;
inn = K·resid; P' = sym((I−KH)P(I−KH)ᵀ + K diag(r) Kᵀ). The kernel is
``csrc/mekf_update.cu`` (Newton–Schulz in one thread-block cluster per
stream, every other product in the repo's own register-tiled GEMM, in
a 32x32 or a wide tiling by the launch's shape, no cuBLAS);
`fused_update_plain` is the same chain in PyTorch matmuls at full f32
and is what a CPU tensor runs.

Both take one filter, or S filters (streams) stacked along a leading
axis: the JAX fleet vmaps its whole filter, Pallas update included, and
here a frame of S streams is one launch sequence.
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch import _build


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


def fused_update(cov: torch.Tensor, h: torch.Tensor, r_diag: torch.Tensor,
                 resid: torch.Tensor, ns_iters: int = 20, out=None):
    """Fused gain/innovation/Joseph update, f32: cov (N, N), h (M, N),
    r_diag and resid (M,), or each with a leading stream axis (S, ...).
    Returns (innovation (..., N), new_cov (..., N, N)), written into
    ``out`` where given (two tensors of those shapes, apart from the
    inputs: a CUDA graph reads them at fixed addresses). A CUDA tensor
    launches ``csrc/mekf_update.cu`` once for all S streams; a CPU tensor
    runs `fused_update_plain`."""
    lead = cov.shape[:-2]
    n = cov.shape[-1]
    m = h.shape[-2]
    if len(lead) > 1 or cov.shape != (*lead, n, n) \
            or h.shape != (*lead, m, n) or r_diag.shape != (*lead, m) \
            or resid.shape != (*lead, m):
        raise ValueError(f"fused_update: cov {tuple(cov.shape)}, h "
                         f"{tuple(h.shape)}, r {tuple(r_diag.shape)}, "
                         f"resid {tuple(resid.shape)}")
    if cov.device.type == "cpu":
        res = fused_update_plain(cov, h, r_diag, resid, ns_iters)
        if out is None:
            return res
        for o, x in zip(out, res):
            o.copy_(x)
        return out
    res = _launch(cov, h, r_diag, resid, ns_iters, out=out)
    fused_update.launches += 1
    return res


fused_update.launches = 0


# The kernel's Newton–Schulz forms, in the order the C entry point tries
# them: "columns" and "rows" (one 8-CTA cluster per stream, column or
# row slabs, S, K and inn folded in; M <= 128 and M <= 256), "block"
# (one block per stream, any M). Each takes every M the ones before it
# take.
FORMS = ("columns", "rows", "block")


def newton_schulz_form(m: int) -> str:
    """The form the kernel runs for M observation rows: the first of
    FORMS that takes M (the later ones take it too). Builds the
    kernels."""
    fn = _build.function("mekf_update_form", [ctypes.c_int])
    return FORMS[fn(m) - 1]


def fused_update_form(cov, h, r_diag, resid, form: str,
                      ns_iters: int = 20):
    """`fused_update` on CUDA tensors with the Newton–Schulz form forced
    (one of FORMS that takes M), for timing and testing each form at
    shapes the kernel would run in another; not counted in
    ``fused_update.launches``."""
    return _launch(cov, h, r_diag, resid, ns_iters, FORMS.index(form) + 1)


# The kernel's GEMM tilings (csrc/mekf_update.cu `gemm_tiling`), one
# arithmetic, bit-identical outputs: "32x32" (32x32 output tiles, 2x2
# outputs a thread) and "wide" (128x64 tiles, 8x8 outputs a thread, a
# cp.async ring), which a launch takes where its outputs, over all its
# streams, fill half the card's SMs with a wide tile each.
TILINGS = ("32x32", "wide")


def gemm_tiling(m: int, n: int, streams: int = 1) -> str:
    """The tiling the kernel takes for a GEMM launch of m x n outputs on
    ``streams`` streams on the current card: ``gemm_tiling(n, n, s)``
    is that of B3's N x N products (I − KH, (I − KH)P, the Joseph sum),
    ``gemm_tiling(n, m, s)`` PHᵀ's. Builds the kernels; reads the
    card's SM count once, no launch."""
    fn = _build.function("mekf_update_gemm_tile", [ctypes.c_int] * 3)
    return TILINGS[fn(m, n, streams) - 1]


def fused_update_tiling(cov, h, r_diag, resid, tiling: str,
                        ns_iters: int = 20):
    """`fused_update` on CUDA tensors with every GEMM launch forced into
    one of TILINGS, for timing and testing each tiling at shapes the
    kernel would run in the other; not counted in
    ``fused_update.launches``."""
    return _launch(cov, h, r_diag, resid, ns_iters,
                   tiling=TILINGS.index(tiling) + 1)


def split_ms(cov, h, r_diag, resid, ns_iters: int = 20,
             tiling: str | None = None) -> dict:
    """CUDA-event milliseconds of each launch group of one kernel call on
    CUDA tensors (not counted in ``fused_update.launches``): "pht"
    PHᵀ; "gain" S, its Newton–Schulz inverse, K and the innovation;
    "joseph" I − KH and the symmetrized Joseph covariance. ``tiling``
    (one of TILINGS) forces every GEMM launch's."""
    forced = 0 if tiling is None else TILINGS.index(tiling) + 1
    return _build.split_ms(lambda marks, n_marks: _launch(
        cov, h, r_diag, resid, ns_iters, 0, forced, marks, n_marks),
        ["pht", "gain", "joseph"])


def _launch(cov, h, r_diag, resid, ns_iters, form=0, tiling=0, marks=None,
            n_marks=0, out=None):
    args = [t.contiguous() for t in (cov, h, r_diag, resid)]
    batched = cov.dim() == 3
    for name, t, nd in zip(("cov", "h", "r_diag", "resid"), args,
                           (2, 2, 1, 1)):
        _build.check_cuda(name, t, torch.float32, nd + batched)
    cov, h, r_diag, resid = args
    streams = cov.shape[0] if batched else 1
    n = cov.shape[-1]
    m = h.shape[-2]
    size = _build.function("mekf_update_scratch_floats",
                           [ctypes.c_int, ctypes.c_int], ctypes.c_longlong)
    scratch = torch.empty(streams * size(n, m), dtype=torch.float32,
                          device=cov.device)
    if out is None:
        inn = torch.empty(cov.shape[:-1], dtype=torch.float32,
                          device=cov.device)
        new_cov = torch.empty_like(cov)
    else:
        inn, new_cov = out
        for name, t, nd in (("inn", inn, 1), ("new_cov", new_cov, 2)):
            _build.check_cuda(name, t, torch.float32, nd + batched)
        if inn.shape != cov.shape[:-1] or new_cov.shape != cov.shape:
            raise ValueError(f"fused_update: out {tuple(inn.shape)}, "
                             f"{tuple(new_cov.shape)} for cov "
                             f"{tuple(cov.shape)}")
    fn = _build.function("mekf_fused_update_batched", [ctypes.c_void_p] * 7
                         + [ctypes.c_int] * 6 + [ctypes.c_void_p,
                                                 ctypes.c_int,
                                                 ctypes.c_void_p])
    with _build.on_device(cov, h, r_diag, resid, inn, new_cov,
                          scratch) as stream:
        _build.call(fn, _build.ptr(cov), _build.ptr(h), _build.ptr(r_diag),
                    _build.ptr(resid), _build.ptr(inn), _build.ptr(new_cov),
                    _build.ptr(scratch), streams, n, m, ns_iters, form,
                    tiling, marks, n_marks, stream)
    return inn, new_cov
