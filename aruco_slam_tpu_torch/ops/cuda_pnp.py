"""IPPE-square PnP as one CUDA kernel (``csrc/pnp_square.cu``).

`solve` computes what ops/pnp.py `solve_square_pnp_plain` computes for
distorted pixel corners (..., 4, 2) on a CUDA float32 tensor, in one
launch, a thread a marker: undistortion, the closed-form homography,
both IPPE rotations and translations, both Gauss-Newton chains, the
choice and the quaternion and rotation vector of the chosen rotation.
`pnp.solve_square_pnp` calls it for any CUDA tensor and runs the plain
version for a CPU tensor. The camera is packed on
its device by one concatenation, so nothing is read back: the call
never waits on the card. On the card the kernel equals the plain
version bit for bit: it rounds where the eager chain's kernels round
(the source's note says how).
"""

from __future__ import annotations

import ctypes

import torch

from aruco_slam_tpu_torch import _build

# a block: the same device time at 32 to 128 for a chunk (2,048 markers)
# or a corners request (8,192), and 128 the fastest of them at 262,144
THREADS = 128

_ARGTYPES = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_float,
             ctypes.c_int, ctypes.c_int, ctypes.c_int,
             *[ctypes.c_void_p] * 5, ctypes.c_void_p]


def pack_camera(cam, device: torch.device) -> torch.Tensor:
    """(9,) float32 [fx, fy, cx, cy, k1, k2, p1, p2, k3] on ``device``,
    concatenated where the camera lies (one launch on a card)."""
    return torch.cat([cam.fx.reshape(1), cam.fy.reshape(1),
                      cam.cx.reshape(1), cam.cy.reshape(1),
                      cam.dist.reshape(5)]).to(device=device,
                                               dtype=torch.float32)


def solve(cam, corners_px: torch.Tensor, marker_size,
          refine_iters: int = 8):
    """(t_cl (..., 3), q_cl (..., 4), rvec (..., 3), err (...),
    err2 (...)) of distorted pixel corners (..., 4, 2), a CUDA float32
    tensor; errors in pixels."""
    if corners_px.dim() < 2 or tuple(corners_px.shape[-2:]) != (4, 2):
        raise ValueError(f"solve: corners {tuple(corners_px.shape)}, "
                         "expected (..., 4, 2)")
    corners = corners_px.contiguous()
    _build.check_cuda("corners", corners, torch.float32, corners.dim())
    camera = pack_camera(cam, corners.device)
    batch = corners.shape[:-2]

    def out(*shape):
        return torch.empty((*batch, *shape), dtype=torch.float32,
                           device=corners.device)

    t, q, rvec, err, err2 = out(3), out(4), out(3), out(), out()
    with _build.on_device(corners, camera, t) as stream:
        _build.call(_build.function("pnp_square", _ARGTYPES),
                    _build.ptr(corners), _build.ptr(camera),
                    float(marker_size) / 2.0, refine_iters,
                    corners.numel() // 8, THREADS, _build.ptr(t),
                    _build.ptr(q), _build.ptr(rvec), _build.ptr(err),
                    _build.ptr(err2), stream)
    if corners.numel():  # pnp_square launches nothing for no marker
        solve.launches += 1
    return t, q, rvec, err, err2


solve.launches = 0
