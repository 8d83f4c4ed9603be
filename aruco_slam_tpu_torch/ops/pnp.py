"""Batched planar PnP: closed-form square homography + IPPE + Gauss-Newton.

Counterpart of aruco_slam_tpu/ops/pnp.py (Collins & Bartoli's IPPE, the
algorithm behind OpenCV's SOLVEPNP_IPPE_SQUARE). The same formulas
entry for entry: the closed-form homography, both IPPE rotations, the
least-squares translation, a damped Gauss-Newton polish of BOTH
ambiguity candidates, and the disambiguation by reprojection error.
The JAX package writes the whole solve in scalar structure-of-arrays
form because of the TPU tiler; here the per-corner Gauss-Newton terms
are stacked over the 4 corners instead (fewer eager launches), and are
accumulated in the reference's corner order. On a card the whole solve
is one kernel (`cuda_pnp`); the eager chain is its plain version
(`solve_square_pnp_plain`). Calibration's f64 LM calls
`solve_square_pnp_normalized` and always runs the eager chain.

Object frame: tag in the z = 0 plane, corners TL TR BR BL;
x_cam = R x_obj + t.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.core import quaternion as quat
from aruco_slam_tpu_torch.ops import cuda_pnp

_EPS = 1e-12
_CHOL_EPS = 1e-20


class PnPResult(NamedTuple):
    """Batched solution; leading axes match the input batch."""

    t_cl: torch.Tensor   # (..., 3) marker origin in camera frame
    q_cl: torch.Tensor   # (..., 4) wxyz marker-to-camera rotation
    rvec: torch.Tensor   # (..., 3) rotation vector
    err: torch.Tensor    # (...,) RMS reprojection error, pixels
    err2: torch.Tensor   # (...,) RMS error of the rejected solution


def square_object_points(marker_size, dtype=torch.float32,
                         device=None) -> torch.Tensor:
    """Canonical square corners (4, 3), IPPE_SQUARE order."""
    s = marker_size / 2.0
    return torch.tensor(
        [[-s, s, 0.0], [s, s, 0.0], [s, -s, 0.0], [-s, -s, 0.0]],
        dtype=dtype, device=device)


def homography_4pt(obj_xy: torch.Tensor, img_xy: torch.Tensor
                   ) -> torch.Tensor:
    """DLT homography from exactly 4 correspondences.

    obj_xy: (..., 4, 2) plane coordinates; img_xy: (..., 4, 2) normalized
    image coordinates. Returns (..., 3, 3) with H[2,2] = 1. The 8x8
    normal equations are solved by the unrolled Cholesky."""
    x, y = obj_xy[..., 0], obj_xy[..., 1]
    u, v = img_xy[..., 0], img_xy[..., 1]
    zeros, ones = torch.zeros_like(x), torch.ones_like(x)
    rows_u = torch.stack([x, y, ones, zeros, zeros, zeros, -u * x, -u * y],
                         dim=-1)
    rows_v = torch.stack([zeros, zeros, zeros, x, y, ones, -v * x, -v * y],
                         dim=-1)
    a = torch.cat([rows_u, rows_v], dim=-2)              # (..., 8, 8)
    b = torch.cat([u, v], dim=-1)                        # (..., 8)
    ata = torch.einsum("...mi,...mj->...ij", a, a)
    atb = torch.einsum("...mi,...m->...i", a, b)
    h = _solve_spd_entries([[ata[..., i, j] for j in range(8)]
                            for i in range(8)],
                           [atb[..., i] for i in range(8)])
    h = torch.stack(h + [torch.ones_like(h[0])], dim=-1)
    return h.reshape(*h.shape[:-1], 3, 3)


def _safe_div(a, b, eps=_EPS):
    return a / torch.where(torch.abs(b) < eps,
                           torch.where(b < 0, -eps, eps), b)


def _h_square_entries(s, u, v):
    """Closed-form homography taking the canonical square corners
    TL(−s,s) TR(s,s) BR(s,−s) BL(−s,−s) to the quad (u_k, v_k):
    projective unit-square interpolation (Heckbert '89) composed with
    the affine unit↔square map. u, v: lists of 4 batched tensors;
    returns 3x3 nested lists of batched tensors."""
    sx = u[0] - u[1] + u[2] - u[3]
    sy = v[0] - v[1] + v[2] - v[3]
    dx1 = u[1] - u[2]
    dy1 = v[1] - v[2]
    dx2 = u[3] - u[2]
    dy2 = v[3] - v[2]
    den = dx1 * dy2 - dx2 * dy1
    g = _safe_div(sx * dy2 - dx2 * sy, den)
    hh = _safe_div(dx1 * sy - sx * dy1, den)
    a = u[1] - u[0] + g * u[1]
    b = u[3] - u[0] + hh * u[3]
    c = u[0]
    d = v[1] - v[0] + g * v[1]
    e = v[3] - v[0] + hh * v[3]
    f = v[0]
    k = 0.5 / s
    return [[a * k, -b * k, 0.5 * a + 0.5 * b + c],
            [d * k, -e * k, 0.5 * d + 0.5 * e + f],
            [g * k, -hh * k, 0.5 * g + 0.5 * hh + 1.0]]


def _ippe_rotations_entries(h):
    """Both IPPE rotation solutions from 3x3 homography entries."""
    inv22 = _safe_div(torch.ones_like(h[2][2]), h[2][2])
    h = [[h[i][j] * inv22 for j in range(3)] for i in range(3)]
    u0, v0 = h[0][2], h[1][2]
    nrm = torch.sqrt(u0 * u0 + v0 * v0 + 1.0)
    d0, d1, c = u0 / nrm, v0 / nrm, 1.0 / nrm
    m = 1.0 / torch.clamp(1.0 + c, min=1e-6)
    rv = [[1.0 - d0 * d0 * m, -d0 * d1 * m, d0],
          [-d0 * d1 * m, 1.0 - d1 * d1 * m, d1],
          [-d0, -d1, 1.0 - (d0 * d0 + d1 * d1) * m]]
    hp = [[rv[0][i] * h[0][j] + rv[1][i] * h[1][j]
           + rv[2][i] * h[2][j] for j in range(3)] for i in range(3)]
    ihp22 = _safe_div(torch.ones_like(hp[2][2]), hp[2][2])
    a00, a01 = hp[0][0] * ihp22, hp[0][1] * ihp22
    a10, a11 = hp[1][0] * ihp22, hp[1][1] * ihp22
    g00 = a00 * a00 + a10 * a10
    g01 = a00 * a01 + a10 * a11
    g11 = a01 * a01 + a11 * a11
    tr = g00 + g11
    det = g00 * g11 - g01 * g01
    disc = torch.sqrt(torch.clamp(tr * tr - 4.0 * det, min=0.0))
    gamma = 1.0 / torch.sqrt(torch.clamp(0.5 * (tr + disc), min=_EPS))
    gg = gamma * gamma
    ga00, ga01 = gamma * a00, gamma * a01
    ga10, ga11 = gamma * a10, gamma * a11
    c1 = torch.sqrt(torch.clamp(1.0 - gg * g00, min=0.0))
    c2m = torch.sqrt(torch.clamp(1.0 - gg * g11, min=0.0))
    c2 = torch.where(g01 > 0, -c2m, c2m)  # c1*c2 = −gamma² g01

    def build(c1v, c2v):
        cx = ga10 * c2v - c1v * ga11
        cy = c1v * ga01 - ga00 * c2v
        cz = ga00 * ga11 - ga10 * ga01
        rp = [[ga00, ga01, cx], [ga10, ga11, cy], [c1v, c2v, cz]]
        return [[rv[i][0] * rp[0][j] + rv[i][1] * rp[1][j]
                 + rv[i][2] * rp[2][j] for j in range(3)]
                for i in range(3)]

    return build(c1, c2), build(-c1, -c2)


def _solve_spd_entries(a, b):
    """Unrolled Cholesky solve: a[i][j] (j ≤ i) and b[i] batched
    tensors (ops/linalg.py `solve_spd_entries`)."""
    n = len(b)
    low = [[None] * n for _ in range(n)]
    for i in range(n):
        for j in range(i + 1):
            s = a[i][j]
            for k in range(j):
                s = s - low[i][k] * low[j][k]
            if i == j:
                low[i][j] = torch.sqrt(torch.clamp(s, min=_CHOL_EPS))
            else:
                low[i][j] = s / low[j][j]
    y = [None] * n
    for i in range(n):
        s = b[i]
        for k in range(i):
            s = s - low[i][k] * y[k]
        y[i] = s / low[i][i]
    x = [None] * n
    for i in reversed(range(n)):
        s = y[i]
        for k in range(i + 1, n):
            s = s - low[k][i] * x[k]
        x[i] = s / low[i][i]
    return x


def _rx_entries(rr, ox, oy, k):
    """Rotated object point R X_k for the z = 0 corner k."""
    return (rr[0][0] * ox[k] + rr[0][1] * oy[k],
            rr[1][0] * ox[k] + rr[1][1] * oy[k],
            rr[2][0] * ox[k] + rr[2][1] * oy[k])


def _solve_translation_entries(rr, ox, oy, u, v):
    """Least-squares translation given rotation (3x3 normal
    equations, Cholesky-solved in scalars)."""
    one = torch.ones_like(u[0])
    n00 = 4.0 * one
    n02 = -(u[0] + u[1] + u[2] + u[3])
    n12 = -(v[0] + v[1] + v[2] + v[3])
    n22 = sum(u[k] * u[k] + v[k] * v[k] for k in range(4))
    b0 = torch.zeros_like(u[0])
    b1 = torch.zeros_like(u[0])
    b2 = torch.zeros_like(u[0])
    for k in range(4):
        rxx, rxy, rxz = _rx_entries(rr, ox, oy, k)
        bu = u[k] * rxz - rxx
        bv = v[k] * rxz - rxy
        b0 = b0 + bu
        b1 = b1 + bv
        b2 = b2 - u[k] * bu - v[k] * bv
    zero = torch.zeros_like(u[0])
    return _solve_spd_entries([[n00], [zero, n00], [n02, n12, n22]],
                              [b0, b1, b2])


def _reproj_rms_entries(rr, tt, ox, oy, u, v):
    """RMS normalized reprojection error + non-positive-depth penalty."""
    e2 = 0.0
    pen = 0.0
    for k in range(4):
        rxx, rxy, rxz = _rx_entries(rr, ox, oy, k)
        pz = rxz + tt[2]
        z = torch.clamp(pz, min=1e-6)
        x = (rxx + tt[0]) / z
        y = (rxy + tt[1]) / z
        e2 = e2 + (x - u[k]) ** 2 + (y - v[k]) ** 2
        pen = pen + torch.clamp(0.3 - pz, min=0.0)
    return torch.sqrt(e2 * 0.25) + pen * 1e3


def _gn_refine(rr, tt, ox, oy, uo, vo, iters: int, damping: float = 1e-9):
    """Fixed-iteration damped Gauss-Newton on the normalized-coordinate
    reprojection residual; parameters [δθ (left rotvec), δt]. ox/oy:
    (4,) object coords; uo/vo: (M, 4) observations."""
    for _ in range(iters):
        a0 = rr[0][0][:, None] * ox + rr[0][1][:, None] * oy   # (M, 4)
        a1 = rr[1][0][:, None] * ox + rr[1][1][:, None] * oy
        a2 = rr[2][0][:, None] * ox + rr[2][1][:, None] * oy
        z = torch.clamp(a2 + tt[2][:, None], min=1e-6)
        iz = 1.0 / z
        x = (a0 + tt[0][:, None]) * iz
        y = (a1 + tt[1][:, None]) * iz
        ru = x - uo
        rv = y - vo
        zero = torch.zeros_like(iz)
        ju = torch.stack([-x * a1 * iz, (a2 + x * a0) * iz, -a1 * iz,
                          iz, zero, -x * iz], -1)               # (M,4,6)
        jv = torch.stack([-(a2 + y * a1) * iz, y * a0 * iz, a0 * iz,
                          zero, iz, -y * iz], -1)
        terms = (ju[..., :, None] * ju[..., None, :]
                 + jv[..., :, None] * jv[..., None, :])         # (M,4,6,6)
        grads = ju * ru[..., None] + jv * rv[..., None]         # (M,4,6)
        jtj = damping * torch.eye(6, dtype=iz.dtype, device=iz.device) \
            + terms[:, 0]
        jtr = 0.0 + grads[:, 0]
        for k in range(1, 4):  # the reference's corner order
            jtj = jtj + terms[:, k]
            jtr = jtr + grads[:, k]
        delta = _solve_spd_entries(
            [[jtj[:, i, j] for j in range(i + 1)] for i in range(6)],
            [-jtr[:, i] for i in range(6)])
        w0, w1, w2 = delta[0], delta[1], delta[2]
        th = torch.sqrt(w0 * w0 + w1 * w1 + w2 * w2)
        half = 0.5 * th
        small_ang = th < 1e-8
        f = torch.where(small_ang, 0.5,
                        torch.sin(half) / torch.where(small_ang, 1.0, th))
        qw = torch.cos(half)
        qx, qy, qz = f * w0, f * w1, f * w2
        dm = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qz * qw),
               2 * (qx * qz + qy * qw)],
              [2 * (qx * qy + qz * qw), 1 - 2 * (qx * qx + qz * qz),
               2 * (qy * qz - qx * qw)],
              [2 * (qx * qz - qy * qw), 2 * (qy * qz + qx * qw),
               1 - 2 * (qx * qx + qy * qy)]]
        rr = [[dm[i][0] * rr[0][j] + dm[i][1] * rr[1][j]
               + dm[i][2] * rr[2][j] for j in range(3)] for i in range(3)]
        tt = [tt[0] + delta[3], tt[1] + delta[4], tt[2] + delta[5]]
    return rr, tt


def solve_square_pnp_normalized(img_xy: torch.Tensor, marker_size,
                                refine_iters: int = 8) -> PnPResult:
    """IPPE-square PnP from normalized (undistorted) corners (M, 4, 2);
    `err` fields in normalized units."""
    dt, dev = img_xy.dtype, img_xy.device
    s = marker_size / 2.0
    ox = [-s, s, s, -s]
    oy = [s, s, -s, -s]
    ox_t = torch.tensor(ox, dtype=dt, device=dev)
    oy_t = torch.tensor(oy, dtype=dt, device=dev)
    u = [img_xy[:, k, 0] for k in range(4)]
    v = [img_xy[:, k, 1] for k in range(4)]

    h = _h_square_entries(torch.tensor(s, dtype=dt, device=dev), u, v)
    r1e, r2e = _ippe_rotations_entries(h)
    t1e = _solve_translation_entries(r1e, ox, oy, u, v)
    t2e = _solve_translation_entries(r2e, ox, oy, u, v)
    uo, vo = img_xy[..., 0], img_xy[..., 1]
    r1e, t1e = _gn_refine(r1e, t1e, ox_t, oy_t, uo, vo, refine_iters)
    r2e, t2e = _gn_refine(r2e, t2e, ox_t, oy_t, uo, vo, refine_iters)
    e1 = _reproj_rms_entries(r1e, t1e, ox, oy, u, v)
    e2 = _reproj_rms_entries(r2e, t2e, ox, oy, u, v)
    best_first = e1 <= e2
    r = torch.stack([
        torch.stack([torch.where(best_first, r1e[i][j], r2e[i][j])
                     for j in range(3)], -1) for i in range(3)], -2)
    t = torch.stack([torch.where(best_first, t1e[i], t2e[i])
                     for i in range(3)], -1)
    err = torch.where(best_first, e1, e2)
    q = quat.from_matrix(r)
    return PnPResult(t_cl=t, q_cl=q, rvec=quat.to_rotvec(q), err=err,
                     err2=torch.where(best_first, e2, e1))


def solve_square_pnp(cam: cam_mod.CameraModel, corners_px: torch.Tensor,
                     marker_size, refine_iters: int = 8) -> PnPResult:
    """Batched IPPE-square PnP from distorted pixel corners
    (..., 4, 2); errors converted to pixels with the mean focal.

    A CUDA tensor launches ``csrc/pnp_square.cu`` once (`cuda_pnp.solve`,
    which takes float32 alone and refuses any other); a CPU tensor runs
    `solve_square_pnp_plain`."""
    if corners_px.is_cuda:
        return PnPResult(*cuda_pnp.solve(cam, corners_px, marker_size,
                                         refine_iters))
    return solve_square_pnp_plain(cam, corners_px, marker_size,
                                  refine_iters)


def solve_square_pnp_plain(cam: cam_mod.CameraModel,
                           corners_px: torch.Tensor, marker_size,
                           refine_iters: int = 8) -> PnPResult:
    """`solve_square_pnp` in eager PyTorch ops, on any device and
    dtype: the CUDA kernel's plain version."""
    xy = cam_mod.pixel_to_ray(cam, corners_px)
    batch = xy.shape[:-2]
    res = solve_square_pnp_normalized(xy.reshape(-1, 4, 2), marker_size,
                                      refine_iters)
    f = 0.5 * (cam.fx + cam.fy)
    return PnPResult(
        t_cl=res.t_cl.reshape(*batch, 3),
        q_cl=res.q_cl.reshape(*batch, 4),
        rvec=res.rvec.reshape(*batch, 3),
        err=(res.err * f).reshape(batch),
        err2=(res.err2 * f).reshape(batch),
    )
