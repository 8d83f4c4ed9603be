"""Camera calibration from planar board views (batched LM), on tensors.

Counterpart of aruco_slam_tpu/ops/calibrate.py (the reference's ChArUco
calibration tool, cv2.aruco.calibrateCameraCharuco): intrinsics (fx, fy,
cx, cy) and the 5-term distortion from several views of a known planar
board, as one Levenberg-Marquardt problem over [intrinsics (9), per-view
poses (6V)] whose residuals are every view's reprojection errors at
once, with the small dense normal equations solved directly.

Boards: marker grids (`grid_board`, residuals on the marker corners) and
ChArUco boards (`charuco_board`, the reference's board: markers seed the
initialization, the interior chessboard corners, interpolated from local
marker homographies and refined to subpixel saddle points by
`detect.refine_corners`, carry the LM).

The board layouts, the homography fit, the Zhang focal initialization
and the chessboard interpolation are host numpy, copies of the JAX
package's (the tests hold them bit-identical). The per-view IPPE
initialization and the LM run on the caller's device in float64, as the
JAX calibration CLI runs them under ``jax_enable_x64``; the LM's
Jacobian is `torch.func.jacfwd` of its residual function, and its
accept/reject and damping stay on the device.
"""

from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.core import quaternion as quat
from aruco_slam_tpu_torch.ops import pnp

F64 = torch.float64


class BoardLayout(NamedTuple):
    """Planar marker board: per marker id, the 4 corner positions in
    board coordinates (z = 0), IPPE corner order."""

    ids: np.ndarray       # (M,)
    corners: np.ndarray   # (M, 4, 2) board-plane xy


def grid_board(nx: int, ny: int, marker_size: float, gap: float,
               first_id: int = 0) -> BoardLayout:
    """nx × ny grid of markers (like cv2.aruco.GridBoard)."""
    ids, corners = [], []
    pitch = marker_size + gap
    s = marker_size
    for gy in range(ny):
        for gx in range(nx):
            x0 = gx * pitch
            y0 = gy * pitch
            # TL TR BR BL with y up in board frame
            corners.append([[x0, y0 + s], [x0 + s, y0 + s],
                            [x0 + s, y0], [x0, y0]])
            ids.append(first_id + gy * nx + gx)
    return BoardLayout(np.asarray(ids, np.int32),
                       np.asarray(corners, np.float64))


class CharucoBoard(NamedTuple):
    """Chessboard with markers in the white squares (cv2.aruco.CharucoBoard
    semantics: the printed top-left square is black; markers fill white
    squares in row-major order from the printed top; the interior
    chessboard corners are the calibration features). Board frame: x
    right, y up, z out of the board."""

    squares_x: int
    squares_y: int
    square_len: float
    marker_len: float
    layout: BoardLayout      # the board's markers (for detection/init)
    chess_pts: np.ndarray    # (C,2) interior corner board xy, row-major


def charuco_board(squares_x: int, squares_y: int, square_len: float,
                  marker_len: float, first_id: int = 0) -> CharucoBoard:
    """squares_x × squares_y ChArUco board. Markers occupy the white
    squares, centered with margin (square_len − marker_len)/2."""
    if marker_len >= square_len:
        raise ValueError("marker_len must be < square_len")
    ids, corners = [], []
    s = marker_len
    margin = (square_len - marker_len) / 2.0
    mid = first_id
    # board frame y is up, so the printed top row is gy = squares_y − 1
    for row_top in range(squares_y):
        gy = squares_y - 1 - row_top
        for gx in range(squares_x):
            if (gx + row_top) % 2 == 0:   # black square, no marker
                continue
            x0 = gx * square_len + margin
            y0 = gy * square_len + margin
            corners.append([[x0, y0 + s], [x0 + s, y0 + s],
                            [x0 + s, y0], [x0, y0]])
            ids.append(mid)
            mid += 1
    # interior chessboard corners, cv2 id order: row-major from the
    # printed top-left (max board y first)
    chess = [[ix * square_len, iy * square_len]
             for iy in range(squares_y - 1, 0, -1)
             for ix in range(1, squares_x)]
    return CharucoBoard(
        squares_x, squares_y, square_len, marker_len,
        BoardLayout(np.asarray(ids, np.int32),
                    np.asarray(corners, np.float64)),
        np.asarray(chess, np.float64))


class CalibrationResult(NamedTuple):
    camera_matrix: np.ndarray  # (3, 3)
    dist_coeffs: np.ndarray    # (5,)
    rms_px: float
    per_view_rms: np.ndarray   # (V,)


def _zhang_focal_init(homs, cx: float, cy: float) -> float:
    """Focal estimate from plane homographies (zero skew, centered
    principal point): with K = diag(f, f, 1) shifted by (cx, cy),
    h1ᵀ ω h2 = 0 and h1ᵀ ω h1 = h2ᵀ ω h2, ω = K⁻ᵀK⁻¹."""
    rows, rhs = [], []
    for h in homs:
        # shift principal point so K = diag(f, f, 1)
        t = np.array([[1, 0, -cx], [0, 1, -cy], [0, 0, 1.0]])
        hh = t @ h
        h1, h2 = hh[:, 0], hh[:, 1]

        def w_terms(a, b):
            # aᵀ diag(1/f², 1/f², 1) b = (a0 b0 + a1 b1)/f² + a2 b2
            return a[0] * b[0] + a[1] * b[1], a[2] * b[2]

        c1, d1 = w_terms(h1, h2)
        rows.append(c1)
        rhs.append(-d1)
        c2a, d2a = w_terms(h1, h1)
        c2b, d2b = w_terms(h2, h2)
        rows.append(c2a - c2b)
        rhs.append(-(d2a - d2b))
    rows = np.asarray(rows)
    rhs = np.asarray(rhs)
    denom = float(rows @ rows)
    if denom < 1e-12:
        return 1000.0
    inv_f2 = float(rows @ rhs) / denom
    if inv_f2 <= 1e-12:
        return 1000.0
    return 1.0 / np.sqrt(inv_f2)


def _fit_homography(src: np.ndarray, dst: np.ndarray) -> np.ndarray:
    """Least-squares DLT homography (h22 = 1) from (N,2)→(N,2), N ≥ 4."""
    a_rows, b_rows = [], []
    for (x, y), (u, v) in zip(src, dst):
        a_rows.append([x, y, 1, 0, 0, 0, -u * x, -u * y])
        b_rows.append(u)
        a_rows.append([0, 0, 0, x, y, 1, -v * x, -v * y])
        b_rows.append(v)
    a = np.asarray(a_rows)
    b = np.asarray(b_rows)
    hvec, *_ = np.linalg.lstsq(a, b, rcond=None)
    return np.append(hvec, 1.0).reshape(3, 3)


def _init_views(layout: BoardLayout, view_corners: np.ndarray,
                view_mask: np.ndarray, image_size: tuple[int, int],
                device=None):
    """Zhang focal + per-view IPPE pose initialization from detected
    marker corners: each valid view's first detected marker through
    `pnp.solve_square_pnp_normalized` at float64, all views in one
    batch on ``device``. Returns (f0, cx0, cy0, pose0 (V, 6) rotvec + t,
    valid_views)."""
    v = view_mask.shape[0]
    w, h = image_size
    cx0, cy0 = w / 2.0, h / 2.0

    homs = []
    for i in range(v):
        det = np.where(view_mask[i])[0]
        if len(det) < 2:
            homs.append(None)
            continue
        homs.append(_fit_homography(layout.corners[det].reshape(-1, 2),
                                    view_corners[i, det].reshape(-1, 2)))
    valid_views = [i for i, hh in enumerate(homs) if hh is not None]
    f0 = _zhang_focal_init([homs[i] for i in valid_views], cx0, cy0)

    pose0 = np.zeros((v, 6))
    pose0[:, 5] = 1.0  # z offset placeholder
    if not valid_views:
        return f0, cx0, cy0, pose0, valid_views
    cam0 = cam_mod.CameraModel.from_matrix(
        np.array([[f0, 0, cx0], [0, f0, cy0], [0, 0, 1.0]]), np.zeros(5),
        dtype=F64, device=device)
    # each valid view's first detected marker; one batched solve per
    # marker side length (the side as the JAX function measures it, so
    # markers whose corner differences round apart solve apart)
    first = {i: int(np.where(view_mask[i])[0][0]) for i in valid_views}
    by_size: dict[float, list[int]] = {}
    for i, j in first.items():
        side = float(np.linalg.norm(layout.corners[j][0]
                                    - layout.corners[j][1]))
        by_size.setdefault(side, []).append(i)
    for side, views in by_size.items():
        px = torch.as_tensor(np.stack([view_corners[i, first[i]]
                                       for i in views]),
                             dtype=F64, device=device)
        res = pnp.solve_square_pnp_normalized(
            cam_mod.pixel_to_ray(cam0, px), side)
        rot = quat.to_matrix(res.q_cl).cpu().numpy()
        rvec = quat.to_rotvec(res.q_cl).cpu().numpy()
        t = res.t_cl.cpu().numpy()
        for k, i in enumerate(views):
            # lift the marker pose to the board pose: board point p maps
            # to the camera as R (p − center_j) + t
            center_board = np.array([*layout.corners[first[i]].mean(0),
                                     0.0])
            pose0[i, :3] = rvec[k]
            pose0[i, 3:] = t[k] - rot[k] @ center_board
    return f0, cx0, cy0, pose0, valid_views


def _project_views(params: torch.Tensor, pts3: torch.Tensor, v: int
                   ) -> torch.Tensor:
    """(V, N, 2) pixels of the board points under params [intrinsics
    (9), poses (6V) rotvec + t]."""
    cam = cam_mod.CameraModel(fx=params[0], fy=params[1], cx=params[2],
                              cy=params[3], dist=params[4:9])
    poses = params[9:].reshape(v, 6)
    rot = quat.to_matrix(quat.from_rotvec(poses[:, :3]))  # (V, 3, 3)
    pts = torch.einsum("vab,nb->vna", rot, pts3) + poses[:, None, 3:]
    return cam_mod.project(cam, pts)


def _residual_fn(board_pts: torch.Tensor, view_pts: torch.Tensor,
                 view_mask: torch.Tensor):
    """params (9 + 6V,) -> the masked reprojection residuals (V·N·2,)."""
    v = view_pts.shape[0]

    def residuals(params):
        proj = _project_views(params, board_pts, v)
        return ((proj - view_pts) * view_mask[:, :, None]).reshape(-1)
    return residuals


def _lm_iterations(residuals, params: torch.Tensor, iters: int
                   ) -> torch.Tensor:
    """``iters`` LM steps from ``params`` (the JAX `lm_step`: damping
    lam·(diag JᵀJ + 1e-9), ×0.3 on accept, ×3 on reject, within [1e-10,
    1e8]). Every choice stays on the device: the loop reads nothing
    back. A failed solve gives NaN, which the cost test rejects."""
    jacobian = torch.func.jacfwd(residuals)
    lam = torch.full((), 1e-3, dtype=params.dtype, device=params.device)
    cost = torch.sum(residuals(params) ** 2)
    for _ in range(iters):
        r = residuals(params)
        jac = jacobian(params)
        jtj = jac.T @ jac
        jtj = jtj + lam * torch.diag(torch.diagonal(jtj) + 1e-9)
        delta, info = torch.linalg.solve_ex(jtj, -(jac.T @ r))
        delta = torch.where(info == 0, delta, torch.full_like(delta,
                                                              float("nan")))
        trial = params + delta
        new_cost = torch.sum(residuals(trial) ** 2)
        accept = new_cost < cost
        params = torch.where(accept, trial, params)
        lam = torch.clamp(torch.where(accept, lam * 0.3, lam * 3.0),
                          1e-10, 1e8)
        cost = torch.where(accept, new_cost, cost)
    return params


def _lm_calibrate(board_pts: np.ndarray, view_pts: np.ndarray,
                  view_mask: np.ndarray, intr0: np.ndarray,
                  pose0: np.ndarray, iters: int, device=None) -> np.ndarray:
    """Joint LM over [intrinsics (9), poses (6V)] with reprojection
    residuals on generic planar point features, float64 on ``device``.

    board_pts: (N, 3) board-frame points (z = 0); view_pts: (V, N, 2)
    detected pixels; view_mask: (V, N). Returns the optimized params
    (9 + 6V,)."""
    residuals = _residual_fn(
        torch.as_tensor(board_pts, dtype=F64, device=device),
        torch.as_tensor(view_pts, dtype=F64, device=device),
        torch.as_tensor(view_mask, device=device))
    params = torch.as_tensor(np.concatenate(
        [np.asarray(intr0, np.float64), pose0.reshape(-1)]), dtype=F64,
        device=device)
    return _lm_iterations(residuals, params, iters).cpu().numpy()


def _result(params: np.ndarray, board_pts: np.ndarray,
            view_pts: np.ndarray, view_mask: np.ndarray
            ) -> CalibrationResult:
    """The calibration's matrices and its RMS reprojection errors (host,
    float64)."""
    v = view_pts.shape[0]
    intr = params[:9]
    k = np.array([[intr[0], 0, intr[2]], [0, intr[1], intr[3]],
                  [0, 0, 1.0]])
    proj = _project_views(torch.from_numpy(np.asarray(params, np.float64)),
                          torch.from_numpy(np.asarray(board_pts,
                                                      np.float64)),
                          v).numpy()
    r = (proj - view_pts) * view_mask[:, :, None]
    counts = np.maximum(view_mask.sum(-1), 1)
    per_view = np.sqrt((r ** 2).sum((-1, -2)) / counts)
    n = max(float(view_mask.sum()), 1.0)
    rms = float(np.sqrt((r ** 2).sum() / n))
    return CalibrationResult(k, intr[4:9], rms, per_view)


def calibrate(board: BoardLayout, view_corners: np.ndarray,
              view_mask: np.ndarray, image_size: tuple[int, int],
              iters: int = 40, device=None) -> CalibrationResult:
    """Calibrate from detected marker corners across views.

    view_corners: (V, M, 4, 2) pixel corners per view per board marker
    (aligned with board.ids); view_mask: (V, M) detected flags. The
    initialization's PnP and the LM run on ``device`` (None: the CPU)."""
    v, m = view_mask.shape
    f0, cx0, cy0, pose0, _ = _init_views(
        board, view_corners, view_mask, image_size, device)
    intr0 = np.array([f0, f0, cx0, cy0, 0, 0, 0, 0, 0])
    board_pts = np.concatenate(
        [board.corners, np.zeros((m, 4, 1))], -1).reshape(-1, 3)
    pts = view_corners.reshape(v, -1, 2)
    msk = np.repeat(view_mask, 4, axis=-1)
    params = _lm_calibrate(board_pts, pts, msk, intr0, pose0, iters, device)
    return _result(params, board_pts, pts, msk)


def interpolate_chess_corners(
        board: CharucoBoard, marker_corners: np.ndarray,
        marker_mask: np.ndarray, min_markers: int = 2,
        radius_squares: float = 2.5
) -> tuple[np.ndarray, np.ndarray]:
    """Interior chessboard corners from detected marker corners via
    local homographies (the capability of cv2.aruco.interpolateCornersCharuco).

    For each interior corner, fit a board→pixel homography from the
    corners of the nearest detected markers (≥ ``min_markers`` within
    ``radius_squares`` board squares) and map the corner through it.
    Host numpy (tiny problem sizes); the subpixel polish runs on the
    device (`detect.refine_corners`).

    marker_corners: (V, M, 4, 2) aligned with board.layout.ids;
    marker_mask: (V, M). Returns (chess_px (V, C, 2), chess_mask
    (V, C))."""
    v, m = marker_mask.shape
    c = len(board.chess_pts)
    centers = board.layout.corners.mean(1)           # (M, 2)
    radius = radius_squares * board.square_len
    chess_px = np.zeros((v, c, 2))
    chess_mask = np.zeros((v, c), bool)
    for i in range(v):
        det = np.where(marker_mask[i])[0]
        if len(det) < min_markers:
            continue
        for j in range(c):
            p = board.chess_pts[j]
            d = np.linalg.norm(centers[det] - p, axis=-1)
            order = np.argsort(d)
            near = det[order[:4]]
            near = near[d[order[:4]] <= radius]
            if len(near) < min_markers:
                continue
            hom = _fit_homography(
                board.layout.corners[near].reshape(-1, 2),
                marker_corners[i, near].reshape(-1, 2))
            q = hom @ np.array([p[0], p[1], 1.0])
            chess_px[i, j] = q[:2] / q[2]
            chess_mask[i, j] = True
    return chess_px, chess_mask


def calibrate_charuco(board: CharucoBoard, marker_corners: np.ndarray,
                      marker_mask: np.ndarray, chess_px: np.ndarray,
                      chess_mask: np.ndarray,
                      image_size: tuple[int, int],
                      iters: int = 40, device=None) -> CalibrationResult:
    """Calibrate from interpolated chessboard corners (the residual
    features cv2.aruco.calibrateCameraCharuco uses). Marker detections
    seed the Zhang/IPPE initialization; chessboard corners carry the
    LM, on ``device`` (None: the CPU)."""
    f0, cx0, cy0, pose0, _ = _init_views(
        board.layout, marker_corners, marker_mask, image_size, device)
    intr0 = np.array([f0, f0, cx0, cy0, 0, 0, 0, 0, 0])
    c = len(board.chess_pts)
    board_pts = np.concatenate([board.chess_pts, np.zeros((c, 1))], -1)
    params = _lm_calibrate(board_pts, chess_px, chess_mask, intr0, pose0,
                           iters, device)
    return _result(params, board_pts, chess_px, chess_mask)
