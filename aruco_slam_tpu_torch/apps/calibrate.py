"""Camera calibration from marker-board images, on PyTorch/CUDA.

Counterpart of aruco_slam_tpu/apps/calibrate.py (the reference's
calibration tool): detect the board's markers in every view, jointly
optimize intrinsics and per-view poses, and save the reference's
artifacts ``camera_matrix.npy`` and ``dist_coeffs.npy`` (what
``run_slam --calib`` reads).

    python -m aruco_slam_tpu_torch.apps.calibrate --images views.npz \
        --grid 4x3 --marker-size 0.05 --gap 0.015 --out calibration/

    # the reference's board: 7x5 ChArUco, 30/15 mm, AprilTag 36h11
    python -m aruco_slam_tpu_torch.apps.calibrate --images views.npz \
        --board charuco --grid 7x5 --square-size 0.03 \
        --marker-size 0.015 --dict apriltag_36h11 --out calibration/

Every view is detected in one batch (`detect.detect_markers_mapped` on
the (V, H, W) views, each with a fresh id->slot table); on a ChArUco
board the interpolated chessboard corners of all views are refined by
one `detect.refine_corners` call (each view's result depends on that
view alone). The LM runs in float64 on the device (`ops/calibrate.py`).
``--preview N`` writes N undistorted views as 8-bit grayscale PNGs
(`io.write_png_gray`). ``--platform cuda`` is the default and raises
when no card is present. ``--images`` takes an .npz with 'images' (V, H,
W) uint8, or a directory of PNG/JPG files (read with imageio, which
that branch needs).
"""

from __future__ import annotations

import argparse
import time
from pathlib import Path
from typing import NamedTuple

import numpy as np
import torch

from aruco_slam_tpu_torch._device import resolve_device
from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.io import write_png_gray
from aruco_slam_tpu_torch.ops import calibrate as cal
from aruco_slam_tpu_torch.ops import detect, dictionary


class CalibrateRun(NamedTuple):
    """What `main` computed and wrote."""

    result: cal.CalibrationResult
    out_dir: Path
    previews: list      # the preview PNG paths
    seconds: dict       # wall time per stage


def _load_images(path: Path) -> np.ndarray:
    if path.suffix == ".npz":
        with np.load(path) as data:
            return data["images"]
    import imageio.v3 as iio
    files = sorted(path.glob("*.png")) + sorted(path.glob("*.jpg"))
    imgs = [iio.imread(f) for f in files]
    return np.stack([im.mean(-1).astype(np.uint8) if im.ndim == 3 else im
                     for im in imgs])


def _parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="camera calibration on "
                                            "PyTorch/CUDA")
    p.add_argument("--images", required=True,
                   help=".npz with 'images' (V,H,W) uint8, or a "
                        "directory of image files")
    p.add_argument("--board", choices=["grid", "charuco"], default="grid",
                   help="marker grid board or ChArUco chessboard "
                        "(the reference's board type)")
    p.add_argument("--grid", default="4x3",
                   help="markers nx x ny (grid) or squares nx x ny "
                        "(charuco)")
    p.add_argument("--marker-size", type=float, default=0.05)
    p.add_argument("--gap", type=float, default=0.015,
                   help="marker gap (grid boards)")
    p.add_argument("--square-size", type=float, default=0.03,
                   help="chessboard square side (charuco boards)")
    p.add_argument("--dict", dest="dict_name",
                   default=dictionary.DICT_5X5_50)
    p.add_argument("--out", default="calibration")
    p.add_argument("--preview", type=int, default=0, metavar="N",
                   help="write N undistorted preview PNGs to OUT/preview/")
    p.add_argument("--iters", type=int, default=60)
    p.add_argument("--platform", default="cuda", choices=["cuda", "cpu"],
                   help="device to run on; cuda raises without a card")
    return p


def main(argv=None) -> CalibrateRun:
    args = _parser().parse_args(argv)
    device = resolve_device(args.platform)
    seconds = {}
    images = _load_images(Path(args.images))
    v, h, w = images.shape

    nx, ny = (int(x) for x in args.grid.split("x"))
    if args.board == "charuco":
        cboard = cal.charuco_board(nx, ny, args.square_size,
                                   args.marker_size)
        board = cboard.layout
    else:
        cboard = None
        board = cal.grid_board(nx, ny, args.marker_size, args.gap)
    m = len(board.ids)

    # the id->slot tables are sized by the markers on the board (+
    # headroom for decodes of off-board clutter), not by the
    # dictionary's id range
    t0 = time.perf_counter()
    dcfg = detect.DetectorConfig(dict_name=args.dict_name, capacity=m + 8)
    ims = torch.from_numpy(np.ascontiguousarray(images)).to(device)
    det, tids = detect.detect_markers_mapped(
        ims, dcfg, detect.slot_table_init(dcfg.capacity, device, streams=v))
    det_c, det_m = det.corners.cpu().numpy(), det.mask.cpu().numpy()
    tids = tids.cpu().numpy()
    # translate each view's slots to board positions by marker id
    pos_of = {int(mid): j for j, mid in enumerate(board.ids)}
    corners = np.zeros((v, m, 4, 2), np.float32)
    mask = np.zeros((v, m), bool)
    for i in range(v):
        for s in np.where(det_m[i])[0]:
            j = pos_of.get(int(tids[i, s]))
            if j is not None:
                corners[i, j] = det_c[i, s]
                mask[i, j] = True
    seconds["detect"] = time.perf_counter() - t0
    print(f"{v} views, detections per view: {mask.sum(-1).tolist()}")

    if cboard is not None:
        t0 = time.perf_counter()
        chess_px, chess_mask = cal.interpolate_chess_corners(
            cboard, corners, mask)
        seconds["interpolate"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        if chess_mask.any():
            ref = detect.refine_corners(
                ims.to(torch.float32),
                torch.as_tensor(chess_px, dtype=torch.float32,
                                device=device)).cpu().numpy()
            chess_px[chess_mask] = ref[chess_mask]
        seconds["refine"] = time.perf_counter() - t0
        print(f"chess corners per view: {chess_mask.sum(-1).tolist()}")
        t0 = time.perf_counter()
        res = cal.calibrate_charuco(cboard, corners, mask, chess_px,
                                    chess_mask, (w, h), iters=args.iters,
                                    device=device)
    else:
        t0 = time.perf_counter()
        res = cal.calibrate(board, corners, mask, (w, h), iters=args.iters,
                            device=device)
    seconds["calibrate"] = time.perf_counter() - t0
    out = Path(args.out)
    out.mkdir(parents=True, exist_ok=True)
    np.save(out / "camera_matrix.npy", res.camera_matrix)
    np.save(out / "dist_coeffs.npy", res.dist_coeffs)
    print(f"rms {res.rms_px:.3f} px")
    print("camera matrix:\n", np.round(res.camera_matrix, 2))
    print("dist:", np.round(res.dist_coeffs, 4))
    print(f"wrote {out}/camera_matrix.npy, {out}/dist_coeffs.npy")

    previews = []
    if args.preview:
        t0 = time.perf_counter()
        cam = cam_mod.CameraModel.from_matrix(
            np.asarray(res.camera_matrix, np.float32),
            np.asarray(res.dist_coeffs, np.float32), device=device)
        pdir = out / "preview"
        for i in range(min(args.preview, v)):
            previews.append(pdir / f"undistorted_{i:03d}.png")
            write_png_gray(previews[-1], cam_mod.undistort_image(
                cam, ims[i]).cpu().numpy())
        seconds["preview"] = time.perf_counter() - t0
        print(f"wrote {len(previews)} undistorted previews to {pdir}/")
    stages = ", ".join(f"{k} {t:.3f}" for k, t in seconds.items())
    print(f"stage seconds {stages} ({device})")
    return CalibrateRun(res, out, previews, seconds)


if __name__ == "__main__":
    main()
