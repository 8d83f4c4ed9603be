"""Batched IPPE-square PnP: the CUDA kernel (`ops.cuda_pnp`,
``csrc/pnp_square.cu``) against its plain version
(`ops.pnp.solve_square_pnp_plain`), and `solve_square_pnp`'s dispatch.

On the CPU: a CPU tensor (float32 or float64) runs the plain version,
bit for bit, and launches nothing; the wrapper refuses what the kernel
does not take before it builds anything. The tests marked ``cuda`` need
a card and skip without one (no jax needed):

    python -m pytest --noconftest -p no:cacheprovider -q tests/test_torch_pnp_cuda.py

On the card the kernel equals the plain version bit for bit, NaNs
included: it is built to round where the eager chain's kernels round
(csrc/pnp_square.cu), because the filter downstream amplifies a
last-bit difference in one marker's pose past the benchmark's limits.
So the card tests compare with torch.equal and no tolerance, near-ties
of the two IPPE candidates (face-on markers) included: both versions
make the same choice.
"""

import numpy as np
import pytest
import torch

from aruco_slam_tpu_torch.core import camera as cam_mod
from aruco_slam_tpu_torch.core import quaternion as quat
from aruco_slam_tpu_torch.ops import cuda_pnp, pnp

K = np.array([[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3], [0.0, 0.0, 1.0]],
             np.float32)
# run_slam's default distortion (upstream's calibration) and none
DIST = {"distorted": np.array([0.0614, -0.2951, 0.0005, 0.0029, 0.4387],
                              np.float32),
        "pinhole": np.zeros(5, np.float32)}
SIZE = 0.16
MAX_REPROJ_PX = 3.0  # run_slam's gate
TIE_PX = 1e-2        # |err - err2| of a near-tie of the two candidates


def camera(kind: str, device=None) -> cam_mod.CameraModel:
    return cam_mod.CameraModel.from_matrix(K, DIST[kind], device=device)


def markers(shape, seed: int, cam, face_on=False, noise_px=0.5,
            padded=0.0):
    """(*shape, 4, 2) f32 pixel corners of random marker poses in view
    (tilt up to 1 rad, or up to 0.02 rad ``face_on``) with Gaussian
    noise; a ``padded`` share of slots zeroed, as the front end pads."""
    rng = np.random.default_rng(seed)
    n = int(np.prod(shape))
    axis = rng.normal(size=(n, 3))
    axis /= np.linalg.norm(axis, axis=1, keepdims=True)
    tilt = rng.uniform(0.0, 0.02 if face_on else 1.0, (n, 1))
    rot = quat.to_matrix(quat.from_rotvec(torch.tensor(axis * tilt))).numpy()
    t = np.stack([rng.uniform(-1.0, 1.0, n), rng.uniform(-0.6, 0.6, n),
                  rng.uniform(1.5, 4.5, n)], 1)
    s = SIZE / 2
    obj = np.array([[-s, s, 0.0], [s, s, 0.0], [s, -s, 0.0], [-s, -s, 0.0]])
    pts = np.einsum("nij,kj->nki", rot, obj) + t[:, None]
    px = cam_mod.project(cam.to(dtype=torch.float64, device="cpu"),
                         torch.tensor(pts)).numpy()
    px = px + rng.normal(scale=noise_px, size=px.shape)
    px[rng.random(n) < padded] = 0.0
    return torch.tensor(px.reshape(*shape, 4, 2), dtype=torch.float32)


# -- on the CPU -------------------------------------------------------


@pytest.mark.parametrize("shape", [(1,), (37,), (4, 16), (2, 3, 8)])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_cpu_tensor_runs_the_plain_version(shape, dtype):
    """A CPU tensor launches nothing and returns the plain version's
    result bit for bit, in the input's batch shape."""
    cam = camera("distorted").to(dtype=dtype)
    corners = markers(shape, 3, cam, padded=0.2).to(dtype)
    before = cuda_pnp.solve.launches
    got = pnp.solve_square_pnp(cam, corners, SIZE)
    assert cuda_pnp.solve.launches == before
    want = pnp.solve_square_pnp_plain(cam, corners, SIZE)
    _same(got, want)
    assert got.t_cl.dtype == dtype and got.t_cl.shape == (*shape, 3) and got.err.shape == shape


def test_pack_camera_order():
    cam = camera("distorted").to(dtype=torch.float64)
    packed = cuda_pnp.pack_camera(cam, torch.device("cpu"))
    assert packed.dtype == torch.float32 and packed.shape == (9,)
    want = np.r_[K[0, 0], K[1, 1], K[0, 2], K[1, 2], DIST["distorted"]]
    np.testing.assert_array_equal(packed.numpy(), want.astype(np.float32))


@pytest.mark.parametrize("corners,match", [
    (torch.zeros(5, 4, 2), "expected a CUDA tensor"),
    (torch.zeros(5, 3, 2), r"expected \(\.\.\., 4, 2\)"),
    (torch.zeros(8), r"expected \(\.\.\., 4, 2\)")])
def test_kernel_wrapper_refuses_what_it_does_not_take(corners, match):
    """Refused before any build or launch (no card here)."""
    before = cuda_pnp.solve.launches
    with pytest.raises(ValueError, match=match):
        cuda_pnp.solve(camera("pinhole"), corners, SIZE)
    assert cuda_pnp.solve.launches == before


# -- on a card --------------------------------------------------------


@pytest.fixture
def device():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")
    return torch.device("cuda")


def _same(got, want) -> None:
    """Every output equal bit for bit (NaN where the other is NaN)."""
    for name, g, w in zip(pnp.PnPResult._fields, got, want):
        assert g.shape == w.shape and g.dtype == w.dtype, name
        assert torch.equal(g.isnan(), w.isnan()), name
        assert torch.equal(g.nan_to_num(), w.nan_to_num()), name


def _check(cam, corners, device, **kw):
    """One kernel launch on the card (none for no marker) against the
    plain version on the same card; returns both results."""
    c = corners.to(device)
    cam_d = cam.to(device=device)
    before = cuda_pnp.solve.launches
    got = pnp.solve_square_pnp(cam_d, c, SIZE, **kw)
    assert cuda_pnp.solve.launches == before + (c.numel() > 0)
    want = pnp.solve_square_pnp_plain(cam_d, c, SIZE, **kw)
    _same(got, want)
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(128, 64), (32, 64), (1,), (37,)])
@pytest.mark.parametrize("kind", ["distorted", "pinhole"])
def test_kernel_matches_plain(device, shape, kind):
    """The corners pool's request (128 frames x 64 slots) and chunk (32
    x 64) with a third of the slots zero-padded, one marker and 37."""
    cam = camera(kind)
    _check(cam, markers(shape, 11, cam, padded=0.3 if shape[-1] == 64
                        else 0.0), device)


@pytest.mark.cuda
def test_zero_padded_slots_gate_alike(device):
    """A chunk whose empty slots hold zero corners: NaN in both, and the
    gate after the solve (det_m & err < max_reproj_px) gives the plain
    version's mask."""
    cam = camera("distorted")
    corners = markers((32, 64), 5, cam, padded=0.8)
    det_m = ((corners != 0).any(-1).any(-1)).to(device)
    got, want = _check(cam, corners, device)
    mask = [det_m & (r.err < MAX_REPROJ_PX) for r in (got, want)]
    assert torch.equal(*mask)
    assert 0 < int(mask[1].sum()) < mask[1].numel()
    assert bool(got.err[~det_m].isnan().all())


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["distorted", "pinhole"])
def test_face_on_markers(device, kind):
    """Tilts under 0.02 rad: the two IPPE candidates nearly coincide and
    many errors tie within TIE_PX; the kernel chooses as the plain
    version does, so the pair is not compared unordered."""
    cam = camera(kind)
    got, want = _check(cam, markers((16, 64), 13, cam, face_on=True),
                       device)
    assert int(((want.err - want.err2).abs() < TIE_PX).sum()) > 0


@pytest.mark.cuda
@pytest.mark.parametrize("iters", [0, 1, 20])
def test_refine_iterations_and_empty_batch(device, iters):
    """The Gauss-Newton step count is the caller's (0: the unrefined
    IPPE solutions); an empty batch launches nothing and returns empty
    outputs."""
    cam = camera("distorted")
    _check(cam, markers((64,), 17, cam), device, refine_iters=iters)
    got, _ = _check(cam, torch.zeros(0, 64, 4, 2), device)
    assert got.t_cl.shape == (0, 64, 3) and got.err.shape == (0, 64)


@pytest.mark.cuda
def test_float64_on_the_card_is_refused(device):
    """A CUDA tensor always goes to the kernel, which takes float32
    alone: float64 raises, with no fallback to the plain version."""
    cam = camera("distorted").to(dtype=torch.float64, device=device)
    corners = markers((8, 16), 23, camera("distorted")).double().to(device)
    before = cuda_pnp.solve.launches
    with pytest.raises(ValueError, match="expected torch.float32"):
        pnp.solve_square_pnp(cam, corners, SIZE)
    assert cuda_pnp.solve.launches == before


@pytest.mark.cuda
def test_kernel_call_never_syncs(device):
    """One launch a call and no host sync (no read of a camera scalar):
    it runs under torch.cuda.set_sync_debug_mode("error")."""
    cam = camera("distorted", device=device)
    corners = markers((128, 64), 19, camera("distorted")).to(device)
    pnp.solve_square_pnp(cam, corners, SIZE)  # builds and loads
    torch.cuda.synchronize()
    before = cuda_pnp.solve.launches
    torch.cuda.set_sync_debug_mode("error")
    try:
        res = pnp.solve_square_pnp(cam, corners, SIZE)
        mask = res.err < MAX_REPROJ_PX
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert cuda_pnp.solve.launches == before + 1
    assert bool(mask.any())


@pytest.mark.cuda
def test_run_slam_corners_request_uses_the_kernel(device, tmp_path):
    """A corners request on the card: every marker PnP solved went
    through the kernel."""
    from aruco_slam_tpu_torch.apps import make_synthetic
    from aruco_slam_tpu_torch.apps import run_slam
    from aruco_slam_tpu_torch.io import save_npz
    path = tmp_path / "corners.npz"
    save_npz(path, **make_synthetic.build(frames=8, markers=12,
                                          capacity=16, noise_px=0.5))
    res = run_slam.main(["--input", str(path), "--platform", "cuda",
                         "--capacity", "16",
                         "--trajectory", str(tmp_path / "traj.txt"),
                         "--map", str(tmp_path / "map.txt")])
    c = res.counters
    assert c["front_end.pnp_markers"] == 8 * 16
    assert c["front_end.pnp_kernel_markers"] == c["front_end.pnp_markers"]
