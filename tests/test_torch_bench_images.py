"""PyTorch port vs the JAX package: the image benches.

`bench.e2e` and `bench.detect_profile` at a dev scale on the CPU (a few
rendered 1080p frames, a small chunk, one timed call): each JSON row has
the JAX row's keys (less the XLA-cost fields, plus the device), e2e's
detections are run_slam's front end's on the same frames, and its
trajectory the serving route's; the profile's stages are the
detector's and add up to its total.
"""

import numpy as np
import pytest
import torch

from aruco_slam_tpu.bench import synthetic as jsyn
from aruco_slam_tpu_torch.apps import front_end
from aruco_slam_tpu_torch.bench import detect_profile, e2e
from aruco_slam_tpu_torch.bench import pipeline as tpipe
from aruco_slam_tpu_torch.config import SlamAppConfig
from aruco_slam_tpu_torch.filters import MekfConfig, init_state
from aruco_slam_tpu_torch.ops import detect
from aruco_slam_tpu_torch.parallel import multi_slam

torch.set_num_threads(2)

# a stream of the batched filter against its own run on the CPU
# (tests/test_torch_multi.py FLEET_TOL: batched f32 matmuls sum in
# another order)
FLEET_TOL = dict(atol=1e-4, rtol=0.0)
# the JAX row's keys (aruco_slam_tpu/bench/e2e.py:318-346) less
# gflops_per_s / mfu_pct (XLA cost analysis), plus the device
E2E_KEYS = {"metric", "value", "unit", "resolution", "detector",
            "mean_detections_per_frame", "detect_ms_per_frame",
            "pnp_ms_per_frame", "mekf_ms_per_frame", "device"}
E2E_FLEET_KEYS = {"streams", "per_stream_fps", "stage_split"}


@pytest.fixture
def cached(tmp_path, monkeypatch):
    """The benches' rendered frames cached under tmp_path, one timed
    call a bench (REPS 1)."""
    monkeypatch.setattr(e2e, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(e2e, "REPS", 1)
    return tmp_path


def test_e2e_row_detections_and_trajectory(cached):
    """`bench.e2e` on 4 rendered 1080p frames in chunks of 2: JAX's row;
    its detections, gated by reprojection, are what run_slam's front end
    (`front_end.observations_from_frames`, its chunk cut to the 4 frames)
    accepts on the same frames: the same ids a frame, their marker
    positions within 1e-5 m; its trajectory (the chunked detection and
    `make_pipeline`) is the serving route's,
    `multi_slam.batched_image_slam`, within FLEET_TOL."""
    row = e2e.main(["--platform", "cpu", "--frames", "4", "--chunk", "2"])
    assert set(row) == E2E_KEYS
    assert row["value"] > 0 and row["mean_detections_per_frame"] >= 3

    frames = np.load(cached / "aruco_slam_tpu_torch_e2e_orbit_4_10.npz"
                     )["frames"]
    scene = jsyn.make_wall_scene(num_markers=10, seed=0)
    cam = e2e.camera()
    dcfg = detect.DetectorConfig(capacity=e2e.CAPACITY)
    images = torch.from_numpy(frames)
    cs, ms = e2e.detect_sequence(images, dcfg, 2)
    res = tpipe.pnp.solve_square_pnp(cam, cs, scene.marker_size)
    gated = (ms & (res.err < 3.0)).numpy()
    assert row["mean_detections_per_frame"] == round(
        float(ms.sum(1).float().mean()), 2)

    cfg = SlamAppConfig(input="", marker_size=scene.marker_size)
    _, t_cl, _, mask, _, _, slot_ids, _, _ = \
        front_end.observations_from_frames(
            zip(np.arange(4) / 30.0, frames), cam, cfg,
            torch.device("cpu"), chunk=4)
    for i in range(4):
        ids = slot_ids[mask[i]]
        assert sorted(ids.tolist()) == np.nonzero(gated[i])[0].tolist()
        np.testing.assert_allclose(t_cl[i][mask[i]],
                                   res.t_cl[i, ids].numpy(), atol=1e-5)

    fcfg = MekfConfig(capacity=e2e.CAPACITY)
    _, traj = tpipe.make_pipeline(cam, scene.marker_size, fcfg, chunk=2)(
        init_state(fcfg), cs, ms)
    _, ref = multi_slam.batched_image_slam(
        dcfg, fcfg, cam, scene.marker_size, images[None],
        multi_slam.stack_states([init_state(fcfg)]))
    np.testing.assert_allclose(traj.numpy(), ref[0].numpy(), **FLEET_TOL)


def test_e2e_fleet_streaming_row(cached):
    """`--streams 2 --track-every 3 --rescue-cohorts 2` on 3 video-rate
    frames: JAX's fleet row; G not dividing S is JAX's ValueError."""
    row = e2e.main(["--platform", "cpu", "--frames", "3", "--streams", "2",
                    "--track-every", "3", "--rescue-cohorts", "2"])
    assert set(row) == E2E_KEYS | E2E_FLEET_KEYS | {"track_every",
                                                    "rescue_cohorts"}
    assert row["streams"] == 2 and row["stage_split"] == "fleet"
    assert row["mean_detections_per_frame"] >= 3
    with pytest.raises(ValueError, match="must divide"):
        e2e.main(["--platform", "cpu", "--frames", "3", "--streams", "2",
                  "--track-every", "3", "--rescue-cohorts", "3"])


def test_e2e_usage_errors():
    with pytest.raises(SystemExit):
        e2e.main(["--platform", "cpu", "--track-every", "2"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            e2e.main(["--frames", "2"])


def test_detect_profile_stages_sum_to_total(cached):
    """The stages are `candidate_stage_names()` then ``slots+rest``, and
    they add up to the full detector's ms a frame (each rounded to
    1e-3)."""
    row = detect_profile.main(["--platform", "cpu", "--frames", "2",
                               "--reps", "1"])
    stages = list(detect.candidate_stage_names()) + ["slots+rest"]
    assert list(row) == ["metric", "detector", "device", "total_ms",
                         *stages]
    assert row["metric"] == "detect_stage_ms_per_frame"
    total = sum(row[s] for s in stages)
    assert abs(total - row["total_ms"]) <= 1e-3 * (len(stages) + 1)
    row = detect_profile.main(["--platform", "cpu", "--frames", "2",
                               "--reps", "1", "--stages", "none"])
    assert list(row) == ["metric", "detector", "device", "total_ms",
                         "slots+rest"]
