"""PyTorch port vs the JAX package: the bench drivers.

`bench.pipeline.make_pipeline` against the JAX pipeline on the same
corners (the default filter, with the JAX fused update in interpret
mode, which the port's update follows; and the large-map filter in the
XLA-form Newton–Schulz update), its stream axis against a loop over
streams; then `bench.large_map` and `bench.headline` at a dev scale on the CPU:
each JSON row has the JAX row's keys (less the XLA-cost fields, plus
the device). `bench.e2e` and `bench.detect_profile` are
tests/test_torch_bench_images.py's.
"""

import numpy as np
import jax
import jax.numpy as jnp
import pytest
import torch

from aruco_slam_tpu.bench import pipeline as jpipe
from aruco_slam_tpu.bench import synthetic as jsyn
from aruco_slam_tpu.core import camera as jcam
from aruco_slam_tpu.filters import mekf as jm
from aruco_slam_tpu_torch.bench import e2e, headline, large_map
from aruco_slam_tpu_torch.bench import pipeline as tpipe
from aruco_slam_tpu_torch.filters import MekfConfig, init_state
from aruco_slam_tpu_torch.filters import mekf as tm
from aruco_slam_tpu_torch.parallel import multi_slam

torch.set_num_threads(2)

# tests/test_torch_mekf.py's bounds for the port against the JAX filter
TRAJ_TOL = dict(atol=5e-4, rtol=1e-3)
# a stream of the batched filter against its own run on the CPU
# (tests/test_torch_multi.py FLEET_TOL: batched f32 matmuls sum in
# another order)
FLEET_TOL = dict(atol=1e-4, rtol=0.0)

# the JAX rows' keys (aruco_slam_tpu/bench/large_map.py:160-174, the
# root bench.py:123-130 and :240-310) less gflops_per_s / mfu_pct / ba_*
# (XLA cost analysis), plus the device each row names
LARGE_MAP_KEYS = {"metric", "value", "unit", "single_stream_fps", "ate_m",
                  "offline_ba_ate_m", "offline_ba_s", "n_factors",
                  "mean_visible", "state_dim", "device"}
HEADLINE_KEYS = {"metric", "value", "unit", "vs_baseline", "batch",
                 "single_stream_fps", "robust_e2e_fps",
                 "robust_e2e_frames", "streaming_fps",
                 "streaming_track_every", "serving_fps_per_stream",
                 "serving_streams", "large_map_fps", "large_map_ate_m",
                 "ba_lm_iters_per_s", "large_map_bf16_fps",
                 "large_map_bf16_ate_m", "device"}


def _cameras():
    k, d = np.asarray(e2e.K), np.asarray(e2e.DIST)
    jc = jcam.CameraModel.from_matrix(jnp.asarray(k, jnp.float32),
                                      jnp.asarray(d, jnp.float32))
    return jc, e2e.camera()


def _orbit_corners(frames, capacity, markers=8):
    """JAX's synthetic corners (the headline's recipe), f32."""
    jc, _ = _cameras()
    scene = jsyn.make_wall_scene(num_markers=markers, seed=0)
    traj = jsyn.make_orbit_trajectory(num_frames=frames)
    corners, mask = jsyn.observe_corners(scene, traj, jc, capacity,
                                         noise_px=0.3, seed=1)
    return scene, corners.astype(np.float32), mask


def _run_pipelines(jcfg, scene, corners, mask, chunk):
    jc, tc = _cameras()
    jfn = jax.jit(jpipe.make_pipeline(jc, scene.marker_size, jcfg,
                                      chunk=chunk))
    j0 = jm.init_state(jcfg)
    _, jtraj = jfn(j0, jnp.asarray(corners), jnp.asarray(mask))
    tcfg = tm.config_from_jax(jcfg._asdict())
    tfn = tpipe.make_pipeline(tc, scene.marker_size, tcfg, chunk=chunk)
    t0 = tm.state_from_numpy({k: np.asarray(v)
                              for k, v in j0._asdict().items()})
    _, ttraj = tfn(t0, torch.tensor(corners), torch.tensor(mask))
    return np.asarray(jtraj), ttraj.numpy()


def test_make_pipeline_default_config_pads_the_tail():
    """T = 23 frames in chunks of 8 (the tail padded by one frame), C 16,
    the default filter: the trajectory within TRAJ_TOL of JAX's."""
    scene, corners, mask = _orbit_corners(23, 16)
    want, got = _run_pipelines(jm.MekfConfig(capacity=16,
                                             pallas_update=True),
                               scene, corners, mask, chunk=8)
    assert got.shape == (23, 7) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


def test_make_pipeline_large_map_config():
    """The large-map filter (`bench.large_map.filter_config`: XLA-form
    Newton–Schulz update, cv model, gate) on its raster survey cut to 24
    markers and 24 frames, max_obs 16: within TRAJ_TOL of JAX's."""
    _, tc = _cameras()
    scene, _, corners, mask = large_map.survey(24, 24, tc)
    tcfg = large_map.filter_config(24, 16, "mixed", "f32")
    jcfg = jm.MekfConfig(capacity=24, max_obs=16, pallas_update=False,
                         s_solver="ns", pixel_sigma=0.3, gate_distance=1.5,
                         motion_model="cv", vel_decay=0.99,
                         matmul_precision="mixed")
    assert tm.config_from_jax(jcfg._asdict()) == tcfg
    want, got = _run_pipelines(jcfg, scene, corners.astype(np.float32),
                               mask, chunk=16)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **TRAJ_TOL)


def test_make_pipeline_streams_match_a_loop():
    """Three streams through one call (stacked states, one PnP call a
    chunk for all, one filter step a frame) against each stream alone:
    FLEET_TOL."""
    scene, corners, mask = _orbit_corners(10, 16)
    rng = np.random.default_rng(7)
    cs = (corners[None] + rng.normal(0, 0.3, (3,) + corners.shape)
          ).astype(np.float32)
    _, tc = _cameras()
    fcfg = MekfConfig(capacity=16)
    fn = tpipe.make_pipeline(tc, scene.marker_size, fcfg, chunk=4)
    states = multi_slam.stack_states([init_state(fcfg)] * 3)
    _, trajs = fn(states, torch.tensor(cs),
                  torch.tensor(mask).expand(3, *mask.shape))
    assert trajs.shape == (3, 10, 7)
    for s in range(3):
        _, one = fn(init_state(fcfg), torch.tensor(cs[s]),
                    torch.tensor(mask))
        np.testing.assert_allclose(trajs[s].numpy(), one.numpy(),
                                   **FLEET_TOL)


@pytest.fixture
def cached(tmp_path, monkeypatch):
    """The benches' rendered frames cached under tmp_path, one timed
    call a bench (REPS 1)."""
    monkeypatch.setattr(e2e, "CACHE_DIR", tmp_path)
    monkeypatch.setattr(e2e, "REPS", 1)
    return tmp_path


def test_large_map_row_and_ate():
    """`bench.large_map` at the JAX package's dev size (96 markers, 160
    frames, batch 2; its 64-frame docstring example sweeps the raster so
    fast that JAX's filter too ends 0.85 m off): JAX's row, the filter's
    ATE under 0.3 m, the state dimension 9 + 3·96, a finite batch-LM
    solve."""
    row = large_map.main(["--platform", "cpu", "--markers", "96",
                          "--frames", "160", "--batch", "2", "--reps",
                          "1"])
    assert set(row) == LARGE_MAP_KEYS
    assert row["state_dim"] == 9 + 3 * 96
    assert row["ate_m"] < 0.3
    assert np.isfinite(row["offline_ba_ate_m"]) and row["offline_ba_s"] > 0


def test_headline_row(cached, monkeypatch):
    """`bench.headline` cut to 8 frames, 2 sequences and tiny ride-along
    runs: JAX's row, every field measured."""
    for name, value in (("FRAMES", 8), ("BATCH", 2), ("CHUNK", 4),
                        ("SINGLE_REPS", 1), ("BATCH_REPS", 1),
                        ("E2E_FRAMES", 2), ("SERVING_FRAMES", 2),
                        ("SERVING_STREAMS", 2),
                        ("LARGE_MAP_ARGS", ("--reps", "1", "--markers",
                                            "24", "--frames", "16",
                                            "--batch", "2", "--max-obs",
                                            "16"))):
        monkeypatch.setattr(headline, name, value)
    row = headline.main(["--platform", "cpu"])
    assert set(row) == HEADLINE_KEYS
    assert row["batch"] == 2 and row["serving_streams"] == 2
    assert row["vs_baseline"] == round(row["value"]
                                       / headline.REFERENCE_FPS, 2)
    assert all(np.isfinite(v) for v in row.values()
               if isinstance(v, float))


class _Parsed(Exception):
    pass


def _parser_of(main, monkeypatch):
    """The argparse parser ``main`` builds, caught at its parse_args."""
    import argparse
    seen = []

    def catch(self, args=None, namespace=None):
        seen.append(self)
        raise _Parsed

    monkeypatch.setattr(argparse.ArgumentParser, "parse_args", catch)
    with pytest.raises(_Parsed):
        main([])
    monkeypatch.undo()
    return seen[0]


def _flags(parser) -> dict:
    return {a.option_strings[0]: (a.dest, a.default, a.choices, a.type,
                                  a.const, a.nargs, a.metavar)
            for a in parser._actions if a.option_strings
            and a.dest != "help"}


@pytest.mark.parametrize("name", ["e2e", "detect_profile", "large_map"])
def test_bench_flags_match_jax(name, monkeypatch):
    """Every JAX flag of the bench, with its default, choices and type;
    --platform is the port's: cuda | cpu, cuda by default."""
    import importlib
    jax_main = importlib.import_module(f"aruco_slam_tpu.bench.{name}").main
    port_main = importlib.import_module(
        f"aruco_slam_tpu_torch.bench.{name}").main
    want = _flags(_parser_of(jax_main, monkeypatch))
    got = _flags(_parser_of(port_main, monkeypatch))
    assert want.pop("--platform")[1] is None
    dest, default, choices = got.pop("--platform")[:3]
    assert (dest, default, list(choices)) == ("platform", "cuda",
                                              ["cuda", "cpu"])
    assert got == want
