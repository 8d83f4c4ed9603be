"""Application config: the JAX package's `SlamAppConfig`
(aruco_slam_tpu/config.py) with the same fields and defaults, here so
that the port imports nothing of the JAX package. tests/test_torch_core.py
holds the two equal; the JAX module documents each knob."""

from __future__ import annotations

import dataclasses

import numpy as np


@dataclasses.dataclass
class SlamAppConfig:
    input: str = "sequence.npz"
    filter: str = "mekf"          # mekf | mekf_rotations | factorgraph
    marker_size: float = 0.16     # meters
    capacity: int = 64
    slot_max_age: int = 0
    rescue_cohorts: int = 0
    dict_name: str = "dict_5x5_50"
    track_every: int = 0
    detector: str = "robust"      # robust | fast
    camera_matrix: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [[1414.9, 0.0, 967.0], [0.0, 1414.9, 544.3], [0.0, 0.0, 1.0]]))
    dist_coeffs: np.ndarray = dataclasses.field(
        default_factory=lambda: np.array(
            [0.0614, -0.2951, 0.0005, 0.0029, 0.4387]))
    trajectory_file: str = "outputs/trajectory.txt"
    map_file: str = "outputs/map.txt"
    viz_2d: bool = False
    viz_3d: bool = False
    viz_3d_renderer: str = "mpl"
    viz_dir: str = "outputs/images"
    export_video: bool = False
    max_reproj_px: float = 3.0
    window: int = 8
    window_iters: int = 3
    pose_budget: int = 128
    batch_iters: int = 50
    meas_sigma_t: float = 0.01
    odom_sigma_t: float = 1.0
    odom_sigma_rot: float = 1.0
    mekf_r: float = 0.005
    mekf_q_cam: float = 1.0
    mekf_q_rot: float = 1.0
    mekf_q_lm: float = 0.0
    mekf_motion_model: str = "cv"
    mekf_q_vel: float = 2e-3
    mekf_vel_decay: float = 0.99
    mekf_precision: str = "highest"
    pixel_sigma: float = 1.0
    gate_distance: float = 1.0
    max_obs: int = 0              # 0 = auto-size from the densest frame
    huber_delta: float = 2.0
