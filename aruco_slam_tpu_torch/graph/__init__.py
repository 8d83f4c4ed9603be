"""Factor-graph backend: batched Gauss-Newton / Levenberg-Marquardt
bundle adjustment with dense Schur-complement elimination (counterpart
of aruco_slam_tpu/graph): fixed-capacity factor storage, residuals and
closed-form Jacobian blocks batched over factors, dense normal equations,
landmarks eliminated by a dense Schur complement and the reduced camera
system solved by Cholesky. Incremental smoothing is the warm-started
sliding-window LM (`optimize_window`); batch smoothing the same solve
over every pose (`batch_optimize`)."""

from aruco_slam_tpu_torch.graph.ba import (
    GraphConfig,
    GraphState,
    add_frame,
    batch_optimize,
    init_graph,
    landmark_covariances,
    marginalize_poses,
    optimize_window,
    state_from_numpy,
    state_to_numpy,
)

__all__ = [
    "GraphConfig",
    "GraphState",
    "add_frame",
    "batch_optimize",
    "init_graph",
    "landmark_covariances",
    "marginalize_poses",
    "optimize_window",
    "state_from_numpy",
    "state_to_numpy",
]
