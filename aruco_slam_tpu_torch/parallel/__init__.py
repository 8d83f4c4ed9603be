"""Parallelism: the multi-process runtime and meshes (`dist`), the
landmark-sharded Schur bundle adjustment and its 2-D fleet form
(`sharded_ba`), and many independent filters at once (`multi_slam`,
its stream axis split over a `stream_mesh` of devices): counterpart of
aruco_slam_tpu/parallel on torch.distributed."""

from aruco_slam_tpu_torch.parallel.dist import (
    initialize, make_mesh, make_mesh2d, replicate_to_hosts)
from aruco_slam_tpu_torch.parallel.multi_slam import (
    batched_mekf_scan, stream_mesh)
from aruco_slam_tpu_torch.parallel.sharded_ba import (
    sharded_batch_optimize, sharded_fleet_optimize, stack_graphs)

__all__ = ["make_mesh", "make_mesh2d", "initialize",
           "replicate_to_hosts", "sharded_batch_optimize",
           "sharded_fleet_optimize", "stack_graphs",
           "batched_mekf_scan", "stream_mesh"]
