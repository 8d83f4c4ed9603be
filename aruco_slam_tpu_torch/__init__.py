"""aruco_slam_tpu_torch — the marker-SLAM engine on PyTorch and CUDA.

A second implementation of `aruco_slam_tpu` (the JAX/Pallas package,
which stays the reference) for one NVIDIA Hopper GPU. Same layout and
function names as the JAX package:

* ``core``     — quaternion, SO(3) and pinhole-camera math on tensors.
* ``ops``      — IPPE-square PnP and the image-domain ArUco detector;
                 ``cuda_cc`` / ``cuda_subpix`` wrap the hand-written
                 labeling and subpixel kernels.
* ``filters``  — the MEKF; ``cuda_mekf`` wraps the fused update kernel.
* ``graph``    — the factor graph: windowed and batch Levenberg-Marquardt
                 bundle adjustment with a dense Schur complement.
* ``bench``    — numpy fixtures (synthetic scenes, the renderer), ATE and
                 the online factor-graph benchmark.
* ``apps``     — the ``run_slam`` and ``run_offline`` CLIs; ``config`` and
                 ``io`` hold the JAX package's app config and file formats.

Every kernel lives in ``csrc/`` as CUDA C++ for sm_90a, is built with
nvcc on first use (``_build``) and is called through ctypes. A kernel
wrapper launches its kernel for a CUDA tensor and runs the plain
PyTorch version of the same function for a CPU tensor; nothing falls
back from one to the other.

This package imports no jax and nothing of `aruco_slam_tpu`: it keeps
its own copies of the small JAX-free pieces it needs (app config, file
formats, the video decoder ``io.VideoSource``, ATE) and ships its own
dictionary tables in ``ops/data/*.npy``, all held equal to the JAX
package's by tests.
"""

from aruco_slam_tpu_torch import _device

_device.pin_precision()

__version__ = "0.1.0"
