// Error-code text for the Python wrappers (aruco_slam_tpu_torch/_build.py).
#include <cuda_runtime.h>

extern "C" const char* aruco_error_string(int code) {
    return cudaGetErrorString(static_cast<cudaError_t>(code));
}
