// Shared helpers for the plain-C kernel entry points.
#pragma once

#include <cuda_runtime.h>

// Return the first launch error to the caller (the Python wrapper
// raises on any nonzero code): a refused launch never runs, and a
// later synchronize would not report it.
#define ARUCO_LAUNCH_CHECK()                                   \
    do {                                                       \
        cudaError_t err_ = cudaGetLastError();                 \
        if (err_ != cudaSuccess) return static_cast<int>(err_); \
    } while (0)

static inline unsigned int aruco_blocks(long long n, int threads) {
    return static_cast<unsigned int>((n + threads - 1) / threads);
}
