// Subpixel corner refinement (cv2.cornerSubPix's structure-tensor
// fixed point), fused with the patch gather and the gradients.
//
// Replaces the TPU kernel aruco_slam_tpu/ops/pallas_subpix.py
// `_gather_kernel` (+ `_iterate`, wrapper `refine_corners_fused`).
// Same math as ops/detect.py `_subpix_refine`: for each corner gather a
// p x p patch (p = 2 rad + 1) centred at clip(round(c), rad, size-rad-1),
// take central-difference gradients with a zeroed border and the
// projection gx*px + gy*py, then run the coarse-to-fine schedule: a
// Gaussian window at the rounded estimate, the five structure-tensor
// sums, a 2x2 solve when |det| > 1e-9, a clip to +-half of the
// previous estimate and then to +-drift.
//
// What bounds it on Hopper: latency, not bytes or FLOPs. The detector
// refines 384 corners per 1080p frame (~0.3 MB of patch reads and a
// few MFLOP); the schedule is 10 dependent iterations, each ending in a
// reduction. Design: one block per (frame, corner); the patch, gx, gy
// and proj stay in shared memory (4 x 729 x 4 B at p = 27) for the
// whole schedule, so the image is read once; each iteration is one
// pass over the patch and five block reductions (warp shuffles, then
// one shared-memory exchange that every thread sums in the same order,
// so all threads hold identical sums and step the estimate in lockstep
// without a broadcast).
//
// Rounding follows jnp.round (half to even: rintf) and the exponential
// is the accurate expf, never __expf (no --use_fast_math).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kMaxStages = 4;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

struct Schedule {
    int stages;
    int half[kMaxStages];
    int iters[kMaxStages];
    float sigma2[kMaxStages];
    float drift[kMaxStages];
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
subpix_kernel(const T* __restrict__ image,
              const float* __restrict__ corners,
              float* __restrict__ out, int n, int h, int w, int rad,
              Schedule sched) {
    extern __shared__ float smem[];
    __shared__ float red[kWarps][5];
    const int p = 2 * rad + 1;
    const int pp = p * p;
    float* patch = smem;
    float* gx = smem + pp;
    float* gy = smem + 2 * pp;
    float* proj = smem + 3 * pp;

    const int corner = blockIdx.x;
    const int frame = blockIdx.y;
    const int tid = threadIdx.x;
    const long long ci = (static_cast<long long>(frame) * n + corner) * 2;
    const float c_x = corners[ci];
    const float c_y = corners[ci + 1];
    const int cx0 = min(max(static_cast<int>(rintf(c_x)), rad), w - rad - 1);
    const int cy0 = min(max(static_cast<int>(rintf(c_y)), rad), h - rad - 1);

    const T* img = image + static_cast<long long>(frame) * h * w;
    for (int j = tid; j < pp; j += kThreads) {
        int r = j / p;
        int c = j - r * p;
        patch[j] = static_cast<float>(
            img[static_cast<long long>(cy0 - rad + r) * w + (cx0 - rad + c)]);
    }
    __syncthreads();
    for (int j = tid; j < pp; j += kThreads) {
        int r = j / p;
        int c = j - r * p;
        bool interior = r >= 1 && r <= p - 2 && c >= 1 && c <= p - 2;
        float vx = interior ? 0.5f * (patch[j + 1] - patch[j - 1]) : 0.0f;
        float vy = interior ? 0.5f * (patch[j + p] - patch[j - p]) : 0.0f;
        gx[j] = vx;
        gy[j] = vy;
        proj[j] = vx * static_cast<float>(c - rad)
                  + vy * static_cast<float>(r - rad);
    }
    __syncthreads();

    const float lim = static_cast<float>(rad - 1);
    float cx = clampf(c_x - static_cast<float>(cx0), -lim, lim);
    float cy = clampf(c_y - static_cast<float>(cy0), -lim, lim);
    const int lane = tid & 31;
    const int warp = tid >> 5;

    for (int s = 0; s < sched.stages; ++s) {
        const float half = static_cast<float>(sched.half[s]);
        const float sigma2 = sched.sigma2[s];
        const float drift = sched.drift[s];
        for (int it = 0; it < sched.iters[s]; ++it) {
            const float wx = rintf(cx);
            const float wy = rintf(cy);
            float acc[5] = {0.f, 0.f, 0.f, 0.f, 0.f};
            for (int j = tid; j < pp; j += kThreads) {
                int r = j / p;
                int c = j - r * p;
                float dx = static_cast<float>(c - rad) - wx;
                float dy = static_cast<float>(r - rad) - wy;
                float inside = (fabsf(dx) <= half && fabsf(dy) <= half)
                                   ? 1.0f : 0.0f;
                float wgt = inside * expf(-0.5f * (dx * dx + dy * dy)
                                          / sigma2);
                float wgx = wgt * gx[j];
                float wgy = wgt * gy[j];
                acc[0] += wgx * gx[j];
                acc[1] += wgx * gy[j];
                acc[2] += wgy * gy[j];
                acc[3] += wgx * proj[j];
                acc[4] += wgy * proj[j];
            }
#pragma unroll
            for (int q = 0; q < 5; ++q) {
                float v = acc[q];
                for (int off = 16; off > 0; off >>= 1)
                    v += __shfl_down_sync(0xffffffffu, v, off);
                if (lane == 0) red[warp][q] = v;
            }
            __syncthreads();
            float sum[5];
#pragma unroll
            for (int q = 0; q < 5; ++q) {
                float v = 0.f;
                for (int k = 0; k < kWarps; ++k) v += red[k][q];
                sum[q] = v;
            }
            __syncthreads();  // red is rewritten next iteration
            const float wxx = sum[0], wxy = sum[1], wyy = sum[2];
            const float bx = sum[3], by = sum[4];
            const float det = wxx * wyy - wxy * wxy;
            const bool ok = fabsf(det) > 1e-9f;
            float nx = ok ? (wyy * bx - wxy * by) / det : cx;
            float ny = ok ? (wxx * by - wxy * bx) / det : cy;
            nx = clampf(nx, cx - half, cx + half);
            ny = clampf(ny, cy - half, cy + half);
            cx = clampf(nx, -drift, drift);
            cy = clampf(ny, -drift, drift);
        }
    }
    if (tid == 0) {
        out[ci] = cx + static_cast<float>(cx0);
        out[ci + 1] = cy + static_cast<float>(cy0);
    }
}

template <typename T>
int launch(const T* image, const float* corners, float* out, int frames,
           int n, int h, int w, int rad, const int* half,
           const int* iters, const float* sigma2, const float* drift,
           int stages, cudaStream_t stream) {
    if (stages < 1 || stages > kMaxStages)
        return static_cast<int>(cudaErrorInvalidValue);
    if (frames == 0 || n == 0) return 0;
    Schedule s{};
    s.stages = stages;
    for (int k = 0; k < stages; ++k) {
        s.half[k] = half[k];
        s.iters[k] = iters[k];
        s.sigma2[k] = sigma2[k];
        s.drift[k] = drift[k];
    }
    const int p = 2 * rad + 1;
    const size_t shmem = 4 * static_cast<size_t>(p) * p * sizeof(float);
    if (shmem > 48 * 1024) {
        cudaFuncSetAttribute(subpix_kernel<T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(shmem));
        ARUCO_LAUNCH_CHECK();
    }
    dim3 grid(n, frames);
    subpix_kernel<T><<<grid, kThreads, shmem, stream>>>(
        image, corners, out, n, h, w, rad, s);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

}  // namespace

// image: (frames, h, w) uint8 or f32; corners/out: (frames, n, 2) f32
// pixel (x, y). half/iters/sigma2/drift: host arrays of `stages`
// entries, precomputed exactly as ops/detect.py `_subpix_refine` does.
extern "C" int subpix_refine_u8(const uint8_t* image, const float* corners,
                                float* out, int frames, int n, int h,
                                int w, int rad, const int* half,
                                const int* iters, const float* sigma2,
                                const float* drift, int stages,
                                cudaStream_t stream) {
    return launch<uint8_t>(image, corners, out, frames, n, h, w, rad, half,
                           iters, sigma2, drift, stages, stream);
}

extern "C" int subpix_refine_f32(const float* image, const float* corners,
                                 float* out, int frames, int n, int h,
                                 int w, int rad, const int* half,
                                 const int* iters, const float* sigma2,
                                 const float* drift, int stages,
                                 cudaStream_t stream) {
    return launch<float>(image, corners, out, frames, n, h, w, rad, half,
                         iters, sigma2, drift, stages, stream);
}
