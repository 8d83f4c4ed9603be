// Subpixel corner refinement (cv2.cornerSubPix's structure-tensor
// fixed point): two entry points over one device loop.
//
// Replaces two TPU kernels of aruco_slam_tpu/ops/pallas_subpix.py that
// share `_iterate`:
//  * `_gather_kernel` (wrapper `refine_corners_fused`): patch gather
//    from the frame, gradients and the schedule, fused
//    (subpix_refine_u8 / subpix_refine_f32 here);
//  * `_kernel` (wrapper `refine_offsets`): the schedule on patches the
//    caller already gathered (subpix_offsets here).
// Same math as ops/detect.py `_subpix_refine`: for each corner a p x p
// patch (p = 2 rad + 1) centred at clip(round(c), rad, size-rad-1),
// central-difference gradients with a zeroed border and the projection
// gx*px + gy*py, then the coarse-to-fine schedule: a Gaussian window at
// the rounded estimate, the five structure-tensor sums, a 2x2 solve
// when |det| > 1e-9, a clip to +-half of the previous estimate and then
// to +-drift. The zeroed border gives the same sums as the reference's
// interior-only (p-2)^2 grid: every term is a product with gx or gy.
//
// What bounds it on Hopper: latency, not bytes or FLOPs. The detector
// refines 384 corners per 1080p frame (~0.3 MB of patch reads and a
// few MFLOP); the schedule is 10 dependent iterations, each ending in a
// reduction. Design: one block per corner; the patch, gx, gy and proj
// stay in shared memory (4 x p^2 x 4 B: 11.7 KB at p = 27, 19.6 KB at
// the tracker's p = 35) for the whole schedule, so the input is read
// once; each iteration (`iterate`, shared by both kernels) is one pass
// over the patch and five block reductions (warp shuffles, then one
// shared-memory exchange that every thread sums in the same order, so
// all threads hold identical sums and step the estimate in lockstep
// without a broadcast).
//
// Rounding follows jnp.round (half to even: rintf), the exponential
// is the accurate expf, never __expf (no --use_fast_math), and the
// products of the projection and of the 2x2 solve are rounded one by
// one (__fmul_rn / __fsub_rn: nvcc would otherwise fuse them into FMAs),
// so an exactly singular structure tensor stays singular.
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

// Gradients with a zeroed border and the projection, from the p x p
// patch already in shared memory.
__device__ void gradients(const float* patch, float* gx, float* gy,
                          float* proj, int p, int rad) {
    const int pp = p * p;
    for (int j = threadIdx.x; j < pp; j += kThreads) {
        int r = j / p;
        int c = j - r * p;
        bool interior = r >= 1 && r <= p - 2 && c >= 1 && c <= p - 2;
        float vx = interior ? 0.5f * (patch[j + 1] - patch[j - 1]) : 0.0f;
        float vy = interior ? 0.5f * (patch[j + p] - patch[j - p]) : 0.0f;
        gx[j] = vx;
        gy[j] = vy;
        proj[j] = __fadd_rn(__fmul_rn(vx, static_cast<float>(c - rad)),
                            __fmul_rn(vy, static_cast<float>(r - rad)));
    }
    __syncthreads();
}

// The refinement schedule from offset (cx, cy) relative to the patch
// centre; every thread of the block returns the same result.
__device__ void iterate(const float* gx, const float* gy, const float* proj,
                        int p, int rad, const Schedule& sched, float& cx,
                        float& cy) {
    __shared__ float red[kWarps][5];
    const int pp = p * p;
    const int tid = threadIdx.x;
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
            // no FMA contraction: on an exactly rank-1 tensor (a 45°
            // edge: gx == gy everywhere, so wxx == wxy == wyy) the
            // rounded products cancel to det == 0 as in the reference,
            // where fma(wxx, wyy, -wxy*wxy) leaves the rounding error
            // of wxy*wxy, passes the 1e-9 test and jumps by +-half
            const float det = __fsub_rn(__fmul_rn(wxx, wyy),
                                        __fmul_rn(wxy, wxy));
            const bool ok = fabsf(det) > 1e-9f;
            float nx = ok ? __fsub_rn(__fmul_rn(wyy, bx), __fmul_rn(wxy, by))
                                / det
                          : cx;
            float ny = ok ? __fsub_rn(__fmul_rn(wxx, by), __fmul_rn(wxy, bx))
                                / det
                          : cy;
            nx = clampf(nx, cx - half, cx + half);
            ny = clampf(ny, cy - half, cy + half);
            cx = clampf(nx, -drift, drift);
            cy = clampf(ny, -drift, drift);
        }
    }
}

// One block per (corner, frame): gather, gradients, schedule.
template <typename T>
__global__ void __launch_bounds__(kThreads)
subpix_kernel(const T* __restrict__ image,
              const float* __restrict__ corners,
              float* __restrict__ out, int n, int h, int w, int rad,
              Schedule sched) {
    extern __shared__ float smem[];
    const int p = 2 * rad + 1;
    const int pp = p * p;
    float* patch = smem;

    const int corner = blockIdx.x;
    const int frame = blockIdx.y;
    const long long ci = (static_cast<long long>(frame) * n + corner) * 2;
    const float c_x = corners[ci];
    const float c_y = corners[ci + 1];
    const int cx0 = min(max(static_cast<int>(rintf(c_x)), rad), w - rad - 1);
    const int cy0 = min(max(static_cast<int>(rintf(c_y)), rad), h - rad - 1);

    const T* img = image + static_cast<long long>(frame) * h * w;
    for (int j = threadIdx.x; j < pp; j += kThreads) {
        int r = j / p;
        int c = j - r * p;
        patch[j] = static_cast<float>(
            img[static_cast<long long>(cy0 - rad + r) * w + (cx0 - rad + c)]);
    }
    __syncthreads();
    gradients(patch, smem + pp, smem + 2 * pp, smem + 3 * pp, p, rad);

    const float lim = static_cast<float>(rad - 1);
    float cx = clampf(c_x - static_cast<float>(cx0), -lim, lim);
    float cy = clampf(c_y - static_cast<float>(cy0), -lim, lim);
    iterate(smem + pp, smem + 2 * pp, smem + 3 * pp, p, rad, sched, cx, cy);
    if (threadIdx.x == 0) {
        out[ci] = cx + static_cast<float>(cx0);
        out[ci + 1] = cy + static_cast<float>(cy0);
    }
}

// One block per patch: gradients and schedule on a gathered (p, p)
// f32 patch from start offset c0 (relative to the patch centre).
__global__ void __launch_bounds__(kThreads)
offsets_kernel(const float* __restrict__ patches,
               const float* __restrict__ c0, float* __restrict__ out,
               int rad, Schedule sched) {
    extern __shared__ float smem[];
    const int p = 2 * rad + 1;
    const int pp = p * p;
    const long long i = blockIdx.x;
    const float* src = patches + i * pp;
    for (int j = threadIdx.x; j < pp; j += kThreads) smem[j] = src[j];
    __syncthreads();
    gradients(smem, smem + pp, smem + 2 * pp, smem + 3 * pp, p, rad);
    float cx = c0[2 * i];
    float cy = c0[2 * i + 1];
    iterate(smem + pp, smem + 2 * pp, smem + 3 * pp, p, rad, sched, cx, cy);
    if (threadIdx.x == 0) {
        out[2 * i] = cx;
        out[2 * i + 1] = cy;
    }
}

int make_schedule(Schedule* s, const int* half, const int* iters,
                  const float* sigma2, const float* drift, int stages) {
    if (stages < 1 || stages > kMaxStages)
        return static_cast<int>(cudaErrorInvalidValue);
    *s = Schedule{};
    s->stages = stages;
    for (int k = 0; k < stages; ++k) {
        s->half[k] = half[k];
        s->iters[k] = iters[k];
        s->sigma2[k] = sigma2[k];
        s->drift[k] = drift[k];
    }
    return 0;
}

// Dynamic shared memory of either kernel: patch, gx, gy, proj.
template <typename K>
int set_shmem(K kernel, int rad, size_t* shmem) {
    const size_t p = 2 * static_cast<size_t>(rad) + 1;
    *shmem = 4 * p * p * sizeof(float);
    if (*shmem > 48 * 1024) {
        cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(*shmem));
        ARUCO_LAUNCH_CHECK();
    }
    return 0;
}

template <typename T>
int launch(const T* image, const float* corners, float* out, int frames,
           int n, int h, int w, int rad, const int* half,
           const int* iters, const float* sigma2, const float* drift,
           int stages, cudaStream_t stream) {
    Schedule s;
    int err = make_schedule(&s, half, iters, sigma2, drift, stages);
    if (err) return err;
    if (frames == 0 || n == 0) return 0;
    size_t shmem;
    err = set_shmem(subpix_kernel<T>, rad, &shmem);
    if (err) return err;
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

// patches: (n, p, p) f32 with p = 2 rad + 1; c0/out: (n, 2) f32 offsets
// from the patch centre. Schedule arrays as above.
extern "C" int subpix_offsets(const float* patches, const float* c0,
                              float* out, int n, int rad, const int* half,
                              const int* iters, const float* sigma2,
                              const float* drift, int stages,
                              cudaStream_t stream) {
    Schedule s;
    int err = make_schedule(&s, half, iters, sigma2, drift, stages);
    if (err) return err;
    if (n == 0) return 0;
    size_t shmem;
    err = set_shmem(offsets_kernel, rad, &shmem);
    if (err) return err;
    offsets_kernel<<<n, kThreads, shmem, stream>>>(patches, c0, out, rad, s);
    ARUCO_LAUNCH_CHECK();
    return 0;
}
