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
// central-difference gradients on the interior and the projection
// gx*px + gy*py, then the coarse-to-fine schedule: a Gaussian window at
// the rounded estimate, the five structure-tensor sums, a 2x2 solve
// when |det| > 1e-9, a clip to +-half of the previous estimate and then
// to +-drift.
//
// What bounds it on Hopper: latency. The work is small (per corner ~6
// flops a patch pixel for the gradients and ~12 a window pixel an
// iteration: 18 kFLOP and 745 bytes at the detector's p = 27), and the
// schedule is 10 dependent iterations, each ending in a reduction and a
// 2x2 solve. Design:
//  * One warp per corner, several corners a block: 8 once a launch has
//    kWideLaunch corners (about a block of 8 for each of the H100's 132
//    SMs), else 4, so that a tracker pull of <= 64 corners spreads over
//    more SMs (on the H100, 8 took less device time at 32 frames x 384
//    corners and 4 at one frame x 64: PERF.md). After the block has
//    built the weight tables (the one __syncthreads), a warp never waits
//    on another: __syncwarp only.
//  * Staging: the warp gathers its patch in row-major order, lanes 32
//    elements apart (no divide an element), 24 loads in flight a lane
//    (one after another, the 23-39 loads of a lane would each wait out
//    the device memory's latency), into its proj slice of shared
//    memory. One pass then computes gx, gy and the projection on the
//    interior [1, p-2]^2, the projection in place: lanes across
//    columns, three rows in registers, horizontal neighbours by
//    shuffles (3 x p^2 x 4 B a warp: 8.7 KB at p = 27, 14.7 KB at the
//    tracker's p = 35; any patch whose slice and the tables fit in the
//    227 KB of shared memory, p <= 139). The kernels are built for 1, 2
//    and 5 column chunks a lane (p <= 32, 64, 160), and a launch takes
//    the fewest that cover its patch: the registers of the widest would
//    slow the narrow patches the detector and the tracker use.
//  * A weight table per stage: wx = rint(cx) is integer-valued, so the
//    offsets dx = c - rad - wx and dy of a window pixel are exact
//    integers in [-half, half] and the Gaussian weight takes only
//    (2 half + 1)^2 values a stage. The block computes them once, with
//    the expression the reference evaluates per pixel, so the loop has
//    no expf and no window test.
//  * Only the window's pixels: lane (lr, lc) of a stage with window
//    width ww = 2 half + 1 <= 32 takes column lc and rows lr,
//    lr + 32/ww, ... of the window; a wider window (any half >= 0 is
//    taken) puts the lanes across its columns lc, lc + 32, ... and walks
//    every row (169 pixel terms at half 6 and 49 at half 3, in place of
//    all 729 of the patch), clamped to the gradient interior
//    [1, p-2]. A dropped term is an exact zero of the reference's sum:
//    outside the window its weight is 0, and off the interior there is
//    no gradient. The clamp binds only on the first iteration of the
//    first stage, whose start may sit +-(rad - 1) from the centre (the
//    start clip). Every later estimate is clipped to the drift D of its
//    stage or of the stage before, and rint(c) <= D since D is an
//    integer; `cuda_subpix.schedule_params` makes drift + half <= rad - 1
//    for the same stage (drift <= rad - half - 1) and for the next one
//    (drift_s <= cum_s and cum_s + 2 half_{s+1} + 1 <= rad), so the
//    window [rad + rint(c) - half, rad + rint(c) + half] lies in [1, p-2].
//  * The five sums reduce by xor butterflies: float addition is
//    commutative, so every lane ends with the same bits and steps the
//    estimate in lockstep without a broadcast.
//
// Rounding follows jnp.round (half to even: rintf), the exponential
// is the accurate expf, never __expf (no --use_fast_math), and the
// products of the projection and of the 2x2 solve are rounded one by
// one (__fmul_rn / __fsub_rn: nvcc would otherwise fuse them into FMAs),
// so an exactly singular structure tensor stays singular.
#include <algorithm>
#include <cstdint>
#include <type_traits>

#include "common.cuh"

namespace {

constexpr int kMaxStages = 4;
constexpr unsigned kFull = 0xffffffffu;
constexpr int kLoadBatch = 24;          // staging loads in flight a lane
constexpr int kMaxChunks = 5;           // columns a lane: p <= 160, more
                                        // than shared memory holds
constexpr long long kWideLaunch = 1024; // corners: 8 warps a block
constexpr size_t kMaxSmem = 227 * 1024;

struct Schedule {
    int stages;
    int half[kMaxStages];
    int iters[kMaxStages];
    float sigma2[kMaxStages];
    float drift[kMaxStages];
    int table[kMaxStages];   // offset of each stage's weight table
    int table_floats;        // all stages' tables
};

__device__ __forceinline__ float clampf(float v, float lo, float hi) {
    return fminf(fmaxf(v, lo), hi);
}

// Every stage's (2 half + 1)^2 window weights, by the whole block.
__device__ __forceinline__ void build_tables(float* tab, const Schedule& s) {
#pragma unroll
    for (int st = 0; st < kMaxStages; ++st) {
        if (st >= s.stages) continue;
        const int h = s.half[st];
        const int ww = 2 * h + 1;
        for (int k = threadIdx.x; k < ww * ww; k += blockDim.x) {
            const int i = k / ww;
            const float dy = static_cast<float>(i - h);
            const float dx = static_cast<float>(k - i * ww - h);
            tab[s.table[st] + k] =
                expf(-0.5f * (dx * dx + dy * dy) / s.sigma2[st]);
        }
    }
}

// Copy a p x p patch (row stride `stride` elements) into dst (p x p
// f32). Lanes walk it in row-major order, 32 elements apart: the lane's
// first (row, column) costs one divide, every later one an add and a
// subtraction or two. kLoadBatch loads are in flight a lane, converted
// to f32 only once all have been issued.
template <typename T>
__device__ void stage(const T* __restrict__ src, int stride, int p,
                      float* dst, int lane) {
    const int pp = p * p;
    int r = lane / p;
    int c = lane - r * p;
    for (int j0 = lane; j0 < pp; j0 += 32 * kLoadBatch) {
        T v[kLoadBatch];
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
            if (j0 + 32 * b < pp) v[b] = src[r * stride + c];
            c += 32;
            while (c >= p) {
                c -= p;
                ++r;
            }
        }
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
            if (j0 + 32 * b < pp)
                dst[j0 + 32 * b] = static_cast<float>(v[b]);
        }
    }
    __syncwarp();
}

// gx, gy and the projection on the interior [1, p-2]^2 in one pass over
// the patch staged in `proj` (p <= 32 C): lanes across columns (column
// lane + 32 k, k < C),
// the rows above, at and below r in registers, the left and right
// neighbours by shuffles. A lane reads from shared memory only its own
// columns, each row once (a step before it overwrites that row with the
// projection), and its neighbours' values come from registers, so the
// projection can take the patch's place. The ring is left as it is and
// never read.
template <int C>
__device__ void gradients(float* gx, float* gy, float* proj, int p, int rad,
                          int lane) {
    float up[C], cur[C], dn[C];
#pragma unroll
    for (int k = 0; k < C; ++k) {
        const int c = lane + 32 * k;
        up[k] = c < p ? proj[c] : 0.f;
        cur[k] = c < p ? proj[p + c] : 0.f;
    }
#pragma unroll 2
    for (int r = 1; r <= p - 2; ++r) {
        const float fy = static_cast<float>(r - rad);
#pragma unroll
        for (int k = 0; k < C; ++k) {
            const int c = lane + 32 * k;
            dn[k] = c < p ? proj[(r + 1) * p + c] : 0.f;
        }
#pragma unroll
        for (int k = 0; k < C; ++k) {
            if (32 * k >= p) continue;  // warp-uniform
            float left = __shfl_up_sync(kFull, cur[k], 1);
            float right = __shfl_down_sync(kFull, cur[k], 1);
            if (k > 0) {  // across the chunk boundary
                const float l = __shfl_sync(kFull, cur[k ? k - 1 : 0], 31);
                if (lane == 0) left = l;
            }
            if (k + 1 < C && 32 * (k + 1) < p) {
                const float rt = __shfl_sync(
                    kFull, cur[k + 1 < C ? k + 1 : k], 0);
                if (lane == 31) right = rt;
            }
            const int c = lane + 32 * k;
            if (c >= 1 && c <= p - 2) {
                const int j = r * p + c;
                const float vx = 0.5f * (right - left);
                const float vy = 0.5f * (dn[k] - up[k]);
                gx[j] = vx;
                gy[j] = vy;
                proj[j] = __fadd_rn(
                    __fmul_rn(vx, static_cast<float>(c - rad)),
                    __fmul_rn(vy, fy));
            }
        }
#pragma unroll
        for (int k = 0; k < C; ++k) {
            up[k] = cur[k];
            cur[k] = dn[k];
        }
    }
    __syncwarp();
}

// Add this lane's rows lr, lr + step, ... (from i0 to i1) of window
// column k to the five sums.
__device__ __forceinline__ void add_column(
        const float* gx, const float* gy, const float* proj, const float* tab,
        int p, int ww, int ox, int oy, int k, int lr, int step, int i0,
        int i1, float& a0, float& a1, float& a2, float& a3, float& a4) {
#pragma unroll 4
    for (int i = lr; i <= i1; i += step) {
        if (i < i0) continue;
        const int j = (oy + i) * p + ox + k;
        const float wgt = tab[i * ww + k];
        const float g_x = gx[j];
        const float g_y = gy[j];
        const float pj = proj[j];
        const float wgx = wgt * g_x;
        const float wgy = wgt * g_y;
        a0 += wgx * g_x;
        a1 += wgx * g_y;
        a2 += wgy * g_y;
        a3 += wgx * pj;
        a4 += wgy * pj;
    }
}

// The refinement schedule from offset (cx, cy) relative to the patch
// centre, by one warp; every lane returns the same result. A window
// wider than the warp comes only with a patch wider than 64 (2 half + 1
// <= rad), so only the kMaxChunks kernels walk window columns.
template <int C>
__device__ __forceinline__ void iterate(const float* gx, const float* gy,
                                        const float* proj,
                                        const float* tables, int p, int rad,
                                        const Schedule& sched, int lane,
                                        float& cx, float& cy) {
#pragma unroll
    for (int s = 0; s < kMaxStages; ++s) {  // unrolled: the schedule stays
        if (s >= sched.stages) continue;    // in registers, not the stack
        const int h = sched.half[s];
        const int ww = 2 * h + 1;
        const int cw = min(ww, 32);         // lanes across a window row
        const int step = 32 / cw;           // window rows a pass
        const int lr = lane / cw;           // one divide a stage
        const int lc = lane - lr * cw;
        const float* tab = tables + sched.table[s];
        const float half = static_cast<float>(h);
        const float drift = sched.drift[s];
        for (int it = 0; it < sched.iters[s]; ++it) {
            const float wx = rintf(cx);
            const float wy = rintf(cy);
            const int ox = rad + static_cast<int>(wx) - h;  // window corner
            const int oy = rad + static_cast<int>(wy) - h;
            // the window's rows i0..i1 and columns k0..k1 that lie in
            // the gradient interior
            const int i0 = max(0, 1 - oy);
            const int i1 = min(ww - 1, p - 2 - oy);
            const int k0 = max(0, 1 - ox);
            const int k1 = min(ww - 1, p - 2 - ox);
            float a0 = 0.f, a1 = 0.f, a2 = 0.f, a3 = 0.f, a4 = 0.f;
            if (C < kMaxChunks || ww <= 32) {  // warp-uniform
                if (lr < step && lc >= k0 && lc <= k1)
                    add_column(gx, gy, proj, tab, p, ww, ox, oy, lc, lr,
                               step, i0, i1, a0, a1, a2, a3, a4);
            } else {  // lanes across columns lc, lc + 32, ...; step 1
                for (int k = lc; k <= k1; k += 32)
                    if (k >= k0)
                        add_column(gx, gy, proj, tab, p, ww, ox, oy, k, lr,
                                   step, i0, i1, a0, a1, a2, a3, a4);
            }
#pragma unroll
            for (int off = 16; off > 0; off >>= 1) {
                a0 += __shfl_xor_sync(kFull, a0, off);
                a1 += __shfl_xor_sync(kFull, a1, off);
                a2 += __shfl_xor_sync(kFull, a2, off);
                a3 += __shfl_xor_sync(kFull, a3, off);
                a4 += __shfl_xor_sync(kFull, a4, off);
            }
            const float wxx = a0, wxy = a1, wyy = a2, bx = a3, by = a4;
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

// The warp's slices of dynamic shared memory: the tables first, then
// gx, gy, proj (p^2 floats each) a warp.
__device__ __forceinline__ float* warp_slice(float* smem, const Schedule& s,
                                             int pp) {
    return smem + s.table_floats + (threadIdx.x >> 5) * 3 * pp;
}

// One warp per (corner, frame): gather, gradients, schedule.
template <typename T, int C>
__global__ void subpix_kernel(const T* __restrict__ image,
                              const float* __restrict__ corners,
                              float* __restrict__ out, int n, int h, int w,
                              int rad, Schedule sched) {
    extern __shared__ float smem[];
    build_tables(smem, sched);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const int corner = blockIdx.x * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (corner >= n) return;  // warp-uniform
    const int p = 2 * rad + 1;
    const int pp = p * p;
    float* gx = warp_slice(smem, sched, pp);
    float* gy = gx + pp;
    float* proj = gy + pp;

    const int frame = blockIdx.y;
    const long long ci = (static_cast<long long>(frame) * n + corner) * 2;
    const float c_x = corners[ci];
    const float c_y = corners[ci + 1];
    const int cx0 = min(max(static_cast<int>(rintf(c_x)), rad), w - rad - 1);
    const int cy0 = min(max(static_cast<int>(rintf(c_y)), rad), h - rad - 1);
    stage(image + static_cast<long long>(frame) * h * w
              + static_cast<long long>(cy0 - rad) * w + (cx0 - rad),
          w, p, proj, lane);
    gradients<C>(gx, gy, proj, p, rad, lane);

    const float lim = static_cast<float>(rad - 1);
    float cx = clampf(c_x - static_cast<float>(cx0), -lim, lim);
    float cy = clampf(c_y - static_cast<float>(cy0), -lim, lim);
    iterate<C>(gx, gy, proj, smem, p, rad, sched, lane, cx, cy);
    if (lane == 0) {
        out[ci] = cx + static_cast<float>(cx0);
        out[ci + 1] = cy + static_cast<float>(cy0);
    }
}

// One warp per patch: gradients and schedule on a gathered (p, p) f32
// patch from start offset c0 (relative to the patch centre).
template <int C>
__global__ void offsets_kernel(const float* __restrict__ patches,
                               const float* __restrict__ c0,
                               float* __restrict__ out, int n, int rad,
                               Schedule sched) {
    extern __shared__ float smem[];
    build_tables(smem, sched);
    __syncthreads();
    const int lane = threadIdx.x & 31;
    const long long i = static_cast<long long>(blockIdx.x)
                        * (blockDim.x >> 5) + (threadIdx.x >> 5);
    if (i >= n) return;  // warp-uniform
    const int p = 2 * rad + 1;
    const int pp = p * p;
    float* gx = warp_slice(smem, sched, pp);
    float* gy = gx + pp;
    float* proj = gy + pp;
    stage(patches + i * pp, p, p, proj, lane);
    gradients<C>(gx, gy, proj, p, rad, lane);
    float cx = c0[2 * i];
    float cy = c0[2 * i + 1];
    iterate<C>(gx, gy, proj, smem, p, rad, sched, lane, cx, cy);
    if (lane == 0) {
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
        if (half[k] < 0 || iters[k] < 0)
            return static_cast<int>(cudaErrorInvalidValue);
        s->half[k] = half[k];
        s->iters[k] = iters[k];
        s->sigma2[k] = sigma2[k];
        s->drift[k] = drift[k];
        s->table[k] = s->table_floats;
        s->table_floats += (2 * half[k] + 1) * (2 * half[k] + 1);
    }
    return 0;
}

// Corners a block (8 or 4 by the launch's `corners`, fewer where the
// patches would not fit) and the dynamic shared memory it takes; sets the
// kernel's shared-memory attribute above 48 KB.
template <typename K>
int block_shape(K kernel, const Schedule& s, int rad, long long corners,
                int* fit, size_t* shmem) {
    const size_t p = 2 * static_cast<size_t>(rad) + 1;
    const size_t tables = s.table_floats * sizeof(float);
    const size_t per_warp = 3 * p * p * sizeof(float);
    if (tables + per_warp > kMaxSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    const size_t warps = corners >= kWideLaunch ? 8 : 4;
    *fit = static_cast<int>(std::min(warps,
                         (kMaxSmem - tables) / per_warp));
    *shmem = tables + *fit * per_warp;
    if (*shmem > 48 * 1024) {
        cudaError_t err = cudaFuncSetAttribute(
            kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
            static_cast<int>(*shmem));
        if (err != cudaSuccess) return static_cast<int>(err);
    }
    return 0;
}

// Call f with the fewest column chunks a lane (1, 2 or kMaxChunks, as a
// std::integral_constant) that cover a p-wide patch.
template <typename F>
int by_chunks(int p, F&& f) {
    if (p <= 32) return f(std::integral_constant<int, 1>{});
    if (p <= 64) return f(std::integral_constant<int, 2>{});
    if (p <= 32 * kMaxChunks)
        return f(std::integral_constant<int, kMaxChunks>{});
    return static_cast<int>(cudaErrorInvalidValue);
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
    return by_chunks(2 * rad + 1, [&](auto chunks) {
        constexpr int C = decltype(chunks)::value;
        int fit;
        size_t shmem;
        int e = block_shape(subpix_kernel<T, C>, s, rad,
                            static_cast<long long>(frames) * n, &fit, &shmem);
        if (e) return e;
        const dim3 grid(aruco_blocks(n, fit), frames);
        subpix_kernel<T, C><<<grid, fit * 32, shmem, stream>>>(
            image, corners, out, n, h, w, rad, s);
        ARUCO_LAUNCH_CHECK();
        return 0;
    });
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
    return by_chunks(2 * rad + 1, [&](auto chunks) {
        constexpr int C = decltype(chunks)::value;
        int fit;
        size_t shmem;
        int e = block_shape(offsets_kernel<C>, s, rad, n, &fit, &shmem);
        if (e) return e;
        offsets_kernel<C><<<aruco_blocks(n, fit), fit * 32, shmem, stream>>>(
            patches, c0, out, n, rad, s);
        ARUCO_LAUNCH_CHECK();
        return 0;
    });
}
