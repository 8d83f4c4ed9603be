// Fused MEKF measurement update: gain by Newton–Schulz, innovation and
// the Joseph-form covariance, all f32.
//
// Replaces the TPU kernel aruco_slam_tpu/filters/pallas_mekf.py
// `_update_kernel` (wrapper `fused_update`). Same chain, same order:
//   PHᵀ; S = HPHᵀ + diag(r); S⁻¹ by `ns_iters` Newton–Schulz steps
//   X ← X(2I − SX) from X₀ = S/‖S‖₁²; K = PHᵀS⁻¹; inn = K·resid;
//   P' = sym((I−KH)P(I−KH)ᵀ + K diag(r) Kᵀ).
//
// What bounds it on Hopper: launch latency and the dependent chain, not
// FLOPs or bytes. At the run_slam defaults (N = 201, M = 48) the whole
// update is ~60 MFLOP over ~1 MB that stays in L2. P alone is 162 KB,
// most of one block's 227 KB of shared memory, so P and H cannot share
// one block and the TPU's one-program design does not carry over.
// Design: every product runs in this file's shared-memory-tiled f32
// GEMM (16x16 tiles, transpose flags, C = αAB + βC; no cuBLAS), the
// 20 Newton–Schulz steps run in ONE single-block kernel (any M; the
// 48x48 iterates live in L1/L2), and small elementwise kernels add the
// diagonal, scale K's columns by r and symmetrize. Ten launches per
// frame on one stream, nothing synchronises.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kNsThreads = 1024;

// C[m, n] = alpha * sum_k opA(m, k) opB(k, n) + beta * C[m, n]
// opA(m, k) = ta ? A[k * lda + m] : A[m * lda + k]   (likewise B)
__global__ void gemm_kernel(int m, int n, int k, float alpha,
                            const float* __restrict__ a, int lda, int ta,
                            const float* __restrict__ b, int ldb, int tb,
                            float beta, float* c, int ldc) {
    __shared__ float as[kTile][kTile + 1];
    __shared__ float bs[kTile][kTile + 1];
    const int tx = threadIdx.x;
    const int ty = threadIdx.y;
    const int row = blockIdx.y * kTile + ty;
    const int col = blockIdx.x * kTile + tx;
    float acc = 0.0f;
    for (int k0 = 0; k0 < k; k0 += kTile) {
        int ka = k0 + tx;
        as[ty][tx] = (row < m && ka < k)
                         ? (ta ? a[static_cast<long long>(ka) * lda + row]
                               : a[static_cast<long long>(row) * lda + ka])
                         : 0.0f;
        int kb = k0 + ty;
        bs[ty][tx] = (kb < k && col < n)
                         ? (tb ? b[static_cast<long long>(col) * ldb + kb]
                               : b[static_cast<long long>(kb) * ldb + col])
                         : 0.0f;
        __syncthreads();
#pragma unroll
        for (int kk = 0; kk < kTile; ++kk)
            acc = fmaf(as[ty][kk], bs[kk][tx], acc);
        __syncthreads();
    }
    if (row < m && col < n) {
        float* out = c + static_cast<long long>(row) * ldc + col;
        *out = beta != 0.0f ? alpha * acc + beta * *out : alpha * acc;
    }
}

__global__ void add_diag(float* s, const float* __restrict__ r, int m) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i < m) s[i * m + i] += r[i];
}

__global__ void set_identity(float* x, int n) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    if (i < static_cast<long long>(n) * n)
        x[i] = (i / n == i % n) ? 1.0f : 0.0f;
}

__global__ void scale_cols(float* __restrict__ out,
                           const float* __restrict__ in,
                           const float* __restrict__ r, int rows,
                           int cols) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    if (i < static_cast<long long>(rows) * cols) out[i] = in[i] * r[i % cols];
}

__global__ void symmetrize(float* __restrict__ out,
                           const float* __restrict__ in, int n) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    if (i >= static_cast<long long>(n) * n) return;
    long long r = i / n;
    long long c = i - r * n;
    out[i] = 0.5f * (in[i] + in[c * n + r]);
}

// S⁻¹ by Newton–Schulz in one block: x ← x (2I − S x), `iters` times,
// from x₀ = S / ‖S‖₁² (‖·‖₁ = max column abs sum; S is symmetric).
__global__ void __launch_bounds__(kNsThreads)
newton_schulz(const float* __restrict__ s, float* x, float* t, float* y,
              int m, int iters) {
    __shared__ float colmax[kNsThreads];
    const int tid = threadIdx.x;
    float best = 0.0f;
    for (int j = tid; j < m; j += kNsThreads) {
        float acc = 0.0f;
        for (int i = 0; i < m; ++i) acc += fabsf(s[i * m + j]);
        best = fmaxf(best, acc);
    }
    colmax[tid] = best;
    __syncthreads();
    for (int stride = kNsThreads / 2; stride > 0; stride >>= 1) {
        if (tid < stride)
            colmax[tid] = fmaxf(colmax[tid], colmax[tid + stride]);
        __syncthreads();
    }
    const float norm1 = colmax[0];
    const float denom = norm1 * norm1;
    const int mm = m * m;
    for (int e = tid; e < mm; e += kNsThreads) x[e] = s[e] / denom;
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
        for (int e = tid; e < mm; e += kNsThreads) {  // t = 2I − S x
            int r = e / m;
            int c = e - r * m;
            float acc = 0.0f;
            for (int q = 0; q < m; ++q)
                acc = fmaf(s[r * m + q], x[q * m + c], acc);
            t[e] = (r == c ? 2.0f : 0.0f) - acc;
        }
        __syncthreads();
        for (int e = tid; e < mm; e += kNsThreads) {  // y = x t
            int r = e / m;
            int c = e - r * m;
            float acc = 0.0f;
            for (int q = 0; q < m; ++q)
                acc = fmaf(x[r * m + q], t[q * m + c], acc);
            y[e] = acc;
        }
        __syncthreads();
        for (int e = tid; e < mm; e += kNsThreads) x[e] = y[e];
        __syncthreads();
    }
}

int gemm(cudaStream_t stream, int m, int n, int k, float alpha,
         const float* a, int lda, int ta, const float* b, int ldb, int tb,
         float beta, float* c, int ldc) {
    dim3 block(kTile, kTile);
    dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile);
    gemm_kernel<<<grid, block, 0, stream>>>(m, n, k, alpha, a, lda, ta, b,
                                            ldb, tb, beta, c, ldc);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

}  // namespace

// f32 scratch the update needs, in floats (the wrapper allocates it).
extern "C" long long mekf_update_scratch_floats(int n, int m) {
    return 3LL * n * m + 4LL * m * m + 3LL * n * n;
}

// cov (n, n), h (m, n), r (m), resid (m) -> inn (n), cov_out (n, n).
extern "C" int mekf_fused_update(const float* cov, const float* h,
                                 const float* r, const float* resid,
                                 float* inn, float* cov_out,
                                 float* scratch, int n, int m,
                                 int ns_iters, cudaStream_t stream) {
    if (n == 0 || m == 0) return static_cast<int>(cudaErrorInvalidValue);
    float* pht = scratch;            // (n, m)  P Hᵀ
    float* gain = pht + n * m;       // (n, m)  K
    float* kr = gain + n * m;        // (n, m)  K diag(r)
    float* s = kr + n * m;           // (m, m)  S
    float* x = s + m * m;            // (m, m)  S⁻¹ iterate
    float* t = x + m * m;            // (m, m)
    float* y = t + m * m;            // (m, m)
    float* ikh = y + m * m;          // (n, n)  I − K H
    float* t1 = ikh + n * n;         // (n, n)  (I − K H) P
    float* jos = t1 + n * n;         // (n, n)  Joseph sum
    const int threads = 256;
    int err;
    if ((err = gemm(stream, n, m, n, 1.f, cov, n, 0, h, n, 1, 0.f, pht, m)))
        return err;
    if ((err = gemm(stream, m, m, n, 1.f, h, n, 0, pht, m, 0, 0.f, s, m)))
        return err;
    add_diag<<<aruco_blocks(m, threads), threads, 0, stream>>>(s, r, m);
    ARUCO_LAUNCH_CHECK();
    newton_schulz<<<1, kNsThreads, 0, stream>>>(s, x, t, y, m, ns_iters);
    ARUCO_LAUNCH_CHECK();
    if ((err = gemm(stream, n, m, m, 1.f, pht, m, 0, x, m, 0, 0.f, gain, m)))
        return err;
    if ((err = gemm(stream, n, 1, m, 1.f, gain, m, 0, resid, 1, 0, 0.f, inn,
                    1)))
        return err;
    set_identity<<<aruco_blocks(static_cast<long long>(n) * n, threads),
                   threads, 0, stream>>>(ikh, n);
    ARUCO_LAUNCH_CHECK();
    if ((err = gemm(stream, n, n, m, -1.f, gain, m, 0, h, n, 0, 1.f, ikh, n)))
        return err;
    if ((err = gemm(stream, n, n, n, 1.f, ikh, n, 0, cov, n, 0, 0.f, t1, n)))
        return err;
    if ((err = gemm(stream, n, n, n, 1.f, t1, n, 0, ikh, n, 1, 0.f, jos, n)))
        return err;
    scale_cols<<<aruco_blocks(static_cast<long long>(n) * m, threads),
                 threads, 0, stream>>>(kr, gain, r, n, m);
    ARUCO_LAUNCH_CHECK();
    if ((err = gemm(stream, n, n, m, 1.f, kr, m, 0, gain, m, 1, 1.f, jos, n)))
        return err;
    symmetrize<<<aruco_blocks(static_cast<long long>(n) * n, threads),
                 threads, 0, stream>>>(cov_out, jos, n);
    ARUCO_LAUNCH_CHECK();
    return 0;
}
