// Fused MEKF measurement update: gain by Newton–Schulz, innovation and
// the Joseph-form covariance, all f32, for one filter or for S filters
// (streams) at once.
//
// Replaces the TPU kernel aruco_slam_tpu/filters/pallas_mekf.py
// `_update_kernel` (wrapper `fused_update`). Same chain, same order:
//   PHᵀ; S = HPHᵀ + diag(r); S⁻¹ by `ns_iters` Newton–Schulz steps
//   X ← X(2I − SX) from X₀ = S/‖S‖₁²; K = PHᵀS⁻¹; inn = K·resid;
//   P' = sym((I−KH)P(I−KH)ᵀ + K diag(r) Kᵀ).
// The JAX fleet vmaps the whole filter, so on a TPU its Pallas update
// runs once per stream per frame; here the stream index is one more
// grid axis and a frame of S streams is still ten launches.
//
// What bounds it on Hopper: launch latency and the dependent chain, not
// FLOPs or bytes. At the run_slam defaults (N = 201, M = 48) the whole
// update is ~60 MFLOP over ~1 MB that stays in L2. P alone is 162 KB,
// most of one block's 227 KB of shared memory, so P and H cannot share
// one block and the TPU's one-program design does not carry over.
// Design: every product runs in this file's shared-memory-tiled f32
// GEMM (16x16 tiles, transpose flags, C = αAB + βC; no cuBLAS; the
// stream in blockIdx.z, each operand at its own per-stream stride), the
// 20 Newton–Schulz steps run in one block per stream (any M; the
// iterates live in L1/L2), and small elementwise kernels (the stream in
// blockIdx.y) add the diagonal, scale K's columns by r and symmetrize.
// Ten launches per frame on one stream, whatever S; nothing
// synchronises. Each stream's arithmetic is the single-stream launch's,
// operation for operation.
#include "common.cuh"

namespace {

constexpr int kTile = 16;
constexpr int kNsThreads = 1024;

// C[z][m, n] = alpha * sum_k opA(m, k) opB(k, n) + beta * C[z][m, n]
// opA(m, k) = ta ? A[k * lda + m] : A[m * lda + k]   (likewise B);
// operand X of stream z starts at X + z * sx
__global__ void gemm_kernel(int m, int n, int k, float alpha,
                            const float* __restrict__ a, int lda, int ta,
                            long long sa, const float* __restrict__ b,
                            int ldb, int tb, long long sb, float beta,
                            float* c, int ldc, long long sc) {
    __shared__ float as[kTile][kTile + 1];
    __shared__ float bs[kTile][kTile + 1];
    const long long z = blockIdx.z;
    a += z * sa;
    b += z * sb;
    c += z * sc;
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

// The elementwise kernels take the stream from blockIdx.y.
__global__ void add_diag(float* s, const float* __restrict__ r, int m) {
    int i = blockIdx.x * blockDim.x + threadIdx.x;
    const long long z = blockIdx.y;
    if (i < m) s[z * m * m + static_cast<long long>(i) * m + i] += r[z * m + i];
}

__global__ void set_identity(float* x, int n) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    const long long nn = static_cast<long long>(n) * n;
    if (i < nn) x[blockIdx.y * nn + i] = (i / n == i % n) ? 1.0f : 0.0f;
}

__global__ void scale_cols(float* __restrict__ out,
                           const float* __restrict__ in,
                           const float* __restrict__ r, int rows,
                           int cols) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    const long long z = blockIdx.y;
    const long long size = static_cast<long long>(rows) * cols;
    if (i < size)
        out[z * size + i] = in[z * size + i] * r[z * cols + i % cols];
}

__global__ void symmetrize(float* __restrict__ out,
                           const float* __restrict__ in, int n) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    const long long nn = static_cast<long long>(n) * n;
    if (i >= nn) return;
    in += blockIdx.y * nn;
    out += blockIdx.y * nn;
    long long r = i / n;
    long long c = i - r * n;
    out[i] = 0.5f * (in[i] + in[c * n + r]);
}

// S⁻¹ by Newton–Schulz, one block per stream: x ← x (2I − S x), `iters`
// times, from x₀ = S / ‖S‖₁² (‖·‖₁ = max column abs sum; S is symmetric).
__global__ void __launch_bounds__(kNsThreads)
newton_schulz(const float* __restrict__ s, float* x, float* t, float* y,
              int m, int iters) {
    __shared__ float colmax[kNsThreads];
    const int mm = m * m;
    const long long off = static_cast<long long>(blockIdx.x) * mm;
    s += off;
    x += off;
    t += off;
    y += off;
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

// One batched GEMM launch: every operand packed per stream, so its
// stream stride is its own size.
int gemm(cudaStream_t stream, int streams, int m, int n, int k,
         float alpha, const float* a, int lda, int ta, long long sa,
         const float* b, int ldb, int tb, long long sb, float beta,
         float* c, int ldc, long long sc) {
    dim3 block(kTile, kTile);
    dim3 grid((n + kTile - 1) / kTile, (m + kTile - 1) / kTile, streams);
    gemm_kernel<<<grid, block, 0, stream>>>(m, n, k, alpha, a, lda, ta, sa,
                                            b, ldb, tb, sb, beta, c, ldc,
                                            sc);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

dim3 per_stream(long long n, int threads, int streams) {
    return dim3(aruco_blocks(n, threads), streams);
}

}  // namespace

// f32 scratch the update needs per stream, in floats (the wrapper
// allocates streams times this).
extern "C" long long mekf_update_scratch_floats(int n, int m) {
    return 3LL * n * m + 4LL * m * m + 3LL * n * n;
}

// S streams packed along a leading axis: cov (S, n, n), h (S, m, n),
// r (S, m), resid (S, m) -> inn (S, n), cov_out (S, n, n).
extern "C" int mekf_fused_update_batched(const float* cov, const float* h,
                                         const float* r, const float* resid,
                                         float* inn, float* cov_out,
                                         float* scratch, int streams, int n,
                                         int m, int ns_iters,
                                         cudaStream_t stream) {
    if (n <= 0 || m <= 0 || streams <= 0 || streams > 65535)
        return static_cast<int>(cudaErrorInvalidValue);
    const long long nm = static_cast<long long>(n) * m;
    const long long mm = static_cast<long long>(m) * m;
    const long long nn = static_cast<long long>(n) * n;
    float* pht = scratch;                // (S, n, m)  P Hᵀ
    float* gain = pht + streams * nm;    // (S, n, m)  K
    float* kr = gain + streams * nm;     // (S, n, m)  K diag(r)
    float* s = kr + streams * nm;        // (S, m, m)  S
    float* x = s + streams * mm;         // (S, m, m)  S⁻¹ iterate
    float* t = x + streams * mm;         // (S, m, m)
    float* y = t + streams * mm;         // (S, m, m)
    float* ikh = y + streams * mm;       // (S, n, n)  I − K H
    float* t1 = ikh + streams * nn;      // (S, n, n)  (I − K H) P
    float* jos = t1 + streams * nn;      // (S, n, n)  Joseph sum
    const int threads = 256;
    const int z = streams;
    int err;
    if ((err = gemm(stream, z, n, m, n, 1.f, cov, n, 0, nn, h, n, 1, nm,
                    0.f, pht, m, nm)))
        return err;
    if ((err = gemm(stream, z, m, m, n, 1.f, h, n, 0, nm, pht, m, 0, nm,
                    0.f, s, m, mm)))
        return err;
    add_diag<<<per_stream(m, threads, z), threads, 0, stream>>>(s, r, m);
    ARUCO_LAUNCH_CHECK();
    newton_schulz<<<z, kNsThreads, 0, stream>>>(s, x, t, y, m, ns_iters);
    ARUCO_LAUNCH_CHECK();
    if ((err = gemm(stream, z, n, m, m, 1.f, pht, m, 0, nm, x, m, 0, mm,
                    0.f, gain, m, nm)))
        return err;
    if ((err = gemm(stream, z, n, 1, m, 1.f, gain, m, 0, nm, resid, 1, 0, m,
                    0.f, inn, 1, n)))
        return err;
    set_identity<<<per_stream(nn, threads, z), threads, 0, stream>>>(ikh, n);
    ARUCO_LAUNCH_CHECK();
    if ((err = gemm(stream, z, n, n, m, -1.f, gain, m, 0, nm, h, n, 0, nm,
                    1.f, ikh, n, nn)))
        return err;
    if ((err = gemm(stream, z, n, n, n, 1.f, ikh, n, 0, nn, cov, n, 0, nn,
                    0.f, t1, n, nn)))
        return err;
    if ((err = gemm(stream, z, n, n, n, 1.f, t1, n, 0, nn, ikh, n, 1, nn,
                    0.f, jos, n, nn)))
        return err;
    scale_cols<<<per_stream(nm, threads, z), threads, 0, stream>>>(
        kr, gain, r, n, m);
    ARUCO_LAUNCH_CHECK();
    if ((err = gemm(stream, z, n, n, m, 1.f, kr, m, 0, nm, gain, m, 1, nm,
                    1.f, jos, n, nn)))
        return err;
    symmetrize<<<per_stream(nn, threads, z), threads, 0, stream>>>(
        cov_out, jos, n);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

// One filter: cov (n, n), h (m, n), r (m), resid (m) -> inn (n),
// cov_out (n, n). The batched chain at S = 1.
extern "C" int mekf_fused_update(const float* cov, const float* h,
                                 const float* r, const float* resid,
                                 float* inn, float* cov_out,
                                 float* scratch, int n, int m,
                                 int ns_iters, cudaStream_t stream) {
    return mekf_fused_update_batched(cov, h, r, resid, inn, cov_out,
                                     scratch, 1, n, m, ns_iters, stream);
}
