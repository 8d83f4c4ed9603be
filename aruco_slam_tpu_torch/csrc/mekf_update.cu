// Fused MEKF measurement update: gain by Newton–Schulz, innovation and
// the Joseph-form covariance, all f32 on FFMA (no TF32: the gain chain
// is pinned to full f32), for one filter or for S filters (streams).
//
// Replaces the TPU kernel aruco_slam_tpu/filters/pallas_mekf.py
// `_update_kernel` (wrapper `fused_update`). Same chain, same order:
//   PHᵀ; S = HPHᵀ + diag(r); X₀ = S/‖S‖₁² (‖·‖₁ = max column abs sum);
//   `ns_iters` steps X ← X(2I − SX); K = PHᵀX; inn = K·resid;
//   P' = sym((I−KH)P(I−KH)ᵀ + K diag(r) Kᵀ).
//
// What bounds it on Hopper: the dependent chain, not FLOPs or bytes.
// The bound (f32 FLOPs at 67 TFLOP/s against each input and output
// moved once at 3.35 TB/s) is 0.82 us at N = 201, M = 48 (54.8 MFLOP),
// 7.1 us at N = 393, M = 112 (479 MFLOP) and 6.6 us for 8 streams of
// (201, 48); but the 2·`ns_iters` Newton–Schulz products are 40
// dependent M x M x M steps, and P (618 KB at N = 393) fits no block.
// Design, five launches per frame for any S (the stream is a grid axis,
// and each stream's arithmetic is the single-stream launch's, operation
// for operation, so a batched launch is bit-equal to S single ones):
//  1. PHᵀ in the register-tiled GEMM below (32x32 output tiles, 2x2
//     outputs a thread, float2 shared-memory loads, the next 64-deep
//     tile fetched into registers while the current one is multiplied,
//     up to two depth segments, the stream in blockIdx.z).
//  2. The Newton–Schulz steps in one 8-CTA thread-block cluster per
//     stream (the stream in blockIdx.y), the iterates in the CTAs'
//     shared memory and exchanged through distributed shared memory
//     (`map_shared_rank`, several float4 loads in flight a thread).
//     S = HPHᵀ + diag(r), the norm, X₀, every step, K = PHᵀX and
//     inn = K·resid all stay in this one launch.
//     `ns_cluster_cols` (M <= 128): each CTA computes a column slab of
//     T and X and holds all of S and all of X (double-buffered), so
//     T = 2I − SX needs no peer, and each CTA stores its slab of the
//     new X into every CTA's next buffer: one cluster barrier a step.
//     `ns_cluster` (M <= kNsMaxM = 256, taken above 128, where the
//     column form's threads cannot hold the rows): each CTA owns a row
//     slab of S, X and T, and each product brings the other factor's
//     slabs from the peers one at a time, double-buffered: two products'
//     worth of DSMEM traffic and two barriers a step (1.9–2.3x the
//     column form's time at M = 48 and 112, and 13x faster than the
//     single block at M = 224, on an H100).
//     Above 256, the single-block `newton_schulz` of the first design
//     is the second path (S and K then in the GEMM: eight launches).
//     The entry point picks the first form that takes M (columns, rows,
//     block: each takes every M the ones before it take); a caller that
//     measures or tests the forms may force one that takes M.
//  3. I − KH: the GEMM with an identity-minus epilogue.
//  4. (I − KH)P.
//  5. The Joseph sum and KRKᵀ as one GEMM over the concatenated depth
//     N + M, [(I−KH)P | K diag(r)] x [(I−KH) | K]ᵀ, whose blocks each
//     compute an output tile and its mirror and write 0.5(C + Cᵀ) to
//     both: P' is symmetrized in the same launch and exactly symmetric.
// Nothing synchronises with the host.
#include <cooperative_groups.h>

#include <climits>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

// ------------------------------------------------------------ GEMM
constexpr int kTile = 32;           // output tile (rows and columns)
constexpr int kDepth = 64;          // depth per shared-memory stage
constexpr int kGemmThreads = 256;   // 16 x 16 threads, 2 x 2 outputs each
constexpr int kPad = kTile + 2;     // row stride of a staged tile

enum Epilogue { kStore, kEyeMinus, kAddDiag, kSymPair };

// A(i, k) = trans ? p[k * ld + i] : p[i * ld + k] (times scale[k] when
// scale is given); B(k, j) = trans ? p[j * ld + k] : p[k * ld + j].
// Stream z's operand starts at p + z * stride (scale + z * sstride).
struct Operand {
    const float* p;
    int ld;
    int trans;
    long long stride;
    const float* scale;
    long long sstride;
};

// C (m x n) = the sum over up to two depth segments of A_s B_s, then
// the epilogue: kStore C; kEyeMinus I − C; kAddDiag C + diag(r);
// kSymPair (m == n) 0.5 (C + Cᵀ), each block a tile and its mirror.
struct Gemm {
    int m, n, segs;
    int depth[2];
    Operand a[2], b[2];
    float* c;
    int ldc;
    long long sc;
    const float* r;
    long long sr;
};

constexpr int kPer = kTile * kDepth / kGemmThreads;  // tile elements a thread

// v = this thread's kPer elements of the A tile at (i0, k0):
// A(i0 + i, k0 + k), zero outside rows x depth.
__device__ __forceinline__ void fetch_a(float (&v)[kPer], const Operand& o,
                                        const float* p, const float* scale,
                                        int rows, int depth, int i0, int k0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kGemmThreads;
        // consecutive threads walk the operand's contiguous axis
        const int i = o.trans ? e % kTile : e / kDepth;
        const int k = o.trans ? e / kTile : e % kDepth;
        const int gi = i0 + i;
        const int gk = k0 + k;
        float x = 0.0f;
        if (gi < rows && gk < depth) {
            x = o.trans ? p[static_cast<long long>(gk) * o.ld + gi]
                        : p[static_cast<long long>(gi) * o.ld + gk];
            if (scale != nullptr) x *= scale[gk];
        }
        v[q] = x;
    }
}

__device__ __forceinline__ void put_a(float (*dst)[kPad], const Operand& o,
                                      const float (&v)[kPer]) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kGemmThreads;
        const int i = o.trans ? e % kTile : e / kDepth;
        const int k = o.trans ? e / kTile : e % kDepth;
        dst[k][i] = v[q];
    }
}

// v = this thread's kPer elements of the B tile at (k0, j0):
// B(k0 + k, j0 + j), zero outside depth x cols.
__device__ __forceinline__ void fetch_b(float (&v)[kPer], const Operand& o,
                                        const float* p, int cols, int depth,
                                        int j0, int k0) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kGemmThreads;
        const int j = o.trans ? e / kDepth : e % kTile;
        const int k = o.trans ? e % kDepth : e / kTile;
        const int gj = j0 + j;
        const int gk = k0 + k;
        float x = 0.0f;
        if (gj < cols && gk < depth)
            x = o.trans ? p[static_cast<long long>(gj) * o.ld + gk]
                        : p[static_cast<long long>(gk) * o.ld + gj];
        v[q] = x;
    }
}

__device__ __forceinline__ void put_b(float (*dst)[kPad], const Operand& o,
                                      const float (&v)[kPer]) {
#pragma unroll
    for (int q = 0; q < kPer; ++q) {
        const int e = threadIdx.x + q * kGemmThreads;
        const int j = o.trans ? e / kDepth : e % kTile;
        const int k = o.trans ? e % kDepth : e / kTile;
        dst[k][j] = v[q];
    }
}

__device__ __forceinline__ void fma2x2(float (&acc)[2][2], float2 a,
                                       float2 b) {
    acc[0][0] = fmaf(a.x, b.x, acc[0][0]);
    acc[0][1] = fmaf(a.x, b.y, acc[0][1]);
    acc[1][0] = fmaf(a.y, b.x, acc[1][0]);
    acc[1][1] = fmaf(a.y, b.y, acc[1][1]);
}

template <int kMode>
__global__ void __launch_bounds__(kGemmThreads) gemm_kernel(Gemm g) {
    constexpr int kMirror = kMode == kSymPair ? kDepth : 1;
    __shared__ __align__(16) float as[kDepth][kPad];
    __shared__ __align__(16) float bs[kDepth][kPad];
    // kSymPair: the mirror tile's operands (rows of the J block of A,
    // columns of the I block of B)
    __shared__ __align__(16) float am[kMirror][kPad];
    __shared__ __align__(16) float bm[kMirror][kPad];
    const long long z = blockIdx.z;
    int i0, j0;
    if (kMode == kSymPair) {  // blockIdx.x walks the tile pairs I <= J
        const int tiles = (g.n + kTile - 1) / kTile;
        int ti = 0;
        int rem = static_cast<int>(blockIdx.x);
        while (rem >= tiles - ti) {
            rem -= tiles - ti;
            ++ti;
        }
        i0 = ti * kTile;
        j0 = (ti + rem) * kTile;
    } else {
        i0 = static_cast<int>(blockIdx.y) * kTile;
        j0 = static_cast<int>(blockIdx.x) * kTile;
    }
    const int ty = threadIdx.x / 16;
    const int tx = threadIdx.x % 16;
    float acc[2][2] = {{0.f, 0.f}, {0.f, 0.f}};
    float mir[2][2] = {{0.f, 0.f}, {0.f, 0.f}};  // C[j][i] (kSymPair)
    for (int s = 0; s < g.segs; ++s) {
        const Operand& oa = g.a[s];
        const Operand& ob = g.b[s];
        const float* pa = oa.p + z * oa.stride;
        const float* pb = ob.p + z * ob.stride;
        const float* scale = oa.scale ? oa.scale + z * oa.sstride : nullptr;
        const int depth = g.depth[s];
        // the next k-tile's operands are fetched into registers while
        // the current one is multiplied
        float va[kPer], vb[kPer], vam[kPer], vbm[kPer];
        fetch_a(va, oa, pa, scale, g.m, depth, i0, 0);
        fetch_b(vb, ob, pb, g.n, depth, j0, 0);
        if (kMode == kSymPair) {
            fetch_a(vam, oa, pa, scale, g.m, depth, j0, 0);
            fetch_b(vbm, ob, pb, g.n, depth, i0, 0);
        }
        for (int k0 = 0; k0 < depth; k0 += kDepth) {
            put_a(as, oa, va);
            put_b(bs, ob, vb);
            if (kMode == kSymPair) {
                put_a(am, oa, vam);
                put_b(bm, ob, vbm);
            }
            __syncthreads();
            if (k0 + kDepth < depth) {
                fetch_a(va, oa, pa, scale, g.m, depth, i0, k0 + kDepth);
                fetch_b(vb, ob, pb, g.n, depth, j0, k0 + kDepth);
                if (kMode == kSymPair) {
                    fetch_a(vam, oa, pa, scale, g.m, depth, j0, k0 + kDepth);
                    fetch_b(vbm, ob, pb, g.n, depth, i0, k0 + kDepth);
                }
            }
#pragma unroll 8
            for (int k = 0; k < kDepth; ++k) {
                fma2x2(acc, *reinterpret_cast<const float2*>(&as[k][ty * 2]),
                       *reinterpret_cast<const float2*>(&bs[k][tx * 2]));
                if (kMode == kSymPair)
                    fma2x2(mir,
                           *reinterpret_cast<const float2*>(&am[k][tx * 2]),
                           *reinterpret_cast<const float2*>(&bm[k][ty * 2]));
            }
            __syncthreads();
        }
    }
    float* c = g.c + z * g.sc;
#pragma unroll
    for (int a = 0; a < 2; ++a) {
#pragma unroll
        for (int b = 0; b < 2; ++b) {
            const int i = i0 + ty * 2 + a;
            const int j = j0 + tx * 2 + b;
            if (i >= g.m || j >= g.n) continue;
            const float v = acc[a][b];
            if (kMode == kStore) {
                c[static_cast<long long>(i) * g.ldc + j] = v;
            } else if (kMode == kEyeMinus) {
                c[static_cast<long long>(i) * g.ldc + j] =
                    (i == j ? 1.0f : 0.0f) - v;
            } else if (kMode == kAddDiag) {
                c[static_cast<long long>(i) * g.ldc + j] =
                    v + (i == j ? g.r[z * g.sr + i] : 0.0f);
            } else {
                // mir[b][a] = C[j][i] (the mirror's row offset is the
                // thread's column offset); the sum is commutative, so
                // the two writes, and the diagonal tile's duplicate
                // writes, hold the same bits
                const float sym = 0.5f * (v + mir[b][a]);
                c[static_cast<long long>(i) * g.ldc + j] = sym;
                c[static_cast<long long>(j) * g.ldc + i] = sym;
            }
        }
    }
}

Operand op(const float* p, int ld, int trans, long long stride,
           const float* scale = nullptr, long long sstride = 0) {
    return Operand{p, ld, trans, stride, scale, sstride};
}

// C = A B over one depth segment.
Gemm gemm1(int m, int n, int depth, Operand a, Operand b, float* c, int ldc,
           long long sc) {
    Gemm g{};
    g.m = m;
    g.n = n;
    g.segs = 1;
    g.depth[0] = depth;
    g.a[0] = a;
    g.b[0] = b;
    g.c = c;
    g.ldc = ldc;
    g.sc = sc;
    return g;
}

template <int kMode>
int launch_gemm(const Gemm& g, int streams, cudaStream_t stream) {
    const int tn = (g.n + kTile - 1) / kTile;
    const int tm = (g.m + kTile - 1) / kTile;
    const dim3 grid = kMode == kSymPair ? dim3(tn * (tn + 1) / 2, 1, streams)
                                        : dim3(tn, tm, streams);
    gemm_kernel<kMode><<<grid, kGemmThreads, 0, stream>>>(g);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

// ------------------------------------------ Newton–Schulz in a cluster
constexpr int kCluster = 8;        // CTAs per stream (portable size)
constexpr int kNsThreads = 256;
constexpr int kNsMaxM = 256;       // the cluster path's largest M
constexpr int kColsMaxM = 128;     // the column form's largest M
constexpr int kRowsRpt = 8;        // row form: rows a thread (R <= 32
                                   // rows over >= 4 row groups)

// The Newton–Schulz forms (the entry point's `form`; kAuto = by M).
enum NsForm { kAuto = 0, kColumns = 1, kRows = 2, kBlock = 3 };

// The largest M a form takes.
int form_max_m(int form) {
    return form == kColumns ? kColsMaxM : form == kRows ? kNsMaxM : INT_MAX;
}

// acc[i][c] += sum_k a[rr_i][k] b[k][4 jq + c] over k < depth (a
// multiple of 4), the k terms in order; rr_i = g + i G, clamped into
// the `rows` of a (a clamped row's sums are never stored). Each thread
// holds an RPT x 4 tile: a row of a and four columns of b a float4
// load each.
template <int RPT>
__device__ __forceinline__ void fma_tile(float (&acc)[RPT][4],
                                         const float* a, int lda, int rows,
                                         const float* b, int ldb, int depth,
                                         int g, int G, int jq) {
    for (int k = 0; k < depth; k += 4) {
        float4 bv[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
            bv[q] = *reinterpret_cast<const float4*>(b + (k + q) * ldb
                                                     + 4 * jq);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int rr = min(g + i * G, rows - 1);
            const float4 av =
                *reinterpret_cast<const float4*>(a + rr * lda + k);
            const float ak[4] = {av.x, av.y, av.z, av.w};
#pragma unroll
            for (int q = 0; q < 4; ++q) {
                acc[i][0] = fmaf(ak[q], bv[q].x, acc[i][0]);
                acc[i][1] = fmaf(ak[q], bv[q].y, acc[i][1]);
                acc[i][2] = fmaf(ak[q], bv[q].z, acc[i][2]);
                acc[i][3] = fmaf(ak[q], bv[q].w, acc[i][3]);
            }
        }
    }
}

constexpr int kBatch = 4;          // float4 loads in flight a thread
constexpr int kStageBatch = 8;     // global loads in flight a thread

// dst[e] = value(e) for e < count: kStageBatch loads in flight a thread
// (value does its own bounds test and global load).
template <typename F>
__device__ __forceinline__ void stage(float* dst, int count, F value) {
    for (int e0 = threadIdx.x; e0 < count; e0 += kNsThreads * kStageBatch) {
        float v[kStageBatch];
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
            const int e = e0 + b * kNsThreads;
            v[b] = e < count ? value(e) : 0.0f;
        }
#pragma unroll
        for (int b = 0; b < kStageBatch; ++b) {
            const int e = e0 + b * kNsThreads;
            if (e < count) dst[e] = v[b];
        }
    }
}

// out[q] = sum_c k[q m + c] resid[c] for q in [lo, hi): a warp a row,
// the lanes over c, then a butterfly sum (the same order in every
// launch). k is read past L1: other CTAs of the cluster wrote parts.
__device__ __forceinline__ void row_dots(float* out, const float* k,
                                         const float* resid, int m, int lo,
                                         int hi) {
    const int lane = threadIdx.x & 31;
    for (int q = lo + (threadIdx.x >> 5); q < hi; q += kNsThreads / 32) {
        float sum = 0.0f;
        for (int c = lane; c < m; c += 32)
            sum = fmaf(__ldcg(k + static_cast<long long>(q) * m + c),
                       resid[c], sum);
        for (int off = 16; off > 0; off >>= 1)
            sum += __shfl_xor_sync(0xffffffffu, sum, off);
        if (lane == 0) out[q] = sum;
    }
}

// dst[e] = peer p's slab `src` (floats, a multiple of 4) over DSMEM,
// kBatch float4 loads issued before their stores.
__device__ __forceinline__ void copy_peer(cg::cluster_group& cluster,
                                          float* dst, float* src,
                                          int floats, int p) {
    const float4* s = reinterpret_cast<const float4*>(
        cluster.map_shared_rank(src, p));
    float4* d = reinterpret_cast<float4*>(dst);
    const int total = floats / 4;
    for (int e0 = threadIdx.x; e0 < total; e0 += kNsThreads * kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int e = e0 + b * kNsThreads;
            if (e < total) v[b] = s[e];
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int e = e0 + b * kNsThreads;
            if (e < total) d[e] = v[b];
        }
    }
}

// dst (ld rows, stride ldd) = every peer's ld x R column slab `src`
// side by side (peer p's in columns [pR, pR + R)), over DSMEM, float4
// at a time.
__device__ __forceinline__ void gather_cols(cg::cluster_group& cluster,
                                            float* dst, int ldd, float* src,
                                            int ld, int R) {
    const int row4 = ld / 4;      // float4s a row of the result
    const int slab4 = R / 4;      // float4s a row of a slab
    const int total = ld * row4;
    for (int e0 = threadIdx.x; e0 < total; e0 += kNsThreads * kBatch) {
        float4 v[kBatch];
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int e = e0 + b * kNsThreads;
            if (e < total) {
                const int row = e / row4;
                const int c4 = e - row * row4;
                const int p = c4 / slab4;
                v[b] = reinterpret_cast<const float4*>(
                    cluster.map_shared_rank(src, p))[row * slab4 + c4
                                                     - p * slab4];
            }
        }
#pragma unroll
        for (int b = 0; b < kBatch; ++b) {
            const int e = e0 + b * kNsThreads;
            if (e < total) {
                const int row = e / row4;
                const int c4 = e - row * row4;
                *reinterpret_cast<float4*>(dst + row * ldd + 4 * c4) = v[b];
            }
        }
    }
}

// acc += this CTA's rows of A B: A is this CTA's R x ld slab `a`
// (columns past M are zero), B is M x ld with peer p holding rows
// [pR, pR + R) in its `src` slab. Peer slabs come over DSMEM one at a
// time into the double buffer `buf` (two slabs).
template <int RPT>
__device__ void cluster_product(cg::cluster_group& cluster,
                                float (&acc)[RPT][4], const float* a,
                                float* src, float* buf, int R, int ld,
                                int m, int g, int G, int jq, bool active) {
    const int slab = R * ld;
    const int peers = (m + R - 1) / R;  // the CTAs that hold rows of B
    copy_peer(cluster, buf, src, slab, 0);
    __syncthreads();
    for (int p = 0; p < peers; ++p) {
        if (p + 1 < peers)
            copy_peer(cluster, buf + ((p + 1) & 1) * slab, src, slab, p + 1);
        if (active)
            fma_tile<RPT>(acc, a + p * R, ld, R, buf + (p & 1) * slab, ld, R,
                          g, G, jq);
        __syncthreads();
    }
}

// The row-slab form for kColsMaxM < M <= kNsMaxM: CTA `rank` owns rows
// [rank R, rank R + R) of S, X and T; each product brings the other
// factor's slabs from the peers (two products, two cluster barriers a
// step). A thread owns RPT rows by 4 columns. h (m, n), pht (n, m), r
// and resid (m) -> gain K (n, m), inn (n).
template <int RPT>
__global__ void __launch_bounds__(kNsThreads)
ns_cluster(const float* __restrict__ h, const float* __restrict__ pht,
           const float* __restrict__ r, const float* __restrict__ resid,
           float* gain, float* inn, int n, int m, int R, int iters) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const long long z = blockIdx.y;
    const long long nm = static_cast<long long>(n) * m;
    h += z * nm;
    pht += z * nm;
    r += z * m;
    resid += z * m;
    gain += z * nm;
    inn += z * n;
    const int ld = kCluster * R;    // a slab row holds every column
    const int slab = R * ld;
    extern __shared__ float4 smem4[];
    float* s_rows = reinterpret_cast<float*>(smem4);
    float* x_rows = s_rows + slab;
    float* t_rows = x_rows + slab;
    float* buf = t_rows + slab;     // two slabs
    float* colsum = buf + 2 * slab; // ld
    float* red = colsum + ld;       // 33
    const int tid = threadIdx.x;
    const int cg4 = ld / 4;         // column quads a row
    const int G = kNsThreads / cg4; // row groups of threads
    const int g = tid / cg4;
    const int jq = tid - g * cg4;   // this thread's columns 4 jq .. + 3
    const bool active = g < G;
    const int r0 = rank * R;
    const int nr = max(0, min(R, m - r0));
    float acc[RPT][4];
    auto clear = [&]() {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    };
    // writes this thread's outputs of rows < nrows and columns < m
    auto store = [&](float* dst, int nrows, auto value) {
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int rr = g + i * G;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = 4 * jq + c;
                if (active && rr < nrows && j < m)
                    dst[rr * ld + j] = value(rr, j, acc[i][c]);
            }
        }
    };

    for (int e = tid; e < 5 * slab + ld; e += kNsThreads) s_rows[e] = 0.0f;
    __syncthreads();

    // S rows = H[r0:r0+nr] PHᵀ + diag(r): depth n in chunks of R,
    // staged in buf (the H chunk R x R, then the PHᵀ chunk R x ld)
    clear();
    float* ha = buf;
    float* pb = buf + slab;
    for (int k0 = 0; k0 < n; k0 += R) {
        const int kc = min(R, n - k0);
        stage(ha, R * R, [&](int e) {
            const int rr = e / R;
            const int kk = e - rr * R;
            return (rr < nr && kk < kc)
                       ? h[static_cast<long long>(r0 + rr) * n + k0 + kk]
                       : 0.0f;
        });
        stage(pb, slab, [&](int e) {
            const int kk = e / ld;
            const int c = e - kk * ld;
            return (kk < kc && c < m)
                       ? pht[static_cast<long long>(k0 + kk) * m + c]
                       : 0.0f;
        });
        __syncthreads();
        if (active) fma_tile<RPT>(acc, ha, R, R, pb, ld, R, g, G, jq);
        __syncthreads();
    }
    store(s_rows, nr, [&](int rr, int j, float v) {
        return v + (r0 + rr == j ? r[j] : 0.0f);
    });
    __syncthreads();

    // ‖S‖₁: each CTA's column sums over its rows, then every CTA adds
    // the partials in rank order (the same bits in every CTA)
    for (int j = tid; j < m; j += kNsThreads) {
        float sum = 0.0f;
        for (int rr = 0; rr < nr; ++rr) sum += fabsf(s_rows[rr * ld + j]);
        colsum[j] = sum;
    }
    cluster.sync();
    float best = 0.0f;
    if (tid < m) {
        for (int p = 0; p < kCluster; ++p)
            best += cluster.map_shared_rank(colsum, p)[tid];
    }
    for (int off = 16; off > 0; off >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if ((tid & 31) == 0) red[tid >> 5] = best;
    __syncthreads();
    if (tid == 0) {
        float v = 0.0f;
        for (int w = 0; w < kNsThreads / 32; ++w) v = fmaxf(v, red[w]);
        red[32] = v;
    }
    __syncthreads();
    const float denom = red[32] * red[32];
    for (int e = tid; e < nr * m; e += kNsThreads) {
        const int rr = e / m;
        const int c = e - rr * m;
        x_rows[rr * ld + c] = s_rows[rr * ld + c] / denom;
    }

    for (int it = 0; it < iters; ++it) {
        cluster.sync();  // X complete everywhere; T no longer read
        clear();
        cluster_product<RPT>(cluster, acc, s_rows, x_rows, buf, R, ld, m, g,
                             G, jq, active);
        store(t_rows, nr, [&](int rr, int j, float v) {  // T = 2I − S X
            return (r0 + rr == j ? 2.0f : 0.0f) - v;
        });
        cluster.sync();  // T complete everywhere
        clear();
        cluster_product<RPT>(cluster, acc, x_rows, t_rows, buf, R, ld, m, g,
                             G, jq, active);
        // X = X T (every read of this CTA's X is done)
        store(x_rows, nr, [](int, int, float v) { return v; });
    }
    cluster.sync();  // the final X everywhere; T no longer read

    // K = PHᵀ X for this CTA's share of the n rows, R rows a pass (the
    // PHᵀ rows staged in t_rows), then inn = K resid
    const int share = (n + kCluster - 1) / kCluster;
    const int q_lo = min(n, rank * share);
    const int q_hi = min(n, q_lo + share);
    for (int q0 = q_lo; q0 < q_hi; q0 += R) {
        const int qr = min(R, q_hi - q0);
        stage(t_rows, slab, [&](int e) {
            const int rr = e / ld;
            const int c = e - rr * ld;
            return (rr < qr && c < m)
                       ? pht[static_cast<long long>(q0 + rr) * m + c]
                       : 0.0f;
        });
        __syncthreads();
        clear();
        cluster_product<RPT>(cluster, acc, t_rows, x_rows, buf, R, ld, m, g,
                             G, jq, active);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int rr = g + i * G;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = 4 * jq + c;
                if (active && rr < qr && j < m)
                    gain[static_cast<long long>(q0 + rr) * m + j] = acc[i][c];
            }
        }
    }
    __syncthreads();
    row_dots(inn, gain, resid, m, q_lo, q_hi);
    cluster.sync();  // no CTA leaves while a peer may still read its X
}

// The column-slab form for M <= kColsMaxM: CTA `rank` computes columns
// [rank R, rank R + R) of T and X and holds the whole of S (gathered
// once) and the whole of X (double-buffered). T's columns = 2I − S X's
// columns need nothing from the peers; X's new columns = X T's columns
// need the whole X, so each CTA stores its new columns into every
// CTA's next X buffer over DSMEM (stores do not stall the thread, where
// gathering loads did). One cluster barrier a step. A thread owns RPT
// rows by 4 columns; the whole matrices' rows are padded to ld + 4
// floats so the rows a warp reads fall in different banks. h (m, n),
// pht (n, m), r and resid (m) -> gain K (n, m), inn (n).
template <int RPT>
__global__ void __launch_bounds__(kNsThreads)
ns_cluster_cols(const float* __restrict__ h, const float* __restrict__ pht,
                const float* __restrict__ r, const float* __restrict__ resid,
                float* gain, float* inn, int n, int m, int R, int iters) {
    cg::cluster_group cluster = cg::this_cluster();
    const int rank = static_cast<int>(cluster.block_rank());
    const long long z = blockIdx.y;
    const long long nm = static_cast<long long>(n) * m;
    h += z * nm;
    pht += z * nm;
    r += z * m;
    resid += z * m;
    gain += z * nm;
    inn += z * n;
    const int ld = kCluster * R;     // padded M: rows and columns
    const int ldp = ld + 4;          // row stride of the whole matrices
    const int whole = ld * ldp;
    const int slab = ld * R;         // a CTA's columns, all rows
    extern __shared__ float4 smem4[];
    float* s_full = reinterpret_cast<float*>(smem4);  // ld x ldp
    float* xb = s_full + whole;      // two ld x ldp: the whole X, or staging
    float* t_cols = xb + 2 * whole;  // ld x R
    float* red = t_cols + slab;      // 8 warp maxima + this CTA's max
    const int tid = threadIdx.x;
    const int cg4 = R / 4;           // column quads a slab
    const int G = kNsThreads / cg4;  // row groups of threads
    const int g = tid / cg4;
    const int jq = tid - g * cg4;    // this thread's columns 4 jq .. + 3
    const bool active = g < G;
    const int c0 = rank * R;
    const int nc = max(0, min(R, m - c0));
    float acc[RPT][4];
    auto clear = [&]() {
#pragma unroll
        for (int i = 0; i < RPT; ++i)
#pragma unroll
            for (int c = 0; c < 4; ++c) acc[i][c] = 0.0f;
    };

    for (int e = tid; e < 3 * whole + slab; e += kNsThreads)
        s_full[e] = 0.0f;
    __syncthreads();

    // S columns = H PHᵀ[:, c0:c0+nc] + diag(r): depth n in chunks of KC
    // staged in xb (the H chunk ld x KC, then the PHᵀ chunk KC x R)
    const int kc_max = max(4, whole / (ld + R) / 4 * 4);
    clear();
    float* ha = xb;
    float* pb = xb + ld * kc_max;
    for (int k0 = 0; k0 < n; k0 += kc_max) {
        const int kc = min(kc_max, n - k0);
        stage(ha, ld * kc_max, [&](int e) {
            const int rr = e / kc_max;
            const int kk = e - rr * kc_max;
            return (rr < m && kk < kc)
                       ? h[static_cast<long long>(rr) * n + k0 + kk]
                       : 0.0f;
        });
        stage(pb, kc_max * R, [&](int e) {
            const int kk = e / R;
            const int c = e - kk * R;
            return (kk < kc && c < nc)
                       ? pht[static_cast<long long>(k0 + kk) * m + c0 + c]
                       : 0.0f;
        });
        __syncthreads();
        if (active)
            fma_tile<RPT>(acc, ha, kc_max, ld, pb, R, kc_max, g, G, jq);
        __syncthreads();
    }
    // S columns into t_cols (the peers gather them into s_full)
#pragma unroll
    for (int i = 0; i < RPT; ++i) {
        const int rr = g + i * G;
#pragma unroll
        for (int c = 0; c < 4; ++c) {
            const int j = 4 * jq + c;
            if (active && rr < m && j < nc)
                t_cols[rr * R + j] =
                    acc[i][c] + (rr == c0 + j ? r[c0 + j] : 0.0f);
        }
    }
    for (int e = tid; e < whole; e += kNsThreads) xb[e] = 0.0f;  // staging
    __syncthreads();

    // ‖S‖₁: this CTA's column sums and their max, then the max over the
    // cluster (exact in any order)
    float best = 0.0f;
    if (tid < nc) {
        for (int rr = 0; rr < m; ++rr) best += fabsf(t_cols[rr * R + tid]);
    }
    for (int off = 16; off > 0; off >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    if ((tid & 31) == 0) red[tid >> 5] = best;
    __syncthreads();
    if (tid == 0) {
        float v = 0.0f;
        for (int w = 0; w < kNsThreads / 32; ++w) v = fmaxf(v, red[w]);
        red[8] = v;
    }
    cluster.sync();  // S columns and column maxima ready everywhere
    float norm1 = 0.0f;
    for (int p = 0; p < kCluster; ++p)
        norm1 = fmaxf(norm1, cluster.map_shared_rank(red, p)[8]);
    const float denom = norm1 * norm1;
    gather_cols(cluster, s_full, ldp, t_cols, ld, R);
    for (int e = tid; e < m * nc; e += kNsThreads) {  // X₀ columns
        const int rr = e / nc;
        const int c = e - rr * nc;
        const float v = t_cols[rr * R + c] / denom;
        for (int p = 0; p < kCluster; ++p)
            cluster.map_shared_rank(xb, p)[rr * ldp + c0 + c] = v;
    }
    cluster.sync();  // S gathered everywhere (t_cols free); X₀ everywhere

    for (int it = 0; it < iters; ++it) {
        float* xc = xb + (it & 1) * whole;        // X
        float* xn = xb + ((it + 1) & 1) * whole;  // the next X
        clear();
        if (active)
            fma_tile<RPT>(acc, s_full, ldp, ld, xc + c0, ldp, ld, g, G, jq);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {  // T = 2I − S X
            const int rr = g + i * G;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = 4 * jq + c;
                if (active && rr < m && j < nc)
                    t_cols[rr * R + j] =
                        (rr == c0 + j ? 2.0f : 0.0f) - acc[i][c];
            }
        }
        __syncthreads();
        clear();
        if (active) fma_tile<RPT>(acc, xc, ldp, ld, t_cols, R, ld, g, G, jq);
        // X T's columns into every CTA's next X (columns past M come
        // out exactly 0: T's are 0)
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int rr = g + i * G;
            if (active && rr < m) {
                const float4 v =
                    make_float4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
                for (int p = 0; p < kCluster; ++p)
                    *reinterpret_cast<float4*>(
                        cluster.map_shared_rank(xn, p) + rr * ldp + c0
                        + 4 * jq) = v;
            }
        }
        cluster.sync();  // the next X everywhere; this one no longer read
    }

    // K columns = PHᵀ X columns, `rows` rows of PHᵀ a pass (as many as
    // the threads cover, at most ld) staged in the other X buffer
    const float* xf = xb + (iters & 1) * whole + c0;
    float* stage_k = xb + ((iters + 1) & 1) * whole;
    const int rows = min(ld, RPT * G);
    for (int q0 = 0; q0 < n; q0 += rows) {
        const int qr = min(rows, n - q0);
        stage(stage_k, whole, [&](int e) {
            const int rr = e / ldp;
            const int c = e - rr * ldp;
            return (rr < qr && c < m)
                       ? pht[static_cast<long long>(q0 + rr) * m + c]
                       : 0.0f;
        });
        __syncthreads();
        clear();
        if (active)
            fma_tile<RPT>(acc, stage_k, ldp, ld, xf, ldp, ld, g, G, jq);
#pragma unroll
        for (int i = 0; i < RPT; ++i) {
            const int rr = g + i * G;
#pragma unroll
            for (int c = 0; c < 4; ++c) {
                const int j = 4 * jq + c;
                if (active && rr < qr && j < nc)
                    gain[static_cast<long long>(q0 + rr) * m + c0 + j] =
                        acc[i][c];
            }
        }
        __syncthreads();
    }
    cluster.sync();  // every CTA's columns of K written
    // inn = K resid, this CTA's share of the rows
    const int share = (n + kCluster - 1) / kCluster;
    row_dots(inn, gain, resid, m, min(n, rank * share),
             min(n, (rank + 1) * share));
}

// A cluster launch: kCluster CTAs per stream (blockIdx.y).
template <typename... Params, typename... Args>
int launch_cluster(void (*kernel)(Params...), size_t smem, int streams,
                   cudaStream_t stream, Args... args) {
    cudaError_t err = cudaFuncSetAttribute(
        kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(kCluster, streams, 1);
    cfg.blockDim = dim3(kNsThreads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.stream = stream;
    cudaLaunchAttribute attr[1];
    attr[0].id = cudaLaunchAttributeClusterDimension;
    attr[0].val.clusterDim.x = kCluster;
    attr[0].val.clusterDim.y = 1;
    attr[0].val.clusterDim.z = 1;
    cfg.attrs = attr;
    cfg.numAttrs = 1;
    err = cudaLaunchKernelEx(&cfg, kernel, args...);
    if (err != cudaSuccess) return static_cast<int>(err);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

// rows (or columns) per CTA: a multiple of 4, so float4 loads stay
// aligned
int cluster_rows(int m) {
    return ((m + kCluster - 1) / kCluster + 3) / 4 * 4;
}

// The cluster Newton–Schulz in `form` (kColumns or kRows). Column form
// (M <= 128): R / 4 column quads leave G >= 64 row groups, so a thread
// holds one or two of the M rows. Row form (M <= 256): at most 32 rows
// a slab over at least 4 row groups.
int ns_cluster_launch(int form, cudaStream_t stream, int streams,
                      const float* h, const float* pht, const float* r,
                      const float* resid, float* gain, float* inn, int n,
                      int m, int iters) {
    const int R = cluster_rows(m);
    const int ld = kCluster * R;
    if (form == kColumns) {
        const size_t smem =
            (3LL * ld * (ld + 4) + 1LL * ld * R + 9) * sizeof(float);
        const bool one = m <= kNsThreads / (R / 4);
        return launch_cluster(one ? ns_cluster_cols<1> : ns_cluster_cols<2>,
                              smem, streams, stream, h, pht, r, resid, gain,
                              inn, n, m, R, iters);
    }
    const size_t smem = (5LL * R * ld + ld + 33) * sizeof(float);
    return launch_cluster(ns_cluster<kRowsRpt>, smem, streams, stream, h,
                          pht, r, resid, gain, inn, n, m, R, iters);
}

// -------------------- second path (M > kNsMaxM): one block per stream
constexpr int kBlockNsThreads = 1024;

// S⁻¹ by Newton–Schulz, one block per stream: x ← x (2I − S x), `iters`
// times, from x₀ = S / ‖S‖₁² (‖·‖₁ = max column abs sum; S is symmetric).
__global__ void __launch_bounds__(kBlockNsThreads)
newton_schulz(const float* __restrict__ s, float* x, float* t, float* y,
              int m, int iters) {
    __shared__ float colmax[kBlockNsThreads];
    const int mm = m * m;
    const long long off = static_cast<long long>(blockIdx.x) * mm;
    s += off;
    x += off;
    t += off;
    y += off;
    const int tid = threadIdx.x;
    float best = 0.0f;
    for (int j = tid; j < m; j += kBlockNsThreads) {
        float acc = 0.0f;
        for (int i = 0; i < m; ++i) acc += fabsf(s[i * m + j]);
        best = fmaxf(best, acc);
    }
    colmax[tid] = best;
    __syncthreads();
    for (int stride = kBlockNsThreads / 2; stride > 0; stride >>= 1) {
        if (tid < stride)
            colmax[tid] = fmaxf(colmax[tid], colmax[tid + stride]);
        __syncthreads();
    }
    const float norm1 = colmax[0];
    const float denom = norm1 * norm1;
    for (int e = tid; e < mm; e += kBlockNsThreads) x[e] = s[e] / denom;
    __syncthreads();
    for (int it = 0; it < iters; ++it) {
        for (int e = tid; e < mm; e += kBlockNsThreads) {  // t = 2I − S x
            int r = e / m;
            int c = e - r * m;
            float acc = 0.0f;
            for (int q = 0; q < m; ++q)
                acc = fmaf(s[r * m + q], x[q * m + c], acc);
            t[e] = (r == c ? 2.0f : 0.0f) - acc;
        }
        __syncthreads();
        for (int e = tid; e < mm; e += kBlockNsThreads) {  // y = x t
            int r = e / m;
            int c = e - r * m;
            float acc = 0.0f;
            for (int q = 0; q < m; ++q)
                acc = fmaf(x[r * m + q], t[q * m + c], acc);
            y[e] = acc;
        }
        __syncthreads();
        for (int e = tid; e < mm; e += kBlockNsThreads) x[e] = y[e];
        __syncthreads();
    }
}

}  // namespace

// f32 scratch the update needs per stream, in floats (the wrapper
// allocates streams times this).
extern "C" long long mekf_update_scratch_floats(int n, int m) {
    return 2LL * n * m + 4LL * m * m + 2LL * n * n;
}

// The Newton–Schulz form the entry point takes for M when none is
// forced: 1 columns, 2 rows (the 8-CTA cluster), 3 block.
extern "C" int mekf_update_form(int m) {
    return m <= kColsMaxM ? kColumns : m <= kNsMaxM ? kRows : kBlock;
}

// S streams packed along a leading axis: cov (S, n, n), h (S, m, n),
// r (S, m), resid (S, m) -> inn (S, n), cov_out (S, n, n). form: 0
// picks by M (`mekf_update_form`), 1-3 force a form that takes M. marks
// (may be null): events recorded after PHᵀ, after S⁻¹ (with S, K and
// inn on the cluster path) and at the end.
extern "C" int mekf_fused_update_batched(const float* cov, const float* h,
                                         const float* r, const float* resid,
                                         float* inn, float* cov_out,
                                         float* scratch, int streams, int n,
                                         int m, int ns_iters, int form,
                                         cudaEvent_t* marks, int n_marks,
                                         cudaStream_t stream) {
    if (form == kAuto) form = mekf_update_form(m);
    if (n <= 0 || m <= 0 || streams <= 0 || streams > 65535
        || form < kColumns || form > kBlock || m > form_max_m(form))
        return static_cast<int>(cudaErrorInvalidValue);
    const long long nm = static_cast<long long>(n) * m;
    const long long mm = static_cast<long long>(m) * m;
    const long long nn = static_cast<long long>(n) * n;
    float* pht = scratch;                // (S, n, m)  P Hᵀ
    float* gain = pht + streams * nm;    // (S, n, m)  K
    float* s = gain + streams * nm;      // (S, m, m)  S (second path)
    float* x = s + streams * mm;         // (S, m, m)  S⁻¹ iterate
    float* t = x + streams * mm;         // (S, m, m)
    float* y = t + streams * mm;         // (S, m, m)
    float* ikh = y + streams * mm;       // (S, n, n)  I − K H
    float* t1 = ikh + streams * nn;      // (S, n, n)  (I − K H) P
    int err;
    if ((err = launch_gemm<kStore>(       // P Hᵀ
             gemm1(n, m, n, op(cov, n, 0, nn), op(h, n, 1, nm), pht, m, nm),
             streams, stream)))
        return err;
    aruco_mark(marks, n_marks, 0, stream);
    if (form != kBlock) {
        if ((err = ns_cluster_launch(form, stream, streams, h, pht, r, resid,
                                     gain, inn, n, m, ns_iters)))
            return err;
    } else {
        Gemm sg = gemm1(m, m, n, op(h, n, 0, nm), op(pht, m, 0, nm), s, m,
                        mm);
        sg.r = r;
        sg.sr = m;
        if ((err = launch_gemm<kAddDiag>(sg, streams, stream))) return err;
        newton_schulz<<<streams, kBlockNsThreads, 0, stream>>>(s, x, t, y, m,
                                                               ns_iters);
        ARUCO_LAUNCH_CHECK();
        if ((err = launch_gemm<kStore>(
                 gemm1(n, m, m, op(pht, m, 0, nm), op(x, m, 0, mm), gain, m,
                       nm),
                 streams, stream)))
            return err;
        if ((err = launch_gemm<kStore>(
                 gemm1(n, 1, m, op(gain, m, 0, nm), op(resid, 1, 0, m), inn,
                       1, n),
                 streams, stream)))
            return err;
    }
    aruco_mark(marks, n_marks, 1, stream);
    if ((err = launch_gemm<kEyeMinus>(    // I − K H
             gemm1(n, n, m, op(gain, m, 0, nm), op(h, n, 0, nm), ikh, n, nn),
             streams, stream)))
        return err;
    if ((err = launch_gemm<kStore>(       // (I − K H) P
             gemm1(n, n, n, op(ikh, n, 0, nn), op(cov, n, 0, nn), t1, n, nn),
             streams, stream)))
        return err;
    // sym([(I−KH)P | K diag(r)] [(I−KH) | K]ᵀ)
    Gemm jg = gemm1(n, n, n, op(t1, n, 0, nn), op(ikh, n, 1, nn), cov_out, n,
                    nn);
    jg.segs = 2;
    jg.depth[1] = m;
    jg.a[1] = op(gain, m, 0, nm, r, m);
    jg.b[1] = op(gain, m, 1, nm);
    if ((err = launch_gemm<kSymPair>(jg, streams, stream))) return err;
    aruco_mark(marks, n_marks, 2, stream);
    return 0;
}
