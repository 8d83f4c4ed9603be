// Stencil-only min-label flooding: `iters` Jacobi rounds of the 8-
// connected 3x3 min over a mask whose 1-px ring is cleared.
//
// Replaces the TPU kernel aruco_slam_tpu/ops/pallas_cc.py
// `_flood_kernel` (wrapper `flood_labels`), which keeps the label image
// resident in VMEM for every round. It is the whole labeling schedule
// of ops/detect.py `_connected_components` when scan_rounds == 0.
// Output is bit-identical: labels are integers and every step is a min.
//
// What bounds it on Hopper: memory traffic and launches. A 270x480
// int32 label image is 518 KB and does not fit one SM's 227 KB of
// shared memory, so the TPU's single-program design does not carry
// over. Design: temporal tiling. A block owns a kTile x kTile output
// tile and loads it with a kHalo-pixel halo ((kTile + 2 kHalo)^2 labels
// and mask bytes) into shared memory, runs up to kHalo Jacobi rounds
// there (double-buffered, one __syncthreads per round) and writes the
// interior. Each round can only corrupt the ring it reads past the
// halo's edge, so the exact region shrinks by one pixel per round and
// the interior stays exact after kHalo rounds. A call is
// ceil(iters / kHalo) launches over every frame at once, ping-ponging
// between two global buffers; global memory is read and written once
// per kHalo rounds instead of once per round. Outside the frame counts
// as background, like the reference's big-valued padding.
#include <cstdint>

#include "common.cuh"

namespace {

constexpr int kTile = 32;
constexpr int kHalo = 8;  // rounds per launch
constexpr int kSpan = kTile + 2 * kHalo;
constexpr int kThreads = 256;

// init != 0: seed labels from the mask (flat index, background h*w)
// instead of reading src.
__global__ void __launch_bounds__(kThreads)
flood_rounds(const uint8_t* __restrict__ fg, const int* __restrict__ src,
             int* __restrict__ dst, int h, int w, int rounds, int init) {
    __shared__ int lab[2][kSpan * kSpan];
    __shared__ uint8_t msk[kSpan * kSpan];
    const int big = h * w;
    const long long base = static_cast<long long>(blockIdx.z) * h * w;
    const int y0 = static_cast<int>(blockIdx.y) * kTile - kHalo;
    const int x0 = static_cast<int>(blockIdx.x) * kTile - kHalo;

    for (int j = threadIdx.x; j < kSpan * kSpan; j += kThreads) {
        const int r = j / kSpan;
        const int c = j - r * kSpan;
        const int y = y0 + r;
        const int x = x0 + c;
        const bool in = y >= 0 && y < h && x >= 0 && x < w;
        const int p = y * w + x;
        const bool f = in && fg[base + p] != 0;
        msk[j] = f ? 1 : 0;
        lab[0][j] = f ? (init ? p : src[base + p]) : big;
    }
    __syncthreads();

    int cur = 0;
    for (int it = 0; it < rounds; ++it) {
        const int* a = lab[cur];
        int* b = lab[cur ^ 1];
        for (int j = threadIdx.x; j < kSpan * kSpan; j += kThreads) {
            int m = big;
            if (msk[j]) {
                const int r = j / kSpan;
                const int c = j - r * kSpan;
                const int r0 = max(r - 1, 0), r1 = min(r + 1, kSpan - 1);
                const int c0 = max(c - 1, 0), c1 = min(c + 1, kSpan - 1);
                for (int rr = r0; rr <= r1; ++rr)
                    for (int cc = c0; cc <= c1; ++cc)
                        m = min(m, a[rr * kSpan + cc]);
            }
            b[j] = m;
        }
        __syncthreads();
        cur ^= 1;
    }

    for (int j = threadIdx.x; j < kTile * kTile; j += kThreads) {
        const int r = j / kTile;
        const int c = j - r * kTile;
        const int y = y0 + kHalo + r;
        const int x = x0 + kHalo + c;
        if (y < h && x < w)
            dst[base + static_cast<long long>(y) * w + x] =
                lab[cur][(r + kHalo) * kSpan + (c + kHalo)];
    }
}

}  // namespace

// fg: (frames, h, w) uint8 mask with its 1-px ring already cleared;
// labels: (frames, h, w) int32 output; scratch: the same shape, the
// ping-pong buffer. iters == 0 writes the seed labels.
extern "C" int flood_labels(const uint8_t* fg, int* labels, int* scratch,
                            int frames, int h, int w, int iters,
                            cudaStream_t stream) {
    if (frames == 0 || h == 0 || w == 0) return 0;
    const dim3 grid((w + kTile - 1) / kTile, (h + kTile - 1) / kTile,
                    frames);
    const int launches = iters > 0 ? (iters + kHalo - 1) / kHalo : 1;
    // the last launch writes `labels`
    int* bufs[2] = {labels, scratch};
    const int* src = nullptr;
    for (int k = 0; k < launches; ++k) {
        int* dst = bufs[(launches - 1 - k) & 1];
        const int rounds = min(kHalo, iters - k * kHalo);
        flood_rounds<<<grid, kThreads, 0, stream>>>(
            fg, src, dst, h, w, max(rounds, 0), k == 0);
        ARUCO_LAUNCH_CHECK();
        src = dst;
    }
    return 0;
}
