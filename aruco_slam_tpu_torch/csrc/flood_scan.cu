// Connected-component labeling by min-label flooding: blocks of 3x3
// min-stencil rounds alternating with segmented row/column min-scans.
//
// Replaces two TPU kernels of aruco_slam_tpu/ops/pallas_cc.py:
//  * `_flood_scan_kernel` (wrapper `flood_scan_labels`), which runs the
//    whole schedule of ops/detect.py `_connected_components` with the
//    label image resident in VMEM: `per` Jacobi rounds, then
//    `scan_rounds` times a row scan (forward, then backward on the
//    forward result), a column scan and `per` more rounds
//    (flood_scan_labels here);
//  * `_flood_kernel` (wrapper `flood_labels`): `iters` Jacobi rounds
//    alone, the schedule when scan_rounds == 0 (flood_labels here: the
//    same stencil launches, at most kStencilOnlyRounds rounds each).
// Output is bit-identical to that schedule: labels are integers and
// every step is a min.
//
// What bounds it on Hopper: the bound is int32 operations (5 a pixel a
// stencil round: 2 vertical and 2 horizontal mins and a select; 2 a
// scan pass: a min and a select; 15 rounds and 16 passes at the
// detector's 16 iterations and 4 scan rounds: 1.78 G at (32, 540, 960),
// 0.106 ms at 132 SMs x 64 lanes x 1.98 GHz, over the 83 MB of mask in
// and labels out at 3.35 TB/s, 0.025 ms). A 540x960 int32 label image
// is 2 MB and fits no SM's shared memory, so the TPU's one-program
// design does not carry over: the schedule is one launch a group, each
// reading and writing the label batch once. Design:
//  * Stencil blocks: each block of `per` rounds is one launch (at most
//    kMaxHalo rounds a launch), temporally tiled. A warp owns a tile of
//    32 columns (one a lane) by kTileRows + 2 per rows, held in
//    registers; a round is the separable min, vertical in each lane's
//    registers and horizontal by __shfl_up/down_sync, so no shared
//    memory and no __syncthreads. Each round corrupts only the ring it
//    reads past the tile's edge, so the exact region shrinks one pixel
//    a round and the warp writes its (32 − 2 per) x kTileRows interior:
//    Jacobi exactly (an in-place Gauss–Seidel update would reach
//    further per round and break bit-identity). The first launch seeds
//    the labels from the mask (the 1-px ring cleared). The 2-D grid
//    (tiles in x and y, the frame in z) needs no divide per pixel.
//    Foreground is label < h*w everywhere after the seed, so no launch
//    after the first reads the mask.
//  * Segmented scans: a running min that restarts at every background
//    pixel, without the reference's monotonic key, so no int32 bit
//    budget limits the frame size. Rows: a block stages 8 rows in
//    shared memory with coalesced loads, kLoadBatch in flight a thread;
//    a warp scans a row, each lane a contiguous chunk, and the chunk
//    carries (the last run's min and whether the chunk held a reset)
//    combine in order, forward and then backward, before the block
//    writes the rows back. Columns: a block stages up to 16 adjacent
//    columns over the whole height (coalesced 64-byte rows) and splits
//    the height among its threads the same way (16 workers a column).
// Launches a call: 1 + 3 scan_rounds while per <= kMaxHalo (13 at the
// detector's 16 iterations and 4 rounds), in place of the first
// design's 1 + per + (2 + per) scan_rounds (25).
#include <cstdint>

#include "common.cuh"

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kTileRows = 32;        // interior rows of a warp tile
constexpr int kMaxHalo = 8;          // Jacobi rounds (and halo) a launch
// rounds a launch of the stencil-only schedule: of 16 rounds as 2 x 8,
// 3 x 5-6 and 4 x 4, 4 x 4 took the least device time on the H100 at
// (32, 540, 960) and (32, 270, 480) (PERF.md, chip_smoke.py `_b4`): a
// tile's halo costs more than a pass over the label batch
constexpr int kStencilOnlyRounds = 4;
constexpr int kStencilWarps = 8;
constexpr int kStencilThreads = kStencilWarps * 32;
constexpr int kScanThreads = 256;    // row scans: 8 rows, a warp each
constexpr int kRowsPerBlock = kScanThreads / 32;
constexpr int kColThreads = 256;     // column scans
constexpr int kLoadBatch = 8;        // global loads in flight a thread
constexpr size_t kMaxColSmem = 200 * 1024;

// H Jacobi rounds over one warp tile per warp. src == nullptr seeds
// from the mask: its 1-px ring cleared, foreground = flat index,
// background = h*w. Outside the frame counts as background.
template <int H>
__global__ void __launch_bounds__(kStencilThreads)
stencil_rounds(const uint8_t* __restrict__ fg, const int* __restrict__ src,
               int* __restrict__ dst, int h, int w) {
    constexpr int kRows = kTileRows + 2 * H;
    constexpr int kInner = 32 - 2 * H;   // columns a warp writes
    const int lane = threadIdx.x & 31;
    const int tile = blockIdx.x * kStencilWarps + (threadIdx.x >> 5);
    const int x0 = tile * kInner - H;    // the tile's first column
    if (x0 + H >= w) return;             // warp-uniform: no interior
    const int y0 = static_cast<int>(blockIdx.y) * kTileRows - H;
    const long long base = static_cast<long long>(blockIdx.z) * h * w;
    const int big = h * w;
    const int x = x0 + lane;
    const bool xin = x >= 0 && x < w;
    int lab[kRows];
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
        const int y = y0 + i;
        int v = big;
        if (xin && y >= 0 && y < h) {
            const int p = y * w + x;
            if (src == nullptr)
                v = (fg[base + p] != 0 && y > 0 && y < h - 1 && x > 0
                     && x < w - 1) ? p : big;
            else
                v = src[base + p];
        }
        lab[i] = v;
    }
#pragma unroll
    for (int round = 0; round < H; ++round) {
        int up = big;   // the old label of the row above
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
            const int cur = lab[i];
            const int down = i + 1 < kRows ? lab[i + 1] : big;
            const int v = min(min(up, cur), down);
            const int left = __shfl_up_sync(kFull, v, 1);
            const int right = __shfl_down_sync(kFull, v, 1);
            const int m = min(v, min(lane > 0 ? left : big,
                                     lane < 31 ? right : big));
            lab[i] = cur != big ? m : big;   // foreground iff label < h*w
            up = cur;
        }
    }
    if (lane >= H && lane < 32 - H && x < w) {
#pragma unroll
        for (int i = H; i < H + kTileRows; ++i) {
            const int y = y0 + i;
            if (y < h) dst[base + static_cast<long long>(y) * w + x] = lab[i];
        }
    }
}

template <int H>
int launch_stencil(const uint8_t* fg, const int* src, int* dst, int frames,
                   int h, int w, cudaStream_t stream) {
    constexpr int kInner = 32 - 2 * H;
    const int tiles = (w + kInner - 1) / kInner;
    const dim3 grid((tiles + kStencilWarps - 1) / kStencilWarps,
                    (h + kTileRows - 1) / kTileRows, frames);
    stencil_rounds<H><<<grid, kStencilThreads, 0, stream>>>(fg, src, dst, h,
                                                            w);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

int stencil(int rounds, const uint8_t* fg, const int* src, int* dst,
            int frames, int h, int w, cudaStream_t stream) {
    switch (rounds) {
        case 0: return launch_stencil<0>(fg, src, dst, frames, h, w, stream);
        case 1: return launch_stencil<1>(fg, src, dst, frames, h, w, stream);
        case 2: return launch_stencil<2>(fg, src, dst, frames, h, w, stream);
        case 3: return launch_stencil<3>(fg, src, dst, frames, h, w, stream);
        case 4: return launch_stencil<4>(fg, src, dst, frames, h, w, stream);
        case 5: return launch_stencil<5>(fg, src, dst, frames, h, w, stream);
        case 6: return launch_stencil<6>(fg, src, dst, frames, h, w, stream);
        case 7: return launch_stencil<7>(fg, src, dst, frames, h, w, stream);
        case 8: return launch_stencil<8>(fg, src, dst, frames, h, w, stream);
        default: return static_cast<int>(cudaErrorInvalidValue);
    }
}

// The segmented min-scan of one line of `len` labels at line[k *
// stride] (background = big resets the run), forward and then backward
// on the forward result, by `workers` threads of the block (this one is
// worker t), each over a contiguous chunk. agg/flag hold this line's
// chunk carries: the chunk's last run min and whether it held a reset.
// Every thread of the block calls it together (it synchronises).
__device__ void seg_scan_line(int* line, int stride, int len, int t,
                              int workers, int big, int* agg, int* flag) {
    const int chunk = (len + workers - 1) / workers;
    const int a = min(len, t * chunk);
    const int b = min(len, a + chunk);
    // forward
    int run = big;
    int reset = 0;
    for (int k = a; k < b; ++k) {
        const int v = line[k * stride];
        if (v == big) {
            run = big;
            reset = 1;
        } else {
            run = min(run, v);
            line[k * stride] = run;
        }
    }
    agg[t] = run;
    flag[t] = reset;
    __syncthreads();
    int carry = big;
    for (int q = 0; q < t; ++q) carry = flag[q] ? agg[q] : min(carry, agg[q]);
    if (carry != big) {
        for (int k = a; k < b; ++k) {
            const int v = line[k * stride];
            if (v == big) break;
            line[k * stride] = min(v, carry);
        }
    }
    __syncthreads();
    // backward, on the forward result
    run = big;
    reset = 0;
    for (int k = b - 1; k >= a; --k) {
        const int v = line[k * stride];
        if (v == big) {
            run = big;
            reset = 1;
        } else {
            run = min(run, v);
            line[k * stride] = run;
        }
    }
    agg[t] = run;
    flag[t] = reset;
    __syncthreads();
    carry = big;
    for (int q = workers - 1; q > t; --q)
        carry = flag[q] ? agg[q] : min(carry, agg[q]);
    if (carry != big) {
        for (int k = b - 1; k >= a; --k) {
            const int v = line[k * stride];
            if (v == big) break;
            line[k * stride] = min(v, carry);
        }
    }
    __syncthreads();
}

// kRowsPerBlock rows (of `lines` = frames x h) a block, a warp a row.
__global__ void __launch_bounds__(kScanThreads)
scan_rows(int* __restrict__ labels, long long lines, int w, int big) {
    extern __shared__ int smem[];
    int* rows = smem;
    int* agg = rows + kRowsPerBlock * w;
    int* flag = agg + kScanThreads;
    const long long line0 = static_cast<long long>(blockIdx.x) * kRowsPerBlock;
    const int nl = static_cast<int>(
        min(static_cast<long long>(kRowsPerBlock), lines - line0));
    int* g = labels + line0 * w;
    const int tid = threadIdx.x;
    const int total = nl * w;
    for (int e0 = tid; e0 < total; e0 += kScanThreads * kLoadBatch) {
        int v[kLoadBatch];
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
            const int e = e0 + b * kScanThreads;
            if (e < total) v[b] = g[e];
        }
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
            const int e = e0 + b * kScanThreads;
            if (e < total) rows[e] = v[b];
        }
    }
    __syncthreads();
    const int warp = tid >> 5;
    seg_scan_line(rows + warp * w, 1, warp < nl ? w : 0, tid & 31, 32, big,
                  agg + warp * 32, flag + warp * 32);
    for (int e = tid; e < total; e += kScanThreads) g[e] = rows[e];
}

// `cw` adjacent columns of one frame (blockIdx.y) a block, the height
// split among kColThreads / cw workers a column.
__global__ void __launch_bounds__(kColThreads)
scan_cols(int* __restrict__ labels, int h, int w, int cw, int big) {
    extern __shared__ int smem[];
    int* cols = smem;                 // [h][cw]
    int* agg = cols + h * cw;
    int* flag = agg + kColThreads;
    const int x0 = static_cast<int>(blockIdx.x) * cw;
    const int nc = min(cw, w - x0);
    int* g = labels + static_cast<long long>(blockIdx.y) * h * w + x0;
    const int tid = threadIdx.x;
    const int total = h * cw;
    for (int e0 = tid; e0 < total; e0 += kColThreads * kLoadBatch) {
        int v[kLoadBatch];
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
            const int e = e0 + b * kColThreads;
            const int y = e / cw;
            const int c = e - y * cw;
            if (e < total)
                v[b] = c < nc ? g[static_cast<long long>(y) * w + c] : big;
        }
#pragma unroll
        for (int b = 0; b < kLoadBatch; ++b) {
            const int e = e0 + b * kColThreads;
            if (e < total) cols[e] = v[b];
        }
    }
    __syncthreads();
    const int workers = kColThreads / cw;
    const int c = tid % cw;
    seg_scan_line(cols + c, cw, h, tid / cw, workers, big, agg + c * workers,
                  flag + c * workers);
    for (int e = tid; e < total; e += kColThreads) {
        const int y = e / cw;
        const int cc = e - y * cw;
        if (cc < nc) g[static_cast<long long>(y) * w + cc] = cols[e];
    }
}

int scan_rows_launch(int* labels, int frames, int h, int w,
                     cudaStream_t stream) {
    const long long lines = static_cast<long long>(frames) * h;
    const size_t smem = (static_cast<size_t>(kRowsPerBlock) * w
                         + 2 * kScanThreads) * sizeof(int);
    cudaError_t err = cudaFuncSetAttribute(
        scan_rows, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
    scan_rows<<<aruco_blocks(lines, kRowsPerBlock), kScanThreads, smem,
                stream>>>(labels, lines, w, h * w);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

int scan_cols_launch(int* labels, int frames, int h, int w,
                     cudaStream_t stream) {
    int cw = 16;  // the widest column group whose staging fits
    auto bytes = [&](int c) {
        return (static_cast<size_t>(h) * c + 2 * kColThreads) * sizeof(int);
    };
    while (cw > 1 && bytes(cw) > kMaxColSmem) cw /= 2;
    if (bytes(cw) > kMaxColSmem)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaError_t err = cudaFuncSetAttribute(
        scan_cols, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(bytes(cw)));
    if (err != cudaSuccess) return static_cast<int>(err);
    const dim3 grid((w + cw - 1) / cw, frames);
    scan_cols<<<grid, kColThreads, bytes(cw), stream>>>(labels, h, w, cw,
                                                        h * w);
    ARUCO_LAUNCH_CHECK();
    return 0;
}

// The schedule: an opening stencil block of `per` rounds (seeded from
// the mask), then scan_rounds times row scans, column scans and another
// block. A block is ceil(per / cap) launches of balanced rounds (per ==
// 0: one launch that only seeds). marks (may be null): events recorded
// after the opening block and after each later launch group.
int run_schedule(const uint8_t* fg, int* labels, int* scratch, int frames,
                 int h, int w, int iters, int scan_rounds, int cap,
                 cudaEvent_t* marks, int n_marks, cudaStream_t stream) {
    if (frames == 0) return 0;
    if (frames > 65535 || iters < 0 || scan_rounds < 0 || cap < 1
        || cap > kMaxHalo)
        return static_cast<int>(cudaErrorInvalidValue);
    const int per = scan_rounds ? max(1, iters / (scan_rounds + 1)) : iters;
    const int per_block = max(1, (per + cap - 1) / cap);
    const int total = per_block * (scan_rounds + 1);
    int* bufs[2] = {labels, scratch};  // the last launch writes labels
    int launched = 0;
    int* cur = nullptr;
    auto stencil_block = [&]() -> int {
        for (int k = 0; k < per_block; ++k) {
            const int rounds = per / per_block + (k < per % per_block);
            int* dst = bufs[(total - 1 - launched) & 1];
            int err = stencil(rounds, fg, cur, dst, frames, h, w, stream);
            if (err) return err;
            cur = dst;
            ++launched;
        }
        return 0;
    };
    int err = stencil_block();
    if (err) return err;
    int mark = 0;
    aruco_mark(marks, n_marks, mark++, stream);
    for (int s = 0; s < scan_rounds; ++s) {
        // the scans work in place on the current buffer
        if ((err = scan_rows_launch(cur, frames, h, w, stream))) return err;
        aruco_mark(marks, n_marks, mark++, stream);
        if ((err = scan_cols_launch(cur, frames, h, w, stream))) return err;
        aruco_mark(marks, n_marks, mark++, stream);
        if ((err = stencil_block())) return err;
        aruco_mark(marks, n_marks, mark++, stream);
    }
    return 0;
}

}  // namespace

// fg: (frames, h, w) uint8 mask (nonzero = foreground); labels:
// (frames, h, w) int32 output; scratch: the same shape, the stencil
// launches' ping-pong buffer. marks (may be null): events recorded
// after the opening stencil block and after each later launch group
// (row scans, column scans, stencil block).
extern "C" int flood_scan_labels(const uint8_t* fg, int* labels, int* scratch,
                                 int frames, int h, int w, int iters,
                                 int scan_rounds, cudaEvent_t* marks,
                                 int n_marks, cudaStream_t stream) {
    return run_schedule(fg, labels, scratch, frames, h, w, iters,
                        scan_rounds, kMaxHalo, marks, n_marks, stream);
}

// The stencil-only schedule: `iters` rounds on the raw mask (its 1-px
// ring cleared in the seeding launch), arguments as above; iters == 0
// writes the seed labels.
extern "C" int flood_labels(const uint8_t* fg, int* labels, int* scratch,
                            int frames, int h, int w, int iters,
                            cudaStream_t stream) {
    return run_schedule(fg, labels, scratch, frames, h, w, iters, 0,
                        kStencilOnlyRounds, nullptr, 0, stream);
}

// flood_labels at most `cap` (1 to 8) rounds a launch: for timing and
// testing each split of the rounds.
extern "C" int flood_labels_split(const uint8_t* fg, int* labels,
                                  int* scratch, int frames, int h, int w,
                                  int iters, int cap, cudaStream_t stream) {
    return run_schedule(fg, labels, scratch, frames, h, w, iters, 0, cap,
                        nullptr, 0, stream);
}
