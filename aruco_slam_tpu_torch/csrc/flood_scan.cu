// Connected-component labeling by min-label flooding: 3x3 min-stencil
// rounds alternating with segmented row/column min-scans.
//
// Replaces the TPU kernel aruco_slam_tpu/ops/pallas_cc.py
// `_flood_scan_kernel` (wrapper `flood_scan_labels`), which runs the
// whole schedule of ops/detect.py `_connected_components` with the
// label image resident in VMEM. Output is bit-identical to that
// schedule: labels are integers and every step is a min.
//
// What bounds it on Hopper: memory traffic. A 540x960 int32 label
// image is 2 MB — it does not fit one SM's 227 KB of shared memory, so
// the TPU's single-program design does not carry over; but a batch of
// frames (16 x 2 MB) sits in the 50 MB L2, so the rounds mostly hit L2.
// Design:
//  * the stencil is Jacobi (each round reads the whole previous image),
//    so each round is one launch over all frames that reads one buffer
//    and writes the other (ping-pong). An in-place tiled update would
//    be Gauss-Seidel: it reaches further per round and breaks
//    bit-identity with the reference.
//  * a segmented min-scan is a running min that restarts at every
//    background pixel. One thread owns one line (row or column) of one
//    frame and walks it forward, then backward over its own forward
//    result, in place (ops/detect.py `seg_scan`: the backward pass
//    consumes the forward one). This is the reference's monotonic-key
//    cummax without the key, so no int32 bit budget limits the frame
//    size: 1080x1920 grids label too. Column walks are coalesced
//    across a warp; row walks are strided — the simple form first.
#include <cstdint>

#include "common.cuh"

namespace {

// Clear the 1-px border of the mask and seed each foreground pixel
// with its own flat index; background = h*w.
__global__ void init_labels(const uint8_t* __restrict__ fg_in,
                            uint8_t* __restrict__ fg,
                            int* __restrict__ labels, long long total,
                            int h, int w) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    if (i >= total) return;
    int p = static_cast<int>(i % (static_cast<long long>(h) * w));
    int y = p / w;
    int x = p - y * w;
    bool f = fg_in[i] != 0 && y > 0 && y < h - 1 && x > 0 && x < w - 1;
    fg[i] = f ? 1 : 0;
    labels[i] = f ? p : h * w;
}

// One Jacobi round: dst = min over the 3x3 neighbourhood of src
// (outside the frame counts as background), background stays h*w.
__global__ void stencil_round(const uint8_t* __restrict__ fg,
                              const int* __restrict__ src,
                              int* __restrict__ dst, long long total,
                              int h, int w) {
    long long i = blockIdx.x * static_cast<long long>(blockDim.x)
                  + threadIdx.x;
    if (i >= total) return;
    int big = h * w;
    if (!fg[i]) {
        dst[i] = big;
        return;
    }
    int p = static_cast<int>(i % big);
    int y = p / w;
    int x = p - y * w;
    const int* frame = src + (i - p);
    int m = big;
    for (int dy = -1; dy <= 1; ++dy) {
        int yy = y + dy;
        if (yy < 0 || yy >= h) continue;
        for (int dx = -1; dx <= 1; ++dx) {
            int xx = x + dx;
            if (xx < 0 || xx >= w) continue;
            m = min(m, frame[yy * w + xx]);
        }
    }
    dst[i] = m;
}

// Segmented min-scan along `count` elements at `stride`, forward then
// backward, in place. Background pixels hold h*w and reset the run.
__device__ void seg_scan_line(const uint8_t* __restrict__ fg,
                              int* __restrict__ labels, long long base,
                              int count, int stride, int big) {
    int run = big;
    for (int k = 0; k < count; ++k) {
        long long i = base + static_cast<long long>(k) * stride;
        if (fg[i]) {
            run = min(run, labels[i]);
            labels[i] = run;
        } else {
            run = big;
        }
    }
    run = big;
    for (int k = count - 1; k >= 0; --k) {
        long long i = base + static_cast<long long>(k) * stride;
        if (fg[i]) {
            run = min(run, labels[i]);
            labels[i] = run;
        } else {
            run = big;
        }
    }
}

__global__ void scan_rows(const uint8_t* __restrict__ fg,
                          int* __restrict__ labels, int frames, int h,
                          int w) {
    long long line = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
    if (line >= static_cast<long long>(frames) * h) return;
    seg_scan_line(fg, labels, line * w, w, 1, h * w);
}

__global__ void scan_cols(const uint8_t* __restrict__ fg,
                          int* __restrict__ labels, int frames, int h,
                          int w) {
    long long line = blockIdx.x * static_cast<long long>(blockDim.x)
                     + threadIdx.x;
    if (line >= static_cast<long long>(frames) * w) return;
    long long b = line / w;
    long long x = line - b * w;
    seg_scan_line(fg, labels, b * h * w + x, h, w, h * w);
}

}  // namespace

// fg_in: (frames, h, w) uint8 mask; fg: (frames, h, w) uint8 scratch
// (the border-cleared mask); labels: (frames, h, w) int32 output;
// scratch: (frames, h, w) int32 ping-pong buffer.
extern "C" int flood_scan_labels(const uint8_t* fg_in, uint8_t* fg,
                                 int* labels, int* scratch, int frames,
                                 int h, int w, int iters, int scan_rounds,
                                 cudaStream_t stream) {
    const int threads = 256;
    long long total = static_cast<long long>(frames) * h * w;
    if (total == 0) return 0;
    unsigned int blocks = aruco_blocks(total, threads);
    init_labels<<<blocks, threads, 0, stream>>>(fg_in, fg, labels, total,
                                                h, w);
    ARUCO_LAUNCH_CHECK();
    int per = scan_rounds ? max(1, iters / (scan_rounds + 1)) : iters;
    int* cur = labels;
    int* nxt = scratch;
    auto stencil_block = [&]() -> int {
        for (int r = 0; r < per; ++r) {
            stencil_round<<<blocks, threads, 0, stream>>>(fg, cur, nxt,
                                                          total, h, w);
            ARUCO_LAUNCH_CHECK();
            int* t = cur;
            cur = nxt;
            nxt = t;
        }
        return 0;
    };
    int err = stencil_block();
    if (err) return err;
    for (int s = 0; s < scan_rounds; ++s) {
        scan_rows<<<aruco_blocks(static_cast<long long>(frames) * h,
                                 threads), threads, 0, stream>>>(
            fg, cur, frames, h, w);
        ARUCO_LAUNCH_CHECK();
        scan_cols<<<aruco_blocks(static_cast<long long>(frames) * w,
                                 threads), threads, 0, stream>>>(
            fg, cur, frames, h, w);
        ARUCO_LAUNCH_CHECK();
        err = stencil_block();
        if (err) return err;
    }
    if (cur != labels) {
        cudaMemcpyAsync(labels, cur, total * sizeof(int),
                        cudaMemcpyDeviceToDevice, stream);
        ARUCO_LAUNCH_CHECK();
    }
    return 0;
}
