// IPPE-square PnP for a batch of markers from distorted pixel corners,
// one thread a marker.
//
// Replaces no TPU kernel. The JAX package writes PnP
// (aruco_slam_tpu/ops/pnp.py) as scalar jnp arithmetic, which XLA fuses
// into a few loops. The port's eager form of the same arithmetic
// (ops/pnp.py `solve_square_pnp_plain`) launches ~6,600 elementwise
// kernels a call whatever the batch, at ~10 us of host time each, while
// the card idles. This kernel does that arithmetic in one launch.
//
// Math, entry for entry as ops/pnp.py and core/camera.py:
//  * pixel -> normalized -> undistorted ray: `undistort`'s 8 fixed-point
//    iterations;
//  * the closed-form square homography (`_h_square_entries`), both IPPE
//    rotations (`_ippe_rotations_entries`), each with its `_safe_div`
//    and clamp guards;
//  * the least-squares translation of each (3x3 Cholesky);
//  * `refine_iters` damped Gauss-Newton steps on each candidate
//    (`_gn_refine`): per-corner terms summed in the reference's corner
//    order, the 6x6 Cholesky, the rotvec -> quaternion -> matrix left
//    update;
//  * both RMS errors with the depth penalty (`_reproj_rms_entries`), the
//    choice by e1 <= e2, then `quaternion.from_matrix` (largest pivot,
//    normalized) and `to_rotvec`; errors in pixels (mean focal).
//
// What bounds it on Hopper: latency inside a thread. A marker is ~15,300
// operations of mostly dependent scalar f32 arithmetic on 32 bytes in
// and 48 out. A corners request's 8,192 markers are 256 warps and a
// 32-frame chunk's 2,048 are 64: a fraction of one wave on 132 SMs, so
// neither the FLOP rate nor the bytes bound the call (1.9 us at 8,192),
// but the chain of dependent operations of one thread does (two 8-step
// Gauss-Newton chains, each step ending in a 6x6 Cholesky solve and
// sin/cos): an H100 takes ~0.079 ms at 2,048 and at 8,192 alike. Design:
//  * Everything in registers: every loop over corners and matrix entries
//    is unrolled so that each index is a compile-time constant; only the
//    Gauss-Newton steps loop at run time.
//  * No shared memory and no barrier: no warp waits on another, and the
//    block size (the wrapper's `THREADS`) barely matters below a wave.
//  * Only the lower triangle of J^T J is formed, which is all the
//    Cholesky reads; both candidates run through the same device
//    function, so the threads of a warp never diverge.
//
// Precision: bit for bit the plain version on the card. The filter
// downstream amplifies a last-bit difference in one marker's pose (this
// arithmetic with products and sums contracted into FMAs, compiled for
// a CPU and run there against the plain version, moved the trajectory
// of a `mono1080-rot.corners` request by 5.6e-4 m; its limit is 2e-5 m),
// so the kernel rounds where the eager chain's kernels round:
//  * f32 throughout, IEEE division and sqrt, the accurate sinf / cosf /
//    atan2f that PyTorch's kernels call (no --use_fast_math);
//  * built with -fmad=false (`_build.SOURCE_FLAGS`): every product and
//    sum rounded on its own, in the reference's order of operations;
//  * a division by a Python number is a product with its reciprocal, as
//    PyTorch computes it (to_rotvec's / 3);
//  * the two reductions in the order PyTorch's reduction kernel takes
//    for a row this short (two threads a row, each summing every other
//    element; read off the card): the quaternion's norm as (q0^2 + q2^2)
//    + (q1^2 + q3^2), to_rotvec's sum of three squares as (v0^2 + v2^2)
//    + v1^2;
//  * clamps as torch.clamp (a NaN passes through: a zero-padded slot
//    gives NaN in both), argmax's first largest pivot, NaN the largest.
#include "common.cuh"

namespace {

constexpr float kEps = 1e-12f;       // ops/pnp.py _EPS, quaternion _EPS
constexpr float kCholEps = 1e-20f;   // ops/pnp.py _CHOL_EPS
constexpr float kDamping = 1e-9f;    // _gn_refine's damping
constexpr int kUndistortIters = 8;   // camera.pixel_to_ray's iters
constexpr int kMaxThreads = 256;     // a block at most (255 registers a thread)

__device__ __forceinline__ float clamp_min(float x, float lo) {
    return isnan(x) ? x : fmaxf(x, lo);
}

__device__ __forceinline__ float safe_div(float a, float b) {
    return a / (fabsf(b) < kEps ? (b < 0.0f ? -kEps : kEps) : b);
}

struct Camera {
    float fx, fy, cx, cy, k1, k2, p1, p2, k3;
};

// core/camera.py pixel_to_ray: normalize, then invert the distortion.
__device__ __forceinline__ void undistort(const Camera& c, float u_px,
                                          float v_px, float& xu, float& yu) {
    const float x = (u_px - c.cx) / c.fx;
    const float y = (v_px - c.cy) / c.fy;
    xu = x;
    yu = y;
#pragma unroll
    for (int it = 0; it < kUndistortIters; ++it) {
        const float r2 = xu * xu + yu * yu;
        const float radial = 1.0f + r2 * (c.k1 + r2 * (c.k2 + r2 * c.k3));
        const float dx = 2.0f * c.p1 * xu * yu + c.p2 * (r2 + 2.0f * xu * xu);
        const float dy = c.p1 * (r2 + 2.0f * yu * yu) + 2.0f * c.p2 * xu * yu;
        xu = (x - dx) / radial;
        yu = (y - dy) / radial;
    }
}

// _h_square_entries: the canonical square (half side s) -> the quad.
__device__ __forceinline__ void h_square(float s, const float (&u)[4],
                                         const float (&v)[4],
                                         float (&h)[3][3]) {
    const float sx = u[0] - u[1] + u[2] - u[3];
    const float sy = v[0] - v[1] + v[2] - v[3];
    const float dx1 = u[1] - u[2];
    const float dy1 = v[1] - v[2];
    const float dx2 = u[3] - u[2];
    const float dy2 = v[3] - v[2];
    const float den = dx1 * dy2 - dx2 * dy1;
    const float g = safe_div(sx * dy2 - dx2 * sy, den);
    const float hh = safe_div(dx1 * sy - sx * dy1, den);
    const float a = u[1] - u[0] + g * u[1];
    const float b = u[3] - u[0] + hh * u[3];
    const float c = u[0];
    const float d = v[1] - v[0] + g * v[1];
    const float e = v[3] - v[0] + hh * v[3];
    const float f = v[0];
    const float k = 0.5f / s;
    h[0][0] = a * k;
    h[0][1] = -b * k;
    h[0][2] = 0.5f * a + 0.5f * b + c;
    h[1][0] = d * k;
    h[1][1] = -e * k;
    h[1][2] = 0.5f * d + 0.5f * e + f;
    h[2][0] = g * k;
    h[2][1] = -hh * k;
    h[2][2] = 0.5f * g + 0.5f * hh + 1.0f;
}

// _ippe_rotations_entries: both rotation solutions of a homography.
__device__ __forceinline__ void ippe_rotations(const float (&h_in)[3][3],
                                               float (&r1)[3][3],
                                               float (&r2)[3][3]) {
    const float inv22 = safe_div(1.0f, h_in[2][2]);
    float h[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j) h[i][j] = h_in[i][j] * inv22;
    const float u0 = h[0][2], v0 = h[1][2];
    const float nrm = sqrtf(u0 * u0 + v0 * v0 + 1.0f);
    const float d0 = u0 / nrm, d1 = v0 / nrm, c = 1.0f / nrm;
    const float m = 1.0f / clamp_min(1.0f + c, 1e-6f);
    const float rv[3][3] = {{1.0f - d0 * d0 * m, -d0 * d1 * m, d0},
                            {-d0 * d1 * m, 1.0f - d1 * d1 * m, d1},
                            {-d0, -d1, 1.0f - (d0 * d0 + d1 * d1) * m}};
    float hp[3][3];
#pragma unroll
    for (int i = 0; i < 3; ++i)
#pragma unroll
        for (int j = 0; j < 3; ++j)
            hp[i][j] = rv[0][i] * h[0][j] + rv[1][i] * h[1][j]
                + rv[2][i] * h[2][j];
    const float ihp22 = safe_div(1.0f, hp[2][2]);
    const float a00 = hp[0][0] * ihp22, a01 = hp[0][1] * ihp22;
    const float a10 = hp[1][0] * ihp22, a11 = hp[1][1] * ihp22;
    const float g00 = a00 * a00 + a10 * a10;
    const float g01 = a00 * a01 + a10 * a11;
    const float g11 = a01 * a01 + a11 * a11;
    const float tr = g00 + g11;
    const float det = g00 * g11 - g01 * g01;
    const float disc = sqrtf(clamp_min(tr * tr - 4.0f * det, 0.0f));
    const float gamma = 1.0f / sqrtf(clamp_min(0.5f * (tr + disc), kEps));
    const float gg = gamma * gamma;
    const float ga00 = gamma * a00, ga01 = gamma * a01;
    const float ga10 = gamma * a10, ga11 = gamma * a11;
    const float c1 = sqrtf(clamp_min(1.0f - gg * g00, 0.0f));
    const float c2m = sqrtf(clamp_min(1.0f - gg * g11, 0.0f));
    const float c2 = g01 > 0.0f ? -c2m : c2m;  // c1 c2 = -gamma^2 g01
#pragma unroll
    for (int sol = 0; sol < 2; ++sol) {
        const float c1v = sol == 0 ? c1 : -c1;
        const float c2v = sol == 0 ? c2 : -c2;
        const float cx = ga10 * c2v - c1v * ga11;
        const float cy = c1v * ga01 - ga00 * c2v;
        const float cz = ga00 * ga11 - ga10 * ga01;
        const float rp[3][3] = {{ga00, ga01, cx}, {ga10, ga11, cy},
                                {c1v, c2v, cz}};
        float (&r)[3][3] = sol == 0 ? r1 : r2;
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
                r[i][j] = rv[i][0] * rp[0][j] + rv[i][1] * rp[1][j]
                    + rv[i][2] * rp[2][j];
    }
}

// _solve_spd_entries: unrolled Cholesky solve of a (lower triangle
// read) x = b.
template <int N>
__device__ __forceinline__ void solve_spd(const float (&a)[N][N],
                                          const float (&b)[N],
                                          float (&x)[N]) {
    float low[N][N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
            float s = a[i][j];
#pragma unroll
            for (int k = 0; k < j; ++k) s = s - low[i][k] * low[j][k];
            low[i][j] = i == j ? sqrtf(clamp_min(s, kCholEps))
                               : s / low[j][j];
        }
    }
    float y[N];
#pragma unroll
    for (int i = 0; i < N; ++i) {
        float s = b[i];
#pragma unroll
        for (int k = 0; k < i; ++k) s = s - low[i][k] * y[k];
        y[i] = s / low[i][i];
    }
#pragma unroll
    for (int i = N - 1; i >= 0; --i) {
        float s = y[i];
#pragma unroll
        for (int k = i + 1; k < N; ++k) s = s - low[k][i] * x[k];
        x[i] = s / low[i][i];
    }
}

// _solve_translation_entries: least-squares translation for rotation r.
__device__ __forceinline__ void solve_translation(
    const float (&r)[3][3], const float (&ox)[4], const float (&oy)[4],
    const float (&u)[4], const float (&v)[4], float (&t)[3]) {
    const float n00 = 4.0f;
    const float n02 = -(u[0] + u[1] + u[2] + u[3]);
    const float n12 = -(v[0] + v[1] + v[2] + v[3]);
    float n22 = 0.0f;
    float b[3] = {0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        n22 = n22 + (u[k] * u[k] + v[k] * v[k]);
        const float rxx = r[0][0] * ox[k] + r[0][1] * oy[k];
        const float rxy = r[1][0] * ox[k] + r[1][1] * oy[k];
        const float rxz = r[2][0] * ox[k] + r[2][1] * oy[k];
        const float bu = u[k] * rxz - rxx;
        const float bv = v[k] * rxz - rxy;
        b[0] = b[0] + bu;
        b[1] = b[1] + bv;
        b[2] = b[2] - u[k] * bu - v[k] * bv;
    }
    const float a[3][3] = {{n00, 0.0f, 0.0f}, {0.0f, n00, 0.0f},
                           {n02, n12, n22}};
    solve_spd<3>(a, b, t);
}

// _reproj_rms_entries: RMS normalized reprojection error plus the
// non-positive-depth penalty.
__device__ __forceinline__ float reproj_rms(
    const float (&r)[3][3], const float (&t)[3], const float (&ox)[4],
    const float (&oy)[4], const float (&u)[4], const float (&v)[4]) {
    float e2 = 0.0f, pen = 0.0f;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
        const float rxx = r[0][0] * ox[k] + r[0][1] * oy[k];
        const float rxy = r[1][0] * ox[k] + r[1][1] * oy[k];
        const float rxz = r[2][0] * ox[k] + r[2][1] * oy[k];
        const float pz = rxz + t[2];
        const float z = clamp_min(pz, 1e-6f);
        const float x = (rxx + t[0]) / z;
        const float y = (rxy + t[1]) / z;
        e2 = e2 + (x - u[k]) * (x - u[k]) + (y - v[k]) * (y - v[k]);
        pen = pen + clamp_min(0.3f - pz, 0.0f);
    }
    return sqrtf(e2 * 0.25f) + pen * 1e3f;
}

// _gn_refine: damped Gauss-Newton on the normalized reprojection
// residual, parameters [left rotvec, translation].
__device__ __forceinline__ void gn_refine(
    float (&r)[3][3], float (&t)[3], const float (&ox)[4],
    const float (&oy)[4], const float (&u)[4], const float (&v)[4],
    int iters) {
    for (int it = 0; it < iters; ++it) {
        float jtj[6][6];
        float jtr[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) {
            jtr[i] = 0.0f;
#pragma unroll
            for (int j = 0; j <= i; ++j) jtj[i][j] = i == j ? kDamping : 0.0f;
        }
#pragma unroll
        for (int k = 0; k < 4; ++k) {  // the reference's corner order
            const float a0 = r[0][0] * ox[k] + r[0][1] * oy[k];
            const float a1 = r[1][0] * ox[k] + r[1][1] * oy[k];
            const float a2 = r[2][0] * ox[k] + r[2][1] * oy[k];
            const float z = clamp_min(a2 + t[2], 1e-6f);
            const float iz = 1.0f / z;
            const float x = (a0 + t[0]) * iz;
            const float y = (a1 + t[1]) * iz;
            const float ru = x - u[k];
            const float rv = y - v[k];
            const float ju[6] = {-x * a1 * iz, (a2 + x * a0) * iz, -a1 * iz,
                                 iz, 0.0f, -x * iz};
            const float jv[6] = {-(a2 + y * a1) * iz, y * a0 * iz, a0 * iz,
                                 0.0f, iz, -y * iz};
#pragma unroll
            for (int i = 0; i < 6; ++i) {
                jtr[i] = jtr[i] + (ju[i] * ru + jv[i] * rv);
#pragma unroll
                for (int j = 0; j <= i; ++j)
                    jtj[i][j] = jtj[i][j] + (ju[i] * ju[j] + jv[i] * jv[j]);
            }
        }
        float neg[6], delta[6];
#pragma unroll
        for (int i = 0; i < 6; ++i) neg[i] = -jtr[i];
        solve_spd<6>(jtj, neg, delta);
        const float w0 = delta[0], w1 = delta[1], w2 = delta[2];
        const float th = sqrtf(w0 * w0 + w1 * w1 + w2 * w2);
        const float half = 0.5f * th;
        const float f = th < 1e-8f ? 0.5f : sinf(half) / th;
        const float qw = cosf(half);
        const float qx = f * w0, qy = f * w1, qz = f * w2;
        const float dm[3][3] = {
            {1.0f - 2.0f * (qy * qy + qz * qz), 2.0f * (qx * qy - qz * qw),
             2.0f * (qx * qz + qy * qw)},
            {2.0f * (qx * qy + qz * qw), 1.0f - 2.0f * (qx * qx + qz * qz),
             2.0f * (qy * qz - qx * qw)},
            {2.0f * (qx * qz - qy * qw), 2.0f * (qy * qz + qx * qw),
             1.0f - 2.0f * (qx * qx + qy * qy)}};
        float nr[3][3];
#pragma unroll
        for (int i = 0; i < 3; ++i)
#pragma unroll
            for (int j = 0; j < 3; ++j)
                nr[i][j] = dm[i][0] * r[0][j] + dm[i][1] * r[1][j]
                    + dm[i][2] * r[2][j];
#pragma unroll
        for (int i = 0; i < 3; ++i) {
#pragma unroll
            for (int j = 0; j < 3; ++j) r[i][j] = nr[i][j];
            t[i] = t[i] + delta[3 + i];
        }
    }
}

__device__ __forceinline__ float safe_sqrt_half(float x) {
    return sqrtf(clamp_min(x, kEps)) / 2.0f;
}

// core/quaternion.py from_matrix (largest pivot, first on ties as
// torch.argmax, a NaN pivot taken as the largest) and normalize.
__device__ __forceinline__ void from_matrix(const float (&m)[3][3],
                                            float (&q)[4]) {
    const float tr = m[0][0] + m[1][1] + m[2][2];
    const float piv[4] = {tr, m[0][0] - m[1][1] - m[2][2],
                          -m[0][0] + m[1][1] - m[2][2],
                          -m[0][0] - m[1][1] + m[2][2]};
    int best = 0;
#pragma unroll
    for (int i = 1; i < 4; ++i)
        if (!isnan(piv[best]) && (piv[i] > piv[best] || isnan(piv[i])))
            best = i;
    if (best == 0) {
        const float w = safe_sqrt_half(1.0f + tr);
        q[0] = w;
        q[1] = (m[2][1] - m[1][2]) / (4.0f * w);
        q[2] = (m[0][2] - m[2][0]) / (4.0f * w);
        q[3] = (m[1][0] - m[0][1]) / (4.0f * w);
    } else if (best == 1) {
        const float x = safe_sqrt_half(1.0f + m[0][0] - m[1][1] - m[2][2]);
        q[0] = (m[2][1] - m[1][2]) / (4.0f * x);
        q[1] = x;
        q[2] = (m[0][1] + m[1][0]) / (4.0f * x);
        q[3] = (m[0][2] + m[2][0]) / (4.0f * x);
    } else if (best == 2) {
        const float y = safe_sqrt_half(1.0f - m[0][0] + m[1][1] - m[2][2]);
        q[0] = (m[0][2] - m[2][0]) / (4.0f * y);
        q[1] = (m[0][1] + m[1][0]) / (4.0f * y);
        q[2] = y;
        q[3] = (m[1][2] + m[2][1]) / (4.0f * y);
    } else {
        const float z = safe_sqrt_half(1.0f - m[0][0] - m[1][1] + m[2][2]);
        q[0] = (m[1][0] - m[0][1]) / (4.0f * z);
        q[1] = (m[0][2] + m[2][0]) / (4.0f * z);
        q[2] = (m[1][2] + m[2][1]) / (4.0f * z);
        q[3] = z;
    }
    const float n = clamp_min(
        sqrtf((q[0] * q[0] + q[2] * q[2]) + (q[1] * q[1] + q[3] * q[3])),
        kEps);
#pragma unroll
    for (int i = 0; i < 4; ++i) q[i] = q[i] / n;
}

// core/quaternion.py to_rotvec (shortest arc).
__device__ __forceinline__ void to_rotvec(const float (&q_in)[4],
                                          float (&rv)[3]) {
    const float sgn = q_in[0] < 0.0f ? -1.0f : 1.0f;
    float w = sgn * q_in[0];
    w = isnan(w) ? w : fminf(fmaxf(w, -1.0f), 1.0f);
    const float v[3] = {sgn * q_in[1], sgn * q_in[2], sgn * q_in[3]};
    const float sin_sq = (v[0] * v[0] + v[2] * v[2]) + v[1] * v[1];
    const float sin_half = sqrtf(clamp_min(sin_sq, kEps));
    const float angle = 2.0f * atan2f(sin_half, w);
    const float k = sin_sq < 1e-12f ? 2.0f + sin_sq * (1.0f / 3.0f)
                                    : angle / sin_half;
#pragma unroll
    for (int i = 0; i < 3; ++i) rv[i] = v[i] * k;
}

__global__ void __launch_bounds__(kMaxThreads) pnp_square_kernel(
    const float* __restrict__ corners, const float* __restrict__ camera,
    float s, int iters, int n, float* __restrict__ t_out,
    float* __restrict__ q_out, float* __restrict__ rvec_out,
    float* __restrict__ err_out, float* __restrict__ err2_out) {
    const long long i = static_cast<long long>(blockIdx.x) * blockDim.x
        + threadIdx.x;
    if (i >= n) return;
    const Camera cam{__ldg(camera + 0), __ldg(camera + 1), __ldg(camera + 2),
                     __ldg(camera + 3), __ldg(camera + 4), __ldg(camera + 5),
                     __ldg(camera + 6), __ldg(camera + 7), __ldg(camera + 8)};
    float u[4], v[4];
#pragma unroll
    for (int k = 0; k < 4; ++k)
        undistort(cam, __ldg(corners + 8 * i + 2 * k),
                  __ldg(corners + 8 * i + 2 * k + 1), u[k], v[k]);
    // canonical corners TL TR BR BL in the z = 0 plane
    const float ox[4] = {-s, s, s, -s};
    const float oy[4] = {s, s, -s, -s};

    float h[3][3], r1[3][3], r2[3][3], t1[3], t2[3];
    h_square(s, u, v, h);
    ippe_rotations(h, r1, r2);
    solve_translation(r1, ox, oy, u, v, t1);
    solve_translation(r2, ox, oy, u, v, t2);
    gn_refine(r1, t1, ox, oy, u, v, iters);
    gn_refine(r2, t2, ox, oy, u, v, iters);
    const float e1 = reproj_rms(r1, t1, ox, oy, u, v);
    const float e2 = reproj_rms(r2, t2, ox, oy, u, v);
    const bool first = e1 <= e2;
    float r[3][3], q[4], rv[3];
#pragma unroll
    for (int a = 0; a < 3; ++a) {
#pragma unroll
        for (int b = 0; b < 3; ++b) r[a][b] = first ? r1[a][b] : r2[a][b];
        t_out[3 * i + a] = first ? t1[a] : t2[a];
    }
    from_matrix(r, q);
    to_rotvec(q, rv);
#pragma unroll
    for (int a = 0; a < 4; ++a) q_out[4 * i + a] = q[a];
#pragma unroll
    for (int a = 0; a < 3; ++a) rvec_out[3 * i + a] = rv[a];
    const float focal = 0.5f * (cam.fx + cam.fy);
    err_out[i] = (first ? e1 : e2) * focal;
    err2_out[i] = (first ? e2 : e1) * focal;
}

}  // namespace

// corners: (n, 4, 2) f32 distorted pixel corners (TL TR BR BL);
// camera: (9,) f32 on the device, [fx, fy, cx, cy, k1, k2, p1, p2, k3];
// half_size: half the marker's side. Outputs, each n rows: t (n, 3),
// q (n, 4) wxyz, rvec (n, 3), err and err2 (n,) pixels. `threads` a
// block, 1 to 256.
extern "C" int pnp_square(const float* corners, const float* camera,
                          float half_size, int refine_iters, int n,
                          int threads, float* t, float* q, float* rvec,
                          float* err, float* err2, cudaStream_t stream) {
    if (threads < 1 || threads > kMaxThreads || refine_iters < 0 || n < 0)
        return static_cast<int>(cudaErrorInvalidValue);
    if (n == 0) return 0;
    pnp_square_kernel<<<aruco_blocks(n, threads), threads, 0, stream>>>(
        corners, camera, half_size, refine_iters, n, t, q, rvec, err, err2);
    ARUCO_LAUNCH_CHECK();
    return 0;
}
