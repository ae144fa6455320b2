// Bundle-adjustment normal equations (B5) and robust cost (B6).
//
// Replaces the TPU kernels gslam_tpu/ops/pallas/schur.py: _schur_kernel
// (called by _schur_call / schur_reduce_pallas and by bundle_adjust with
// backend="pallas") and _cost_kernel (_cost_call / ba_cost_pallas).
// Gold: the plain PyTorch schur_reduce and ba_cost in
// gslam_tpu_torch/opt/ba.py.
//
// B5 computes, for P points with O observation slots each over C <= 32
// cameras: residuals, Huber weights and Jacobians; per point the damped
// and pinned 3x3 landmark block Hpp, its closed-form Cholesky inverse and
// bp; the per-observation coupling blocks W_e (6x3); and the camera-side
// sums Hcc (C, 6, 6), b = bc - W Hpp^-1 bp (C, 6) and the Schur
// correction S_corr = W Hpp^-1 W^T (6C, 6C), returning the reduced
// camera system S = (Hcc + lam I, pinned to I for fixed cameras) -
// S_corr and b.
//
// Bound at the main-path shape (C = 8, P = 1024, O = 8): about 0.8 MB
// read and written (Hpp^-1, bp, W_e and the inputs; 0.24 us at 3.35
// TB/s) and about 10 M float32 operations (0.14 us at 67 TFLOP/s).  Both
// are far below what two launches cost (an empty kernel takes 0.9 us in
// a CUDA graph on the card named below), so the design goes for a short
// critical path, not for a rate.
//
// What bounded the first design (0.2016 ms on an NVIDIA H100 80GB HBM3
// at 700 W): one thread per point in 16 blocks of 64 threads, each
// thread keeping a dense (C x 78)-float record per point in global
// memory (zeroed, then 78 dependent read-modify-writes per slot), the
// residual evaluated twice per slot, four launches, and a scratch of
// P x C x 78 floats plus per-chunk partials (49 MB at C = 32, P = 1024).
//
// Design (not the Pallas block layout), 0.013 ms on the same card:
//   schur_groups, one block of 512 threads per group of G points (G x O
//   <= 512 pairs; G = 8 at P = 1024: 128 blocks; G grows so that at most
//   MAX_BLOCKS blocks, and MAX_PARTIAL_FLOATS of partials, cover the
//   points, and blocks stride over the groups beyond that):
//     prologue: every thread reads its (point, slot) pair from global
//       memory while C threads build the camera table (R, t, q, free
//       flag) in shared memory;
//     stage 1, a thread per pair: residual, Huber weight and point
//       Jacobian once, kept in registers; the slot's terms of Hpp and
//       bp go to shared memory;
//     stage 2a, the same thread: sums its point's Hpp and bp over the
//       slots in slot order (every slot thread of a point forms the same
//       sums: no hand-over), inverts Hpp in closed form, writes Hpp^-1
//       and bp (from slot 0) to global memory, and leaves the inverse,
//       its Jacobians, weight and residual in shared memory;
//     stage 2b, a thread per (pair, row a of the slot's 6x3 block): the
//       row of W_e (to global memory, a warp's rows contiguous), of Y =
//       W_e Hpp^-1 and of the camera-side terms, added to the (point,
//       camera) record in SHARED memory: U = sum Y (18), V = sum W_e
//       (18), the lower triangle of Hcc (21), g (6).  Two slots of a
//       point may name one camera: a slot's rank is the number of
//       earlier slots of its point with its camera (slots without
//       weight add only zeros and are left out), and the adds run in
//       turns by rank with a barrier between turns, so every record is
//       summed in slot order.  Tracked points name each camera once:
//       one turn;
//     stage 3: a thread owns the six entries (b = 0..5) of one row
//       (c1, a) and one camera c2 and sums them over the group's points
//       in index order, S_corr[(c1,a),(c2,b)] = sum_p U[p,c1,a,:] .
//       V[p,c2,b,:], into the block's partial.  A bit mask of the
//       cameras each point sees skips the points whose records are zero
//       (at C = 32 most are); lanes run over c2, so a warp has one c1
//       and skips as one.  U and V records are 18 floats apart, so a
//       warp's V reads fall on addresses 18 apart (2-way conflicts at
//       worst);
//   schur_total: 32 entries a block, eight warps each summing every
//     eighth partial, then the eight sums in warp order; applies the
//     damping and pinning.
// Records never reach global memory; the scratch is the partials only,
// at most MAX_PARTIAL_FLOATS (10 MB) however many points there are.
// What holds it now: the block's critical path, about 10 us of
// dependent shared-memory accesses and IEEE divisions and square roots
// (-fmad=false, as the plain version rounds) between six barriers.
// The wrapper passes the problem's tensors as they are (masks as bytes,
// poses as [t, q]): no PyTorch operation runs around the launch.
// No float atomics anywhere, in shared or global memory: the result is
// the same from run to run, so the LM accept decisions (new_cost < cost)
// are too.  No tensor cores: U^T V is a float32 product held to rtol
// 1e-4 against the plain version; TF32 keeps three digits, and a 3xTF32
// split is not worth it for 7 M (C = 8) to 113 M (C = 32) multiply-adds.
//
// B6 shares B5's residual stage (residual_stage below): a kernel builds
// the camera table in global memory, one thread per point sums w e^2
// over its slots, each block reduces its threads in a fixed tree, and
// one block sums the block partials in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

// tuning builds may override these with -D
#ifndef GSLAM_SCHUR_THREADS
#define GSLAM_SCHUR_THREADS 512
#endif
#ifndef GSLAM_SCHUR_GROUP
#define GSLAM_SCHUR_GROUP 8
#endif

namespace {

constexpr int MAX_CAMS = 32;
constexpr int MAX_OBS = 1024;    // slots per point (shared memory)
constexpr int POSE = 17;     // per camera: R (9), t (3), q (4), free
// per (point, camera) record, four arrays in shared memory: U = sum Y
// (18), V = sum W_e (18), the lower triangle of the Hcc terms (21), g (6)
constexpr int N_UV = 18, N_H = 21, N_G = 6;
constexpr int REC = 2 * N_UV + N_H + N_G;
constexpr int SLOT = 9;      // a slot's terms of Hpp (6) and bp (3)
constexpr int T5 = GSLAM_SCHUR_THREADS;   // schur_groups threads per block
constexpr int GROUP = GSLAM_SCHUR_GROUP;  // most points per group
constexpr int T2 = 256;      // schur_total and cost threads per block
constexpr int MAX_BLOCKS = 264;           // schur_groups: two per SM
constexpr long long MAX_PARTIAL_FLOATS = 2621440;   // 10 MB of partials
constexpr int SMEM_MAX = 232448;          // bytes a block can opt into

struct Obs {
    float x, y, iz, iz2, rx, ry, e, w;
    float r[9];
    int c;
    bool front;
};

// One camera's row of the table from its [t, q] pose:
// [R row-major (9) | t (3) | q (4, wxyz) | 1 if free else 0].  R is
// quat_to_matrix of the normalized quaternion (the plain version's);
// the residual stage rotates by the raw quaternion, as se3_apply does.
__device__ __forceinline__ void camera_row(const float* __restrict__ T,
                                           bool fixed, float* R) {
    const float n = fmaxf(sqrtf(T[3] * T[3] + T[4] * T[4] + T[5] * T[5]
                                + T[6] * T[6]), 1e-8f);
    const float w = T[3] / n, x = T[4] / n, y = T[5] / n, z = T[6] / n;
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    R[0] = 1.0f - 2.0f * (yy + zz);
    R[1] = 2.0f * (xy - wz);
    R[2] = 2.0f * (xz + wy);
    R[3] = 2.0f * (xy + wz);
    R[4] = 1.0f - 2.0f * (xx + zz);
    R[5] = 2.0f * (yz - wx);
    R[6] = 2.0f * (xz - wy);
    R[7] = 2.0f * (yz + wx);
    R[8] = 1.0f - 2.0f * (xx + yy);
    for (int k = 0; k < 7; ++k) R[9 + k] = T[k];
    R[16] = fixed ? 0.0f : 1.0f;
}

// The (C, 17) table in global memory, for the cost kernel.
__global__ void camera_table(const float* __restrict__ cam_pose, int C,
                             float* __restrict__ table) {
    const int c = threadIdx.x;
    if (c < C) camera_row(cam_pose + 7 * c, false, table + POSE * c);
}

// projection, residual and robust weight of slot o of point (px, py, pz)
// -- the Pallas kernel's _residual_stage, reading the camera's row of
// the table above: the point moves into the
// camera by the quaternion, as the plain version's se3_apply does
// (v + w t + q_v x t with t = 2 q_v x v), so both see the same
// residuals; R serves the point Jacobian.  kDivide: the residual as
// x / z (the cost, as ba_cost computes it) instead of x * (1 / z).
// The camera index is taken as an array index is in the reference: a
// negative one counts from the end, and the result is clamped to
// [0, C), so a pad slot never reads or writes outside the tables.
template <bool kDivide>
__device__ __forceinline__ Obs residual_stage(
        const float* __restrict__ pose, int c, int C, float px, float py,
        float pz, float u, float v, float wt, float huber) {
    Obs s;
    s.c = min(max(c < 0 ? c + C : c, 0), C - 1);
    const float* P = pose + POSE * s.c;
#pragma unroll
    for (int k = 0; k < 9; ++k) s.r[k] = P[k];
    const float qw = P[12], qx = P[13], qy = P[14], qz = P[15];
    const float tx = 2.0f * (qy * pz - qz * py);
    const float ty = 2.0f * (qz * px - qx * pz);
    const float tz = 2.0f * (qx * py - qy * px);
    s.x = px + qw * tx + (qy * tz - qz * ty) + P[9];
    s.y = py + qw * ty + (qz * tx - qx * tz) + P[10];
    const float z = pz + qw * tz + (qx * ty - qy * tx) + P[11];
    s.front = z > 1e-6f;
    const float zs = s.front ? z : 1.0f;
    s.iz = 1.0f / zs;
    s.iz2 = s.iz * s.iz;
    if (kDivide) {
        s.rx = s.x / zs - u;
        s.ry = s.y / zs - v;
    } else {
        s.rx = s.x * s.iz - u;
        s.ry = s.y * s.iz - v;
    }
    s.e = sqrtf(s.rx * s.rx + s.ry * s.ry);
    const float hub = s.e <= huber ? 1.0f : huber / fmaxf(s.e, 1e-12f);
    s.w = (s.front && wt != 0.0f) ? wt * hub : 0.0f;   // wt: 0 if invalid
    return s;
}

__device__ __forceinline__ void point_jac(const Obs& s, float pf,
                                          float* jpx, float* jpy) {
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        jpx[m] = (s.iz * s.r[m] - s.x * s.iz2 * s.r[6 + m]) * pf;
        jpy[m] = (s.iz * s.r[3 + m] - s.y * s.iz2 * s.r[6 + m]) * pf;
    }
}

__device__ __forceinline__ void cam_jac(const Obs& s, float cf,
                                        float* jx, float* jy) {
    const float x = s.x, y = s.y, iz = s.iz, iz2 = s.iz2;
    jx[0] = iz * cf;
    jx[1] = 0.0f;
    jx[2] = -x * iz2 * cf;
    jx[3] = -x * y * iz2 * cf;
    jx[4] = (1.0f + x * x * iz2) * cf;
    jx[5] = -y * iz * cf;
    jy[0] = 0.0f;
    jy[1] = iz * cf;
    jy[2] = -y * iz2 * cf;
    jy[3] = -(1.0f + y * y * iz2) * cf;
    jy[4] = x * y * iz2 * cf;
    jy[5] = x * iz * cf;
}

// A (point, slot) pair as read from global memory.
struct Raw {
    float px, py, pz, u, v, wt, pf;
    int c;
};

__device__ __forceinline__ Raw load_pair(
        const float* __restrict__ pts, const uint8_t* __restrict__ pt_fixed,
        const int32_t* __restrict__ cam, const float* __restrict__ uv,
        const uint8_t* __restrict__ valid, const float* __restrict__ weight,
        int p, size_t q) {
    Raw r;
    r.px = pts[3 * p];
    r.py = pts[3 * p + 1];
    r.pz = pts[3 * p + 2];
    r.u = uv[2 * q];
    r.v = uv[2 * q + 1];
    r.wt = valid[q] ? weight[q] : 0.0f;
    r.pf = pt_fixed[p] ? 0.0f : 1.0f;
    r.c = cam[q];
    return r;
}

// What a (point, slot) thread keeps from stage 1 to stage 2.
struct Pair {
    Obs s;
    float jpx[3], jpy[3];
    float pf;
};

__device__ __forceinline__ Pair eval_pair(const float* table, const Raw& in,
                                          int C, float huber) {
    Pair r;
    r.pf = in.pf;
    r.s = residual_stage<false>(table, in.c, C, in.px, in.py, in.pz, in.u,
                                in.v, in.wt, huber);
    point_jac(r.s, r.pf, r.jpx, r.jpy);
    return r;
}

// A slot's place in the order of the adds to its (point, camera)
// record: the number of earlier slots of its point that carry weight
// and name its camera.  `cams`: the point's O entries of the slot table
// (the camera, or -1 for a slot without weight, which adds nothing).
__device__ __forceinline__ int slot_rank(const int* cams, int o) {
    const int c = cams[o];
    int rank = 0;
    if (c >= 0)
        for (int o2 = 0; o2 < o; ++o2) rank += cams[o2] == c;
    return rank;
}

// What stage 2a leaves in shared memory for the six row lanes of a slot.
constexpr int D_HI = 0;      // Hpp^-1: 11, 21, 31, 22, 32, 33
constexpr int D_BP = 6;      // bp (3)
constexpr int D_JX = 9;      // camera Jacobian rows (6 + 6)
constexpr int D_JY = 15;
constexpr int D_JPX = 21;    // point Jacobian rows (3 + 3)
constexpr int D_JPY = 24;
constexpr int D_W = 27;      // weight, residual (2)
constexpr int D_RX = 28;
constexpr int D_RY = 29;
constexpr int SDATA = 31;    // odd stride: slots fall on different banks

// Stage 2a of one slot: its point's Hpp and bp summed over the slots in
// slot order from `terms` (the point's O x SLOT terms), damped, pinned
// and inverted (Hpp^-1 and bp to global memory from slot 0); with the
// slot's Jacobians, weight and residual into d for the row lanes.
__device__ __forceinline__ void slot_data(
        const Pair& pr, const float* terms, int O, float lam, float cam_free,
        bool slot0, float* __restrict__ hppinv, float* __restrict__ bp_out,
        float* d) {
    float H00 = 0, H10 = 0, H20 = 0, H11 = 0, H21 = 0, H22 = 0;
    float b0 = 0, b1 = 0, b2 = 0;
    for (int o2 = 0; o2 < O; ++o2) {
        const float* t = terms + o2 * SLOT;
        H00 += t[0];
        H10 += t[1];
        H20 += t[2];
        H11 += t[3];
        H21 += t[4];
        H22 += t[5];
        b0 += t[6];
        b1 += t[7];
        b2 += t[8];
    }
    // damping with a relative floor, pinning of fixed points
    const float damp = lam + 1e-5f * ((H00 + H11 + H22) / 3.0f);
    H00 += damp;
    H11 += damp;
    H22 += damp;
    if (!(pr.pf > 0.0f)) {
        H00 = H11 = H22 = 1.0f;
        H10 = H20 = H21 = 0.0f;
    }
    // closed-form Cholesky inverse (opt.ba._inv3x3)
    const float eps = 1e-20f;
    const float l11 = sqrtf(fmaxf(H00, eps));
    const float l21 = H10 / l11, l31 = H20 / l11;
    const float l22 = sqrtf(fmaxf(H11 - l21 * l21, eps));
    const float l32 = (H21 - l31 * l21) / l22;
    const float l33 = sqrtf(fmaxf(H22 - l31 * l31 - l32 * l32, eps));
    const float m11 = 1.0f / l11, m22 = 1.0f / l22, m33 = 1.0f / l33;
    const float m21 = -l21 * m11 * m22;
    const float m32 = -l32 * m22 * m33;
    const float m31 = (l21 * l32 - l31 * l22) * m11 * m22 * m33;
    d[D_HI + 0] = m11 * m11 + m21 * m21 + m31 * m31;
    d[D_HI + 1] = m21 * m22 + m31 * m32;
    d[D_HI + 2] = m31 * m33;
    d[D_HI + 3] = m22 * m22 + m32 * m32;
    d[D_HI + 4] = m32 * m33;
    d[D_HI + 5] = m33 * m33;
    d[D_BP + 0] = b0;
    d[D_BP + 1] = b1;
    d[D_BP + 2] = b2;
    if (slot0) {
        hppinv[0] = d[D_HI + 0];
        hppinv[1] = hppinv[3] = d[D_HI + 1];
        hppinv[2] = hppinv[6] = d[D_HI + 2];
        hppinv[4] = d[D_HI + 3];
        hppinv[5] = hppinv[7] = d[D_HI + 4];
        hppinv[8] = d[D_HI + 5];
        bp_out[0] = b0;
        bp_out[1] = b1;
        bp_out[2] = b2;
    }
    cam_jac(pr.s, cam_free, d + D_JX, d + D_JY);
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        d[D_JPX + m] = pr.jpx[m];
        d[D_JPY + m] = pr.jpy[m];
    }
    d[D_W] = pr.s.w;
    d[D_RX] = pr.s.rx;
    d[D_RY] = pr.s.ry;
}

// Stage 2b, row a of one slot: W_e's row to global memory, and the
// row's terms of the slot's record: Y = W_e Hpp^-1 (u), W_e (wa), the
// Hcc terms (a, b <= a) (h) and g.
__device__ __forceinline__ void row_values(const float* d, int a,
                                           float* __restrict__ W, float* u,
                                           float* wa, float* h, float& g) {
    const float w = d[D_W];
    const float jxa = d[D_JX + a], jya = d[D_JY + a];
    const float Hi[3][3] = {
        {d[D_HI + 0], d[D_HI + 1], d[D_HI + 2]},
        {d[D_HI + 1], d[D_HI + 3], d[D_HI + 4]},
        {d[D_HI + 2], d[D_HI + 4], d[D_HI + 5]}};
#pragma unroll
    for (int m = 0; m < 3; ++m) {
        wa[m] = w * (jxa * d[D_JPX + m] + jya * d[D_JPY + m]);
        W[m] = wa[m];
    }
    float yb = 0.0f;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
        u[k] = wa[0] * Hi[0][k] + wa[1] * Hi[1][k] + wa[2] * Hi[2][k];
        yb += u[k] * d[D_BP + k];
    }
#pragma unroll
    for (int b = 0; b < 6; ++b)
        h[b] = b <= a ? w * (jxa * d[D_JX + b] + jya * d[D_JY + b]) : 0.0f;
    g = w * (jxa * d[D_RX] + jya * d[D_RY]) - yb;
}

// kMulti: more pairs than threads (one point a group, O > T5), so a
// thread walks several pairs and forms each anew in stage 2a; else a
// thread has one pair and keeps it in registers from stage 1.
template <bool kMulti>
__global__ void __launch_bounds__(T5)
schur_groups(const float* __restrict__ cam_pose,
             const uint8_t* __restrict__ cam_fixed,
             const float* __restrict__ lam_p, const float* __restrict__ pts,
             const uint8_t* __restrict__ pt_fixed,
             const int32_t* __restrict__ cam, const float* __restrict__ uv,
             const uint8_t* __restrict__ valid,
             const float* __restrict__ weight, int C, int P, int O, int G,
             float huber, float* __restrict__ hppinv,
             float* __restrict__ bp_out, float* __restrict__ we,
             float* __restrict__ partial) {
    extern __shared__ float sm[];
    float* table = sm;                            // C x POSE
    float* terms = table + C * POSE;              // G x O x SLOT
    float* sdata = terms + G * O * SLOT;          // G x O x SDATA
    int* scam = reinterpret_cast<int*>(sdata + G * O * SDATA);   // G x O
    int* srank = scam + G * O;                    // G x O
    uint32_t* seen = reinterpret_cast<uint32_t*>(srank + G * O);  // G
    float* sU = reinterpret_cast<float*>(seen + G);   // G x C x 18
    float* sV = sU + G * C * N_UV;                // G x C x 18
    float* sH = sV + G * C * N_UV;                // G x C x 21
    float* sG = sH + G * C * N_H;                 // G x C x 6
    const int tid = threadIdx.x;
    const float lam = lam_p[0];
    const int C6 = 6 * C, n_s = C6 * C6, n_h = 36 * C, NT = n_s + n_h + C6;
    const int n_groups = (P + G - 1) / G;
    float* out = partial + (size_t)blockIdx.x * NT;
    bool first = true;
    for (int grp = blockIdx.x; grp < n_groups; grp += gridDim.x) {
        const int p0 = grp * G;
        const int n = min(G, P - p0);
        const int NS = n * O;
        // this thread's pair, read while the camera table is built
        Raw in;
        if (!kMulti && tid < NS)
            in = load_pair(pts, pt_fixed, cam, uv, valid, weight,
                           p0 + tid / O, (size_t)p0 * O + tid);
        if (first && tid < C)
            camera_row(cam_pose + 7 * tid, cam_fixed[tid] != 0,
                       table + POSE * tid);
        __syncthreads();      // table built; the last group's records read
        for (int k = tid; k < G * C * REC; k += T5) sU[k] = 0.0f;

        // stage 1: residual, weight, point Jacobian; Hpp and bp terms
        Pair pr;
        for (int e = tid; e < NS; e += T5) {
            if (kMulti)
                in = load_pair(pts, pt_fixed, cam, uv, valid, weight,
                               p0 + e / O, (size_t)p0 * O + e);
            pr = eval_pair(table, in, C, huber);
            const float w = pr.s.w;
            const float* jpx = pr.jpx;
            const float* jpy = pr.jpy;
            float* t = terms + e * SLOT;
            t[0] = w * (jpx[0] * jpx[0] + jpy[0] * jpy[0]);
            t[1] = w * (jpx[1] * jpx[0] + jpy[1] * jpy[0]);
            t[2] = w * (jpx[2] * jpx[0] + jpy[2] * jpy[0]);
            t[3] = w * (jpx[1] * jpx[1] + jpy[1] * jpy[1]);
            t[4] = w * (jpx[2] * jpx[1] + jpy[2] * jpy[1]);
            t[5] = w * (jpx[2] * jpx[2] + jpy[2] * jpy[2]);
            t[6] = w * (jpx[0] * pr.s.rx + jpy[0] * pr.s.ry);
            t[7] = w * (jpx[1] * pr.s.rx + jpy[1] * pr.s.ry);
            t[8] = w * (jpx[2] * pr.s.rx + jpy[2] * pr.s.ry);
            // a slot without weight adds only zeros: it takes no turn
            scam[e] = w != 0.0f ? pr.s.c : -1;
        }
        __syncthreads();

        // stage 2a, a thread per slot: the point's block inverted, the
        // slot's data for its row lanes, its rank, the point's cameras
        for (int e = tid; e < NS; e += T5) {
            const int pl = e / O, o = e - pl * O;
            const int p = p0 + pl;
            if (kMulti)
                pr = eval_pair(table, load_pair(pts, pt_fixed, cam, uv, valid,
                                                weight, p,
                                                (size_t)p0 * O + e),
                               C, huber);
            srank[e] = slot_rank(scam + pl * O, o);
            if (o == 0) {
                uint32_t m = 0;
                for (int o2 = 0; o2 < O; ++o2) {
                    const int c = scam[pl * O + o2];
                    if (c >= 0) m |= 1u << c;
                }
                seen[pl] = m;
            }
            slot_data(pr, terms + pl * O * SLOT, O, lam,
                      table[POSE * pr.s.c + 16], o == 0,
                      hppinv + (size_t)p * 9, bp_out + (size_t)p * 3,
                      sdata + e * SDATA);
        }
        __syncthreads();

        // stage 2b, a thread per (slot, row a of its 6x3 block): the
        // row's terms, added to the slot's record in turns by rank
        for (int turn = 0;; ++turn) {
            bool more = false;
            for (int r = tid; r < 6 * NS; r += T5) {
                const int e = r / 6, a = r - e * 6;
                const int rank = srank[e];
                more = more || rank > turn;
                if (rank != turn) continue;
                float u[3], wa[3], h[6], g;
                row_values(sdata + e * SDATA, a,
                           we + ((size_t)p0 * O + e) * 18 + a * 3, u, wa, h,
                           g);
                const int c = scam[e];
                if (c < 0) continue;
                const int rc = (e / O) * C + c;
                float* U = sU + rc * N_UV + a * 3;
                float* V = sV + rc * N_UV + a * 3;
                float* Hc = sH + rc * N_H + a * (a + 1) / 2;
                // every load before the first store, so they overlap
                float old[13];
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    old[k] = U[k];
                    old[3 + k] = V[k];
                }
#pragma unroll
                for (int b = 0; b < 6; ++b)
                    if (b <= a) old[6 + b] = Hc[b];
                old[12] = sG[rc * N_G + a];
#pragma unroll
                for (int k = 0; k < 3; ++k) {
                    U[k] = old[k] + u[k];
                    V[k] = old[3 + k] + wa[k];
                }
#pragma unroll
                for (int b = 0; b < 6; ++b)
                    if (b <= a) Hc[b] = old[6 + b] + h[b];
                sG[rc * N_G + a] = old[12] + g;
            }
            if (!__syncthreads_or(more)) break;
        }

        // stage 3: this group's share of every output entry, points in
        // index order, added to the block's partial.  A thread owns the
        // six entries (b = 0..5) of one row (c1, a) and one camera c2:
        // six independent sums, lanes over c2, so at C = 32 a warp has
        // one c1 and skips as one the points that do not see it (their
        // records are zero).
        for (int u = tid; u < C6 * C; u += T5) {
            const int row = u / C, c2 = u - row * C;
            const int c1 = row / 6, a = row - c1 * 6;
            const float* U = sU + c1 * N_UV + a * 3;
            const float* V = sV + c2 * N_UV;
            float acc[6] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
            for (int i = 0; i < n; ++i) {
                const uint32_t m = seen[i];
                if ((m >> c1) & (m >> c2) & 1u) {
                    const float* ui = U + i * C * N_UV;
                    const float* vi = V + i * C * N_UV;
                    const float u0 = ui[0], u1 = ui[1], u2 = ui[2];
#pragma unroll
                    for (int b = 0; b < 6; ++b)
                        acc[b] += u0 * vi[3 * b] + u1 * vi[3 * b + 1]
                                  + u2 * vi[3 * b + 2];
                }
            }
            float* o = out + row * C6 + c2 * 6;
#pragma unroll
            for (int b = 0; b < 6; ++b) o[b] = first ? acc[b] : o[b] + acc[b];
        }
        for (int e = tid; e < n_h + C6; e += T5) {
            float acc = 0.0f;
            if (e < n_h) {
                const int c = e / 36, ab = e - c * 36;
                const int a = ab / 6, b = ab - a * 6;
                const int hi = max(a, b), lo = min(a, b);
                const float* Hc = sH + c * N_H + hi * (hi + 1) / 2 + lo;
#pragma unroll 4
                for (int i = 0; i < n; ++i) acc += Hc[i * C * N_H];
            } else {
                const float* g = sG + (e - n_h);
#pragma unroll 4
                for (int i = 0; i < n; ++i) acc += g[i * C * N_G];
            }
            out[n_s + e] = first ? acc : out[n_s + e] + acc;
        }
        first = false;
    }
}

// the blocks' partials summed into S = Hcc + lam I (an identity block
// for a fixed camera) - S_corr and b.  A block owns 32 neighbouring
// entries: warp w sums the partials w, w + 8, ... in that order (a
// warp's loads are 128 contiguous bytes), then the eight sums are added
// in warp order: a fixed order, eight loads deep in flight.
__global__ void __launch_bounds__(T2)
schur_total(const float* __restrict__ partial, int n_blocks, int C,
            const uint8_t* __restrict__ cam_fixed,
            const float* __restrict__ lam_p, float* __restrict__ S,
            float* __restrict__ b) {
    __shared__ float red[2][T2 / 32][32];
    const int C6 = 6 * C, n_s = C6 * C6, n_h = 36 * C;
    const int T = n_s + n_h + C6;
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int e = blockIdx.x * 32 + lane;
    const bool live = e < n_s + C6;
    // entry e of S or b: its column of the partials, and for an entry of
    // a free camera's diagonal block the column of its Hcc term
    int col = 0, hcol = -1;
    if (live) {
        col = e < n_s ? e : n_h + e;
        if (e < n_s) {
            const int row = e / C6, cc = e % C6;
            const int c1 = row / 6, c2 = cc / 6;
            if (c1 == c2 && !cam_fixed[c1])
                hcol = n_s + c1 * 36 + (row % 6) * 6 + cc % 6;
        }
    }
    float acc = 0.0f, h = 0.0f;
    if (live) {
        for (int k = warp; k < n_blocks; k += T2 / 32) {
            const float* row = partial + (size_t)k * T;
            acc += row[col];
            if (hcol >= 0) h += row[hcol];
        }
    }
    red[0][warp][lane] = acc;
    red[1][warp][lane] = h;
    __syncthreads();
    if (warp != 0 || !live) return;
    acc = red[0][0][lane];
    h = red[1][0][lane];
    for (int w = 1; w < T2 / 32; ++w) {
        acc += red[0][w][lane];
        h += red[1][w][lane];
    }
    if (e >= n_s) {
        b[e - n_s] = acc;
        return;
    }
    const int row = e / C6, cc = e % C6;
    if (row / 6 == cc / 6) {
        if (hcol >= 0) {
            if (row % 6 == cc % 6) h += lam_p[0];
        } else {
            h = row % 6 == cc % 6 ? 1.0f : 0.0f;
        }
    }
    S[e] = h - acc;
}

__global__ void __launch_bounds__(T2)
cost_points(const float* __restrict__ pose, const float* __restrict__ pts,
            const int32_t* __restrict__ cam, const float* __restrict__ uv,
            const uint8_t* __restrict__ valid,
            const float* __restrict__ weight, int C, int P, int O,
            float huber, float* __restrict__ partial) {
    __shared__ float red[T2];
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    float acc = 0.0f;
    if (p < P) {
        const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
        for (int o = 0; o < O; ++o) {
            const size_t q = (size_t)p * O + o;
            const Obs s = residual_stage<true>(pose, cam[q], C, px, py, pz,
                                               uv[2 * q], uv[2 * q + 1],
                                               valid[q] ? weight[q] : 0.0f,
                                               huber);
            if (s.w != 0.0f) acc += s.w * s.e * s.e;
        }
    }
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int h = T2 / 2; h > 0; h >>= 1) {      // fixed-order tree
        if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) partial[blockIdx.x] = red[0];
}

__global__ void __launch_bounds__(T2)
cost_total(const float* __restrict__ partial, int n, float* __restrict__ out) {
    __shared__ float red[T2];
    float acc = 0.0f;
    for (int k = threadIdx.x; k < n; k += T2) acc += partial[k];
    red[threadIdx.x] = acc;
    __syncthreads();
    for (int h = T2 / 2; h > 0; h >>= 1) {
        if (threadIdx.x < h) red[threadIdx.x] += red[threadIdx.x + h];
        __syncthreads();
    }
    if (threadIdx.x == 0) out[0] = red[0];
}

// Launch shape of schur_groups: points per group (GROUP, or as many as
// let max_blocks(C) blocks cover the points; at most as many whole
// points as T5 threads hold pairs; fewer if shared memory is short),
// its shared memory and the number of blocks (one per group, up to
// MAX_BLOCKS and to MAX_PARTIAL_FLOATS of partials; blocks stride over
// further groups).  G = 0: one point does not fit.
struct Plan {
    int G, blocks;
    size_t smem;
};

long long partial_floats(int C) { return 36LL * C * C + 42LL * C; }

int max_blocks(int C) {
    const long long cap = MAX_PARTIAL_FLOATS / partial_floats(C);
    return (int)(cap < MAX_BLOCKS ? cap : MAX_BLOCKS);
}

Plan schur_plan(int C, int P, int O) {
    Plan pl;
    // GROUP points, or as many as give every block one group
    const int want = (P + max_blocks(C) - 1) / max_blocks(C);
    pl.G = want > GROUP ? want : GROUP;
    if (pl.G > T5 / O) pl.G = T5 / O < 1 ? 1 : T5 / O;
    for (;; --pl.G) {
        pl.smem = sizeof(float) * ((size_t)C * POSE + pl.G
                                   + (size_t)pl.G * O * (SLOT + SDATA + 2)
                                   + (size_t)pl.G * C * REC);
        if (pl.smem <= SMEM_MAX || pl.G == 0) break;
    }
    if (pl.G == 0) return pl;
    const int n_groups = (P + pl.G - 1) / pl.G;
    pl.blocks = n_groups < max_blocks(C) ? n_groups : max_blocks(C);
    return pl;
}

}  // namespace

// Scratch floats the caller allocates for gslam_schur: the blocks'
// partials (an upper bound over O).
extern "C" long long gslam_schur_scratch(int C, int P) {
    const int nb = P < max_blocks(C) ? P : max_blocks(C);
    return nb * partial_floats(C);
}

// cam_pose (C, 7) [t, q wxyz], cam_fixed (C,) bool, lam (1,) on the card,
// pts (P, 3), pt_fixed (P,) bool, cam (P, O) int32, uv (P, O, 2), valid
// (P, O) bool, weight (P, O); huber the Huber delta.  Outputs: hppinv
// (P, 3, 3), bp (P, 3), we (P, O, 6, 3), S (6C, 6C) with row (c1*6+a)
// and column (c2*6+b), b (C, 6).  scratch: gslam_schur_scratch(C, P)
// floats.  Needs 1 <= C <= 32, P >= 1, 1 <= O <= 1024.  Returns the CUDA
// error of the launches.
extern "C" int gslam_schur(const float* cam_pose, const uint8_t* cam_fixed,
                           const float* lam, const float* pts,
                           const uint8_t* pt_fixed, const int32_t* cam,
                           const float* uv, const uint8_t* valid,
                           const float* weight, int C, int P, int O,
                           float huber, float* hppinv, float* bp, float* we,
                           float* S, float* b, float* scratch,
                           void* stream) {
    if (C < 1 || C > MAX_CAMS || P < 1 || O < 1 || O > MAX_OBS)
        return static_cast<int>(cudaErrorInvalidValue);
    const Plan pl = schur_plan(C, P, O);
    if (pl.G == 0) return static_cast<int>(cudaErrorInvalidValue);
    static bool opted_in = false;       // above 48 KB of shared memory
    if (!opted_in) {
        cudaError_t e = cudaFuncSetAttribute(
            schur_groups<false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
            SMEM_MAX);
        if (e == cudaSuccess)
            e = cudaFuncSetAttribute(
                schur_groups<true>,
                cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM_MAX);
        if (e != cudaSuccess) return static_cast<int>(e);
        opted_in = true;
    }
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int C6 = 6 * C;
    if (pl.G * O > T5)
        schur_groups<true><<<pl.blocks, T5, pl.smem, s>>>(
            cam_pose, cam_fixed, lam, pts, pt_fixed, cam, uv, valid, weight,
            C, P, O, pl.G, huber, hppinv, bp, we, scratch);
    else
        schur_groups<false><<<pl.blocks, T5, pl.smem, s>>>(
            cam_pose, cam_fixed, lam, pts, pt_fixed, cam, uv, valid, weight,
            C, P, O, pl.G, huber, hppinv, bp, we, scratch);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    schur_total<<<(C6 * C6 + C6 + 31) / 32, T2, 0, s>>>(
        scratch, pl.blocks, C, cam_fixed, lam, S, b);
    return static_cast<int>(cudaGetLastError());
}

// Robust cost sum w e^2 of the same inputs into out (1,); scratch:
// C * 17 + ceil(P / 256) floats.  Returns the CUDA error of the launches.
extern "C" int gslam_ba_cost(const float* cam_pose, const float* pts,
                             const int32_t* cam, const float* uv,
                             const uint8_t* valid, const float* weight,
                             int C, int P, int O, float huber, float* out,
                             float* scratch, void* stream) {
    if (C < 1 || C > MAX_CAMS || P < 1 || O < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int nb = (P + T2 - 1) / T2;
    float* table = scratch;
    camera_table<<<1, MAX_CAMS, 0, s>>>(cam_pose, C, table);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cost_points<<<nb, T2, 0, s>>>(table, pts, cam, uv, valid, weight, C, P,
                                  O, huber, table + C * POSE);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cost_total<<<1, T2, 0, s>>>(table + C * POSE, nb, out);
    return static_cast<int>(cudaGetLastError());
}
