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
// Bound at the main-path shape (C = 8, P = 1024, O = 8): about 0.9 MB
// read and written (Hpp^-1, bp, W_e and the inputs; 0.27 us at 3.35
// TB/s) and about 17 M float32 operations (0.26 us at 67 TFLOP/s);
// launch and latency bound in practice (three small kernels).
//
// Design (not the Pallas block layout):
//   stage 0, one thread per camera: R from the quaternion, and the
//     camera's free flag, into a table;
//   stage 1, one thread per point: two passes over its O slots (Hpp and
//     bp, then W_e, Y = W_e Hpp^-1 and the camera-side terms), writing
//     Hpp^-1, bp and W_e in the solver's layout and, per (point,
//     camera), U = sum Y, V = sum W_e, the Hcc terms and b into a
//     record of 78 floats (zero for cameras the point does not see),
//     stored point-minor so that a warp's accesses coalesce;
//   stage 2, one block per chunk of points: each thread owns output
//     entries and sums them over the chunk's points in index order:
//     S_corr[(c1,a),(c2,b)] = sum_p U[p,c1,a,:] . V[p,c2,b,:];
//   stage 3: each output entry sums the chunks' partials in chunk order
//     and applies the damping and pinning.
// The wrapper passes the problem's tensors as they are (masks as bytes,
// poses as [t, q]): no PyTorch operation runs around the launch.
// No float atomics anywhere: the result is the same from run to run, so
// the LM accept decisions (new_cost < cost) are too.
//
// B6 shares B5's residual stage (residual_stage below): one thread per
// point sums w e^2 over its slots, each block reduces its threads in a
// fixed tree, and one block sums the block partials in a fixed order.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int MAX_CAMS = 32;
constexpr int POSE = 17;     // per camera: R (9), t (3), q (4), free
constexpr int REC = 78;      // per (point, camera): U 18, V 18, H 36, g 6
constexpr int R_U = 0, R_V = 18, R_H = 36, R_G = 72;
constexpr int T1 = 64;       // stage-1 threads per block (points)
constexpr int T2 = 256;      // stage-2/3 and cost threads per block
constexpr int SMEM_FLOATS = 12288;   // 48 KB of stage-2 shared memory

struct Obs {
    float x, y, iz, iz2, rx, ry, e, w;
    float r[9];
    int c;
    bool front;
};

// Per-camera table (C, 17) from the (C, 7) [t, q] poses:
// [R row-major (9) | t (3) | q (4, wxyz) | 1 if free else 0].  R is
// quat_to_matrix of the normalized quaternion (the plain version's);
// the residual stage rotates by the raw quaternion, as se3_apply does.
__global__ void camera_table(const float* __restrict__ cam_pose,
                             const uint8_t* __restrict__ cam_fixed, int C,
                             float* __restrict__ table) {
    const int c = threadIdx.x;
    if (c >= C) return;
    const float* T = cam_pose + 7 * c;
    const float n = fmaxf(sqrtf(T[3] * T[3] + T[4] * T[4] + T[5] * T[5]
                                + T[6] * T[6]), 1e-8f);
    const float w = T[3] / n, x = T[4] / n, y = T[5] / n, z = T[6] / n;
    const float xx = x * x, yy = y * y, zz = z * z;
    const float xy = x * y, xz = x * z, yz = y * z;
    const float wx = w * x, wy = w * y, wz = w * z;
    float* R = table + POSE * c;
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
    R[16] = (cam_fixed != nullptr && cam_fixed[c]) ? 0.0f : 1.0f;
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

__global__ void __launch_bounds__(T1)
schur_points(const float* __restrict__ pose, const float* __restrict__ lam_p,
             const float* __restrict__ pts, const uint8_t* __restrict__ pt_fixed,
             const int32_t* __restrict__ cam, const float* __restrict__ uv,
             const uint8_t* __restrict__ valid,
             const float* __restrict__ weight, int C, int P, int O,
             float huber,
             float* __restrict__ hppinv, float* __restrict__ bp_out,
             float* __restrict__ we, float* __restrict__ rec) {
    const int p = blockIdx.x * blockDim.x + threadIdx.x;
    if (p >= P) return;
    const float px = pts[3 * p], py = pts[3 * p + 1], pz = pts[3 * p + 2];
    const float pf = pt_fixed[p] ? 0.0f : 1.0f;
    // this point's records, point-minor (entry k of camera c at
    // rec[(c * REC + k) * P + p]) so a warp's accesses coalesce
    float* R = rec + p;
    for (int k = 0; k < C * REC; ++k) R[(size_t)k * P] = 0.0f;

    // pass 1: the landmark block and its right-hand side
    float H00 = 0, H10 = 0, H20 = 0, H11 = 0, H21 = 0, H22 = 0;
    float b0 = 0, b1 = 0, b2 = 0;
    for (int o = 0; o < O; ++o) {
        const size_t q = (size_t)p * O + o;
        const Obs s = residual_stage<false>(pose, cam[q], C, px, py, pz,
                                            uv[2 * q], uv[2 * q + 1],
                                            valid[q] ? weight[q] : 0.0f,
                                            huber);
        float jpx[3], jpy[3];
        point_jac(s, pf, jpx, jpy);
        const float w = s.w;
        H00 += w * (jpx[0] * jpx[0] + jpy[0] * jpy[0]);
        H10 += w * (jpx[1] * jpx[0] + jpy[1] * jpy[0]);
        H20 += w * (jpx[2] * jpx[0] + jpy[2] * jpy[0]);
        H11 += w * (jpx[1] * jpx[1] + jpy[1] * jpy[1]);
        H21 += w * (jpx[2] * jpx[1] + jpy[2] * jpy[1]);
        H22 += w * (jpx[2] * jpx[2] + jpy[2] * jpy[2]);
        b0 += w * (jpx[0] * s.rx + jpy[0] * s.ry);
        b1 += w * (jpx[1] * s.rx + jpy[1] * s.ry);
        b2 += w * (jpx[2] * s.rx + jpy[2] * s.ry);
    }
    // damping with a relative floor, pinning of fixed points
    const float damp = lam_p[0] + 1e-5f * ((H00 + H11 + H22) / 3.0f);
    H00 += damp;
    H11 += damp;
    H22 += damp;
    if (!(pf > 0.0f)) {
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
    float Hi[3][3];
    Hi[0][0] = m11 * m11 + m21 * m21 + m31 * m31;
    Hi[1][0] = Hi[0][1] = m21 * m22 + m31 * m32;
    Hi[2][0] = Hi[0][2] = m31 * m33;
    Hi[1][1] = m22 * m22 + m32 * m32;
    Hi[2][1] = Hi[1][2] = m32 * m33;
    Hi[2][2] = m33 * m33;
    for (int a = 0; a < 3; ++a)
        for (int b = 0; b < 3; ++b) hppinv[(size_t)p * 9 + a * 3 + b] = Hi[a][b];
    const float bpv[3] = {b0, b1, b2};
    for (int a = 0; a < 3; ++a) bp_out[(size_t)p * 3 + a] = bpv[a];

    // pass 2: W_e, Y = W_e Hpp^-1 and the per-camera records
    for (int o = 0; o < O; ++o) {
        const size_t q = (size_t)p * O + o;
        const Obs s = residual_stage<false>(pose, cam[q], C, px, py, pz,
                                            uv[2 * q], uv[2 * q + 1],
                                            valid[q] ? weight[q] : 0.0f,
                                            huber);
        const float cf = pose[POSE * s.c + 16];
        float jx[6], jy[6], jpx[3], jpy[3];
        cam_jac(s, cf, jx, jy);
        point_jac(s, pf, jpx, jpy);
        const float w = s.w;
        float* r = R + (size_t)s.c * REC * P;
        float* W = we + q * 18;
        for (int a = 0; a < 6; ++a) {
            float Wa[3];
            for (int m = 0; m < 3; ++m) {
                Wa[m] = w * (jx[a] * jpx[m] + jy[a] * jpy[m]);
                W[a * 3 + m] = Wa[m];
                r[(size_t)(R_V + a * 3 + m) * P] += Wa[m];
            }
            float yb = 0.0f;
            for (int k = 0; k < 3; ++k) {
                const float y = Wa[0] * Hi[0][k] + Wa[1] * Hi[1][k]
                                + Wa[2] * Hi[2][k];
                r[(size_t)(R_U + a * 3 + k) * P] += y;
                yb += y * bpv[k];
            }
            for (int b = 0; b < 6; ++b)
                r[(size_t)(R_H + a * 6 + b) * P] +=
                    w * (jx[a] * jx[b] + jy[a] * jy[b]);
            r[(size_t)(R_G + a) * P] += w * (jx[a] * s.rx + jy[a] * s.ry) - yb;
        }
    }
}

__global__ void __launch_bounds__(T2)
schur_chunks(const float* __restrict__ rec, int C, int P, int chunk,
             float* __restrict__ partial) {
    extern __shared__ float sr[];
    const int p0 = blockIdx.x * chunk;
    const int n = min(chunk, P - p0);
    const int C6 = 6 * C;
    const int n_s = C6 * C6, n_h = 36 * C, T = n_s + n_h + C6;
    // the chunk's records, point-major in shared memory
    for (int k = threadIdx.x; k < n * C * REC; k += blockDim.x) {
        const int i = k % n, ck = k / n;
        sr[i * C * REC + ck] = rec[(size_t)ck * P + p0 + i];
    }
    __syncthreads();
    float* out = partial + (size_t)blockIdx.x * T;
    for (int e = threadIdx.x; e < T; e += blockDim.x) {
        float acc = 0.0f;
        if (e < n_s) {
            const int row = e / C6, col = e % C6;
            const int c1 = row / 6, a = row % 6, c2 = col / 6, b = col % 6;
            for (int i = 0; i < n; ++i) {
                const float* U = sr + (i * C + c1) * REC + R_U + a * 3;
                const float* V = sr + (i * C + c2) * REC + R_V + b * 3;
                acc += U[0] * V[0] + U[1] * V[1] + U[2] * V[2];
            }
        } else if (e < n_s + n_h) {
            const int c = (e - n_s) / 36, ab = (e - n_s) % 36;
            for (int i = 0; i < n; ++i) acc += sr[(i * C + c) * REC + R_H + ab];
        } else {
            const int c = (e - n_s - n_h) / 6, a = (e - n_s - n_h) % 6;
            for (int i = 0; i < n; ++i) acc += sr[(i * C + c) * REC + R_G + a];
        }
        out[e] = acc;
    }
}

// the chunks' partials summed in chunk order into S = Hcc + lam I (an
// identity block for a fixed camera) - S_corr and b
__global__ void schur_total(const float* __restrict__ partial, int n_chunks,
                            int C, const float* __restrict__ pose,
                            const float* __restrict__ lam_p,
                            float* __restrict__ S, float* __restrict__ b) {
    const int C6 = 6 * C, n_s = C6 * C6, n_h = 36 * C;
    const int T = n_s + n_h + C6;
    const int e = blockIdx.x * blockDim.x + threadIdx.x;
    if (e >= n_s + C6) return;
    float acc = 0.0f;
    if (e >= n_s) {
        for (int k = 0; k < n_chunks; ++k)
            acc += partial[(size_t)k * T + n_h + e];
        b[e - n_s] = acc;
        return;
    }
    for (int k = 0; k < n_chunks; ++k) acc += partial[(size_t)k * T + e];
    const int row = e / C6, col = e % C6;
    const int c1 = row / 6, a = row % 6, c2 = col / 6, bb = col % 6;
    float h = 0.0f;
    if (c1 == c2) {
        if (pose[POSE * c1 + 16] > 0.0f) {
            for (int k = 0; k < n_chunks; ++k)
                h += partial[(size_t)k * T + n_s + c1 * 36 + a * 6 + bb];
            if (a == bb) h += lam_p[0];
        } else {
            h = a == bb ? 1.0f : 0.0f;
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

}  // namespace

// Points per stage-2 block for C cameras (its records fit in 48 KB).
extern "C" int gslam_schur_chunk(int C) {
    int ch = SMEM_FLOATS / (C * REC);
    return ch < 1 ? 1 : (ch > 32 ? 32 : ch);
}

// Scratch floats the caller allocates for gslam_schur: the camera
// table, the records and the chunk partials.
extern "C" long long gslam_schur_scratch(int C, int P) {
    const int ch = gslam_schur_chunk(C);
    const long long n_chunks = (P + ch - 1) / ch;
    const long long T = 36LL * C * C + 36LL * C + 6LL * C;
    return (long long)C * POSE + (long long)P * C * REC + n_chunks * T;
}

// cam_pose (C, 7) [t, q wxyz], cam_fixed (C,) bool, lam (1,) on the card,
// pts (P, 3), pt_fixed (P,) bool, cam (P, O) int32, uv (P, O, 2), valid
// (P, O) bool, weight (P, O); huber the Huber delta.  Outputs: hppinv
// (P, 3, 3), bp (P, 3), we (P, O, 6, 3), S (6C, 6C) with row (c1*6+a)
// and column (c2*6+b), b (C, 6).  scratch: gslam_schur_scratch(C, P)
// floats.  Needs 1 <= C <= 32, P >= 1, O >= 1.  Returns the CUDA error
// of the launches.
extern "C" int gslam_schur(const float* cam_pose, const uint8_t* cam_fixed,
                           const float* lam, const float* pts,
                           const uint8_t* pt_fixed, const int32_t* cam,
                           const float* uv, const uint8_t* valid,
                           const float* weight, int C, int P, int O,
                           float huber, float* hppinv, float* bp, float* we,
                           float* S, float* b, float* scratch,
                           void* stream) {
    if (C < 1 || C > MAX_CAMS || P < 1 || O < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int ch = gslam_schur_chunk(C);
    const int n_chunks = (P + ch - 1) / ch;
    const int C6 = 6 * C;
    float* table = scratch;
    float* rec = table + C * POSE;
    float* partial = rec + (size_t)P * C * REC;
    camera_table<<<1, MAX_CAMS, 0, s>>>(cam_pose, cam_fixed, C, table);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    schur_points<<<(P + T1 - 1) / T1, T1, 0, s>>>(
        table, lam, pts, pt_fixed, cam, uv, valid, weight, C, P, O, huber,
        hppinv, bp, we, rec);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    schur_chunks<<<n_chunks, T2, ch * C * REC * sizeof(float), s>>>(
        rec, C, P, ch, partial);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    schur_total<<<(C6 * C6 + C6 + T2 - 1) / T2, T2, 0, s>>>(
        partial, n_chunks, C, table, lam, S, b);
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
    camera_table<<<1, MAX_CAMS, 0, s>>>(cam_pose, nullptr, C, table);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cost_points<<<nb, T2, 0, s>>>(table, pts, cam, uv, valid, weight, C, P,
                                  O, huber, table + C * POSE);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    cost_total<<<1, T2, 0, s>>>(table + C * POSE, nb, out);
    return static_cast<int>(cudaGetLastError());
}
