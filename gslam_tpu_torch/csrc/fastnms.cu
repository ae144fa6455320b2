// FAST-9/16 corner score + 3x3 non-maximum suppression in one pass.
//
// Replaces the TPU kernel gslam_tpu/ops/pallas/fastnms.py
// (_fast_nms_kernel, called by fast_nms_raw_pallas).  Gold: the plain
// PyTorch fast_score + nms in gslam_tpu_torch/ops/frontend.py, bit for
// bit.
//
// Bound at the main-path shape (480 x 640 float32): 1.2 MB read and
// 2.5 MB written, 1.1 us at 3.35 TB/s.  The work the inputs need is
// small beside that: per pixel 16 circle differences, 32 compares, a
// few mask operations and 9 NMS maxima, and arc sums only where an arc
// qualifies (under 2% of pixels on the SLAM and example frames).  The
// bytes bound it.  What is left over the bound is latency: one wave of
// blocks, each a chain of the staging loads, three barriers and the
// stores, the longest where a tile's candidate list is longest.
//
// What held the first design back: every pixel formed all 16 arc sums
// (about 920 float32 operations a pixel, 98% of them thrown away), on a
// 32 x 16 tile whose one-pixel score ring added 19.5%, staged 4 bytes at
// a time.  A full mask test on every pixel with the sums behind a branch
// still spent most of its time on sums: a warp with one qualifying pixel
// ran them for all 32 lanes, and 5% to 18% of warps had one.  This
// design:
//
// 1. The compass pretest on every position (four circle pixels, one
//    compare each way): some two consecutive compass pixels both bright
//    or both dark.  It passes 0.5% (SLAM frames) to 1.8% (the example
//    image) of pixels, and those go to a list in shared memory, one
//    append per warp (a ballot and one shared atomic).
// 2. The full test on the listed pixels only, half a warp a pixel, a
//    lane per circle pixel and arc start: the 16 differences d[k] =
//    p_k - c give two 16-bit masks by ballot, bright (d[k] > t) and dark
//    (d[k] < -t); the arc starts whose ARC pixels are all set come from
//    shift-ANDs of each mask doubled to 32 bits (arc_starts); each lane
//    forms its start's two sums from its neighbours' differences
//    (shuffles), and the qualifying ones meet in a 4-step maximum.  One
//    thread per pixel walking its qualifying starts one after another
//    was slower: a chain of up to 16 x 9 dependent sums.
// 3. A 64 x 40 tile (GSLAM_FAST_TW x GSLAM_FAST_TH) and 1024 threads
//    (GSLAM_FAST_THREADS), tuned by scripts/tune_kernels.py: the
//    one-pixel score ring costs 8%, and 480 x 640 takes 120 blocks, one
//    wave on the 132 SMs.
// 4. The halo tile is staged with 16-byte loads, all of a thread's loads
//    issued before its stores, and both maps are written with 16-byte
//    stores, a thread per 4 adjacent pixels; 4-byte loads and stores
//    where W is not a multiple of 4 or a pointer is not 16-byte aligned.
//
// Exactness.  The plain score is max_s where(ok_s, sum_s, 0) over the 16
// starts of each polarity, with sum_s = (d[s] - t) + (d[s+1] - t) + ...
// in arc order.  A start that does not qualify contributes 0, which the
// initial 0 of the maximum already holds, so its sum never reaches the
// result; a qualifying start's sum is formed here by the same sequence
// of separately rounded float32 operations (0 + x is exact, and there
// are no products, so no contraction).  The maximum of float32 values
// does not depend on their order.  The pretest is a necessary condition
// (any 9 or 12 contiguous circle pixels hold two consecutive compass
// pixels), decided on the same differences and compares, so a pixel it
// rejects has no qualifying start and scores 0 either way; the list's
// order, which varies from run to run, decides nothing, since each entry
// writes only its own position.  So the raw map equals the plain one
// bit for bit, and NMS (maxima and compares only) does too.  Pixels
// within 3 of the image edge score 0, as the plain border mask gives;
// off-image neighbours in the NMS window hold 0, which decides the same
// as the plain version's -inf pad because a pixel survives only with a
// score > 0.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GSLAM_FAST_TW
#define GSLAM_FAST_TW 64          // output tile width, a multiple of 4
#endif
#ifndef GSLAM_FAST_TH
#define GSLAM_FAST_TH 40          // output tile height
#endif
#ifndef GSLAM_FAST_THREADS
#define GSLAM_FAST_THREADS 1024   // threads per block
#endif

namespace {

constexpr int TW = GSLAM_FAST_TW;
constexpr int TH = GSLAM_FAST_TH;
constexpr int NT = GSLAM_FAST_THREADS;
constexpr int HALO = 4;               // circle radius 3 + 1 NMS ring
constexpr int SW = TW + 2 * HALO;     // staged tile
constexpr int SH = TH + 2 * HALO;
constexpr int RW = TW + 2;            // raw score on the tile + 1 ring
constexpr int RH = TH + 2;
constexpr int NPOS = RH * RW;         // scored positions
// raw row stride and column offset: output quad tx reads raw columns
// tx .. tx + 5, stored at tx + 2 .. tx + 7 (a float2 and a float4)
constexpr int RSTRIDE = TW + 4;
constexpr int ROFF = 2;
static_assert(TW % 4 == 0, "GSLAM_FAST_TW must be a multiple of 4");
static_assert(NT % 32 == 0 && NT <= 1024, "GSLAM_FAST_THREADS");
static_assert(NPOS <= 65536, "tile too large for 16-bit positions");

// arc starts s (bits 0..15) whose ARC circle pixels s .. s+ARC-1 (mod
// 16) are all set in the 16-bit mask m
template <int ARC>
__device__ __forceinline__ unsigned arc_starts(unsigned m) {
    const unsigned x = m | (m << 16);   // bit s + 16 repeats bit s
    unsigned y = x & (x >> 1);          // s, s+1
    y &= y >> 2;                        // s .. s+3
    y &= y >> 4;                        // s .. s+7
    if (ARC == 9)
        y &= x >> 8;                    // s .. s+8
    else
        y &= y >> 4;                    // s .. s+11
    return y & 0xffffu;
}

// the circle in FAST_OFFSETS order (Bresenham, radius 3), offsets + 3
// packed four bits a pixel: dx or dy of circle pixel k is
// ((PACK >> 4k) & 15) - 3
constexpr unsigned long long pack_circle(const int (&o)[16]) {
    unsigned long long p = 0;
    for (int k = 0; k < 16; ++k)
        p |= static_cast<unsigned long long>(o[k] + 3) << (4 * k);
    return p;
}
constexpr int CIRCLE_DX[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                               0, -1, -2, -3, -3, -3, -2, -1};
constexpr int CIRCLE_DY[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                               -3, -3, -2, -1, 0, 1, 2, 3};
constexpr unsigned long long PACK_DX = pack_circle(CIRCLE_DX);
constexpr unsigned long long PACK_DY = pack_circle(CIRCLE_DY);

// the raw FAST score of the staged pixel (sy, sx) by the half warp that
// calls it (lanes 0-15 or 16-31, all 32 lanes calling together): lane
// k of the half takes circle pixel k and arc start k.  The 16 compares
// become the two masks by a ballot, the ARC differences of a start come
// from the half's lanes by shuffles, and the 16 starts' maxima meet in
// four shuffle steps.  ``ok`` false: a lane of a half without a pixel.
template <int ARC>
__device__ __forceinline__ float fast_score_half(const float (*tile)[SW],
                                                 int sy, int sx, float t,
                                                 bool ok) {
    const int lane = threadIdx.x & 31, k = lane & 15, half = lane & 16;
    float d = 0.0f;
    if (ok) {
        const int dx = static_cast<int>((PACK_DX >> (4 * k)) & 15) - 3;
        const int dy = static_cast<int>((PACK_DY >> (4 * k)) & 15) - 3;
        d = tile[sy + dy][sx + dx] - tile[sy][sx];
    }
    const unsigned mb = __ballot_sync(0xffffffffu, ok && d > t) >> half;
    const unsigned md = __ballot_sync(0xffffffffu, ok && d < -t) >> half;
    const unsigned qb = arc_starts<ARC>(mb & 0xffffu);
    const unsigned qd = arc_starts<ARC>(md & 0xffffu);
    // start k: its sums in arc order, each term separately rounded
    float v[ARC];
#pragma unroll
    for (int j = 0; j < ARC; ++j)
        v[j] = __shfl_sync(0xffffffffu, d, half | ((k + j) & 15));
    float sb = 0.0f, sd = 0.0f;
#pragma unroll
    for (int j = 0; j < ARC; ++j) {
        sb = sb + (v[j] - t);
        sd = sd + (-v[j] - t);
    }
    float best = fmaxf((qb >> k) & 1u ? sb : 0.0f, (qd >> k) & 1u ? sd : 0.0f);
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
        best = fmaxf(best, __shfl_xor_sync(0xffffffffu, best, off));
    return best;
}

// the compass pretest: some two consecutive compass pixels (circle
// pixels 0, 4, 8, 12) both bright or both dark.  Any 9 or 12 contiguous
// circle pixels hold two consecutive compass pixels, so a pixel that
// fails has no qualifying arc and scores 0; the differences and compares
// are the full test's own
__device__ __forceinline__ bool compass_pass(const float (*tile)[SW],
                                             int sy, int sx, float t) {
    const float c = tile[sy][sx];
    const float d0 = tile[sy + 3][sx] - c, d4 = tile[sy][sx + 3] - c;
    const float d8 = tile[sy - 3][sx] - c, d12 = tile[sy][sx - 3] - c;
    const float nt = -t;
    const unsigned b = (d0 > t) | (d4 > t) << 1 | (d8 > t) << 2
                       | (d12 > t) << 3;
    const unsigned k = (d0 < nt) | (d4 < nt) << 1 | (d8 < nt) << 2
                       | (d12 < nt) << 3;
    return ((b & (b >> 1 | b << 3)) | (k & (k >> 1 | k << 3))) & 15u;
}

template <int ARC>
__global__ void __launch_bounds__(NT)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ nms_out,
                float* __restrict__ raw_out, int H, int W, float t,
                int vec) {
    __shared__ __align__(16) float tile[SH][SW];
    __shared__ __align__(16) float raw[RH][RSTRIDE];
    __shared__ unsigned short cand_pos[NPOS];
    __shared__ int n_cand;
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tid = threadIdx.x;
    if (tid == 0) n_cand = 0;

    // 1. the tile and its halo; off-image pixels hold 0
    if (vec) {
        // W % 4 == 0 and x0 - HALO % 4 == 0: a 4-pixel chunk lies wholly
        // inside or wholly outside the image
        constexpr int CW = SW / 4;
        constexpr int NCH = SH * CW;
        constexpr int PER = (NCH + NT - 1) / NT;
        float4 v[PER];
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int i = tid + k * NT;
            const int gy = y0 - HALO + i / CW;
            const int gx = x0 - HALO + 4 * (i % CW);
            v[k] = make_float4(0.f, 0.f, 0.f, 0.f);
            if (i < NCH && gy >= 0 && gy < H && gx >= 0 && gx < W)
                v[k] = __ldg(reinterpret_cast<const float4*>(
                    img + (size_t)gy * W + gx));
        }
#pragma unroll
        for (int k = 0; k < PER; ++k) {
            const int i = tid + k * NT;
            if (i < NCH)
                *reinterpret_cast<float4*>(&tile[i / CW][4 * (i % CW)]) =
                    v[k];
        }
    } else {
        for (int i = tid; i < SH * SW; i += NT) {
            const int sy = i / SW, sx = i % SW;
            const int gy = y0 - HALO + sy, gx = x0 - HALO + sx;
            tile[sy][sx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                               ? __ldg(img + (size_t)gy * W + gx) : 0.0f;
        }
    }
    __syncthreads();

    // 2a. the raw score on the tile and a one-pixel ring: the compass
    // pretest on every position, whose candidates (inside the border)
    // go to a list in shared memory; every other position scores 0
    const int lane = tid & 31;
    for (int i0 = 0; i0 < NPOS; i0 += NT) {     // the same trip count
        const int i = i0 + tid;                 // for every thread
        bool cand = false;
        if (i < NPOS) {
            const int ry = i / RW, rx = i % RW;
            const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
            cand = gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3
                   && compass_pass(tile, ry + HALO - 1, rx + HALO - 1, t);
            if (!cand) raw[ry][rx + ROFF] = 0.0f;
        }
        const unsigned ball = __ballot_sync(0xffffffffu, cand);
        if (ball) {
            int base = 0;
            if (lane == 0) base = atomicAdd(&n_cand, __popc(ball));
            base = __shfl_sync(0xffffffffu, base, 0);
            if (cand)
                cand_pos[base + __popc(ball & ((1u << lane) - 1u))] =
                    static_cast<unsigned short>(i);
        }
    }
    __syncthreads();

    // 2b. the full test and the sums of the qualifying starts, half a
    // warp per candidate (their order in the list does not matter: each
    // writes only its own position)
    const int nc = n_cand;
    for (int e0 = 2 * (tid >> 5); e0 < nc; e0 += NT / 16) {
        const int e = e0 + ((tid >> 4) & 1);
        const bool ok = e < nc;
        const int i = ok ? cand_pos[e] : 0;
        const int ry = i / RW, rx = i % RW;
        const float s = fast_score_half<ARC>(tile, ry + HALO - 1,
                                             rx + HALO - 1, t, ok);
        if (ok && (tid & 15) == 0) raw[ry][rx + ROFF] = s;
    }
    __syncthreads();

    // 3. NMS over 3 x 3 and both maps, 4 adjacent pixels per thread
    constexpr int QW = TW / 4;
    for (int i = tid; i < TH * QW; i += NT) {
        const int ty = i / QW, tx = 4 * (i % QW);
        const int gy = y0 + ty, gx = x0 + tx;
        if (gy >= H || gx >= W) continue;
        float r[3][6];
#pragma unroll
        for (int dy = 0; dy < 3; ++dy) {
            const float2 a = *reinterpret_cast<const float2*>(
                &raw[ty + dy][tx + ROFF]);
            const float4 b = *reinterpret_cast<const float4*>(
                &raw[ty + dy][tx + ROFF + 2]);
            r[dy][0] = a.x; r[dy][1] = a.y;
            r[dy][2] = b.x; r[dy][3] = b.y; r[dy][4] = b.z; r[dy][5] = b.w;
        }
        float c[4], n[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
            c[q] = r[1][q + 1];
            float mx = c[q];
#pragma unroll
            for (int dy = 0; dy < 3; ++dy)
#pragma unroll
                for (int dx = 0; dx < 3; ++dx)
                    mx = fmaxf(mx, r[dy][q + dx]);
            n[q] = (c[q] >= mx && c[q] > 0.0f) ? c[q] : 0.0f;
        }
        const size_t o = (size_t)gy * W + gx;
        if (vec) {
            *reinterpret_cast<float4*>(nms_out + o) =
                make_float4(n[0], n[1], n[2], n[3]);
            *reinterpret_cast<float4*>(raw_out + o) =
                make_float4(c[0], c[1], c[2], c[3]);
        } else {
#pragma unroll
            for (int q = 0; q < 4; ++q)
                if (gx + q < W) {
                    nms_out[o + q] = n[q];
                    raw_out[o + q] = c[q];
                }
        }
    }
}

}  // namespace

// img, nms_out, raw_out: (H, W) float32 device pointers.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int gslam_fast_nms(const float* img, float* nms_out,
                              float* raw_out, int H, int W, float threshold,
                              int arc, void* stream) {
    if (H < 1 || W < 1) return static_cast<int>(cudaErrorInvalidValue);
    const uintptr_t ptrs = reinterpret_cast<uintptr_t>(img)
                           | reinterpret_cast<uintptr_t>(nms_out)
                           | reinterpret_cast<uintptr_t>(raw_out);
    const int vec = (W % 4 == 0) && (ptrs % 16 == 0);
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (arc == 9)
        fast_nms_kernel<9><<<grid, NT, 0, s>>>(img, nms_out, raw_out, H, W,
                                              threshold, vec);
    else if (arc == 12)
        fast_nms_kernel<12><<<grid, NT, 0, s>>>(img, nms_out, raw_out, H, W,
                                               threshold, vec);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
