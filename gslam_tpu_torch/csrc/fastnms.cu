// FAST-9/16 corner score + 3x3 non-maximum suppression in one pass.
//
// Replaces the TPU kernel gslam_tpu/ops/pallas/fastnms.py
// (_fast_nms_kernel, called by fast_nms_raw_pallas).  Gold: the plain
// PyTorch fast_score + nms in gslam_tpu_torch/ops/frontend.py.
//
// Bound at the main-path shape (480 x 640 float32): 1.2 MB read and
// 2.5 MB written (about 1.1 us at 3.35 TB/s), and about 920 float32
// operations per pixel as this kernel issues them (16 circle
// differences; for each of 16 arc starts, two compares, two threshold
// subtractions and two running sums per arc pixel and two maxima; 10
// for NMS), about 0.28 G operations or 4.2 us at 67 TFLOP/s: operations
// bound on paper, launch bound in practice at this size.
//
// Design: one 32 x 16 output tile per block of 32 x 8 threads.  The tile
// plus a 4-pixel halo (circle radius 3 + 1 NMS ring) is staged in shared
// memory once; the raw score is computed on the tile plus a 1-pixel ring
// into shared memory; NMS then reads its 3 x 3 neighbourhood there; both
// maps are written once.  Global memory is read once per pixel (plus
// halo) and written twice, the minimum for two outputs.
//
// Exactness: the arc sums run in arc order from the first arc pixel, as
// the plain version does, with separately rounded subtractions (there
// are no products to contract).  Pixels within 3 of the image edge score
// 0, as the reference's border mask gives; off-image neighbours in the
// NMS window hold 0, which decides the same as the reference's -inf pad
// because a pixel survives only with a score > 0.

#include <cuda_runtime.h>

namespace {

constexpr int TW = 32;            // tile width  (= blockDim.x)
constexpr int TH = 16;            // tile height
constexpr int BY = 8;             // blockDim.y
constexpr int NT = TW * BY;       // threads per block
constexpr int HALO = 4;
constexpr int SW = TW + 2 * HALO;
constexpr int SH = TH + 2 * HALO;
constexpr int RW = TW + 2;        // raw score on the tile + 1 ring
constexpr int RH = TH + 2;

// the 16-pixel Bresenham circle of radius 3, in FAST_OFFSETS order
__constant__ int c_dx[16] = {0, 1, 2, 3, 3, 3, 2, 1,
                             0, -1, -2, -3, -3, -3, -2, -1};
__constant__ int c_dy[16] = {3, 3, 2, 1, 0, -1, -2, -3,
                             -3, -3, -2, -1, 0, 1, 2, 3};

template <int ARC>
__device__ float fast_score_at(const float (*tile)[SW], int sy, int sx,
                               float t) {
    const float c = tile[sy][sx];
    float d[16];
#pragma unroll
    for (int k = 0; k < 16; ++k)
        d[k] = tile[sy + c_dy[k]][sx + c_dx[k]] - c;
    float best_b = 0.0f, best_d = 0.0f;
#pragma unroll
    for (int s = 0; s < 16; ++s) {
        bool okb = true, okd = true;
        float sb = 0.0f, sd = 0.0f;
#pragma unroll
        for (int k = 0; k < ARC; ++k) {
            const float v = d[(s + k) & 15];
            okb = okb && (v > t);
            okd = okd && (v < -t);
            sb = sb + (v - t);
            sd = sd + (-v - t);
        }
        best_b = fmaxf(best_b, okb ? sb : 0.0f);
        best_d = fmaxf(best_d, okd ? sd : 0.0f);
    }
    return fmaxf(best_b, best_d);
}

template <int ARC>
__global__ void __launch_bounds__(NT)
fast_nms_kernel(const float* __restrict__ img, float* __restrict__ nms_out,
                float* __restrict__ raw_out, int H, int W, float t) {
    __shared__ float tile[SH][SW];
    __shared__ float raw[RH][RW];
    const int x0 = blockIdx.x * TW;
    const int y0 = blockIdx.y * TH;
    const int tid = threadIdx.y * TW + threadIdx.x;

    for (int i = tid; i < SH * SW; i += NT) {
        const int sy = i / SW, sx = i % SW;
        const int gy = y0 - HALO + sy, gx = x0 - HALO + sx;
        tile[sy][sx] = (gy >= 0 && gy < H && gx >= 0 && gx < W)
                           ? img[(size_t)gy * W + gx] : 0.0f;
    }
    __syncthreads();

    for (int i = tid; i < RH * RW; i += NT) {
        const int ry = i / RW, rx = i % RW;
        const int gy = y0 - 1 + ry, gx = x0 - 1 + rx;
        float s = 0.0f;
        if (gy >= 3 && gy < H - 3 && gx >= 3 && gx < W - 3)
            s = fast_score_at<ARC>(tile, ry + HALO - 1, rx + HALO - 1, t);
        raw[ry][rx] = s;
    }
    __syncthreads();

    for (int i = tid; i < TH * TW; i += NT) {
        const int ty = i / TW, tx = i % TW;
        const int gy = y0 + ty, gx = x0 + tx;
        if (gy >= H || gx >= W) continue;
        const float c = raw[ty + 1][tx + 1];
        float mx = c;
#pragma unroll
        for (int dy = 0; dy < 3; ++dy)
#pragma unroll
            for (int dx = 0; dx < 3; ++dx)
                mx = fmaxf(mx, raw[ty + dy][tx + dx]);
        const size_t o = (size_t)gy * W + gx;
        nms_out[o] = (c >= mx && c > 0.0f) ? c : 0.0f;
        raw_out[o] = c;
    }
}

}  // namespace

// img, nms_out, raw_out: (H, W) float32 device pointers.  Returns the
// CUDA error of the launch (0 on success).
extern "C" int gslam_fast_nms(const float* img, float* nms_out,
                              float* raw_out, int H, int W, float threshold,
                              int arc, void* stream) {
    const dim3 block(TW, BY);
    const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (arc == 9)
        fast_nms_kernel<9><<<grid, block, 0, s>>>(img, nms_out, raw_out, H,
                                                  W, threshold);
    else if (arc == 12)
        fast_nms_kernel<12><<<grid, block, 0, s>>>(img, nms_out, raw_out,
                                                   H, W, threshold);
    else
        return static_cast<int>(cudaErrorInvalidValue);
    return static_cast<int>(cudaGetLastError());
}
