// Intensity-centroid moments at the keypoints: for each keypoint the
// 31 x 31 patch's m01 and m10, from which the caller forms the ORB
// orientation atan2(m01, m10).
//
// Replaces no TPU kernel: the JAX package computes orientation in plain
// jnp (gslam_tpu/ops/frontend.py:225 orientation_map, :249
// compute_orientations), two separable 31-tap moment filters over the
// whole image, read at the keypoints.  The port's plain version is the
// same (gslam_tpu_torch/ops/frontend.py: orientation_map, _gather2d,
// centroid_moments); on the card it is some 260 launches a pyramid
// level, each over the whole level image, for values read at 8-2000
// keypoints.  This kernel is one launch a level and reads only the
// patches.  Gold: centroid_moments, bit for bit.
//
// Bound at the ORB cell's level 0 (K = 2000 keypoints on 376 x 1241):
// the image read once is 1.87 MB (0.56 us at 3.35 TB/s); the work is 89
// float operations a patch row and 89 to fold the rows, 2848 a keypoint,
// 5.7 M in all (0.09 us at 67 TFLOP/s): bytes bound on paper; in
// practice latency bound, the patches being L2 resident: the keypoint's
// load, the patch's loads, a chain of 30 dependent sums a lane, then 30
// more in lanes 0 and 1, whatever K (PERF.md's table has the times).
//
// Design: a warp a keypoint, 8 warps a block, no atomics.  The warp
// stages the patch in shared memory, row by row with lane c loading
// column c (coalesced, all 31 rows in flight at once), at a row stride
// of 33 floats so that lanes reading down their own rows hit 31
// different banks.  Lane r forms row r's two sums; lanes 0 and 1 fold
// the 31 row sums of m10 and m01.  The sums' order is fixed by the
// plain version, so no tree reduction can shorten the chains.
//
// Exactness: the plain version is two separable filters (_sep_filter),
// each a row pass then a column pass of shift-multiply-adds in tap
// order, every product and sum rounded on its own; this kernel takes the
// same products and sums in the same order, with __fmul_rn / __fadd_rn
// (and the library is built with -fmad=false):
//   m10: row sum ramp[0] p[0] + ramp[1] p[1] + ... + ramp[30] p[30]
//        (ramp[j] = j - 15, the zero centre tap skipped), column sum
//        R[0] + R[1] + ... + R[30] (weights 1, exact);
//   m01: row sum p[0] + p[1] + ... + p[30] (weights 1), column sum
//        ramp[0] S[0] + ... + ramp[30] S[30], the centre skipped.
// A pixel outside the image reads +0, as the filters' zero padding, and
// a row outside it sums to +0, as the column pass's padding.  The centre
// follows _gather2d: uv truncated toward zero, a negative index wrapped
// once, then clamped into the image.  atan2 stays with the caller.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int R = 15;            // patch radius
constexpr int D = 2 * R + 1;     // patch side, 31
constexpr int STRIDE = D + 2;    // shared row stride, 33 floats
constexpr int WARPS = 8;         // warps (keypoints) a block

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(WARPS * 32)
orient_kernel(const float* __restrict__ img, const float* __restrict__ uv,
              float* __restrict__ m01, float* __restrict__ m10, int K,
              int H, int W) {
    __shared__ float patch[WARPS][D * STRIDE];
    __shared__ float rows10[WARPS][32];
    __shared__ float rows01[WARPS][32];
    const int lane = threadIdx.x & 31;
    const int w = threadIdx.x >> 5;
    const int k = blockIdx.x * WARPS + w;
    if (k >= K) return;              // a whole warp: no block barrier below
    int xi = static_cast<int>(__ldg(uv + 2 * k));       // toward zero
    int yi = static_cast<int>(__ldg(uv + 2 * k + 1));
    xi = clampi(xi < 0 ? xi + W : xi, 0, W - 1);
    yi = clampi(yi < 0 ? yi + H : yi, 0, H - 1);

    float* p = patch[w];
    const int x = xi - R + lane;
    const bool col_in = lane < D && x >= 0 && x < W;
#pragma unroll
    for (int r = 0; r < D; ++r) {
        const int y = yi - R + r;
        if (lane < D)
            p[r * STRIDE + lane] = (col_in && y >= 0 && y < H)
                ? __ldg(img + static_cast<size_t>(y) * W + x) : 0.0f;
    }
    __syncwarp();

    if (lane < D) {
        const float* row = p + lane * STRIDE;
        float s10 = 0.0f, s01 = 0.0f;
        const int y = yi - R + lane;
        if (y >= 0 && y < H) {
            s10 = __fmul_rn(static_cast<float>(-R), row[0]);
            s01 = row[0];
#pragma unroll
            for (int j = 1; j < D; ++j) {
                if (j != R)
                    s10 = __fadd_rn(s10, __fmul_rn(
                        static_cast<float>(j - R), row[j]));
                s01 = __fadd_rn(s01, row[j]);
            }
        }
        rows10[w][lane] = s10;
        rows01[w][lane] = s01;
    }
    __syncwarp();

    if (lane == 0) {
        float m = rows10[w][0];
#pragma unroll
        for (int i = 1; i < D; ++i) m = __fadd_rn(m, rows10[w][i]);
        m10[k] = m;
    } else if (lane == 1) {
        float m = __fmul_rn(static_cast<float>(-R), rows01[w][0]);
#pragma unroll
        for (int i = 1; i < D; ++i)
            if (i != R)
                m = __fadd_rn(m, __fmul_rn(static_cast<float>(i - R),
                                           rows01[w][i]));
        m01[k] = m;
    }
}

}  // namespace

// img (H, W), uv (K, 2): float32 device pointers; m01, m10 (K,) float32.
// Returns the CUDA error of the launch.
extern "C" int gslam_orient(const float* img, const float* uv, float* m01,
                            float* m10, int K, int H, int W, void* stream) {
    if (K == 0) return 0;
    orient_kernel<<<(K + WARPS - 1) / WARPS, WARPS * 32, 0,
                    static_cast<cudaStream_t>(stream)>>>(img, uv, m01, m10,
                                                         K, H, W);
    return static_cast<int>(cudaGetLastError());
}
