// Rotated BRIEF-256: sample 256 rotated point pairs per keypoint from
// the blurred image and pack the comparisons into 8 32-bit words.
//
// Replaces the TPU kernel gslam_tpu/ops/pallas/brief.py (_brief_kernel,
// called by brief_bits_pallas / brief_descriptors_pallas).  Gold: the
// plain PyTorch brief_from_rotation in gslam_tpu_torch/ops/frontend.py,
// bit for bit given the same cos/sin tensors.
//
// Bound at the main-path shape (K = 512 keypoints on a 480 x 640 image):
// counting the image as read once, about 1.26 MB moved (0.38 us at
// 3.35 TB/s); the work is 512 x 512 = 262k pixel reads and about 31
// operations per bit (8 products, 6 sums, 4 roundings, 8 clamps, 2
// addresses, 1 compare: 4.1 M operations, 0.06 us): bytes bound on
// paper, launch bound in practice, and the sampled pixels are L2
// resident (the image is 1.2 MB of a 50 MB L2).
//
// Design: one block of 256 threads per keypoint, one thread per bit, so
// warp w owns descriptor word w.  Each lane rotates its pattern pair,
// rounds, clamps, reads two pixels and compares; __ballot_sync packs the
// warp's 32 comparisons into word w directly, lane j giving bit j.  The
// (TPU) one-hot selection GEMM is not needed: a gather is cheap here.
//
// Exactness: x = cx + (px*ca - py*sa), y = cy + (px*sa + py*ca) with
// every product and sum rounded on its own (__fmul_rn / __fadd_rn, and
// the library is built with -fmad=false), in the plain version's
// parenthesization; rintf rounds half to even as torch.round does.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BITS = 256;
constexpr int WORDS = BITS / 32;

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

__global__ void __launch_bounds__(BITS)
brief_kernel(const float* __restrict__ img, const float* __restrict__ uv,
             const float* __restrict__ ca, const float* __restrict__ sa,
             const float* __restrict__ pattern, int32_t* __restrict__ out,
             int H, int W) {
    const int k = blockIdx.x;
    const int j = threadIdx.x;                 // bit index
    const float cx = uv[2 * k], cy = uv[2 * k + 1];
    const float c = ca[k], s = sa[k];
    const float p1x = pattern[4 * j], p1y = pattern[4 * j + 1];
    const float p2x = pattern[4 * j + 2], p2y = pattern[4 * j + 3];

    const float x1 = __fadd_rn(cx, __fsub_rn(__fmul_rn(p1x, c),
                                             __fmul_rn(p1y, s)));
    const float y1 = __fadd_rn(cy, __fadd_rn(__fmul_rn(p1x, s),
                                             __fmul_rn(p1y, c)));
    const float x2 = __fadd_rn(cx, __fsub_rn(__fmul_rn(p2x, c),
                                             __fmul_rn(p2y, s)));
    const float y2 = __fadd_rn(cy, __fadd_rn(__fmul_rn(p2x, s),
                                             __fmul_rn(p2y, c)));
    const int xi1 = clampi(static_cast<int>(rintf(x1)), 0, W - 1);
    const int yi1 = clampi(static_cast<int>(rintf(y1)), 0, H - 1);
    const int xi2 = clampi(static_cast<int>(rintf(x2)), 0, W - 1);
    const int yi2 = clampi(static_cast<int>(rintf(y2)), 0, H - 1);
    const float a = __ldg(img + (size_t)yi1 * W + xi1);
    const float b = __ldg(img + (size_t)yi2 * W + xi2);

    const unsigned word = __ballot_sync(0xffffffffu, a < b);
    if ((j & 31) == 0)
        out[k * WORDS + (j >> 5)] = static_cast<int32_t>(word);
}

}  // namespace

// img (H, W), uv (K, 2), ca/sa (K,), pattern (256, 4): float32 device
// pointers; out (K, 8) int32.  Returns the CUDA error of the launch.
extern "C" int gslam_brief(const float* img, const float* uv,
                           const float* ca, const float* sa,
                           const float* pattern, int32_t* out, int K, int H,
                           int W, void* stream) {
    if (K == 0) return 0;
    brief_kernel<<<K, BITS, 0, static_cast<cudaStream_t>(stream)>>>(
        img, uv, ca, sa, pattern, out, H, W);
    return static_cast<int>(cudaGetLastError());
}
