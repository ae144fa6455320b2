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
// What held the first design (a block of 256 threads per keypoint, a
// thread per bit), split by phase with scripts/tune_kernels.py b2 on an
// NVIDIA H100 80GB HBM3 at 700 W: 512 blocks launched and their stores
// 0.00109 ms, the pattern and keypoint loads and the endpoints 0.00081
// ms more (every thread reading its 4 pattern floats and the keypoint's
// uv, cos and sin, 8 loads of 4 bytes), the pixel gathers and compares
// 0.00018 ms more; 0.00208 ms in all.
//
// Design: SPLIT warps share a keypoint, warp `part` computing words
// part, part + SPLIT, ...; lane j computes bit j of each, i.e. pattern
// pair 32 w + j, so each word is one __ballot_sync.  A lane reads its
// pattern pairs as 16-byte loads and keeps them in registers for the
// KPW keypoints its warp takes one after another; per keypoint it forms
// all its endpoints, issues all its gathers, then compares; lane i
// stores the warp's word i.  The chosen values (tune_kernels.py b2): blocks of 16 warps,
// 8 warps a keypoint (a warp a word, two keypoints a block, 256 blocks
// at K = 512), one keypoint a warp.  A warp a keypoint (lane j: bit j
// of all 8 words, 16 gathers in flight), in 128 blocks of 4 warps, took
// 0.0023 ms: a warp issues its 16 endpoints and gathers one after
// another, and 4 warps an SM hide little of it.  What holds the kept
// design is latency: the launch, the keypoint and pattern loads, the
// dependent gathers, the store.
//
// Exactness: x = cx + (px*ca - py*sa), y = cy + (px*sa + py*ca) with
// every product and sum rounded on its own (__fmul_rn / __fadd_rn, and
// the library is built with -fmad=false), in the plain version's
// parenthesization; rintf rounds half to even as torch.round does; the
// endpoints are clamped into the image.  cos and sin come from the
// caller, as in the TPU wrapper.

#include <cuda_runtime.h>
#include <stdint.h>

// tuning builds may override these with -D: warps per block, warps per
// keypoint and keypoints per warp
#ifndef GSLAM_BRIEF_WARPS
#define GSLAM_BRIEF_WARPS 16
#endif
#ifndef GSLAM_BRIEF_SPLIT
#define GSLAM_BRIEF_SPLIT 8
#endif
#ifndef GSLAM_BRIEF_KPW
#define GSLAM_BRIEF_KPW 1
#endif
// 0 stores zeros, 1 adds the pattern and keypoint loads and the
// endpoints (a bit compares the two addresses), 2 (the default) adds the
// pixel gathers.  Tuning builds stop early to split the time by phase.
#ifndef GSLAM_BRIEF_PHASE
#define GSLAM_BRIEF_PHASE 2
#endif

namespace {

constexpr int WORDS = 8;
constexpr int WARPS = GSLAM_BRIEF_WARPS;   // warps per block
constexpr int SPLIT = GSLAM_BRIEF_SPLIT;   // warps per keypoint
constexpr int KPW = GSLAM_BRIEF_KPW;       // keypoints per warp
constexpr int NW = WORDS / SPLIT;          // words per warp
static_assert(SPLIT == 1 || SPLIT == 2 || SPLIT == 4 || SPLIT == 8,
              "BRIEF_SPLIT: 1, 2, 4 or 8");
static_assert(WARPS % SPLIT == 0, "BRIEF_WARPS: a multiple of BRIEF_SPLIT");

__device__ __forceinline__ int clampi(int v, int lo, int hi) {
    return v < lo ? lo : (v > hi ? hi : v);
}

// The image offset of a rotated pattern point (px, py) about (cx, cy).
__device__ __forceinline__ int endpoint(float px, float py, float cx,
                                        float cy, float c, float s, int H,
                                        int W) {
    const float x = __fadd_rn(cx, __fsub_rn(__fmul_rn(px, c),
                                            __fmul_rn(py, s)));
    const float y = __fadd_rn(cy, __fadd_rn(__fmul_rn(px, s),
                                            __fmul_rn(py, c)));
    const int xi = clampi(static_cast<int>(rintf(x)), 0, W - 1);
    const int yi = clampi(static_cast<int>(rintf(y)), 0, H - 1);
    return yi * W + xi;
}

// Warp part (of SPLIT) of a keypoint computes words part + SPLIT i.
__global__ void __launch_bounds__(WARPS * 32)
brief_kernel(const float* __restrict__ img, const float* __restrict__ uv,
             const float* __restrict__ ca, const float* __restrict__ sa,
             const float4* __restrict__ pattern, int32_t* __restrict__ out,
             int K, int H, int W) {
    const unsigned FULL = 0xffffffffu;
    const int lane = threadIdx.x & 31;
    const int gw = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const int part = gw % SPLIT;
    const int k0 = gw / SPLIT * KPW;
    if (k0 >= K) return;
#if GSLAM_BRIEF_PHASE >= 1
    float4 pat[NW];                      // pairs 32 (part + SPLIT i) + lane
#pragma unroll
    for (int i = 0; i < NW; ++i)
        pat[i] = __ldg(pattern + 32 * (part + SPLIT * i) + lane);
#endif
    for (int n = 0; n < KPW && k0 + n < K; ++n) {
        const int k = k0 + n;
        unsigned word[NW];
#if GSLAM_BRIEF_PHASE == 0
#pragma unroll
        for (int i = 0; i < NW; ++i) word[i] = 0;
#else
        const float cx = __ldg(uv + 2 * k), cy = __ldg(uv + 2 * k + 1);
        const float c = __ldg(ca + k), s = __ldg(sa + k);
        int a[NW], b[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) {
            a[i] = endpoint(pat[i].x, pat[i].y, cx, cy, c, s, H, W);
            b[i] = endpoint(pat[i].z, pat[i].w, cx, cy, c, s, H, W);
        }
#if GSLAM_BRIEF_PHASE == 1
#pragma unroll
        for (int i = 0; i < NW; ++i)
            word[i] = __ballot_sync(FULL, a[i] < b[i]);
#else
        float va[NW], vb[NW];
#pragma unroll
        for (int i = 0; i < NW; ++i) {
            va[i] = __ldg(img + a[i]);
            vb[i] = __ldg(img + b[i]);
        }
#pragma unroll
        for (int i = 0; i < NW; ++i)
            word[i] = __ballot_sync(FULL, va[i] < vb[i]);
#endif
#endif
        // lane i stores word part + SPLIT i: one 32-byte sector a keypoint
#pragma unroll
        for (int i = 0; i < NW; ++i)
            if (lane == i)
                out[(size_t)k * WORDS + part + SPLIT * i] =
                    static_cast<int32_t>(word[i]);
    }
}

}  // namespace

// img (H, W), uv (K, 2), ca/sa (K,), pattern (256, 4): float32 device
// pointers; out (K, 8) int32.  pattern 16-byte aligned (a fresh tensor
// is).  Returns the CUDA error of the launch.
extern "C" int gslam_brief(const float* img, const float* uv,
                           const float* ca, const float* sa,
                           const float* pattern, int32_t* out, int K, int H,
                           int W, void* stream) {
    if (K == 0) return 0;
    if (reinterpret_cast<uintptr_t>(pattern) & 15)
        return static_cast<int>(cudaErrorMisalignedAddress);
    const int per_block = WARPS / SPLIT * KPW;
    brief_kernel<<<(K + per_block - 1) / per_block, WARPS * 32, 0,
                   static_cast<cudaStream_t>(stream)>>>(
        img, uv, ca, sa, reinterpret_cast<const float4*>(pattern), out, K,
        H, W);
    return static_cast<int>(cudaGetLastError());
}
