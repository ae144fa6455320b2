// Projection-gated Hamming matcher: per map row, the best and
// second-best distance and the best column among the keypoints that lie
// within the pixel gate of the row's projection.
//
// Replaces the TPU kernel gslam_tpu/ops/pallas/matcher.py
// (_gated_kernel, called by match_hamming_gated_pallas).  Gold: the
// plain PyTorch hamming_top2_gated in gslam_tpu_torch/ops/matching.py
// (identical outputs; the ratio / max_dist decisions stay in PyTorch).
//
// Bound at the main-path shape (N = 2048 map rows against M = 512
// keypoints): about 110 kB moved (0.03 us at 3.35 TB/s) and N x M x
// (8 words x 3 integer operations + 5 gate operations + 3 top-2
// compares) = 33 M operations (0.5 us at the 67 T/s non-tensor rate):
// operations bound on paper, launch bound in practice.
//
// Design: Hamming distance is __popc(a ^ b) over 8 words, exact integer
// arithmetic.  One warp owns one row: its lanes take the columns
// lane, lane + 32, ... (so N = 2048 rows are 2048 warps, 256 blocks of
// 8 warps over the 132 SMs), keep a lane-local best / second / column,
// and merge them with five shuffle steps.  The keypoints (descriptors
// with a padded row stride against bank conflicts, pixels, validity)
// are staged in shared memory in tiles of 512 columns.
//
// Exactness: the gate is (dx*dx + dy*dy) <= gate2 with __fmul_rn /
// __fadd_rn in the plain version's order, so gate decisions match bit
// for bit.  Ties: each lane scans its columns in increasing order and
// only a strictly smaller distance replaces its best; the warp merge
// orders (distance, column) lexicographically, so the best column is
// the lowest of equal minima (lax.top_k's rule), and `second` equals
// `best` when two columns tie.  Masked pairs count as 257 (BITS + 1); a
// row with every pair masked gives best = second = 257 and column 0.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int WARPS = 8;            // rows per block
constexpr int TILE = 512;           // keypoint columns staged per step
constexpr int MASKED = 257;         // BITS + 1
constexpr int NONE = MASKED + 1;    // larger than any distance

__global__ void __launch_bounds__(WARPS * 32)
gated_kernel(const int32_t* __restrict__ A, const uint8_t* __restrict__ av,
             const float* __restrict__ uva,
             const int32_t* __restrict__ B, const uint8_t* __restrict__ bv,
             const float* __restrict__ uvb, int N, int M, float gate2,
             float* __restrict__ best_out, float* __restrict__ second_out,
             int32_t* __restrict__ idx_out) {
    __shared__ uint32_t sB[TILE][WORDS + 1];
    __shared__ float sX[TILE], sY[TILE];
    __shared__ uint8_t sV[TILE];
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
    const bool row_in = i < N;
    const bool va = row_in && av[i] != 0;
    uint32_t a[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
        a[w] = row_in ? static_cast<uint32_t>(A[(size_t)i * WORDS + w]) : 0u;
    const float ax = row_in ? uva[2 * (size_t)i] : 0.f;
    const float ay = row_in ? uva[2 * (size_t)i + 1] : 0.f;

    int best = NONE, second = NONE, bidx = 0x7fffffff;
    for (int j0 = 0; j0 < M; j0 += TILE) {
        const int n = min(TILE, M - j0);
        __syncthreads();                  // previous tile fully read
        for (int e = threadIdx.x; e < n * WORDS; e += blockDim.x)
            sB[e / WORDS][e % WORDS] =
                static_cast<uint32_t>(B[(size_t)j0 * WORDS + e]);
        for (int e = threadIdx.x; e < n; e += blockDim.x) {
            sX[e] = uvb[2 * (size_t)(j0 + e)];
            sY[e] = uvb[2 * (size_t)(j0 + e) + 1];
            sV[e] = bv[j0 + e];
        }
        __syncthreads();
        for (int jj = lane; jj < n; jj += 32) {
            const float dx = __fsub_rn(ax, sX[jj]);
            const float dy = __fsub_rn(ay, sY[jj]);
            const float d2 = __fadd_rn(__fmul_rn(dx, dx), __fmul_rn(dy, dy));
            int d = MASKED;
            if (va && sV[jj] && d2 <= gate2) {
                d = 0;
#pragma unroll
                for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ sB[jj][w]);
            }
            if (d < best) {
                second = best;
                best = d;
                bidx = j0 + jj;
            } else if (d < second) {
                second = d;
            }
        }
    }
    // merge the lanes' (best, column, second): the winner keeps its
    // second, the loser's best competes for second place
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
        const int ob = __shfl_xor_sync(0xffffffffu, best, off);
        const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
        const int os = __shfl_xor_sync(0xffffffffu, second, off);
        if (ob < best || (ob == best && oi < bidx)) {
            second = min(os, best);
            best = ob;
            bidx = oi;
        } else {
            second = min(second, ob);
        }
    }
    if (row_in && lane == 0) {
        best_out[i] = static_cast<float>(best);
        second_out[i] = static_cast<float>(min(second, MASKED));
        idx_out[i] = bidx;
    }
}

}  // namespace

// A (N, 8) / B (M, 8) int32 words, av (N,) / bv (M,) bool bytes,
// uva (N, 2) / uvb (M, 2) float32 pixels, gate2 the squared gate radius;
// outputs best / second (N,) float32 and idx (N,) int32.  Needs N >= 1
// and M >= 1.  Returns the CUDA error of the launch.
extern "C" int gslam_match_gated(const int32_t* A, const uint8_t* av,
                                 const float* uva, const int32_t* B,
                                 const uint8_t* bv, const float* uvb,
                                 int N, int M, float gate2, float* best,
                                 float* second, int32_t* idx, void* stream) {
    if (N < 1 || M < 1) return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    gated_kernel<<<(N + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        A, av, uva, B, bv, uvb, N, M, gate2, best, second, idx);
    return static_cast<int>(cudaGetLastError());
}
