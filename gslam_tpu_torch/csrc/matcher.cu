// Hamming matcher over packed 256-bit descriptors: per-row best and
// second-best distance and best column, per-column best row.
//
// Replaces the TPU kernel gslam_tpu/ops/pallas/matcher.py
// (_matcher_kernel, called by _matcher_call / match_hamming_pallas).
// Gold: the plain PyTorch hamming_top2 in gslam_tpu_torch/ops/matching.py
// (identical outputs; the ratio / max_dist / mutual decisions stay in
// PyTorch, matches_from_top2).
//
// Bound at the main-path shape (N = 2048 map descriptors against M = 512
// keypoints): about 110 kB moved (0.03 us at 3.35 TB/s) and
// N x M x (8 words x 3 integer operations (xor, popc, add) + 4 top-2
// and column compares) = 29 M operations (0.44 us at the 67 T/s
// non-tensor rate): operations bound on paper, launch bound in practice.
//
// Design: Hamming distance is __popc(a ^ b) over 8 words, exact integer
// arithmetic, so no +/-1 GEMM is needed.  One thread owns one row of A
// and keeps its running best / second / column in registers; B is
// staged through shared memory in tiles of 256 rows.  For the column
// argmin across blocks, every (row, column) distance is packed as
// (dist << 16) | row, reduced by warp shuffles and folded into the
// column's slot with one atomicMin per warp: deterministic, and its tie
// rule (lowest distance, then lowest row) is jnp.argmin's.  The (N, M)
// matrix never reaches global memory.
//
// Ties: columns are scanned in increasing order and only a strictly
// smaller distance replaces the best, so the best column is the lowest
// of equal minima, and `second` equals `best` when two columns tie.
// Invalid rows or columns count as distance 257 (BITS + 1), so a column
// masked in every row points back to row 0, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int ROWS = 64;           // threads per block, one A row each
constexpr int TILE = 256;          // B rows staged per step
constexpr int MASKED = 257;        // BITS + 1

__global__ void init_keys(uint32_t* keys, int M) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < M) keys[j] = 0xffffffffu;
}

__global__ void __launch_bounds__(ROWS)
matcher_kernel(const int32_t* __restrict__ A, const uint8_t* __restrict__ av,
               const int32_t* __restrict__ B, const uint8_t* __restrict__ bv,
               int N, int M, float* __restrict__ best_out,
               float* __restrict__ second_out, int32_t* __restrict__ idx_out,
               uint32_t* __restrict__ keys) {
    __shared__ uint32_t sB[TILE][WORDS];
    __shared__ uint8_t sV[TILE];
    const int i = blockIdx.x * ROWS + threadIdx.x;
    const int lane = threadIdx.x & 31;
    const bool row_in = i < N;
    const bool va = row_in && av[i] != 0;
    uint32_t a[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
        a[w] = row_in ? static_cast<uint32_t>(A[(size_t)i * WORDS + w]) : 0u;

    int best = 0x7fffffff, second = 0x7fffffff, bidx = 0;
    for (int j0 = 0; j0 < M; j0 += TILE) {
        const int n = min(TILE, M - j0);
        __syncthreads();                  // previous tile fully read
        for (int e = threadIdx.x; e < n * WORDS; e += ROWS)
            sB[e / WORDS][e % WORDS] =
                static_cast<uint32_t>(B[(size_t)j0 * WORDS + e]);
        for (int e = threadIdx.x; e < n; e += ROWS) sV[e] = bv[j0 + e];
        __syncthreads();
        for (int jj = 0; jj < n; ++jj) {
            int d = MASKED;
            if (va && sV[jj]) {
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
            uint32_t key = row_in ? ((static_cast<uint32_t>(d) << 16) |
                                     static_cast<uint32_t>(i))
                                  : 0xffffffffu;
#pragma unroll
            for (int off = 16; off > 0; off >>= 1)
                key = min(key, __shfl_xor_sync(0xffffffffu, key, off));
            if (lane == 0 && key != 0xffffffffu) atomicMin(keys + j0 + jj, key);
        }
    }
    if (row_in) {
        best_out[i] = static_cast<float>(best);
        second_out[i] = static_cast<float>(second);
        idx_out[i] = bidx;
    }
}

__global__ void keys_to_rows(const uint32_t* keys, int32_t* back, int M) {
    const int j = blockIdx.x * blockDim.x + threadIdx.x;
    if (j < M) back[j] = static_cast<int32_t>(keys[j] & 0xffffu);
}

}  // namespace

// A (N, 8) / B (M, 8) int32 words, av (N,) / bv (M,) bool bytes; outputs
// best / second (N,) float32, idx (N,) int32, back (M,) int32; keys (M,)
// 32-bit scratch.  Needs 1 <= N <= 65535 and M >= 2.  Returns the CUDA
// error of the launches.
extern "C" int gslam_match_hamming(const int32_t* A, const uint8_t* av,
                                   const int32_t* B, const uint8_t* bv,
                                   int N, int M, float* best, float* second,
                                   int32_t* idx, int32_t* back,
                                   uint32_t* keys, void* stream) {
    if (N < 1 || N > 65535 || M < 2)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int cb = 256, cg = (M + cb - 1) / cb;
    init_keys<<<cg, cb, 0, s>>>(keys, M);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    matcher_kernel<<<(N + ROWS - 1) / ROWS, ROWS, 0, s>>>(
        A, av, B, bv, N, M, best, second, idx, keys);
    err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    keys_to_rows<<<cg, cb, 0, s>>>(keys, back, M);
    return static_cast<int>(cudaGetLastError());
}
