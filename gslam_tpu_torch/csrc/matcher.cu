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
// keypoints): about 110 kB moved (0.03 us at 3.35 TB/s) and N x M x 8 =
// 8.4 M population counts with as many xors and adds, 2.2 us at the
// 15.4 such steps per clock and SM this card was measured to do (the
// popc pipe: NVIDIA's CUDA C++ programming manual gives 16 popc per
// clock and SM for compute capability 9.0): operations bound on paper,
// and of the size of a launch (an empty kernel takes 0.9 us in a CUDA
// graph on the card named below).
//
// What bounded the first design (0.1421 ms on an NVIDIA H100 80GB HBM3
// at 700 W, slower than the plain version's 0.096 ms): 32 blocks of 64
// threads (64 warps on a card with 132 SMs), every thread walking all M
// columns in sequence, and in each step five dependent shuffles and one
// atomicMin for the column argmin: 32,768 atomics on 512 addresses.
//
// Design (0.0088 ms on the same card): a block of 8 warps owns a tile
// of 32 rows x 128 columns (N = 2048, M = 512: 64 x 4 = 256 blocks).  A
// lane owns four columns of the tile (lane, lane + 32, ...) and keeps
// their words in registers; a warp owns four rows and reads each row's
// words at a warp-uniform address.  Every distance is formed once, in a
// register, and feeds both reductions:
//   rows: a lane keeps (best, second, column) over its columns, scanned
//     in increasing order; the warp merges the lanes' triples with five
//     shuffle steps per row (not per pair), ordered by (distance,
//     column), and writes the tile's triple as a partial;
//   columns: the lane owns its columns over all of the warp's rows, so
//     the column minimum of the packed key (distance << 16) | row needs
//     no shuffle; the block's eight warps meet in shared memory and the
//     tile's key is written as a partial.
//   matcher_merge: a thread per row merges the column tiles' triples in
//     tile order; a thread per column takes the least key over the row
//     tiles and unpacks the row.
// No atomics and no memset: two kernels a call.  Neither tile is staged
// in shared memory: a tile is 1 KB of rows and 4 KB of columns, read
// once per block through L1/L2 with 16-byte loads.
//
// Distances stay __popc(a ^ b) on the CUDA cores: at this size they
// cost as much as a launch, and the outputs must be exact integers.  A
// much larger N x M would call for the tensor cores: the single-bit
// mma.sync m16n8k256 with xor/and .popc (one 256-bit descriptor is one
// k step), or the +/-1 int8 product the Pallas kernel uses, as wgmma.
//
// Ties: a lane scans its columns in increasing order and only a
// strictly smaller distance replaces its best; every merge orders
// (distance, column) lexicographically, the winner keeps its second and
// the loser's best competes for second place.  So the best column is
// the lowest of equal minima, within a tile and across tiles, and
// `second` equals `best` when two columns tie.  The column key orders
// (distance, row), so the lowest row wins among equal minima
// (jnp.argmin's rule).  Invalid rows or columns count as distance 257
// (BITS + 1): a row masked everywhere gives 257, 257 and column 0, a
// column masked in every row points back to row 0, as in the reference.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int WARPS = 8;
constexpr int ROWS_W = 4;              // rows per warp
constexpr int COLS_L = 4;              // columns per lane
constexpr int TR = WARPS * ROWS_W;     // 32 rows per tile
constexpr int TC = 32 * COLS_L;        // 128 columns per tile
constexpr int MASKED = 257;            // BITS + 1
constexpr int NONE = MASKED + 1;       // larger than any distance
constexpr int NO_COL = 0x7fffffff;

// Merge (ob, oi, os) into (best, bidx, second), ordered by (distance,
// column): the winner keeps its second, the loser's best competes for
// second place.
__device__ __forceinline__ void merge_top2(int& best, int& bidx, int& second,
                                           int ob, int oi, int os) {
    if (ob < best || (ob == best && oi < bidx)) {
        second = min(os, best);
        best = ob;
        bidx = oi;
    } else {
        second = min(second, ob);
    }
}

// Tile (blockIdx.y, blockIdx.x) = (row tile, column tile).  rows: per
// column tile and row, (best | second << 16, column); cols: per row tile
// and column, the packed key.
__global__ void __launch_bounds__(WARPS * 32)
matcher_tiles(const int32_t* __restrict__ A, const uint8_t* __restrict__ av,
              const int32_t* __restrict__ B, const uint8_t* __restrict__ bv,
              int N, int M, int2* __restrict__ rows,
              uint32_t* __restrict__ cols) {
    __shared__ uint32_t skey[WARPS][TC];
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
    const int j0 = blockIdx.x * TC;
    const int i0 = blockIdx.y * TR + warp * ROWS_W;

    // this lane's columns: words, validity, whether inside the matrix
    uint32_t b[COLS_L][WORDS];
    bool b_in[COLS_L], b_ok[COLS_L];
    uint32_t kmin[COLS_L];
#pragma unroll
    for (int k = 0; k < COLS_L; ++k) {
        const int j = j0 + lane + 32 * k;
        b_in[k] = j < M;
        b_ok[k] = b_in[k] && bv[j] != 0;
        kmin[k] = 0xffffffffu;
        const uint4* src = reinterpret_cast<const uint4*>(
            B + (size_t)(b_in[k] ? j : 0) * WORDS);
        const uint4 lo = src[0], hi = src[1];
        b[k][0] = lo.x; b[k][1] = lo.y; b[k][2] = lo.z; b[k][3] = lo.w;
        b[k][4] = hi.x; b[k][5] = hi.y; b[k][6] = hi.z; b[k][7] = hi.w;
    }

#pragma unroll
    for (int r = 0; r < ROWS_W; ++r) {
        const int i = i0 + r;
        if (i >= N) break;                       // warp-uniform
        const uint4* src = reinterpret_cast<const uint4*>(
            A + (size_t)i * WORDS);
        const uint4 lo = src[0], hi = src[1];
        const uint32_t a[WORDS] = {lo.x, lo.y, lo.z, lo.w,
                                   hi.x, hi.y, hi.z, hi.w};
        const bool va = av[i] != 0;
        int best = NONE, second = NONE, bidx = NO_COL;
#pragma unroll
        for (int k = 0; k < COLS_L; ++k) {
            if (!b_in[k]) continue;
            int d = MASKED;
            if (va && b_ok[k]) {
                d = 0;
#pragma unroll
                for (int w = 0; w < WORDS; ++w) d += __popc(a[w] ^ b[k][w]);
            }
            if (d < best) {
                second = best;
                best = d;
                bidx = j0 + lane + 32 * k;
            } else if (d < second) {
                second = d;
            }
            kmin[k] = min(kmin[k], (static_cast<uint32_t>(d) << 16)
                                   | static_cast<uint32_t>(i));
        }
#pragma unroll
        for (int off = 16; off > 0; off >>= 1) {
            const int ob = __shfl_xor_sync(0xffffffffu, best, off);
            const int oi = __shfl_xor_sync(0xffffffffu, bidx, off);
            const int os = __shfl_xor_sync(0xffffffffu, second, off);
            merge_top2(best, bidx, second, ob, oi, os);
        }
        if (lane == 0)
            rows[(size_t)blockIdx.x * N + i] =
                make_int2(best | (second << 16), bidx);
    }

    // the tile's column minima: the warps meet in shared memory
#pragma unroll
    for (int k = 0; k < COLS_L; ++k) skey[warp][lane + 32 * k] = kmin[k];
    __syncthreads();
    const int jj = threadIdx.x;
    if (jj < TC && j0 + jj < M) {
        uint32_t key = skey[0][jj];
#pragma unroll
        for (int w = 1; w < WARPS; ++w) key = min(key, skey[w][jj]);
        cols[(size_t)blockIdx.y * M + j0 + jj] = key;
    }
}

__global__ void matcher_merge(const int2* __restrict__ rows,
                              const uint32_t* __restrict__ cols, int N, int M,
                              int n_ct, int n_rt, float* __restrict__ best_out,
                              float* __restrict__ second_out,
                              int32_t* __restrict__ idx_out,
                              int32_t* __restrict__ back) {
    const int t = blockIdx.x * blockDim.x + threadIdx.x;
    if (t < N) {
        int best = NONE, second = NONE, bidx = NO_COL;
        for (int ct = 0; ct < n_ct; ++ct) {
            const int2 v = rows[(size_t)ct * N + t];
            merge_top2(best, bidx, second, v.x & 0xffff, v.y, v.x >> 16);
        }
        best_out[t] = static_cast<float>(best);
        second_out[t] = static_cast<float>(min(second, MASKED));
        idx_out[t] = bidx;
    } else if (t < N + M) {
        const int j = t - N;
        uint32_t key = 0xffffffffu;
        for (int rt = 0; rt < n_rt; ++rt)
            key = min(key, cols[(size_t)rt * M + j]);
        back[j] = static_cast<int32_t>(key & 0xffffu);
    }
}

}  // namespace

// 32-bit words of scratch the caller allocates for gslam_match_hamming:
// the row partials (two words per column tile and row) and the column
// partials (one word per row tile and column).
extern "C" long long gslam_match_scratch(int N, int M) {
    const long long n_ct = (M + TC - 1) / TC, n_rt = (N + TR - 1) / TR;
    return 2 * n_ct * N + n_rt * M;
}

// A (N, 8) / B (M, 8) int32 words, av (N,) / bv (M,) bool bytes; outputs
// best / second (N,) float32, idx (N,) int32, back (M,) int32; scratch:
// gslam_match_scratch(N, M) 32-bit words, 16-byte aligned.  Needs
// 1 <= N <= 65535 and M >= 2.  Returns the CUDA error of the launches.
extern "C" int gslam_match_hamming(const int32_t* A, const uint8_t* av,
                                   const int32_t* B, const uint8_t* bv,
                                   int N, int M, float* best, float* second,
                                   int32_t* idx, int32_t* back,
                                   uint32_t* scratch, void* stream) {
    if (N < 1 || N > 65535 || M < 2)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    const int n_ct = (M + TC - 1) / TC, n_rt = (N + TR - 1) / TR;
    int2* rows = reinterpret_cast<int2*>(scratch);
    uint32_t* cols = scratch + 2 * (size_t)n_ct * N;
    matcher_tiles<<<dim3(n_ct, n_rt), WARPS * 32, 0, s>>>(A, av, B, bv, N, M,
                                                          rows, cols);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
    const int mb = 256;
    matcher_merge<<<(N + M + mb - 1) / mb, mb, 0, s>>>(
        rows, cols, N, M, n_ct, n_rt, best, second, idx, back);
    return static_cast<int>(cudaGetLastError());
}
