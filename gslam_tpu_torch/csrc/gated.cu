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
// keypoints): about 110 kB moved (0.03 us at 3.35 TB/s), the gate of
// every pair (6 float operations, 1 M pairs) and 8 Hamming steps only
// for the pairs inside the gate (about 1.4% of them): 0.0001 ms, far
// under the launch floor.  What is left is latency (the launch, the
// staging loads, the barriers) and the issue of the gate tests.
//
// What held the first design back: each of the N x M pairs formed its
// popc (8 xor, 8 popc, 7 adds) and a top-2 update, though only the
// pairs inside the gate (1.4% here) need them, and popc issues at a
// quarter of the integer rate (16 lanes a clock and SM).  A warp per row
// walked its columns one at a time, 16 dependent steps a lane at
// M = 512, with 8 warps an SM; 256 blocks each staged all 512 keypoints
// with 4-byte loads.  Skipping the warp steps where no lane had a pair
// inside the gate still left the popc on about a third of them, each at
// 1.4% of its lanes: the popc pipe pays for a whole warp.  This design:
//
// 1. Only the pairs inside the gate reach the popc, and in full warps:
//    every lane tests the gate of its column against each of the warp's
//    rows, a ballot per (column step, row) appends the pairs inside to
//    the warp's queue in shared memory, (column << 5 | row), and the
//    queue is drained 32 pairs at a time, a lane a pair: the row's words
//    come from registers, the keypoint's from shared memory.  Every pair
//    outside the gate counts as MASKED at its column, so a row starts at
//    (MASKED, column 0).
// 2. GSLAM_GATED_ROWS map rows per warp, their words and pixels in
//    registers, and GSLAM_GATED_WARPS warps a block (tuned by
//    scripts/tune_kernels.py: 1 and 16, a warp per row and 16 rows a
//    block).  The keypoints are staged once a block, 128 times at
//    N = 2048 (256 before).
// 3. A lane takes GSLAM_GATED_UNROLL columns a step, their pixels read
//    from shared memory before the first gate test.
// 4. Staging with 16-byte loads (a descriptor is two uint4), all of a
//    thread's loads issued before its stores, into two unpadded planes
//    (words 0-3, words 4-7): a warp reading 32 consecutive columns reads
//    512 contiguous bytes per plane, no bank conflict.  Pixels are
//    staged as float2, an invalid keypoint's as NaN, so the gate rejects
//    it (as an invalid row's pixel is NaN): validity needs no test of
//    its own.
// 5. A column-tile loop of GSLAM_GATED_TILE keypoints, so any M >= 1
//    works (the main path's M = 512 and the loop run's 384 take one
//    tile); the queue is drained before the next tile is staged.
//
// Exactness: the gate is (dx*dx + dy*dy) <= gate2 with __fsub_rn /
// __fmul_rn / __fadd_rn in the plain version's order, so gate decisions
// match bit for bit; a NaN pixel fails the compare, as a masked pair
// does in the plain version.  Ties: every update (a pair into a lane's
// top-2, then the lanes of a warp) orders (distance, column)
// lexicographically, the winner keeping its second and the loser's best
// competing for second.  The result does not depend on the order the
// pairs arrive in: the best column is the lowest of equal minima
// (lax.top_k's rule) and `second` equals `best` when two columns tie.
// Masked pairs count as 257 (BITS + 1), more than any distance: a row
// with one pair inside the gate has second = 257 (the plain version's
// too when M = 1, from its masked fill), and a row with every pair
// masked gives best = second = 257 and column 0.

#include <cuda_runtime.h>
#include <stdint.h>

#ifndef GSLAM_GATED_WARPS
#define GSLAM_GATED_WARPS 16      // warps per block
#endif
#ifndef GSLAM_GATED_ROWS
#define GSLAM_GATED_ROWS 1        // map rows per warp
#endif
#ifndef GSLAM_GATED_UNROLL
#define GSLAM_GATED_UNROLL 4      // columns a lane tests per step
#endif
#ifndef GSLAM_GATED_TILE
#define GSLAM_GATED_TILE 512      // keypoint columns staged per step
#endif

namespace {

constexpr int WARPS = GSLAM_GATED_WARPS;
constexpr int ROWS = GSLAM_GATED_ROWS;
constexpr int UNROLL = GSLAM_GATED_UNROLL;
constexpr int TILE = GSLAM_GATED_TILE;
constexpr int NT = WARPS * 32;
constexpr int ROWS_PER_BLOCK = WARPS * ROWS;
constexpr int CHUNK = 32 * UNROLL;              // columns per warp step
constexpr int MASKED = 257;         // BITS + 1
constexpr unsigned FULL = 0xffffffffu;
// a chunk's pairs (UNROLL x ROWS ballots of up to 32) and a partial
// batch left from the chunk before
constexpr int QCAP = 32 * (UNROLL * ROWS + 1);
static_assert(ROWS <= 32, "GSLAM_GATED_ROWS above 32");
static_assert(TILE % 32 == 0, "GSLAM_GATED_TILE must be a multiple of 32");
static_assert(TILE < (1 << 26), "GSLAM_GATED_TILE above 2^26");
static_assert(TILE * 40 + WARPS * QCAP * 4 <= 48 * 1024,
              "shared memory above 48 kB: lower GSLAM_GATED_TILE");

// words 4h .. 4h+3 of descriptor j; 16-byte loads when VEC
template <bool VEC>
__device__ __forceinline__ uint4 load_words(const int32_t* __restrict__ D,
                                            size_t j, int h) {
    const int32_t* p = D + j * 8 + 4 * h;
    if (VEC) return __ldg(reinterpret_cast<const uint4*>(p));
    return make_uint4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}

__device__ __forceinline__ float2 nan2() {
    const float q = __int_as_float(0x7fc00000);
    return make_float2(q, q);
}

// pixel j, NaN where invalid (the gate then rejects every pair with it)
template <bool VEC>
__device__ __forceinline__ float2 load_pixel(const float* __restrict__ uv,
                                             const uint8_t* __restrict__ v,
                                             size_t j) {
    const float2 p = VEC ? __ldg(reinterpret_cast<const float2*>(uv) + j)
                         : make_float2(__ldg(uv + 2 * j),
                                       __ldg(uv + 2 * j + 1));
    return __ldg(v + j) ? p : nan2();
}

__device__ __forceinline__ int popc8(const uint4& a0, const uint4& a1,
                                     const uint4& b0, const uint4& b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y) + __popc(a0.z ^ b0.z)
           + __popc(a0.w ^ b0.w) + __popc(a1.x ^ b1.x)
           + __popc(a1.y ^ b1.y) + __popc(a1.z ^ b1.z)
           + __popc(a1.w ^ b1.w);
}

// (best, column, second) merge: the winner by (distance, column) keeps
// its second, the loser's best competes for second place
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

// one pair inside the gate, queued as (column in the tile) << 5 | row:
// its distance joins the lane's top-2 of that row
__device__ __forceinline__ void take_pair(int e, int j0,
                                          const uint4* sLo, const uint4* sHi,
                                          const uint4 (&a0)[ROWS],
                                          const uint4 (&a1)[ROWS],
                                          int (&best)[ROWS],
                                          int (&second)[ROWS],
                                          int (&bidx)[ROWS]) {
    const int jj = e >> 5, rc = e & 31;
    uint4 x0 = a0[0], x1 = a1[0];
#pragma unroll
    for (int r = 1; r < ROWS; ++r)
        if (rc == r) {
            x0 = a0[r];
            x1 = a1[r];
        }
    const int d = popc8(x0, x1, sLo[jj], sHi[jj]);
#pragma unroll
    for (int r = 0; r < ROWS; ++r)
        if (rc == r) merge_top2(best[r], bidx[r], second[r], d, j0 + jj,
                                MASKED);
}

template <bool VEC>
__global__ void __launch_bounds__(NT)
gated_kernel(const int32_t* __restrict__ A, const uint8_t* __restrict__ av,
             const float* __restrict__ uva,
             const int32_t* __restrict__ B, const uint8_t* __restrict__ bv,
             const float* __restrict__ uvb, int N, int M, float gate2,
             float* __restrict__ best_out, float* __restrict__ second_out,
             int32_t* __restrict__ idx_out) {
    __shared__ uint4 sLo[TILE], sHi[TILE];   // words 0-3, words 4-7
    __shared__ float2 sP[TILE];
    __shared__ int sQ[WARPS][QCAP];          // each warp's queue
    const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
    const int row0 = blockIdx.x * ROWS_PER_BLOCK + warp * ROWS;

    uint4 a0[ROWS], a1[ROWS];
    float ax[ROWS], ay[ROWS];
    int best[ROWS], second[ROWS], bidx[ROWS];
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
        const int i = row0 + r;
        float2 p = nan2();
        a0[r] = a1[r] = make_uint4(0u, 0u, 0u, 0u);
        if (i < N) {
            a0[r] = load_words<VEC>(A, i, 0);
            a1[r] = load_words<VEC>(A, i, 1);
            p = load_pixel<VEC>(uva, av, i);
        }
        ax[r] = p.x;
        ay[r] = p.y;
        // every pair outside the gate counts as MASKED at its column, so
        // a row starts at (MASKED, column 0) and only the pairs inside
        // the gate (distance <= 256) are visited
        best[r] = second[r] = MASKED;
        bidx[r] = 0;
    }

    int* const queue = sQ[warp];
    const unsigned below = (1u << lane) - 1u;
    int qn = 0;                       // pairs queued, the same in every lane
    int j0 = 0;
    // the queued pairs, a lane each, 32 at a time: all of them when
    // ``last``, else whole batches, the rest moved to the front
    auto drain = [&](bool last) {
        __syncwarp();
        int e = 0;
        for (; e + 32 <= qn || (last && e < qn); e += 32)
            if (e + lane < qn)
                take_pair(queue[e + lane], j0, sLo, sHi, a0, a1, best,
                          second, bidx);
        const int rest = last ? 0 : qn - e;
        const int v = lane < rest ? queue[e + lane] : 0;
        __syncwarp();
        if (lane < rest) queue[lane] = v;
        __syncwarp();
        qn = rest;
    };

    for (; j0 < M; j0 += TILE) {
        const int n = min(TILE, M - j0);
        __syncthreads();                  // previous tile fully read
        {
            constexpr int PW = (2 * TILE + NT - 1) / NT;
            constexpr int PP = (TILE + NT - 1) / NT;
            uint4 w[PW];
            float2 p[PP];
#pragma unroll
            for (int k = 0; k < PW; ++k) {
                const int e = tid + k * NT;   // half e & 1 of column e >> 1
                if (e < 2 * n) w[k] = load_words<VEC>(B, j0 + (e >> 1),
                                                      e & 1);
            }
#pragma unroll
            for (int k = 0; k < PP; ++k) {
                const int e = tid + k * NT;
                if (e < n) p[k] = load_pixel<VEC>(uvb, bv, j0 + e);
            }
#pragma unroll
            for (int k = 0; k < PW; ++k) {
                const int e = tid + k * NT;
                if (e < 2 * n) {
                    if (e & 1) sHi[e >> 1] = w[k];
                    else sLo[e >> 1] = w[k];
                }
            }
#pragma unroll
            for (int k = 0; k < PP; ++k) {
                const int e = tid + k * NT;
                if (e < n) sP[e] = p[k];
            }
        }
        __syncthreads();
        for (int c0 = 0; c0 < n; c0 += CHUNK) {
            float2 kp[UNROLL];
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
                const int jj = c0 + 32 * u + lane;
                kp[u] = jj < n ? sP[jj] : nan2();
            }
            // the pairs inside the gate join the warp's queue
#pragma unroll
            for (int u = 0; u < UNROLL; ++u) {
#pragma unroll
                for (int r = 0; r < ROWS; ++r) {
                    const float dx = __fsub_rn(ax[r], kp[u].x);
                    const float dy = __fsub_rn(ay[r], kp[u].y);
                    const bool in = __fadd_rn(__fmul_rn(dx, dx),
                                              __fmul_rn(dy, dy)) <= gate2;
                    const unsigned ball = __ballot_sync(FULL, in);
                    if (in)
                        queue[qn + __popc(ball & below)] =
                            (c0 + 32 * u + lane) << 5 | r;
                    qn += __popc(ball);
                }
            }
            drain(false);
        }
        drain(true);
    }
    // merge the lanes
#pragma unroll
    for (int r = 0; r < ROWS; ++r) {
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
            merge_top2(best[r], bidx[r], second[r],
                       __shfl_xor_sync(FULL, best[r], off),
                       __shfl_xor_sync(FULL, bidx[r], off),
                       __shfl_xor_sync(FULL, second[r], off));
        if (lane == r && row0 + r < N) {
            best_out[row0 + r] = static_cast<float>(best[r]);
            second_out[row0 + r] = static_cast<float>(second[r]);
            idx_out[row0 + r] = bidx[r];
        }
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
    const bool vec = ((reinterpret_cast<uintptr_t>(A)
                       | reinterpret_cast<uintptr_t>(B)) % 16 == 0)
                     && ((reinterpret_cast<uintptr_t>(uva)
                          | reinterpret_cast<uintptr_t>(uvb)) % 8 == 0);
    const int blocks = (N + ROWS_PER_BLOCK - 1) / ROWS_PER_BLOCK;
    if (vec)
        gated_kernel<true><<<blocks, NT, 0, s>>>(
            A, av, uva, B, bv, uvb, N, M, gate2, best, second, idx);
    else
        gated_kernel<false><<<blocks, NT, 0, s>>>(
            A, av, uva, B, bv, uvb, N, M, gate2, best, second, idx);
    return static_cast<int>(cudaGetLastError());
}
