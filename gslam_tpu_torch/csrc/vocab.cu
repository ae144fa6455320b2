// Bag-of-words tree descent: the leaf word of each descriptor in a
// complete k-ary vocabulary tree.
//
// Replaces the TPU kernel gslam_tpu/ops/pallas/vocab.py (_vocab_kernel,
// called by transform_words_pallas).  Gold: the plain PyTorch
// _transform_words in gslam_tpu_torch/ops/vocab.py (identical word ids).
//
// The TPU kernel forms the distance from every descriptor to EVERY node
// with one matrix product and takes L masked argmins over it, because a
// TPU has no cheap gather; it therefore holds the whole table on chip
// and caps it at 8192 nodes.  On this card the same function is a
// descent: per descriptor and level, the Hamming distance to the k
// children of the current node, the first strict minimum, node = node *
// k + best.  It has no table cap.
//
// Bound: at the loop-closure shape (N = 384, k = 6, L = 2) 15.6 kB and
// 37 k xor-popcount steps, under 0.00001 ms either way.  What holds it is
// latency, link after link: every level needs the previous level's
// answer.  Split by phase with scripts/tune_kernels.py b7 on an NVIDIA
// H100 80GB HBM3 at 700 W, the first design (a warp per descriptor,
// every level read from L2, five shuffles a level) took 0.00122 ms to
// launch and store, +0.00018 for the descriptor and +0.00036 to
// +0.00044 a level.  Staging the top levels in shared memory for a whole
// block (a copy and a barrier) cost +0.0006 and left each level at
// +0.0003 to +0.0004, no faster.
//
// Design: a warp owns a descriptor.  The top S levels of the table
// (rows 1 .. (k^(S+1) - 1) / (k - 1) - 1; S the most whole levels within
// GSLAM_VOCAB_TOP_ROWS rows, worked out at launch from k and L) do not
// depend on the descriptor, so every warp's first loads are those rows,
// R = 1, 2 or 4 a lane, beside its descriptor's two 16-byte halves and
// validity: one L2 round trip.  Each lane forms the distances to its
// rows; a level l <= S is then a choice among rows already in registers:
// a lane keys (distance << 20 | child) those of its rows that are
// children of the current node, and one redux.sync.min over the warp
// gives the child.  Deeper levels read their children from global memory
// (lane c: child c, c + 32, ...; two 16-byte loads a row) and take the
// same warp minimum.  The key orders (distance, child) lexicographically,
// so ties go to the lowest child, as argmin breaks them: the words equal
// the plain version's exactly.  Invalid rows write -1 and do not descend.
//
// Measured the same way, 64 rows held: launch and store 0.00123 to
// 0.00128 ms; the loads of the descriptor and the held rows with their
// distances +0.00040 at 42 rows (two a lane), +0.00027 at 8 or 10 rows
// (one a lane); a held level +0.00006 to +0.00009; a level past them
// +0.00039 to +0.00041.  Holding 72 or 110 rows (four a lane) took
// +0.00059 for the loads, about what the L2 level it spares costs, so at
// k = 8, L = 4 and k = 10, L = 6 the 64- and 128-row builds time alike
// (0.00278 and 0.00277 ms; 0.00350 and 0.00345); 64 rows hold the loop
// path's k = 6, L = 2 tree (42 rows) whole.  In turns against the first
// design (scripts/compare_trees.py): 0.00176 against 0.00194 ms at N =
// 384, k = 6, L = 2; 0.00178 against 0.00215 at N = 512.  Four warps a
// block (tried 2, 4, 8 and 16), 64 rows (tried 0, 32, 64 and 128).

#include <cuda_runtime.h>
#include <stdint.h>

// tuning builds may override this with -D: descriptors (warps) per block
#ifndef GSLAM_VOCAB_DPB
#define GSLAM_VOCAB_DPB 4
#endif
// tuning builds may override this with -D: the most table rows below the
// root (levels 1..S, whole levels only) a warp holds, at most 128
#ifndef GSLAM_VOCAB_TOP_ROWS
#define GSLAM_VOCAB_TOP_ROWS 64
#endif
// split builds stop after phase 0 (launch, store -1), 1 (the loads of the
// descriptor and the table's top, and their distances) or 1 + l (level
// l); the default runs every level
#ifndef GSLAM_VOCAB_PHASE
#define GSLAM_VOCAB_PHASE 99
#endif

namespace {

constexpr int DPB = GSLAM_VOCAB_DPB;
constexpr int THREADS = 32 * DPB;
constexpr int CHILD_BITS = 20;      // k < 2^20
constexpr int CHILD_MASK = (1 << CHILD_BITS) - 1;
constexpr int NO_KEY = 0x7fffffff;
constexpr int TOP_ROWS = GSLAM_VOCAB_TOP_ROWS;   // up to 4 a lane

static_assert(DPB >= 1 && DPB <= 32, "GSLAM_VOCAB_DPB must be 1 to 32");
static_assert(TOP_ROWS >= 0 && TOP_ROWS <= 128,
              "GSLAM_VOCAB_TOP_ROWS must be 0 to 128");

__device__ __forceinline__ int hamming(const uint4& a0, const uint4& a1,
                                       const uint4& b0, const uint4& b1) {
    return __popc(a0.x ^ b0.x) + __popc(a0.y ^ b0.y)
         + __popc(a0.z ^ b0.z) + __popc(a0.w ^ b0.w)
         + __popc(a1.x ^ b1.x) + __popc(a1.y ^ b1.y)
         + __popc(a1.z ^ b1.z) + __popc(a1.w ^ b1.w);
}

// R = top rows a lane holds (0: none staged)
template <int R>
__global__ void __launch_bounds__(THREADS)
vocab_kernel(const uint4* __restrict__ nodes, const uint4* __restrict__ desc,
             const uint8_t* __restrict__ valid, int N, int k, int L, int S,
             int top_rows, int32_t* __restrict__ words) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * DPB + (threadIdx.x >> 5);
    if (i >= N) return;             // whole warps leave together
#if GSLAM_VOCAB_PHASE == 0
    if (lane == 0) words[i] = -1;
#else
    // lane t-th row: table row 1 + lane + 32 t, clamped into the top
    int dist[R > 0 ? R : 1];
    uint4 top[R > 0 ? 2 * R : 1];
#pragma unroll
    for (int t = 0; t < R; ++t) {
        const int r = 1 + min(lane + 32 * t, top_rows - 1);
        top[2 * t] = __ldg(nodes + 2 * r);
        top[2 * t + 1] = __ldg(nodes + 2 * r + 1);
    }
    const uint4 a0 = __ldg(desc + 2 * static_cast<size_t>(i));
    const uint4 a1 = __ldg(desc + 2 * static_cast<size_t>(i) + 1);
    const bool ok = valid[i] != 0;  // the same in the whole warp
#pragma unroll
    for (int t = 0; t < R; ++t)
        dist[t] = hamming(a0, a1, top[2 * t], top[2 * t + 1]);
    int node = 0;                   // position within the level
#if GSLAM_VOCAB_PHASE == 1
    node = static_cast<int>((a0.x ^ a0.y ^ a0.z ^ a0.w ^ a1.x ^ a1.y
                             ^ a1.z ^ a1.w) & 0x7fffffffu);
#pragma unroll
    for (int t = 0; t < R; ++t) node ^= dist[t];
#else
    long long off = 0;              // first node of the level
    for (int l = 1; ok && l <= L && l < GSLAM_VOCAB_PHASE; ++l) {
        off = off * k + 1;
        const long long child0 = off + static_cast<long long>(node) * k;
        int key = NO_KEY;
        if (l <= S) {               // the children are held rows
#pragma unroll
            for (int t = 0; t < R; ++t) {
                const long long c = 1 + lane + 32 * t - child0;
                if (c >= 0 && c < k)
                    key = min(key, (dist[t] << CHILD_BITS)
                                   | static_cast<int>(c));
            }
        } else {
            const uint4* rows = nodes + 2 * child0;
            for (int c = lane; c < k; c += 32)
                key = min(key, (hamming(a0, a1, __ldg(rows + 2 * c),
                                        __ldg(rows + 2 * c + 1))
                                << CHILD_BITS) | c);
        }
        node = node * k + (__reduce_min_sync(0xffffffffu, key)
                           & CHILD_MASK);
    }
#endif
    if (lane == 0) words[i] = ok ? node : -1;
#endif
}

}  // namespace

// nodes (n_nodes, 8) int32 words of a complete k-ary tree of depth L in
// level-major order (n_nodes = (k^(L+1) - 1) / (k - 1), checked by the
// caller), desc (N, 8) int32 words, both 16-byte aligned, valid (N,)
// bool bytes; output words (N,) int32, -1 where invalid.  Each warp
// reads levels 1..S whole first, S the most levels whose rows number at
// most TOP_ROWS.  Needs N >= 1, 2 <= k < 2^20, L >= 1.  Returns the CUDA
// error of the launch.
extern "C" int gslam_transform_words(const int32_t* nodes,
                                     const int32_t* desc,
                                     const uint8_t* valid, int N, int k,
                                     int L, int32_t* words, void* stream) {
    if (N < 1 || k < 2 || k >= (1 << CHILD_BITS) || L < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    int S = 0;
    long long rows = 0, width = 1;
    while (S < L) {
        width *= k;
        if (rows + width > TOP_ROWS) break;
        rows += width;
        ++S;
    }
    const uint4* n4 = reinterpret_cast<const uint4*>(nodes);
    const uint4* d4 = reinterpret_cast<const uint4*>(desc);
    const int top = static_cast<int>(rows), grid = (N + DPB - 1) / DPB;
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (top == 0)
        vocab_kernel<0><<<grid, THREADS, 0, s>>>(n4, d4, valid, N, k, L, S,
                                                 top, words);
    else if (top <= 32)
        vocab_kernel<1><<<grid, THREADS, 0, s>>>(n4, d4, valid, N, k, L, S,
                                                 top, words);
    else if (top <= 64)
        vocab_kernel<2><<<grid, THREADS, 0, s>>>(n4, d4, valid, N, k, L, S,
                                                 top, words);
    else
        vocab_kernel<4><<<grid, THREADS, 0, s>>>(n4, d4, valid, N, k, L, S,
                                                 top, words);
    return static_cast<int>(cudaGetLastError());
}
