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
// k + best.  It reads k * L nodes per descriptor and has no table cap.
//
// Bound at the loop-closure shape (N = 384 descriptors, k = 6, L = 2, 43
// nodes): N * 32 B of descriptors + 43 * 32 B of nodes + N * 5 B of
// validity and words = 15.6 kB (0.005 us at 3.35 TB/s) against N * k * L
// * 8 xor-popcounts = 37 k operations: bytes bound on paper, launch
// bound in practice.  At k = 8, L = 4 (4681 nodes, 150 kB) the table is
// read through L2.
//
// Design: one warp owns one descriptor, whose 8 words sit in registers
// in every lane.  The children of the current node go across the lanes
// (lane, lane + 32, ... for k > 32); each lane keeps the least key
// (distance << 20 | child) of its children, scanned in increasing order,
// and five shuffle steps take the warp's minimum.  The key orders
// (distance, child) lexicographically, so ties go to the lowest child,
// as argmin breaks them: the words equal the plain version's exactly.
// Level l + 1 starts at node (k^(l+1) - 1) / (k - 1) of the level-major
// table; the offset is accumulated as off = off * k + 1.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WORDS = 8;
constexpr int WARPS = 8;            // descriptors per block
constexpr int CHILD_BITS = 20;      // k < 2^20
constexpr int NO_KEY = 0x7fffffff;

__global__ void __launch_bounds__(WARPS * 32)
vocab_kernel(const int32_t* __restrict__ nodes,
             const int32_t* __restrict__ desc,
             const uint8_t* __restrict__ valid, int N, int k, int L,
             int32_t* __restrict__ words) {
    const int lane = threadIdx.x & 31;
    const int i = blockIdx.x * WARPS + (threadIdx.x >> 5);
    if (i >= N) return;             // whole warps leave together
    uint32_t a[WORDS];
#pragma unroll
    for (int w = 0; w < WORDS; ++w)
        a[w] = static_cast<uint32_t>(desc[(size_t)i * WORDS + w]);

    int node = 0;                   // position within the level
    int off = 0;                    // first node of the level
    for (int l = 0; l < L; ++l) {
        off = off * k + 1;
        const size_t base = (size_t)off + (size_t)node * k;
        int key = NO_KEY;
        for (int c = lane; c < k; c += 32) {
            const int32_t* row = nodes + (base + c) * WORDS;
            int d = 0;
#pragma unroll
            for (int w = 0; w < WORDS; ++w)
                d += __popc(a[w] ^ static_cast<uint32_t>(__ldg(row + w)));
            key = min(key, (d << CHILD_BITS) | c);
        }
#pragma unroll
        for (int s = 16; s > 0; s >>= 1)
            key = min(key, __shfl_xor_sync(0xffffffffu, key, s));
        node = node * k + (key & ((1 << CHILD_BITS) - 1));
    }
    if (lane == 0) words[i] = valid[i] ? node : -1;
}

}  // namespace

// nodes (n_nodes, 8) int32 words of a complete k-ary tree of depth L in
// level-major order (n_nodes = (k^(L+1) - 1) / (k - 1), checked by the
// caller), desc (N, 8) int32 words, valid (N,) bool bytes; output words
// (N,) int32, -1 where invalid.  Needs N >= 1, 2 <= k < 2^20, L >= 1.
// Returns the CUDA error of the launch.
extern "C" int gslam_transform_words(const int32_t* nodes,
                                     const int32_t* desc,
                                     const uint8_t* valid, int N, int k,
                                     int L, int32_t* words, void* stream) {
    if (N < 1 || k < 2 || k >= (1 << CHILD_BITS) || L < 1)
        return static_cast<int>(cudaErrorInvalidValue);
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    vocab_kernel<<<(N + WARPS - 1) / WARPS, WARPS * 32, 0, s>>>(
        nodes, desc, valid, N, k, L, words);
    return static_cast<int>(cudaGetLastError());
}
