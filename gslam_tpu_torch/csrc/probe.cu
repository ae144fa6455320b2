// Measurement probes, not ported kernels: an empty kernel, whose time in
// a CUDA graph is the floor under every launch, and two integer loops
// that measure the card's rate for the Hamming inner step (xor, popc,
// add) and for plain integer operations (xor, add), per clock and SM.
// The matchers' and the tree descent's operation bounds are stated
// against these rates.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int CHAINS = 8;       // independent chains per thread

__global__ void empty_kernel() {}

// Each thread runs CHAINS independent chains of `iters` steps.  A step
// is x ^= acc; acc += popc(x) (kPopc) or x ^= acc; acc += x.
template <bool kPopc>
__global__ void __launch_bounds__(256)
int_loop(uint32_t* __restrict__ out, int iters) {
    uint32_t x[CHAINS], acc[CHAINS];
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) {
        x[k] = (blockIdx.x * blockDim.x + threadIdx.x) * 2654435761u + k;
        acc[k] = k;
    }
    for (int i = 0; i < iters; ++i) {
#pragma unroll
        for (int k = 0; k < CHAINS; ++k) {
            x[k] ^= acc[k];
            acc[k] += kPopc ? __popc(x[k]) : x[k];
        }
    }
    uint32_t s = 0;
#pragma unroll
    for (int k = 0; k < CHAINS; ++k) s += acc[k] ^ x[k];
    if (s == 0x12345678u) out[0] = s;     // keeps the loop alive
}

}  // namespace

extern "C" int gslam_probe_empty(void* stream) {
    empty_kernel<<<1, 32, 0, static_cast<cudaStream_t>(stream)>>>();
    return static_cast<int>(cudaGetLastError());
}

// Launches `blocks` blocks of 256 threads; the steps run in all are
// blocks * 256 * 8 * iters.  popc != 0: the Hamming step.
extern "C" int gslam_probe_int_loop(uint32_t* out, int blocks, int iters,
                                    int popc, void* stream) {
    cudaStream_t s = static_cast<cudaStream_t>(stream);
    if (popc)
        int_loop<true><<<blocks, 256, 0, s>>>(out, iters);
    else
        int_loop<false><<<blocks, 256, 0, s>>>(out, iters);
    return static_cast<int>(cudaGetLastError());
}
