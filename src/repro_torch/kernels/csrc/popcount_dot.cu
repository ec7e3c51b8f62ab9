// Integer ternary dot product by AND + POPCNT (sm_90a).
//
// Replaces the TPU kernel repro/kernels/popcount_dot.py::popcount_dot
// (body _kernel).  For two ternary vectors held as flat bit planes of W
// 32-bit words,
//
//     dot = popc(a+ & b+) + popc(a- & b-) - popc(a+ & b-) - popc(a- & b+)
//
// as one int32 (scales are applied by the caller).
//
// What bounds it on the H100: bytes (16 bytes read per word position, four
// POPCs and a few integer ops on them).  Design: a grid-stride loop with
// 16-byte loads (four words of each array per step) when all four arrays
// are 16-byte aligned, scalar loads otherwise and for the tail; each
// thread keeps an int sum, a warp-shuffle and a shared-memory step reduce
// a block to one int, and one integer atomicAdd per block adds it to the
// output, which the wrapper zeroes.  Integer sums do not depend on their
// order, so the result is bitwise deterministic.  The TPU kernel emitted
// one partial per grid step and summed them outside.  Left on the table:
// nothing much beyond the load width; the grid is sized to a few blocks
// per SM so that the atomics are few.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ int term(uint32_t ap, uint32_t an, uint32_t bp,
                                    uint32_t bn) {
  return __popc(ap & bp) + __popc(an & bn) - __popc(ap & bn) -
         __popc(an & bp);
}

__global__ void popcount_dot_kernel(const uint32_t* __restrict__ ap,
                                    const uint32_t* __restrict__ an,
                                    const uint32_t* __restrict__ bp,
                                    const uint32_t* __restrict__ bn,
                                    long long W, long long quads,
                                    int* __restrict__ out) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  int acc = 0;
  const uint4* ap4 = reinterpret_cast<const uint4*>(ap);
  const uint4* an4 = reinterpret_cast<const uint4*>(an);
  const uint4* bp4 = reinterpret_cast<const uint4*>(bp);
  const uint4* bn4 = reinterpret_cast<const uint4*>(bn);
  for (long long i = tid; i < quads; i += stride) {
    const uint4 a = __ldg(ap4 + i), c = __ldg(an4 + i);
    const uint4 b = __ldg(bp4 + i), d = __ldg(bn4 + i);
    acc += term(a.x, c.x, b.x, d.x) + term(a.y, c.y, b.y, d.y) +
           term(a.z, c.z, b.z, d.z) + term(a.w, c.w, b.w, d.w);
  }
  for (long long i = quads * 4 + tid; i < W; i += stride) {
    acc += term(__ldg(ap + i), __ldg(an + i), __ldg(bp + i), __ldg(bn + i));
  }
  for (int o = 16; o > 0; o >>= 1) acc += __shfl_down_sync(0xffffffffu, acc, o);
  __shared__ int warp_sums[kThreads / 32];
  if ((threadIdx.x & 31) == 0) warp_sums[threadIdx.x >> 5] = acc;
  __syncthreads();
  if (threadIdx.x < 32) {
    int v = threadIdx.x < kThreads / 32 ? warp_sums[threadIdx.x] : 0;
    for (int o = 16; o > 0; o >>= 1) v += __shfl_down_sync(0xffffffffu, v, o);
    if (threadIdx.x == 0) atomicAdd(out, v);
  }
}

}  // namespace

// out: one int, zeroed by the caller
extern "C" int popcount_dot(const uint32_t* ap, const uint32_t* an,
                            const uint32_t* bp, const uint32_t* bn,
                            long long W, int* out, void* stream) {
  if (W == 0) return 0;
  const uintptr_t any = reinterpret_cast<uintptr_t>(ap) |
                        reinterpret_cast<uintptr_t>(an) |
                        reinterpret_cast<uintptr_t>(bp) |
                        reinterpret_cast<uintptr_t>(bn);
  const long long quads = (any % 16 == 0) ? W / 4 : 0;
  const long long work = quads > 0 ? quads : W;
  long long blocks = (work + kThreads - 1) / kThreads;
  if (blocks > 132 * 8) blocks = 132 * 8;       // a few blocks per SM
  popcount_dot_kernel<<<(unsigned)blocks, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(ap, an, bp, bn,
                                                             W, quads, out);
  return static_cast<int>(cudaGetLastError());
}
