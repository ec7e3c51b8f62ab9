// Gumbel-max sampling on JAX's threefry stream (sm_90a).
//
// Replaces the reference's sampled token selection,
// repro/serve/decode_loop.py::select_tokens after its temperature and
// top-k steps: jax.random.categorical under fold_in(keys[row], gen[row]),
// which is argmax(scaled + gumbel) with gumbel = -log(-log(u)) and u made
// from threefry-2x32 bits (JAX's partitionable layout: counter v is the
// word pair (0, v), the bits are the xor of the two output words).  The
// reference computes it in jnp and jax.random, not in Pallas.  For a
// [B, V] f32 input of scaled, masked logits, per row:
//
//     (s0, s1) = threefry(keys[row], (0, gen[row]))          // fold_in
//     bits[v]  = xor of threefry((s0, s1), (0, v))
//     u[v]     = max(tiny, ((bits >> 9 | 0x3F800000) as f32 - 1) * 1 + tiny)
//     out[row] = first argmax over v of x[v] + -logf(-logf(u[v]))
//
// Every step is the arithmetic of repro_torch/serve/sampling.py (the plain
// version) in the same order, so noise and tokens are bitwise equal to it
// on the card (logf is the accurate one: no fast math; built with
// -fmad=false like every source here).  -inf + noise stays -inf; a row of
// all -inf gives index 0, as argmax does.  NaN inputs are never picked.
//
// What bounds it on the H100: operations.  About 75 32-bit integer ops
// per element for threefry (20 rounds of add, rotate, xor and five key
// injections), a few more for u, and two logf, against 4 bytes read.
//
// Design (simple and right first): a row is cut into `chunks` contiguous
// spans, one block of 256 threads each (grid chunks x B), so a decode
// batch of a few rows still fills the card.  Thread 0 folds the step key
// into shared memory; each thread strides over its span keeping the first
// (value, index) maximum; a warp-shuffle and shared-memory reduction keeps
// the larger value and, on ties, the lower index.  A second kernel, one
// warp per row, reduces the spans' partials in the same way.  The result
// is the first maximum whatever the span count, so the geometry cannot
// change a token.  Optionally the noise itself is written out (for the
// checks against the plain version).  Left on the table: nothing overlaps
// the two launches, and a span's threefry of its step key is serial.

#include <cfloat>
#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kThreads = 256;
constexpr float kTiny = FLT_MIN;     // finfo(float32).tiny

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32, 20 rounds: jax/_src/prng.py::_threefry2x32_lowering
__device__ __forceinline__ void threefry(uint32_t k0, uint32_t k1,
                                         uint32_t& x0, uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r) ^ x0;
  x0 += k0;
  x1 += k1;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1;
  x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2;
  x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0;
  x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1;
  x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2;
  x1 += k0 + 5u;
#undef TF_ROUND
}

__device__ __forceinline__ float gumbel_of(uint32_t s0, uint32_t s1,
                                           uint32_t v) {
  uint32_t b0 = 0u, b1 = v;
  threefry(s0, s1, b0, b1);
  const uint32_t bits = b0 ^ b1;
  const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
  const float u = fmaxf(kTiny, f * (1.0f - kTiny) + kTiny);
  return -logf(-logf(u));
}

// keep (v, i) if it beats (bv, bi): larger value, then lower index
__device__ __forceinline__ void keep_best(float v, int i, float& bv,
                                          int& bi) {
  if (v > bv || (v == bv && i < bi)) {
    bv = v;
    bi = i;
  }
}

__device__ __forceinline__ void warp_best(float& bv, int& bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, bv, o);
    const int i = __shfl_down_sync(0xffffffffu, bi, o);
    keep_best(v, i, bv, bi);
  }
}

__global__ void sample_spans_kernel(const float* __restrict__ x,
                                    long long V, long long span,
                                    const long long* __restrict__ keys,
                                    const long long* __restrict__ gen,
                                    float* __restrict__ part_val,
                                    int* __restrict__ part_idx,
                                    float* __restrict__ noise) {
  const int row = blockIdx.y;
  __shared__ uint32_t step_key[2];
  __shared__ float warp_val[kThreads / 32];
  __shared__ int warp_idx[kThreads / 32];
  if (threadIdx.x == 0) {
    uint32_t s0 = 0u, s1 = static_cast<uint32_t>(gen[row]);
    threefry(static_cast<uint32_t>(keys[2 * row]),
             static_cast<uint32_t>(keys[2 * row + 1]), s0, s1);
    step_key[0] = s0;
    step_key[1] = s1;
  }
  __syncthreads();
  const uint32_t s0 = step_key[0], s1 = step_key[1];
  const long long lo = static_cast<long long>(blockIdx.x) * span;
  const long long hi = lo + span < V ? lo + span : V;
  const float* xr = x + static_cast<long long>(row) * V;
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (long long v = lo + threadIdx.x; v < hi; v += kThreads) {
    const float g = gumbel_of(s0, s1, static_cast<uint32_t>(v));
    if (noise != nullptr) noise[static_cast<long long>(row) * V + v] = g;
    keep_best(xr[v] + g, static_cast<int>(v), bv, bi);
  }
  warp_best(bv, bi);
  if ((threadIdx.x & 31) == 0) {
    warp_val[threadIdx.x >> 5] = bv;
    warp_idx[threadIdx.x >> 5] = bi;
  }
  __syncthreads();
  if (threadIdx.x < 32) {
    bv = threadIdx.x < kThreads / 32 ? warp_val[threadIdx.x] : -CUDART_INF_F;
    bi = threadIdx.x < kThreads / 32 ? warp_idx[threadIdx.x] : INT_MAX;
    warp_best(bv, bi);
    if (threadIdx.x == 0) {
      part_val[row * gridDim.x + blockIdx.x] = bv;
      part_idx[row * gridDim.x + blockIdx.x] = bi;
    }
  }
}

__global__ void sample_finish_kernel(const float* __restrict__ part_val,
                                     const int* __restrict__ part_idx,
                                     int chunks, int* __restrict__ out) {
  const int row = blockIdx.x;
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (int c = threadIdx.x; c < chunks; c += 32) {
    keep_best(part_val[row * chunks + c], part_idx[row * chunks + c], bv,
              bi);
  }
  warp_best(bv, bi);
  if (threadIdx.x == 0) out[row] = bi;
}

}  // namespace

// x [B, V] f32, keys [B, 2] and gen [B] int64 (the low 32 bits are the
// words), all contiguous; part_val/part_idx scratch [B, chunks]; out [B]
// int32; noise [B, V] f32 or null.
extern "C" int sample_gumbel_argmax(const float* x, const long long* keys,
                                    const long long* gen, int B, long long V,
                                    int chunks, float* part_val,
                                    int* part_idx, int* out, float* noise,
                                    void* stream) {
  if (B == 0) return 0;
  const long long span = (V + chunks - 1) / chunks;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  sample_spans_kernel<<<dim3(chunks, B), kThreads, 0, s>>>(
      x, V, span, keys, gen, part_val, part_idx, noise);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  sample_finish_kernel<<<B, 32, 0, s>>>(part_val, part_idx, chunks, out);
  return static_cast<int>(cudaGetLastError());
}
