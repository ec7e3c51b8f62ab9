// Fused ternary decompress + add (expert merge) for Hopper (sm_90a).
//
// Replaces the TPU kernels repro/kernels/unpack_add.py::unpack_add (body
// _kernel) and ::unpack_add_many (body _kernel_many).  For a base [M, N]
// in f32 or bf16 and E experts' bit planes of 32-bit words [E, M,
// ceil(N/32)] (bit j of word w of row r is element 32 w + j):
//
//     out = base
//     for e in 0..E-1:  out = to_dtype(f32(out) + s_e * (pos_e - neg_e))
//
// rounded through the base dtype after every expert, in expert order, so
// the fused form is bitwise a loop of the single-expert form.  The delta
// is computed as a float even where both bits are 0 (so -0.0 + 0.0 gives
// +0.0, as the reference does) and is 0 where both are set.  Bits at or
// beyond N are never applied and nothing beyond N is written.  Scales
// (ensemble weights included) arrive ready-made in f32.  One entry point,
// unpack_add_many; the single-expert wrapper launches it with E = 1.
//
// What bounds it on the H100: bytes, 2 * sizeof(base) + E / 4 per element
// (base read once, out written once, two bits per expert); the arithmetic
// is a few f32 operations per element and expert.
//
// Design (simple and right first): a grid-stride loop over chunks of 16
// bytes of the base (4 f32 or 8 bf16 elements).  A chunk never straddles
// a plane word, so each thread reads one word per plane and expert and
// neighbouring threads read neighbouring chunks: base loads and stores are
// 16-byte vectors, coalesced, where the row width and the pointers allow
// it, and element by element otherwise.  Expert, row and word strides of
// the planes are arguments, so stacked or strided planes need no copy.
// Left on the table: the 4 or 8 threads that share a word each load it,
// and the wrapper stacks per-expert planes into one buffer before a
// launch with E > 1.

#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename T>
__device__ __forceinline__ T from_f32(float v);
template <>
__device__ __forceinline__ float from_f32<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

template <typename T, bool kVector>
__global__ void unpack_add_kernel(const T* __restrict__ base,
                                  const uint32_t* __restrict__ pos,
                                  const uint32_t* __restrict__ neg,
                                  const float* __restrict__ scales,
                                  T* __restrict__ out, int E, long long M,
                                  long long N, long long es, long long rs,
                                  long long ws) {
  constexpr int V = 16 / sizeof(T);  // elements per chunk; divides 32
  const long long per_row = (N + V - 1) / V;
  const long long total = M * per_row;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long c = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       c < total; c += step) {
    const long long r = c / per_row;
    const long long col0 = (c - r * per_row) * V;
    const long long i0 = r * N + col0;
    const int n = (int)(N - col0 < V ? N - col0 : V);
    float acc[V];
    if (kVector) {  // N % V == 0 and 16-byte aligned pointers: n == V
      const uint4 raw = *reinterpret_cast<const uint4*>(base + i0);
      const T* v = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = to_f32(v[j]);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) acc[j] = j < n ? to_f32(base[i0 + j]) : 0.0f;
    }
    const long long woff = r * rs + (col0 >> 5) * ws;
    const int shift = (int)(col0 & 31);
    for (int e = 0; e < E; ++e) {
      const uint32_t p = pos[e * es + woff] >> shift;
      const uint32_t q = neg[e * es + woff] >> shift;
      const float s = scales[e];
#pragma unroll
      for (int j = 0; j < V; ++j) {
        const float d = (float)((p >> j) & 1u) - (float)((q >> j) & 1u);
        acc[j] = to_f32(from_f32<T>(acc[j] + s * d));
      }
    }
    if (kVector) {
      uint4 raw;
      T* v = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < V; ++j) v[j] = from_f32<T>(acc[j]);
      *reinterpret_cast<uint4*>(out + i0) = raw;
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j)
        if (j < n) out[i0 + j] = from_f32<T>(acc[j]);
    }
  }
}

template <typename T>
int launch(const void* base, const uint32_t* pos, const uint32_t* neg,
           const float* scales, void* out, int E, long long M, long long N,
           long long es, long long rs, long long ws, cudaStream_t stream) {
  constexpr int V = 16 / sizeof(T);
  const long long chunks = M * ((N + V - 1) / V);
  int dev = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  long long blocks = (chunks + kThreads - 1) / kThreads;
  const long long cap = (long long)sms * 16;
  if (blocks > cap) blocks = cap;
  const bool vec = N % V == 0 &&
                   ((reinterpret_cast<uintptr_t>(base) |
                     reinterpret_cast<uintptr_t>(out)) & 15u) == 0;
  const T* b = static_cast<const T*>(base);
  T* o = static_cast<T*>(out);
  if (vec)
    unpack_add_kernel<T, true><<<(unsigned)blocks, kThreads, 0, stream>>>(
        b, pos, neg, scales, o, E, M, N, es, rs, ws);
  else
    unpack_add_kernel<T, false><<<(unsigned)blocks, kThreads, 0, stream>>>(
        b, pos, neg, scales, o, E, M, N, es, rs, ws);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16.  Strides are in words.
extern "C" int unpack_add_many(const void* base, const uint32_t* pos,
                               const uint32_t* neg, const float* scales,
                               void* out, int E, long long M, long long N,
                               long long es, long long rs, long long ws,
                               int dtype, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(base, pos, neg, scales, out, E, M, N, es, rs, ws, s);
  if (dtype == 1)
    return launch<__nv_bfloat16>(base, pos, neg, scales, out, E, M, N, es,
                                 rs, ws, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
