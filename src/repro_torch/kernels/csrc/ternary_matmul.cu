// Dense x packed-ternary matmul for Hopper (sm_90a): the grouped form
// and the single-expert form.
//
// Replaces the TPU kernel repro/kernels/ternary_matmul.py::
// ternary_matmul_grouped (body _kernel_grouped).  Per row m with expert
// e = eid[m]:
//
//     y[m, n] = scales[e] * sum_k x[m, k] * T_e[k, n]      (e >= 0)
//     y[m, n] = 0                                           (e == -1)
//
// T_e is ternary, held as two bit planes of 32-bit words.  Normal form:
// planes [E, K, N/32] packed along n.  transpose_rhs form: planes
// [E, N, ceil(K/32)] packed along k (the embedding table reused as the
// tied LM head), computing x @ T_e^t.
//
// What bounds it on the H100: bytes.  Each row reads only its own
// expert's planes (2 bits per weight) once per distinct expert in the
// batch; the arithmetic is one add or subtract per nonzero weight per row,
// far below the card's f32 rate at decode batch sizes.
//
// Design (simple and right first): one thread computes one output element
// over k in a fixed order, unpacking its expert's bits from the word it
// loads, and scales last.  The summation order therefore depends on
// nothing but K: no split-K, no tiling by M, and the rows of other experts
// never enter a row's sum, so every row is bitwise what it would be if it
// were launched alone.  The TPU kernel instead ran E row-masked matmuls
// per tile.  Left on the table: tensor cores (wgmma on a +-1 tile unpacked
// into shared memory), reuse of a plane word across the rows that share an
// expert, TMA loads, and coalesced plane reads in the transposed form.
//
// single_kernel replaces the TPU kernel repro/kernels/ternary_matmul.py::
// ternary_matmul (body _kernel): one expert, planes [K, N/32],
//
//     y[m, n] = scale * sum_k x[m, k] * T[k, n].
//
// It is its own kernel, not the grouped one launched with E = 1, and it
// sums in the grouped kernel's order (acc = 0, k ascending, every term
// added with __fadd_rn, the zero terms too, the scale last with
// __fmul_rn).  So a row of a grouped launch equals ternary_matmul of that
// row on its expert bitwise: the reference's contract of
// tests/test_kernels.py::test_grouped_matmul_bit_identical_to_single,
// held on the card between two independent kernels.  Bounded by bytes
// (the planes, 2 bits per weight, read once); at decode sizes (M = 4) a
// few dozen blocks each walk K sequentially, so it runs at the latency of
// that loop, far from the bound.  Left on the table: split-K over a warp
// with a fixed-order reduction, and reading each plane word once for all
// rows.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;   // outputs per block along n
constexpr int kChunk = 256;     // x values staged in shared memory per step

__device__ __forceinline__ float ternary_term(uint32_t p, uint32_t q, int b,
                                              float v) {
  return ((p >> b) & 1u) ? v : (((q >> b) & 1u) ? -v : 0.0f);
}

// planes [E, K, W] with W = N / 32 words per k row
__global__ void grouped_kernel(const float* __restrict__ x,
                               const uint32_t* __restrict__ pos,
                               const uint32_t* __restrict__ neg,
                               const float* __restrict__ scales,
                               const int* __restrict__ eid,
                               float* __restrict__ out, int K, int N, int W,
                               long long e_stride) {
  const int m = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int e = eid[m];
  __shared__ float xs[kChunk];
  if (e < 0) {                       // block-uniform: no barrier is skipped
    if (n < N) out[(long long)m * N + n] = 0.0f;
    return;
  }
  const uint32_t* P = pos + e * e_stride;
  const uint32_t* Q = neg + e * e_stride;
  const int w = n >> 5;
  const int b = n & 31;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    __syncthreads();
    if (threadIdx.x < kn) xs[threadIdx.x] = x[(long long)m * K + k0 + threadIdx.x];
    __syncthreads();
    if (n < N) {
      const uint32_t* Pk = P + (long long)k0 * W + w;
      const uint32_t* Qk = Q + (long long)k0 * W + w;
      for (int kk = 0; kk < kn; ++kk) {
        acc = __fadd_rn(acc, ternary_term(__ldg(Pk + (long long)kk * W),
                                          __ldg(Qk + (long long)kk * W), b,
                                          xs[kk]));
      }
    }
  }
  if (n < N) out[(long long)m * N + n] = __fmul_rn(acc, scales[e]);
}

// planes [E, N, W] with W = ceil(K / 32) words per output row n
__global__ void grouped_t_kernel(const float* __restrict__ x,
                                 const uint32_t* __restrict__ pos,
                                 const uint32_t* __restrict__ neg,
                                 const float* __restrict__ scales,
                                 const int* __restrict__ eid,
                                 float* __restrict__ out, int K, int N,
                                 int W, long long e_stride) {
  const int m = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  const int e = eid[m];
  __shared__ float xs[kChunk];
  if (e < 0) {
    if (n < N) out[(long long)m * N + n] = 0.0f;
    return;
  }
  const uint32_t* P = pos + e * e_stride + (long long)n * W;
  const uint32_t* Q = neg + e * e_stride + (long long)n * W;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    __syncthreads();
    if (threadIdx.x < kn) xs[threadIdx.x] = x[(long long)m * K + k0 + threadIdx.x];
    __syncthreads();
    if (n < N) {
      for (int wk = 0; wk * 32 < kn; ++wk) {
        const uint32_t p = __ldg(P + (k0 >> 5) + wk);
        const uint32_t q = __ldg(Q + (k0 >> 5) + wk);
        const int bn = min(32, kn - wk * 32);
        for (int b = 0; b < bn; ++b) {
          acc = __fadd_rn(acc, ternary_term(p, q, b, xs[wk * 32 + b]));
        }
      }
    }
  }
  if (n < N) out[(long long)m * N + n] = __fmul_rn(acc, scales[e]);
}

// planes [K, W] of one expert, N = 32 W
__global__ void single_kernel(const float* __restrict__ x,
                              const uint32_t* __restrict__ pos,
                              const uint32_t* __restrict__ neg,
                              const float* __restrict__ scale,
                              float* __restrict__ out, int K, int N, int W) {
  const int m = blockIdx.x;
  const int n = blockIdx.y * kThreads + threadIdx.x;
  __shared__ float xs[kChunk];
  const int w = n >> 5;
  const int b = n & 31;
  float acc = 0.0f;
  for (int k0 = 0; k0 < K; k0 += kChunk) {
    const int kn = min(kChunk, K - k0);
    __syncthreads();
    if (threadIdx.x < kn) xs[threadIdx.x] = x[(long long)m * K + k0 + threadIdx.x];
    __syncthreads();
    if (n < N) {
      const uint32_t* Pk = pos + (long long)k0 * W + w;
      const uint32_t* Qk = neg + (long long)k0 * W + w;
      for (int kk = 0; kk < kn; ++kk) {
        acc = __fadd_rn(acc, ternary_term(__ldg(Pk + (long long)kk * W),
                                          __ldg(Qk + (long long)kk * W), b,
                                          xs[kk]));
      }
    }
  }
  if (n < N) out[(long long)m * N + n] = __fmul_rn(acc, scale[0]);
}

}  // namespace

extern "C" int ternary_matmul(const float* x, const uint32_t* pos,
                              const uint32_t* neg, const float* scale,
                              float* out, int M, int K, int N, int W,
                              void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid(M, (N + kThreads - 1) / kThreads);
  single_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      x, pos, neg, scale, out, K, N, W);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int ternary_matmul_grouped(const float* x, const uint32_t* pos,
                                      const uint32_t* neg,
                                      const float* scales, const int* eid,
                                      float* out, int M, int K, int N, int W,
                                      long long e_stride, int transpose_rhs,
                                      void* stream) {
  if (M == 0 || N == 0) return 0;
  dim3 grid(M, (N + kThreads - 1) / kThreads);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transpose_rhs) {
    grouped_t_kernel<<<grid, kThreads, 0, s>>>(x, pos, neg, scales, eid, out,
                                               K, N, W, e_stride);
  } else {
    grouped_kernel<<<grid, kThreads, 0, s>>>(x, pos, neg, scales, eid, out, K,
                                             N, W, e_stride);
  }
  return static_cast<int>(cudaGetLastError());
}
