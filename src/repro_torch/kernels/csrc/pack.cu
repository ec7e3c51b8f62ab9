// Fused threshold + sign + bit-plane pack (sm_90a): two kernels.
//
// 1. pack_rows_kernel replaces the TPU kernel repro/kernels/pack.py::
// pack_ternary_planes_segmented (body _kernel_rows).  For the flat
// [R, C] f32 buffer holding every leaf of a task vector (C % 32 == 0) and
// one threshold per row:
//
//     keep = |tau| >= thr[r]
//     pos word bit j = keep & (tau > 0),  neg word bit j = keep & (tau < 0)
//
// with 32 little-endian bits per word, words [R, C/32].
//
// What bounds it on the H100: bytes (4 bytes read per element, 1/4 byte
// written).  Design: each warp owns 32 consecutive words of one row.  For
// word i the 32 lanes read 32 consecutive floats (one coalesced 128-byte
// load) and __ballot_sync turns the lane predicates into the word, with
// lane j's predicate landing on bit j; lane i keeps word i, so the warp
// stores its 32 pos and 32 neg words with two coalesced writes.  Left on
// the table: wider (16-byte) loads per lane and more words in flight per
// warp.
//
// 2. pack_scalar_kernel replaces the TPU kernel repro/kernels/pack.py::
// pack_ternary_planes (body _kernel): one [M, N] tensor, one scalar
// threshold read from device memory (no host sync), any N.  Words are
// [M, ceil(N/32)] per row; in each row's last word the lanes past N
// read nothing and set no bit.  A leaf of any rank passes as its [1, n]
// view, which gives the flat C-order packing of a whole leaf.  Bounded
// by bytes like the first; the same one-ballot-per-word design, with
// the row stride N instead of C and 64-bit offsets (a leaf reaches 3e8
// elements).  -0.0 and 0.0 set no bit: the predicates are t > 0 and
// t < 0, never the sign bit.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;

__global__ void pack_rows_kernel(const float* __restrict__ tau,
                                 const float* __restrict__ thr,
                                 uint32_t* __restrict__ pos,
                                 uint32_t* __restrict__ neg, long long R,
                                 int C) {
  const int lane = threadIdx.x & 31;
  const long long gw =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const int words = C >> 5;
  const int per_row = (words + 31) >> 5;     // warps per row
  const long long r = gw / per_row;
  if (r >= R) return;                         // warp-uniform
  const int w0 = (int)(gw % per_row) * 32;
  const float t_r = thr[r];
  const float* row = tau + r * (long long)C;
  uint32_t my_pos = 0u, my_neg = 0u;
  for (int i = 0; i < 32 && w0 + i < words; ++i) {   // warp-uniform bound
    const float t = row[(long long)(w0 + i) * 32 + lane];
    const bool keep = fabsf(t) >= t_r;
    const uint32_t p = __ballot_sync(0xffffffffu, keep && t > 0.0f);
    const uint32_t q = __ballot_sync(0xffffffffu, keep && t < 0.0f);
    if (lane == i) {
      my_pos = p;
      my_neg = q;
    }
  }
  if (w0 + lane < words) {
    pos[r * words + w0 + lane] = my_pos;
    neg[r * words + w0 + lane] = my_neg;
  }
}

// tau [M, N] f32, any N; words [M, ceil(N/32)]
__global__ void pack_scalar_kernel(const float* __restrict__ tau,
                                   const float* __restrict__ thr,
                                   uint32_t* __restrict__ pos,
                                   uint32_t* __restrict__ neg, long long M,
                                   long long N) {
  const int lane = threadIdx.x & 31;
  const long long gw =
      (long long)blockIdx.x * (kThreads / 32) + (threadIdx.x >> 5);
  const long long words = (N + 31) >> 5;
  const long long per_row = (words + 31) >> 5;   // warps per row
  const long long r = gw / per_row;
  if (r >= M) return;                             // warp-uniform
  const long long w0 = (gw % per_row) * 32;
  const float t_r = thr[0];
  const float* row = tau + r * N;
  uint32_t my_pos = 0u, my_neg = 0u;
  for (int i = 0; i < 32 && w0 + i < words; ++i) {   // warp-uniform bound
    const long long col = (w0 + i) * 32 + lane;
    const float t = col < N ? row[col] : 0.0f;         // ragged tail: no bit
    const bool keep = fabsf(t) >= t_r;
    const uint32_t p = __ballot_sync(0xffffffffu, keep && t > 0.0f);
    const uint32_t q = __ballot_sync(0xffffffffu, keep && t < 0.0f);
    if (lane == i) {
      my_pos = p;
      my_neg = q;
    }
  }
  if (w0 + lane < words) {
    pos[r * words + w0 + lane] = my_pos;
    neg[r * words + w0 + lane] = my_neg;
  }
}

}  // namespace

extern "C" int pack_ternary_planes(const float* tau, const float* thr,
                                   uint32_t* pos, uint32_t* neg, long long M,
                                   long long N, void* stream) {
  if (M == 0 || N == 0) return 0;
  const long long per_row = (((N + 31) >> 5) + 31) >> 5;
  const long long warps = M * per_row;
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  pack_scalar_kernel<<<(unsigned)blocks, kThreads, 0,
                       static_cast<cudaStream_t>(stream)>>>(tau, thr, pos,
                                                            neg, M, N);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int pack_ternary_planes_segmented(const float* tau,
                                             const float* thr, uint32_t* pos,
                                             uint32_t* neg, long long R,
                                             int C, void* stream) {
  if (R == 0 || C == 0) return 0;
  const long long per_row = ((C >> 5) + 31) >> 5;
  const long long warps = R * per_row;
  const long long blocks = (warps + kThreads / 32 - 1) / (kThreads / 32);
  pack_rows_kernel<<<(unsigned)blocks, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(tau, thr, pos, neg,
                                                          R, C);
  return static_cast<int>(cudaGetLastError());
}
