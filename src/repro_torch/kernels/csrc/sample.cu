// Sampled token selection on JAX's threefry stream, fused (sm_90a).
//
// Replaces the reference's sampled branch of
// repro/serve/decode_loop.py::select_tokens whole (the reference computes
// it in jnp, lax.top_k and jax.random, not in Pallas).  For logits [B, V]
// in f32 or bf16, temperature T (an f32 value) and top_k = k, per row:
//
//     x[v]     = f32(logits[row, v]) / T               // IEEE division
//     t        = k-th largest x[v], counted with multiplicity
//                (-inf, so nothing is cut, when k = 0 or k >= V)
//     keep[v]  = !(x[v] < t)                            // every tie stays
//     (s0, s1) = threefry(keys[row], (0, gen[row]))     // fold_in
//     bits[v]  = xor of threefry((s0, s1), (0, v))
//     u[v]     = max(tiny, ((bits >> 9 | 0x3F800000) as f32 - 1) * 1 + tiny)
//     g[v]     = -logf(-logf(u[v]))
//     out[row] = first argmax over v of (keep[v] ? x[v] + g[v] : -inf)
//
// which is, step for step, the plain version in kernels/sample.py (the
// division by a tensor, torch.topk's k-th value, torch.where, then
// serve/sampling.py and torch.argmax), so tokens, and the noise when it is
// asked for, are bitwise equal to it on the card: logf is the accurate one
// (no fast math), every source here is built with -fmad=false, and a
// (value, index) pair beats another by a larger value, then a lower index,
// so no partition of a row can change a token.  A masked entry would
// compete as -inf + g = -inf (g lies in [-4.47, 15.9]), so its noise is
// never computed unless the noise is written out; a row whose every value
// is -inf gives index 0, as argmax does.  NaN inputs are never picked.
//
// What bounds it on the H100.  Without a cut (k = 0 or k >= V) every
// element pays threefry (about 75 integer operations) and two logf: the
// integer lanes bound it.  With a cut only about k survivors pay that; the
// rest is the read of the logits (2 or 4 bytes each), the division and a
// few integer operations per element (the first digit pass and the
// candidate test; the later passes run over the candidates only).  In
// practice the latency of each step that a row's CTAs must agree on sets
// the time, and a cluster barrier that orders distributed shared memory
// (release / acquire) is the slowest of them, so the fast path avoids it.
//
// Design.  Two kernels, one launch per call:
//
// - sample_select_kernel (0 < k < V): one thread-block cluster of 8 CTAs
//   (1024 threads each) per row.  Each CTA loads its slice of the row once
//   (16-byte loads), widened and divided, into shared memory, and counts
//   its keys (the floats mapped to order-preserving uint32s) by their top
//   11 bits.  The k-th largest key is found by radix select over digits of
//   11, 11 and 10 bits: #(x > t) < k <= #(x >= t), torch.topk's k-th value
//   counted with multiplicity; the cost does not depend on k.  -0.0 takes
//   the key of +0.0, so a key compares as its float does, and every value
//   equal to t survives whatever the sign of a zero at the boundary.
//   Fast path (k < 2048): no cluster-wide fence.  Each CTA sends rank 0
//   its top-digit counts with st.async (asynchronous stores into rank 0's
//   shared memory that complete on rank 0's mbarrier, which counts the
//   bytes it expects); rank 0 sums them, finds the top digit d of the k-th
//   largest, and tells each CTA d and where its candidates (keys whose top
//   digit is >= d: every survivor, and fewer than k plus d's own count) go
//   in rank 0's table.  The CTAs send their candidates (value, index) the
//   same way and are done; rank 0 finds the last two digits among them,
//   draws noise for the survivors only (x >= t) and writes the token.
//   Distributed path (a larger k, more than 2048 candidates as with massive
//   ties, or a slice too long for shared memory, read again at each pass
//   instead): each digit pass adds every CTA's histogram into every rank's
//   copy over distributed shared memory behind a cluster barrier; then
//   each CTA draws its survivors and rank 0 reduces the CTAs' maxima.
//   No scratch in global memory.  Each CTA's warp 0 folds the step key
//   while the slice loads.
// - sample_spans_kernel (no cut): every element needs noise, so the
//   geometry fills the card: the row is cut into spans, one block each
//   (about two blocks per SM over the batch), two elements a thread in
//   flight; each block keeps its first maximum, writes it to a partial,
//   and the last block of the row to finish (a ticket counter in the
//   caller's scratch, zeroed by a memset before the launch) reduces the
//   partials and writes the token.  Warp 0 folds the step key while every
//   thread's first loads are in flight.  Every launch has its own scratch,
//   so launches on concurrent streams cannot mix their tickets.

#include <cfloat>
#include <climits>
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kSpanThreads = 256;    // no-cut kernel, about 2 blocks per SM
constexpr int kSelThreads = 1024;    // cut kernel, one CTA per SM
constexpr int kPasses = 3;           // radix digits of 11, 11 and 10 bits
constexpr int kBins = 2048;
static_assert(kBins == 2 * kSelThreads, "the search gives 2 digits a thread");
static_assert(kSelThreads == 32 * 32, "the search scans 32 warp sums");
constexpr int kTable = 2048;         // rank 0's candidates on the fast path
constexpr int kCluster = 8;          // CTAs a row with a cut (portable size)
constexpr int kMaxRows = 65535;      // gridDim.y
constexpr int kUnroll = 4;           // 16-byte loads in flight per thread
constexpr int kMaxSlice = 49152;     // elements a CTA caches (16-bit counts)
constexpr long long kMaxDynBytes = 216 * 1024;     // + 9 KB static
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

// fold_in(keys[row], gen[row]): the row's key for this step
__device__ __forceinline__ void step_key_of(const long long* keys,
                                            const long long* gen, int row,
                                            uint32_t& s0, uint32_t& s1) {
  s0 = 0u;
  s1 = static_cast<uint32_t>(gen[row]);
  threefry(static_cast<uint32_t>(keys[2 * row]),
           static_cast<uint32_t>(keys[2 * row + 1]), s0, s1);
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

// the warp's first maximum, in lane 0
__device__ __forceinline__ void warp_best(float& bv, int& bi) {
  for (int o = 16; o > 0; o >>= 1) {
    const float v = __shfl_down_sync(0xffffffffu, bv, o);
    const int i = __shfl_down_sync(0xffffffffu, bi, o);
    keep_best(v, i, bv, bi);
  }
}

// the block's first maximum, in thread 0; every thread must call it
template <int kThreads>
__device__ __forceinline__ void block_best(float& bv, int& bi, float* wv,
                                           int* wi) {
  warp_best(bv, bi);
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  if (lane == 0) {
    wv[warp] = bv;
    wi[warp] = bi;
  }
  __syncthreads();
  if (warp == 0) {
    bv = lane < kThreads / 32 ? wv[lane] : -CUDART_INF_F;
    bi = lane < kThreads / 32 ? wi[lane] : INT_MAX;
    warp_best(bv, bi);
  }
}

__device__ __forceinline__ float widen(const float* x, long long i) {
  return x[i];
}
__device__ __forceinline__ float widen(const uint16_t* x, long long i) {
  return __uint_as_float(static_cast<uint32_t>(x[i]) << 16);    // bf16
}

// a larger float gives a larger key, and -0.0 the key of +0.0, so keys
// order (and tie) as the floats compare
__device__ __forceinline__ uint32_t ord(float f) {
  uint32_t b = __float_as_uint(f);
  if (b == 0x80000000u) b = 0u;
  return b ^ (static_cast<uint32_t>(static_cast<int32_t>(b) >> 31) |
              0x80000000u);
}
__device__ __forceinline__ float from_ord(uint32_t u) {
  return __uint_as_float(u & 0x80000000u ? u ^ 0x80000000u : ~u);
}

// digit pass p covers bits [digit_shift(p), + digit_width(p)) of a key
__device__ __forceinline__ int digit_shift(int p) {
  return p == 0 ? 21 : p == 1 ? 10 : 0;
}
__device__ __forceinline__ int digit_width(int p) { return p == 2 ? 10 : 11; }
// the bits that earlier passes fixed
__device__ __forceinline__ uint32_t high_mask(int p) {
  return p ? ~0u << (digit_shift(p) + digit_width(p)) : 0u;
}

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" : : : "memory");
}
__device__ __forceinline__ void cluster_sync() {
  cluster_arrive();
  cluster_wait();
}

// the top digit of a key: digit pass 0
__device__ __forceinline__ uint32_t top_digit(float v) { return ord(v) >> 21; }

// 16 bytes of input, widened and divided, into shared memory, each value
// counted in hist by its top digit
__device__ __forceinline__ void store_scaled(uint4 r, float temp,
                                             const float*, float* dst,
                                             uint32_t* hist) {
  float4 a = make_float4(__uint_as_float(r.x), __uint_as_float(r.y),
                         __uint_as_float(r.z), __uint_as_float(r.w));
  a.x = __fdiv_rn(a.x, temp);
  a.y = __fdiv_rn(a.y, temp);
  a.z = __fdiv_rn(a.z, temp);
  a.w = __fdiv_rn(a.w, temp);
  reinterpret_cast<float4*>(dst)[0] = a;
  atomicAdd(&hist[top_digit(a.x)], 1u);
  atomicAdd(&hist[top_digit(a.y)], 1u);
  atomicAdd(&hist[top_digit(a.z)], 1u);
  atomicAdd(&hist[top_digit(a.w)], 1u);
}
__device__ __forceinline__ void store_scaled(uint4 r, float temp,
                                             const uint16_t*, float* dst,
                                             uint32_t* hist) {
  const uint32_t w[4] = {r.x, r.y, r.z, r.w};
  float f[8];
#pragma unroll
  for (int j = 0; j < 4; ++j) {   // little-endian: the low half comes first
    f[2 * j] = __fdiv_rn(__uint_as_float(w[j] << 16), temp);
    f[2 * j + 1] = __fdiv_rn(__uint_as_float(w[j] & 0xFFFF0000u), temp);
  }
  reinterpret_cast<float4*>(dst)[0] = make_float4(f[0], f[1], f[2], f[3]);
  reinterpret_cast<float4*>(dst)[1] = make_float4(f[4], f[5], f[6], f[7]);
#pragma unroll
  for (int j = 0; j < 8; ++j) atomicAdd(&hist[top_digit(f[j])], 1u);
}

// --- mbarriers and asynchronous stores into another CTA's shared memory
// (st.async): a store completes on the receiver's mbarrier, which counts
// the bytes it expects, so no cluster-wide fence is needed ---

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n"
               : : "r"(smem_addr(bar)) : "memory");
}
// the one arrival of this phase, which then waits for `bytes` of stores
__device__ __forceinline__ void mbar_expect(uint64_t* bar, uint32_t bytes) {
  asm volatile(
      "{\n\t.reg .b64 state;\n\t"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n\t}"
      : : "r"(smem_addr(bar)), "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(uint64_t* bar) {   // phase 0
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 done, [%0], "
      "%1;\n\t"
      "@!done bra WAIT;\n\t}"
      : : "r"(smem_addr(bar)), "r"(0u) : "memory");
}
// `remote` and `bar` from cluster.map_shared_rank: the receiver's copy
__device__ __forceinline__ void st_async(void* remote, uint4 v, uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.b32 "
      "[%0], {%1, %2, %3, %4}, [%5];\n"
      : : "r"(smem_addr(remote)), "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w),
        "r"(smem_addr(bar)) : "memory");
}
__device__ __forceinline__ void st_async(void* remote, uint2 v, uint64_t* bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.b32 "
      "[%0], {%1, %2}, [%3];\n"
      : : "r"(smem_addr(remote)), "r"(v.x), "r"(v.y), "r"(smem_addr(bar))
      : "memory");
}

// f(i, x) for each element i of the CTA's slice, x its scaled value:
// from shared memory four at a time, or (a slice too large for it) read
// and divided again
template <bool kCached, typename In, typename F>
__device__ __forceinline__ void for_slice(const float* slice, const In* xr,
                                          int n, float temp, F f) {
  if (kCached) {
    const int n4 = n >> 2;
    const float4* s4 = reinterpret_cast<const float4*>(slice);
    for (int j = threadIdx.x; j < n4; j += kSelThreads) {
      const float4 q = s4[j];
      f(4 * j, q.x);
      f(4 * j + 1, q.y);
      f(4 * j + 2, q.z);
      f(4 * j + 3, q.w);
    }
    for (int i = 4 * n4 + threadIdx.x; i < n; i += kSelThreads)
      f(i, slice[i]);
  } else {
    for (int i = threadIdx.x; i < n; i += kSelThreads)
      f(i, __fdiv_rn(widen(xr, i), temp));
  }
}

// Adds the digit of the k-th largest key to sel = {digits so far, rank
// left to find}, given this thread's counts m0, m1 of digits 2t and 2t+1
// (of the keys that match the digits so far) at digit pass p.  Every
// thread calls it; it ends on a barrier.
__device__ __forceinline__ void find_digit(uint32_t m0, uint32_t m1, int p,
                                           uint32_t prefix, uint32_t k,
                                           uint32_t* sel, uint32_t* warp_sum) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  uint32_t incl = m0 + m1;             // these digits and the higher
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_down_sync(0xffffffffu, incl, o);
    if (lane + o < 32) incl += up;
  }
  if (lane == 0) warp_sum[warp] = incl;
  __syncthreads();
  uint32_t higher = warp_sum[lane];    // then the warps above, by a scan
  for (int o = 1; o < 32; o <<= 1) {
    const uint32_t up = __shfl_down_sync(0xffffffffu, higher, o);
    if (lane + o < 32) higher += up;
  }
  higher = __shfl_sync(0xffffffffu, higher, (warp + 1) & 31);
  if (warp < 31) incl += higher;
  const uint32_t above = incl - m0 - m1;
  if (above < k && k <= incl) {      // one thread: #above < k <= #at or above
    const bool hi = above + m1 >= k;
    sel[0] = prefix | (static_cast<uint32_t>(2 * threadIdx.x + (hi ? 1 : 0))
                       << digit_shift(p));
    sel[1] = hi ? k - above : k - above - m1;
  }
  __syncthreads();
}

// The k-th largest key, counted from the largest, among the keys that
// for_keys(g) hands to g(key) in the threads of one block and that match
// `prefix` in the digits before pass `first`: the rest of the digit passes
// over a histogram in shared memory.
template <typename F>
__device__ uint32_t block_select(F for_keys, int first, uint32_t prefix,
                                 uint32_t k, uint32_t* hist, uint32_t* sel,
                                 uint32_t* warp_sum) {
  if (threadIdx.x == 0) {
    sel[0] = prefix;
    sel[1] = k;
  }
  for (int p = first; p < kPasses; ++p) {
    for (int b = threadIdx.x; b < kBins; b += kSelThreads) hist[b] = 0u;
    __syncthreads();
    const uint32_t pre = sel[0], kp = sel[1];
    const int shift = digit_shift(p);
    const uint32_t dmask = (1u << digit_width(p)) - 1u, hi_mask = high_mask(p);
    for_keys([&](uint32_t u) {
      if ((u & hi_mask) == pre) atomicAdd(&hist[(u >> shift) & dmask], 1u);
    });
    __syncthreads();
    find_digit(hist[2 * threadIdx.x], hist[2 * threadIdx.x + 1], p, pre, kp,
               sel, warp_sum);
  }
  return sel[0];
}

// The cut kernel: grid (cluster, B), one cluster per row.  `span`:
// elements a CTA; `vec`: the slices start on 16-byte boundaries and hold
// whole 16-byte words; `cached`: bytes of dynamic shared memory that hold
// the slice (0 without kCached); after them, rank 0's receive buffers
// (fast path) or the cluster's histograms (distributed path).
template <typename In, bool kCached>
__global__ void __launch_bounds__(kSelThreads, 1)
sample_select_kernel(const In* __restrict__ x, long long V, int span,
                     float temp, int top_k, const long long* __restrict__ keys,
                     const long long* __restrict__ gen, int vec, int cached,
                     int* __restrict__ out, float* __restrict__ noise) {
  cg::cluster_group cluster = cg::this_cluster();
  const unsigned rank = cluster.block_rank();
  const int row = blockIdx.y;
  extern __shared__ __align__(16) unsigned char dyn[];
  float* slice = reinterpret_cast<float*>(dyn);      // kCached: x, scaled
  // fast path, rank 0: each rank's top-digit counts (16 bits), then the
  // candidates (value bits, index)
  uint32_t* recv = reinterpret_cast<uint32_t*>(dyn + cached);
  uint2* table = reinterpret_cast<uint2*>(recv + kCluster * kBins / 2);
  // distributed path: the cluster's histograms, one a pass
  uint32_t* merged = reinterpret_cast<uint32_t*>(dyn + cached);
  __shared__ uint32_t hist[kBins];               // this CTA's
  __shared__ uint32_t warp_sum[32];
  __shared__ uint32_t step_key[2];
  __shared__ uint32_t sel[2];        // digits found so far, rank left to find
  __shared__ __align__(16) uint4 msg;        // from rank 0
  __shared__ uint64_t bar_msg, bar_hist, bar_cand;
  __shared__ uint32_t n_src[kCluster];       // rank 0: candidates a rank
  __shared__ uint32_t n_local;
  __shared__ float best_val[kCluster];       // rank 0: each CTA's maximum
  __shared__ int best_idx[kCluster];
  __shared__ float warp_val[32];
  __shared__ int warp_idx[32];

  const long long lo = min(static_cast<long long>(rank) * span, V);
  const int n = static_cast<int>(min(lo + span, V) - lo);
  const In* xr = x + static_cast<long long>(row) * V + lo;
  const uint32_t k = static_cast<uint32_t>(top_k);
  // fast path: with the slice cached (its counts fit 16 bits) and a cut
  // that fits the candidate table
  const bool fast = kCached && k < static_cast<uint32_t>(kTable);
  for (int i = threadIdx.x; i < kBins; i += kSelThreads) hist[i] = 0u;
  if (threadIdx.x < kCluster) n_src[threadIdx.x] = 0u;
  if (threadIdx.x == 0) {
    n_local = 0u;
    mbar_init(&bar_msg);
    mbar_expect(&bar_msg, sizeof(uint4));
    if (rank == 0) {
      mbar_init(&bar_hist);
      mbar_expect(&bar_hist, kCluster * kBins * 2);
      mbar_init(&bar_cand);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" : : : "memory");
  }
  __syncthreads();
  // every rank's mbarriers are set before any rank stores into it
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" : : : "memory");

  if (kCached) {
    if (vec) {
      constexpr int kVec = 16 / sizeof(In);
      const uint4* src = reinterpret_cast<const uint4*>(xr);
      const int nv = n / kVec;
      for (int base = 0; base < nv; base += kUnroll * kSelThreads) {
        uint4 r[kUnroll];
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int i = base + j * kSelThreads + threadIdx.x;
          if (i < nv) r[j] = __ldg(src + i);
        }
#pragma unroll
        for (int j = 0; j < kUnroll; ++j) {
          const int i = base + j * kSelThreads + threadIdx.x;
          if (i < nv) store_scaled(r[j], temp, xr, slice + i * kVec, hist);
        }
      }
    } else {
      for (int i = threadIdx.x; i < n; i += kSelThreads) {
        slice[i] = __fdiv_rn(widen(xr, i), temp);
        atomicAdd(&hist[top_digit(slice[i])], 1u);
      }
    }
  } else {
    for_slice<false>(slice, xr, n, temp, [&](int, float xv) {
      atomicAdd(&hist[top_digit(xv)], 1u);
    });
  }
  if (threadIdx.x < 32) {
    uint32_t s0, s1;
    step_key_of(keys, gen, row, s0, s1);
    if (threadIdx.x == 0) {
      step_key[0] = s0;
      step_key[1] = s1;
    }
  }
  __syncthreads();
  const uint32_t s0 = step_key[0], s1 = step_key[1];
  if (noise != nullptr) {            // checks: every element's noise
    float* noise_r = noise + static_cast<long long>(row) * V + lo;
    for_slice<kCached>(slice, xr, n, temp, [&](int i, float) {
      noise_r[i] = gumbel_of(s0, s1, static_cast<uint32_t>(lo + i));
    });
  }
  asm volatile("barrier.cluster.wait.aligned;\n" : : : "memory");

  if (fast) {
    // Fast path.  (1) Each rank sends rank 0 its top-digit counts.
    uint64_t* rbar = cluster.map_shared_rank(&bar_hist, 0);
    uint32_t* rrecv = cluster.map_shared_rank(recv, 0) + rank * (kBins / 2);
    for (int j = threadIdx.x; j < kBins / 8; j += kSelThreads) {
      const uint32_t* h = hist + 8 * j;
      st_async(rrecv + 4 * j,
               make_uint4(h[0] | h[1] << 16, h[2] | h[3] << 16,
                          h[4] | h[5] << 16, h[6] | h[7] << 16), rbar);
    }
    if (rank == 0) {
      // (2) rank 0 sums them, finds the top digit d of the k-th largest,
      // and tells each rank d and where its candidates (keys with a top
      // digit >= d) go in its table: after those of the ranks before it
      mbar_wait(&bar_hist);
      uint32_t m0 = 0u, m1 = 0u;
#pragma unroll
      for (int r = 0; r < kCluster; ++r) {
        const uint32_t w = recv[r * (kBins / 2) + threadIdx.x];
        m0 += w & 0xFFFFu;
        m1 += w >> 16;
      }
      find_digit(m0, m1, 0, 0u, k, sel, warp_sum);
      const uint32_t d = sel[0] >> 21;
      // each rank's keys with a top digit >= d: 64 threads a rank, each
      // over 32 digits
      const unsigned src = threadIdx.x >> 6;
      if (src < kCluster) {
        const uint4* w4 = reinterpret_cast<const uint4*>(
            recv + src * (kBins / 2) + 16 * (threadIdx.x & 63));
        const uint32_t first = 32 * (threadIdx.x & 63);
        uint32_t c = 0u;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const uint4 v = w4[q];
          const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const uint32_t b = first + 8 * q + 2 * j;
            c += (b >= d ? (w[j] & 0xFFFFu) : 0u) +
                 (b + 1 >= d ? (w[j] >> 16) : 0u);
          }
        }
        for (int o = 16; o > 0; o >>= 1)
          c += __shfl_down_sync(0xffffffffu, c, o);
        if ((threadIdx.x & 31) == 0 && c) atomicAdd(&n_src[src], c);
      }
      __syncthreads();
      uint32_t total = 0u, offset = 0u;
      for (unsigned r = 0; r < kCluster; ++r) {
        if (r == threadIdx.x) offset = total;
        total += n_src[r];
      }
      const bool ok = total <= static_cast<uint32_t>(kTable);
      if (threadIdx.x == 0 && ok) mbar_expect(&bar_cand, total * 8u);
      __syncwarp();
      if (threadIdx.x < kCluster) {
        st_async(cluster.map_shared_rank(&msg, threadIdx.x),
                 make_uint4(sel[0], sel[1], offset, ok ? total : 0u),
                 cluster.map_shared_rank(&bar_msg, threadIdx.x));
      }
    }
    mbar_wait(&bar_msg);
    const uint4 m = msg;             // lowest key of digit d, rank left
                                     // within it, offset, candidates (0:
                                     // too many)
    if (m.w) {
      // (3) each rank sends its candidates; the others are done
      uint2* rtable = cluster.map_shared_rank(table, 0) + m.z;
      uint64_t* rcand = cluster.map_shared_rank(&bar_cand, 0);
      for_slice<true>(slice, xr, n, temp, [&](int i, float xv) {
        if (ord(xv) >= m.x) {
          const uint32_t slot = atomicAdd(&n_local, 1u);
          st_async(rtable + slot,
                   make_uint2(__float_as_uint(xv),
                              static_cast<uint32_t>(lo + i)), rcand);
        }
      });
      if (rank != 0) return;
      // (4) rank 0: the k-th largest among the candidates (the rest of
      // its digits, within top digit d), then the draw of the survivors
      mbar_wait(&bar_cand);
      auto for_table = [&](auto g) {
        for (uint32_t i = threadIdx.x; i < m.w; i += kSelThreads)
          g(table[i]);
      };
      const float t = from_ord(block_select([&](auto g) {
        for_table([&](uint2 c) { g(ord(__uint_as_float(c.x))); });
      }, 1, m.x, m.y, hist, sel, warp_sum));
      float bv = -CUDART_INF_F;
      int bi = INT_MAX;
      for_table([&](uint2 c) {
        const float xv = __uint_as_float(c.x);
        if (!(xv < t)) {
          keep_best(xv + gumbel_of(s0, s1, c.y), static_cast<int>(c.y), bv,
                    bi);
        }
      });
      block_best<kSelThreads>(bv, bi, warp_val, warp_idx);
      if (threadIdx.x == 0) out[row] = bi;
      return;
    }
  }

  // Distributed path (a larger k, a slice too long for shared memory, or
  // candidates that overflow the table): each digit pass adds every CTA's
  // histogram into every rank's copy of the cluster's over distributed
  // shared memory, behind a cluster barrier.
  for (int i = threadIdx.x; i < kPasses * kBins; i += kSelThreads)
    merged[i] = 0u;
  if (threadIdx.x == 0) {
    sel[0] = 0u;
    sel[1] = k;
  }
  cluster_sync();                    // every rank's copies are zero
  for (int p = 0; p < kPasses; ++p) {
    const int shift = digit_shift(p);
    const uint32_t dmask = (1u << digit_width(p)) - 1u, hi_mask = high_mask(p);
    const uint32_t prefix = sel[0];
    const uint32_t kp = sel[1];
    if (p > 0) {                     // pass 0's counts are the load's
      for (int b = threadIdx.x; b < kBins; b += kSelThreads) hist[b] = 0u;
      __syncthreads();
      for_slice<kCached>(slice, xr, n, temp, [&](int, float xv) {
        const uint32_t u = ord(xv);
        if ((u & hi_mask) == prefix)
          atomicAdd(&hist[(u >> shift) & dmask], 1u);
      });
      __syncthreads();
    }
    uint32_t* mp = merged + p * kBins;
    for (int b = threadIdx.x; b < kBins; b += kSelThreads) {
      const uint32_t c = hist[b];
      if (c) {
        for (int r = 0; r < kCluster; ++r)
          atomicAdd(cluster.map_shared_rank(mp + b, r), c);
      }
    }
    cluster_sync();
    find_digit(mp[2 * threadIdx.x], mp[2 * threadIdx.x + 1], p, prefix, kp,
               sel, warp_sum);
  }
  const float t = from_ord(sel[0]);
  float bv = -CUDART_INF_F;
  // an all -inf row still gives its lowest index
  int bi = threadIdx.x < n ? static_cast<int>(lo + threadIdx.x) : INT_MAX;
  for_slice<kCached>(slice, xr, n, temp, [&](int i, float xv) {
    if (!(xv < t)) {
      const int v = static_cast<int>(lo + i);
      keep_best(xv + gumbel_of(s0, s1, static_cast<uint32_t>(v)), v, bv, bi);
    }
  });
  block_best<kSelThreads>(bv, bi, warp_val, warp_idx);
  if (threadIdx.x == 0) {
    *cluster.map_shared_rank(best_val + rank, 0) = bv;
    *cluster.map_shared_rank(best_idx + rank, 0) = bi;
  }
  cluster_sync();
  if (rank == 0 && threadIdx.x < 32) {
    bv = threadIdx.x < kCluster ? best_val[threadIdx.x] : -CUDART_INF_F;
    bi = threadIdx.x < kCluster ? best_idx[threadIdx.x] : INT_MAX;
    warp_best(bv, bi);
    if (threadIdx.x == 0) out[row] = bi;
  }
}

// The no-cut kernel: grid (chunks, B), a span of the row per block.
template <typename In>
__global__ void __launch_bounds__(kSpanThreads)
sample_spans_kernel(const In* __restrict__ x, long long V, long long span,
                    float temp, const long long* __restrict__ keys,
                    const long long* __restrict__ gen,
                    float* __restrict__ part_val, int* __restrict__ part_idx,
                    unsigned* __restrict__ tickets, int* __restrict__ out,
                    float* __restrict__ noise) {
  const int row = blockIdx.y;
  const int chunks = gridDim.x;
  __shared__ uint32_t step_key[2];
  __shared__ float warp_val[kSpanThreads / 32];
  __shared__ int warp_idx[kSpanThreads / 32];
  __shared__ bool last;
  const long long lo = static_cast<long long>(blockIdx.x) * span;
  const long long hi = lo + span < V ? lo + span : V;
  const In* xr = x + static_cast<long long>(row) * V;
  // two elements a step, v and w = v + kSpanThreads: two independent
  // threefry chains in flight per thread
  long long v = lo + threadIdx.x;
  float a = v < hi ? widen(xr, v) : 0.0f;      // in flight during the fold
  float b = v + kSpanThreads < hi ? widen(xr, v + kSpanThreads) : 0.0f;
  if (threadIdx.x < 32) {
    uint32_t s0, s1;
    step_key_of(keys, gen, row, s0, s1);
    if (threadIdx.x == 0) {
      step_key[0] = s0;
      step_key[1] = s1;
    }
  }
  __syncthreads();
  const uint32_t s0 = step_key[0], s1 = step_key[1];
  float* noise_r = noise == nullptr ? nullptr
                                    : noise + static_cast<long long>(row) * V;
  float bv = -CUDART_INF_F;
  int bi = INT_MAX;
  for (; v < hi; v += 2 * kSpanThreads) {
    const long long w = v + kSpanThreads;
    const float xa = a, xb = b;
    if (v + 2 * kSpanThreads < hi) a = widen(xr, v + 2 * kSpanThreads);
    if (w + 2 * kSpanThreads < hi) b = widen(xr, w + 2 * kSpanThreads);
    const float ga = gumbel_of(s0, s1, static_cast<uint32_t>(v));
    const float gb = gumbel_of(s0, s1, static_cast<uint32_t>(w));
    if (noise_r != nullptr) noise_r[v] = ga;
    keep_best(__fdiv_rn(xa, temp) + ga, static_cast<int>(v), bv, bi);
    if (w < hi) {
      if (noise_r != nullptr) noise_r[w] = gb;
      keep_best(__fdiv_rn(xb, temp) + gb, static_cast<int>(w), bv, bi);
    }
  }
  block_best<kSpanThreads>(bv, bi, warp_val, warp_idx);
  if (threadIdx.x == 0) {
    part_val[row * chunks + blockIdx.x] = bv;
    part_idx[row * chunks + blockIdx.x] = bi;
    __threadfence();
    last = atomicAdd(tickets + row, 1u) == static_cast<unsigned>(chunks - 1);
  }
  __syncthreads();
  if (last && threadIdx.x < 32) {
    __threadfence();
    bv = -CUDART_INF_F;
    bi = INT_MAX;
    for (int c = threadIdx.x; c < chunks; c += 32) {
      keep_best(__ldcg(part_val + row * chunks + c),
                __ldcg(part_idx + row * chunks + c), bv, bi);
    }
    warp_best(bv, bi);
    if (threadIdx.x == 0) out[row] = bi;
  }
}

// bytes of dynamic shared memory after the slice: rank 0's receive buffers
// on the fast path, else the cluster's histograms
int buffer_bytes(bool cached, int top_k) {
  const int hists = kPasses * kBins * 4;
  const int fast = kCluster * kBins * 2 + kTable * 8;
  return cached && top_k < kTable ? (fast > hists ? fast : hists) : hists;
}

// a CTA's slice of the row: whole 16-byte words of input
template <typename In>
long long select_span(long long V) {
  constexpr int kVec = 16 / sizeof(In);
  return ((V + kCluster - 1) / kCluster + kVec - 1) / kVec * kVec;
}

template <typename In, bool kCached>
cudaError_t launch_select(const In* x, const long long* keys,
                          const long long* gen, int B, long long V,
                          float temp, int top_k, int* out, float* noise,
                          cudaStream_t s) {
  constexpr int kVec = 16 / sizeof(In);
  const long long span = select_span<In>(V);
  const int vec = V % kVec == 0 &&
                  reinterpret_cast<uintptr_t>(x) % 16 == 0;
  auto kernel = sample_select_kernel<In, kCached>;
  const int cached = kCached ? static_cast<int>(span * sizeof(float)) : 0;
  const int dyn = cached + buffer_bytes(kCached, top_k);
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
  if (err != cudaSuccess) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster, B);
  cfg.blockDim = dim3(kSelThreads);
  cfg.dynamicSmemBytes = dyn;
  cfg.stream = s;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cudaLaunchKernelEx(&cfg, kernel, x, V, static_cast<int>(span), temp,
                            top_k, keys, gen, vec, cached, out, noise);
}

template <typename In>
cudaError_t launch(const In* x, const long long* keys, const long long* gen,
                   int B, long long V, float temp, int top_k, int chunks,
                   float* part_val, int* part_idx, unsigned* tickets, int* out,
                   float* noise, cudaStream_t s) {
  if (top_k > 0 && top_k < V) {
    const long long span = select_span<In>(V);
    if (span <= kMaxSlice &&
        span * static_cast<long long>(sizeof(float)) +
        buffer_bytes(true, top_k) <= kMaxDynBytes)
      return launch_select<In, true>(x, keys, gen, B, V, temp, top_k, out,
                                     noise, s);
    return launch_select<In, false>(x, keys, gen, B, V, temp, top_k, out,
                                    noise, s);
  }
  // a memset, not a kernel: under a CUDA graph it is a memset node
  cudaError_t err = cudaMemsetAsync(tickets, 0, B * sizeof(unsigned), s);
  if (err != cudaSuccess) return err;
  const long long span = (V + chunks - 1) / chunks;
  sample_spans_kernel<In><<<dim3(chunks, B), kSpanThreads, 0, s>>>(
      x, V, span, temp, keys, gen, part_val, part_idx, tickets, out, noise);
  return cudaGetLastError();
}

}  // namespace

// logits [B, V] f32 (bf16 = 0) or bf16 (bf16 = 1), keys [B, 2] and gen [B]
// int64 (the low 32 bits are the words), all contiguous; temp the divisor
// (max(T, 1e-6) as f32); 0 < top_k < V cuts to the top_k largest (8 CTAs
// a row), otherwise nothing is cut and the row is drawn in `chunks` spans
// with part_val/part_idx scratch [B, chunks] and tickets [B] (zeroed here);
// out [B] int32; noise [B, V] f32 or null.  B <= 65535.
extern "C" int sample_tokens(const void* x, int bf16, const long long* keys,
                             const long long* gen, int B, long long V,
                             float temp, int top_k, int chunks,
                             float* part_val, int* part_idx,
                             unsigned* tickets, int* out, float* noise,
                             void* stream) {
  if (B == 0) return 0;
  if (B > kMaxRows) return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      bf16 ? launch(static_cast<const uint16_t*>(x), keys, gen, B, V, temp,
                    top_k, chunks, part_val, part_idx, tickets, out, noise, s)
           : launch(static_cast<const float*>(x), keys, gen, B, V, temp,
                    top_k, chunks, part_val, part_idx, tickets, out, noise,
                    s);
  if (err == cudaSuccess) err = cudaGetLastError();
  return static_cast<int>(err);
}
