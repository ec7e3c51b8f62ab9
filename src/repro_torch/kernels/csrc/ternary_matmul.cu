// Dense x packed-ternary matmul for Hopper (sm_90a): the grouped form,
// in its normal and transposed layouts, and the single-expert form.
//
// Replaces the TPU kernels of repro/kernels/ternary_matmul.py:
// ternary_matmul_grouped (body _kernel_grouped) and ternary_matmul (body
// _kernel).  Per row m with expert e = eid[m]:
//
//     y[m, n] = scales[e] * sum_k x[m, k] * T_e[k, n]      (e >= 0)
//     y[m, n] = 0                                           (e == -1)
//
// T_e is ternary, held as two bit planes of 32-bit words.  Normal form:
// planes [E, K, N/32] packed along n.  Transposed form (transpose_rhs):
// planes [E, N, ceil(K/32)] packed along k (the embedding table reused as
// the tied LM head), computing x @ T_e^t.  The single-expert form is the
// normal form over planes [K, N/32] with one scale.
//
// What bounds it on the H100: bytes at decode (M = 4: each plane word,
// 2 bits per weight, is read once per distinct expert, and each word
// carries about 3 nonzero weights at density 0.1), operations at prefill
// (one add per nonzero weight per row).  A design that walks K with one
// thread per output is bound by that walk's latency instead, and one that
// adds every zero bit spends ten times the adds.
//
// Three contracts shape the design:
//  1. a row's result depends only on its x row, its expert's planes and
//     its scale: the K partition and the reduction tree below depend on K
//     (and the form) alone, never on M, on the other rows or their
//     experts; no float atomics, one launch;
//  2. the single-expert kernel equals a grouped row bitwise: both run the
//     same routine, normal_tile;
//  3. f32 throughout (explicit __fadd_rn / __fmul_rn; the build passes
//     -fmad=false): within 1e-4 * max|plain| of the plain version.
//
// Summation order of one output (m, n), normal form: K is cut into
// subtiles of 32 k; subtile s belongs to phase s % 16.  Each phase adds
// the nonzero terms of its subtiles in ascending k (a term is +x[m, k]
// where only the pos bit is set, -x[m, k] where only the neg bit is set;
// zero bits, and both bits set, add nothing), starting from +0.0.  The 16
// phase sums meet in a fixed pairwise tree, and the scale multiplies
// last.  Transposed form: lane l of a warp owns the k words l, l + 32,
// ... of its output row and adds their nonzero terms in ascending k; a
// fixed __shfl_xor_sync butterfly combines the 32 lane sums.  Skipping
// the zero terms changes nothing but the sign of an all-zero sum.
//
// Normal form: a block of 16 warps (warp w is phase w) owns `cols` (1 or
// 2, chosen by the wrapper from N) plane-word columns, i.e. 32 * cols
// outputs, for one expert group of a tile of up to 8 rows: the rows of
// the tile that share an expert, the z-th such group in the order of
// their first row for blockIdx.z.  So the planes of a group are read once
// per tile whatever its number of rows, and the groups of a decode batch
// run side by side.  For each 32-k subtile a lane loads the `cols` words
// of one k row (a vector load when aligned) and the group's x values at
// that k; a 5-step shuffle transpose turns the warp's 32 x 32 bit tile so
// that lane b holds output column b's bits over the 32 k, and each lane
// walks its set bits with __ffs, two at a time, the CW columns side by
// side.  The next subtile's loads are in flight meanwhile.  The phase
// sums meet in shared memory: one launch, no scratch in device memory.
//
// Transposed form: one warp per output row n (8 per block) and tile of up
// to 4 rows, lanes over consecutive k words of that row (128 contiguous
// bytes per warp load, scalar so that the partition stays a function of
// K alone); the bits past K in the last word are masked.  A warp walks
// its tile's groups with the next group's words in flight, two set bits
// at a time.
//
// Measured on the H100 (PERF.md): the launches of a served wave run at
// 4-45x their byte or operation bound.  A block spends 85-95% of its
// life in the subtile loop (block start and the reduction take about a
// microsecond each), at 2,400-3,800 cycles per warp for one 32 x 32 bit
// tile and column word at decode; coalescing the plane loads changed
// that by 3-15%, so the cost is the loop's instructions (the transposes,
// the set-bit walk, whose trip count is the busiest lane's), not memory.
//
// Left on the table: tensor cores (a prefill product would need its own
// summation order or an exact bf16x3 split of x), TMA, persistent blocks
// over the row tiles of a prefill, and a wider transposed-form load.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr int kWarps = 16;                   // normal: warps per block
constexpr int kThreads = kWarps * 32;
constexpr int kPhases = kWarps;              // K phases of the normal form
constexpr int kRows = 8;                     // rows per tile
constexpr int kTWarps = 8;                   // transposed: warps per block
constexpr int kTRows = 4;                    // transposed: rows per tile

__device__ __forceinline__ uint32_t transpose_step(uint32_t v, int lane,
                                                   int h, uint32_t lo) {
  const uint32_t o = __shfl_xor_sync(kFull, v, h);
  return (lane & h) ? ((v & ~lo) | ((o >> h) & lo))
                    : ((v & lo) | ((o & lo) << h));
}

// Lane j holds row j of a 32 x 32 bit matrix; returns column `lane`
// (its bit j is bit `lane` of row j).
__device__ __forceinline__ uint32_t transpose32(uint32_t v, int lane) {
  v = transpose_step(v, lane, 16, 0x0000ffffu);
  v = transpose_step(v, lane, 8, 0x00ff00ffu);
  v = transpose_step(v, lane, 4, 0x0f0f0f0fu);
  v = transpose_step(v, lane, 2, 0x33333333u);
  return transpose_step(v, lane, 1, 0x55555555u);
}

// Takes the next expert group off `todo` (the tile rows not yet taken;
// lane r holds row r's expert in my_e): its expert and its row mask.
// Warp-uniform.
__device__ __forceinline__ void take_group(unsigned& todo, int my_e, int& e,
                                           unsigned& grp) {
  e = __shfl_sync(kFull, my_e, __ffs(todo) - 1);
  grp = __ballot_sync(kFull, my_e == e);
  todo &= ~grp;
}

// the rows of group mask `grp` (bit r: tile row m0 + r), ascending
__device__ __forceinline__ void group_rows(unsigned grp, int m0, int* row) {
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    row[i] = m0 + (grp ? __ffs(grp) - 1 : 0);
    grp &= grp - 1;
  }
}

// v with its sign flipped unless `plus`: the term of a nonzero weight
__device__ __forceinline__ float signed_term(float v, bool plus) {
  return __int_as_float(__float_as_int(v) ^ (plus ? 0u : 0x80000000u));
}

// the `cols` words of plane row k starting at column c0 (zeros past K or W)
template <int CW>
__device__ __forceinline__ void load_words(const uint32_t* __restrict__ P,
                                           int k, int K, int W, int c0,
                                           bool vec, uint32_t* w) {
  if (k >= K) {
#pragma unroll
    for (int c = 0; c < CW; ++c) w[c] = 0u;
    return;
  }
  const uint32_t* p = P + (long long)k * W + c0;
  if constexpr (CW == 2) {
    if (vec) {
      const uint2 v = __ldg(reinterpret_cast<const uint2*>(p));
      w[0] = v.x, w[1] = v.y;
      return;
    }
  }
#pragma unroll
  for (int c = 0; c < CW; ++c) w[c] = (c0 + c < W) ? __ldg(p + c) : 0u;
}

// One subtile of a warp's work in the normal form: the group's plane words
// of k row k0 + lane and the group's x values there.
template <int CW>
struct Subtile {
  uint32_t p[CW], q[CW];
  float xv[kRows];
};

template <int CW>
__device__ __forceinline__ void load_subtile(
    Subtile<CW>& t, const float* __restrict__ x, const uint32_t* __restrict__ P,
    const uint32_t* __restrict__ Q, const int* row, int cnt, int k, int K,
    int W, int c0, bool vec) {
  load_words<CW>(P, k, K, W, c0, vec, t.p);
  load_words<CW>(Q, k, K, W, c0, vec, t.q);
#pragma unroll
  for (int i = 0; i < kRows; ++i) {
    if (i == cnt) break;
    t.xv[i] = k < K ? __ldg(x + (long long)row[i] * K + k) : 0.f;
  }
}

// The normal form, shared by the grouped and the single-expert kernels.
// planes [E, K, W] (W = N / 32) with expert stride e_stride; eid == nullptr
// means every row is on expert 0 (the single-expert kernel).  The block
// sums expert group blockIdx.z of its row tile (groups in the order of
// their first row); a block whose tile has fewer groups has no work.
// Each warp walks its phase's subtiles with the next one's loads in
// flight; per subtile, the 2 * CW transposes run side by side, then one
// loop walks the CW columns' set bits together.
template <int CW>
__device__ __forceinline__ void normal_tile(
    const float* __restrict__ x, const uint32_t* __restrict__ pos,
    const uint32_t* __restrict__ neg, const float* __restrict__ scales,
    const int* __restrict__ eid, float* __restrict__ out, int M, int K,
    int W, long long e_stride, bool vec) {
  constexpr int kOut = CW * kRows * 32;
  extern __shared__ float smem[];              // normal_smem<CW>() bytes
  float (*red)[kOut] = reinterpret_cast<float (*)[kOut]>(smem);  // warps'
  float (*xs)[kRows][32] =                     // one subtile of x per warp
      reinterpret_cast<float (*)[kRows][32]>(smem + kWarps * kOut);
  const int c0 = blockIdx.x * CW;
  const int m0 = blockIdx.y * kRows;
  const int nrows = min(kRows, M - m0);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int N = W * 32;
  int my_e = -1;
  if (lane < nrows) my_e = eid ? eid[m0 + lane] : 0;
  if (eid && blockIdx.z == 0) {                // rows on no expert: 0
    for (int o = threadIdx.x; o < nrows * CW * 32; o += kThreads) {
      const int r = o / (CW * 32), col = c0 * 32 + o % (CW * 32);
      if (col < N && eid[m0 + r] < 0) out[(long long)(m0 + r) * N + col] = 0.f;
    }
  }
  unsigned todo = __ballot_sync(kFull, my_e >= 0), grp = 0;
  int e = 0;
  for (int z = 0; z <= static_cast<int>(blockIdx.z); ++z) {
    if (!todo) {
      grp = 0;
      break;
    }
    take_group(todo, my_e, e, grp);
  }
  if (!grp) return;                  // the whole block: same tile and z
  int row[kRows];
  group_rows(grp, m0, row);
  const int cnt = __popc(grp);
  const uint32_t* P = pos + e * e_stride;
  const uint32_t* Q = neg + e * e_stride;

  const int phase = warp;
  const int nsub = (K + 31) / 32;
  float acc[CW][kRows];
#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int i = 0; i < kRows; ++i) acc[c][i] = 0.f;
  Subtile<CW> cur, nxt;
  if (phase < nsub)
    load_subtile<CW>(cur, x, P, Q, row, cnt, phase * 32 + lane, K, W, c0,
                     vec);
  for (int s = phase; s < nsub; s += kPhases) {
    if (s + kPhases < nsub)          // the next subtile's loads, early
      load_subtile<CW>(nxt, x, P, Q, row, cnt, (s + kPhases) * 32 + lane, K,
                       W, c0, vec);
    __syncwarp();
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i == cnt) break;
      xs[warp][i][lane] = cur.xv[i];
    }
    __syncwarp();
    uint32_t tp[CW], tm[CW];
#pragma unroll
    for (int c = 0; c < CW; ++c) {
      tp[c] = transpose32(cur.p[c], lane);
      tm[c] = transpose32(cur.p[c] ^ cur.q[c], lane);
    }
    bool any = true;
    while (any) {                    // each column's set bits, ascending k,
      any = false;                   // two at a time
#pragma unroll
      for (int c = 0; c < CW; ++c) {
        if (!tm[c]) continue;
        const int b1 = __ffs(tm[c]) - 1;
        tm[c] &= tm[c] - 1;
        const bool two = tm[c] != 0;
        const int b2 = two ? __ffs(tm[c]) - 1 : b1;
        tm[c] &= tm[c] - 1;
        any |= tm[c] != 0;
        const bool p1 = (tp[c] >> b1) & 1u, p2 = (tp[c] >> b2) & 1u;
#pragma unroll
        for (int i = 0; i < kRows; ++i) {
          if (i == cnt) break;
          const float v1 = xs[warp][i][b1], v2 = xs[warp][i][b2];
          acc[c][i] = __fadd_rn(acc[c][i], signed_term(v1, p1));
          if (two) acc[c][i] = __fadd_rn(acc[c][i], signed_term(v2, p2));
        }
      }
    }
    cur = nxt;
  }

#pragma unroll
  for (int c = 0; c < CW; ++c)
#pragma unroll
    for (int i = 0; i < kRows; ++i) {
      if (i == cnt) break;
      red[warp][(c * kRows + i) * 32 + lane] = acc[c][i];
    }
  __syncthreads();
  const float scale = scales[e];
  for (int o = threadIdx.x; o < kOut; o += kThreads) {   // the warps' tree
    const int c = o / (kRows * 32), i = (o / 32) % kRows, b = o % 32;
    if (i >= cnt || c0 + c >= W) continue;
    float v[kWarps];
#pragma unroll
    for (int w = 0; w < kWarps; ++w) v[w] = red[w][o];
#pragma unroll
    for (int h = kWarps / 2; h >= 1; h >>= 1)
#pragma unroll
      for (int w = 0; w < h; ++w) v[w] = __fadd_rn(v[w], v[w + h]);
    int m = row[0];
#pragma unroll
    for (int j = 1; j < kRows; ++j)
      if (j == i) m = row[j];
    out[(long long)m * N + (c0 + c) * 32 + b] = __fmul_rn(v[0], scale);
  }
}

// shared memory of normal_tile<CW>: the warps' sums and one subtile of x
// per warp
template <int CW>
constexpr int normal_smem() {
  return (kWarps * CW * kRows * 32 + kWarps * kRows * 32) * 4;
}
static_assert(normal_smem<2>() <= 48 * 1024,
              "the widest block must fit the default dynamic shared memory");

template <int CW>
__global__ void __launch_bounds__(kThreads)
grouped_kernel(const float* __restrict__ x, const uint32_t* __restrict__ pos,
               const uint32_t* __restrict__ neg,
               const float* __restrict__ scales, const int* __restrict__ eid,
               float* __restrict__ out, int M, int K, int W,
               long long e_stride, bool vec) {
  normal_tile<CW>(x, pos, neg, scales, eid, out, M, K, W, e_stride, vec);
}

template <int CW>
__global__ void __launch_bounds__(kThreads)
single_kernel(const float* __restrict__ x, const uint32_t* __restrict__ pos,
              const uint32_t* __restrict__ neg,
              const float* __restrict__ scale, float* __restrict__ out,
              int M, int K, int W, bool vec) {
  normal_tile<CW>(x, pos, neg, scale, nullptr, out, M, K, W, 0, vec);
}

// planes [E, N, W] with W = ceil(K / 32) words per output row n, for a
// tile of up to kTRows rows.  One warp per output row; its items are
// (group, 64-word chunk) pairs, the next item's words in flight while the
// current one is summed.  Lane l adds the nonzero terms of its words l,
// l + 32, l + 64, ... in ascending k.
__global__ void __launch_bounds__(kTWarps * 32)
grouped_t_kernel(const float* __restrict__ x, const uint32_t* __restrict__ pos,
                 const uint32_t* __restrict__ neg,
                 const float* __restrict__ scales,
                 const int* __restrict__ eid, float* __restrict__ out, int M,
                 int K, int N, int W, long long e_stride) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n = blockIdx.x * kTWarps + warp;
  const int m0 = blockIdx.y * kTRows;
  const int nrows = min(kTRows, M - m0);
  if (n >= N) return;                // whole warps; no block barrier here
  const int my_e = lane < nrows ? eid[m0 + lane] : -1;
  if (lane < nrows && my_e < 0) out[(long long)(m0 + lane) * N + n] = 0.f;
  unsigned todo = __ballot_sync(kFull, my_e >= 0), grp;
  if (!todo) return;
  const uint32_t last = (K % 32) ? (1u << (K % 32)) - 1u : kFull;
  const int nch = (W + 63) / 64;
  auto load = [&](int e, int ch, uint32_t* p, uint32_t* q) {
    const long long base = e * e_stride + (long long)n * W;
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int wk = ch * 64 + t * 32 + lane;
      p[t] = wk < W ? __ldg(pos + base + wk) : 0u;
      q[t] = wk < W ? __ldg(neg + base + wk) : 0u;
    }
  };
  int e, ch = 0;
  take_group(todo, my_e, e, grp);
  uint32_t p[2], q[2], pn[2] = {}, qn[2] = {};
  load(e, 0, p, q);
  float acc[kTRows];
#pragma unroll
  for (int i = 0; i < kTRows; ++i) acc[i] = 0.f;
  while (true) {
    int en = e, chn = ch + 1;
    unsigned grpn = grp;
    bool more = true;
    if (chn == nch) {                // the next group
      chn = 0;
      more = todo != 0;
      if (more) take_group(todo, my_e, en, grpn);
    }
    if (more) load(en, chn, pn, qn);
    int row[kRows];
    group_rows(grp, m0, row);
    const int cnt = __popc(grp);
#pragma unroll
    for (int t = 0; t < 2; ++t) {    // the lane's words, ascending k
      const int wk = ch * 64 + t * 32 + lane;
      uint32_t m = p[t] ^ q[t];
      if (wk == W - 1) m &= last;
      while (m) {                    // two set bits at a time
        const int b1 = __ffs(m) - 1;
        m &= m - 1;
        const bool two = m != 0;
        const int b2 = two ? __ffs(m) - 1 : b1;
        m &= m - 1;
        const bool p1 = (p[t] >> b1) & 1u, p2 = (p[t] >> b2) & 1u;
#pragma unroll
        for (int i = 0; i < kTRows; ++i) {
          if (i == cnt) break;
          const float* xr = x + (long long)row[i] * K + wk * 32;
          const float v1 = __ldg(xr + b1), v2 = __ldg(xr + b2);
          acc[i] = __fadd_rn(acc[i], signed_term(v1, p1));
          if (two) acc[i] = __fadd_rn(acc[i], signed_term(v2, p2));
        }
      }
    }
    if (chn == 0) {                  // this group is summed
      const float scale = scales[e];
#pragma unroll
      for (int i = 0; i < kTRows; ++i) {
        if (i == cnt) break;
        float v = acc[i];
#pragma unroll
        for (int h = 16; h >= 1; h >>= 1)
          v = __fadd_rn(v, __shfl_xor_sync(kFull, v, h));
        if (lane == 0) out[(long long)row[i] * N + n] = __fmul_rn(v, scale);
        acc[i] = 0.f;
      }
    }
    if (!more) break;
    e = en, grp = grpn, ch = chn;
    p[0] = pn[0], p[1] = pn[1], q[0] = qn[0], q[1] = qn[1];
  }
}

template <int CW>
int launch_single(dim3 grid, cudaStream_t s, const float* x,
                  const uint32_t* pos, const uint32_t* neg,
                  const float* scale, float* out, int M, int K, int W,
                  bool vec) {
  single_kernel<CW><<<grid, kThreads, normal_smem<CW>(), s>>>(
      x, pos, neg, scale, out, M, K, W, vec);
  return static_cast<int>(cudaGetLastError());
}

template <int CW>
int launch_grouped(dim3 grid, cudaStream_t s, const float* x,
                   const uint32_t* pos, const uint32_t* neg,
                   const float* scales, const int* eid, float* out, int M,
                   int K, int W, long long e_stride, bool vec) {
  grouped_kernel<CW><<<grid, kThreads, normal_smem<CW>(), s>>>(
      x, pos, neg, scales, eid, out, M, K, W, e_stride, vec);
  return static_cast<int>(cudaGetLastError());
}

// a vector load of `cols` words fits when every row and expert block
// starts on a multiple of `cols` words of a base aligned to it
bool vector_loads(const void* pos, const void* neg, int W, long long e_stride,
                  int cols) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(pos) |
                      reinterpret_cast<uintptr_t>(neg);
  return cols > 1 && a % (4u * cols) == 0 && W % cols == 0 &&
         e_stride % cols == 0;
}

}  // namespace

// cols: plane-word columns per block (1 or 2), from the wrapper's
// launch_cols(N, form); E: the grid's z is min(E, 8), the most expert
// groups a row tile can hold.  Neither changes a summation order.
extern "C" int ternary_matmul(const float* x, const uint32_t* pos,
                              const uint32_t* neg, const float* scale,
                              float* out, int M, int K, int N, int W,
                              int cols, void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  dim3 grid((W + cols - 1) / cols, (M + kRows - 1) / kRows);
  const bool vec = vector_loads(pos, neg, W, 0, cols);
  switch (cols) {
    case 1: return launch_single<1>(grid, s, x, pos, neg, scale, out, M, K, W, vec);
    case 2: return launch_single<2>(grid, s, x, pos, neg, scale, out, M, K, W, vec);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" int ternary_matmul_grouped(const float* x, const uint32_t* pos,
                                      const uint32_t* neg,
                                      const float* scales, const int* eid,
                                      float* out, int M, int K, int N, int W,
                                      int E, long long e_stride,
                                      int transpose_rhs, int cols,
                                      void* stream) {
  if (M == 0 || N == 0) return 0;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (transpose_rhs) {
    dim3 grid((N + kTWarps - 1) / kTWarps, (M + kTRows - 1) / kTRows);
    grouped_t_kernel<<<grid, kTWarps * 32, 0, s>>>(x, pos, neg, scales, eid,
                                                   out, M, K, N, W, e_stride);
    return static_cast<int>(cudaGetLastError());
  }
  dim3 grid((W + cols - 1) / cols, (M + kRows - 1) / kRows,
            max(1, min(E, kRows)));
  const bool vec = vector_loads(pos, neg, W, e_stride, cols);
  switch (cols) {
    case 1: return launch_grouped<1>(grid, s, x, pos, neg, scales, eid, out, M, K, W, e_stride, vec);
    case 2: return launch_grouped<2>(grid, s, x, pos, neg, scales, eid, out, M, K, W, e_stride, vec);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
