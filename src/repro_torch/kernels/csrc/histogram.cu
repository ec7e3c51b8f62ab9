// Segmented |x| histogram + moments for the O(n) top-k threshold, and the
// segment absmax pre-pass (sm_90a).
//
// Replaces the TPU kernel repro/kernels/histogram_quantile.py::
// segment_hist_moments_pallas (body _hist_kernel), and the plain fused
// reduction _segment_absmax that the reference runs before it.  Over the
// flat [R, C] f32 segment buffer, with row r belonging to segment
// row_seg[r] and only its first row_valid[r] columns real:
//
//   hist[s, b] = #{ valid x in s : lo_s <= |x| <= lo_s + w_s,
//                   b = clip(int((|x| - lo_s) / w_s * nbins), 0, nbins-1) }
//   mom[s]     = (sum x, sum x^2, max |x|, sum |x|) over valid x in s
//   smax[s]    = max(0, max |x| over valid x in s)        (segment_absmax)
//
// with w_s = max(width[s], 1e-30).  The bin index uses the Pallas/jnp
// formula with IEEE round-to-nearest division and product (explicit
// __fdiv_rn / __fmul_rn, and the file is built with -fmad=false), so the
// counts are bitwise those of the reference's jnp and Pallas paths.
//
// What bounds both on the H100: bytes (one read of the buffer; the
// histogram and moments are small), 2.48 GB in 0.74 ms at the main path's
// shape.  The design keeps that many bytes in flight and spends few
// instructions and barriers per element:
//
// * Partition.  Block b takes rows [b * rpb, (b + 1) * rpb) with rpb =
//   kBlockElems / C (at least 1): a function of C alone, so every run sums
//   the moments in the same order on every card.  The whole block walks
//   one row at a time; each thread issues kUnroll independent 16-byte
//   loads (4-byte loads when C % 4 or the buffer's alignment forbids
//   them) before it bins any of them.
// * No barrier per row.  Moments stay in registers across the rows of a
//   segment run; the block reduces them in a fixed tree only where the
//   segment changes or the block ends, into part[run's first row], and
//   adds its shared histogram to the global one with integer atomics
//   there.  A barrier-free fast path covers whole vectors; only the last
//   vector of a ragged row masks columns (a block-uniform branch).
// * Skewed data.  One shared-memory int per bin and one atomicAdd per
//   in-range element.  A frozen (all-zero) leaf and a leaf of repeated
//   magnitudes put a warp's lanes on one address; on the H100 that costs
//   a tenth more than Gaussian data, while a warp vote that merged equal
//   bins into one atomic cost more than it saved on both.
// * Segment moments.  The sweep records, per segment, its first row and
//   its end row (int atomicMin / atomicMax, exact).  A second kernel (one
//   block per segment) scans the rows between them and sums the partials
//   of the runs of its own segment in row order and a fixed tree; for a
//   contiguous segment (every buffer the compression builds) that span
//   is the segment's own rows, scanned sixteen rows deep per thread.  No
//   float atomics, so the moments are the same on every run, whatever
//   the layout.
// * segment_absmax: max of the bit patterns of |x| (for non-negative
//   floats an integer max is the float max, exact in any order), reduced
//   per run in the block and met across blocks with an integer atomicMax.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kUnroll = 4;             // independent vector loads per thread
constexpr int kBlockElems = 1 << 18;   // elements per block (rows = this / C)
constexpr unsigned kFull = 0xffffffffu;

int rows_per_block(int C) {
  return C >= kBlockElems ? 1 : kBlockElems / (C > 0 ? C : 1);
}

template <int VEC>
__device__ __forceinline__ void load_vec(const float* p, float (&x)[VEC]) {
  if constexpr (VEC == 4) {
    const float4 v = __ldcs(reinterpret_cast<const float4*>(p));
    x[0] = v.x; x[1] = v.y; x[2] = v.z; x[3] = v.w;
  } else {
    x[0] = __ldcs(p);
  }
}

struct Moments {
  float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f;
  unsigned mx = 0u;            // bits of max |x| (an integer max)
};

// Fixed-order block reduction; thread 0 holds the result.  The caller
// puts a barrier between two calls (red is reused).
__device__ void block_reduce(Moments& m, float4* red) {
  for (int o = 16; o > 0; o >>= 1) {
    m.s1 = __fadd_rn(m.s1, __shfl_down_sync(kFull, m.s1, o));
    m.s2 = __fadd_rn(m.s2, __shfl_down_sync(kFull, m.s2, o));
    m.s3 = __fadd_rn(m.s3, __shfl_down_sync(kFull, m.s3, o));
    m.mx = max(m.mx, __shfl_down_sync(kFull, m.mx, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = make_float4(m.s1, m.s2, __uint_as_float(m.mx), m.s3);
  __syncthreads();
  if (warp == 0) {
    const float4 v = lane < kWarps ? red[lane] : make_float4(0.f, 0.f, 0.f, 0.f);
    m.s1 = v.x; m.s2 = v.y; m.mx = __float_as_uint(v.z); m.s3 = v.w;
    for (int o = 16; o > 0; o >>= 1) {
      m.s1 = __fadd_rn(m.s1, __shfl_down_sync(kFull, m.s1, o));
      m.s2 = __fadd_rn(m.s2, __shfl_down_sync(kFull, m.s2, o));
      m.s3 = __fadd_rn(m.s3, __shfl_down_sync(kFull, m.s3, o));
      m.mx = max(m.mx, __shfl_down_sync(kFull, m.mx, o));
    }
  }
}

struct Seg {
  float lo, w, hi, fbins;
  int nbins;
};

// One element of the sweep.
template <bool MOM, bool MASKED>
__device__ __forceinline__ void bin_one(float v, bool valid, const Seg& g,
                                        int* sh, Moments& m) {
  if (MASKED && !valid) v = 0.0f;
  const float mag = fabsf(v);
  if (MOM) {
    m.s1 = __fadd_rn(m.s1, v);
    m.s2 = __fadd_rn(m.s2, __fmul_rn(v, v));
    m.s3 = __fadd_rn(m.s3, mag);
    m.mx = max(m.mx, __float_as_uint(mag));
  }
  if ((!MASKED || valid) && mag >= g.lo && mag <= g.hi) {
    const float q = __fmul_rn(__fdiv_rn(__fsub_rn(mag, g.lo), g.w), g.fbins);
    atomicAdd(&sh[min(max(__float2int_rz(q), 0), g.nbins - 1)], 1);
  }
}

// Adds the block's shared histogram of segment `seg` to the global one,
// clears it, and (MOM) writes the run's moment partial to part[run0] and
// widens the segment's span of rows in info.  Called by the whole block.
template <bool MOM>
__device__ void end_run(int* sh, int* hist, int nbins, int seg, Moments& m,
                        float4* red, float4* part, int* info, int S,
                        long long run0, long long run_end) {
  __syncthreads();
  int* h = hist + (long long)seg * nbins;
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    const int c = sh[i];
    if (c) {
      atomicAdd(h + i, c);
      sh[i] = 0;
    }
  }
  if (MOM) {
    block_reduce(m, red);
    if (threadIdx.x == 0) {
      part[run0] = make_float4(m.s1, m.s2, __uint_as_float(m.mx), m.s3);
      atomicMin(info + seg, (int)run0);
      atomicMax(info + S + seg, (int)run_end);
    }
    m = Moments();
  }
  __syncthreads();
}

template <int VEC, bool MOM>
__global__ void __launch_bounds__(kThreads)
hist_sweep_kernel(const float* __restrict__ buf, const int* __restrict__ row_seg,
                  const int* __restrict__ row_valid, const float* __restrict__ lo,
                  const float* __restrict__ width, int* __restrict__ hist,
                  float4* __restrict__ part, int* __restrict__ info, long long R,
                  int C, int S, int nbins, int rpb) {
  extern __shared__ int sh[];
  __shared__ float4 red[kWarps];
  const int tid = threadIdx.x;
  for (int i = tid; i < nbins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = min(R, r0 + rpb);
  int cur = r0 > 0 ? row_seg[r0 - 1] : -1;   // the segment of the row before
  bool open = false;                           // a run of `cur` is open
  long long run0 = r0;
  Seg g{0.f, 1.f, 1.f, (float)nbins, nbins};
  Moments m;
  for (long long r = r0; r < r1; ++r) {
    const int seg = row_seg[r];
    if (seg != cur || !open) {
      if (open && seg != cur) {
        end_run<MOM>(sh, hist, nbins, cur, m, red, part, info, S, run0, r);
        open = false;
      }
      if (seg >= 0 && seg < S && !open) {
        open = true;
        run0 = r;
        g.lo = lo[seg];
        g.w = fmaxf(width[seg], 1e-30f);
        g.hi = __fadd_rn(g.lo, g.w);
      }
      cur = seg;
    }
    if (!open) continue;                       // a row outside [0, S)
    const int nv = min(max(row_valid[r], 0), C);
    const int nvec = (nv + VEC - 1) / VEC;
    const float* row = buf + r * (long long)C;
    for (int kb = 0; kb < nvec; kb += kThreads * kUnroll) {
      float x[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = kb + u * kThreads + tid;
        if (idx < nvec) {
          load_vec<VEC>(row + (long long)idx * VEC, x[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) x[u][j] = 0.0f;
        }
      }
      // whole vectors for every thread: no column masks (block-uniform)
      const bool whole = kb + kUnroll * kThreads <= nvec && nv == nvec * VEC;
      if (whole) {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u)
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            bin_one<MOM, false>(x[u][j], true, g, sh, m);
      } else {
#pragma unroll
        for (int u = 0; u < kUnroll; ++u) {
          const int lim = nv - (kb + u * kThreads + tid) * VEC;
#pragma unroll
          for (int j = 0; j < VEC; ++j)
            bin_one<MOM, true>(x[u][j], j < lim, g, sh, m);
        }
      }
    }
  }
  if (open) end_run<MOM>(sh, hist, nbins, cur, m, red, part, info, S, run0, r1);
}

// One block per segment: the partials of its runs (a run starts at a
// block's first row or after a row of another segment), in row order
// over its span of rows, then a fixed tree.  info = [first row (S), end
// row (S)]; a segment with no rows keeps first > end and sums nothing.
// Each thread loads kScan rows' segments before it tests any, so the scan
// of a long span waits on memory once per kScan * kThreads rows.
constexpr int kScan = 16;

__global__ void __launch_bounds__(kThreads)
segment_moments_kernel(const float4* __restrict__ part,
                       const int* __restrict__ row_seg,
                       const int* __restrict__ info, float* __restrict__ mom,
                       int S, int rpb) {
  __shared__ float4 red[kWarps];
  const int s = blockIdx.x;
  const int first = info[s], end = info[S + s];
  Moments m;
  for (int r0 = first + (int)threadIdx.x; r0 < end; r0 += kThreads * kScan) {
    int cur[kScan], prev[kScan];
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      const int r = r0 + u * kThreads;
      cur[u] = r < end ? row_seg[r] : -1;
      prev[u] = r < end && r % rpb != 0 ? row_seg[r - 1] : -1;
    }
#pragma unroll
    for (int u = 0; u < kScan; ++u) {
      if (cur[u] == s && prev[u] != s) {
        const float4 v = part[r0 + u * kThreads];
        m.s1 = __fadd_rn(m.s1, v.x);
        m.s2 = __fadd_rn(m.s2, v.y);
        m.mx = max(m.mx, __float_as_uint(v.z));
        m.s3 = __fadd_rn(m.s3, v.w);
      }
    }
  }
  block_reduce(m, red);
  if (threadIdx.x == 0) {
    mom[s * 4 + 0] = m.s1;
    mom[s * 4 + 1] = m.s2;
    mom[s * 4 + 2] = __uint_as_float(m.mx);
    mom[s * 4 + 3] = m.s3;
  }
}

template <int VEC>
__global__ void __launch_bounds__(kThreads)
absmax_kernel(const float* __restrict__ buf, const int* __restrict__ row_seg,
              const int* __restrict__ row_valid, unsigned* __restrict__ smax,
              long long R, int C, int S, int rpb) {
  __shared__ unsigned red[kWarps];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const long long r0 = (long long)blockIdx.x * rpb;
  const long long r1 = min(R, r0 + rpb);
  int cur = -1;
  unsigned mx = 0u;
  for (long long r = r0; r <= r1; ++r) {
    const int seg = r < r1 ? row_seg[r] : -1;
    if (seg != cur) {          // block-uniform: end the run of `cur`
      if (cur >= 0 && cur < S) {
        for (int o = 16; o > 0; o >>= 1)
          mx = max(mx, __shfl_down_sync(kFull, mx, o));
        if (lane == 0) red[warp] = mx;
        __syncthreads();
        if (tid == 0) {
          unsigned v = red[0];
          for (int w = 1; w < kWarps; ++w) v = max(v, red[w]);
          atomicMax(smax + cur, v);
        }
        __syncthreads();
      }
      mx = 0u;
      cur = seg;
    }
    if (r == r1 || seg < 0 || seg >= S) continue;
    const int nv = min(max(row_valid[r], 0), C);
    const int nvec = (nv + VEC - 1) / VEC;
    const float* row = buf + r * (long long)C;
    for (int kb = 0; kb < nvec; kb += kThreads * kUnroll) {
      float x[kUnroll][VEC];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int idx = kb + u * kThreads + tid;
        if (idx < nvec) {
          load_vec<VEC>(row + (long long)idx * VEC, x[u]);
        } else {
#pragma unroll
          for (int j = 0; j < VEC; ++j) x[u][j] = 0.0f;
        }
      }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        const int lim = nv - (kb + u * kThreads + tid) * VEC;
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const unsigned bitsv = __float_as_uint(x[u][j]) & 0x7fffffffu;
          mx = max(mx, j < lim ? bitsv : 0u);
        }
      }
    }
  }
}

bool vec4_ok(const float* buf, int C) {
  return C % 4 == 0 && (reinterpret_cast<uintptr_t>(buf) & 15u) == 0;
}

}  // namespace

// hist [S, nbins] int32 and mom [S, 4] f32 are written whole; part is
// [R, 4] f32 scratch and info [2, S] int32 scratch (both unused when
// with_moments == 0).
extern "C" int segment_hist_moments(const float* buf, const int* row_seg,
                                    const int* row_valid, const float* lo,
                                    const float* width, int* hist, float* part,
                                    int* info, float* mom, long long R, int C,
                                    int S, int nbins, int with_moments,
                                    void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)S * nbins, st);
  cudaMemsetAsync(mom, 0, sizeof(float) * (size_t)S * 4, st);
  if (R <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int rpb = rows_per_block(C);
  const unsigned blocks = (unsigned)((R + rpb - 1) / rpb);
  const size_t shm = sizeof(int) * (size_t)nbins;
  float4* p4 = reinterpret_cast<float4*>(part);
  const bool v4 = vec4_ok(buf, C);
  if (with_moments) {
    cudaMemsetAsync(info, 0x7f, sizeof(int) * (size_t)S, st);   // first
    cudaMemsetAsync(info + S, 0, sizeof(int) * (size_t)S, st);          // end
    if (v4)
      hist_sweep_kernel<4, true><<<blocks, kThreads, shm, st>>>(
          buf, row_seg, row_valid, lo, width, hist, p4, info, R, C, S, nbins, rpb);
    else
      hist_sweep_kernel<1, true><<<blocks, kThreads, shm, st>>>(
          buf, row_seg, row_valid, lo, width, hist, p4, info, R, C, S, nbins, rpb);
    segment_moments_kernel<<<S, kThreads, 0, st>>>(p4, row_seg, info, mom, S, rpb);
  } else if (v4) {
    hist_sweep_kernel<4, false><<<blocks, kThreads, shm, st>>>(
        buf, row_seg, row_valid, lo, width, hist, p4, info, R, C, S, nbins, rpb);
  } else {
    hist_sweep_kernel<1, false><<<blocks, kThreads, shm, st>>>(
        buf, row_seg, row_valid, lo, width, hist, p4, info, R, C, S, nbins, rpb);
  }
  return static_cast<int>(cudaGetLastError());
}

// smax [S] f32 is written whole: max(0, max |x|) over each segment's valid
// elements.
extern "C" int segment_absmax(const float* buf, const int* row_seg,
                              const int* row_valid, float* smax, long long R,
                              int C, int S, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(smax, 0, sizeof(float) * (size_t)S, st);
  if (R <= 0 || S <= 0) return static_cast<int>(cudaGetLastError());
  const int rpb = rows_per_block(C);
  const unsigned blocks = (unsigned)((R + rpb - 1) / rpb);
  unsigned* out = reinterpret_cast<unsigned*>(smax);
  if (vec4_ok(buf, C))
    absmax_kernel<4><<<blocks, kThreads, 0, st>>>(buf, row_seg, row_valid, out, R, C, S, rpb);
  else
    absmax_kernel<1><<<blocks, kThreads, 0, st>>>(buf, row_seg, row_valid, out, R, C, S, rpb);
  return static_cast<int>(cudaGetLastError());
}
