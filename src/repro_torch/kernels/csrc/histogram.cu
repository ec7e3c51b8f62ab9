// Segmented |x| histogram + moments for the O(n) top-k threshold (sm_90a).
//
// Replaces the TPU kernel repro/kernels/histogram_quantile.py::
// segment_hist_moments_pallas (body _hist_kernel).  Over the flat [R, C]
// f32 segment buffer, with row r belonging to segment row_seg[r] and only
// its first row_valid[r] columns real:
//
//   hist[s, b] = #{ valid x in s : lo_s <= |x| <= lo_s + w_s,
//                   b = clip(int((|x| - lo_s) / w_s * nbins), 0, nbins-1) }
//   mom[s]     = (sum x, sum x^2, max |x|, sum |x|) over valid x in s
//
// with w_s = max(width[s], 1e-30).  The bin index uses the Pallas/jnp
// formula with IEEE round-to-nearest division and product (explicit
// __fdiv_rn / __fmul_rn, and the file is built with -fmad=false), so the
// counts are bitwise those of the reference's jnp and Pallas paths.
//
// What bounds it on the H100: bytes (one read of the buffer per sweep;
// the histogram and moments are small).  Design: each block takes eight
// consecutive rows and keeps one 2048-bin int histogram in shared memory
// for the segment it is in; shared-memory integer atomics are
// order-independent, and the block adds its bins to the global histogram
// with integer atomics whenever the segment changes.  The float moments
// use no float atomics: each row's partials are reduced in a fixed tree
// order into a per-row [R, 4] buffer, and a second kernel (one block per
// segment) sums those rows in a fixed order.  An expert's scale is thus
// the same on every run.  Left on the table: 16-byte loads, a warp-private
// histogram to cut shared-atomic contention on skewed data, and fusing the
// segment absmax pass into the coarse sweep.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRowsPerBlock = 8;

// Fixed-order block reduction of (a, b, c) sums and a max.  Every thread
// calls it; thread 0 holds the result.
__device__ void block_reduce4(float& a, float& b, float& c, float& mx,
                              float* red) {
  const unsigned full = 0xffffffffu;
  for (int o = 16; o > 0; o >>= 1) {
    a = __fadd_rn(a, __shfl_down_sync(full, a, o));
    b = __fadd_rn(b, __shfl_down_sync(full, b, o));
    c = __fadd_rn(c, __shfl_down_sync(full, c, o));
    mx = fmaxf(mx, __shfl_down_sync(full, mx, o));
  }
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  __syncthreads();                 // red may still be read from last call
  if (lane == 0) {
    red[warp] = a;
    red[32 + warp] = b;
    red[64 + warp] = c;
    red[96 + warp] = mx;
  }
  __syncthreads();
  if (warp == 0) {
    a = lane < kWarps ? red[lane] : 0.0f;
    b = lane < kWarps ? red[32 + lane] : 0.0f;
    c = lane < kWarps ? red[64 + lane] : 0.0f;
    mx = lane < kWarps ? red[96 + lane] : 0.0f;
    for (int o = 16; o > 0; o >>= 1) {
      a = __fadd_rn(a, __shfl_down_sync(full, a, o));
      b = __fadd_rn(b, __shfl_down_sync(full, b, o));
      c = __fadd_rn(c, __shfl_down_sync(full, c, o));
      mx = fmaxf(mx, __shfl_down_sync(full, mx, o));
    }
  }
}

__device__ void flush_hist(int* sh, int* hist_seg, int nbins) {
  __syncthreads();
  for (int i = threadIdx.x; i < nbins; i += kThreads) {
    const int c = sh[i];
    if (c) {
      atomicAdd(hist_seg + i, c);
      sh[i] = 0;
    }
  }
  __syncthreads();
}

__global__ void hist_rows_kernel(const float* __restrict__ buf,
                                 const int* __restrict__ row_seg,
                                 const int* __restrict__ row_valid,
                                 const float* __restrict__ lo,
                                 const float* __restrict__ width,
                                 int* __restrict__ hist,
                                 float* __restrict__ row_mom, long long R,
                                 int C, int nbins, int with_moments) {
  extern __shared__ int sh[];
  __shared__ float red[128];
  for (int i = threadIdx.x; i < nbins; i += kThreads) sh[i] = 0;
  __syncthreads();
  const float fbins = (float)nbins;
  int cur = -1;
  for (int j = 0; j < kRowsPerBlock; ++j) {
    const long long r = (long long)blockIdx.x * kRowsPerBlock + j;
    if (r >= R) break;                       // block-uniform
    const int seg = row_seg[r];
    if (seg != cur) {
      if (cur >= 0) flush_hist(sh, hist + (long long)cur * nbins, nbins);
      cur = seg;
    }
    const float lo_s = lo[seg];
    const float w_s = fmaxf(width[seg], 1e-30f);
    const float hi_s = __fadd_rn(lo_s, w_s);
    const int nv = row_valid[r];
    const float* row = buf + r * (long long)C;
    float s1 = 0.0f, s2 = 0.0f, s3 = 0.0f, mx = 0.0f;
    for (int c = threadIdx.x; c < nv && c < C; c += kThreads) {
      const float v = row[c];
      const float mag = fabsf(v);
      if (mag >= lo_s && mag <= hi_s) {
        const float q =
            __fmul_rn(__fdiv_rn(__fsub_rn(mag, lo_s), w_s), fbins);
        const int b = min(max(__float2int_rz(q), 0), nbins - 1);
        atomicAdd(&sh[b], 1);
      }
      if (with_moments) {
        s1 = __fadd_rn(s1, v);
        s2 = __fadd_rn(s2, __fmul_rn(v, v));
        s3 = __fadd_rn(s3, mag);
        mx = fmaxf(mx, mag);
      }
    }
    if (with_moments) {
      block_reduce4(s1, s2, s3, mx, red);
      if (threadIdx.x == 0) {
        row_mom[r * 4 + 0] = s1;
        row_mom[r * 4 + 1] = s2;
        row_mom[r * 4 + 2] = mx;
        row_mom[r * 4 + 3] = s3;
      }
    }
  }
  if (cur >= 0) flush_hist(sh, hist + (long long)cur * nbins, nbins);
}

// One block per segment: sum the rows' partials in a fixed order.
__global__ void segment_moments_kernel(const float* __restrict__ row_mom,
                                       const int* __restrict__ row_seg,
                                       float* __restrict__ mom, long long R) {
  __shared__ float red[128];
  const int s = blockIdx.x;
  float a = 0.0f, b = 0.0f, c = 0.0f, mx = 0.0f;
  for (long long r = threadIdx.x; r < R; r += kThreads) {
    if (row_seg[r] == s) {
      a = __fadd_rn(a, row_mom[r * 4 + 0]);
      b = __fadd_rn(b, row_mom[r * 4 + 1]);
      mx = fmaxf(mx, row_mom[r * 4 + 2]);
      c = __fadd_rn(c, row_mom[r * 4 + 3]);
    }
  }
  block_reduce4(a, b, c, mx, red);
  if (threadIdx.x == 0) {
    mom[s * 4 + 0] = a;
    mom[s * 4 + 1] = b;
    mom[s * 4 + 2] = mx;
    mom[s * 4 + 3] = c;
  }
}

}  // namespace

// hist [S, nbins] int32 and mom [S, 4] f32 are written whole; row_mom is
// [R, 4] f32 scratch (unused when with_moments == 0).
extern "C" int segment_hist_moments(const float* buf, const int* row_seg,
                                    const int* row_valid, const float* lo,
                                    const float* width, int* hist,
                                    float* row_mom, float* mom, long long R,
                                    int C, int S, int nbins,
                                    int with_moments, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaMemsetAsync(hist, 0, sizeof(int) * (size_t)S * nbins, st);
  cudaMemsetAsync(mom, 0, sizeof(float) * (size_t)S * 4, st);
  if (R > 0) {
    const long long blocks = (R + kRowsPerBlock - 1) / kRowsPerBlock;
    hist_rows_kernel<<<(unsigned)blocks, kThreads, sizeof(int) * nbins, st>>>(
        buf, row_seg, row_valid, lo, width, hist, row_mom, R, C, nbins,
        with_moments);
    if (with_moments) {
      segment_moments_kernel<<<S, kThreads, 0, st>>>(row_mom, row_seg, mom,
                                                     R);
    }
  }
  return static_cast<int>(cudaGetLastError());
}
