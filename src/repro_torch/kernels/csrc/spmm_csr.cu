// Row-compressed sparse neighbour sum (CSR SpMM) for Hopper, fp32.
//
// Replaces the Pallas TPU kernel `spmm` of src/repro/kernels/gnn_aggregate.py
// (pallas_call at line 77, body `_kernel` at lines 39-51), which multiplies
// dense (bm, bk) link blocks against feature tiles.  Here the same matrix
// arrives packed by `pack_bsr` (kernels/gnn_aggregate.py): only its nonzeros,
// per partition p and destination row r, in the order the dense product
// visits them (stored block j, then k).  It computes
//
//   out[p, r, c] = sum_{e = row_ptr[p, r]}^{row_ptr[p, r + 1] - 1}
//                      w[p, e] * feats[p, col[p, e], c]
//
// for every partition, row and feature column c < d.  Empty rows give 0.
//
// Bound.  A random layout leaves the stored blocks 99.9% zeros: the work is
// a gather of one feature row per nonzero (tens of thousands of rows of
// d * 4 bytes from a table of a few MB, which fits in the 50 MB L2) and
// 2 * nnz * d fp32 operations, far below the fp32 rate.  The least time is
// set by bytes: the nonzeros (col and w), the row pointers, the feature
// table and the output, each once, over HBM bandwidth.  Tensor cores and
// TMA tiles have nothing to do at this density; what the card must supply is
// many independent row loads in flight.
//
// Design.  Lanes run over feature columns: lane l owns columns c0 + l,
// c0 + l + 32, ... (CPL per lane, a template: d <= 32, 64, 128, 256; wider d
// takes 256-column tiles on grid y); ragged d is masked by clamping the
// column (every load stays in bounds and none sits under a divergent branch)
// and not storing it.  A warp owns one destination row, all P partitions in
// one launch.  Rows are numbered row-major over (r, p) and dealt to CTAs
// with stride gridDim.x, so the plan's hub rows (slotted first in every
// partition) land one per CTA.
//  * A row of at most kLong = 2 * 32 / CPL nonzeros is summed by its warp:
//    one load of up to 32 (col, w) pairs, one per lane, then the feature
//    rows of up to 32 / CPL nonzeros (col broadcast by __shfl_sync) loaded
//    through the read-only path before the fmaf chain consumes any of them.
//  * A longer row (the hubs: up to 277 nonzeros on SIoT) would cost one L2
//    round trip per 32 / CPL nonzeros on one warp.  The whole CTA stages it
//    through shared memory instead, 8 * 32 / CPL nonzeros at a time with
//    every warp loading its share, and the owning warp runs the fmaf chain
//    from shared memory.  Long rows go first, then each warp's short row.
//
// Order.  Each output element is one thread's sequential fmaf chain over the
// row's entries in packed order, for short and long rows alike: no atomics,
// no split rows, no cross-lane sums.  The same inputs give the same bits run
// to run, and, because fmaf(0, f, acc) == acc for finite f, the same bits as
// a dense-block product that chains its fmaf in (j, k) order over the
// unpacked matrix.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFull = 0xffffffffu;

template <int CPL>
struct Tile {
  static constexpr int kBatch = 32 / CPL;  // nonzeros whose rows load at once
  static constexpr int kSmall = kBatch < 8 ? kBatch : 8;
  static constexpr int kLong = 2 * kBatch;  // longer rows: the whole CTA
  static constexpr int kChunk = kWarps * kBatch;  // staged long-row entries
  static constexpr int kCols = 32 * CPL;          // columns per CTA
};

// Loads the feature rows of nonzeros t .. t + B - 1 of the warp's (col, w)
// registers, then chains them into acc.  Lanes past the row hold col 0 (a
// valid row), so every load is unconditional; only the first n are summed.
template <int B, int CPL>
__device__ __forceinline__ void batch(const float* feats_p, int d,
                                      const int (&off)[CPL], int my_c,
                                      float my_w, int t, int n,
                                      float (&acc)[CPL]) {
  float f[B][CPL];
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const float* src = feats_p + (int64_t)__shfl_sync(kFull, my_c, t + u) * d;
#pragma unroll
    for (int q = 0; q < CPL; ++q) f[u][q] = __ldg(src + off[q]);
  }
#pragma unroll
  for (int u = 0; u < B; ++u) {
    const float wv = __shfl_sync(kFull, my_w, t + u);
    if (t + u < n) {  // the same for the whole warp
#pragma unroll
      for (int q = 0; q < CPL; ++q) acc[q] = fmaf(wv, f[u][q], acc[q]);
    }
  }
}

// A row of at most kLong nonzeros, summed by one warp.
template <int CPL>
__device__ __forceinline__ void warp_row(const int32_t* col_p,
                                         const float* w_p,
                                         const float* feats_p, int src_rows,
                                         int d, const int (&off)[CPL],
                                         int beg, int end, int lane,
                                         float (&acc)[CPL]) {
  using T = Tile<CPL>;
  for (int base = beg; base < end; base += 32) {
    const int n = min(32, end - base);
    int my_c = 0;
    float my_w = 0.f;
    if (lane < n) {
      my_c = __ldg(col_p + base + lane);
      my_w = __ldg(w_p + base + lane);
    }
    if ((unsigned)my_c >= (unsigned)src_rows) __trap();  // corrupt col
    for (int t = 0; t < n;) {
      if (n - t > T::kSmall) {
        batch<T::kBatch, CPL>(feats_p, d, off, my_c, my_w, t, n, acc);
        t += T::kBatch;
      } else {
        batch<T::kSmall, CPL>(feats_p, d, off, my_c, my_w, t, n, acc);
        t += T::kSmall;
      }
    }
  }
}

// A longer row, summed by the whole CTA: each step every warp loads the
// feature rows of kBatch entries into shared memory, then the owning warp
// chains the step's entries in order.  Every thread of the CTA calls this.
template <int CPL>
__device__ __forceinline__ void cta_row(const int32_t* col_p,
                                        const float* w_p,
                                        const float* feats_p, int src_rows,
                                        int d, const int (&off)[CPL],
                                        int beg, int end, int owner,
                                        float* s_f, float* s_w,
                                        float (&acc)[CPL]) {
  using T = Tile<CPL>;
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int e0 = wid * T::kBatch;  // this warp's entries of each step
  for (int base = beg; base < end; base += T::kChunk) {
    const int m = min(T::kChunk, end - base);
    const bool mine = lane < T::kBatch && e0 + lane < m;
    int my_c = 0;
    float my_w = 0.f;
    if (mine) {
      my_c = __ldg(col_p + base + e0 + lane);
      my_w = __ldg(w_p + base + e0 + lane);
      s_w[e0 + lane] = my_w;
    }
    if ((unsigned)my_c >= (unsigned)src_rows) __trap();  // corrupt col
    float f[T::kBatch][CPL];
#pragma unroll
    for (int u = 0; u < T::kBatch; ++u) {
      const float* src = feats_p + (int64_t)__shfl_sync(kFull, my_c, u) * d;
#pragma unroll
      for (int q = 0; q < CPL; ++q) f[u][q] = __ldg(src + off[q]);
    }
#pragma unroll
    for (int u = 0; u < T::kBatch; ++u) {
      if (e0 + u < m) {
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          s_f[(e0 + u) * T::kCols + 32 * q + lane] = f[u][q];
      }
    }
    __syncthreads();
    if (wid == owner) {
#pragma unroll 4
      for (int i = 0; i < m; ++i) {
        const float wv = s_w[i];
#pragma unroll
        for (int q = 0; q < CPL; ++q)
          acc[q] = fmaf(wv, s_f[i * T::kCols + 32 * q + lane], acc[q]);
      }
    }
    __syncthreads();
  }
}

template <int CPL>
__global__ void __launch_bounds__(kThreads)
spmm_csr_f32_kernel(const int32_t* __restrict__ row_ptr,
                    const int32_t* __restrict__ col,
                    const float* __restrict__ w,
                    const float* __restrict__ feats,
                    float* __restrict__ out, int P, int n_rows, int nnz_cap,
                    int src_rows, int d) {
  using T = Tile<CPL>;
  __shared__ float s_f[T::kChunk * T::kCols];  // 32 KB
  __shared__ float s_w[T::kChunk];
  __shared__ int s_long[kWarps];
  const int lane = threadIdx.x & 31;
  const int wid = threadIdx.x >> 5;
  const int64_t rows = (int64_t)P * n_rows;
  const int c0 = blockIdx.y * T::kCols + lane;  // this lane's first column
  int off[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) off[q] = min(c0 + 32 * q, d - 1);

  // This warp's row; a warp past the last row has an empty one.
  const int64_t g = blockIdx.x + (int64_t)wid * gridDim.x;
  int p = 0, r = 0, beg = 0, end = 0;
  if (g < rows) {
    r = (int)(g / P);
    p = (int)(g - (int64_t)r * P);
    const int32_t* rp = row_ptr + (int64_t)p * (n_rows + 1) + r;
    beg = __ldg(rp);
    end = __ldg(rp + 1);
    if (beg < 0 || end < beg || end > nnz_cap) __trap();  // corrupt row_ptr
  }
  const int32_t* col_p = col + (int64_t)p * nnz_cap;
  const float* w_p = w + (int64_t)p * nnz_cap;
  const float* feats_p = feats + (int64_t)p * src_rows * d;

  float acc[CPL];
#pragma unroll
  for (int q = 0; q < CPL; ++q) acc[q] = 0.f;
  const bool is_long = end - beg > T::kLong;
  if (lane == 0) s_long[wid] = is_long;
  __syncthreads();
  // Long rows first: they are the launch's critical path.
  for (int o = 0; o < kWarps; ++o) {
    if (!s_long[o]) continue;  // the same for the whole CTA
    const int64_t go = blockIdx.x + (int64_t)o * gridDim.x;
    const int ro = (int)(go / P);
    const int po = (int)(go - (int64_t)ro * P);
    const int32_t* rp = row_ptr + (int64_t)po * (n_rows + 1) + ro;
    cta_row<CPL>(col + (int64_t)po * nnz_cap, w + (int64_t)po * nnz_cap,
                 feats + (int64_t)po * src_rows * d, src_rows, d, off,
                 __ldg(rp), __ldg(rp + 1), o, s_f, s_w, acc);
  }
  if (!is_long)
    warp_row<CPL>(col_p, w_p, feats_p, src_rows, d, off, beg, end, lane, acc);

  if (g < rows) {
    float* out_row = out + ((int64_t)p * n_rows + r) * d;
#pragma unroll
    for (int q = 0; q < CPL; ++q)
      if (c0 + 32 * q < d) out_row[c0 + 32 * q] = acc[q];
  }
}

template <int CPL>
int launch(const void* row_ptr, const void* col, const void* w,
           const void* feats, void* out, int P, int n_rows, int nnz_cap,
           int src_rows, int d, cudaStream_t stream) {
  const int64_t warps = (int64_t)P * n_rows;
  const int64_t blocks = (warps + kWarps - 1) / kWarps;
  const int64_t tiles = (d + 32 * CPL - 1) / (32 * CPL);
  if (blocks > 0x7fffffff || tiles > 65535) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)blocks, (unsigned)tiles);
  spmm_csr_f32_kernel<CPL><<<grid, kThreads, 0, stream>>>(
      static_cast<const int32_t*>(row_ptr), static_cast<const int32_t*>(col),
      static_cast<const float*>(w), static_cast<const float*>(feats),
      static_cast<float*>(out), P, n_rows, nnz_cap, src_rows, d);
  return (int)cudaGetLastError();
}

}  // namespace

// row_ptr (P, n_rows + 1) i32, col and w (P, nnz_cap) i32 and f32,
// feats (P, src_rows, d) f32, out (P, n_rows, d) f32; all contiguous on one
// device.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int spmm_csr_f32(const void* row_ptr, const void* col,
                            const void* w, const void* feats, void* out,
                            int P, int n_rows, int nnz_cap, int src_rows,
                            int d, void* stream) {
  if (P < 1 || n_rows < 1 || nnz_cap < 0 || src_rows < 1 || d < 1) {
    return (int)cudaErrorInvalidValue;
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (d <= 32)
    return launch<1>(row_ptr, col, w, feats, out, P, n_rows, nnz_cap,
                     src_rows, d, s);
  if (d <= 64)
    return launch<2>(row_ptr, col, w, feats, out, P, n_rows, nnz_cap,
                     src_rows, d, s);
  if (d <= 128)
    return launch<4>(row_ptr, col, w, feats, out, P, n_rows, nnz_cap,
                     src_rows, d, s);
  return launch<8>(row_ptr, col, w, feats, out, P, n_rows, nnz_cap, src_rows,
                   d, s);
}

extern "C" const char* repro_torch_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
