// Block-sparse neighbour sum (BSR SpMM) for Hopper, fp32.
//
// Replaces the Pallas TPU kernel `spmm` of src/repro/kernels/gnn_aggregate.py
// (pallas_call at line 77, body `_kernel` at lines 39-51).  It computes
//
//   out[p, i*bm + r, c] = sum_j sum_k values[p, i*maxb + j, r, k]
//                               * feats[p, block_cols[p, i, j]*bk + k, c]
//
// for every partition p, destination block-row i, row r < bm and feature
// column c < d.  Padded blocks hold zeros and point at source block 0.
//
// Design.  One CTA per (destination block-row i, 64-column d-tile, partition
// p).  The Pallas kernel's sequential j grid axis, whose accumulator lived in
// VMEM, becomes a loop inside the CTA with the accumulator in registers: each
// thread owns one column and up to 8 rows of the (bm, 64) output tile.  Each
// step stages a (bm, 32) slice of the value block and the matching (32, 64)
// slice of the feature block chosen by block_cols in shared memory, then
// accumulates with fmaf.  Blocks are taken in a fixed j order and k in a
// fixed order, with no atomics and no split-K, so the result is the same bit
// for bit from run to run.  Ragged d is masked here: no caller pads to 128.
//
// Bound.  The product this data needs is 2 * nnz * d operations, far below
// the card's fp32 rate, so the least time is set by bytes: `values`
// (P * nb * maxb * bm * bk * 4 bytes) read once, which each d-tile's CTA
// streams from device memory.  The kernel as written also performs the
// dense-block multiply-adds, 2 * bm * bk * d per stored block, which at
// d = 52 cost about as much fp32 time as those bytes; most multiply zeros.
// A faster version skips padded blocks and stages tiles with TMA; this one
// is the simple, correct first version.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kBD = 64;                     // feature columns per CTA
constexpr int kKC = 32;                     // k rows staged per step
constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / kBD;  // threads sharing one column
constexpr int kMaxBM = 32;
constexpr int kRowsPerThread = kMaxBM / kRowGroups;

__global__ void __launch_bounds__(kThreads)
spmm_bsr_f32_kernel(const float* __restrict__ values,
                    const int32_t* __restrict__ block_cols,
                    const float* __restrict__ feats,
                    float* __restrict__ out,
                    int nb, int maxb, int bm, int bk, int src_rows, int d) {
  __shared__ float s_val[kMaxBM][kKC];
  __shared__ float s_feat[kKC][kBD];

  const int i = blockIdx.x;
  const int d0 = blockIdx.y * kBD;
  const int p = blockIdx.z;
  const int tid = threadIdx.x;
  const int tx = tid % kBD;
  const int ty = tid / kBD;
  const int n_src_blocks = src_rows / bk;

  const int64_t row_block = (int64_t)p * nb + i;
  const float* vals_i = values + row_block * maxb * bm * bk;
  const int32_t* cols_i = block_cols + row_block * maxb;
  const float* feats_p = feats + (int64_t)p * src_rows * d;

  float acc[kRowsPerThread];
#pragma unroll
  for (int q = 0; q < kRowsPerThread; ++q) acc[q] = 0.f;

  for (int j = 0; j < maxb; ++j) {
    const int col = cols_i[j];
    if (col < 0 || col >= n_src_blocks) __trap();  // corrupt block_cols
    const float* blk = vals_i + (int64_t)j * bm * bk;
    const float* src = feats_p + (int64_t)col * bk * d;
    for (int kc = 0; kc < bk; kc += kKC) {
      for (int e = tid; e < bm * kKC; e += kThreads) {
        const int r = e / kKC, kk = e % kKC;
        s_val[r][kk] = (kc + kk < bk) ? blk[(int64_t)r * bk + kc + kk] : 0.f;
      }
      for (int e = tid; e < kKC * kBD; e += kThreads) {
        const int kk = e / kBD, c = e % kBD;
        const int row = kc + kk, colf = d0 + c;
        s_feat[kk][c] =
            (row < bk && colf < d) ? src[(int64_t)row * d + colf] : 0.f;
      }
      __syncthreads();
#pragma unroll 8
      for (int kk = 0; kk < kKC; ++kk) {
        const float f = s_feat[kk][tx];
#pragma unroll
        for (int q = 0; q < kRowsPerThread; ++q) {
          const int r = ty + q * kRowGroups;
          if (r < bm) acc[q] = fmaf(s_val[r][kk], f, acc[q]);
        }
      }
      __syncthreads();
    }
  }

  const int c = d0 + tx;
  if (c < d) {
    float* out_i = out + row_block * bm * d;
#pragma unroll
    for (int q = 0; q < kRowsPerThread; ++q) {
      const int r = ty + q * kRowGroups;
      if (r < bm) out_i[(int64_t)r * d + c] = acc[q];
    }
  }
}

}  // namespace

// values (P, nb*maxb, bm, bk) f32, block_cols (P, nb, maxb) i32,
// feats (P, src_rows, d) f32, out (P, nb*bm, d) f32; all contiguous on one
// device.  Launches on `stream` and returns the launch's cudaError_t.
extern "C" int spmm_bsr_f32(const void* values, const void* block_cols,
                            const void* feats, void* out, int P, int nb,
                            int maxb, int bm, int bk, int src_rows, int d,
                            void* stream) {
  if (P < 1 || nb < 1 || maxb < 1 || d < 1 || bm < 1 || bm > kMaxBM ||
      bk < 1 || src_rows < bk || src_rows % bk != 0 || P > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  const dim3 grid(nb, (d + kBD - 1) / kBD, P);
  spmm_bsr_f32_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      static_cast<const float*>(values),
      static_cast<const int32_t*>(block_cols),
      static_cast<const float*>(feats), static_cast<float*>(out), nb, maxb,
      bm, bk, src_rows, d);
  return (int)cudaGetLastError();
}

extern "C" const char* repro_torch_cuda_error_string(int code) {
  return cudaGetErrorString((cudaError_t)code);
}
