// Flash attention (blockwise online softmax, GQA-aware) for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (pallas_call at line 117, body
// `_kernel` at lines 30-81).  For q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D) and an
// optional kv_len (B,) it computes, for every query head h (kv head
// h / (Hq/Hkv)) and query row r at position r + Lk - Lq,
//
//   out[b, h, r] = sum_j p_j v[b, h_kv, j] / max(sum_j p_j, 1e-30),
//   p_j = exp(s_j - max s),  s_j = scale * q[b, h, r] . k[b, h_kv, j]
//
// over the keys j < kv_len[b] (clamped to [0, Lk]) and, when causal,
// j <= r + Lk - Lq; masked keys have p_j = 0, so a fully masked row gives 0.
// Running max, sum and the output accumulator are fp32; the output is in
// q's dtype.  Inputs are read through explicit strides: the model passes its
// (B, L, H, D) tensors and KV-cache slices as transposed views, with no copy.
//
// The TPU kernel walks a sequential kv grid axis with its running max, sum
// and accumulator in VMEM scratch.  CTAs have no order, so each kernel here
// keeps that state in registers (or reduces it in a fixed order) and a CTA
// serves one (batch, kv head) and a block of the flattened
// (query position, group head) row space, group head fastest: one K/V tile
// staged in shared memory serves every query head of the GQA group, the
// point of the TPU kernel's h // group index map.  Three kernels sit behind
// one wrapper (repro_torch/kernels/flash_attention.py), which picks one by
// shape, dtype and strides alone:
//
// * flash_prefill_bf16_kernel (bf16, Lq * group > 16, D in {32, 64, 96,
//   128}).  Bound by operations (4 D flops per query row and live key, on
//   the tensor cores).  A CTA of 4 warps takes 64 rows; each warp owns 16.
//   Q is staged once, K/V tiles of 64 keys stream through a ring of
//   cp.async 16-byte copies (3 stages up to D = 64, else 2; one barrier a
//   tile), with shared rows padded by 16 bytes so ldmatrix is free of bank
//   conflicts.  S = Q K^T and O += P V are mma.sync.m16n8k16 bf16 -> fp32,
//   each k-step's fragments loaded by ldmatrix (V by ldmatrix.trans) ahead
//   of its products.  The online softmax works in the accumulator
//   fragments: a thread holds parts of 2 rows, a row's max and sum reduce
//   over the 4 lanes of a quad in a fixed order, and the scores are scaled
//   by scale * log2(e) before the max (any sign of scale), so ex2.approx
//   takes s - m.  P is rounded to bf16 in registers and fed as the A
//   fragment of P V (the m16n8 accumulator layout is the m16n8k16 A
//   layout), as the reference's chunked path rounds p to v's dtype.  Tiles wholly above a warp's causal diagonal or past kv_len are
//   skipped; only the tiles the diagonal or kv_len crosses are masked.  The
//   grid is 1-D, the row blocks with the most keys first.
//
// * flash_decode_split_kernel (f32 or bf16, Lq * group <= 16).  Bound by
//   bytes (each live K/V row once).  Lq = 1 leaves too few rows to fill a
//   CTA, so the keys are split instead: grid (S, Hkv, B) with S = ceil(Lk /
//   Ks) splits of a fixed length Ks <= 128.  A CTA whose split starts at or
//   past kv_len exits at once (with kv_len = 0, split 0 writes the zero
//   output).  A live CTA stages its keys' K and V rows with cp.async
//   16-byte copies; a thread per key scores every row in fp32; a warp per
//   row reduces its max and sum in a fixed butterfly order; each warp sums
//   p v over a quarter of the keys in key order and the quarters add in
//   warp order; the CTA writes (m, l, acc) to a scratch.  The last CTA of
//   each (batch, kv head) to finish, elected by an integer counter that it
//   then resets, combines the live partials in split order in the same
//   launch.  Split boundaries depend on Lk, Ks and the row's own kv_len
//   only, so the bits of a row never depend on B, on the other rows or on
//   which CTA finished last; no float atomics and no host read of kv_len.
//
// * flash_attention_kernel, everything else (fp32 prefill, prefill head
//   dims outside the templates, rows that are not whole 16-byte chunks,
//   views whose rows are not 16-byte aligned): CUDA-core fmaf in fp32, 8
//   warps x 4 rows per CTA, 32-key tiles with one key per lane, any
//   strides.  TF32 would break the reference's 2e-5 fp32 tolerance.
//
// Two more kernels are the backward (flash_bwd_dq_kernel, then
// flash_bwd_dkdv_kernel; see their section below): the reference has no
// backward kernel, so they write out the flash-attention backward on the
// CUDA cores, with the forward's masks and log2-domain scores.  They take
// the calls that the tensor-core backward (flash_attention_bwd_tc.cu: bf16,
// the prefill's head dims, 16-byte aligned rows) does not.  The helpers
// both sources use live in flash_common.cuh.
//
// Every entry point launches on the given stream and returns the launch's
// cudaError_t (cudaGetLastError right after the launch).

#include <math.h>

#include "flash_common.cuh"

namespace {

struct Strides {
  int64_t q[4], k[4], v[4], o[4];
};

__device__ __forceinline__ float load_f(const float* p) { return *p; }
__device__ __forceinline__ float load_f(const __nv_bfloat16* p) {
  return __bfloat162float(*p);
}
__device__ __forceinline__ void store_f(float* p, float x) { *p = x; }
__device__ __forceinline__ void store_f(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(kFull, x, o));
  return x;
}

// Butterfly sum, then lane 0's value for every lane, so all lanes of a row
// divide by the same bits.
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return __shfl_sync(kFull, x, 0);
}

Strides unpack_strides(const int64_t* s) {
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[4 + i];
    st.v[i] = s[8 + i];
    st.o[i] = s[12 + i];
  }
  return st;
}

// =============================================== general CUDA-core kernel
constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kKeys = 32;                     // keys per tile, one per lane

// DC = number of 32-column slices of the head dim: D <= DP = 32 * DC.
template <typename T, int DC>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ out,
                       const int32_t* __restrict__ kv_len, Strides st, int Hq,
                       int Hkv, int Lq, int Lk, int D, int causal,
                       float scale) {
  constexpr int DP = 32 * DC;
  extern __shared__ float smem[];
  float* q_s = smem;                    // [kRows][DP]      scaled q rows
  float* k_s = q_s + kRows * DP;        // [kKeys][DP + 1]  k tile
  float* v_s = k_s + kKeys * (DP + 1);  // [kKeys][DP]      v tile

  const int group = Hq / Hkv;
  const int nrows = Lq * group;
  const int row0 = blockIdx.x * kRows;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_off = Lk - Lq;

  int live = Lk;
  if (kv_len != nullptr) live = min(max(kv_len[b], 0), Lk);
  int key_end = live;  // keys [0, key_end) can be live for some row here
  if (causal) {
    const int last_row = min(row0 + kRows, nrows) - 1;
    key_end = min(key_end, last_row / group + q_off + 1);
  }

  const T* q_b = q + b * st.q[0];
  const T* k_b = k + b * st.k[0] + hk * st.k[1];
  const T* v_b = v + b * st.v[0] + hk * st.v[1];

  for (int e = tid; e < kRows * DP; e += kThreads) {
    const int r = e / DP, d = e % DP;
    const int f = row0 + r;
    float x = 0.f;
    if (f < nrows && d < D) {
      const int i = f / group, h = hk * group + f % group;
      x = load_f(q_b + h * st.q[1] + i * st.q[2] + d * st.q[3]) * scale;
    }
    q_s[e] = x;
  }

  const int rbase = warp * kRowsPerWarp;
  const bool warp_active = row0 + rbase < nrows;
  bool valid[kRowsPerWarp];
  int qpos[kRowsPerWarp];
  float m[kRowsPerWarp], l[kRowsPerWarp], acc[kRowsPerWarp][DC];
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    const int f = row0 + rbase + t;
    valid[t] = f < nrows;
    qpos[t] = f / group + q_off;
    m[t] = -INFINITY;
    l[t] = 0.f;
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[t][c] = 0.f;
  }

  for (int j0 = 0; j0 < key_end; j0 += kKeys) {
    __syncthreads();  // q staged; the previous tile fully consumed
    for (int e = tid; e < kKeys * DP; e += kThreads) {
      const int kk = e / DP, d = e % DP;
      const int pos = j0 + kk;
      float kx = 0.f, vx = 0.f;
      if (pos < key_end && d < D) {
        kx = load_f(k_b + pos * st.k[2] + d * st.k[3]);
        vx = load_f(v_b + pos * st.v[2] + d * st.v[3]);
      }
      k_s[kk * (DP + 1) + d] = kx;
      v_s[kk * DP + d] = vx;
    }
    __syncthreads();
    if (!warp_active) continue;

    float s[kRowsPerWarp];
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) s[t] = 0.f;
    const float* kr = k_s + lane * (DP + 1);
    const float* qr = q_s + rbase * DP;
#pragma unroll 16
    for (int d = 0; d < DP; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t)
        s[t] = fmaf(qr[t * DP + d], kd, s[t]);
    }

    const int pos = j0 + lane;
#pragma unroll
    for (int t = 0; t < kRowsPerWarp; ++t) {
      const bool ok = valid[t] && pos < key_end && (!causal || pos <= qpos[t]);
      const float sc = ok ? s[t] : -INFINITY;
      const float m_new = fmaxf(m[t], warp_max(sc));
      const float p = ok ? expf(sc - m_new) : 0.f;
      const float corr = (m[t] == -INFINITY) ? 0.f : expf(m[t] - m_new);
      l[t] = l[t] * corr + warp_sum(p);
      m[t] = m_new;
#pragma unroll
      for (int c = 0; c < DC; ++c) acc[t][c] *= corr;
      s[t] = p;
    }

#pragma unroll 4
    for (int jj = 0; jj < kKeys; ++jj) {
      float pj[kRowsPerWarp];
#pragma unroll
      for (int t = 0; t < kRowsPerWarp; ++t)
        pj[t] = __shfl_sync(kFull, s[t], jj);
      const float* vr = v_s + jj * DP + lane;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float vx = vr[32 * c];
#pragma unroll
        for (int t = 0; t < kRowsPerWarp; ++t)
          acc[t][c] = fmaf(pj[t], vx, acc[t][c]);
      }
    }
  }

  if (!warp_active) return;
#pragma unroll
  for (int t = 0; t < kRowsPerWarp; ++t) {
    if (!valid[t]) continue;
    const int f = row0 + rbase + t;
    const int i = f / group, h = hk * group + f % group;
    T* o = out + b * st.o[0] + h * st.o[1] + i * st.o[2];
    const float denom = fmaxf(l[t], 1e-30f);
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store_f(o + d * st.o[3], acc[t][c] / denom);
    }
  }
}

template <typename T, int DC>
int launch_general(const void* q, const void* k, const void* v, void* out,
                   const void* kv_len, const Strides& st, int B, int Hq,
                   int Hkv, int Lq, int Lk, int D, int causal, float scale,
                   cudaStream_t stream) {
  constexpr int DP = 32 * DC;
  const size_t smem =
      (size_t)(kRows * DP + kKeys * (DP + 1) + kKeys * DP) * sizeof(float);
  auto kern = flash_attention_kernel<T, DC>;
  const int e = allow_smem(kern, smem);
  if (e != 0) return e;
  const int64_t nrows = (int64_t)Lq * (Hq / Hkv);
  const int64_t nblocks = (nrows + kRows - 1) / kRows;
  if (nrows > 0x7fffffff - kRows) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)nblocks, (unsigned)Hkv, (unsigned)B);
  kern<<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int32_t*>(kv_len), st, Hq, Hkv, Lq, Lk, D, causal,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_general_dc(int D, const void* q, const void* k, const void* v,
                      void* out, const void* kv_len, const Strides& st, int B,
                      int Hq, int Hkv, int Lq, int Lk, int causal, float scale,
                      cudaStream_t stream) {
  if (D <= 32)
    return launch_general<T, 1>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                D, causal, scale, stream);
  if (D <= 64)
    return launch_general<T, 2>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                D, causal, scale, stream);
  if (D <= 128)
    return launch_general<T, 4>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                D, causal, scale, stream);
  return launch_general<T, 8>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk, D,
                              causal, scale, stream);
}

// ======================================= bf16 prefill on the tensor cores
// A CTA of 4 warps, 16 rows each, over 64-key K/V tiles; a 3-stage ring up
// to D = 64 (65 KB of shared memory, three CTAs an SM at 167 registers), 2
// stages above (87 KB at D = 128).
template <int D>
struct TcShape {
  static constexpr int kWarps = 4;
  static constexpr int kKeys = 64;
  static constexpr int kStages = D <= 64 ? 3 : 2;
  static constexpr int kThreads = kWarps * 32;
  static constexpr int kRows = kWarps * 16;
  static constexpr size_t kSmem = (size_t)(kRows + 2 * kStages * kKeys) *
                                  (D + 8) * sizeof(__nv_bfloat16);
};

template <int D>
__global__ void __launch_bounds__(TcShape<D>::kThreads)
flash_prefill_bf16_kernel(const __nv_bfloat16* __restrict__ q,
                          const __nv_bfloat16* __restrict__ k,
                          const __nv_bfloat16* __restrict__ v,
                          __nv_bfloat16* __restrict__ out,
                          const int32_t* __restrict__ kv_len, Strides st,
                          int Hq, int Hkv, int B, int Lq, int Lk, int causal,
                          float scale_log2) {
  using Shape = TcShape<D>;
  constexpr int kThreads = Shape::kThreads;
  constexpr int kRows = Shape::kRows;
  constexpr int kStages = Shape::kStages;
  constexpr int kKeys = Shape::kKeys;
  constexpr int LD = D + 8;   // padded shared row: ldmatrix conflict-free
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KD = D / 16;  // k-steps of Q K^T
  constexpr int NO = D / 8;   // n-tiles of the output
  constexpr int NS = kKeys / 8;  // n-tiles of S
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* q_s = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* k_s = q_s + kRows * LD;            // [stage][key][LD]
  __nv_bfloat16* v_s = k_s + kStages * kKeys * LD;  // [stage][key][LD]

  const int group = Hq / Hkv;
  const int nrows = Lq * group;
  // A 1-D grid in order of causal work: the last row block of every
  // (batch, kv head) first, so the CTAs an SM takes together pair heavy
  // blocks with light ones.
  const int heads = Hkv * B;
  const int nblk = (nrows + kRows - 1) / kRows;
  const int row0 = (nblk - 1 - (int)(blockIdx.x / heads)) * kRows;
  const int hk = (int)(blockIdx.x % heads) % Hkv;
  const int b = (int)(blockIdx.x % heads) / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_off = Lk - Lq;

  int live = Lk;
  if (kv_len != nullptr) live = min(max(kv_len[b], 0), Lk);
  int key_end = live;  // keys [0, key_end) can be live for some row here
  if (causal)
    key_end = min(key_end, (min(row0 + kRows, nrows) - 1) / group + q_off + 1);
  key_end = max(key_end, 0);
  const int ntiles = (key_end + kKeys - 1) / kKeys;

  const __nv_bfloat16* q_b = q + b * st.q[0];
  const __nv_bfloat16* k_b = k + b * st.k[0] + hk * st.k[1];
  const __nv_bfloat16* v_b = v + b * st.v[0] + hk * st.v[1];

  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH, f = row0 + r;
    const bool ok = f < nrows;
    const __nv_bfloat16* src = q_b;
    if (ok)
      src += (int64_t)(hk * group + f % group) * st.q[1] +
             (int64_t)(f / group) * st.q[2] + c * 8;
    cp_async16(q_s + r * LD + c * 8, src, ok);
  }
  // Keys at or past key_end are zero-filled: their p is 0, and 0 * v must
  // not meet stale bits.
  auto load_kv = [&](int tile) {
    const int stage = tile % kStages;
    __nv_bfloat16* kd = k_s + stage * kKeys * LD;
    __nv_bfloat16* vd = v_s + stage * kKeys * LD;
    for (int e = tid; e < kKeys * CH; e += kThreads) {
      const int kk = e / CH, c = e % CH;
      const int pos = tile * kKeys + kk;
      const bool ok = pos < key_end;
      const int64_t kofs = ok ? (int64_t)pos * st.k[2] + c * 8 : 0;
      const int64_t vofs = ok ? (int64_t)pos * st.v[2] + c * 8 : 0;
      cp_async16(kd + kk * LD + c * 8, k_b + kofs, ok);
      cp_async16(vd + kk * LD + c * 8, v_b + vofs, ok);
    }
  };
  // Group t holds tile t (group 0 also Q); one group is committed per
  // step, empty or not, so "tile j has landed" is wait_group(kStages - 2).
#pragma unroll
  for (int t = 0; t < kStages - 1; ++t) {
    if (t < ntiles) load_kv(t);
    cp_async_commit();
  }

  // This warp's 16 rows; this thread holds rows lane / 4 and lane / 4 + 8,
  // and the keys each may see.  The warp's own causal extent bounds the
  // tiles it computes.
  const int wrow0 = row0 + warp * 16;
  const bool warp_active = wrow0 < nrows;
  int lim[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = wrow0 + lane / 4 + 8 * h;
    lim[h] = causal ? min(live, f / group + q_off + 1) : live;
  }
  int warp_end = live, warp_full = live;
  if (causal) {
    warp_end = min(live, (min(wrow0 + 16, nrows) - 1) / group + q_off + 1);
    warp_full = min(live, wrow0 / group + q_off + 1);
  }

  uint32_t qf[KD][4];
  float o[NO][4];
#pragma unroll
  for (int n = 0; n < NO; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) o[n][c] = 0.f;
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};

  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<kStages - 2>();  // Q and tile j have landed
    // Every warp is past tile j - 1, whose stage the next load refills.
    __syncthreads();
    if (j + kStages - 1 < ntiles) load_kv(j + kStages - 1);
    cp_async_commit();
    if (j == 0 && warp_active) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        ldmatrix_x4(qf[kd], q_s + (warp * 16 + (lane % 8) +
                                   ((lane / 8) & 1) * 8) * LD +
                                kd * 16 + (lane / 16) * 8);
    }
    const int k0 = j * kKeys;
    if (!warp_active || k0 >= warp_end) continue;
    const __nv_bfloat16* ks = k_s + (j % kStages) * kKeys * LD;
    const __nv_bfloat16* vs = v_s + (j % kStages) * kKeys * LD;

    float s[NS][4];
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = 0.f;
    // A k-step's K fragments are all loaded before its products.
#pragma unroll
    for (int kd = 0; kd < KD; ++kd) {
      uint32_t kb[NS / 2][4];
#pragma unroll
      for (int np = 0; np < NS / 2; ++np)
        ldmatrix_x4(kb[np], ks + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                                kd * 16 + ((lane / 8) & 1) * 8);
#pragma unroll
      for (int np = 0; np < NS / 2; ++np) {
        mma_bf16(s[2 * np], qf[kd], kb[np][0], kb[np][1]);
        mma_bf16(s[2 * np + 1], qf[kd], kb[np][2], kb[np][3]);
      }
    }

    // Scores in the log2 domain (times scale log2 e) before the max, so
    // any scale, 0 or negative too, gives the plain version's softmax.
    // Only the tiles that the diagonal or kv_len crosses are masked.
#pragma unroll
    for (int n = 0; n < NS; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] *= scale_log2;
    if (k0 + kKeys > warp_full) {
#pragma unroll
      for (int n = 0; n < NS; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + n * 8 + 2 * (lane % 4) + (c & 1);
          if (key >= lim[c >> 1]) s[n][c] = -INFINITY;
        }
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < NS; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float corr = exp2_approx(m[h] - m_use);
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < NS; ++n) {
        const float p0 = exp2_approx(s[n][2 * h] - m_use);
        const float p1 = exp2_approx(s[n][2 * h + 1] - m_use);
        s[n][2 * h] = p0;
        s[n][2 * h + 1] = p1;
        sum += p0;
        sum += p1;
      }
      l[h] = l[h] * corr + sum;
      m[h] = m_new;
#pragma unroll
      for (int n = 0; n < NO; ++n) {
        o[n][2 * h] *= corr;
        o[n][2 * h + 1] *= corr;
      }
    }

#pragma unroll
    for (int kk = 0; kk < kKeys / 16; ++kk) {
      uint32_t vb[NO / 2][4];
#pragma unroll
      for (int np = 0; np < NO / 2; ++np)
        ldmatrix_x4_trans(
            vb[np], vs + (kk * 16 + (lane % 8) + ((lane / 8) & 1) * 8) * LD +
                        np * 16 + (lane / 16) * 8);
      const uint32_t pa[4] = {pack_bf16(s[2 * kk][0], s[2 * kk][1]),
                              pack_bf16(s[2 * kk][2], s[2 * kk][3]),
                              pack_bf16(s[2 * kk + 1][0], s[2 * kk + 1][1]),
                              pack_bf16(s[2 * kk + 1][2], s[2 * kk + 1][3])};
#pragma unroll
      for (int np = 0; np < NO / 2; ++np) {
        mma_bf16(o[2 * np], pa, vb[np][0], vb[np][1]);
        mma_bf16(o[2 * np + 1], pa, vb[np][2], vb[np][3]);
      }
    }
  }
  cp_async_wait<0>();

  if (!warp_active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float lh = l[h];
    lh += __shfl_xor_sync(kFull, lh, 1);
    lh += __shfl_xor_sync(kFull, lh, 2);
    const int f = wrow0 + lane / 4 + 8 * h;
    if (f >= nrows) continue;
    __nv_bfloat16* orow = out + b * st.o[0] +
                          (int64_t)(hk * group + f % group) * st.o[1] +
                          (int64_t)(f / group) * st.o[2];
    const float denom = fmaxf(lh, 1e-30f);
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(orow + d) = __floats2bfloat162_rn(
          o[n][2 * h] / denom, o[n][2 * h + 1] / denom);
    }
  }
}

template <int D>
int launch_prefill(const void* q, const void* k, const void* v, void* out,
                   const void* kv_len, const Strides& st, int B, int Hq,
                   int Hkv, int Lq, int Lk, int causal, float scale,
                   cudaStream_t stream) {
  using Shape = TcShape<D>;
  auto kern = flash_prefill_bf16_kernel<D>;
  const int e = allow_smem(kern, Shape::kSmem);
  if (e != 0) return e;
  const int64_t nrows = (int64_t)Lq * (Hq / Hkv);
  const int64_t nblocks =
      (nrows + Shape::kRows - 1) / Shape::kRows * (int64_t)Hkv * B;
  if (nrows > 0x7fffffff - Shape::kRows || nblocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  kern<<<(unsigned)nblocks, Shape::kThreads, Shape::kSmem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(out),
      static_cast<const int32_t*>(kv_len), st, Hq, Hkv, B, Lq, Lk, causal,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

// ======================================================= split-key decode
constexpr int kDecThreads = 128;
constexpr int kDecMaxRows = 16;  // Lq * group

// x[0..EPC) from one 16-byte chunk.
__device__ __forceinline__ void unpack16(const uint4& raw, float (&x)[4]) {
  const float* f = reinterpret_cast<const float*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = f[i];
}
__device__ __forceinline__ void unpack16(const uint4& raw, float (&x)[8]) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&raw);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    x[2 * i] = f.x;
    x[2 * i + 1] = f.y;
  }
}

// Two consecutive elements as floats.
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}

constexpr int kDecWarps = kDecThreads / 32;
constexpr int kDecRowBlock = 4;  // rows summed together in P V
constexpr int kDecPairs = 4;     // column pairs a lane owns: D <= 256

size_t decode_smem_bytes(int R, int D, int Ks, size_t esize) {
  return (size_t)Ks * (2 * D + 16 / esize) * esize +
         (size_t)(R * D + R * Ks + kDecWarps * kDecRowBlock * D) *
             sizeof(float);
}

// part: [3][B * Hkv * S * R (* D for acc)] fp32 scratch (m, l, acc);
// counters: B * Hkv ints, 0 between launches.  Ks <= kDecThreads, D <= DMAX.
template <typename T, int DMAX>
__global__ void __launch_bounds__(kDecThreads)
flash_decode_split_kernel(const T* __restrict__ q, const T* __restrict__ k,
                          const T* __restrict__ v, T* __restrict__ out,
                          const int32_t* __restrict__ kv_len, Strides st,
                          int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                          float scale_log2, int Ks, float* __restrict__ part,
                          int* __restrict__ counters,
                          float* __restrict__ out32, float* __restrict__ ml) {
  constexpr int EPC = 16 / sizeof(T);  // elements per 16-byte chunk
  const int C = D / EPC;
  const int group = Hq / Hkv;
  const int R = Lq * group;
  const int S = gridDim.x;
  const int s = blockIdx.x;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int bh = b * Hkv + hk;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_off = Lk - Lq;

  const int KLD = D + EPC;  // k rows padded by 16 bytes
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* k_s = reinterpret_cast<T*>(smem_raw);              // [Ks][KLD]
  T* v_s = k_s + Ks * KLD;                              // [Ks][D]
  float* q_s = reinterpret_cast<float*>(v_s + Ks * D);  // [R][D]
  float* p_s = q_s + R * D;                             // [R][Ks]
  float* red = p_s + R * Ks;  // [warp][kDecRowBlock][D]
  __shared__ float m_s[kDecMaxRows], l_s[kDecMaxRows];
  __shared__ int s_last;

  // kv_len and q are read together.
  int live = Lk;
  if (kv_len != nullptr) live = kv_len[b];
  const T* q_b = q + b * st.q[0];
  for (int e = tid; e < R * D; e += kDecThreads) {
    const int r = e / D, d = e % D;
    q_s[e] = load_f(q_b + (int64_t)(hk * group + r % group) * st.q[1] +
                    (int64_t)(r / group) * st.q[2] + d);
  }
  live = min(max(live, 0), Lk);
  const int n_live = (live + Ks - 1) / Ks;  // splits holding a live key

  auto out_row = [&](int r) {
    return out + b * st.o[0] + (int64_t)(hk * group + r % group) * st.o[1] +
           (int64_t)(r / group) * st.o[2];
  };
  // With stats: row r's fp32 output and its (M, L) at (b, head, position)
  // in (B, Hq, Lq) order.
  const int64_t nrows = (int64_t)gridDim.z * Hq * Lq;
  auto stat_row = [&](int r) {
    return ((int64_t)b * Hq + hk * group + r % group) * Lq + r / group;
  };
  if (s >= n_live) {
    if (s == 0) {  // no live key at all: every row is exactly 0
      for (int e = tid; e < R * D; e += kDecThreads) {
        store_f(out_row(e / D) + (e % D) * st.o[3], 0.f);
        if (out32 != nullptr) out32[stat_row(e / D) * D + e % D] = 0.f;
      }
      if (ml != nullptr && tid < R) {
        ml[stat_row(tid)] = -INFINITY;
        ml[nrows + stat_row(tid)] = 0.f;
      }
    }
    return;
  }

  const int j0 = s * Ks;
  const int n = min(Ks, live - j0);  // this split's keys below kv_len
  const T* k_b = k + b * st.k[0] + hk * st.k[1];
  const T* v_b = v + b * st.v[0] + hk * st.v[1];
  for (int e = tid; e < n * C; e += kDecThreads) {
    const int j = e / C, c = e % C;
    cp_async16(k_s + j * KLD + c * EPC,
               k_b + (int64_t)(j0 + j) * st.k[2] + c * EPC, true);
  }
  cp_async_commit();
  for (int e = tid; e < n * C; e += kDecThreads) {
    const int j = e / C, c = e % C;
    cp_async16(v_s + j * D + c * EPC,
               v_b + (int64_t)(j0 + j) * st.v[2] + c * EPC, true);
  }
  cp_async_commit();
  cp_async_wait<1>();  // K has landed
  __syncthreads();

  // Scores, log2 domain: a thread per key, four rows at a time against its
  // k row (q read by all lanes at once: a broadcast), over d in order.
  if (tid < n) {
    const T* kr = k_s + tid * KLD;
    for (int r0 = 0; r0 < R; r0 += kDecRowBlock) {
      float sc[kDecRowBlock] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int c = 0; c < DMAX / EPC; ++c) {
        if (c >= C) break;
        float x[EPC];
        unpack16(*reinterpret_cast<const uint4*>(kr + c * EPC), x);
#pragma unroll
        for (int rr = 0; rr < kDecRowBlock; ++rr) {
          if (r0 + rr >= R) break;
          const float4* qp =
              reinterpret_cast<const float4*>(q_s + (r0 + rr) * D + c * EPC);
#pragma unroll
          for (int i = 0; i < EPC / 4; ++i) {
            const float4 qv = qp[i];
            sc[rr] = fmaf(qv.x, x[4 * i], sc[rr]);
            sc[rr] = fmaf(qv.y, x[4 * i + 1], sc[rr]);
            sc[rr] = fmaf(qv.z, x[4 * i + 2], sc[rr]);
            sc[rr] = fmaf(qv.w, x[4 * i + 3], sc[rr]);
          }
        }
      }
#pragma unroll
      for (int rr = 0; rr < kDecRowBlock; ++rr)
        if (r0 + rr < R) p_s[(r0 + rr) * Ks + tid] = sc[rr] * scale_log2;
    }
  }
  __syncthreads();

  // Each row's max and sum over this split's keys: a warp per row.
  for (int r = warp; r < R; r += kDecWarps) {
    const int lim = (causal ? min(live, r / group + q_off + 1) : live) - j0;
    float* pr = p_s + r * Ks;
    float mx = -INFINITY;
    for (int j = lane; j < n; j += 32)
      if (j < lim) mx = fmaxf(mx, pr[j]);
    mx = warp_max(mx);
    const float m_use = mx == -INFINITY ? 0.f : mx;
    float sum = 0.f;
    for (int j = lane; j < n; j += 32) {
      const float p = j < lim ? exp2f(pr[j] - m_use) : 0.f;
      pr[j] = p;
      sum += p;
    }
    sum = warp_sum(sum);
    if (lane == 0) {
      m_s[r] = mx;
      l_s[r] = sum;
    }
  }
  cp_async_wait<0>();  // V has landed
  __syncthreads();

  // acc[r][d] = sum_j p[r][j] v[j][d]: warp w sums its quarter of the keys
  // in key order, a lane owns columns 2 lane + 64 i and 2 lane + 64 i + 1,
  // and the four warps' sums add in warp order.
  const int64_t slot = ((int64_t)bh * S + s) * R;
  const int64_t nslots = (int64_t)gridDim.z * Hkv * S * R;
  float* pm = part;
  float* pl = part + nslots;
  float* pacc = part + 2 * nslots;
  const int kw = (n + kDecWarps - 1) / kDecWarps;
  const int ja = min(n, warp * kw), jb = min(n, ja + kw);
  for (int r0 = 0; r0 < R; r0 += kDecRowBlock) {
    float acc[kDecRowBlock][kDecPairs][2];
#pragma unroll
    for (int rr = 0; rr < kDecRowBlock; ++rr)
#pragma unroll
      for (int i = 0; i < kDecPairs; ++i) acc[rr][i][0] = acc[rr][i][1] = 0.f;
    for (int j = ja; j < jb; ++j) {
      float p[kDecRowBlock];
#pragma unroll
      for (int rr = 0; rr < kDecRowBlock; ++rr)
        p[rr] = r0 + rr < R ? p_s[(r0 + rr) * Ks + j] : 0.f;
#pragma unroll
      for (int i = 0; i < kDecPairs; ++i) {
        const int d = 2 * lane + 64 * i;
        if (d >= D) break;
        const float2 x = load2(v_s + j * D + d);
#pragma unroll
        for (int rr = 0; rr < kDecRowBlock; ++rr) {
          acc[rr][i][0] = fmaf(p[rr], x.x, acc[rr][i][0]);
          acc[rr][i][1] = fmaf(p[rr], x.y, acc[rr][i][1]);
        }
      }
    }
#pragma unroll
    for (int rr = 0; rr < kDecRowBlock; ++rr)
#pragma unroll
      for (int i = 0; i < kDecPairs; ++i) {
        const int d = 2 * lane + 64 * i;
        if (d >= D) break;
        float* w = red + (warp * kDecRowBlock + rr) * D + d;
        w[0] = acc[rr][i][0];
        w[1] = acc[rr][i][1];
      }
    __syncthreads();
    for (int e = tid; e < kDecRowBlock * D; e += kDecThreads) {
      const int rr = e / D, d = e % D;
      if (r0 + rr >= R) break;
      float x = 0.f;
#pragma unroll
      for (int w = 0; w < kDecWarps; ++w) x += red[(w * kDecRowBlock + rr) * D + d];
      pacc[(slot + r0 + rr) * D + d] = x;
    }
    __syncthreads();
  }
  if (tid < R) {
    pm[slot + tid] = m_s[tid];
    pl[slot + tid] = l_s[tid];
  }

  // The last live CTA of this (batch, kv head) combines the partials in
  // split order, one pass with a running max: fenced once, after the
  // barrier that orders the CTA's writes.
  __syncthreads();
  if (tid == 0) {
    __threadfence();
    s_last = atomicAdd(counters + bh, 1) == n_live - 1;
  }
  __syncthreads();
  if (!s_last) return;
  __threadfence();
  const int64_t base = (int64_t)bh * S * R;
  for (int e = tid; e < R * D; e += kDecThreads) {
    const int r = e / D, d = e % D;
    float M = -INFINITY, L = 0.f, acc = 0.f;
#pragma unroll 8
    for (int t = 0; t < n_live; ++t) {
      const int64_t idx = base + (int64_t)t * R + r;
      const float mt = __ldcg(pm + idx);
      const float lt = __ldcg(pl + idx);
      const float at = __ldcg(pacc + idx * D + d);
      if (mt == -INFINITY) continue;  // no live key of this row here
      const float mn = fmaxf(M, mt);
      const float a = exp2f(M - mn), w = exp2f(mt - mn);
      L = fmaf(lt, w, L * a);
      acc = fmaf(at, w, acc * a);
      M = mn;
    }
    const float o = acc / fmaxf(L, 1e-30f);
    store_f(out_row(r) + d * st.o[3], o);
    if (out32 != nullptr) {
      out32[stat_row(r) * D + d] = o;
      if (d == 0) {
        ml[stat_row(r)] = M;
        ml[nrows + stat_row(r)] = L;
      }
    }
  }
  if (tid == 0) counters[bh] = 0;  // ready for the next launch
}

template <typename T, int DMAX>
int launch_decode(const void* q, const void* k, const void* v, void* out,
                  const void* kv_len, const Strides& st, int B, int Hq,
                  int Hkv, int Lq, int Lk, int D, int causal, float scale,
                  int Ks, void* part, void* counters, void* out32, void* ml,
                  cudaStream_t stream) {
  const int R = Lq * (Hq / Hkv);
  const size_t smem = decode_smem_bytes(R, D, Ks, sizeof(T));
  if (smem > 227 * 1024) return (int)cudaErrorInvalidValue;
  auto kern = flash_decode_split_kernel<T, DMAX>;
  const int e = allow_smem(kern, smem);
  if (e != 0) return e;
  const int S = Lk > 0 ? (Lk + Ks - 1) / Ks : 1;
  const dim3 grid((unsigned)S, (unsigned)Hkv, (unsigned)B);
  kern<<<grid, kDecThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(out),
      static_cast<const int32_t*>(kv_len), st, Hq, Hkv, Lq, Lk, D, causal,
      scale * kLog2e, Ks, static_cast<float*>(part),
      static_cast<int*>(counters), static_cast<float*>(out32),
      static_cast<float*>(ml));
  return (int)cudaGetLastError();
}

template <typename T>
int launch_decode_d(const void* q, const void* k, const void* v, void* out,
                    const void* kv_len, const Strides& st, int B, int Hq,
                    int Hkv, int Lq, int Lk, int D, int causal, float scale,
                    int Ks, void* part, void* counters, void* out32,
                    void* ml, cudaStream_t stream) {
  if (D <= 64)
    return launch_decode<T, 64>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                D, causal, scale, Ks, part, counters, out32,
                                ml, stream);
  if (D <= 128)
    return launch_decode<T, 128>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                 D, causal, scale, Ks, part, counters, out32,
                                 ml, stream);
  return launch_decode<T, 256>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                               D, causal, scale, Ks, part, counters, out32,
                               ml, stream);
}

// ============================================= backward on the CUDA cores
// The reference has no backward kernel (it trains attention in plain jnp),
// so these two follow the flash-attention backward's formulas, in fp32 on
// the CUDA cores, with the forward's semantics: scores in the log2 domain
// (times scale log2 e), bottom-right causal alignment, the kv_len mask, and
// P = 0 on masked keys (a fully masked row has no live key, LSE = +inf, and
// a zero gradient).  Each output element is written once by one CTA from
// sums in a fixed order: no atomics, so a launch repeats bit for bit.
//
// * flash_bwd_dq_kernel, grid (row blocks, Hkv, B): 64 rows of the
//   flattened (position, group head) space per CTA, 8 per warp.  Pass 1
//   recomputes each row's max and sum over the live keys (32-key tiles, a
//   key per lane) and writes LSE = m + log2 l and Delta = sum dO o (fp32,
//   (B, Hq, Lq)); pass 2 walks the key tiles again in ascending order:
//   P = exp2(S - LSE), dP = dO V^T, dS = P (dP - Delta), dQ += dS K, and
//   writes scale dQ.
// * flash_bwd_dkdv_kernel, grid (key blocks, Hkv, B), launched after the dq
//   kernel on the same stream: 64 keys per CTA, 8 per warp.  For each query
//   head of the group in order, then each 32-row query tile in ascending
//   order (tiles that causality masks whole are skipped), a query per lane:
//   dV += P^T dO and dK += dS^T Q, summed over the group inside the CTA
//   (what makes GQA deterministic); writes scale dK and dV.
//
// Both are bound by operations (10 D flops per query row and live key, in
// fp32 here).  bf16 calls with the prefill's head dims and 16-byte aligned
// rows take the tensor-core pair of flash_attention_bwd_tc.cu instead.
constexpr int kBwdWarps = 8;
constexpr int kBwdThreads = kBwdWarps * 32;
constexpr int kBwdPerWarp = 8;                     // rows (dq) or keys (dkdv)
constexpr int kBwdBlock = kBwdWarps * kBwdPerWarp;  // 64 per CTA
constexpr int kBwdTile = 32;                        // keys or queries per tile

template <int DC>
size_t bwd_smem_bytes() {
  constexpr int DP = 32 * DC;
  return (size_t)(2 * kBwdBlock * DP + 2 * kBwdTile * (DP + 1) +
                  2 * kBwdTile) * sizeof(float);
}

template <typename T, int DC>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                    const T* __restrict__ v, const T* __restrict__ out,
                    const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse, float* __restrict__ delta,
                    const int32_t* __restrict__ kv_len, BwdStrides st, int Hq,
                    int Hkv, int Lq, int Lk, int D, int causal,
                    float scale_log2, float scale) {
  constexpr int DP = 32 * DC;
  constexpr int R = kBwdPerWarp;
  extern __shared__ float smem[];
  float* q_s = smem;                       // [kBwdBlock][DP]
  float* do_s = q_s + kBwdBlock * DP;      // [kBwdBlock][DP]
  float* k_s = do_s + kBwdBlock * DP;      // [kBwdTile][DP + 1]
  float* v_s = k_s + kBwdTile * (DP + 1);  // [kBwdTile][DP + 1]

  const int group = Hq / Hkv;
  const int nrows = Lq * group;
  const int row0 = blockIdx.x * kBwdBlock;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_off = Lk - Lq;

  int live = Lk;
  if (kv_len != nullptr) live = min(max(kv_len[b], 0), Lk);
  int key_end = live;  // keys [0, key_end) can be live for some row here
  if (causal) {
    const int last_row = min(row0 + kBwdBlock, nrows) - 1;
    key_end = min(key_end, last_row / group + q_off + 1);
  }
  key_end = max(key_end, 0);

  const T* k_b = k + b * st.k[0] + hk * st.k[1];
  const T* v_b = v + b * st.v[0] + hk * st.v[1];
  for (int e = tid; e < kBwdBlock * DP; e += kBwdThreads) {
    const int r = e / DP, d = e % DP, f = row0 + r;
    float qx = 0.f, gx = 0.f;
    if (f < nrows && d < D) {
      const int i = f / group, h = hk * group + f % group;
      qx = load_f(q + b * st.q[0] + h * st.q[1] + i * st.q[2] + d * st.q[3]);
      gx = load_f(dout + b * st.dout[0] + h * st.dout[1] + i * st.dout[2] +
                  d * st.dout[3]);
    }
    q_s[e] = qx;
    do_s[e] = gx;
  }
  __syncthreads();

  const int rbase = warp * R;
  bool valid[R];
  int qpos[R];
  float m[R], l[R], dl[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    const int f = row0 + rbase + t;
    valid[t] = f < nrows;
    qpos[t] = f / group + q_off;
    m[t] = -INFINITY;
    l[t] = 0.f;
    // Delta = sum_d dO o: a lane per 32 columns, then the butterfly.
    float x = 0.f;
    if (valid[t]) {
      const T* orow = out + b * st.o[0] + (hk * group + f % group) * st.o[1] +
                      (f / group) * st.o[2];
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const int d = lane + 32 * c;
        if (d < D)
          x = fmaf(do_s[(rbase + t) * DP + d], load_f(orow + d * st.o[3]), x);
      }
    }
    dl[t] = warp_sum(x);
  }

  auto scores = [&](float (&s)[R]) {
#pragma unroll
    for (int t = 0; t < R; ++t) s[t] = 0.f;
    const float* kr = k_s + lane * (DP + 1);
    const float* qr = q_s + rbase * DP;
#pragma unroll 8
    for (int d = 0; d < DP; ++d) {
      const float kd = kr[d];
#pragma unroll
      for (int t = 0; t < R; ++t) s[t] = fmaf(qr[t * DP + d], kd, s[t]);
    }
  };

  // Pass 1: each row's max and sum over its live keys, log2 domain.
  for (int j0 = 0; j0 < key_end; j0 += kBwdTile) {
    __syncthreads();  // the previous tile fully consumed
    for (int e = tid; e < kBwdTile * DP; e += kBwdThreads) {
      const int kk = e / DP, d = e % DP, pos = j0 + kk;
      k_s[kk * (DP + 1) + d] =
          (pos < key_end && d < D) ? load_f(k_b + pos * st.k[2] + d * st.k[3])
                                   : 0.f;
    }
    __syncthreads();
    float s[R];
    scores(s);
    const int pos = j0 + lane;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const bool ok = valid[t] && pos < key_end && (!causal || pos <= qpos[t]);
      const float sc = ok ? s[t] * scale_log2 : -INFINITY;
      const float m_new = fmaxf(m[t], warp_max(sc));
      const float p = ok ? exp2f(sc - m_new) : 0.f;
      const float corr = (m[t] == -INFINITY) ? 0.f : exp2f(m[t] - m_new);
      l[t] = l[t] * corr + warp_sum(p);
      m[t] = m_new;
    }
  }
  float ls[R];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    ls[t] = l[t] > 0.f ? m[t] + log2f(l[t]) : INFINITY;
    if (valid[t] && lane == 0) {
      const int f = row0 + rbase + t;
      const int64_t idx =
          ((int64_t)b * Hq + hk * group + f % group) * Lq + f / group;
      lse[idx] = ls[t];
      delta[idx] = dl[t];
    }
  }

  // Pass 2: dQ over the key tiles in ascending order.
  float acc[R][DC];
#pragma unroll
  for (int t = 0; t < R; ++t)
#pragma unroll
    for (int c = 0; c < DC; ++c) acc[t][c] = 0.f;
  for (int j0 = 0; j0 < key_end; j0 += kBwdTile) {
    __syncthreads();
    for (int e = tid; e < kBwdTile * DP; e += kBwdThreads) {
      const int kk = e / DP, d = e % DP, pos = j0 + kk;
      float kx = 0.f, vx = 0.f;
      if (pos < key_end && d < D) {
        kx = load_f(k_b + pos * st.k[2] + d * st.k[3]);
        vx = load_f(v_b + pos * st.v[2] + d * st.v[3]);
      }
      k_s[kk * (DP + 1) + d] = kx;
      v_s[kk * (DP + 1) + d] = vx;
    }
    __syncthreads();
    float s[R], dp[R];
    scores(s);
#pragma unroll
    for (int t = 0; t < R; ++t) dp[t] = 0.f;
    {
      const float* vr = v_s + lane * (DP + 1);
      const float* gr = do_s + rbase * DP;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        const float vd = vr[d];
#pragma unroll
        for (int t = 0; t < R; ++t) dp[t] = fmaf(gr[t * DP + d], vd, dp[t]);
      }
    }
    const int pos = j0 + lane;
#pragma unroll
    for (int t = 0; t < R; ++t) {
      const bool ok = valid[t] && pos < key_end && (!causal || pos <= qpos[t]);
      const float p = ok ? exp2f(s[t] * scale_log2 - ls[t]) : 0.f;
      s[t] = p * (dp[t] - dl[t]);  // dS
    }
#pragma unroll 4
    for (int jj = 0; jj < kBwdTile; ++jj) {
      float dsj[R];
#pragma unroll
      for (int t = 0; t < R; ++t) dsj[t] = __shfl_sync(kFull, s[t], jj);
      const float* kr = k_s + jj * (DP + 1) + lane;
#pragma unroll
      for (int c = 0; c < DC; ++c) {
        const float kx = kr[32 * c];
#pragma unroll
        for (int t = 0; t < R; ++t) acc[t][c] = fmaf(dsj[t], kx, acc[t][c]);
      }
    }
  }

#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (!valid[t]) continue;
    const int f = row0 + rbase + t;
    T* o = dq + b * st.dq[0] + (hk * group + f % group) * st.dq[1] +
           (f / group) * st.dq[2];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) store_f(o + d * st.dq[3], acc[t][c] * scale);
    }
  }
}

template <typename T, int DC>
__global__ void __launch_bounds__(kBwdThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      T* __restrict__ dk, T* __restrict__ dv,
                      const float* __restrict__ lse,
                      const float* __restrict__ delta,
                      const int32_t* __restrict__ kv_len, BwdStrides st,
                      int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                      float scale_log2, float scale) {
  constexpr int DP = 32 * DC;
  constexpr int R = kBwdPerWarp;
  extern __shared__ float smem[];
  float* k_s = smem;                        // [kBwdBlock][DP]
  float* v_s = k_s + kBwdBlock * DP;        // [kBwdBlock][DP]
  float* q_s = v_s + kBwdBlock * DP;        // [kBwdTile][DP + 1]
  float* do_s = q_s + kBwdTile * (DP + 1);  // [kBwdTile][DP + 1]
  float* lse_s = do_s + kBwdTile * (DP + 1);
  float* dl_s = lse_s + kBwdTile;

  const int group = Hq / Hkv;
  const int key0 = blockIdx.x * kBwdBlock;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_off = Lk - Lq;

  int live = Lk;
  if (kv_len != nullptr) live = min(max(kv_len[b], 0), Lk);

  const T* k_b = k + b * st.k[0] + hk * st.k[1];
  const T* v_b = v + b * st.v[0] + hk * st.v[1];
  for (int e = tid; e < kBwdBlock * DP; e += kBwdThreads) {
    const int kk = e / DP, d = e % DP, pos = key0 + kk;
    float kx = 0.f, vx = 0.f;
    if (pos < live && d < D) {
      kx = load_f(k_b + pos * st.k[2] + d * st.k[3]);
      vx = load_f(v_b + pos * st.v[2] + d * st.v[3]);
    }
    k_s[e] = kx;
    v_s[e] = vx;
  }

  const int kbase = warp * R;
  int kpos[R];
  bool kvalid[R];
  float dka[R][DC], dva[R][DC];
#pragma unroll
  for (int t = 0; t < R; ++t) {
    kpos[t] = key0 + kbase + t;
    kvalid[t] = kpos[t] < live;
#pragma unroll
    for (int c = 0; c < DC; ++c) dka[t][c] = dva[t][c] = 0.f;
  }

  // The first query that sees a key of this CTA, bottom-right aligned; the
  // tiles before it are masked whole.
  const int i_first = causal ? max(0, key0 - q_off) : 0;
  const int i_start = key0 < live ? (i_first / kBwdTile) * kBwdTile : Lq;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const T* q_h = q + b * st.q[0] + h * st.q[1];
    const T* g_h = dout + b * st.dout[0] + h * st.dout[1];
    const int64_t row_base = ((int64_t)b * Hq + h) * Lq;
    for (int i0 = i_start; i0 < Lq; i0 += kBwdTile) {
      __syncthreads();  // K/V staged; the previous tile fully consumed
      for (int e = tid; e < kBwdTile * DP; e += kBwdThreads) {
        const int qq = e / DP, d = e % DP, i = i0 + qq;
        float qx = 0.f, gx = 0.f;
        if (i < Lq && d < D) {
          qx = load_f(q_h + i * st.q[2] + d * st.q[3]);
          gx = load_f(g_h + i * st.dout[2] + d * st.dout[3]);
        }
        q_s[qq * (DP + 1) + d] = qx;
        do_s[qq * (DP + 1) + d] = gx;
      }
      if (tid < kBwdTile) {
        const int i = i0 + tid;
        lse_s[tid] = i < Lq ? lse[row_base + i] : INFINITY;
        dl_s[tid] = i < Lq ? delta[row_base + i] : 0.f;
      }
      __syncthreads();

      // A query per lane against this warp's 8 keys.
      float s[R], dp[R];
#pragma unroll
      for (int t = 0; t < R; ++t) s[t] = dp[t] = 0.f;
      const float* qr = q_s + lane * (DP + 1);
      const float* gr = do_s + lane * (DP + 1);
      const float* kr = k_s + kbase * DP;
      const float* vr = v_s + kbase * DP;
#pragma unroll 8
      for (int d = 0; d < DP; ++d) {
        const float qd = qr[d], gd = gr[d];
#pragma unroll
        for (int t = 0; t < R; ++t) {
          s[t] = fmaf(qd, kr[t * DP + d], s[t]);
          dp[t] = fmaf(gd, vr[t * DP + d], dp[t]);
        }
      }
      const int i = i0 + lane;
      const float lse_i = lse_s[lane], dl_i = dl_s[lane];
#pragma unroll
      for (int t = 0; t < R; ++t) {
        const bool ok = kvalid[t] && i < Lq && (!causal || kpos[t] <= i + q_off);
        const float p = ok ? exp2f(s[t] * scale_log2 - lse_i) : 0.f;
        s[t] = p;
        dp[t] = p * (dp[t] - dl_i);  // dS
      }
#pragma unroll 4
      for (int jj = 0; jj < kBwdTile; ++jj) {
        float pj[R], dsj[R];
#pragma unroll
        for (int t = 0; t < R; ++t) {
          pj[t] = __shfl_sync(kFull, s[t], jj);
          dsj[t] = __shfl_sync(kFull, dp[t], jj);
        }
        const float* qx = q_s + jj * (DP + 1) + lane;
        const float* gx = do_s + jj * (DP + 1) + lane;
#pragma unroll
        for (int c = 0; c < DC; ++c) {
          const float qv = qx[32 * c], gv = gx[32 * c];
#pragma unroll
          for (int t = 0; t < R; ++t) {
            dva[t][c] = fmaf(pj[t], gv, dva[t][c]);
            dka[t][c] = fmaf(dsj[t], qv, dka[t][c]);
          }
        }
      }
    }
  }

#pragma unroll
  for (int t = 0; t < R; ++t) {
    if (kpos[t] >= Lk) continue;
    T* kr = dk + b * st.dk[0] + hk * st.dk[1] + kpos[t] * st.dk[2];
    T* vr = dv + b * st.dv[0] + hk * st.dv[1] + kpos[t] * st.dv[2];
#pragma unroll
    for (int c = 0; c < DC; ++c) {
      const int d = lane + 32 * c;
      if (d < D) {
        store_f(kr + d * st.dk[3], dka[t][c] * scale);
        store_f(vr + d * st.dv[3], dva[t][c]);
      }
    }
  }
}

struct BwdArgs {
  const void *q, *k, *v, *out, *dout;
  void *dq, *dk, *dv, *lse, *delta;
  const void* kv_len;
  BwdStrides st;
  int B, Hq, Hkv, Lq, Lk, D, causal;
  float scale;
};

template <typename T, int DC>
int launch_bwd(const BwdArgs& a, bool dkdv, cudaStream_t stream) {
  const size_t smem = bwd_smem_bytes<DC>();
  const float scale_log2 = a.scale * kLog2e;
  const int64_t n = dkdv ? (int64_t)a.Lk : (int64_t)a.Lq * (a.Hq / a.Hkv);
  if (n > 0x7fffffff - kBwdBlock) return (int)cudaErrorInvalidValue;
  const dim3 grid((unsigned)((n + kBwdBlock - 1) / kBwdBlock), (unsigned)a.Hkv,
                  (unsigned)a.B);
  if (dkdv) {
    auto kern = flash_bwd_dkdv_kernel<T, DC>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
        static_cast<T*>(a.dk), static_cast<T*>(a.dv),
        static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
        static_cast<const int32_t*>(a.kv_len), a.st, a.Hq, a.Hkv, a.Lq, a.Lk,
        a.D, a.causal, scale_log2, a.scale);
  } else {
    auto kern = flash_bwd_dq_kernel<T, DC>;
    const int e = allow_smem(kern, smem);
    if (e != 0) return e;
    kern<<<grid, kBwdThreads, smem, stream>>>(
        static_cast<const T*>(a.q), static_cast<const T*>(a.k),
        static_cast<const T*>(a.v), static_cast<const T*>(a.out),
        static_cast<const T*>(a.dout), static_cast<T*>(a.dq),
        static_cast<float*>(a.lse), static_cast<float*>(a.delta),
        static_cast<const int32_t*>(a.kv_len), a.st, a.Hq, a.Hkv, a.Lq, a.Lk,
        a.D, a.causal, scale_log2, a.scale);
  }
  return (int)cudaGetLastError();
}

template <typename T>
int launch_bwd_dc(const BwdArgs& a, bool dkdv, cudaStream_t stream) {
  if (a.D <= 32) return launch_bwd<T, 1>(a, dkdv, stream);
  if (a.D <= 64) return launch_bwd<T, 2>(a, dkdv, stream);
  if (a.D <= 128) return launch_bwd<T, 4>(a, dkdv, stream);
  return launch_bwd<T, 8>(a, dkdv, stream);
}

}  // namespace

// q/k/v/out device pointers with element strides given in `strides` (a host
// array of 16: q, k, v, out, each (b, h, l, d)); kv_len a device int32 (B,)
// array or null; dtype 0 = f32, 1 = bf16.

// The general kernel: any strides, any D <= 256.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, const void* kv_len,
                                   const int64_t* strides, int B, int Hq,
                                   int Hkv, int Lq, int Lk, int D, int causal,
                                   float scale, int dtype, void* stream) {
  if (!valid_dims(B, Hq, Hkv, Lq, Lk, D) || strides == nullptr ||
      (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st = unpack_strides(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_general_dc<float>(D, q, k, v, out, kv_len, st, B, Hq, Hkv,
                                    Lq, Lk, causal, scale, s);
  return launch_general_dc<__nv_bfloat16>(D, q, k, v, out, kv_len, st, B, Hq,
                                          Hkv, Lq, Lk, causal, scale, s);
}

// bf16 prefill on the tensor cores: D in {32, 64, 96, 128}, 16-byte aligned
// rows (base and strides), last dim contiguous.
extern "C" int flash_attention_prefill_bf16(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_len, const int64_t* strides, int B, int Hq, int Hkv, int Lq,
    int Lk, int D, int causal, float scale, void* stream) {
  if (!valid_dims(B, Hq, Hkv, Lq, Lk, D) || strides == nullptr ||
      !aligned16(q, strides, 2) || !aligned16(k, strides + 4, 2) ||
      !aligned16(v, strides + 8, 2) || !aligned16(out, strides + 12, 2)) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st = unpack_strides(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32:
      return launch_prefill<32>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                causal, scale, s);
    case 64:
      return launch_prefill<64>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                causal, scale, s);
    case 96:
      return launch_prefill<96>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                causal, scale, s);
    case 128:
      return launch_prefill<128>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                                 causal, scale, s);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// Split-key decode: Lq * (Hq / Hkv) <= 16, D a multiple of 16 bytes, rows
// 16-byte aligned; `split` keys per CTA; `part` an fp32 scratch of
// B * Hkv * ceil(Lk / split) * Lq * (Hq / Hkv) * (D + 2) floats; `counters`
// B * Hkv zeroed ints, left zeroed.  `out32` and `ml` both null, or both
// set: then the normalised output is also written in fp32 to `out32`
// (B, Hq, Lq, D) contiguous, and each row's max M (log2 domain) and sum L to
// `ml` (2, B, Hq, Lq); a row with no live key gets M = -inf, L = 0 and 0.
extern "C" int flash_attention_decode(
    const void* q, const void* k, const void* v, void* out,
    const void* kv_len, const int64_t* strides, int B, int Hq, int Hkv, int Lq,
    int Lk, int D, int causal, float scale, int dtype, int split, void* part,
    void* counters, void* out32, void* ml, void* stream) {
  const size_t esize = dtype == 0 ? 4 : 2;
  if (!valid_dims(B, Hq, Hkv, Lq, Lk, D) || strides == nullptr ||
      (dtype != 0 && dtype != 1) || Lq * (Hq / Hkv) > kDecMaxRows ||
      (D * esize) % 16 != 0 || split < 1 || split > kDecThreads ||
      part == nullptr || (out32 == nullptr) != (ml == nullptr) ||
      counters == nullptr || !aligned16(k, strides + 4, esize) ||
      !aligned16(v, strides + 8, esize) || strides[3] != 1) {
    return (int)cudaErrorInvalidValue;
  }
  const Strides st = unpack_strides(strides);
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_decode_d<float>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq,
                                  Lk, D, causal, scale, split, part, counters,
                                  out32, ml, s);
  return launch_decode_d<__nv_bfloat16>(q, k, v, out, kv_len, st, B, Hq, Hkv,
                                        Lq, Lk, D, causal, scale, split, part,
                                        counters, out32, ml, s);
}

// The backward: `strides` a host array of 32 (q, k, v, out, dout, dq, dk,
// dv, each (b, h, l, d)), any strides; `lse` and `delta` fp32 (B, Hq, Lq)
// scratch that the dq kernel writes and the dkdv kernel, launched after it
// on the same stream, reads.  dtype 0 = f32, 1 = bf16.
namespace {
int bwd_entry(const void* q, const void* k, const void* v, const void* out,
              const void* dout, void* dq, void* dk, void* dv, void* lse,
              void* delta, const void* kv_len, const int64_t* strides, int B,
              int Hq, int Hkv, int Lq, int Lk, int D, int causal, float scale,
              int dtype, bool dkdv, void* stream) {
  if (!valid_dims(B, Hq, Hkv, Lq, Lk, D) || strides == nullptr ||
      lse == nullptr || delta == nullptr || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  if (dkdv && Lk == 0) return 0;  // no key: nothing to write
  const BwdArgs a{q,   k,     v,      out,
                  dout, dq,   dk,     dv,
                  lse,  delta, kv_len, unpack_bwd_strides(strides),
                  B,    Hq,   Hkv,    Lq,
                  Lk,   D,    causal, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0) return launch_bwd_dc<float>(a, dkdv, s);
  return launch_bwd_dc<__nv_bfloat16>(a, dkdv, s);
}
}  // namespace

extern "C" int flash_attention_bwd_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* lse, void* delta, const void* kv_len,
    const int64_t* strides, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, float scale, int dtype, void* stream) {
  return bwd_entry(q, k, v, out, dout, dq, nullptr, nullptr, lse, delta,
                   kv_len, strides, B, Hq, Hkv, Lq, Lk, D, causal, scale,
                   dtype, false, stream);
}

extern "C" int flash_attention_bwd_dkdv(
    const void* q, const void* k, const void* v, const void* dout, void* dk,
    void* dv, const void* lse, const void* delta, const void* kv_len,
    const int64_t* strides, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, float scale, int dtype, void* stream) {
  return bwd_entry(q, k, v, nullptr, dout, nullptr, dk, dv,
                   const_cast<void*>(lse), const_cast<void*>(delta), kv_len,
                   strides, B, Hq, Hkv, Lq, Lk, D, causal, scale, dtype, true,
                   stream);
}
