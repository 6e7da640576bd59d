// Flash attention (blockwise online softmax, GQA-aware) for Hopper.
//
// Replaces the Pallas TPU kernel `flash_attention` of
// src/repro/kernels/flash_attention.py (pallas_call at line 117, body
// `_kernel` at lines 30-81).  For q (B, Hq, Lq, D), k/v (B, Hkv, Lk, D) and an
// optional kv_len (B,) it computes, for every query head h (kv head
// h / (Hq/Hkv)) and query row r at position r + Lk - Lq,
//
//   out[b, h, r] = sum_j p_j v[b, h_kv, j] / max(sum_j p_j, 1e-30),
//   p_j = exp(s_j - max s),  s_j = (scale * q[b, h, r]) . k[b, h_kv, j]
//
// over the keys j < kv_len[b] (and j <= r + Lk - Lq when causal); masked keys
// have p_j = 0, so a fully masked row gives 0.  Running max, sum and the
// output accumulator are fp32; inputs are f32 or bf16, read through explicit
// strides (the model passes (B, L, H, D) tensors and KV-cache slices as
// transposed views, with no copy).
//
// Design.  The TPU kernel walks a sequential kv grid axis and keeps its
// running max, sum and accumulator in VMEM scratch across it; CTAs have no
// order, so the kv loop runs inside the CTA with those in registers.  One CTA
// serves one (batch, kv head) and kRows = 32 rows of the flattened
// (query position, group head) space: every K/V tile staged in shared memory
// is read once for all query heads of the GQA group (the point of the TPU
// kernel's h // group index map), and in decode (Lq = 1) one CTA serves the
// whole group.  Each of the 8 warps owns 4 rows.  A tile holds 32 keys, one
// per lane: a lane computes the 4 rows' scores for its key from shared memory
// (k rows padded to DP + 1 floats, so the 32 lanes hit 32 banks), the warp
// reduces max and sum with shuffles in a fixed order, and then every lane
// accumulates its 32-column slices of the 4 output rows against the tile's v
// rows, with p broadcast by shuffle.  The loop stops at the CTA's causal
// diagonal and at kv_len, as the TPU kernel's pl.when does.  No atomics and
// no split-KV: the same inputs give the same bits run to run.
//
// Bound.  At the main path's shapes (prefill Lq = Lk <= 1024; decode Lq = 1
// against a 2048-position cache, B = 8, Hq/Hkv = 32/8, D = 64, bf16) the work
// is 4 * D flops per (query row, live key) and the bytes are q, the live K/V
// rows and the output: microseconds at the tensor-core rate and at HBM rate.
// This first version uses CUDA-core fmaf and loads each tile without overlap,
// so it is latency-bound far above that bound; wgmma, TMA staging and warp
// specialisation are later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kRowsPerWarp = 4;
constexpr int kRows = kWarps * kRowsPerWarp;  // query rows per CTA
constexpr int kKeys = 32;                     // keys per tile, one per lane
constexpr unsigned kFull = 0xffffffffu;

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
int launch(const void* q, const void* k, const void* v, void* out,
           const void* kv_len, const Strides& st, int B, int Hq, int Hkv,
           int Lq, int Lk, int D, int causal, float scale,
           cudaStream_t stream) {
  constexpr int DP = 32 * DC;
  const size_t smem =
      (size_t)(kRows * DP + kKeys * (DP + 1) + kKeys * DP) * sizeof(float);
  auto kern = flash_attention_kernel<T, DC>;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
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
int launch_dc(int D, const void* q, const void* k, const void* v, void* out,
              const void* kv_len, const Strides& st, int B, int Hq, int Hkv,
              int Lq, int Lk, int causal, float scale, cudaStream_t stream) {
  if (D <= 32)
    return launch<T, 1>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk, D,
                        causal, scale, stream);
  if (D <= 64)
    return launch<T, 2>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk, D,
                        causal, scale, stream);
  if (D <= 128)
    return launch<T, 4>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk, D,
                        causal, scale, stream);
  return launch<T, 8>(q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk, D, causal,
                      scale, stream);
}

}  // namespace

// q/k/v/out device pointers with element strides given in `strides` (a host
// array of 16: q, k, v, out, each (b, h, l, d)); kv_len a device int32 (B,)
// array or null; dtype 0 = f32, 1 = bf16.  Launches on `stream` and returns
// the launch's cudaError_t.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* out, const void* kv_len,
                                   const int64_t* strides, int B, int Hq,
                                   int Hkv, int Lq, int Lk, int D, int causal,
                                   float scale, int dtype, void* stream) {
  if (B < 1 || B > 65535 || Hkv < 1 || Hkv > 65535 || Hq < 1 ||
      Hq % Hkv != 0 || Lq < 1 || Lk < 0 || D < 1 || D > 256 ||
      strides == nullptr || (dtype != 0 && dtype != 1)) {
    return (int)cudaErrorInvalidValue;
  }
  Strides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = strides[i];
    st.k[i] = strides[4 + i];
    st.v[i] = strides[8 + i];
    st.o[i] = strides[12 + i];
  }
  const cudaStream_t s = (cudaStream_t)stream;
  if (dtype == 0)
    return launch_dc<float>(D, q, k, v, out, kv_len, st, B, Hq, Hkv, Lq, Lk,
                            causal, scale, s);
  return launch_dc<__nv_bfloat16>(D, q, k, v, out, kv_len, st, B, Hq, Hkv, Lq,
                                  Lk, causal, scale, s);
}
