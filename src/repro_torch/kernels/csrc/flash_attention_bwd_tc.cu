// K2's backward on the tensor cores: bf16 in, fp32 accumulation, for the
// head dims of the tensor-core prefill (D in {32, 64, 96, 128}) and 16-byte
// aligned rows.  The other calls (fp32, other head dims, unaligned views)
// take the CUDA-core backward of flash_attention.cu; the wrapper
// (repro_torch/kernels/flash_attention.py::backward_path) picks by dtype,
// head dim and strides alone.
//
// The reference has no backward kernel: it trains attention in plain jnp
// (src/repro/models/common.py, chunked_attention / full_attention) and puts
// no custom_vjp on its Pallas call (src/repro/kernels/flash_attention.py,
// pallas_call at line 117).  So the two kernels follow the flash-attention
// backward's formulas with the forward's semantics: scores in the log2
// domain (times scale log2 e), bottom-right causal alignment (query row r
// sits at position r + Lk - Lq), the kv_len mask, P = 0 on masked keys, and
// on a row with no live key LSE = +inf and a zero gradient, never NaN.
//
//   P = exp2(S - LSE), dP = dO V^T, Delta = rowsum(dO o), dS = P (dP - Delta)
//   dQ = scale dS K,  dK = scale dS^T Q,  dV = P^T dO
//
// dK and dV are summed over the GQA group.  Every product is
// mma.sync.m16n8k16 bf16 -> fp32 with the forward's fragment patterns (the
// m16n8 accumulator layout is the m16n8k16 A layout, so P and dS feed the
// next product from registers, rounded to bf16 there):
//
// * flash_bwd_dq_tc_kernel<D>: the prefill's grid and row mapping.  A CTA
//   of 4 warps takes 64 rows of the flattened (position, group head) space,
//   group head fastest, so one staged K/V tile serves every query head of
//   the group; each warp owns 16 rows.  Q and dO are staged once; 64-key
//   K/V tiles stream through a 2-stage cp.async ring with rows padded by 16
//   bytes (ldmatrix free of bank conflicts).  Pass 1 computes S = Q K^T
//   with a running max and sum and writes LSE = m + log2 l and Delta to
//   the fp32 (B, Hq, Lq) scratch; pass 2 walks the tiles again in
//   ascending order: S and dP = dO V^T (V as the B operand like K), dS in
//   registers, dQ += dS K (K through ldmatrix.trans, like V in P V).
// * flash_bwd_dkdv_tc_kernel<D>, launched after it on the same stream: a
//   CTA of 4 warps takes 64 keys of one (batch, kv head), 16 a warp.  For
//   each query head of the group in order, then each 64-row Q/dO tile in
//   ascending order (with its LSE and Delta, through a 2-stage cp.async
//   ring): S^T = K Q^T, P^T = exp2(S^T - LSE[col]), dP^T = V dO^T,
//   dS^T = P^T (dP^T - Delta[col]), dV += P^T dO, dK += dS^T Q (dO and Q
//   through ldmatrix.trans).  dK and dV stay in registers across the whole
//   group and every tile, and each element is written once from sums in a
//   fixed order: no atomics, so a launch repeats bit for bit (and GQA's
//   group sum needs no second pass).
//
// Both skip the tiles wholly above a warp's causal diagonal or past kv_len
// and mask only the tiles the diagonal, kv_len or the end of the rows
// crosses; both grids put the blocks with the most causal work first.  A
// dkdv CTA whose keys all lie at or past kv_len still writes its zeros.
//
// Bound by operations: the bound counts 10 D flops per (query row, live
// key) on the tensor cores (five products); the dq kernel runs four
// products (Q K^T twice, dO V^T, dS K) and the dkdv kernel four (K Q^T,
// V dO^T, P^T dO, dS^T Q), 8/5 of the bound's work.  Up to D = 64 the
// warps' A fragments (Q and dO here, K and V there) stay in registers
// across tiles; above, they are reloaded from shared memory per k-step to
// keep the accumulators out of local memory.
//
// Both entry points launch on the given stream and return the launch's
// cudaError_t.

#include <math.h>

#include "flash_common.cuh"

namespace {

using bf16 = __nv_bfloat16;

template <int D>
struct BwdTcShape {
  static constexpr int kThreads = 128;  // 4 warps, 16 rows or keys each
  static constexpr int kBlock = 64;     // rows (dq) or keys (dkdv) per CTA
  static constexpr int kTile = 64;      // keys (dq) or rows (dkdv) per tile
  static constexpr int LD = D + 8;      // padded shared row
  static constexpr bool kHold = D <= 64;
  // Q, dO [kBlock][LD]; two stages of K, V [kTile][LD].
  static constexpr size_t kSmemDq =
      (size_t)(2 * kBlock + 4 * kTile) * LD * sizeof(bf16);
  // K, V [kBlock][LD]; two stages of Q, dO [kTile][LD], LSE, Delta [kTile].
  static constexpr size_t kSmemDkdv = kSmemDq + 4 * kTile * sizeof(float);
};

// The A fragment (16 x 16) of a row-major [row][LD] tile at (r0, c0).
template <int LD>
__device__ __forceinline__ void load_a(uint32_t (&a)[4], const bf16* s,
                                       int r0, int c0, int lane) {
  ldmatrix_x4(a, s + (r0 + (lane % 8) + ((lane / 8) & 1) * 8) * LD + c0 +
                     (lane / 16) * 8);
}

// acc (16 x 64) = A (16 x D) B^T, B's 64 rows [n][LD] in shared memory
// (the forward's K in Q K^T).  a(kd, frag) gives the A fragment of k-step
// kd.  A k-step's B fragments are all loaded before its products.
template <int D, typename AFrag>
__device__ __forceinline__ void mma_rows(float (&acc)[8][4], AFrag a,
                                         const bf16* bs, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kd = 0; kd < D / 16; ++kd) {
    uint32_t af[4], b[4][4];
    a(kd, af);
#pragma unroll
    for (int np = 0; np < 4; ++np)
      ldmatrix_x4(b[np], bs + (np * 16 + (lane % 8) + (lane / 16) * 8) * LD +
                             kd * 16 + ((lane / 8) & 1) * 8);
#pragma unroll
    for (int np = 0; np < 4; ++np) {
      mma_bf16(acc[2 * np], af, b[np][0], b[np][1]);
      mma_bf16(acc[2 * np + 1], af, b[np][2], b[np][3]);
    }
  }
}

// acc (16 x D) += X (16 x 64, fp32 accumulators rounded to bf16 here) B,
// B's 64 rows [k][LD] in shared memory through ldmatrix.trans (the
// forward's P V).
template <int D>
__device__ __forceinline__ void mma_cols(float (&acc)[D / 8][4],
                                         const float (&x)[8][4],
                                         const bf16* bs, int lane) {
  constexpr int LD = D + 8;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    const uint32_t xa[4] = {pack_bf16(x[2 * kk][0], x[2 * kk][1]),
                            pack_bf16(x[2 * kk][2], x[2 * kk][3]),
                            pack_bf16(x[2 * kk + 1][0], x[2 * kk + 1][1]),
                            pack_bf16(x[2 * kk + 1][2], x[2 * kk + 1][3])};
#pragma unroll
    for (int np = 0; np < D / 16; ++np) {
      uint32_t b[4];
      ldmatrix_x4_trans(b, bs + (kk * 16 + (lane % 8) + ((lane / 8) & 1) * 8) *
                                    LD + np * 16 + (lane / 16) * 8);
      mma_bf16(acc[2 * np], xa, b[0], b[1]);
      mma_bf16(acc[2 * np + 1], xa, b[2], b[3]);
    }
  }
}

template <int N>
__device__ __forceinline__ void zero(float (&x)[N][4]) {
#pragma unroll
  for (int n = 0; n < N; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) x[n][c] = 0.f;
}

// ==================================================================== dQ
template <int D>
__global__ void __launch_bounds__(BwdTcShape<D>::kThreads)
flash_bwd_dq_tc_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                       const bf16* __restrict__ v,
                       const bf16* __restrict__ out,
                       const bf16* __restrict__ dout, bf16* __restrict__ dq,
                       float* __restrict__ lse, float* __restrict__ delta,
                       const int32_t* __restrict__ kv_len, BwdStrides st,
                       int Hq, int Hkv, int B, int Lq, int Lk, int causal,
                       float scale_log2, float scale) {
  using Shape = BwdTcShape<D>;
  constexpr int kThreads = Shape::kThreads;
  constexpr int kRows = Shape::kBlock;
  constexpr int kKeys = Shape::kTile;
  constexpr int LD = Shape::LD;
  constexpr int CH = D / 8;   // 16-byte chunks per row
  constexpr int KD = D / 16;  // k-steps over the head dim
  constexpr int NO = D / 8;   // n-tiles of dQ
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_raw);  // [kRows][LD]
  bf16* do_s = q_s + kRows * LD;                  // [kRows][LD]
  bf16* k_s = do_s + kRows * LD;                  // [stage][key][LD]
  bf16* v_s = k_s + 2 * kKeys * LD;               // [stage][key][LD]

  const int group = Hq / Hkv;
  const int nrows = Lq * group;
  // A 1-D grid in order of causal work, as the prefill's: the last row
  // block of every (batch, kv head) first.
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

  const bf16* k_b = k + b * st.k[0] + hk * st.k[1];
  const bf16* v_b = v + b * st.v[0] + hk * st.v[1];
  for (int e = tid; e < kRows * CH; e += kThreads) {
    const int r = e / CH, c = e % CH, f = row0 + r;
    const bool ok = f < nrows;
    int64_t qo = 0, go = 0;
    if (ok) {
      const int64_t h = hk * group + f % group, i = f / group;
      qo = b * st.q[0] + h * st.q[1] + i * st.q[2] + c * 8;
      go = b * st.dout[0] + h * st.dout[1] + i * st.dout[2] + c * 8;
    }
    cp_async16(q_s + r * LD + c * 8, q + qo, ok);
    cp_async16(do_s + r * LD + c * 8, dout + go, ok);
  }
  // Keys at or past key_end are zero-filled: their P and dS are 0, and
  // 0 * K must not meet stale bits.
  auto load_kv = [&](int tile, bool with_v) {
    bf16* kd = k_s + (tile & 1) * kKeys * LD;
    bf16* vd = v_s + (tile & 1) * kKeys * LD;
    for (int e = tid; e < kKeys * CH; e += kThreads) {
      const int kk = e / CH, c = e % CH, pos = tile * kKeys + kk;
      const bool ok = pos < key_end;
      cp_async16(kd + kk * LD + c * 8,
                 k_b + (ok ? (int64_t)pos * st.k[2] + c * 8 : 0), ok);
      if (with_v)
        cp_async16(vd + kk * LD + c * 8,
                   v_b + (ok ? (int64_t)pos * st.v[2] + c * 8 : 0), ok);
    }
  };

  // This warp's 16 rows; this thread holds rows lane / 4 and lane / 4 + 8
  // of every accumulator, and the keys each may see.
  const int wrow0 = row0 + warp * 16;
  const int wr = warp * 16;  // the warp's first row in q_s / do_s
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

  uint32_t qf[Shape::kHold ? KD : 1][4], gf[Shape::kHold ? KD : 1][4];
  auto q_frag = [&](int kd, uint32_t(&a)[4]) {
    if constexpr (Shape::kHold) {
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = qf[kd][c];
    } else {
      load_a<LD>(a, q_s, wr, kd * 16, lane);
    }
  };
  auto do_frag = [&](int kd, uint32_t(&a)[4]) {
    if constexpr (Shape::kHold) {
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = gf[kd][c];
    } else {
      load_a<LD>(a, do_s, wr, kd * 16, lane);
    }
  };
  // Scores of one tile in the log2 domain, masked to -inf where the
  // diagonal or kv_len crosses it.
  auto scores = [&](float (&s)[8][4], const bf16* ks, int k0) {
    zero(s);
    mma_rows<D>(s, q_frag, ks, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] *= scale_log2;
    if (k0 + kKeys > warp_full) {
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          const int key = k0 + n * 8 + 2 * (lane % 4) + (c & 1);
          if (key >= lim[c >> 1]) s[n][c] = -INFINITY;
        }
    }
  };

  // ---- Pass 1: each row's max and sum over its live keys.
  float m[2] = {-INFINITY, -INFINITY}, l[2] = {0.f, 0.f};
  if (ntiles > 0) load_kv(0, false);
  cp_async_commit();  // group 0: Q, dO and tile 0
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();  // tile j (and Q, dO) have landed
    // Every warp is past tile j - 1, whose stage the next load refills.
    __syncthreads();
    if (j + 1 < ntiles) load_kv(j + 1, false);
    cp_async_commit();
    if constexpr (Shape::kHold) {
      if (j == 0 && warp_active) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) load_a<LD>(qf[kd], q_s, wr, kd * 16,
                                                   lane);
      }
    }
    const int k0 = j * kKeys;
    if (!warp_active || k0 >= warp_end) continue;
    float s[8][4];
    scores(s, k_s + (j & 1) * kKeys * LD, k0);
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float mx = -INFINITY;
#pragma unroll
      for (int n = 0; n < 8; ++n)
        mx = fmaxf(mx, fmaxf(s[n][2 * h], s[n][2 * h + 1]));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 1));
      mx = fmaxf(mx, __shfl_xor_sync(kFull, mx, 2));
      const float m_new = fmaxf(m[h], mx);
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      float sum = 0.f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        sum += exp2_approx(s[n][2 * h] - m_use);
        sum += exp2_approx(s[n][2 * h + 1] - m_use);
      }
      l[h] = l[h] * exp2_approx(m[h] - m_use) + sum;
      m[h] = m_new;
    }
  }
  cp_async_wait<0>();
  __syncthreads();  // Q and dO have landed even when no tile ran; stages free

  // LSE = m + log2 l (+inf on a row with no live key) and Delta = sum dO o
  // for rows lane / 4 and lane / 4 + 8: the quad's 4 lanes split the row's
  // 16-byte chunks, then reduce in a fixed order.
  float ls[2], dl[2];
  if (warp_active) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      float lh = l[h];
      lh += __shfl_xor_sync(kFull, lh, 1);
      lh += __shfl_xor_sync(kFull, lh, 2);
      ls[h] = lh > 0.f ? m[h] + log2f(lh) : INFINITY;
      const int r = lane / 4 + 8 * h, f = wrow0 + r;
      float x = 0.f;
      if (f < nrows) {
        const bf16* orow = out + b * st.o[0] +
                           (int64_t)(hk * group + f % group) * st.o[1] +
                           (int64_t)(f / group) * st.o[2];
        for (int c = lane % 4; c < CH; c += 4) {
          const uint4 ov = *reinterpret_cast<const uint4*>(orow + c * 8);
          const uint4 gv =
              *reinterpret_cast<const uint4*>(do_s + (wr + r) * LD + c * 8);
          const __nv_bfloat162* o2 =
              reinterpret_cast<const __nv_bfloat162*>(&ov);
          const __nv_bfloat162* g2 =
              reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float2 of = __bfloat1622float2(o2[u]);
            const float2 gf2 = __bfloat1622float2(g2[u]);
            x = fmaf(gf2.x, of.x, x);
            x = fmaf(gf2.y, of.y, x);
          }
        }
      }
      x += __shfl_xor_sync(kFull, x, 1);
      x += __shfl_xor_sync(kFull, x, 2);
      dl[h] = x;
      if (f < nrows && lane % 4 == 0) {
        const int64_t idx =
            ((int64_t)b * Hq + hk * group + f % group) * Lq + f / group;
        lse[idx] = ls[h];
        delta[idx] = dl[h];
      }
    }
    if constexpr (Shape::kHold) {
#pragma unroll
      for (int kd = 0; kd < KD; ++kd)
        load_a<LD>(gf[kd], do_s, wr, kd * 16, lane);
    }
  }

  // ---- Pass 2: dQ over the key tiles in ascending order.
  float acc[NO][4];
  zero(acc);
  if (ntiles > 0) load_kv(0, true);
  cp_async_commit();
  for (int j = 0; j < ntiles; ++j) {
    cp_async_wait<0>();
    __syncthreads();
    if (j + 1 < ntiles) load_kv(j + 1, true);
    cp_async_commit();
    const int k0 = j * kKeys;
    if (!warp_active || k0 >= warp_end) continue;
    const bf16* ks = k_s + (j & 1) * kKeys * LD;
    const bf16* vs = v_s + (j & 1) * kKeys * LD;
    float s[8][4], dp[8][4];
    scores(s, ks, k0);
    zero(dp);
    mma_rows<D>(dp, do_frag, vs, lane);
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int h = c >> 1;
        const float p = exp2_approx(s[n][c] - ls[h]);  // masked: -inf -> 0
        s[n][c] = p * (dp[n][c] - dl[h]);              // dS
      }
    mma_cols<D>(acc, s, ks, lane);
  }
  cp_async_wait<0>();

  if (!warp_active) return;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int f = wrow0 + lane / 4 + 8 * h;
    if (f >= nrows) continue;
    bf16* row = dq + b * st.dq[0] +
                (int64_t)(hk * group + f % group) * st.dq[1] +
                (int64_t)(f / group) * st.dq[2];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(row + d) = __floats2bfloat162_rn(
          acc[n][2 * h] * scale, acc[n][2 * h + 1] * scale);
    }
  }
}

// ============================================================== dK and dV
template <int D>
__global__ void __launch_bounds__(BwdTcShape<D>::kThreads)
flash_bwd_dkdv_tc_kernel(const bf16* __restrict__ q,
                         const bf16* __restrict__ k,
                         const bf16* __restrict__ v,
                         const bf16* __restrict__ dout, bf16* __restrict__ dk,
                         bf16* __restrict__ dv, const float* __restrict__ lse,
                         const float* __restrict__ delta,
                         const int32_t* __restrict__ kv_len, BwdStrides st,
                         int Hq, int Hkv, int B, int Lq, int Lk, int causal,
                         float scale_log2, float scale) {
  using Shape = BwdTcShape<D>;
  constexpr int kThreads = Shape::kThreads;
  constexpr int kKeys = Shape::kBlock;
  constexpr int kRows = Shape::kTile;
  constexpr int LD = Shape::LD;
  constexpr int CH = D / 8;
  constexpr int KD = D / 16;
  constexpr int NO = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_raw);  // [kKeys][LD]
  bf16* v_s = k_s + kKeys * LD;                   // [kKeys][LD]
  bf16* q_s = v_s + kKeys * LD;                   // [stage][row][LD]
  bf16* do_s = q_s + 2 * kRows * LD;              // [stage][row][LD]
  float* lse_s = reinterpret_cast<float*>(do_s + 2 * kRows * LD);  // [2][64]
  float* dl_s = lse_s + 2 * kRows;                                 // [2][64]

  const int group = Hq / Hkv;
  // Key block 0 first: under causality it sees the most rows.
  const int heads = Hkv * B;
  const int key0 = (int)(blockIdx.x / heads) * kKeys;
  const int hk = (int)(blockIdx.x % heads) % Hkv;
  const int b = (int)(blockIdx.x % heads) / Hkv;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;
  const int q_off = Lk - Lq;

  int live = Lk;
  if (kv_len != nullptr) live = min(max(kv_len[b], 0), Lk);

  // K and V rows at or past kv_len are zero-filled (their P is masked).
  const bf16* k_b = k + b * st.k[0] + hk * st.k[1];
  const bf16* v_b = v + b * st.v[0] + hk * st.v[1];
  for (int e = tid; e < kKeys * CH; e += kThreads) {
    const int kk = e / CH, c = e % CH, pos = key0 + kk;
    const bool ok = pos < live;
    cp_async16(k_s + kk * LD + c * 8,
               k_b + (ok ? (int64_t)pos * st.k[2] + c * 8 : 0), ok);
    cp_async16(v_s + kk * LD + c * 8,
               v_b + (ok ? (int64_t)pos * st.v[2] + c * 8 : 0), ok);
  }

  // The first row that sees a key of this CTA, bottom-right aligned; the
  // tiles before it are masked whole.  Tiles start at multiples of 64.
  const int i_first = causal ? max(0, key0 - q_off) : 0;
  const int i_start = key0 < live ? (i_first / kRows) * kRows : Lq;
  const int ntq = i_start < Lq ? (Lq - i_start + kRows - 1) / kRows : 0;
  const int ntiles = group * ntq;  // (group head, row tile), in that order

  auto load_q = [&](int t) {
    const int h = hk * group + t / ntq;
    const int i0 = i_start + (t % ntq) * kRows;
    const int stage = t & 1;
    const bf16* q_h = q + b * st.q[0] + h * st.q[1];
    const bf16* g_h = dout + b * st.dout[0] + h * st.dout[1];
    bf16* qd = q_s + stage * kRows * LD;
    bf16* gd = do_s + stage * kRows * LD;
    for (int e = tid; e < kRows * CH; e += kThreads) {
      const int r = e / CH, c = e % CH, i = i0 + r;
      const bool ok = i < Lq;
      cp_async16(qd + r * LD + c * 8,
                 q_h + (ok ? (int64_t)i * st.q[2] + c * 8 : 0), ok);
      cp_async16(gd + r * LD + c * 8,
                 g_h + (ok ? (int64_t)i * st.dout[2] + c * 8 : 0), ok);
    }
    if (tid < kRows) {
      const int i = i0 + tid;
      const bool ok = i < Lq;
      const int64_t idx = ((int64_t)b * Hq + h) * Lq + (ok ? i : 0);
      cp_async4(lse_s + stage * kRows + tid, lse + idx, ok);
      cp_async4(dl_s + stage * kRows + tid, delta + idx, ok);
    }
  };

  // This warp's 16 keys; this thread holds keys lane / 4 and lane / 4 + 8
  // of every accumulator (rows), the query rows along the columns.
  const int kw0 = key0 + warp * 16;
  const int wk = warp * 16;  // the warp's first row in k_s / v_s
  const bool warp_active = kw0 < live;
  int kp[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) kp[h] = kw0 + lane / 4 + 8 * h;

  uint32_t kf[Shape::kHold ? KD : 1][4], vf[Shape::kHold ? KD : 1][4];
  auto k_frag = [&](int kd, uint32_t(&a)[4]) {
    if constexpr (Shape::kHold) {
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = kf[kd][c];
    } else {
      load_a<LD>(a, k_s, wk, kd * 16, lane);
    }
  };
  auto v_frag = [&](int kd, uint32_t(&a)[4]) {
    if constexpr (Shape::kHold) {
#pragma unroll
      for (int c = 0; c < 4; ++c) a[c] = vf[kd][c];
    } else {
      load_a<LD>(a, v_s, wk, kd * 16, lane);
    }
  };

  float dka[NO][4], dva[NO][4];
  zero(dka);
  zero(dva);
  if (ntiles > 0) load_q(0);
  cp_async_commit();  // group 0: K, V and tile 0
  for (int t = 0; t < ntiles; ++t) {
    cp_async_wait<0>();  // tile t (and K, V) have landed
    // Every warp is past tile t - 1, whose stage the next load refills.
    __syncthreads();
    if (t + 1 < ntiles) load_q(t + 1);
    cp_async_commit();
    if constexpr (Shape::kHold) {
      if (t == 0 && warp_active) {
#pragma unroll
        for (int kd = 0; kd < KD; ++kd) {
          load_a<LD>(kf[kd], k_s, wk, kd * 16, lane);
          load_a<LD>(vf[kd], v_s, wk, kd * 16, lane);
        }
      }
    }
    if (!warp_active) continue;
    const int i0 = i_start + (t % ntq) * kRows;
    const int i_last = min(i0 + kRows, Lq) - 1;
    if (causal && kw0 > i_last + q_off) continue;  // masked whole
    const bool full = kw0 + 15 < live && i0 + kRows <= Lq &&
                      (!causal || kw0 + 15 <= i0 + q_off);
    const int stage = t & 1;
    const bf16* qs = q_s + stage * kRows * LD;
    const bf16* gs = do_s + stage * kRows * LD;
    const float* lt = lse_s + stage * kRows;
    const float* dt = dl_s + stage * kRows;

    float s[8][4], dp[8][4];
    zero(s);
    zero(dp);
    mma_rows<D>(s, k_frag, qs, lane);   // S^T = K Q^T
    mma_rows<D>(dp, v_frag, gs, lane);  // dP^T = V dO^T
#pragma unroll
    for (int n = 0; n < 8; ++n) {
      const int col = n * 8 + 2 * (lane % 4);
      const float2 lc = *reinterpret_cast<const float2*>(lt + col);
      const float2 dc = *reinterpret_cast<const float2*>(dt + col);
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float lse_c = (c & 1) ? lc.y : lc.x;
        const float dl_c = (c & 1) ? dc.y : dc.x;
        float p = exp2_approx(s[n][c] * scale_log2 - lse_c);
        if (!full) {
          const int i = i0 + col + (c & 1), key = kp[c >> 1];
          if (key >= live || i >= Lq || (causal && key > i + q_off)) p = 0.f;
        }
        s[n][c] = p;                     // P^T
        dp[n][c] = p * (dp[n][c] - dl_c);  // dS^T
      }
    }
    mma_cols<D>(dva, s, gs, lane);   // dV += P^T dO
    mma_cols<D>(dka, dp, qs, lane);  // dK += dS^T Q
  }
  cp_async_wait<0>();

  // Every key of the block below Lk is written, zeros past kv_len.
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (kp[h] >= Lk) continue;
    bf16* kr = dk + b * st.dk[0] + hk * st.dk[1] + (int64_t)kp[h] * st.dk[2];
    bf16* vr = dv + b * st.dv[0] + hk * st.dv[1] + (int64_t)kp[h] * st.dv[2];
#pragma unroll
    for (int n = 0; n < NO; ++n) {
      const int d = n * 8 + 2 * (lane % 4);
      *reinterpret_cast<__nv_bfloat162*>(kr + d) = __floats2bfloat162_rn(
          dka[n][2 * h] * scale, dka[n][2 * h + 1] * scale);
      *reinterpret_cast<__nv_bfloat162*>(vr + d) =
          __floats2bfloat162_rn(dva[n][2 * h], dva[n][2 * h + 1]);
    }
  }
}

struct BwdTcArgs {
  const bf16 *q, *k, *v, *out, *dout;
  bf16 *dq, *dk, *dv;
  float *lse, *delta;
  const int32_t* kv_len;
  BwdStrides st;
  int B, Hq, Hkv, Lq, Lk, causal;
  float scale;
};

template <int D>
int launch_bwd_tc(const BwdTcArgs& a, bool dkdv, cudaStream_t stream) {
  using Shape = BwdTcShape<D>;
  const int64_t n = dkdv ? (int64_t)a.Lk : (int64_t)a.Lq * (a.Hq / a.Hkv);
  const int64_t blocks =
      (n + Shape::kBlock - 1) / Shape::kBlock * (int64_t)a.Hkv * a.B;
  if (n > 0x7fffffff - Shape::kBlock || blocks > 0x7fffffff)
    return (int)cudaErrorInvalidValue;
  const float scale_log2 = a.scale * kLog2e;
  if (dkdv) {
    auto kern = flash_bwd_dkdv_tc_kernel<D>;
    const int e = allow_smem(kern, Shape::kSmemDkdv);
    if (e != 0) return e;
    kern<<<(unsigned)blocks, Shape::kThreads, Shape::kSmemDkdv, stream>>>(
        a.q, a.k, a.v, a.dout, a.dk, a.dv, a.lse, a.delta, a.kv_len, a.st,
        a.Hq, a.Hkv, a.B, a.Lq, a.Lk, a.causal, scale_log2, a.scale);
  } else {
    auto kern = flash_bwd_dq_tc_kernel<D>;
    const int e = allow_smem(kern, Shape::kSmemDq);
    if (e != 0) return e;
    kern<<<(unsigned)blocks, Shape::kThreads, Shape::kSmemDq, stream>>>(
        a.q, a.k, a.v, a.out, a.dout, a.dq, a.lse, a.delta, a.kv_len, a.st,
        a.Hq, a.Hkv, a.B, a.Lq, a.Lk, a.causal, scale_log2, a.scale);
  }
  return (int)cudaGetLastError();
}

int bwd_tc_entry(const void* q, const void* k, const void* v, const void* out,
                 const void* dout, void* dq, void* dk, void* dv, void* lse,
                 void* delta, const void* kv_len, const int64_t* strides,
                 int B, int Hq, int Hkv, int Lq, int Lk, int D, int causal,
                 float scale, bool dkdv, void* stream) {
  if (!valid_dims(B, Hq, Hkv, Lq, Lk, D) || strides == nullptr ||
      lse == nullptr || delta == nullptr)
    return (int)cudaErrorInvalidValue;
  // Every tensor the kernel reads or writes: 16-byte rows, last dim
  // contiguous (out and dq only for dq, dk and dv only for dkdv).
  const void* ptrs[8] = {q, k, v, out, dout, dq, dk, dv};
  for (int i = 0; i < 8; ++i) {
    const bool used = dkdv ? (i != 3 && i != 5) : (i != 6 && i != 7);
    if (used && (ptrs[i] == nullptr || !aligned16(ptrs[i], strides + 4 * i, 2)))
      return (int)cudaErrorInvalidValue;
  }
  if (dkdv && Lk == 0) return 0;  // no key: nothing to write
  const BwdTcArgs a{static_cast<const bf16*>(q),
                    static_cast<const bf16*>(k),
                    static_cast<const bf16*>(v),
                    static_cast<const bf16*>(out),
                    static_cast<const bf16*>(dout),
                    static_cast<bf16*>(dq),
                    static_cast<bf16*>(dk),
                    static_cast<bf16*>(dv),
                    static_cast<float*>(lse),
                    static_cast<float*>(delta),
                    static_cast<const int32_t*>(kv_len),
                    unpack_bwd_strides(strides),
                    B, Hq, Hkv, Lq, Lk, causal, scale};
  const cudaStream_t s = (cudaStream_t)stream;
  switch (D) {
    case 32: return launch_bwd_tc<32>(a, dkdv, s);
    case 64: return launch_bwd_tc<64>(a, dkdv, s);
    case 96: return launch_bwd_tc<96>(a, dkdv, s);
    case 128: return launch_bwd_tc<128>(a, dkdv, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// bf16 q, k, v, out, dout (and dq, dk, dv) with element strides in
// `strides` (a host array of 32: q, k, v, out, dout, dq, dk, dv, each
// (b, h, l, d)), 16-byte aligned rows; D in {32, 64, 96, 128}; `lse` and
// `delta` fp32 (B, Hq, Lq) scratch that the dq kernel writes and the dkdv
// kernel, launched after it on the same stream, reads.
extern "C" int flash_attention_bwd_tc_dq(
    const void* q, const void* k, const void* v, const void* out,
    const void* dout, void* dq, void* lse, void* delta, const void* kv_len,
    const int64_t* strides, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, float scale, void* stream) {
  return bwd_tc_entry(q, k, v, out, dout, dq, nullptr, nullptr, lse, delta,
                      kv_len, strides, B, Hq, Hkv, Lq, Lk, D, causal, scale,
                      false, stream);
}

extern "C" int flash_attention_bwd_tc_dkdv(
    const void* q, const void* k, const void* v, const void* dout, void* dk,
    void* dv, const void* lse, const void* delta, const void* kv_len,
    const int64_t* strides, int B, int Hq, int Hkv, int Lq, int Lk, int D,
    int causal, float scale, void* stream) {
  return bwd_tc_entry(q, k, v, nullptr, dout, nullptr, dk, dv,
                      const_cast<void*>(lse), const_cast<void*>(delta),
                      kv_len, strides, B, Hq, Hkv, Lq, Lk, D, causal, scale,
                      true, stream);
}
