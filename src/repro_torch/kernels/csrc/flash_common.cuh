// Helpers shared by K2's sources (flash_attention.cu, the forward and the
// CUDA-core backward; flash_attention_bwd_tc.cu, the tensor-core backward):
// cp.async staging, ldmatrix, the bf16 mma.sync.m16n8k16 product, ex2 and
// bf16 packing, and the host-side checks of the entry points.  Everything
// sits in an anonymous namespace, so each source compiles its own copy.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr unsigned kFull = 0xffffffffu;
constexpr float kLog2e = 1.4426950408889634f;

// Raise a kernel's dynamic shared-memory limit when it needs more than the
// default 48 KB.
template <typename K>
int allow_smem(K kern, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

// ------------------------------------------------ async copies and mma.sync
__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes global -> shared; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes global -> shared; zero-fills the destination when !valid.
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_u32(dst)),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ void ldmatrix_x4(uint32_t (&r)[4], const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}

// d += a (16x16, row) * b (16x8, col), bf16 in, fp32 accumulate.
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 2^x by the SFU's ex2.approx (relative error ~2^-22, -inf -> 0): the bf16
// tensor-core kernels only, whose p is rounded to bf16 next.
__device__ __forceinline__ float exp2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Two floats rounded to bf16, the lower column in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}

// ------------------------------------------------- the backward's arguments
struct BwdStrides {
  int64_t q[4], k[4], v[4], o[4], dout[4], dq[4], dk[4], dv[4];
};

inline BwdStrides unpack_bwd_strides(const int64_t* s) {
  BwdStrides st;
  for (int i = 0; i < 4; ++i) {
    st.q[i] = s[i];
    st.k[i] = s[4 + i];
    st.v[i] = s[8 + i];
    st.o[i] = s[12 + i];
    st.dout[i] = s[16 + i];
    st.dq[i] = s[20 + i];
    st.dk[i] = s[24 + i];
    st.dv[i] = s[28 + i];
  }
  return st;
}

// ------------------------------------------------------ entry-point checks
inline bool valid_dims(int B, int Hq, int Hkv, int Lq, int Lk, int D) {
  return B >= 1 && B <= 65535 && Hkv >= 1 && Hkv <= 65535 && Hq >= 1 &&
         Hq % Hkv == 0 && Lq >= 1 && Lk >= 0 && D >= 1 && D <= 256;
}

// The vector paths' layout: last dim contiguous, every other stride and
// the base 16-byte aligned.
inline bool aligned16(const void* p, const int64_t* s, size_t esize) {
  if (((uintptr_t)p & 15) != 0 || s[3] != 1) return false;
  for (int i = 0; i < 3; ++i)
    if ((s[i] * (int64_t)esize) % 16 != 0) return false;
  return true;
}

}  // namespace
