// Shared helpers for the hand-written Hopper kernels (sm_90a).
#pragma once
#include <cmath>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace akt {

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) { return __bfloat162float(x); }

template <typename T> __device__ __forceinline__ T from_f(float x);
template <> __device__ __forceinline__ float from_f<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}

// x rounded to T, as a float (x itself for T = float)
template <typename T> __device__ __forceinline__ float round_to(float x) {
  return to_f(from_f<T>(x));
}

// One element of a norm's apply step in the default lowering's function:
// x * a + b as an elementwise mul then an elementwise add in T, each
// computed in fp32 and rounded to T (a and b already rounded to T). No
// contraction into an FMA, so fp32 I/O rounds the product too; the caller
// rounds the sum to T when it stores it.
template <typename T>
__device__ __forceinline__ float mul_add_rounded(float x, float a, float b) {
  return __fadd_rn(round_to<T>(__fmul_rn(x, a)), b);
}

// two floats -> packed bf16x2 (lo in the low half), as mma fragments want
__device__ __forceinline__ uint32_t pack_bf16x2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// D = A(16x16, row) * B(16x8, col) + C, bf16 inputs, fp32 accumulate.
// Fragment layout (g = lane / 4, t = lane % 4):
//   a0 (g, 2t..2t+1)  a1 (g+8, 2t..)  a2 (g, 2t+8..)  a3 (g+8, 2t+8..)
//   b0 (k 2t..2t+1, n g)  b1 (k 2t+8.., n g)
//   c0,c1 (g, 2t..2t+1)  c2,c3 (g+8, 2t..2t+1)
__device__ __forceinline__ void mma_bf16_16816(float c[4], const uint32_t a[4],
                                               uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// 16-byte vectors of T as fp32 values: 8 bf16 or 4 fp32 per vector
template <typename T> struct Vec;
template <> struct Vec<__nv_bfloat16> { static constexpr int N = 8; };
template <> struct Vec<float> { static constexpr int N = 4; };

__device__ __forceinline__ void unpack_vec(const uint4& v, float* f) {
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 p = __bfloat1622float2(h[i]);
    f[2 * i] = p.x;
    f[2 * i + 1] = p.y;
  }
}

// f <- the Vec<T>::N values at p (16-byte aligned)
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* f) {
  unpack_vec(*reinterpret_cast<const uint4*>(p), f);
}
__device__ __forceinline__ void load_vec(const float* p, float* f) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  f[0] = v.x; f[1] = v.y; f[2] = v.z; f[3] = v.w;
}

// the Vec<T>::N values f, rounded to T, to p (16-byte aligned)
__device__ __forceinline__ uint4 pack_vec(const float* f) {
  return make_uint4(pack_bf16x2(f[0], f[1]), pack_bf16x2(f[2], f[3]),
                    pack_bf16x2(f[4], f[5]), pack_bf16x2(f[6], f[7]));
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* f) {
  *reinterpret_cast<uint4*>(p) = pack_vec(f);
}
__device__ __forceinline__ void store_vec(float* p, const float* f) {
  *reinterpret_cast<float4*>(p) = make_float4(f[0], f[1], f[2], f[3]);
}

}  // namespace akt
