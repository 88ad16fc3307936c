// K4: GEGLU feed-forward y = (h * gelu_erf(g)) @ W2^T + b2 with
// [h | g] = x @ W1^T + b1; x (M, C) bf16, W1 (2I, C) and W2 (Cout, I) bf16
// in torch Linear layout, b1 / b2 fp32.
//
// Replaces the TPU kernel actalker_tpu/ops/mlp.py `_mlp_kernel` (:47-58,
// launched by `_mlp_pallas` :81). Same numerics: both products accumulate
// in fp32, the gate is computed in fp32 (exact erf GELU), and h is rounded
// to bf16 before the second product, as the TPU kernel casts it to the
// weight dtype (mlp.py:54-57).
//
// What bounds it on the H100: the two products, 2*M*C*2I + 2*M*I*Cout
// flops (2.4 TFLOP at M = 56*4096, C = 1280), i.e. tensor-core work; the
// unfused form also moves the (M, I) intermediate through device memory
// twice (0.6 GB bf16 at C = 320). Design, first version: one hand-written
// tiled GEMM (128 x 64 block tile, 8 warps of 32 x 32, k-steps of 32,
// mma.sync m16n8k16 bf16 -> fp32, next k-tile prefetched into registers
// while the current one is multiplied) launched twice:
//   1. x @ W1^T with both halves per block (W1 rows n and I + n), and an
//      epilogue that adds b1, gates in fp32 and writes h once as bf16;
//   2. h @ W2^T with a bias epilogue.
// Keeping h out of device memory (one fused launch) and wgmma / TMA are
// later work.
#include "common.cuh"

namespace {

constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kPad = kBK + 8;   // shared row stride in bf16 (conflict-free frags)
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// GEGLU=true: out (M, N) = (A W[n]^T + bias[n]) * gelu(A W[N+n]^T + bias[N+n])
// GEGLU=false: out (M, N) = A W[n]^T + bias[n]
template <bool GEGLU>
__global__ void __launch_bounds__(kThreads)
gemm_tn_kernel(const __nv_bfloat16* __restrict__ A,
               const __nv_bfloat16* __restrict__ W,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int M, int N, int K) {
  constexpr int NB = GEGLU ? 2 : 1;
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kPad];
  __shared__ __align__(16) __nv_bfloat16 Bs[NB][kBN * kPad];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int wm = warp / 2, wn = warp % 2;      // 4 x 2 warps of 32 x 32
  const int m0 = blockIdx.y * kBM, n0 = blockIdx.x * kBN;

  // global -> register staging: A tile 128 x 32 (2 vectors / thread),
  // each B tile 64 x 32 (1 vector / thread)
  uint4 ra[2], rb[NB];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx / 4, c = (idx % 4) * 8;
      ra[i] = make_uint4(0, 0, 0, 0);
      if (m0 + r < M && k0 + c < K)
        ra[i] = *reinterpret_cast<const uint4*>(A + (size_t)(m0 + r) * K + k0 + c);
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int r = tid / 4, c = (tid % 4) * 8;
      rb[nb] = make_uint4(0, 0, 0, 0);
      if (n0 + r < N && k0 + c < K)
        rb[nb] = *reinterpret_cast<const uint4*>(
            W + (size_t)(nb * N + n0 + r) * K + k0 + c);
    }
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx / 4, c = (idx % 4) * 8;
      *reinterpret_cast<uint4*>(&As[r * kPad + c]) = ra[i];
    }
#pragma unroll
    for (int nb = 0; nb < NB; ++nb) {
      const int r = tid / 4, c = (tid % 4) * 8;
      *reinterpret_cast<uint4*>(&Bs[nb][r * kPad + c]) = rb[nb];
    }
  };

  float acc[NB][2][4][4];
#pragma unroll
  for (int nb = 0; nb < NB; ++nb)
#pragma unroll
    for (int mi = 0; mi < 2; ++mi)
#pragma unroll
      for (int ni = 0; ni < 4; ++ni)
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nb][mi][ni][e] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = &As[(wm * 32 + mi * 16 + gr) * kPad + kk * 16 + 2 * tq];
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * kPad);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * kPad + 8);
      }
#pragma unroll
      for (int nb = 0; nb < NB; ++nb)
#pragma unroll
        for (int ni = 0; ni < 4; ++ni) {
          const __nv_bfloat16* p = &Bs[nb][(wn * 32 + ni * 8 + gr) * kPad + kk * 16 + 2 * tq];
          const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
#pragma unroll
          for (int mi = 0; mi < 2; ++mi) akt::mma_bf16_16816(acc[nb][mi][ni], a[mi], b0, b1);
        }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * tq;
      if (col >= N) continue;   // N is even, so col + 1 < N as well
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mi * 16 + gr + half * 8;
        if (row >= M) continue;
        float y0 = acc[0][mi][ni][2 * half] + bias[col];
        float y1 = acc[0][mi][ni][2 * half + 1] + bias[col + 1];
        if constexpr (GEGLU) {
          y0 *= gelu_erf(acc[NB - 1][mi][ni][2 * half] + bias[N + col]);
          y1 *= gelu_erf(acc[NB - 1][mi][ni][2 * half + 1] + bias[N + col + 1]);
        }
        *reinterpret_cast<uint32_t*>(out + (size_t)row * N + col) = akt::pack_bf16x2(y0, y1);
      }
    }
}

}  // namespace

// h (M, I) = geglu(x (M, C) @ W1^T + b1), W1 (2I, C)
extern "C" int geglu_in_bf16(const void* x, const void* w1, const void* b1,
                             void* h, int M, int C, int I, void* stream) {
  dim3 grid((I + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_tn_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const __nv_bfloat16*)w1, (const float*)b1,
      (__nv_bfloat16*)h, M, I, C);
  return (int)cudaGetLastError();
}

// y (M, Cout) = h (M, I) @ W2^T + b2, W2 (Cout, I)
extern "C" int linear_bias_bf16(const void* h, const void* w2, const void* b2,
                                void* y, int M, int I, int Cout, void* stream) {
  dim3 grid((Cout + kBN - 1) / kBN, (M + kBM - 1) / kBM);
  gemm_tn_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)h, (const __nv_bfloat16*)w2, (const float*)b2,
      (__nv_bfloat16*)y, M, Cout, I);
  return (int)cudaGetLastError();
}
