// K7-LN: LayerNorm over the last axis, y = (x - mu) * rsqrt(var + eps) *
// gamma + beta; x, y (M, C) bf16 or fp32, gamma / beta fp32 (C,).
//
// Replaces the TPU kernel actalker_tpu/ops/norms.py `_ln_kernel` (:35-41,
// launched by `_ln_pallas` :56). Same numerics: fp32 statistics as
// E[x^2] - mu^2 clamped at 0, the affine in fp32, the output rounded once
// to the input dtype.
//
// What bounds it on the H100: bytes. It reads x once and writes y once
// (2 * M * C * 2 bytes in bf16, 294 MB at M = 56 * 4096, C = 320) for ~8
// operations per element. Design, first version: one warp per row, 16-byte
// vector loads, fp32 sum and sum of squares per lane, an xor-shuffle warp
// reduce (deterministic), then a second sweep over the row that applies
// the affine (the row, at most 5 KB, is read again from L1 / L2, not from
// device memory). Rows of any width C % 8 == 0: a lane takes the vectors
// v = lane, lane + 32, ... of its row, so the ragged tail at C = 320 (40
// vectors) needs no padding.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

template <typename T>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                  const float* __restrict__ beta, T* __restrict__ y, int M,
                  int C, float eps) {
  constexpr int V = akt::Vec<T>::N;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int row = blockIdx.x * kWarps + warp;
  if (row >= M) return;
  const T* xr = x + (size_t)row * C;
  T* yr = y + (size_t)row * C;
  const int nv = C / V;

  float s1 = 0.f, s2 = 0.f;
  for (int v = lane; v < nv; v += 32) {
    float f[V];
    akt::load_vec(xr + v * V, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1 += f[j];
      s2 += f[j] * f[j];
    }
  }
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s1 += __shfl_xor_sync(0xffffffffu, s1, o);
    s2 += __shfl_xor_sync(0xffffffffu, s2, o);
  }
  const float mu = s1 / C;
  const float inv = rsqrtf(fmaxf(s2 / C - mu * mu, 0.f) + eps);

  for (int v = lane; v < nv; v += 32) {
    float f[V], g[V], b[V];
    akt::load_vec(xr + v * V, f);
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      akt::load_vec(gamma + v * V + j, g + j);
      akt::load_vec(beta + v * V + j, b + j);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = (f[j] - mu) * inv * g[j] + b[j];
    akt::store_vec(yr + v * V, f);
  }
}

template <typename T>
int launch(const void* x, const void* gamma, const void* beta, void* y, int M,
           int C, float eps, void* stream) {
  const int blocks = (M + kWarps - 1) / kWarps;
  layer_norm_kernel<T><<<blocks, kWarps * 32, 0, (cudaStream_t)stream>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (T*)y, M, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// y (M, C) = layer_norm(x (M, C)); C % 8 == 0
extern "C" int layer_norm_bf16(const void* x, const void* gamma,
                               const void* beta, void* y, int M, int C,
                               float eps, void* stream) {
  return launch<__nv_bfloat16>(x, gamma, beta, y, M, C, eps, stream);
}

extern "C" int layer_norm_f32(const void* x, const void* gamma,
                              const void* beta, void* y, int M, int C,
                              float eps, void* stream) {
  return launch<float>(x, gamma, beta, y, M, C, eps, stream);
}
