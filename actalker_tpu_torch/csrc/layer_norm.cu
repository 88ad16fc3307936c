// K7-LN: LayerNorm over the last axis, y = (x - mu) * rsqrt(var + eps) *
// gamma + beta; x, y (M, C) bf16 or fp32, gamma / beta fp32 (C,).
//
// Replaces the TPU kernel actalker_tpu/ops/norms.py `_ln_kernel` (:35-41,
// launched by `_ln_pallas` :56). Same numerics: fp32 statistics as
// E[x^2] - mu^2 clamped at 0, the affine in fp32, the output rounded once
// to the input dtype.
//
// The `_io` entries compute the default lowering's function instead
// (models/common.py's plain LayerNormF32; compile-time kIo): the same
// statistics, a = rsqrt(var + eps) * gamma and b = beta - mu * a in fp32 as
// separate rounded operations, a and b rounded to the I/O dtype T, then
// y = round_T(round_T(x * a) + b), what an elementwise mul and an
// elementwise add in T give. Only the apply step differs.
//
// What bounds it on the H100: bytes. It reads x once and writes y once
// (2 * M * C * 2 bytes in bf16, 294 MB at M = 56 * 4096, C = 320) for ~8
// operations per element. The first port walked each row twice with one
// 16-byte load in flight per lane and reloaded gamma / beta per row, so it
// was latency-bound. Design:
//   * a row of nv = C / (16 bytes) vectors is held in registers by LPR
//     lanes of VPL vectors each (template parameters, nv == LPR * VPL):
//     every load of the row is issued before the reduction, and x is read
//     once. A warp takes 32 / LPR rows at once, so narrow rows (C = 320
//     bf16: 8 lanes of 5 vectors) leave no lane idle;
//   * the sums are reduced by xor-shuffles within the LPR lanes
//     (deterministic);
//   * gamma and beta are staged in shared memory once per block, and the
//     blocks (at most 8 per SM) walk the rows, so each is read from device
//     memory once per block, not once per row.
// Widths outside the templated set (C % 8 == 0 still) take the general
// kernel: one warp per row, a strided loop of vectors.
#include "common.cuh"

namespace {

constexpr int kWarps = 8;

// y of one element from the row's mean and rsqrt(var + eps): the fp32
// affine, or (kIo) the default lowering's rounded one
template <typename T, bool kIo>
__device__ __forceinline__ float apply(float x, float mu, float inv, float g,
                                       float b) {
  if constexpr (kIo) {
    const float a = __fmul_rn(inv, g);
    const float c = __fsub_rn(b, __fmul_rn(mu, a));
    return akt::mul_add_rounded<T>(x, akt::round_to<T>(a), akt::round_to<T>(c));
  } else {
    return (x - mu) * inv * g + b;
  }
}

template <typename T, int VPL, int LPR, bool kIo>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_rows_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                       const float* __restrict__ beta, T* __restrict__ y, int M,
                       int C, float eps) {
  constexpr int V = akt::Vec<T>::N;
  constexpr int kRowsPerWarp = 32 / LPR;
  extern __shared__ float sgb[];            // gamma | beta, C each
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int sub = lane / LPR, l = lane % LPR;
  const int stride = gridDim.x * kWarps * kRowsPerWarp;
  const float inv_c = 1.f / C;
  float f[VPL][V];
  // all of a row's loads at once (zeros past M)
  auto load_row = [&](int row) {
#pragma unroll
    for (int k = 0; k < VPL; ++k) {
      if (row < M) akt::load_vec(x + (size_t)row * C + (l + k * LPR) * V, f[k]);
      else
#pragma unroll
        for (int j = 0; j < V; ++j) f[k][j] = 0.f;
    }
  };
  int r0 = (blockIdx.x * kWarps + warp) * kRowsPerWarp;
  // the first row's loads go out before gamma / beta are staged, so the
  // two latencies overlap (a block of the heads' 1792 rows walks one pass)
  load_row(r0 + sub);
  for (int i = threadIdx.x; i < C / 4; i += kWarps * 32) {
    reinterpret_cast<float4*>(sgb)[i] = reinterpret_cast<const float4*>(gamma)[i];
    reinterpret_cast<float4*>(sgb + C)[i] = reinterpret_cast<const float4*>(beta)[i];
  }
  __syncthreads();
  for (; r0 < M; r0 += stride) {
    const int row = r0 + sub;
    float s1 = 0.f, s2 = 0.f;
#pragma unroll
    for (int k = 0; k < VPL; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1 += f[k][j];
        s2 += f[k][j] * f[k][j];
      }
#pragma unroll
    for (int o = LPR / 2; o > 0; o >>= 1) {
      s1 += __shfl_xor_sync(0xffffffffu, s1, o);
      s2 += __shfl_xor_sync(0xffffffffu, s2, o);
    }
    const float mu = s1 * inv_c;
    const float inv = rsqrtf(fmaxf(s2 * inv_c - mu * mu, 0.f) + eps);
    if (row < M) {
      T* yr = y + (size_t)row * C;
#pragma unroll
      for (int k = 0; k < VPL; ++k) {
        const int c0 = (l + k * LPR) * V;
#pragma unroll
        for (int j = 0; j < V; j += 4) {
          const float4 g = *reinterpret_cast<const float4*>(sgb + c0 + j);
          const float4 b = *reinterpret_cast<const float4*>(sgb + C + c0 + j);
          f[k][j] = apply<T, kIo>(f[k][j], mu, inv, g.x, b.x);
          f[k][j + 1] = apply<T, kIo>(f[k][j + 1], mu, inv, g.y, b.y);
          f[k][j + 2] = apply<T, kIo>(f[k][j + 2], mu, inv, g.z, b.z);
          f[k][j + 3] = apply<T, kIo>(f[k][j + 3], mu, inv, g.w, b.w);
        }
        akt::store_vec(yr + c0, f[k]);
      }
    }
    load_row(row + stride);
  }
}

// any C % 8 == 0: one warp per row, lanes take vectors lane, lane + 32, ...
template <typename T, bool kIo>
__global__ void __launch_bounds__(kWarps * 32)
layer_norm_general_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                          const float* __restrict__ beta, T* __restrict__ y,
                          int M, int C, float eps) {
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
    for (int j = 0; j < V; ++j) f[j] = apply<T, kIo>(f[j], mu, inv, g[j], b[j]);
    akt::store_vec(yr + v * V, f);
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

template <typename T, int VPL, int LPR, bool kIo>
int launch_rows(const void* x, const void* gamma, const void* beta, void* y,
                int M, int C, float eps, cudaStream_t stream) {
  constexpr int kRows = kWarps * 32 / LPR;   // rows per block pass
  const int smem = 2 * C * (int)sizeof(float);
  static int attr = 0;
  if (smem > 48 * 1024 && smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        layer_norm_rows_kernel<T, VPL, LPR, kIo>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  const long long passes = ((long long)M + kRows - 1) / kRows;
  const int grid = (int)(passes < 8LL * sm_count() ? passes : 8LL * sm_count());
  layer_norm_rows_kernel<T, VPL, LPR, kIo><<<grid, kWarps * 32, smem, stream>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (T*)y, M, C, eps);
  return (int)cudaGetLastError();
}

// the templated widths: nv vectors per row as LPR lanes x VPL vectors,
// the widest LPR first: C = 320 / 640 / 1280 / 2560 bf16 (8 x 5, 16 x 5,
// 32 x 5, 32 x 10) and 1024 fp32 (32 x 8), the widths the path gives
template <typename T, int LPR, bool kIo>
int try_lanes(const void* x, const void* g, const void* b, void* y, int M,
              int C, float eps, cudaStream_t s, bool* done) {
  const int nv = C / akt::Vec<T>::N;
  *done = true;
  if (nv == LPR * 5) return launch_rows<T, 5, LPR, kIo>(x, g, b, y, M, C, eps, s);
  if (nv == LPR * 8) return launch_rows<T, 8, LPR, kIo>(x, g, b, y, M, C, eps, s);
  if (nv == LPR * 10) return launch_rows<T, 10, LPR, kIo>(x, g, b, y, M, C, eps, s);
  *done = false;
  return 0;
}

template <typename T, bool kIo>
int launch(const void* x, const void* gamma, const void* beta, void* y, int M,
           int C, float eps, void* stream) {
  if (M <= 0) return 0;
  cudaStream_t s = (cudaStream_t)stream;
  bool done = false;
  int err = try_lanes<T, 32, kIo>(x, gamma, beta, y, M, C, eps, s, &done);
  if (!done) err = try_lanes<T, 16, kIo>(x, gamma, beta, y, M, C, eps, s, &done);
  if (!done) err = try_lanes<T, 8, kIo>(x, gamma, beta, y, M, C, eps, s, &done);
  if (done) return err;
  const int blocks = (M + kWarps - 1) / kWarps;
  layer_norm_general_kernel<T, kIo><<<blocks, kWarps * 32, 0, s>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (T*)y, M, C, eps);
  return (int)cudaGetLastError();
}

}  // namespace

// y (M, C) = layer_norm(x (M, C)); C % 8 == 0. The `_io` entries: the
// default lowering's function (the affine rounded in the I/O dtype)
#define LN_ENTRY(NAME, T, IO)                                                 \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta,     \
                      void* y, int M, int C, float eps, void* stream) {       \
    return launch<T, IO>(x, gamma, beta, y, M, C, eps, stream);               \
  }
LN_ENTRY(layer_norm_bf16, __nv_bfloat16, false)
LN_ENTRY(layer_norm_f32, float, false)
LN_ENTRY(layer_norm_io_bf16, __nv_bfloat16, true)
LN_ENTRY(layer_norm_io_f32, float, true)
