// K7-GN: GroupNorm of x (N, M, C) over its M rows and the C / G channels
// of each of G groups, y = x * a[n, c] + b[n, c] with the fp32 per-(N, C)
// affine a = rsqrt(var_g + eps) * gamma, b = beta - mean_g * a; x, y bf16
// or fp32, gamma / beta fp32 (C,).
//
// Replaces the TPU kernel actalker_tpu/ops/norms.py `_gn_kernel` (:119-161,
// launched by `_gn_pallas` :179). Same numerics: fp32 sums of x and x^2,
// var = E[x^2] - mean^2 clamped at 0, the affine in fp32, the output
// rounded once to the input dtype.
//
// What bounds it on the H100: bytes, x read twice (statistics, then the
// affine) and y written once. The TPU kernel walks one image's rows in a
// sequential grid axis with the sums in VMEM; on the card that would give
// one block per (n, group): 32 or 448 blocks over a million elements each
// at the VAE's (1 or 14, 512 * 512, 128). Design, first version, three
// kernels:
//   1. statistics: grid (chunks, N), each block sums a chunk of rows in
//      fp32, per channel in registers (a thread owns one 16-byte channel
//      vector and walks rows), then per group in a fixed order, and writes
//      its (sum, sum of squares) per group to part (N, chunks, G, 2). No
//      atomics, so two runs give the same bits;
//   2. finalize: one block per image sums its chunks in order and writes
//      the fp32 affine (a, b) per (n, c);
//   3. apply: y = x * a + b over 16-byte vectors.
// Groups are indexed per channel (c / (C / G)), never as whole vectors:
// C / G is 10 at C = 320 and 4 at C = 128. `gn_affine_*` runs 1-2 alone
// for K8, which takes (a, b) and fuses the affine into its conv.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

// (column lanes, row lanes) of a statistics block over nvec channel vectors
__host__ __device__ __forceinline__ int col_lanes(int nvec) {
  return nvec < kThreads ? nvec : kThreads;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_stats_kernel(const T* __restrict__ x, float* __restrict__ part, int M,
                int C, int G, int chunk_rows) {
  constexpr int V = akt::Vec<T>::N;
  extern __shared__ float sh[];           // [2][rp][C]
  const int nvec = C / V, cw = col_lanes(nvec), rp = kThreads / cw;
  const int n = blockIdx.y, chunk = blockIdx.x;
  const int r0 = chunk * chunk_rows, r1 = min(M, r0 + chunk_rows);
  const int tr = threadIdx.x / cw, tc = threadIdx.x % cw;
  const T* xn = x + (size_t)n * M * C;
  float* sh1 = sh;
  float* sh2 = sh + rp * C;
  if (tr < rp) {
    for (int v = tc; v < nvec; v += cw) {
      float s1[V], s2[V];
#pragma unroll
      for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
      for (int r = r0 + tr; r < r1; r += rp) {
        float f[V];
        akt::load_vec(xn + (size_t)r * C + v * V, f);
#pragma unroll
        for (int j = 0; j < V; ++j) {
          s1[j] += f[j];
          s2[j] += f[j] * f[j];
        }
      }
#pragma unroll
      for (int j = 0; j < V; ++j) {
        sh1[tr * C + v * V + j] = s1[j];
        sh2[tr * C + v * V + j] = s2[j];
      }
    }
  }
  __syncthreads();
  const int cg = C / G;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float a = 0.f, b = 0.f;
    for (int r = 0; r < rp; ++r)
      for (int c = g * cg; c < (g + 1) * cg; ++c) {
        a += sh1[r * C + c];
        b += sh2[r * C + c];
      }
    float* out = part + (((size_t)n * gridDim.x + chunk) * G + g) * 2;
    out[0] = a;
    out[1] = b;
  }
}

__global__ void __launch_bounds__(kThreads)
gn_finalize_kernel(const float* __restrict__ part,
                   const float* __restrict__ gamma,
                   const float* __restrict__ beta, float* __restrict__ a,
                   float* __restrict__ b, int chunks, int M, int C, int G,
                   float eps) {
  __shared__ float mean[kThreads], inv[kThreads];
  const int n = blockIdx.x, cg = C / G;
  const float cnt = (float)M * (float)cg;
  for (int g = threadIdx.x; g < G; g += kThreads) {
    float s1 = 0.f, s2 = 0.f;
    for (int k = 0; k < chunks; ++k) {
      const float* p = part + (((size_t)n * chunks + k) * G + g) * 2;
      s1 += p[0];
      s2 += p[1];
    }
    const float m1 = s1 / cnt;
    mean[g] = m1;
    inv[g] = rsqrtf(fmaxf(s2 / cnt - m1 * m1, 0.f) + eps);
  }
  __syncthreads();
  for (int c = threadIdx.x; c < C; c += kThreads) {
    const float ac = inv[c / cg] * gamma[c];
    a[(size_t)n * C + c] = ac;
    b[(size_t)n * C + c] = beta[c] - mean[c / cg] * ac;
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ y, int N, int M,
                int C) {
  constexpr int V = akt::Vec<T>::N;
  const int nvec = C / V;
  const size_t per_image = (size_t)M * nvec, total = (size_t)N * per_image;
  for (size_t i = (size_t)blockIdx.x * kThreads + threadIdx.x; i < total;
       i += (size_t)gridDim.x * kThreads) {
    const int n = (int)(i / per_image), c = (int)(i % nvec) * V;
    float f[V], av[V], bv[V];
    akt::load_vec(x + i * V, f);
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      akt::load_vec(a + (size_t)n * C + c + j, av + j);
      akt::load_vec(b + (size_t)n * C + c + j, bv + j);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) f[j] = f[j] * av[j] + bv[j];
    akt::store_vec(y + i * V, f);
  }
}

template <typename T>
int affine(const void* x, const void* gamma, const void* beta, void* part,
           void* a, void* b, int N, int M, int C, int G, int chunk_rows,
           float eps, cudaStream_t stream) {
  const int nvec = C / akt::Vec<T>::N;
  const size_t smem = 2 * sizeof(float) * (kThreads / col_lanes(nvec)) * C;
  if (G > kThreads || smem > 48 * 1024) return (int)cudaErrorInvalidValue;
  const int chunks = (M + chunk_rows - 1) / chunk_rows;
  gn_stats_kernel<T><<<dim3(chunks, N), kThreads, smem, stream>>>(
      (const T*)x, (float*)part, M, C, G, chunk_rows);
  const int err = (int)cudaGetLastError();
  if (err) return err;
  gn_finalize_kernel<<<N, kThreads, 0, stream>>>(
      (const float*)part, (const float*)gamma, (const float*)beta, (float*)a,
      (float*)b, chunks, M, C, G, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int apply(const void* x, const void* a, const void* b, void* y, int N, int M,
          int C, cudaStream_t stream) {
  const size_t total = (size_t)N * M * (C / akt::Vec<T>::N);
  const size_t want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gn_apply_kernel<T><<<blocks, kThreads, 0, stream>>>(
      (const T*)x, (const float*)a, (const float*)b, (T*)y, N, M, C);
  return (int)cudaGetLastError();
}

template <typename T>
int group_norm(const void* x, const void* gamma, const void* beta, void* part,
               void* a, void* b, void* y, int N, int M, int C, int G,
               int chunk_rows, float eps, void* stream) {
  const int err = affine<T>(x, gamma, beta, part, a, b, N, M, C, G,
                            chunk_rows, eps, (cudaStream_t)stream);
  if (err) return err;
  return apply<T>(x, a, b, y, N, M, C, (cudaStream_t)stream);
}

}  // namespace

// (a, b) (N, C) fp32 = the GroupNorm affine of x (N, M, C); part holds
// (N, ceil(M / chunk_rows), G, 2) fp32 partial sums; C % 8 == 0, C % G == 0
extern "C" int gn_affine_bf16(const void* x, const void* gamma,
                              const void* beta, void* part, void* a, void* b,
                              int N, int M, int C, int G, int chunk_rows,
                              float eps, void* stream) {
  return affine<__nv_bfloat16>(x, gamma, beta, part, a, b, N, M, C, G,
                               chunk_rows, eps, (cudaStream_t)stream);
}

extern "C" int gn_affine_f32(const void* x, const void* gamma,
                             const void* beta, void* part, void* a, void* b,
                             int N, int M, int C, int G, int chunk_rows,
                             float eps, void* stream) {
  return affine<float>(x, gamma, beta, part, a, b, N, M, C, G, chunk_rows,
                       eps, (cudaStream_t)stream);
}

// y (N, M, C) = group_norm(x): the affine above, then its application
extern "C" int group_norm_bf16(const void* x, const void* gamma,
                               const void* beta, void* part, void* a, void* b,
                               void* y, int N, int M, int C, int G,
                               int chunk_rows, float eps, void* stream) {
  return group_norm<__nv_bfloat16>(x, gamma, beta, part, a, b, y, N, M, C, G,
                                   chunk_rows, eps, stream);
}

extern "C" int group_norm_f32(const void* x, const void* gamma,
                              const void* beta, void* part, void* a, void* b,
                              void* y, int N, int M, int C, int G,
                              int chunk_rows, float eps, void* stream) {
  return group_norm<float>(x, gamma, beta, part, a, b, y, N, M, C, G,
                           chunk_rows, eps, stream);
}
