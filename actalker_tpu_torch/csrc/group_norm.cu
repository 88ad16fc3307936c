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
// What bounds it on the H100: bytes. The least traffic is one read of x
// and one write of y (one read for the statistics alone, which K8 takes).
// Two designs, chosen per shape by the host plan (ops/norms.py::gn_plan),
// which the C entries check:
//
//   cluster (one launch, x read once): an image's slice of whole groups
//     (sc channels, a multiple of 16 bytes) is held on chip by a thread
//     block cluster of P CTAs, each holding rows_cta of its rows in shared
//     memory, loaded by TMA boxes of box_rows rows. Each CTA sums its rows
//     per channel (fp32, fixed order), then per group; the clusters' CTAs
//     read each other's group sums through distributed shared memory in
//     rank order (so every CTA, and every run, gets the same bits), and
//     apply the affine from shared memory. Used where an image's slice fits
//     the CTAs of one cluster: at res-64 (56, 4096, 320) a CTA holds
//     2.6 MB / (slices * P) of x.
//   two-pass (two launches, x read twice): images too large for a cluster
//     (the temporal resnets' (4, 57344, 320), the VAE's 512 px frames).
//     1. statistics, grid (chunks, N): each block sums a chunk of rows per
//        channel and per group and writes its partial sums; the last block
//        of an image to finish (an arrival counter, reset in the kernel)
//        adds the image's partials in chunk order and writes (a, b). This
//        launch alone is `gn_stats_*`, K8's statistics.
//     2. apply, grid (row blocks, N): each thread owns one channel vector,
//        its a / b in registers, and walks rows (no per-vector index
//        division). Images and rows are walked in the reverse order of the
//        statistics pass, so the part of x still in L2 is read first.
// Groups are indexed per channel (c / (C / G)), never as whole vectors:
// C / G is 10 at C = 320 and 4 at C = 128, so a vector may straddle groups.
//
// The `_io` entries compute the default lowering's function instead
// (models/common.py's plain GroupNorm32; compile-time kIo): the same
// statistics, the fp32 a = rsqrt(var + eps) * gamma and b = beta - mu * a
// as two rounded operations (no FMA), both rounded to the I/O dtype T,
// then y = round_T(round_T(x * a) + b), what an elementwise mul and an
// elementwise add in T give. Only b's rounding and the apply step differ,
// on both paths.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kMaxThreads = 512;
constexpr int kMaxCluster = 8;          // the portable cluster size
constexpr int kMaxBox = 256;             // a TMA box's extent limit
constexpr int kSmemLimit = 232448;       // 227 KB a block

// ---- geometry shared by the host checks and the kernels -------------------

// (column lanes, row lanes) of a block of `threads` over nvec vectors a row
__host__ __device__ __forceinline__ int col_lanes(int nvec, int threads) {
  return nvec < threads ? nvec : threads;
}

// statistics block: per-(row lane, channel) float2 sums, reused by the
// finalize for per-(stripe, group) sums and the groups' (mean, inv)
__host__ __device__ inline int stats_smem(int C, int G, int threads, int vec) {
  const int rl = threads / col_lanes(C / vec, threads);
  const int stripes = threads / G > 0 ? threads / G : 1;
  const int a = rl * C, b = stripes * G + G;
  return 8 * (a > b ? a : b);
}

// cluster CTA: x rows (128-byte aligned boxes), per-(row lane, channel)
// float2 sums, the slice's group sums, the channels' (a, b), one mbarrier
struct ClusterGeo {
  int xbytes, red, grp, ab, bar, total;
};
__host__ __device__ inline ClusterGeo cluster_geo(int sc, int cg, int box_rows,
                                                 int nbox, int threads, int esize) {
  ClusterGeo g;
  g.xbytes = nbox * box_rows * sc * esize;
  const int rl = threads / col_lanes(sc * esize / 16, threads);
  g.red = (g.xbytes + 127) / 128 * 128;
  g.grp = g.red + rl * sc * 8;
  g.ab = g.grp + sc / cg * 8;
  g.bar = g.ab + sc * 8;
  g.total = g.bar + 8;
  return g;
}

// the apply step's coefficient: the fp32 a or b, or (kIo) it rounded to T
template <typename T, bool kIo>
__device__ __forceinline__ float coef(float v) {
  if constexpr (kIo) return akt::round_to<T>(v);
  else return v;
}

// b = beta - mu * a from the fp32 a: one FMA, or (kIo) a rounded product
// then a rounded difference, the plain branch's two operations
template <bool kIo>
__device__ __forceinline__ float shift(float beta, float mu, float a) {
  if constexpr (kIo) return __fsub_rn(beta, __fmul_rn(mu, a));
  else return beta - mu * a;
}

// the apply step's x * a + b: one fp32 FMA, or (kIo) a mul and an add in T
template <typename T, bool kIo>
__device__ __forceinline__ float affine(float x, float a, float b) {
  if constexpr (kIo) return akt::mul_add_rounded<T>(x, a, b);
  else return fmaf(x, a, b);
}

__device__ __forceinline__ float2 add2(float2 a, float2 b) {
  return make_float2(a.x + b.x, a.y + b.y);
}

// mean and rsqrt(var + eps) of a group from its (sum, sum of squares)
__device__ __forceinline__ float2 moments(float2 s, float cnt, float eps) {
  const float m1 = s.x / cnt;
  return make_float2(m1, rsqrtf(fmaxf(s.y / cnt - m1 * m1, 0.f) + eps));
}

// sums of x and x^2 over rows [r, r_end) stepping rl, of the V channels at p
// (p points at row 0 of those channels, rows `stride` elements apart); four
// rows' loads are issued before their sums
template <typename T>
__device__ __forceinline__ void sum_rows(const T* p, size_t stride, int r, int r_end,
                                         int rl, float* s1, float* s2) {
  constexpr int V = akt::Vec<T>::N;
  for (; r + 3 * rl < r_end; r += 4 * rl) {
    float f[4][V];
#pragma unroll
    for (int k = 0; k < 4; ++k) akt::load_vec(p + (size_t)(r + k * rl) * stride, f[k]);
#pragma unroll
    for (int k = 0; k < 4; ++k)
#pragma unroll
      for (int j = 0; j < V; ++j) {
        s1[j] += f[k][j];
        s2[j] = fmaf(f[k][j], f[k][j], s2[j]);
      }
  }
  for (; r < r_end; r += rl) {
    float f[V];
    akt::load_vec(p + (size_t)r * stride, f);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      s1[j] += f[j];
      s2[j] = fmaf(f[j], f[j], s2[j]);
    }
  }
}

// per-channel sums of a block's row lanes: red[tr][c] (float2) for the
// thread's vectors, then red[0][c] = the row lanes' total in lane order;
// ends synchronized
__device__ __forceinline__ void reduce_lanes(float2* red, int width, int rl) {
  const int tid = threadIdx.x;
  __syncthreads();
  for (int c = tid; c < width; c += blockDim.x) {
    float2 t = red[c];
    for (int k = 1; k < rl; ++k) t = add2(t, red[k * width + c]);
    red[c] = t;
  }
  __syncthreads();
}

// ---- two-pass: 1. statistics (+ the last block's finalize) -----------------

template <typename T, bool kIo>
__global__ void __launch_bounds__(kMaxThreads)
gn_stats_kernel(const T* __restrict__ x, const float* __restrict__ gamma,
                const float* __restrict__ beta, float2* __restrict__ part,
                unsigned* __restrict__ count, float* __restrict__ a,
                float* __restrict__ b, int M, int C, int G, int rows, float eps) {
  constexpr int V = akt::Vec<T>::N;
  extern __shared__ __align__(16) float2 sh[];
  __shared__ bool last;
  const int tid = threadIdx.x, n = blockIdx.y, chunk = blockIdx.x;
  const int chunks = gridDim.x, nvec = C / V, cg = C / G;
  const int cw = col_lanes(nvec, blockDim.x), rl = blockDim.x / cw;
  const int tr = tid / cw, tc = tid - tr * cw;
  const int r0 = chunk * rows, r1 = min(M, r0 + rows);
  const T* xn = x + (size_t)n * M * C;
  for (int v = tc; v < nvec; v += cw) {
    float s1[V], s2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
    sum_rows(xn + v * V, (size_t)C, r0 + tr, r1, rl, s1, s2);
#pragma unroll
    for (int j = 0; j < V; ++j) sh[tr * C + v * V + j] = make_float2(s1[j], s2[j]);
  }
  reduce_lanes(sh, C, rl);
  for (int g = tid; g < G; g += blockDim.x) {
    float2 t = sh[g * cg];
    for (int c = 1; c < cg; ++c) t = add2(t, sh[g * cg + c]);
    part[((size_t)n * chunks + chunk) * G + g] = t;
  }
  // the last block of image n to arrive finalizes it
  __threadfence();
  __syncthreads();
  if (tid == 0) last = atomicAdd(count + n, 1u) == (unsigned)(chunks - 1);
  __syncthreads();
  if (!last) return;
  __threadfence();
  const int stripes = max(1, (int)blockDim.x / G);
  const float2* pn = part + (size_t)n * chunks * G;
  for (int i = tid; i < stripes * G; i += blockDim.x) {
    const int s = i / G, g = i - s * G;
    // four running sums a stripe, combined in a fixed order
    float2 acc[4] = {{0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}, {0.f, 0.f}};
    int k = s;
    for (; k + 3 * stripes < chunks; k += 4 * stripes)
#pragma unroll
      for (int q = 0; q < 4; ++q)
        acc[q] = add2(acc[q], __ldcg(pn + (size_t)(k + q * stripes) * G + g));
    for (; k < chunks; k += stripes) acc[0] = add2(acc[0], __ldcg(pn + (size_t)k * G + g));
    sh[i] = add2(add2(acc[0], acc[1]), add2(acc[2], acc[3]));
  }
  __syncthreads();
  const float cnt = (float)M * (float)cg;
  for (int g = tid; g < G; g += blockDim.x) {
    float2 t = sh[g];
    for (int s = 1; s < stripes; ++s) t = add2(t, sh[s * G + g]);
    sh[stripes * G + g] = moments(t, cnt, eps);
  }
  __syncthreads();
  for (int c = tid; c < C; c += blockDim.x) {
    const float2 mi = sh[stripes * G + c / cg];
    const float ac = mi.y * gamma[c];
    a[(size_t)n * C + c] = ac;
    b[(size_t)n * C + c] = shift<kIo>(beta[c], mi.x, ac);
  }
  if (tid == 0) count[n] = 0u;   // ready for the next launch
}

// ---- two-pass: 2. apply ---------------------------------------------------

template <typename T, bool kIo>
__global__ void __launch_bounds__(kMaxThreads)
gn_apply_kernel(const T* __restrict__ x, const float* __restrict__ a,
                const float* __restrict__ b, T* __restrict__ y, int M, int C,
                int rows) {
  constexpr int V = akt::Vec<T>::N;
  // reverse of the statistics pass's order: its last rows are in L2
  const int n = gridDim.y - 1 - blockIdx.y, blk = gridDim.x - 1 - blockIdx.x;
  const int nvec = C / V, cw = col_lanes(nvec, blockDim.x), rl = blockDim.x / cw;
  const int tr = threadIdx.x / cw, tc = threadIdx.x - tr * cw;
  const int r0 = blk * rows, r1 = min(M, r0 + rows);
  const size_t base = (size_t)n * M * C;
  for (int v = tc; v < nvec; v += cw) {
    float av[V], bv[V];
#pragma unroll
    for (int j = 0; j < V; j += 4) {
      akt::load_vec(a + (size_t)n * C + v * V + j, av + j);
      akt::load_vec(b + (size_t)n * C + v * V + j, bv + j);
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      av[j] = coef<T, kIo>(av[j]);
      bv[j] = coef<T, kIo>(bv[j]);
    }
    const T* xp = x + base + v * V;
    T* yp = y + base + v * V;
    int r = r0 + tr;
    for (; r + 3 * rl < r1; r += 4 * rl) {
      float f[4][V];
#pragma unroll
      for (int k = 0; k < 4; ++k) akt::load_vec(xp + (size_t)(r + k * rl) * C, f[k]);
#pragma unroll
      for (int k = 0; k < 4; ++k) {
#pragma unroll
        for (int j = 0; j < V; ++j) f[k][j] = affine<T, kIo>(f[k][j], av[j], bv[j]);
        akt::store_vec(yp + (size_t)(r + k * rl) * C, f[k]);
      }
    }
    for (; r < r1; r += rl) {
      float f[V];
      akt::load_vec(xp + (size_t)r * C, f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = affine<T, kIo>(f[j], av[j], bv[j]);
      akt::store_vec(yp + (size_t)r * C, f);
    }
  }
}

// ---- cluster: x read once ---------------------------------------------------

__device__ __forceinline__ uint32_t cluster_rank() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_ctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ uint32_t cluster_ctas() {
  uint32_t r;
  asm volatile("mov.u32 %0, %%cluster_nctarank;\n" : "=r"(r));
  return r;
}
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}
// the float2 at the same shared offset as p in cluster CTA `rank`
__device__ __forceinline__ float2 ld_cluster(const float2* p, uint32_t rank) {
  uint32_t addr;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(addr) : "r"(hop::smem_u32(p)), "r"(rank));
  float2 v;
  asm volatile("ld.shared::cluster.v2.f32 {%0, %1}, [%2];\n"
               : "=f"(v.x), "=f"(v.y) : "r"(addr) : "memory");
  return v;
}

// grid (P * slices, N), clusters of P along x: cluster rank r of slice s of
// image n holds rows [r * rows_cta, +rows_cta) of channels [s * sc, +sc)
template <typename T, bool kIo>
__global__ void __launch_bounds__(kMaxThreads)
gn_cluster_kernel(const __grid_constant__ CUtensorMap xmap,
                  const float* __restrict__ gamma, const float* __restrict__ beta,
                  T* __restrict__ y, int M, int C, int G, int sc, int rows_cta,
                  int box_rows, int nbox, float eps) {
  constexpr int V = akt::Vec<T>::N;
  extern __shared__ __align__(128) uint8_t smem[];
  const int cg = C / G, ngs = sc / cg;
  const ClusterGeo geo = cluster_geo(sc, cg, box_rows, nbox, blockDim.x, sizeof(T));
  const T* xs = reinterpret_cast<const T*>(smem);
  float2* red = reinterpret_cast<float2*>(smem + geo.red);
  float2* grp = reinterpret_cast<float2*>(smem + geo.grp);
  float2* ab = reinterpret_cast<float2*>(smem + geo.ab);
  const uint32_t bar = hop::smem_u32(smem + geo.bar);
  const int tid = threadIdx.x;
  const int P = (int)cluster_ctas(), rank = (int)cluster_rank();
  const int slice = blockIdx.x / P, n = blockIdx.y, c0 = slice * sc;
  const int r0 = rank * rows_cta, valid = max(0, min(rows_cta, M - r0));

  if (tid == 0) {
    hop::mbar_init(bar, 1);
    hop::mbar_init_fence();
  }
  __syncthreads();
  if (tid == 0) {
    const int box_bytes = box_rows * sc * (int)sizeof(T);
    hop::mbar_expect_tx(bar, (uint32_t)(nbox * box_bytes));
    for (int k = 0; k < nbox; ++k)
      hop::tma_load_3d(hop::smem_u32(smem + k * box_bytes), &xmap, bar, c0,
                       r0 + k * box_rows, n);
  }
  const int nvs = sc / V, cw = col_lanes(nvs, blockDim.x), rl = blockDim.x / cw;
  const int tr = tid / cw, tc = tid - tr * cw;
  hop::mbar_wait(bar, 0);

  // this CTA's sums: per channel over its rows, then per group
  for (int v = tc; v < nvs; v += cw) {
    float s1[V], s2[V];
#pragma unroll
    for (int j = 0; j < V; ++j) s1[j] = s2[j] = 0.f;
    sum_rows(xs + v * V, (size_t)sc, tr, valid, rl, s1, s2);
#pragma unroll
    for (int j = 0; j < V; ++j) red[tr * sc + v * V + j] = make_float2(s1[j], s2[j]);
  }
  reduce_lanes(red, sc, rl);
  for (int g = tid; g < ngs; g += blockDim.x) {
    float2 t = red[g * cg];
    for (int c = 1; c < cg; ++c) t = add2(t, red[g * cg + c]);
    grp[g] = t;
  }
  // every CTA's group sums are written; add them in rank order
  cluster_arrive();
  cluster_wait();
  const float cnt = (float)M * (float)cg;
  for (int g = tid; g < ngs; g += blockDim.x) {
    float2 t = ld_cluster(grp + g, 0);
    for (int q = 1; q < P; ++q) t = add2(t, ld_cluster(grp + g, q));
    red[g] = moments(t, cnt, eps);
  }
  cluster_arrive();   // this CTA has read the others' sums
  __syncthreads();
  for (int c = tid; c < sc; c += blockDim.x) {
    const float2 mi = red[c / cg];
    const float ac = mi.y * gamma[c0 + c];
    ab[c] = make_float2(ac, shift<kIo>(beta[c0 + c], mi.x, ac));
  }
  __syncthreads();

  // the affine from shared memory, y straight to device memory
  for (int v = tc; v < nvs; v += cw) {
    float av[V], bv[V];
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float2 t = ab[v * V + j];
      av[j] = coef<T, kIo>(t.x);
      bv[j] = coef<T, kIo>(t.y);
    }
    T* yp = y + ((size_t)n * M + r0) * C + c0 + v * V;
    for (int r = tr; r < valid; r += rl) {
      float f[V];
      akt::load_vec(xs + (size_t)r * sc + v * V, f);
#pragma unroll
      for (int j = 0; j < V; ++j) f[j] = affine<T, kIo>(f[j], av[j], bv[j]);
      akt::store_vec(yp + (size_t)r * C, f);
    }
  }
  cluster_wait();     // no CTA leaves while another may read its sums
}

// ---- host -------------------------------------------------------------------

// raise a kernel's dynamic shared-memory limit to `smem` (kept per kernel
// in *limit, so it is set once for each larger size)
int ensure_smem(const void* fn, int smem, int* limit) {
  if (smem <= *limit) return 0;
  const int e = (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e == 0) *limit = smem;
  return e;
}

// the plan's statistics layout is one this kernel takes
template <typename T>
bool stats_ok(int C, int G, int rows, int threads, int smem) {
  constexpr int V = akt::Vec<T>::N;
  const int cw = col_lanes(C / V, threads);
  return C % V == 0 && G > 0 && C % G == 0 && rows > 0 && threads > 0 &&
         threads <= kMaxThreads && threads % cw == 0 &&
         smem == stats_smem(C, G, threads, V) && smem <= kSmemLimit;
}

template <typename T, bool kIo>
int stats(const void* x, const void* gamma, const void* beta, void* part,
          void* count, void* a, void* b, int N, int M, int C, int G, int rows,
          int threads, int smem, float eps, cudaStream_t s) {
  if (!stats_ok<T>(C, G, rows, threads, smem)) return (int)cudaErrorInvalidValue;
  static int limit = 48 * 1024;
  const int e = ensure_smem((const void*)gn_stats_kernel<T, kIo>, smem, &limit);
  if (e) return e;
  gn_stats_kernel<T, kIo><<<dim3((M + rows - 1) / rows, N), threads, smem, s>>>(
      (const T*)x, (const float*)gamma, (const float*)beta, (float2*)part,
      (unsigned*)count, (float*)a, (float*)b, M, C, G, rows, eps);
  return (int)cudaGetLastError();
}

template <typename T, bool kIo>
int two_pass(const void* x, const void* gamma, const void* beta, void* part,
             void* count, void* a, void* b, void* y, int N, int M, int C, int G,
             int rows, int apply_rows, int threads, int smem, float eps,
             void* stream) {
  if (apply_rows <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = (cudaStream_t)stream;
  const int err = stats<T, kIo>(x, gamma, beta, part, count, a, b, N, M, C, G, rows,
                           threads, smem, eps, s);
  if (err) return err;
  gn_apply_kernel<T, kIo><<<dim3((M + apply_rows - 1) / apply_rows, N), threads, 0, s>>>(
      (const T*)x, (const float*)a, (const float*)b, (T*)y, M, C, apply_rows);
  return (int)cudaGetLastError();
}

template <typename T, bool kIo>
int cluster_launch(const void* x, const void* gamma, const void* beta, void* y, int N,
            int M, int C, int G, int sc, int P, int rows_cta, int box_rows,
            int nbox, int threads, int smem, float eps, void* stream) {
  constexpr int V = akt::Vec<T>::N;
  const int es = sizeof(T);
  const bool ok =
      C % V == 0 && G > 0 && C % G == 0 && sc > 0 && sc <= kMaxBox &&
      C % sc == 0 && sc % (C / G) == 0 && (sc * es) % 16 == 0 && P >= 1 &&
      P <= kMaxCluster && rows_cta > 0 && (long)P * rows_cta >= M &&
      box_rows > 0 && box_rows <= kMaxBox && box_rows % 8 == 0 && nbox > 0 &&
      nbox * box_rows >= rows_cta && threads > 0 && threads <= kMaxThreads &&
      threads % col_lanes(sc / V, threads) == 0 &&
      smem == cluster_geo(sc, C / G, box_rows, nbox, threads, es).total &&
      smem <= kSmemLimit;
  if (!ok) return (int)cudaErrorInvalidValue;
  static int limit = 48 * 1024;
  const int e0 = ensure_smem((const void*)gn_cluster_kernel<T, kIo>, smem, &limit);
  if (e0) return e0;
  CUtensorMap map;
  const unsigned long long dims[3] = {(unsigned long long)C, (unsigned long long)M,
                                      (unsigned long long)N};
  const unsigned long long strides[2] = {(unsigned long long)C * es,
                                         (unsigned long long)M * C * es};
  const unsigned box[3] = {(unsigned)sc, (unsigned)box_rows, 1u};
  const int err = hop::tile_map_3d(&map, es == 2 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16
                                                 : CU_TENSOR_MAP_DATA_TYPE_FLOAT32,
                                   x, dims, strides, box);
  if (err) return err;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(P * (C / sc), N, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute at[1];
  at[0].id = cudaLaunchAttributeClusterDimension;
  at[0].val.clusterDim.x = P;
  at[0].val.clusterDim.y = 1;
  at[0].val.clusterDim.z = 1;
  cfg.attrs = at;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, gn_cluster_kernel<T, kIo>, map,
                                           (const float*)gamma, (const float*)beta,
                                           (T*)y, M, C, G, sc, rows_cta, box_rows,
                                           nbox, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// (a, b) (N, C) fp32 = the GroupNorm affine of x (N, M, C), one launch;
// part holds (N, ceil(M / rows), G) float2 partial sums, count N zeroed
// uint32 arrival counters (left zeroed); C % (16 / sizeof(T)) == 0
#define GN_STATS_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta,       \
                      void* part, void* count, void* a, void* b, int N, int M,  \
                      int C, int G, int rows, int threads, int smem, float eps, \
                      void* stream) {                                           \
    return stats<T, false>(x, gamma, beta, part, count, a, b, N, M, C, G, rows, \
                           threads, smem, eps, (cudaStream_t)stream);           \
  }
GN_STATS_ENTRY(gn_stats_bf16, __nv_bfloat16)
GN_STATS_ENTRY(gn_stats_f32, float)

// y (N, M, C) = group_norm(x) on the two-pass plan: the statistics launch
// above, then the apply over blocks of apply_rows rows; the `_io` entries
// apply the default lowering's rounded affine
#define GN_TWO_PASS_ENTRY(NAME, T, IO)                                          \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta,       \
                      void* part, void* count, void* a, void* b, void* y,       \
                      int N, int M, int C, int G, int rows, int apply_rows,     \
                      int threads, int smem, float eps, void* stream) {         \
    return two_pass<T, IO>(x, gamma, beta, part, count, a, b, y, N, M, C, G,    \
                           rows, apply_rows, threads, smem, eps, stream);       \
  }
GN_TWO_PASS_ENTRY(group_norm_two_pass_bf16, __nv_bfloat16, false)
GN_TWO_PASS_ENTRY(group_norm_two_pass_f32, float, false)
GN_TWO_PASS_ENTRY(group_norm_two_pass_io_bf16, __nv_bfloat16, true)
GN_TWO_PASS_ENTRY(group_norm_two_pass_io_f32, float, true)

// y (N, M, C) = group_norm(x) on the cluster plan: clusters of P CTAs, each
// of rows_cta rows of an sc-channel slice, loaded as nbox TMA boxes of
// box_rows rows; smem is the plan's dynamic shared bytes; `_io` as above
#define GN_CLUSTER_ENTRY(NAME, T, IO)                                           \
  extern "C" int NAME(const void* x, const void* gamma, const void* beta,       \
                      void* y, int N, int M, int C, int G, int sc, int P,       \
                      int rows_cta, int box_rows, int nbox, int threads,        \
                      int smem, float eps, void* stream) {                      \
    return cluster_launch<T, IO>(x, gamma, beta, y, N, M, C, G, sc, P,          \
                                 rows_cta, box_rows, nbox, threads, smem, eps,  \
                                 stream);                                       \
  }
GN_CLUSTER_ENTRY(group_norm_cluster_bf16, __nv_bfloat16, false)
GN_CLUSTER_ENTRY(group_norm_cluster_f32, float, false)
GN_CLUSTER_ENTRY(group_norm_cluster_io_bf16, __nv_bfloat16, true)
GN_CLUSTER_ENTRY(group_norm_cluster_io_f32, float, true)
