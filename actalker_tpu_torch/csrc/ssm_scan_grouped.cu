// K1: grouped S6 selective-scan forward for one SS2DCondV10 block.
//
// Replaces the TPU kernel actalker_tpu/ops/selective_scan_pallas.py
// `_ssm_kernel_grouped` (:592-667, and the state-major v2 at :669,
// launched by `_grouped_pallas` :904). Same function: for each group g
// (branch g/2, direction g%2) and each (batch row b, channel d):
//   delta_t = softplus(slab[t, b, g*128 : g*128+128] . dtw[g, :, d] + bias[g, d])
//   h_t     = exp(delta_t * A[g, d, :]) * h_{t-1} + delta_t * B_t * u_t
//   y_t     = C_t . h_t + D[g, d] * u_t
// with B_t / C_t at slab lanes [rank, rank+N) / [rank+N, rank+2N), and slab
// lane MASK_LANE (126) times the -1e9 dtw row turning inactive tokens into
// exact identity steps (softplus(-1e9) == 0, exp2(0) == 1). Only dtw rows
// [0, rank) and MASK_LANE may be nonzero. Odd groups walk t from L-1 down
// to 0. State is fp32, N = 16.
//
// What bounds it on the H100: the exponentials set a floor. Every token of
// every (g, b, d) chain needs 16 exp(delta * A_n) and a softplus (one exp,
// one log), and the special-function units issue 16 of them per SM per
// clock: at res-64 (5.92e8 token-chains) that is ~2.5 ms, above the bound
// that counts an exp as one fp32 operation. Bytes are small (u, the read
// slab lanes and y once each). Measured, this design runs at about twice
// the floor at res-64, and replacing the exponentials by an FMA barely
// moves it: what holds it is instruction issue and the shared-memory
// broadcasts of the projection and the walk (PERF.md).
//
// Design: one thread per chain, 128 channels of one (g, b) per block, the
// 16 states and A * log2(e) in registers, tokens in chunks of 32:
//   - staging: only the slab lanes that are read (dts [0, rank), B|C, the
//     16-byte vector holding the mask lane) and the block's u columns,
//     copied by cp.async into a ring of two chunks, so chunk c+1 loads
//     while chunk c is scanned; one pass per chunk turns the read lanes
//     into fp32 rows in shared memory (dts rank-major, B|C token-major),
//     with index arithmetic of shifts and masks only;
//   - the delta projection and softplus run for the whole chunk before its
//     serial walk: per rank, each thread reads its dtw entry once and the
//     chunk's 32 dts as 128-bit broadcasts (fp32, as the JAX kernel's
//     dot_general), and parks the 32 deltas in its column of shared memory;
//   - the serial walk reads B and C as 128-bit broadcasts and computes
//     exp(delta * A_n) as ex2.approx(delta * (A_n log2 e)) (bf16 entry; the
//     fp32 entry keeps the accurate exp2f / log1pf). It is unrolled by two
//     tokens only: a fully unrolled chunk overflows the instruction cache.
// Shared memory allows 3 blocks per SM at rank 20, so the kernel is built
// for 3 (up to 168 registers a thread). The walk stops at L, so the last
// chunk's tail is never scanned.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kN = 16;          // d_state
constexpr int kLanes = 128;     // slab lanes per group
constexpr int kMaskLane = 126;  // inactivity lane (selective_scan_pallas.MASK_LANE)
constexpr int kThreads = 128;   // channels (chains) per block
constexpr int kChunk = 32;      // tokens per ring slot
constexpr int kStages = 2;      // ring depth
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Shared-memory geometry for one (rank, element size): the block's dtw
// columns (s_dtw), the chunk's dts as fp32 rows of kS tokens, one per rank
// (s_dts), per token an fp32 row [B (16) | C (16) | mask | pad (3)]
// (s_bc), the deltas (s_dl, token-major); a ring slot holds per token the
// raw slab vectors (the first nmain, plus the one holding the mask lane
// when it lies past them) and the block's u columns.
constexpr int kS = kChunk + 4;   // s_dts row stride (4-way conflicts in the transpose)
constexpr int kBC = 2 * kN + 4;  // s_bc row stride

struct Geo {
  int ve, nmain, nraw, stride, mask_pos;
  size_t dtw_bytes, dts_bytes, bc_bytes, dl_bytes, slab_bytes, stage_bytes, total;
};

__host__ __device__ inline Geo geometry(int rank, int esize) {
  Geo g;
  g.ve = 16 / esize;
  g.nmain = (rank + 2 * kN + g.ve - 1) / g.ve;
  const bool tail = g.nmain * g.ve <= kMaskLane;
  g.nraw = g.nmain + (tail ? 1 : 0);
  // staged slab vectors per token, padded to an odd count: token rows of
  // 4 x odd words keep the token-strided conversion reads at 4-way bank
  // conflicts
  g.stride = g.nraw + 1 + (g.nraw % 2);
  g.mask_pos = tail ? g.nmain * g.ve + kMaskLane % g.ve : kMaskLane;
  g.dtw_bytes = (size_t)rank * kThreads * 4;
  g.dts_bytes = (size_t)(rank + 1) / 2 * 2 * kS * 4;
  g.bc_bytes = (size_t)kChunk * kBC * 4;
  g.dl_bytes = (size_t)kChunk * kThreads * 4;
  g.slab_bytes = (size_t)kChunk * g.stride * 16;
  g.stage_bytes = g.slab_bytes + (size_t)kChunk * kThreads * esize;
  g.total = g.dtw_bytes + g.dts_bytes + g.bc_bytes + g.dl_bytes +
            kStages * g.stage_bytes;
  return g;
}

template <bool kFast> __device__ __forceinline__ float exp2_of(float x) {
  if constexpr (kFast) return hop::exp2_fast(x);
  else return exp2f(x);
}

// softplus(x); exactly 0 at the masked tokens' x ~ -1e9
template <bool kFast> __device__ __forceinline__ float softplus(float x) {
  if constexpr (kFast) {
    const float e = hop::exp2_fast(x * kLog2e);
    return x > 20.f ? x : x < -15.f ? e : kLn2 * hop::lg2_fast(1.f + e);
  } else {
    return x > 20.f ? x : log1pf(expf(x));
  }
}

// two adjacent elements as fp32 (aligned to their pair)
__device__ __forceinline__ float2 load2(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
__device__ __forceinline__ float2 load2(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}

template <typename T, bool kRev>
__device__ __forceinline__ void scan_group(
    const T* __restrict__ u, const T* __restrict__ slab,
    const float* __restrict__ dtw, const float* __restrict__ A,
    const float* __restrict__ Dskip, const float* __restrict__ bias,
    T* __restrict__ y, int L, int B, int Dp, int G, int rank, int g, int b,
    int d0, uint8_t* smem) {
  constexpr bool kFast = sizeof(T) == 2;
  const Geo geo = geometry(rank, sizeof(T));
  float* s_dtw = reinterpret_cast<float*>(smem);                    // rank x kThreads
  float* s_dts = reinterpret_cast<float*>(smem + geo.dtw_bytes);    // rank x kS
  float* s_bc = reinterpret_cast<float*>(smem + geo.dtw_bytes + geo.dts_bytes);
  float* s_dl = s_bc + kChunk * kBC;                                  // kChunk x kThreads
  uint8_t* ring = reinterpret_cast<uint8_t*>(s_dl + kChunk * kThreads);

  const int tid = threadIdx.x;
  const int d = d0 + tid;
  const bool active = d < Dp;
  const int dd = active ? d : Dp - 1;   // idle lanes read a valid channel
  const int nbr = G / 2;

  for (int r = 0; r < rank; ++r)
    s_dtw[r * kThreads + tid] = dtw[((size_t)g * kLanes + r) * Dp + dd];
  const float wmask = dtw[((size_t)g * kLanes + kMaskLane) * Dp + dd];
  float a2[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = A[((size_t)g * Dp + dd) * kN + n] * kLog2e;
    h[n] = 0.f;
  }
  const float dsk = Dskip[(size_t)g * Dp + dd];
  const float bs = bias[(size_t)g * Dp + dd];

  const int nchunks = (L + kChunk - 1) / kChunk;
  const int raw_row = geo.stride * geo.ve;   // staged slab elements per token
  constexpr int kUvec = kThreads * sizeof(T) / 16;   // u copies per token (a power of 2)
  constexpr int kSlots = sizeof(T) == 2 ? 16 : 32;   // >= nraw, a power of 2

  // copy chunk c (memory order) into ring slot s
  auto stage = [&](int c, int s) {
    uint8_t* slot = ring + (size_t)s * geo.stage_bytes;
    const uint32_t slab_dst = hop::smem_u32(slot);
    const uint32_t u_dst = hop::smem_u32(slot + geo.slab_bytes);
    for (int i = tid; i < kChunk * kSlots; i += kThreads) {
      const int t = i / kSlots, j = i % kSlots;
      const int tok = c * kChunk + t;
      if (j < geo.nraw) {
        const size_t row = (size_t)(tok < L ? tok : 0) * B + b;
        const int lane0 = j < geo.nmain ? j * geo.ve : kLanes - geo.ve;
        hop::cp_async16(slab_dst + (uint32_t)(t * geo.stride + j) * 16,
                   slab + (row * G + g) * kLanes + lane0, tok < L);
      }
    }
    for (int i = tid; i < kChunk * kUvec; i += kThreads) {
      const int t = i / kUvec, v = i % kUvec;
      const int tok = c * kChunk + t, ch = d0 + v * geo.ve;
      const bool valid = tok < L && ch < Dp;
      const size_t row = (size_t)(tok < L ? tok : 0) * B + b;
      hop::cp_async16(u_dst + (uint32_t)i * 16,
                 u + (row * nbr + g / 2) * Dp + (valid ? ch : 0), valid);
    }
  };

  for (int s = 0; s < kStages - 1; ++s) {
    if (s < nchunks) stage(kRev ? nchunks - 1 - s : s, s);
    hop::cp_async_commit();
  }

  for (int ci = 0; ci < nchunks; ++ci) {
    const int c = kRev ? nchunks - 1 - ci : ci;
    const int t0 = c * kChunk;
    hop::cp_async_wait<kStages - 2>();
    // chunk ci has landed for every thread's copies, and chunk ci-1 (its
    // fp32 rows and ring slot) is fully consumed
    __syncthreads();
    const int cn = ci + kStages - 1;
    if (cn < nchunks) stage(kRev ? nchunks - 1 - cn : cn, cn % kStages);
    hop::cp_async_commit();

    // the read lanes to fp32: dts transposed to rank-major rows, B|C|mask
    // token-major
    const uint8_t* slot = ring + (size_t)(ci % kStages) * geo.stage_bytes;
    const T* raw = reinterpret_cast<const T*>(slot);
    // (lane = token for the dts, two ranks per step; lane = B|C lane for
    // the rest)
    for (int r = 2 * (tid / kChunk); r < rank; r += 2 * kThreads / kChunk) {
      const int t = tid % kChunk;
      const float2 v = load2(raw + t * raw_row + r);
      s_dts[r * kS + t] = v.x;
      s_dts[(r + 1) * kS + t] = v.y;
    }
    for (int i = tid; i < kChunk * 2 * kN; i += kThreads) {
      const int t = i / (2 * kN), j = i % (2 * kN);
      s_bc[t * kBC + j] = akt::to_f(raw[t * raw_row + rank + j]);
    }
    if (tid < kChunk) s_bc[tid * kBC + 2 * kN] = akt::to_f(raw[tid * raw_row + geo.mask_pos]);
    __syncthreads();

    // the chunk's delta projection and softplus, before the serial walk;
    // each thread keeps its channel's deltas in its own column of s_dl
    {
      float dl[kChunk];
#pragma unroll
      for (int t = 0; t < kChunk; ++t) dl[t] = fmaf(s_bc[t * kBC + 2 * kN], wmask, bs);
      for (int r = 0; r < rank; ++r) {
        const float w = s_dtw[r * kThreads + tid];
        const float4* row = reinterpret_cast<const float4*>(s_dts + r * kS);
#pragma unroll
        for (int q = 0; q < kChunk / 4; ++q) {
          const float4 v = row[q];
          dl[4 * q] = fmaf(v.x, w, dl[4 * q]);
          dl[4 * q + 1] = fmaf(v.y, w, dl[4 * q + 1]);
          dl[4 * q + 2] = fmaf(v.z, w, dl[4 * q + 2]);
          dl[4 * q + 3] = fmaf(v.w, w, dl[4 * q + 3]);
        }
      }
#pragma unroll
      for (int t = 0; t < kChunk; ++t)
        s_dl[t * kThreads + tid] = softplus<kFast>(dl[t]);
    }

    // the serial walk
    const T* us = reinterpret_cast<const T*>(slot + geo.slab_bytes);
    const int tn = min(kChunk, L - t0);
    T* yp = y + ((size_t)t0 * B + b) * G * Dp + (size_t)g * Dp + d;
    const size_t y_row = (size_t)B * G * Dp;
#pragma unroll 2
    for (int j = 0; j < tn; ++j) {
      const int tt = kRev ? tn - 1 - j : j;
      const float dl = s_dl[tt * kThreads + tid];
      const float uu = akt::to_f(us[tt * kThreads + tid]);
      const float dtu = dl * uu;
      const float4* bc = reinterpret_cast<const float4*>(s_bc + tt * kBC);
      float y0 = dsk * uu, y1 = 0.f;
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 bq = bc[q], cq = bc[kN / 4 + q];
        const int n = 4 * q;
        h[n] = fmaf(exp2_of<kFast>(dl * a2[n]), h[n], bq.x * dtu);
        h[n + 1] = fmaf(exp2_of<kFast>(dl * a2[n + 1]), h[n + 1], bq.y * dtu);
        h[n + 2] = fmaf(exp2_of<kFast>(dl * a2[n + 2]), h[n + 2], bq.z * dtu);
        h[n + 3] = fmaf(exp2_of<kFast>(dl * a2[n + 3]), h[n + 3], bq.w * dtu);
        y0 = fmaf(cq.x, h[n], y0);
        y1 = fmaf(cq.y, h[n + 1], y1);
        y0 = fmaf(cq.z, h[n + 2], y0);
        y1 = fmaf(cq.w, h[n + 3], y1);
      }
      if (active) yp[tt * y_row] = akt::from_f<T>(y0 + y1);
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 3)
ssm_grouped_kernel(const T* __restrict__ u, const T* __restrict__ slab,
                   const float* __restrict__ dtw, const float* __restrict__ A,
                   const float* __restrict__ Dskip, const float* __restrict__ bias,
                   T* __restrict__ y, int L, int B, int Dp, int G, int rank) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int g = blockIdx.z, b = blockIdx.y, d0 = blockIdx.x * kThreads;
  if (g & 1)
    scan_group<T, true>(u, slab, dtw, A, Dskip, bias, y, L, B, Dp, G, rank, g,
                        b, d0, smem);
  else
    scan_group<T, false>(u, slab, dtw, A, Dskip, bias, y, L, B, Dp, G, rank,
                         g, b, d0, smem);
}

template <typename T>
int launch(const void* u, const void* slab, const void* dtw, const void* A,
           const void* Dskip, const void* bias, void* y, int L, int B, int Dp,
           int G, int rank, void* stream) {
  static bool attr = false;
  if (!attr) {
    // the largest geometry (rank 94, fp32) stays well inside 227 KB
    const cudaError_t e = cudaFuncSetAttribute(
        ssm_grouped_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)geometry(kMaskLane - 2 * kN, 4).total);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((Dp + kThreads - 1) / kThreads, B, G);
  ssm_grouped_kernel<T><<<grid, kThreads, geometry(rank, sizeof(T)).total,
                          (cudaStream_t)stream>>>(
      (const T*)u, (const T*)slab, (const float*)dtw, (const float*)A,
      (const float*)Dskip, (const float*)bias, (T*)y, L, B, Dp, G, rank);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int ssm_scan_grouped_bf16(const void* u, const void* slab,
                                     const void* dtw, const void* A,
                                     const void* Dskip, const void* bias,
                                     void* y, int L, int B, int Dp, int G,
                                     int rank, void* stream) {
  return launch<__nv_bfloat16>(u, slab, dtw, A, Dskip, bias, y, L, B, Dp, G,
                               rank, stream);
}

extern "C" int ssm_scan_grouped_f32(const void* u, const void* slab,
                                    const void* dtw, const void* A,
                                    const void* Dskip, const void* bias,
                                    void* y, int L, int B, int Dp, int G,
                                    int rank, void* stream) {
  return launch<float>(u, slab, dtw, A, Dskip, bias, y, L, B, Dp, G, rank,
                       stream);
}
