// K1: grouped S6 selective-scan forward for one SS2DCondV10 block.
//
// Replaces the TPU kernel actalker_tpu/ops/selective_scan_pallas.py
// `_ssm_kernel_grouped` (:592-667, launched by `_grouped_pallas` :904).
// Same function: for each group g (branch g/2, direction g%2) and each
// (batch row b, channel d):
//   delta_t = softplus(slab[t, b, g*128 : g*128+128] . dtw[g, :, d] + bias[g, d])
//   h_t     = exp(delta_t * A[g, d, :]) * h_{t-1} + delta_t * B_t * u_t
//   y_t     = C_t . h_t + D[g, d] * u_t
// with B_t / C_t at slab lanes [rank, rank+N) / [rank+N, rank+2N), and slab
// lane MASK_LANE (126) times the -1e9 dtw row turning inactive tokens into
// exact identity steps (softplus(-1e9) == 0, exp(0 * A) == 1). Odd groups
// walk t from L-1 down to 0. State is fp32, N = 16.
//
// What bounds it on the H100: the recurrence is serial in t, so the work
// per (g, b, d) chain is ~L * (rank + 4N) flops with a loop-carried
// dependency; bytes are small (u, the 128-lane slab and y once each).
// Design: one thread per (g, b, d) chain holding its 16 states and A row in
// registers; the block (64 channels of one (g, b)) stages a chunk of 32
// tokens of slab rows and u in shared memory, so each token's delta
// projection reads dtw from shared memory (rank + 1 rows, only those are
// nonzero by contract) and the B/C lanes as shared-memory broadcasts.
// At res-64 (Dp = 640, B = 56, G = 4) that is 143k independent chains,
// enough to fill 132 SMs. Chunked parallel scans are later work.
#include "common.cuh"

namespace {

constexpr int kN = 16;          // d_state
constexpr int kLanes = 128;     // slab lanes per group
constexpr int kMaskLane = 126;  // inactivity lane (selective_scan_pallas.MASK_LANE)
constexpr int kThreads = 64;    // channels per block
constexpr int kChunk = 32;      // tokens staged per shared-memory chunk

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_grouped_kernel(const T* __restrict__ u, const T* __restrict__ slab,
                   const float* __restrict__ dtw, const float* __restrict__ A,
                   const float* __restrict__ Dskip, const float* __restrict__ bias,
                   T* __restrict__ y, int L, int B, int Dp, int G, int rank) {
  extern __shared__ float smem[];
  float* s_dtw = smem;                              // (rank + 1) x kThreads
  float* s_slab = s_dtw + (rank + 1) * kThreads;    // kChunk x kLanes
  float* s_u = s_slab + kChunk * kLanes;            // kChunk x kThreads

  const int tid = threadIdx.x;
  const int g = blockIdx.z;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool active = d < Dp;
  const int dd = active ? d : Dp - 1;   // inactive lanes load a valid address
  const int nbr = G / 2;
  const bool rev = (g & 1) != 0;

  for (int r = 0; r < rank; ++r)
    s_dtw[r * kThreads + tid] = dtw[((size_t)g * kLanes + r) * Dp + dd];
  s_dtw[rank * kThreads + tid] = dtw[((size_t)g * kLanes + kMaskLane) * Dp + dd];

  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = A[((size_t)g * Dp + dd) * kN + n];
    h[n] = 0.f;
  }
  const float dsk = Dskip[(size_t)g * Dp + dd];
  const float bs = bias[(size_t)g * Dp + dd];

  const size_t u_row = (size_t)B * nbr * Dp;
  const size_t s_row = (size_t)B * G * kLanes;
  const size_t y_row = (size_t)B * G * Dp;
  const T* u_base = u + (size_t)b * nbr * Dp + (size_t)(g / 2) * Dp + dd;
  const T* slab_base = slab + (size_t)b * G * kLanes + (size_t)g * kLanes;
  T* y_base = y + (size_t)b * G * Dp + (size_t)g * Dp + dd;

  const int nchunks = (L + kChunk - 1) / kChunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c = rev ? nchunks - 1 - ci : ci;
    const int t0 = c * kChunk;
    const int tn = min(kChunk, L - t0);
    __syncthreads();   // previous chunk fully consumed (and s_dtw written)
    for (int i = tid; i < tn * kLanes; i += kThreads) {
      const int tt = i / kLanes, lane = i % kLanes;
      s_slab[i] = akt::to_f(slab_base[(size_t)(t0 + tt) * s_row + lane]);
    }
    for (int tt = 0; tt < tn; ++tt)
      s_u[tt * kThreads + tid] = akt::to_f(u_base[(size_t)(t0 + tt) * u_row]);
    __syncthreads();

    for (int j = 0; j < tn; ++j) {
      const int tt = rev ? tn - 1 - j : j;
      const float* row = s_slab + tt * kLanes;
      float acc = 0.f;
      for (int r = 0; r < rank; ++r) acc += row[r] * s_dtw[r * kThreads + tid];
      acc += row[kMaskLane] * s_dtw[rank * kThreads + tid];
      const float x = acc + bs;
      const float delta = x > 20.f ? x : log1pf(expf(x));
      const float uu = s_u[tt * kThreads + tid];
      const float dtu = delta * uu;
      float yy = dsk * uu;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float da = expf(delta * a[n]);
        h[n] = da * h[n] + row[rank + n] * dtu;
        yy += row[rank + kN + n] * h[n];
      }
      if (active) y_base[(size_t)(t0 + tt) * y_row] = akt::from_f<T>(yy);
    }
  }
}

template <typename T>
int launch(const void* u, const void* slab, const void* dtw, const void* A,
           const void* Dskip, const void* bias, void* y, int L, int B, int Dp,
           int G, int rank, void* stream) {
  dim3 grid((Dp + kThreads - 1) / kThreads, B, G);
  size_t smem = sizeof(float) * ((rank + 1) * kThreads + kChunk * kLanes +
                                 kChunk * kThreads);
  ssm_grouped_kernel<T><<<grid, kThreads, smem, (cudaStream_t)stream>>>(
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
