// K5: single-direction S6 selective-scan forward on arranged buffers.
//
// Replaces the TPU kernel actalker_tpu/ops/selective_scan_pallas.py
// `_ssm_kernel` (:75-139, launched by `_arranged_pallas` :546). Same
// function: for each (batch row b, channel d) chain of the arranged
// (L, B, Dp) buffers
//   delta_t = softplus(dt[t, b, d] + bias[d])
//   h_t     = exp(delta_t * A[d, :]) * h_{t-1} + delta_t * B_t * u_t
//   y_t     = C_t . h_t + D[d] * u_t
// with B_t / C_t in lanes [0, N) / [N, 2N) of the NB-lane row bc[t, b, :].
// `rev` walks t from L-1 down to 0 (no flipped copies). State and
// arithmetic are fp32, N = 16; u, dt, bc and y share one dtype (bf16 or
// fp32). A row with dt = -1e9 gives softplus == 0 exactly (expf(-1e9) == 0,
// log1pf(0) == 0), so exp(0 * A) == 1: an exact identity step.
//
// What bounds it on the H100: the recurrence is serial in t. Per token and
// chain it does one softplus, 16 exps and ~50 fp32 operations against ~6-12
// bytes of u, dt and y (B|C is shared by the row's channels), so it is
// bound by the serial dependency and the exps, not by bytes.
// Design: K1's (csrc/ssm_scan_grouped.cu) without the dt projection: one
// thread per (b, d) chain holding its 16 states and its A row in
// registers; a block of 64 channels of one row b stages a chunk of 32
// tokens of u, dt and the 2N B|C lanes in shared memory, so the loads of a
// chunk are issued together and B|C is read as shared-memory broadcasts.
// A wide block (Dp = 640, B = 56) is 35,840 chains; a narrow one (Dp =
// 128, B = 8) is 1,024 chains on 16 blocks, which leaves most SMs idle.
// Chunked parallel scans (and so more chains per call) are later work.
#include "common.cuh"

namespace {

constexpr int kN = 16;         // d_state
constexpr int kThreads = 64;   // channels per block
constexpr int kChunk = 32;     // tokens staged per shared-memory chunk

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                const T* __restrict__ bc, const float* __restrict__ A,
                const float* __restrict__ Dskip, const float* __restrict__ bias,
                T* __restrict__ y, int L, int B, int Dp, int NB, int rev) {
  __shared__ float s_bc[kChunk * 2 * kN];
  __shared__ float s_u[kChunk * kThreads];
  __shared__ float s_dt[kChunk * kThreads];

  const int tid = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + tid;
  const bool active = d < Dp;
  const int dd = active ? d : Dp - 1;   // inactive lanes load a valid address

  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = A[(size_t)dd * kN + n];
    h[n] = 0.f;
  }
  const float dsk = Dskip[dd];
  const float bs = bias[dd];

  const size_t row = (size_t)B * Dp;       // t stride of u, dt and y
  const size_t bc_row = (size_t)B * NB;    // t stride of bc
  const T* u_b = u + (size_t)b * Dp + dd;
  const T* dt_b = dt + (size_t)b * Dp + dd;
  const T* bc_b = bc + (size_t)b * NB;
  T* y_b = y + (size_t)b * Dp + dd;

  const int nchunks = (L + kChunk - 1) / kChunk;
  for (int ci = 0; ci < nchunks; ++ci) {
    const int c = rev ? nchunks - 1 - ci : ci;
    const int t0 = c * kChunk;
    const int tn = min(kChunk, L - t0);
    __syncthreads();   // the previous chunk is fully consumed
    for (int i = tid; i < tn * 2 * kN; i += kThreads) {
      const int tt = i / (2 * kN), lane = i % (2 * kN);
      s_bc[i] = akt::to_f(bc_b[(size_t)(t0 + tt) * bc_row + lane]);
    }
    for (int tt = 0; tt < tn; ++tt) {
      s_u[tt * kThreads + tid] = akt::to_f(u_b[(size_t)(t0 + tt) * row]);
      s_dt[tt * kThreads + tid] = akt::to_f(dt_b[(size_t)(t0 + tt) * row]);
    }
    __syncthreads();

    for (int j = 0; j < tn; ++j) {
      const int tt = rev ? tn - 1 - j : j;
      const float* r = s_bc + tt * 2 * kN;
      const float delta = softplus(s_dt[tt * kThreads + tid] + bs);
      const float uu = s_u[tt * kThreads + tid];
      const float dtu = delta * uu;
      float yy = dsk * uu;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float da = expf(delta * a[n]);
        h[n] = da * h[n] + r[n] * dtu;
        yy += r[kN + n] * h[n];
      }
      if (active) y_b[(size_t)(t0 + tt) * row] = akt::from_f<T>(yy);
    }
  }
}

template <typename T>
int launch(const void* u, const void* dt, const void* bc, const void* A,
           const void* Dskip, const void* bias, void* y, int L, int B, int Dp,
           int NB, int rev, void* stream) {
  if (NB < 2 * kN) return (int)cudaErrorInvalidValue;
  dim3 grid((Dp + kThreads - 1) / kThreads, B);
  ssm_scan_kernel<T><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const T*)u, (const T*)dt, (const T*)bc, (const float*)A,
      (const float*)Dskip, (const float*)bias, (T*)y, L, B, Dp, NB, rev);
  return (int)cudaGetLastError();
}

}  // namespace

// y (L, B, Dp) = the scan of u / dt (L, B, Dp) with B|C lanes bc (L, B, NB),
// A (Dp, 16), D / bias (Dp,) fp32; rev != 0 scans right to left.
#define SSM_SCAN_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* u, const void* dt, const void* bc,         \
                      const void* A, const void* Dskip, const void* bias,    \
                      void* y, int L, int B, int Dp, int NB, int rev,        \
                      void* stream) {                                        \
    return launch<T>(u, dt, bc, A, Dskip, bias, y, L, B, Dp, NB, rev,        \
                     stream);                                                \
  }

SSM_SCAN_ENTRY(ssm_scan_bf16, __nv_bfloat16)
SSM_SCAN_ENTRY(ssm_scan_f32, float)
