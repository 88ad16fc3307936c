// K6: adjoint (backward) of one arranged S6 selective scan.
//
// Replaces the TPU kernels actalker_tpu/ops/selective_scan_pallas.py
// `_boundary_kernel` (:154-197, forward replay that records the state
// entering each L-chunk) and `_bwd_kernel` (:200-327, the adjoint walk),
// both launched by `_arranged_grad_tpu` (:387, :408). One C call here runs
// the same two passes as two kernels.
//
// Per (batch row b, channel d) chain, state n (N = 16), with
//   delta_t = softplus(dtr_t + bias), a = exp(delta A), p = delta u,
//   h_t = a_t h_{t-1} + B_t p_t,  y_t = sum_n C_n h_n + D u_t,
// the adjoint g_t = dy_t C_t + a_{t+1} g_{t+1} (scan order) gives
//   du = delta sum_n g B + D dy
//   ddt = (u sum_n g B + sum_n g A a h_{t-1}) * sigmoid(dtr + bias)
//   dB_n = sum_d g_n p,  dC_n = sum_d dy h_n        (sums over channels)
//   dA_n = sum_t g_n h_{t-1,n} delta a_n,  dD = sum_t dy u   (over tokens)
// `rev` walks t from L-1 down to 0. Masked tokens (dtr ~ -1e9) give
// softplus 0, sigmoid 0 and a = 1: exact identity steps, no NaN.
//
// What bounds it on the H100: the recurrence is serial in t; per token and
// chain it does 3 x 16 exps (forward replay, chunk recompute, adjoint) and
// ~10 x 16 fma, against ~14 bytes of token rows read and written per
// chain. It is bound by the serial dependency and the SFU's exps, not by
// bytes.
// Design: one thread per (b, d) chain, one warp per block, so the
// cross-channel sums dB / dC are a warp-level reduce-scatter (31 shuffles
// for all 32 values of a token; lane i ends with value i) written as
// per-warp partials (L, B, Dp/32, 2N) that the wrapper sums. Pass 1 writes
// the fp32 state entering every chunk of kChunk tokens. Pass 2 walks the
// chunks in reverse scan order: it recomputes the chunk's states into
// shared memory (state-major, lane-minor: conflict-free), then runs the
// adjoint backwards through it; dA / dD accumulate in registers and are
// written per (b, d) for the wrapper to sum over b.
#include "common.cuh"

namespace {

constexpr int kN = 16;        // d_state
constexpr int kThreads = 32;  // channels per block: one warp
constexpr int kChunk = 16;    // tokens between saved states

__device__ __forceinline__ float softplus(float x) {
  return x > 20.f ? x : log1pf(expf(x));
}

// Warp reduce-scatter step: keep one half of the 2*O live values, add the
// partner's copy of that half. After steps 16, 8, 4, 2, 1 lane i holds the
// warp-wide sum of value i in v[0].
template <int O>
__device__ __forceinline__ void rs_step(float* v, int lane) {
  const bool up = (lane & O) != 0;
#pragma unroll
  for (int i = 0; i < O; ++i) {
    const float send = up ? v[i] : v[i + O];
    const float keep = up ? v[i + O] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, O);
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
boundary_kernel(const T* __restrict__ u, const float* __restrict__ dtr,
                const T* __restrict__ bc, const float* __restrict__ A,
                const float* __restrict__ bias, float* __restrict__ bnd,
                int L, int B, int Dp, int NB, int rev) {
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < Dp;
  const int dd = active ? d : Dp - 1;
  float a[kN], h[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = A[(size_t)dd * kN + n];
    h[n] = 0.f;
  }
  const float bs = bias[dd];
  const int nchunk = (L + kChunk - 1) / kChunk;
  for (int c = 0; c < nchunk; ++c) {
    if (active) {
#pragma unroll
      for (int n = 0; n < kN; ++n)
        bnd[(((size_t)c * B + b) * kN + n) * Dp + d] = h[n];
    }
    const int s1 = min(L, (c + 1) * kChunk);
    for (int s = c * kChunk; s < s1; ++s) {
      const int t = rev ? L - 1 - s : s;
      const size_t row = (size_t)t * B + b;
      const float delta = softplus(dtr[row * Dp + dd] + bs);
      const float p = delta * akt::to_f(u[row * Dp + dd]);
      const T* bcr = bc + row * NB;
#pragma unroll
      for (int n = 0; n < kN; ++n)
        h[n] = expf(delta * a[n]) * h[n] + akt::to_f(bcr[n]) * p;
    }
  }
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adjoint_kernel(const T* __restrict__ u, const float* __restrict__ dtr,
               const T* __restrict__ bc, const float* __restrict__ A,
               const float* __restrict__ Dskip, const float* __restrict__ bias,
               const T* __restrict__ dy, const float* __restrict__ bnd,
               T* __restrict__ du, float* __restrict__ ddt,
               float* __restrict__ dbc_part, float* __restrict__ da_part,
               float* __restrict__ dd_part, int L, int B, int Dp, int NB,
               int rev) {
  // hist[i][n][lane]: slot 0 = state entering the chunk, slot i + 1 = state
  // after the chunk's i-th token (scan order)
  __shared__ float hist[(kChunk + 1) * kN * kThreads];
  __shared__ float s_bc[kChunk * 2 * kN];

  const int lane = threadIdx.x;
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + lane;
  const int nwarp = (Dp + kThreads - 1) / kThreads;
  const bool active = d < Dp;
  const int dd = active ? d : Dp - 1;

  float a[kN], g[kN], da_acc[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a[n] = A[(size_t)dd * kN + n];
    g[n] = 0.f;
    da_acc[n] = 0.f;
  }
  const float bs = bias[dd];
  const float dsk = Dskip[dd];
  float dd_acc = 0.f;

  const int nchunk = (L + kChunk - 1) / kChunk;
  for (int c = nchunk - 1; c >= 0; --c) {
    const int s0 = c * kChunk;
    const int tn = min(kChunk, L - s0);
    __syncwarp();   // previous chunk's reads of hist / s_bc are done
    for (int i = lane; i < tn * 2 * kN; i += kThreads) {
      const int ti = i / (2 * kN), k = i % (2 * kN);
      const int t = rev ? L - 1 - (s0 + ti) : s0 + ti;
      s_bc[i] = akt::to_f(bc[((size_t)t * B + b) * NB + k]);
    }
    float h[kN];
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      h[n] = bnd[(((size_t)c * B + b) * kN + n) * Dp + dd];
      hist[n * kThreads + lane] = h[n];
    }
    __syncwarp();
    // forward recompute of the chunk into hist
    for (int i = 0; i < tn; ++i) {
      const int t = rev ? L - 1 - (s0 + i) : s0 + i;
      const size_t row = (size_t)t * B + b;
      const float delta = softplus(dtr[row * Dp + dd] + bs);
      const float p = delta * akt::to_f(u[row * Dp + dd]);
      float* hs = hist + (size_t)(i + 1) * kN * kThreads;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        h[n] = expf(delta * a[n]) * h[n] + s_bc[i * 2 * kN + n] * p;
        hs[n * kThreads + lane] = h[n];
      }
    }
    // adjoint walk, reverse scan order
    for (int i = tn - 1; i >= 0; --i) {
      const int t = rev ? L - 1 - (s0 + i) : s0 + i;
      const size_t row = (size_t)t * B + b;
      const float x = dtr[row * Dp + dd] + bs;
      const float delta = softplus(x);
      const float sig = 1.f / (1.f + expf(-x));
      const float uu = akt::to_f(u[row * Dp + dd]);
      const float dyy = active ? akt::to_f(dy[row * Dp + dd]) : 0.f;
      const float p = delta * uu;
      const float* bcr = s_bc + i * 2 * kN;
      const float* hm1 = hist + (size_t)i * kN * kThreads;
      const float* ht = hm1 + kN * kThreads;
      float v[2 * kN];   // [dB partials | dC partials] for the warp reduction
      float gb = 0.f, gah = 0.f;
#pragma unroll
      for (int n = 0; n < kN; ++n) {
        const float hp = hm1[n * kThreads + lane];
        const float an = expf(delta * a[n]);
        const float gn = g[n] + dyy * bcr[kN + n];
        gb += gn * bcr[n];
        gah += gn * a[n] * an * hp;
        v[n] = gn * p;
        v[kN + n] = dyy * ht[n * kThreads + lane];
        da_acc[n] += gn * hp * delta * an;
        g[n] = gn * an;
      }
      if (!active) {
#pragma unroll
        for (int n = 0; n < 2 * kN; ++n) v[n] = 0.f;
      }
      rs_step<16>(v, lane);
      rs_step<8>(v, lane);
      rs_step<4>(v, lane);
      rs_step<2>(v, lane);
      rs_step<1>(v, lane);
      dbc_part[(row * nwarp + blockIdx.x) * (2 * kN) + lane] = v[0];
      if (active) {
        du[row * Dp + d] = akt::from_f<T>(delta * gb + dsk * dyy);
        ddt[row * Dp + d] = (uu * gb + gah) * sig;
        dd_acc += dyy * uu;
      }
    }
  }
  if (active) {
#pragma unroll
    for (int n = 0; n < kN; ++n) da_part[((size_t)b * Dp + d) * kN + n] = da_acc[n];
    dd_part[(size_t)b * Dp + d] = dd_acc;
  }
}

template <typename T>
int launch(const void* u, const void* dtr, const void* bc, const void* A,
           const void* Dskip, const void* bias, const void* dy, void* bnd,
           void* du, void* ddt, void* dbc_part, void* da_part, void* dd_part,
           int L, int B, int Dp, int NB, int rev, void* stream) {
  if (NB < 2 * kN) return (int)cudaErrorInvalidValue;
  dim3 grid((Dp + kThreads - 1) / kThreads, B);
  cudaStream_t s = (cudaStream_t)stream;
  boundary_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)u, (const float*)dtr, (const T*)bc, (const float*)A,
      (const float*)bias, (float*)bnd, L, B, Dp, NB, rev);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  adjoint_kernel<T><<<grid, kThreads, 0, s>>>(
      (const T*)u, (const float*)dtr, (const T*)bc, (const float*)A,
      (const float*)Dskip, (const float*)bias, (const T*)dy,
      (const float*)bnd, (T*)du, (float*)ddt, (float*)dbc_part,
      (float*)da_part, (float*)dd_part, L, B, Dp, NB, rev);
  return (int)cudaGetLastError();
}

}  // namespace

#define SSM_BWD_ENTRY(NAME, T)                                                \
  extern "C" int NAME(const void* u, const void* dtr, const void* bc,         \
                      const void* A, const void* Dskip, const void* bias,     \
                      const void* dy, void* bnd, void* du, void* ddt,         \
                      void* dbc_part, void* da_part, void* dd_part, int L,    \
                      int B, int Dp, int NB, int rev, void* stream) {         \
    return launch<T>(u, dtr, bc, A, Dskip, bias, dy, bnd, du, ddt, dbc_part,  \
                     da_part, dd_part, L, B, Dp, NB, rev, stream);            \
  }

SSM_BWD_ENTRY(ssm_scan_bwd_bf16, __nv_bfloat16)
SSM_BWD_ENTRY(ssm_scan_bwd_f32, float)

// Tokens between saved states: the wrapper sizes `bnd` as
// (ceil(L / chunk), B, N, Dp) fp32 from this.
extern "C" int ssm_scan_bwd_chunk() { return kChunk; }
