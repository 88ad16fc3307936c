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
// `rev` walks t from L-1 down to 0 (no flipped copies): scan position p is
// token L-1-p. State and arithmetic are fp32, N = 16; u, dt, bc and y share
// one dtype (bf16 or fp32). A row with dt = -1e9 gives softplus == 0
// exactly, so exp(0 * A) == 1: an exact identity step.
//
// What bounds it on the H100: the recurrence is serial in t. Per token and
// chain it takes 16 exps and a softplus (18 special-function operations)
// against ~6-12 bytes of u, dt and y (B|C is shared by the row's channels).
// Wide shapes (the lineage's res-64 blocks: 35,840 chains) are held by the
// special-function units and instruction issue; narrow ones (MambaUPNet's
// stages: 1,024-8,192 chains, never a full wave of the card) by the
// latency of the serial chain.
//
// Design: K1's (csrc/ssm_scan_grouped.cu) without the projection. A block
// holds 64 channels of one row b (res-64's 35,840 chains make 560 blocks,
// four to five an SM); two lanes share a chain, each with 8 of its 16
// states and their A * log2(e) in registers (twice the warps to hide the
// walk's latency; the chain's y is one shuffle). Tokens come in chunks of
// 32, copied by cp.async (u and dt as 16-byte vectors of the block's
// columns, and only the 2N B|C lanes of each NB-lane row) into a ring of
// two, so chunk c+1 loads while chunk c is walked; the chunk's softplus is
// taken before its walk (the two lanes take alternate tokens); y is
// written over dt in the ring slot and stored as 16-byte vectors; the
// walk is unrolled by four tokens. The bf16 entry takes exp as ex2.approx(delta * A log2 e) and a
// fast softplus; the fp32 entry the accurate exp2f / log1pf.
// Two paths, chosen by the host plan (ops/selective_scan.py::fwd_plan) and
// checked here:
//   wide: one walk of the whole chain (seg_len >= L);
//   segments (too few chains to fill the card): the chain is cut into
//   segments of seg_len tokens that run in parallel.
//     1. each segment but the last walks from a zero state and records its
//        end state h0(j) and the running product P(j) of its decays (one
//        multiply a state; exactly 1 across masked identity steps); the
//        first segment, which really starts from zero, writes its y;
//     2. a serial join per (row, state, channel): h_start(j+1) = h0(j) +
//        P(j) h_start(j);
//     3. each later segment walks again from its h_start and writes y.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kN = 16;         // d_state
constexpr int kChunk = 32;     // tokens per ring slot
constexpr int kCh = 64;        // chains (channels) per block
constexpr int kL = 2;          // lanes per chain
constexpr int kH = kN / kL;    // states per lane
constexpr int kThreads = kL * kCh;
constexpr int kJoin = 4;       // segments whose loads the join issues together
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// one ring slot: the chunk's u (overwritten by y) and dt rows of the
// block's columns, and the 2N B|C lanes of each token
template <typename T>
struct Slot {
  static constexpr int kU = 0;
  static constexpr int kDt = kChunk * kCh * sizeof(T);
  static constexpr int kBc = 2 * kDt;
  static constexpr int kBytes = kBc + kChunk * 2 * kN * sizeof(T);
};
// dynamic shared bytes: the ring, the chunk's B|C rows as fp32, its deltas
template <typename T>
constexpr int smem_bytes() {
  return 2 * Slot<T>::kBytes + kChunk * 2 * kN * 4 + kChunk * kCh * 4;
}

template <bool kFast> __device__ __forceinline__ float exp2_of(float x) {
  if constexpr (kFast) return hop::exp2_fast(x);
  else return exp2f(x);
}

// softplus(x); exactly 0 at the masked tokens' x ~ -1e9. The fast form
// takes the series e - e^2/2 + e^3/3 of log1p(e) below x = -4, so a small
// delta keeps its relative precision.
template <bool kFast> __device__ __forceinline__ float softplus(float x) {
  if constexpr (kFast) {
    const float e = hop::exp2_fast(fminf(x, 20.f) * kLog2e);
    return x > 20.f ? x
           : x < -4.f ? e * (1.f - e * (0.5f - e * (1.f / 3.f)))
                      : kLn2 * hop::lg2_fast(1.f + e);
  } else {
    return x > 20.f ? x : log1pf(expf(x));
  }
}

// Copy the chunk at scan positions [s0, s0 + tn) into ring slot `slot` and
// commit it as one cp.async group. Channels past Dp read zeros; Dp and NB
// are multiples of 8 (the wrapper pads), so no copy straddles Dp.
template <typename T>
__device__ __forceinline__ void stage(uint32_t slot, const T* __restrict__ u,
                                      const T* __restrict__ dt,
                                      const T* __restrict__ bc, int s0, int tn,
                                      int L, int B, int Dp, int NB, int b, int d0,
                                      int rev) {
  using S = Slot<T>;
  constexpr int ve = 16 / sizeof(T);   // elements a copy
  constexpr int cu = kCh / ve;         // copies a token of u (of dt)
  constexpr int cb = 2 * kN / ve;      // of B|C
  constexpr int per = 2 * cu + cb;
  for (int i = threadIdx.x; i < tn * per; i += kThreads) {
    const int ti = i / per, j = i - ti * per;
    const int tok = rev ? L - 1 - (s0 + ti) : s0 + ti;
    const size_t row = (size_t)tok * B + b;
    if (j < 2 * cu) {
      const bool is_u = j < cu;
      const int ch = d0 + (is_u ? j : j - cu) * ve;
      const bool ok = ch < Dp;
      hop::cp_async16(slot + (is_u ? S::kU : S::kDt) + (ti * kCh + ch - d0) * sizeof(T),
                      (is_u ? u : dt) + row * Dp + (ok ? ch : 0), ok);
    } else {
      const int k = (j - 2 * cu) * ve;
      hop::cp_async16(slot + S::kBc + (ti * 2 * kN + k) * sizeof(T), bc + row * NB + k);
    }
  }
  hop::cp_async_commit();
}

// A thread's place in its block: lanes l and l + 16 of a warp share chain
// 16 * warp + (l & 15), lane half hf holding its states [8 hf, 8 hf + 8).
struct Lane {
  int ch, hf;
  __device__ __forceinline__ Lane() {
    const int tid = threadIdx.x;
    ch = (tid >> 5) * 16 + (tid & 15);
    hf = (tid >> 4) & 1;
  }
};

// Walk scan positions [sb, se) of the block's chains from the state h (the
// lane's 8 states). kY: write y; kRec: keep the running product pr of the
// decays.
template <typename T, bool kY, bool kRec>
__device__ __forceinline__ void walk(const T* __restrict__ u, const T* __restrict__ dt,
                                     const T* __restrict__ bc, T* __restrict__ y,
                                     int L, int B, int Dp, int NB, int rev, int b,
                                     int d0, int sb, int se, const float (&a2)[kH],
                                     float dsk, float bs, float (&h)[kH],
                                     float (&pr)[kH], uint8_t* smem) {
  using S = Slot<T>;
  constexpr bool kFast = sizeof(T) == 2;
  constexpr int ve = 16 / sizeof(T), cu = kCh / ve;
  float* s_bc = reinterpret_cast<float*>(smem + 2 * S::kBytes);   // [kChunk][2N]
  float* s_dl = s_bc + kChunk * 2 * kN;                            // [kChunk][kCh]
  const uint32_t ring = hop::smem_u32(smem);
  const int tid = threadIdx.x;
  const Lane ln;
  const int ch = ln.ch, n0 = ln.hf * kH;
  const int nchunks = (se - sb + kChunk - 1) / kChunk;
  stage<T>(ring, u, dt, bc, sb, min(kChunk, se - sb), L, B, Dp, NB, b, d0, rev);
  for (int c = 0; c < nchunks; ++c) {
    const int s0 = sb + c * kChunk, tn = min(kChunk, se - s0);
    hop::cp_async_wait<0>();
    __syncthreads();   // chunk c landed; chunk c-1's slot, s_bc and s_dl are free
    if (c + 1 < nchunks)
      stage<T>(ring + ((c + 1) & 1) * S::kBytes, u, dt, bc, s0 + kChunk,
               min(kChunk, se - s0 - kChunk), L, B, Dp, NB, b, d0, rev);
    uint8_t* slot = smem + (c & 1) * S::kBytes;
    const T* us = reinterpret_cast<const T*>(slot + S::kU);
    T* dts = reinterpret_cast<T*>(slot + S::kDt);   // dt in; y out, after the softplus
    const T* bcs = reinterpret_cast<const T*>(slot + S::kBc);
    for (int i = tid; i < tn * 2 * kN; i += kThreads) s_bc[i] = akt::to_f(bcs[i]);
    // the chain's two lanes split the chunk's tokens
    for (int i = ln.hf; i < tn; i += kL)
      s_dl[i * kCh + ch] = softplus<kFast>(akt::to_f(dts[i * kCh + ch]) + bs);
    __syncthreads();   // s_bc, s_dl; the dt rows are consumed
#pragma unroll 4
    for (int i = 0; i < tn; ++i) {
      const float dl = s_dl[i * kCh + ch];
      const float uu = akt::to_f(us[i * kCh + ch]);
      const float dtu = dl * uu;
      const float4* bq = reinterpret_cast<const float4*>(s_bc + i * 2 * kN + n0);
      const float4* cq = reinterpret_cast<const float4*>(s_bc + i * 2 * kN + kN + n0);
      float y0 = n0 == 0 ? dsk * uu : 0.f, y1 = 0.f;
#pragma unroll
      for (int q = 0; q < kH / 4; ++q) {
        const float4 bb = bq[q], cc = cq[q];
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          const float a = exp2_of<kFast>(dl * a2[n]);
          if constexpr (kRec) pr[n] *= a;
          h[n] = fmaf(a, h[n], bv[e] * dtu);
          if (e & 1) y1 = fmaf(cv[e], h[n], y1);
          else y0 = fmaf(cv[e], h[n], y0);
        }
      }
      if constexpr (kY) {
        const float yv = y0 + y1;
        const float yc = yv + __shfl_xor_sync(0xffffffffu, yv, 16);   // the chain's sum
        if (n0 == 0) dts[i * kCh + ch] = akt::from_f<T>(yc);
      }
    }
    if constexpr (kY) {
      __syncthreads();   // the chunk's y is in the slot
      for (int i = tid; i < tn * cu; i += kThreads) {
        const int ti = i / cu, d = d0 + (i - ti * cu) * ve;
        if (d < Dp) {
          const int tok = rev ? L - 1 - (s0 + ti) : s0 + ti;
          *reinterpret_cast<uint4*>(y + ((size_t)tok * B + b) * Dp + d) =
              *reinterpret_cast<const uint4*>(slot + S::kDt + (ti * kCh + d - d0) * sizeof(T));
        }
      }
    }
  }
}

// the chain's constants: its lane's A * log2(e), D, bias (idle lanes read
// channel Dp-1)
__device__ __forceinline__ void chain_consts(const float* __restrict__ A,
                                            const float* __restrict__ Dskip,
                                            const float* __restrict__ bias, int Dp,
                                            int d, int n0, float (&a2)[kH], float& dsk,
                                            float& bs) {
  const int dd = d < Dp ? d : Dp - 1;
#pragma unroll
  for (int n = 0; n < kH; ++n) a2[n] = A[(size_t)dd * kN + n0 + n] * kLog2e;
  dsk = Dskip[dd];
  bs = bias[dd];
}

// ---- wide: one walk a chain --------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
ssm_scan_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                const T* __restrict__ bc, const float* __restrict__ A,
                const float* __restrict__ Dskip, const float* __restrict__ bias,
                T* __restrict__ y, int L, int B, int Dp, int NB, int rev) {
  extern __shared__ __align__(16) uint8_t smem[];
  const int b = blockIdx.y, d0 = blockIdx.x * kCh;
  const Lane ln;
  float a2[kH], h[kH], pr[kH], dsk, bs;
  chain_consts(A, Dskip, bias, Dp, d0 + ln.ch, ln.hf * kH, a2, dsk, bs);
#pragma unroll
  for (int n = 0; n < kH; ++n) h[n] = 0.f;
  walk<T, true, false>(u, dt, bc, y, L, B, Dp, NB, rev, b, d0, 0, L, a2, dsk, bs, h,
                       pr, smem);
}

// ---- segments: 1. replay from zero, 3. walk from the joined state -------

// grid (Dp / kCh, nseg - 1, B). phase 1: segment j = blockIdx.y (all but
// the last) from zero, records h0 / P in seg_h / seg_p (nseg - 1, B, N,
// Dp); segment 0 writes y. phase 3: segment j = blockIdx.y + 1 from
// seg_h[j - 1] (the join's h_start(j)), writes y.
template <typename T>
__global__ void __launch_bounds__(kThreads, 6)
ssm_scan_seg_kernel(const T* __restrict__ u, const T* __restrict__ dt,
                    const T* __restrict__ bc, const float* __restrict__ A,
                    const float* __restrict__ Dskip, const float* __restrict__ bias,
                    T* __restrict__ y, float* __restrict__ seg_h,
                    float* __restrict__ seg_p, int L, int B, int Dp, int NB,
                    int rev, int seg_len, int phase) {
  extern __shared__ __align__(16) uint8_t smem[];
  const Lane ln;
  const int b = blockIdx.z, d0 = blockIdx.x * kCh, d = d0 + ln.ch, n0 = ln.hf * kH;
  const int j = phase == 1 ? blockIdx.y : blockIdx.y + 1;
  const int sb = j * seg_len, se = min(L, sb + seg_len);
  float a2[kH], h[kH], pr[kH], dsk, bs;
  chain_consts(A, Dskip, bias, Dp, d, n0, a2, dsk, bs);
  // [j'][b][n][d]
  const size_t rec = (((size_t)blockIdx.y * B + b) * kN + n0) * Dp + d;
  if (phase == 3) {
#pragma unroll
    for (int n = 0; n < kH; ++n) h[n] = d < Dp ? seg_h[rec + (size_t)n * Dp] : 0.f;
    walk<T, true, false>(u, dt, bc, y, L, B, Dp, NB, rev, b, d0, sb, se, a2, dsk, bs,
                         h, pr, smem);
    return;
  }
#pragma unroll
  for (int n = 0; n < kH; ++n) {
    h[n] = 0.f;
    pr[n] = 1.f;
  }
  if (j == 0)
    walk<T, true, false>(u, dt, bc, y, L, B, Dp, NB, rev, b, d0, sb, se, a2, dsk, bs,
                         h, pr, smem);
  else
    walk<T, false, true>(u, dt, bc, y, L, B, Dp, NB, rev, b, d0, sb, se, a2, dsk, bs,
                         h, pr, smem);
  if (d < Dp) {
#pragma unroll
    for (int n = 0; n < kH; ++n) {
      seg_h[rec + (size_t)n * Dp] = h[n];
      seg_p[rec + (size_t)n * Dp] = pr[n];
    }
  }
}

// ---- segments: 2. join ----------------------------------------------------

// One thread per (row, state, channel): seg_h[j] from segment j's local end
// state to h_start(j + 1) = h0(j) + P(j) h_start(j) (segment 0 starts from
// zero, so h_start(1) = h0(0); its P is not read).
__global__ void ssm_scan_join_kernel(float* __restrict__ seg_h,
                                     const float* __restrict__ seg_p, int B,
                                     int Dp, int nrec) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * kN * Dp) return;
  const size_t stride = (size_t)B * kN * Dp;
  float* hp = seg_h + i;
  const float* pp = seg_p + i;
  float hs = 0.f;
  for (int j0 = 0; j0 < nrec; j0 += kJoin) {
    float h0[kJoin], p[kJoin];
#pragma unroll
    for (int k = 0; k < kJoin; ++k) {
      const bool ok = j0 + k < nrec;
      h0[k] = ok ? hp[(j0 + k) * stride] : 0.f;
      p[k] = ok && j0 + k > 0 ? pp[(j0 + k) * stride] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kJoin; ++k) {
      if (j0 + k < nrec) {
        hs = fmaf(p[k], hs, h0[k]);
        hp[(j0 + k) * stride] = hs;
      }
    }
  }
}

template <typename T>
int launch(const void* u, const void* dt, const void* bc, const void* A,
           const void* Dskip, const void* bias, void* y, void* seg_h, void* seg_p,
           int L, int B, int Dp, int NB, int rev, int seg_len, int smem,
           void* stream) {
  if (L < 1 || B < 1 || Dp < 8 || Dp % 8 || NB < 2 * kN || NB % 8 ||
      seg_len <= 0 || seg_len % kChunk || smem != smem_bytes<T>())
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssm_scan_seg_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  cudaStream_t s = (cudaStream_t)stream;
  const int nblk = (Dp + kCh - 1) / kCh;
  const int nseg = (L + seg_len - 1) / seg_len;
  if (nseg == 1) {
    ssm_scan_kernel<T><<<dim3(nblk, B), kThreads, smem, s>>>(
        (const T*)u, (const T*)dt, (const T*)bc, (const float*)A,
        (const float*)Dskip, (const float*)bias, (T*)y, L, B, Dp, NB, rev);
    return (int)cudaGetLastError();
  }
  if (seg_h == nullptr || seg_p == nullptr) return (int)cudaErrorInvalidValue;
  for (int phase = 1; phase <= 3; phase += 2) {
    if (phase == 3) {
      const int n = B * kN * Dp;
      ssm_scan_join_kernel<<<(n + 255) / 256, 256, 0, s>>>(
          (float*)seg_h, (const float*)seg_p, B, Dp, nseg - 1);
      const cudaError_t e = cudaGetLastError();
      if (e != cudaSuccess) return (int)e;
    }
    ssm_scan_seg_kernel<T><<<dim3(nblk, nseg - 1, B), kThreads, smem, s>>>(
        (const T*)u, (const T*)dt, (const T*)bc, (const float*)A,
        (const float*)Dskip, (const float*)bias, (T*)y, (float*)seg_h,
        (float*)seg_p, L, B, Dp, NB, rev, seg_len, phase);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// y (L, B, Dp) = the scan of u / dt (L, B, Dp) with B|C lanes bc (L, B, NB),
// A (Dp, 16), D / bias (Dp,) fp32; rev != 0 scans right to left. Dp and NB
// are multiples of 8. seg_len >= L: one wide launch (seg_h / seg_p unused);
// else the segment path, three launches, with seg_h / seg_p (ceil(L /
// seg_len) - 1, B, 16, Dp) fp32 scratch. smem: the plan's dynamic shared
// bytes; a plan that disagrees is refused.
#define SSM_SCAN_ENTRY(NAME, T)                                               \
  extern "C" int NAME(const void* u, const void* dt, const void* bc,         \
                      const void* A, const void* Dskip, const void* bias,    \
                      void* y, void* seg_h, void* seg_p, int L, int B,       \
                      int Dp, int NB, int rev, int seg_len, int smem,        \
                      void* stream) {                                        \
    return launch<T>(u, dt, bc, A, Dskip, bias, y, seg_h, seg_p, L, B, Dp,   \
                     NB, rev, seg_len, smem, stream);                        \
  }

SSM_SCAN_ENTRY(ssm_scan_bf16, __nv_bfloat16)
SSM_SCAN_ENTRY(ssm_scan_f32, float)

// Tokens a ring slot holds (seg_len is a multiple of it) and chains a
// block: the plan's FWD_CHUNK and FWD_BLOCK.
extern "C" int ssm_scan_chunk() { return kChunk; }
extern "C" int ssm_scan_block() { return kCh; }
