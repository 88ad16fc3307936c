// K6: adjoint (backward) of one arranged S6 selective scan.
//
// Replaces the TPU kernels actalker_tpu/ops/selective_scan_pallas.py
// `_boundary_kernel` (:154-197, forward replay that records the state
// entering each L-chunk) and `_bwd_kernel` (:200-327, the adjoint walk),
// both launched by `_arranged_grad_tpu` (:387, :408).
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
// What bounds it on the H100: neither bytes nor flops but the
// special-function units and instruction issue. Per token and chain it
// needs 16 exps for the forward states and 16 for the adjoint's decays
// (plus the softplus and sigmoid), against ~14 bytes of token rows.
//
// Design: the chain is cut into segments of `seg_len` tokens (a multiple
// of kT) that run in parallel, joined by a short serial pass. A is
// diagonal, so across a segment of total delta S the state and the adjoint
// carry both decay by exp(A_n S):
//   1. replay (one thread per chain and segment, 128 channels a block):
//      walks the segment from a zero state and records, per sub-chunk of
//      kT tokens, that local state h0 and the delta summed so far; at the
//      segment's end its h0, S, and e0 = sum_t (prod_{s<=t} a_s) dy_t C_t,
//      the adjoint carry the segment would hand back from a zero carry
//      (the running product of the decays costs one multiply per state);
//   2. join (one thread per chain and state): h_start(j+1) = h0(j) +
//      exp(A S_j) h_start(j) forward, K(j-1) = e0(j) + exp(A S_j) K(j)
//      backward, over the ~L / seg_len segments;
//   3. adjoint (two lanes per chain and segment, 8 states each, 16 kW
//      chains a block): the segment's sub-chunks in reverse scan order;
//      each starts from its checkpoint h0 + exp(A * delta so far) h_start,
//      recomputes the state entering each of its tokens into shared memory
//      (kT x N x 4 bytes a chain), then walks the adjoint back through them
//      from the carry K.
// The replay and the adjoint stage their token rows (u, dtr, dy, the 32
// B|C lanes, the checkpoint) with cp.async into a ring of two sub-chunks,
// so no global load sits on the serial path; exp(delta A) is ex2.approx with A
// pre-scaled by log2 e (in the adjoint too: one SFU op, recomputed rather
// than kept, since keeping it doubles the history and halves the warps in
// flight). Two lanes a chain halve each lane's serial work and double the
// warps that fit the shared memory. The cross-channel sums dB / dC reduce
// over a warp's 16 chains by shuffles and over the block's warps in shared
// memory, leaving one partial per 64 channels; dA, dD and dbias leave one
// partial per (segment, row, channel).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kN = 16;            // d_state
constexpr int kT = 8;             // tokens per sub-chunk (checkpoint spacing)
constexpr int kH = kN / 2;        // states per lane of the adjoint (two lanes a chain)
constexpr int kW = 4;             // warps per adjoint block
constexpr int kCh3 = 16 * kW;     // channels (chains) per adjoint block
constexpr int kCh1 = 128;         // channels per replay block
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// (softplus(x), sigmoid(x)); exactly (0, 0) at the masked tokens' x ~ -1e9.
// Below x = -4 softplus is the series e - e^2/2 + e^3/3 of log1p(e), so a
// small delta keeps its relative precision.
__device__ __forceinline__ float2 softplus_sigmoid(float x) {
  const float e = hop::exp2_fast(fminf(x, 20.f) * kLog2e);
  const float sp = x > 20.f ? x
                   : x < -4.f ? e * (1.f - e * (0.5f - e * (1.f / 3.f)))
                              : kLn2 * hop::lg2_fast(1.f + e);
  return make_float2(sp, __fdividef(e, 1.f + e));
}

// One ring slot: the rows of kT tokens (scan order) for kCh channels, the
// 2N B|C lanes of each token, and for the adjoint the sub-chunk's
// checkpoint (N state rows and the delta sum, kCh channels each).
template <typename T, int kCh, bool kCk>
struct Slot {
  static constexpr int kU = 0;
  static constexpr int kDy = kT * kCh * sizeof(T);
  static constexpr int kDtr = 2 * kDy;
  static constexpr int kBc = kDtr + kT * kCh * 4;
  static constexpr int kCkp = kBc + kT * 2 * kN * sizeof(T);
  static constexpr int kBytes = kCkp + (kCk ? (kN + 1) * kCh * 4 : 0);
};

// Copy sub-chunk `cg` (scan positions s0 .. s0 + tn - 1) into ring slot
// `slot` and commit it as one cp.async group. Channels past Dp are zero;
// Dp is a multiple of 8 (the wrapper pads), so no 16-byte copy straddles it.
template <typename T, int kCh, bool kCk>
__device__ __forceinline__ void stage(uint32_t slot, const T* __restrict__ u,
                                      const float* __restrict__ dtr,
                                      const T* __restrict__ dy,
                                      const T* __restrict__ bc,
                                      const float* __restrict__ ck_h,
                                      const float* __restrict__ ck_cum, int cg,
                                      int s0, int tn, int L, int B, int Dp,
                                      int NB, int b, int d0, int rev) {
  using G = Slot<T, kCh, kCk>;
  constexpr int ve = 16 / sizeof(T);   // elements per 16-byte copy
  constexpr int cu = kCh / ve;         // copies per token of u (of dy)
  constexpr int cd = kCh / 4;          // of dtr
  constexpr int cb = 2 * kN / ve;      // of B|C
  constexpr int per = 2 * cu + cd + cb;
  for (int i = threadIdx.x; i < kT * per; i += blockDim.x) {
    const int ti = i / per, j = i - ti * per;
    if (ti >= tn) continue;
    const int tok = rev ? L - 1 - (s0 + ti) : s0 + ti;
    const size_t row = (size_t)tok * B + b;
    if (j < 2 * cu) {
      const bool is_u = j < cu;
      const int ch = d0 + (is_u ? j : j - cu) * ve;
      const bool ok = ch < Dp;
      hop::cp_async16(slot + (is_u ? G::kU : G::kDy) + (ti * kCh + ch - d0) * sizeof(T),
                      (is_u ? u : dy) + row * Dp + (ok ? ch : 0), ok);
    } else if (j < 2 * cu + cd) {
      const int ch = d0 + (j - 2 * cu) * 4;
      const bool ok = ch < Dp;
      hop::cp_async16(slot + G::kDtr + (ti * kCh + ch - d0) * 4,
                      dtr + row * Dp + (ok ? ch : 0), ok);
    } else {
      const int k = (j - 2 * cu - cd) * ve;
      hop::cp_async16(slot + G::kBc + (ti * 2 * kN + k) * sizeof(T), bc + row * NB + k);
    }
  }
  if constexpr (kCk) {
    constexpr int cc = kCh / 4;
    for (int i = threadIdx.x; i < (kN + 1) * cc; i += blockDim.x) {
      const int n = i / cc, ch = d0 + (i - n * cc) * 4;
      const bool ok = ch < Dp;
      const float* src = n < kN ? ck_h + (((size_t)cg * B + b) * kN + n) * Dp
                                : ck_cum + ((size_t)cg * B + b) * Dp;
      hop::cp_async16(slot + G::kCkp + (n * kCh + ch - d0) * 4, src + (ok ? ch : 0), ok);
    }
  }
  hop::cp_async_commit();
}

// the slot's B|C rows as fp32 [kT][2N] (tn tokens)
template <typename T>
__device__ __forceinline__ void bc_to_f32(const uint8_t* raw, float* s_bc, int tn) {
  const T* r = reinterpret_cast<const T*>(raw);
  for (int i = threadIdx.x; i < tn * 2 * kN; i += blockDim.x) s_bc[i] = akt::to_f(r[i]);
}

// ---- 1. replay ----------------------------------------------------------

template <typename T>
__global__ void __launch_bounds__(kCh1)
ssm_bwd_replay_kernel(const T* __restrict__ u, const float* __restrict__ dtr,
                      const T* __restrict__ bc, const T* __restrict__ dy,
                      const float* __restrict__ A, const float* __restrict__ bias,
                      float* __restrict__ ck_h, float* __restrict__ ck_cum,
                      float* __restrict__ seg_h, float* __restrict__ seg_e,
                      float* __restrict__ seg_cum, int L, int B, int Dp, int NB,
                      int rev, int seg_len) {
  using G = Slot<T, kCh1, false>;
  extern __shared__ __align__(16) uint8_t smem[];
  float* s_bc = reinterpret_cast<float*>(smem + 2 * G::kBytes);
  const uint32_t ring = hop::smem_u32(smem);
  const int tid = threadIdx.x, j = blockIdx.y, b = blockIdx.z;
  const int d0 = blockIdx.x * kCh1, d = d0 + tid;
  const bool active = d < Dp;
  const int dd = active ? d : Dp - 1;

  float a2[kN], h[kN], P[kN], e[kN];
#pragma unroll
  for (int n = 0; n < kN; ++n) {
    a2[n] = A[(size_t)dd * kN + n] * kLog2e;
    h[n] = 0.f;
    P[n] = 1.f;
    e[n] = 0.f;
  }
  const float bs = bias[dd];
  float cum = 0.f;
  const int sb = j * seg_len, se = min(L, sb + seg_len);
  const int nsub = (se - sb + kT - 1) / kT, cg0 = sb / kT;
  auto stage_sub = [&](int c) {
    stage<T, kCh1, false>(ring + (c & 1) * G::kBytes, u, dtr, dy, bc, nullptr,
                          nullptr, 0, sb + c * kT, min(kT, se - sb - c * kT),
                          L, B, Dp, NB, b, d0, rev);
  };
  stage_sub(0);
  for (int c = 0; c < nsub; ++c) {
    hop::cp_async_wait<0>();
    __syncthreads();   // sub-chunk c landed; c - 1's slot and s_bc are free
    if (c + 1 < nsub) stage_sub(c + 1);
    const int tn = min(kT, se - sb - c * kT);
    const uint8_t* slot = smem + (c & 1) * G::kBytes;
    bc_to_f32<T>(slot + G::kBc, s_bc, tn);
    if (active) {
      const size_t o = ((size_t)(cg0 + c) * B + b) * kN * Dp + d;
#pragma unroll
      for (int n = 0; n < kN; ++n) ck_h[o + (size_t)n * Dp] = h[n];
      ck_cum[((size_t)(cg0 + c) * B + b) * Dp + d] = cum;
    }
    __syncthreads();
    const T* us = reinterpret_cast<const T*>(slot + G::kU);
    const T* dys = reinterpret_cast<const T*>(slot + G::kDy);
    const float* xs = reinterpret_cast<const float*>(slot + G::kDtr);
    for (int i = 0; i < tn; ++i) {
      const float dl = softplus_sigmoid(xs[i * kCh1 + tid] + bs).x;
      const float p = dl * akt::to_f(us[i * kCh1 + tid]);
      const float dyv = akt::to_f(dys[i * kCh1 + tid]);
      cum += dl;
      const float4* bq = reinterpret_cast<const float4*>(s_bc + i * 2 * kN);
#pragma unroll
      for (int q = 0; q < kN / 4; ++q) {
        const float4 bb = bq[q], cc = bq[kN / 4 + q];
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int n = 4 * q + r;
          const float a = hop::exp2_fast(dl * a2[n]);
          h[n] = fmaf(a, h[n], bv[r] * p);
          P[n] *= a;
          e[n] = fmaf(P[n], dyv * cv[r], e[n]);
        }
      }
    }
  }
  if (active) {
    const size_t o = ((size_t)j * B + b) * kN * Dp + d;
#pragma unroll
    for (int n = 0; n < kN; ++n) {
      seg_h[o + (size_t)n * Dp] = h[n];
      seg_e[o + (size_t)n * Dp] = e[n];
    }
    seg_cum[((size_t)j * B + b) * Dp + d] = cum;
  }
}

// ---- 2. join --------------------------------------------------------------

// seg_h: each segment's local end state in, the state entering it out;
// seg_e: each segment's zero-carry e0 in, the adjoint carry entering it
// (from the later side) out. One thread per (row, state, channel); the
// loads of kJoin segments are issued together, so the serial pass waits
// for memory once per kJoin segments.
constexpr int kJoin = 4;

__global__ void ssm_bwd_join_kernel(const float* __restrict__ A,
                                    float* __restrict__ seg_h,
                                    float* __restrict__ seg_e,
                                    const float* __restrict__ seg_cum, int B,
                                    int Dp, int nseg) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= B * kN * Dp) return;
  const int d = i % Dp, bn = i / Dp, n = bn % kN, b = bn / kN;
  const float a2 = A[d * kN + n] * kLog2e;
  const size_t hstride = (size_t)B * kN * Dp, cstride = (size_t)B * Dp;
  float* hp = seg_h + i;
  float* ep = seg_e + i;
  const float* cp = seg_cum + (size_t)b * Dp + d;
  float hs = 0.f;
  for (int j0 = 0; j0 < nseg; j0 += kJoin) {
    float h0[kJoin], dec[kJoin];
#pragma unroll
    for (int k = 0; k < kJoin; ++k) {
      const bool ok = j0 + k < nseg;
      h0[k] = ok ? hp[(j0 + k) * hstride] : 0.f;
      dec[k] = ok ? cp[(j0 + k) * cstride] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kJoin; ++k) {
      if (j0 + k < nseg) {
        hp[(j0 + k) * hstride] = hs;
        hs = fmaf(hop::exp2_fast(a2 * dec[k]), hs, h0[k]);
      }
    }
  }
  float kc = 0.f;
  for (int j0 = nseg - 1; j0 >= 0; j0 -= kJoin) {
    float e0[kJoin], dec[kJoin];
#pragma unroll
    for (int k = 0; k < kJoin; ++k) {
      const bool ok = j0 - k >= 0;
      e0[k] = ok ? ep[(j0 - k) * hstride] : 0.f;
      dec[k] = ok ? cp[(j0 - k) * cstride] : 0.f;
    }
#pragma unroll
    for (int k = 0; k < kJoin; ++k) {
      if (j0 - k >= 0) {
        ep[(j0 - k) * hstride] = kc;
        kc = fmaf(hop::exp2_fast(a2 * dec[k]), kc, e0[k]);
      }
    }
  }
}

// ---- 3. adjoint -----------------------------------------------------------

// Sums over the 16 lanes that share lane bit 4 of the 16 values v[] of
// every lane: each step keeps half of the live values (by lane bit kMask)
// and adds the partner's copy of them. Lane l ends with the sum of value
// l & 15 in v[0].
template <int kKeep, int kMask>
__device__ __forceinline__ void half_warp_reduce_scatter(float* v, int lane) {
  const bool up = (lane & kMask) != 0;
#pragma unroll
  for (int i = 0; i < kKeep; ++i) {
    const float send = up ? v[i] : v[i + kKeep];
    const float keep = up ? v[i + kKeep] : v[i];
    v[i] = keep + __shfl_xor_sync(0xffffffffu, send, kMask);
  }
  if constexpr (kKeep > 1) half_warp_reduce_scatter<kKeep / 2, kMask / 2>(v, lane);
}

// shared memory of the adjoint block past its ring (fp32 arrays)
struct AdjGeo {
  static constexpr int kBc = 0;                          // [kT][2N]
  static constexpr int kDl = kBc + kT * 2 * kN;          // delta [kT][kCh3]
  static constexpr int kSg = kDl + kT * kCh3;            // sigmoid
  static constexpr int kHist = kSg + kT * kCh3;          // [kT][kH][kW][32 lanes]
  static constexpr int kRed = kHist + kT * kN * kCh3;    // [kT][kW][2N]
  static constexpr int kFloats = kRed + kT * kW * 2 * kN;
};

// Lane l of warp w holds states [kH * (l >> 4), + kH) of channel
// 16 w + (l & 15): two lanes a chain, so a block of kW warps walks 16 kW
// chains with half the serial work a lane.
template <typename T>
__global__ void __launch_bounds__(32 * kW)
ssm_bwd_adjoint_kernel(const T* __restrict__ u, const float* __restrict__ dtr,
                       const T* __restrict__ bc, const T* __restrict__ dy,
                       const float* __restrict__ A, const float* __restrict__ Dskip,
                       const float* __restrict__ bias, const float* __restrict__ ck_h,
                       const float* __restrict__ ck_cum, const float* __restrict__ seg_h,
                       const float* __restrict__ seg_e, T* __restrict__ du,
                       float* __restrict__ ddt, float* __restrict__ dbc_part,
                       float* __restrict__ da_part, float* __restrict__ dd_part,
                       float* __restrict__ db_part, int L, int B, int Dp, int NB,
                       int rev, int seg_len) {
  using G = Slot<T, kCh3, true>;
  using S = AdjGeo;
  extern __shared__ __align__(16) uint8_t smem[];
  float* sf = reinterpret_cast<float*>(smem + 2 * G::kBytes);
  float* s_bc = sf + S::kBc;
  float* s_dl = sf + S::kDl;
  float* s_sg = sf + S::kSg;
  float* hist = sf + S::kHist;
  float* red = sf + S::kRed;
  const uint32_t ring = hop::smem_u32(smem);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int hf = lane >> 4, ch = warp * 16 + (lane & 15), n0 = kH * hf;
  const int j = blockIdx.y, b = blockIdx.z, nblk = gridDim.x;
  const int d0 = blockIdx.x * kCh3, d = d0 + ch;
  const bool active = d < Dp;
  const int dd = active ? d : Dp - 1;

  float a2[kH], hs[kH], g[kH], da[kH];
  {
    const size_t o = (((size_t)j * B + b) * kN + n0) * Dp + dd;
#pragma unroll
    for (int n = 0; n < kH; ++n) {
      a2[n] = A[(size_t)dd * kN + n0 + n] * kLog2e;
      hs[n] = seg_h[o + (size_t)n * Dp];   // state entering the segment
      g[n] = seg_e[o + (size_t)n * Dp];    // adjoint carry from the later side
      da[n] = 0.f;
    }
  }
  const float bs = bias[dd], dsk = Dskip[dd];
  float acc = 0.f;   // lane half 0: sum_t dy u (dD); half 1: sum_t ddt (dbias)
  const int sb = j * seg_len, se = min(L, sb + seg_len);
  const int nsub = (se - sb + kT - 1) / kT, cg0 = sb / kT;
  // sub-chunks in reverse scan order: ring step r holds sub-chunk nsub-1-r
  auto stage_step = [&](int r) {
    const int c = nsub - 1 - r;
    stage<T, kCh3, true>(ring + (r & 1) * G::kBytes, u, dtr, dy, bc, ck_h, ck_cum,
                         cg0 + c, sb + c * kT, min(kT, se - sb - c * kT), L, B,
                         Dp, NB, b, d0, rev);
  };
  stage_step(0);
  for (int r = 0; r < nsub; ++r) {
    const int c = nsub - 1 - r;
    const int s0 = sb + c * kT, tn = min(kT, se - s0);
    hop::cp_async_wait<0>();
    __syncthreads();   // step r landed; step r - 1's slot and arrays are free
    if (r + 1 < nsub) stage_step(r + 1);
    const uint8_t* slot = smem + (r & 1) * G::kBytes;
    const T* us = reinterpret_cast<const T*>(slot + G::kU);
    const T* dys = reinterpret_cast<const T*>(slot + G::kDy);
    const float* xs = reinterpret_cast<const float*>(slot + G::kDtr);
    const float* ck = reinterpret_cast<const float*>(slot + G::kCkp);
    bc_to_f32<T>(slot + G::kBc, s_bc, tn);
    for (int i = hf; i < tn; i += 2) {   // the chain's two lanes split the tokens
      const float2 ss = softplus_sigmoid(xs[i * kCh3 + ch] + bs);
      s_dl[i * kCh3 + ch] = ss.x;
      s_sg[i * kCh3 + ch] = ss.y;
    }
    // this lane's states entering the sub-chunk
    float h[kH];
    {
      const float cum = ck[kN * kCh3 + ch];
#pragma unroll
      for (int n = 0; n < kH; ++n)
        h[n] = fmaf(hop::exp2_fast(a2[n] * cum), hs[n], ck[(n0 + n) * kCh3 + ch]);
    }
    __syncthreads();   // s_bc, s_dl, s_sg
    float* hl = hist + warp * 32 + lane;   // hist[i][n] of this lane: [(i kH + n) kW 32]
    // forward: the state entering each token of the sub-chunk
    for (int i = 0; i < tn; ++i) {
      const float dl = s_dl[i * kCh3 + ch];
      const float p = dl * akt::to_f(us[i * kCh3 + ch]);
      const float4* bq = reinterpret_cast<const float4*>(s_bc + i * 2 * kN + n0);
#pragma unroll
      for (int q = 0; q < kH / 4; ++q) {
        const float4 bb = bq[q];
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          hl[(i * kH + n) * kW * 32] = h[n];
          h[n] = fmaf(hop::exp2_fast(dl * a2[n]), h[n], bv[e] * p);
        }
      }
    }
    // adjoint walk back through the sub-chunk
    for (int i = tn - 1; i >= 0; --i) {
      const float dl = s_dl[i * kCh3 + ch];
      const float uu = akt::to_f(us[i * kCh3 + ch]);
      const float dyv = active ? akt::to_f(dys[i * kCh3 + ch]) : 0.f;
      const float p = dl * uu;
      const float4* bq = reinterpret_cast<const float4*>(s_bc + i * 2 * kN + n0);
      const float4* cq = reinterpret_cast<const float4*>(s_bc + i * 2 * kN + kN + n0);
      float v[2 * kH];   // [dB | dC] of this lane's states, for the channel sums
      float gb = 0.f, gah = 0.f;
#pragma unroll
      for (int q = 0; q < kH / 4; ++q) {
        const float4 bb = bq[q], cc = cq[q];
        const float bv[4] = {bb.x, bb.y, bb.z, bb.w}, cv[4] = {cc.x, cc.y, cc.z, cc.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int n = 4 * q + e;
          const float a = hop::exp2_fast(dl * a2[n]);
          const float ah = a * hl[(i * kH + n) * kW * 32];   // a h_{t-1}
          const float gn = fmaf(dyv, cv[e], g[n]);
          gb = fmaf(gn, bv[e], gb);
          const float t1 = gn * ah;
          da[n] = fmaf(dl, t1, da[n]);
          gah = fmaf(a2[n], t1, gah);
          g[n] = gn * a;
          v[n] = gn * p;
          v[kH + n] = dyv * fmaf(bv[e], p, ah);          // dy h_t
        }
      }
      if (!active) {
#pragma unroll
        for (int n = 0; n < 2 * kH; ++n) v[n] = 0.f;
      }
      // the chain's sums over all N states: its two lanes
      gb += __shfl_xor_sync(0xffffffffu, gb, 16);
      gah += __shfl_xor_sync(0xffffffffu, gah, 16);
      // channel sums over the warp's 16 chains: lane l ends with value l & 15
      half_warp_reduce_scatter<kH, 8>(v, lane);
      {
        const int k = lane & 15;   // 0..kH-1: dB, kH..2kH-1: dC of this half's states
        red[(i * kW + warp) * 2 * kN + (k < kH ? n0 + k : kN + n0 + k - kH)] = v[0];
      }
      if (active) {
        const int tok = rev ? L - 1 - (s0 + i) : s0 + i;
        const size_t o = ((size_t)tok * B + b) * Dp + d;
        if (hf == 0) {
          du[o] = akt::from_f<T>(fmaf(dl, gb, dsk * dyv));
          acc = fmaf(dyv, uu, acc);
        } else {
          const float x = fmaf(uu, gb, kLn2 * gah) * s_sg[i * kCh3 + ch];
          ddt[o] = x;
          acc += x;
        }
      }
    }
    __syncthreads();   // red
    for (int x = tid; x < tn * 2 * kN; x += 32 * kW) {
      const int i = x / (2 * kN), k = x % (2 * kN);
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kW; ++w) sum += red[(i * kW + w) * 2 * kN + k];
      const int tok = rev ? L - 1 - (s0 + i) : s0 + i;
      dbc_part[(((size_t)tok * B + b) * nblk + blockIdx.x) * 2 * kN + k] = sum;
    }
  }
  if (active) {
    const size_t o = ((size_t)j * B + b) * Dp + d;
#pragma unroll
    for (int n = 0; n < kH; ++n) da_part[o * kN + n0 + n] = da[n];
    (hf == 0 ? dd_part : db_part)[o] = acc;
  }
}

size_t replay_smem(int esize) {
  return esize == 2 ? 2 * Slot<__nv_bfloat16, kCh1, false>::kBytes + kT * 2 * kN * 4
                    : 2 * Slot<float, kCh1, false>::kBytes + kT * 2 * kN * 4;
}
size_t adjoint_smem(int esize) {
  return (esize == 2 ? 2 * Slot<__nv_bfloat16, kCh3, true>::kBytes
                     : 2 * Slot<float, kCh3, true>::kBytes) +
         (size_t)AdjGeo::kFloats * 4;
}

template <typename T>
int launch(const void* u, const void* dtr, const void* bc, const void* A,
           const void* Dskip, const void* bias, const void* dy, void* ck_h,
           void* ck_cum, void* seg_h, void* seg_e, void* seg_cum, void* du,
           void* ddt, void* dbc_part, void* da_part, void* dd_part,
           void* db_part, int L, int B, int Dp, int NB, int rev, int seg_len,
           int smem1, int smem3, void* stream) {
  const int es = sizeof(T);
  if (NB < 2 * kN || NB % 8 || Dp % 8 || seg_len <= 0 || seg_len % kT ||
      smem1 != (int)replay_smem(es) || smem3 != (int)adjoint_smem(es))
    return (int)cudaErrorInvalidValue;
  static bool attr = false;
  if (!attr) {
    cudaError_t e = cudaFuncSetAttribute(
        ssm_bwd_replay_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem1);
    if (e == cudaSuccess)
      e = cudaFuncSetAttribute(ssm_bwd_adjoint_kernel<T>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize, smem3);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int nseg = (L + seg_len - 1) / seg_len;
  cudaStream_t s = (cudaStream_t)stream;
  ssm_bwd_replay_kernel<T><<<dim3((Dp + kCh1 - 1) / kCh1, nseg, B), kCh1, smem1, s>>>(
      (const T*)u, (const float*)dtr, (const T*)bc, (const T*)dy,
      (const float*)A, (const float*)bias, (float*)ck_h, (float*)ck_cum,
      (float*)seg_h, (float*)seg_e, (float*)seg_cum, L, B, Dp, NB, rev, seg_len);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int chains = B * kN * Dp;
  ssm_bwd_join_kernel<<<(chains + 255) / 256, 256, 0, s>>>(
      (const float*)A, (float*)seg_h, (float*)seg_e, (const float*)seg_cum, B,
      Dp, nseg);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  ssm_bwd_adjoint_kernel<T><<<dim3((Dp + kCh3 - 1) / kCh3, nseg, B), 32 * kW, smem3, s>>>(
      (const T*)u, (const float*)dtr, (const T*)bc, (const T*)dy,
      (const float*)A, (const float*)Dskip, (const float*)bias,
      (const float*)ck_h, (const float*)ck_cum, (const float*)seg_h,
      (const float*)seg_e, (T*)du, (float*)ddt, (float*)dbc_part,
      (float*)da_part, (float*)dd_part, (float*)db_part, L, B, Dp, NB, rev,
      seg_len);
  return (int)cudaGetLastError();
}

}  // namespace

// Buffers (fp32 unless noted; shapes from ops/selective_scan.py::bwd_plan):
// ck_h (L/kT, B, N, Dp), ck_cum (L/kT, B, Dp); seg_h, seg_e (nseg, B, N,
// Dp), seg_cum (nseg, B, Dp); du (L, B, Dp) in u's dtype, ddt (L, B, Dp);
// dbc_part (L, B, Dp/kCh3, 2N); da_part (nseg, B, Dp, N); dd_part and
// db_part (nseg, B, Dp). smem1 / smem3: the replay's and the adjoint's
// dynamic shared bytes, from the same plan; a plan that disagrees is
// refused.
#define SSM_BWD_ENTRY(NAME, T)                                                 \
  extern "C" int NAME(const void* u, const void* dtr, const void* bc,          \
                      const void* A, const void* Dskip, const void* bias,      \
                      const void* dy, void* ck_h, void* ck_cum, void* seg_h,   \
                      void* seg_e, void* seg_cum, void* du, void* ddt,         \
                      void* dbc_part, void* da_part, void* dd_part,            \
                      void* db_part, int L, int B, int Dp, int NB, int rev,    \
                      int seg_len, int smem1, int smem3, void* stream) {       \
    return launch<T>(u, dtr, bc, A, Dskip, bias, dy, ck_h, ck_cum, seg_h,      \
                     seg_e, seg_cum, du, ddt, dbc_part, da_part, dd_part,      \
                     db_part, L, B, Dp, NB, rev, seg_len, smem1, smem3,        \
                     stream);                                                  \
  }

SSM_BWD_ENTRY(ssm_scan_bwd_bf16, __nv_bfloat16)
SSM_BWD_ENTRY(ssm_scan_bwd_f32, float)

// Tokens per sub-chunk (the checkpoint spacing; seg_len is a multiple of
// it): the plan's BWD_CHUNK.
extern "C" int ssm_scan_bwd_chunk() { return kT; }
