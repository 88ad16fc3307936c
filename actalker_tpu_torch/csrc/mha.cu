// K2: softmax self-attention in token layout, q/k/v/o (B, S, H*64) bf16.
//
// Replaces the TPU kernels actalker_tpu/ops/mha.py `_mha_kernel` (:54-105,
// online softmax over key blocks) and `_mha_kernel_1pass` (:111-141, one
// whole-sequence key block), both launched by `_mha_pallas` (:192, :211).
// Same function: per (batch, head) o = softmax(q k^T * scale) v with the
// softmax in fp32; heads are column slices of the token rows, so no
// (B,S,H,D) <-> (B,H,S,D) relayout exists anywhere.
//
// What bounds it on the H100: 4 * B * H * S^2 * 64 flops (1.2 TFLOP at
// (56, 4096, 320, h5)) against O(B * S * C) bytes, i.e. tensor-core work.
// Design (flash attention, first version): one block of 4 warps per
// (64-query tile, head, batch); each warp owns 16 query rows and keeps its
// Q fragments, the fp32 output accumulator and the running row max / sum in
// registers. Key/value tiles of 64 tokens are staged in shared memory (V
// transposed, so both products read 32-bit fragment pairs), QK^T and PV run
// on mma.sync m16n8k16 bf16 -> fp32, and the probabilities are re-packed
// from the score accumulators straight into PV's A fragments. The ragged
// key and query edge (S = 5184 at 576 px) is masked in the kernel; nothing
// is padded. wgmma / TMA pipelining is later work.
//
// The training forward (`mha_tokens_lse_bf16`) is the same kernel compiled
// with kLse: it also writes each row's log-sum-exp in the base-2 scaled
// domain, lse2 = max + log2(sum), (B, H, S) fp32, from which the backward
// (mha_bwd.cu) recomputes P = exp2(s * scale * log2(e) - lse2). The
// inference entry `mha_tokens_bf16` is unchanged.
#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kBq = 64;       // query rows per block (16 per warp)
constexpr int kBk = 64;       // keys per tile
constexpr int kPad = 72;      // shared row stride in bf16 (conflict-free frags)
constexpr int kThreads = 128;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// 64 rows x 64 bf16 of token rows [r0, r0+64) (zero past S) into s[64][kPad]
__device__ __forceinline__ void load_tile(__nv_bfloat16* s,
                                          const __nv_bfloat16* g, int r0,
                                          int S, int C, int tid) {
#pragma unroll
  for (int i = 0; i < (kBk * kD / 8) / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / 8, c = idx % 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * C + c * 8);
    *reinterpret_cast<uint4*>(s + r * kPad + c * 8) = v;
  }
}

template <bool kLse>
__global__ void __launch_bounds__(kThreads)
mha_fwd_kernel(const __nv_bfloat16* __restrict__ q,
               const __nv_bfloat16* __restrict__ k,
               const __nv_bfloat16* __restrict__ v,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
               int C, float scale_log2) {
  __shared__ __align__(16) __nv_bfloat16 Qs[kBq * kPad];
  __shared__ __align__(16) __nv_bfloat16 Ks[kBk * kPad];
  __shared__ __align__(16) __nv_bfloat16 Vt[kD * kPad];   // [d][key]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int q0 = blockIdx.x * kBq, h = blockIdx.y, b = blockIdx.z;
  const size_t base = (size_t)b * S * C + (size_t)h * kD;

  load_tile(Qs, q + base, q0, S, C, tid);
  __syncthreads();
  uint32_t qa[4][4];
  const int qr = warp * 16 + gr;
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    qa[kk][0] = ld32(&Qs[qr * kPad + kk * 16 + 2 * tq]);
    qa[kk][1] = ld32(&Qs[(qr + 8) * kPad + kk * 16 + 2 * tq]);
    qa[kk][2] = ld32(&Qs[qr * kPad + kk * 16 + 2 * tq + 8]);
    qa[kk][3] = ld32(&Qs[(qr + 8) * kPad + kk * 16 + 2 * tq + 8]);
  }

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;
  float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

  for (int k0 = 0; k0 < S; k0 += kBk) {
    __syncthreads();   // previous tile consumed
    load_tile(Ks, k + base, k0, S, C, tid);
#pragma unroll
    for (int i = 0; i < (kBk * kD / 8) / kThreads; ++i) {
      const int idx = tid + i * kThreads;
      const int r = idx / 8, c = idx % 8;
      uint4 raw = make_uint4(0, 0, 0, 0);
      if (k0 + r < S)
        raw = *reinterpret_cast<const uint4*>(v + base + (size_t)(k0 + r) * C + c * 8);
      const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
      for (int j = 0; j < 8; ++j) Vt[(c * 8 + j) * kPad + r] = e[j];
    }
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = s[nt][1] = s[nt][2] = s[nt][3] = 0.f;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const __nv_bfloat16* kr = &Ks[(nt * 8 + gr) * kPad + kk * 16 + 2 * tq];
        akt::mma_bf16_16816(s[nt], qa[kk], ld32(kr), ld32(kr + 8));
      }
    }
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tq + (e & 1);
        s[nt][e] = key < S ? s[nt][e] * scale_log2 : -INFINITY;
      }
      mx0 = fmaxf(mx0, fmaxf(s[nt][0], s[nt][1]));
      mx1 = fmaxf(mx1, fmaxf(s[nt][2], s[nt][3]));
    }
#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    m0 = mn0;
    m1 = mn1;
    float rs0 = 0.f, rs1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      s[nt][0] = exp2f(s[nt][0] - mn0);
      s[nt][1] = exp2f(s[nt][1] - mn0);
      s[nt][2] = exp2f(s[nt][2] - mn1);
      s[nt][3] = exp2f(s[nt][3] - mn1);
      rs0 += s[nt][0] + s[nt][1];
      rs1 += s[nt][2] + s[nt][3];
      acc[nt][0] *= al0;
      acc[nt][1] *= al0;
      acc[nt][2] *= al1;
      acc[nt][3] *= al1;
    }
    l0 = l0 * al0 + rs0;   // per-thread partial row sums, reduced at the end
    l1 = l1 * al1 + rs1;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[4];
      pa[0] = akt::pack_bf16x2(s[2 * kk][0], s[2 * kk][1]);
      pa[1] = akt::pack_bf16x2(s[2 * kk][2], s[2 * kk][3]);
      pa[2] = akt::pack_bf16x2(s[2 * kk + 1][0], s[2 * kk + 1][1]);
      pa[3] = akt::pack_bf16x2(s[2 * kk + 1][2], s[2 * kk + 1][3]);
#pragma unroll
      for (int nt = 0; nt < 8; ++nt) {
        const __nv_bfloat16* vr = &Vt[(nt * 8 + gr) * kPad + kk * 16 + 2 * tq];
        akt::mma_bf16_16816(acc[nt], pa, ld32(vr), ld32(vr + 8));
      }
    }
  }

#pragma unroll
  for (int off = 1; off < 4; off <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, off);
    l1 += __shfl_xor_sync(0xffffffffu, l1, off);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  if (kLse && tq == 0) {
    float* lr = lse + ((size_t)b * gridDim.y + h) * S;
    if (r0 < S) lr[r0] = m0 + log2f(l0);
    if (r1 < S) lr[r1] = m1 + log2f(l1);
  }
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r0 * C + col) =
          akt::pack_bf16x2(acc[nt][0] * inv0, acc[nt][1] * inv0);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(o + base + (size_t)r1 * C + col) =
          akt::pack_bf16x2(acc[nt][2] * inv1, acc[nt][3] * inv1);
  }
}

}  // namespace

extern "C" int mha_tokens_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, float scale,
                               void* stream) {
  dim3 grid((S + kBq - 1) / kBq, H, B);
  mha_fwd_kernel<false><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, nullptr, S, H * kD,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

extern "C" int mha_tokens_lse_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int H, float scale, void* stream) {
  dim3 grid((S + kBq - 1) / kBq, H, B);
  mha_fwd_kernel<true><<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, (float*)lse, S, H * kD,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
