// K2: softmax self-attention in token layout, q/k/v/o (B, S, H*64) bf16.
//
// Replaces the TPU kernels actalker_tpu/ops/mha.py `_mha_kernel` (:54-105,
// online softmax over key blocks) and `_mha_kernel_1pass` (:111-141, one
// whole-sequence key block), both launched by `_mha_pallas` (:192, :211).
// Same function: per (batch, head) o = softmax(q k^T * scale) v with the
// softmax in fp32 and P rounded to bf16 before P v; heads are 64-column
// slices of the token rows, so no (B,S,H,D) <-> (B,H,S,D) relayout exists
// anywhere.
//
// What bounds it on the H100: 4 * B * H * S^2 * 64 tensor-core flops (1.2
// TFLOP at (56, 4096, 320, h5), 1.22 ms at the bf16 peak) against
// O(B * S * C) bytes; at a head width of 64 the S^2 exponentials (4.7e9
// there) cost about as much SFU time again, so the softmax of one
// warpgroup has to overlap the products of another.
//
// Design (flash attention on wgmma and TMA): one block of four
// warpgroups per (192-query tile, head, batch). Warpgroup 0 is the
// producer: it gives up registers (setmaxnreg) and one thread keeps TMA
// loads of 128-key K and V tiles (16 KB each, 128-byte swizzled) in
// flight through a 2-stage ring with full / empty mbarriers; Q is loaded
// once. Warpgroups 1-3 own 64 query rows each (three, so that the
// softmax of two overlaps the products of the third): S = Q K^T is a wgmma
// m64n128k16 with both operands in shared memory (K-major, as the token
// rows lie), the fp32 online softmax (exp2, scale * log2 e) runs on the
// accumulator registers, P is packed to bf16 in registers and fed as the
// register A operand of O += P V, where V is read MN-major through the
// descriptor's transpose bit. Keys past S (the last tile at S = 5184)
// arrive as zeros and are masked to -inf; query rows past S are not
// stored; nothing is padded in device memory.
//
// The training forward (`mha_tokens_lse_bf16`) is the same kernel compiled
// with kLse: it also writes each row's log-sum-exp in the base-2 scaled
// domain, lse2 = max + log2(sum), (B, H, S) fp32, from which the backward
// (mha_bwd.cu) recomputes P = exp2(s * scale * log2(e) - lse2).
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 64;           // head dim (one 128-byte row)
constexpr int kConsumers = 3;    // consumer warpgroups, 64 query rows each
constexpr int kBq = 64 * kConsumers;   // query rows per block
constexpr int kBk = 128;         // keys per tile
constexpr int kStages = 2;
constexpr int kThreads = 128 * (1 + kConsumers);   // + the producer
constexpr int kTile = kBk * kD * 2;   // bytes of one 128-row tile

struct Smem {                    // 1024-byte aligned (128-byte swizzle atoms)
  __nv_bfloat16 q[kBq * kD];
  __nv_bfloat16 k[kStages][kBk * kD];
  __nv_bfloat16 v[kStages][kBk * kD];
  uint64_t q_full, k_full[kStages], v_full[kStages], empty[kStages];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;   // + alignment slack

template <bool kLse>
__global__ void __launch_bounds__(kThreads, 1)
mha_fwd_kernel(const __grid_constant__ CUtensorMap tq,
               const __grid_constant__ CUtensorMap tk,
               const __grid_constant__ CUtensorMap tv,
               __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
               int C, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * kBq, h = blockIdx.y, b = blockIdx.z;
  const int nk = (S + kBk - 1) / kBk;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hop::mbar_init(hop::smem_u32(&sm.q_full), 1);
    for (int i = 0; i < kStages; ++i) {
      hop::mbar_init(hop::smem_u32(&sm.k_full[i]), 1);
      hop::mbar_init(hop::smem_u32(&sm.v_full[i]), 1);
      hop::mbar_init(hop::smem_u32(&sm.empty[i]), kConsumers * 128);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    hop::regs_dealloc<24>();
    if (tid == 0) {
      hop::mbar_expect_tx(hop::smem_u32(&sm.q_full), kBq * kD * 2);
      hop::tma_load_3d(hop::smem_u32(sm.q), &tq, hop::smem_u32(&sm.q_full),
                       h * kD, q0, b);
      for (int it = 0; it < nk; ++it) {
        const int st = it % kStages;
        hop::mbar_wait(hop::smem_u32(&sm.empty[st]), ((it / kStages) & 1) ^ 1);
        hop::mbar_expect_tx(hop::smem_u32(&sm.k_full[st]), kTile);
        hop::tma_load_3d(hop::smem_u32(sm.k[st]), &tk,
                         hop::smem_u32(&sm.k_full[st]), h * kD, it * kBk, b);
        hop::mbar_expect_tx(hop::smem_u32(&sm.v_full[st]), kTile);
        hop::tma_load_3d(hop::smem_u32(sm.v[st]), &tv,
                         hop::smem_u32(&sm.v_full[st]), h * kD, it * kBk, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    hop::regs_alloc<160>();
    const int wg = tid / 128 - 1, t = tid % 128;
    const int warp = t / 32, lane = t % 32, tq4 = lane % 4;
    // the rows this thread holds in the accumulator layout
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
    const uint32_t q_addr = hop::smem_u32(sm.q) + wg * 64 * 128;
    if (q0 + wg * 64 >= S) {
      // all 64 rows past S (the last block at small S): no products, but
      // the ring's release count stays whole
      for (int it = 0; it < nk; ++it) {
        hop::mbar_wait(hop::smem_u32(&sm.k_full[it % kStages]), (it / kStages) & 1);
        hop::mbar_arrive(hop::smem_u32(&sm.empty[it % kStages]));
      }
      return;
    }

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f;

    hop::mbar_wait(hop::smem_u32(&sm.q_full), 0);
    for (int it = 0; it < nk; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const uint32_t k_addr = hop::smem_u32(sm.k[st]);
      const uint32_t v_addr = hop::smem_u32(sm.v[st]);

      // S = Q K^T (64 x 128), K-major operands, 4 steps of 16 over d
      float s[64];
      hop::mbar_wait(hop::smem_u32(&sm.k_full[st]), ph);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        hop::wgmma_m64n128k16_ss(s, hop::desc_sw128(q_addr + kk * 32),
                                 hop::desc_sw128(k_addr + kk * 32), kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(s);

      // accumulator layout: s[4j + e] holds key 8j + 2 tq4 + (e & 1) of
      // row r0 (e < 2) or r1 (e >= 2)
      if ((it + 1) * kBk > S) {
#pragma unroll
        for (int j = 0; j < 16; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (it * kBk + 8 * j + 2 * tq4 + (e & 1) >= S) s[4 * j + e] = -INFINITY;
      }
      float mx0 = m0, mx1 = m1;
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        mx0 = fmaxf(mx0, fmaxf(s[4 * j], s[4 * j + 1]));
        mx1 = fmaxf(mx1, fmaxf(s[4 * j + 2], s[4 * j + 3]));
      }
#pragma unroll
      for (int off = 1; off < 4; off <<= 1) {
        mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, off));
        mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, off));
      }
      const float al0 = hop::exp2_fast((m0 - mx0) * scale_log2);
      const float al1 = hop::exp2_fast((m1 - mx1) * scale_log2);
      m0 = mx0;
      m1 = mx1;
      const float mb0 = mx0 * scale_log2, mb1 = mx1 * scale_log2;
      float rs0 = 0.f, rs1 = 0.f;
      uint32_t pa[kBk / 16][4];
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const float p0 = hop::exp2_fast(fmaf(s[4 * j], scale_log2, -mb0));
        const float p1 = hop::exp2_fast(fmaf(s[4 * j + 1], scale_log2, -mb0));
        const float p2 = hop::exp2_fast(fmaf(s[4 * j + 2], scale_log2, -mb1));
        const float p3 = hop::exp2_fast(fmaf(s[4 * j + 3], scale_log2, -mb1));
        rs0 += p0 + p1;
        rs1 += p2 + p3;
        // register A fragment of P V's k step j / 2 (keys 16 (j/2) ...):
        // {row r0, keys 2t..}, {r1, 2t..}, {r0, 2t+8..}, {r1, 2t+8..}
        pa[j / 2][(j % 2) * 2] = akt::pack_bf16x2(p0, p1);
        pa[j / 2][(j % 2) * 2 + 1] = akt::pack_bf16x2(p2, p3);
      }
      l0 = l0 * al0 + rs0;   // per-thread partial row sums, reduced at the end
      l1 = l1 * al1 + rs1;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        acc[4 * j] *= al0;
        acc[4 * j + 1] *= al0;
        acc[4 * j + 2] *= al1;
        acc[4 * j + 3] *= al1;
      }

      // O += P V: V (keys x d) is the MN-major B operand, 8 steps of 16 keys
      hop::mbar_wait(hop::smem_u32(&sm.v_full[st]), ph);
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBk / 16; ++kk)
        hop::wgmma_m64n64k16_rs_mn(acc, pa[kk],
                                   hop::desc_sw128(v_addr + kk * 16 * 128), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::mbar_arrive(hop::smem_u32(&sm.empty[st]));
    }

#pragma unroll
    for (int off = 1; off < 4; off <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, off);
      l1 += __shfl_xor_sync(0xffffffffu, l1, off);
    }
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const size_t base = (size_t)b * S * C + (size_t)h * kD;
    if (kLse && tq4 == 0) {
      float* lr = lse + ((size_t)b * gridDim.y + h) * S;
      if (r0 < S) lr[r0] = m0 * scale_log2 + log2f(l0);
      if (r1 < S) lr[r1] = m1 * scale_log2 + log2f(l1);
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int col = 8 * j + 2 * tq4;
      if (r0 < S)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)r0 * C + col) =
            akt::pack_bf16x2(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
      if (r1 < S)
        *reinterpret_cast<uint32_t*>(o + base + (size_t)r1 * C + col) =
            akt::pack_bf16x2(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
    }
  }
}

template <bool kLse>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           int B, int S, int H, float scale, void* stream) {
  const int C = H * kD;
  CUtensorMap tq, tk, tv;
  int err = hop::token_map(&tq, q, B, S, C, kBq);
  if (!err) err = hop::token_map(&tk, k, B, S, C, kBk);
  if (!err) err = hop::token_map(&tv, v, B, S, C, kBk);
  if (err) return err;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        mha_fwd_kernel<kLse>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((S + kBq - 1) / kBq, H, B);
  mha_fwd_kernel<kLse><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      tq, tk, tv, (__nv_bfloat16*)o, (float*)lse, S, C,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int mha_tokens_bf16(const void* q, const void* k, const void* v,
                               void* o, int B, int S, int H, float scale,
                               void* stream) {
  return launch<false>(q, k, v, o, nullptr, B, S, H, scale, stream);
}

extern "C" int mha_tokens_lse_bf16(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int B,
                                   int S, int H, float scale, void* stream) {
  return launch<true>(q, k, v, o, lse, B, S, H, scale, stream);
}
