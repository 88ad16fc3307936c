// K2 backward: gradients of softmax self-attention in token layout,
// q/k/v/o/dO/dq/dk/dv (B, S, H*64) bf16.
//
// Replaces what the JAX package runs for `mha_tokens`' backward
// (actalker_tpu/ops/mha.py `_mha_bwd` :280-335): the stock Pallas TPU
// flash-attention backward on (B, H, S, D) transposes. Same function, in
// the token layout (a head is a 64-column slice of the token rows):
//   P = softmax(q k^T * scale), D = rowsum(dO o)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q,
// with P and dS rounded to bf16 before their products. P is recomputed
// from the forward's row log-sum-exp (mha.cu, kLse entry, base-2 scaled
// domain), so no S x S matrix is ever stored.
//
// What bounds it on the H100: 7 products of 2 * S^2 * 64 flops per (batch,
// head) (4 in the dK/dV pass, 3 in the dQ pass, which recomputes S and
// dP): tensor-core work, 1.9 TFLOP at (25, 4096, 320, h5), against
// O(B * S * C) bytes.
//
// Design (FlashAttention-2's deterministic two-pass backward on wgmma and
// TMA; no atomics, the same bits every run):
//   1. `row_dot`: D = rowsum(dO o) in fp32, one thread per (token, head);
//   2. `dkdv_kernel`: one block of three warpgroups per (128-key tile,
//      head, batch). The producer warpgroup loads K and V once and keeps a
//      3-stage ring of 64-query Q and dO tiles in flight by TMA (one
//      thread), while one warp stages the tile's log-sum-exp and D rows
//      (+inf and 0 past S, so padded queries contribute nothing). Each
//      consumer warpgroup owns 64 keys: S^T = K Q^T and dP^T = V dO^T are
//      wgmma m64n64k16 products with K-major shared operands; P^T and dS^T
//      are formed on the accumulators and packed to bf16 register A
//      operands of dV += P^T dO and dK += dS^T Q, where dO and Q are read
//      MN-major through the descriptor's transpose bit;
//   3. `dq_kernel`: one block per (128-query tile, head, batch) holds Q and
//      dO, walks a 3-stage ring of 64-key K and V tiles, recomputes S = Q
//      K^T and dP = dO V^T and accumulates dQ += dS K (K read MN-major).
// Rows past S arrive from TMA as zeros; keys past S are masked in the dQ
// pass's last tile and their dK / dV rows are not stored; nothing is
// padded in device memory.
#include "common.cuh"
#include "hopper.cuh"

namespace {

typedef __nv_bfloat16 bf16;

constexpr int kD = 64;           // head dim (one 128-byte row)
constexpr int kBig = 128;        // rows a block owns (64 per consumer)
constexpr int kSmall = 64;       // rows of a streamed tile
constexpr int kStages = 3;
constexpr int kThreads = 384;    // producer + two consumer warpgroups
constexpr int kBigTile = kBig * kD * 2;      // 16 KB
constexpr int kSmallTile = kSmall * kD * 2;  // 8 KB

// D[b, h, s] = sum_d dO[b, s, h*64 + d] * o[b, s, h*64 + d]
__global__ void row_dot(const bf16* __restrict__ o, const bf16* __restrict__ dO,
                        float* __restrict__ Dv, int B, int S, int H) {
  const size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (size_t)B * S * H) return;
  const int h = (int)(i % H);
  const size_t bs = i / H;   // b * S + s
  const bf16* op = o + bs * H * kD + h * kD;
  const bf16* dp = dO + bs * H * kD + h * kD;
  float acc = 0.f;
#pragma unroll
  for (int c = 0; c < kD / 8; ++c) {
    const uint4 a = *reinterpret_cast<const uint4*>(op + c * 8);
    const uint4 b = *reinterpret_cast<const uint4*>(dp + c * 8);
    const bf16* ea = reinterpret_cast<const bf16*>(&a);
    const bf16* eb = reinterpret_cast<const bf16*>(&b);
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += __bfloat162float(ea[j]) * __bfloat162float(eb[j]);
  }
  const size_t b = bs / S, s = bs % S;
  Dv[(b * H + h) * S + s] = acc;
}

// the register A fragments (4 steps of 16 along k) of a 64 x 64 fp32
// accumulator x, rounded to bf16: step kk holds columns 16 kk .. 16 kk + 15
__device__ __forceinline__ void pack_a(uint32_t (&a)[4][4], const float (&x)[32]) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk)
#pragma unroll
    for (int r = 0; r < 4; ++r)
      a[kk][r] = akt::pack_bf16x2(x[8 * kk + 2 * r], x[8 * kk + 2 * r + 1]);
}

// rows [r0, r0 + 16 ...) of a consumer's 64 x 64 accumulator, scaled, to
// token rows < S of g (the accumulator layout: acc[4j + e] is column
// 8j + 2 tq + (e & 1) of row r0 (e < 2) or r0 + 8)
__device__ __forceinline__ void store_rows(bf16* g, const float (&acc)[32],
                                           float scale, int r0, int tq, int S,
                                           int C) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const int col = 8 * j + 2 * tq;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(g + (size_t)r0 * C + col) =
          akt::pack_bf16x2(acc[4 * j] * scale, acc[4 * j + 1] * scale);
    if (r0 + 8 < S)
      *reinterpret_cast<uint32_t*>(g + (size_t)(r0 + 8) * C + col) =
          akt::pack_bf16x2(acc[4 * j + 2] * scale, acc[4 * j + 3] * scale);
  }
}

struct SmemKV {                  // 1024-byte aligned
  bf16 k[kBig * kD], v[kBig * kD];
  bf16 q[kStages][kSmall * kD], dO[kStages][kSmall * kD];
  float lse[kStages][kSmall], dd[kStages][kSmall];
  uint64_t kv_full, full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(kThreads, 1)
dkdv_kernel(const __grid_constant__ CUtensorMap tq,
            const __grid_constant__ CUtensorMap tk,
            const __grid_constant__ CUtensorMap tv,
            const __grid_constant__ CUtensorMap tdo,
            const float* __restrict__ lse, const float* __restrict__ Dv,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int C,
            float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  SmemKV& sm = *reinterpret_cast<SmemKV*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int k0 = blockIdx.x * kBig, h = blockIdx.y, b = blockIdx.z;
  const int nq = (S + kSmall - 1) / kSmall;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hop::mbar_init(hop::smem_u32(&sm.kv_full), 1);
    for (int i = 0; i < kStages; ++i) {
      hop::mbar_init(hop::smem_u32(&sm.full[i]), 1 + 32);   // TMA + lse warp
      hop::mbar_init(hop::smem_u32(&sm.empty[i]), 2 * 128);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup ----
    hop::regs_dealloc<40>();
    if (tid == 0) {
      hop::mbar_expect_tx(hop::smem_u32(&sm.kv_full), 2 * kBigTile);
      hop::tma_load_3d(hop::smem_u32(sm.k), &tk, hop::smem_u32(&sm.kv_full),
                       h * kD, k0, b);
      hop::tma_load_3d(hop::smem_u32(sm.v), &tv, hop::smem_u32(&sm.kv_full),
                       h * kD, k0, b);
      for (int it = 0; it < nq; ++it) {
        const int st = it % kStages;
        hop::mbar_wait(hop::smem_u32(&sm.empty[st]), ((it / kStages) & 1) ^ 1);
        const uint32_t bar = hop::smem_u32(&sm.full[st]);
        hop::mbar_expect_tx(bar, 2 * kSmallTile);
        hop::tma_load_3d(hop::smem_u32(sm.q[st]), &tq, bar, h * kD, it * kSmall, b);
        hop::tma_load_3d(hop::smem_u32(sm.dO[st]), &tdo, bar, h * kD, it * kSmall, b);
      }
    } else if (tid >= 32 && tid < 64) {
      // the query tile's lse and D rows: +inf and 0 past S (P = dS = 0)
      const int lane = tid - 32;
      const size_t bh = (size_t)b * gridDim.y + h;
      const float* lr = lse + bh * S;
      const float* dr = Dv + bh * S;
      for (int it = 0; it < nq; ++it) {
        const int st = it % kStages;
        hop::mbar_wait(hop::smem_u32(&sm.empty[st]), ((it / kStages) & 1) ^ 1);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int i = lane + 32 * half, r = it * kSmall + i;
          sm.lse[st][i] = r < S ? lr[r] : INFINITY;
          sm.dd[st][i] = r < S ? dr[r] : 0.f;
        }
        hop::mbar_arrive(hop::smem_u32(&sm.full[st]));
      }
    }
  } else {
    // ---- consumer warpgroups: 64 keys each ----
    hop::regs_alloc<232>();
    const int wg = tid / 128 - 1, t = tid % 128;
    const int warp = t / 32, lane = t % 32, tq4 = lane % 4;
    const uint32_t k_addr = hop::smem_u32(sm.k) + wg * 64 * 128;
    const uint32_t v_addr = hop::smem_u32(sm.v) + wg * 64 * 128;

    float acc_k[32], acc_v[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc_k[i] = acc_v[i] = 0.f;

    hop::mbar_wait(hop::smem_u32(&sm.kv_full), 0);
    for (int it = 0; it < nq; ++it) {
      const int st = it % kStages;
      hop::mbar_wait(hop::smem_u32(&sm.full[st]), (it / kStages) & 1);
      const uint32_t q_addr = hop::smem_u32(sm.q[st]);
      const uint32_t do_addr = hop::smem_u32(sm.dO[st]);

      // S^T = K Q^T and dP^T = V dO^T (64 keys x 64 queries each)
      float p[32], dp[32];
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        hop::wgmma_m64n64k16_ss(p, hop::desc_sw128(k_addr + kk * 32),
                                hop::desc_sw128(q_addr + kk * 32), kk > 0);
      hop::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        hop::wgmma_m64n64k16_ss(dp, hop::desc_sw128(v_addr + kk * 32),
                                hop::desc_sw128(do_addr + kk * 32), kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      hop::fence_regs(p);

      // P^T = exp2(S^T * scale_log2 - lse2[query]); column 8j + 2 tq4 + (e & 1)
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 l2 = *reinterpret_cast<const float2*>(&sm.lse[st][8 * j + 2 * tq4]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          p[4 * j + e] = hop::exp2_fast(fmaf(p[4 * j + e], scale_log2, (e & 1) ? -l2.y : -l2.x));
      }

      // dV += P^T dO (dO read MN-major: queries x d)
      uint32_t pa[4][4];
      pack_a(pa, p);
      hop::fence_regs(acc_v);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSmall / 16; ++kk)
        hop::wgmma_m64n64k16_rs_mn(acc_v, pa[kk],
                                   hop::desc_sw128(do_addr + kk * 16 * 128), 1);
      hop::wgmma_commit();

      // dS^T = P^T (dP^T - D[query]), then dK += dS^T Q (Q read MN-major)
      hop::wgmma_wait<1>();
      hop::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const float2 d2 = *reinterpret_cast<const float2*>(&sm.dd[st][8 * j + 2 * tq4]);
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - ((e & 1) ? d2.y : d2.x));
      }
      uint32_t da[4][4];
      pack_a(da, dp);
      hop::fence_regs(acc_k);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSmall / 16; ++kk)
        hop::wgmma_m64n64k16_rs_mn(acc_k, da[kk],
                                   hop::desc_sw128(q_addr + kk * 16 * 128), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc_v);
      hop::fence_regs(acc_k);
      hop::mbar_arrive(hop::smem_u32(&sm.empty[st]));
    }

    const size_t base = (size_t)b * S * C + (size_t)h * kD;
    const int r0 = k0 + wg * 64 + warp * 16 + lane / 4;
    store_rows(dk + base, acc_k, scale, r0, tq4, S, C);
    store_rows(dv + base, acc_v, 1.f, r0, tq4, S, C);
  }
}

struct SmemQ {                   // 1024-byte aligned
  bf16 q[kBig * kD], dO[kBig * kD];
  bf16 k[kStages][kSmall * kD], v[kStages][kSmall * kD];
  uint64_t qd_full, k_full[kStages], v_full[kStages], empty[kStages];
};

__global__ void __launch_bounds__(kThreads, 1)
dq_kernel(const __grid_constant__ CUtensorMap tq,
          const __grid_constant__ CUtensorMap tk,
          const __grid_constant__ CUtensorMap tv,
          const __grid_constant__ CUtensorMap tdo,
          const float* __restrict__ lse, const float* __restrict__ Dv,
          bf16* __restrict__ dq, int S, int C, float scale, float scale_log2) {
  extern __shared__ uint8_t smem_raw[];
  SmemQ& sm = *reinterpret_cast<SmemQ*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int q0 = blockIdx.x * kBig, h = blockIdx.y, b = blockIdx.z;
  const int nk = (S + kSmall - 1) / kSmall;
  const int tid = threadIdx.x;

  if (tid == 0) {
    hop::mbar_init(hop::smem_u32(&sm.qd_full), 1);
    for (int i = 0; i < kStages; ++i) {
      hop::mbar_init(hop::smem_u32(&sm.k_full[i]), 1);
      hop::mbar_init(hop::smem_u32(&sm.v_full[i]), 1);
      hop::mbar_init(hop::smem_u32(&sm.empty[i]), 2 * 128);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    hop::regs_dealloc<40>();
    if (tid == 0) {
      const uint32_t bar = hop::smem_u32(&sm.qd_full);
      hop::mbar_expect_tx(bar, 2 * kBigTile);
      hop::tma_load_3d(hop::smem_u32(sm.q), &tq, bar, h * kD, q0, b);
      hop::tma_load_3d(hop::smem_u32(sm.dO), &tdo, bar, h * kD, q0, b);
      for (int it = 0; it < nk; ++it) {
        const int st = it % kStages;
        hop::mbar_wait(hop::smem_u32(&sm.empty[st]), ((it / kStages) & 1) ^ 1);
        hop::mbar_expect_tx(hop::smem_u32(&sm.k_full[st]), kSmallTile);
        hop::tma_load_3d(hop::smem_u32(sm.k[st]), &tk,
                         hop::smem_u32(&sm.k_full[st]), h * kD, it * kSmall, b);
        hop::mbar_expect_tx(hop::smem_u32(&sm.v_full[st]), kSmallTile);
        hop::tma_load_3d(hop::smem_u32(sm.v[st]), &tv,
                         hop::smem_u32(&sm.v_full[st]), h * kD, it * kSmall, b);
      }
    }
  } else {
    // ---- consumer warpgroups: 64 queries each ----
    hop::regs_alloc<232>();
    const int wg = tid / 128 - 1, t = tid % 128;
    const int warp = t / 32, lane = t % 32, tq4 = lane % 4;
    const uint32_t q_addr = hop::smem_u32(sm.q) + wg * 64 * 128;
    const uint32_t do_addr = hop::smem_u32(sm.dO) + wg * 64 * 128;
    const int r0 = q0 + wg * 64 + warp * 16 + lane / 4, r1 = r0 + 8;
    const size_t bh = (size_t)b * gridDim.y + h;
    // +inf / 0 past S: P = dS = 0 on padded query rows
    const float l0 = r0 < S ? lse[bh * S + r0] : INFINITY;
    const float l1 = r1 < S ? lse[bh * S + r1] : INFINITY;
    const float d0 = r0 < S ? Dv[bh * S + r0] : 0.f;
    const float d1 = r1 < S ? Dv[bh * S + r1] : 0.f;

    float acc[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) acc[i] = 0.f;

    hop::mbar_wait(hop::smem_u32(&sm.qd_full), 0);
    for (int it = 0; it < nk; ++it) {
      const int st = it % kStages;
      const uint32_t ph = (it / kStages) & 1;
      const uint32_t k_addr = hop::smem_u32(sm.k[st]);
      const uint32_t v_addr = hop::smem_u32(sm.v[st]);

      // S = Q K^T and dP = dO V^T (64 queries x 64 keys each)
      float p[32], dp[32];
      hop::mbar_wait(hop::smem_u32(&sm.k_full[st]), ph);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        hop::wgmma_m64n64k16_ss(p, hop::desc_sw128(q_addr + kk * 32),
                                hop::desc_sw128(k_addr + kk * 32), kk > 0);
      hop::wgmma_commit();
      hop::mbar_wait(hop::smem_u32(&sm.v_full[st]), ph);
#pragma unroll
      for (int kk = 0; kk < kD / 16; ++kk)
        hop::wgmma_m64n64k16_ss(dp, hop::desc_sw128(do_addr + kk * 32),
                                hop::desc_sw128(v_addr + kk * 32), kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<1>();
      hop::fence_regs(p);

      // P = exp2(S * scale_log2 - lse2[row]); keys past S masked to 0
      const bool edge = (it + 1) * kSmall > S;
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float pe = hop::exp2_fast(fmaf(p[4 * j + e], scale_log2, e < 2 ? -l0 : -l1));
          p[4 * j + e] =
              edge && it * kSmall + 8 * j + 2 * tq4 + (e & 1) >= S ? 0.f : pe;
        }
      hop::wgmma_wait<0>();
      hop::fence_regs(dp);
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          dp[4 * j + e] = p[4 * j + e] * (dp[4 * j + e] - (e < 2 ? d0 : d1));

      // dQ += dS K (K read MN-major: keys x d)
      uint32_t da[4][4];
      pack_a(da, dp);
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kSmall / 16; ++kk)
        hop::wgmma_m64n64k16_rs_mn(acc, da[kk],
                                   hop::desc_sw128(k_addr + kk * 16 * 128), 1);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      hop::mbar_arrive(hop::smem_u32(&sm.empty[st]));
    }

    store_rows(dq + (size_t)b * S * C + (size_t)h * kD, acc, scale, r0, tq4, S, C);
  }
}

template <typename Kernel>
int allow_smem(Kernel* kernel, int bytes, bool& done) {
  if (done) return 0;
  const cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  done = e == cudaSuccess;
  return (int)e;
}

}  // namespace

// Dv: (B, H, S) fp32 scratch for rowsum(dO o). lse: the forward's (B, H, S).
extern "C" int mha_bwd_bf16(const void* q, const void* k, const void* v,
                            const void* o, const void* dO, const void* lse,
                            void* Dv, void* dq, void* dk, void* dv, int B,
                            int S, int H, float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const int C = H * kD;
  const float sl2 = scale * 1.4426950408889634f;
  // maps: the block's own 128-row tiles and the streamed 64-row tiles
  CUtensorMap q_big, do_big, k_big, v_big, q_small, do_small, k_small, v_small;
  int err = 0;
  const void* src[4] = {q, dO, k, v};
  CUtensorMap* big[4] = {&q_big, &do_big, &k_big, &v_big};
  CUtensorMap* small[4] = {&q_small, &do_small, &k_small, &v_small};
  for (int i = 0; i < 4 && !err; ++i) {
    err = hop::token_map(big[i], src[i], B, S, C, kBig);
    if (!err) err = hop::token_map(small[i], src[i], B, S, C, kSmall);
  }
  if (err) return err;
  static bool kv_attr = false, q_attr = false;
  const int kv_smem = sizeof(SmemKV) + 1024, q_smem = sizeof(SmemQ) + 1024;
  if ((err = allow_smem(dkdv_kernel, kv_smem, kv_attr))) return err;
  if ((err = allow_smem(dq_kernel, q_smem, q_attr))) return err;

  const size_t rows = (size_t)B * S * H;
  row_dot<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      (const bf16*)o, (const bf16*)dO, (float*)Dv, B, S, H);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kBig - 1) / kBig, H, B);
  dkdv_kernel<<<grid, kThreads, kv_smem, s>>>(
      q_small, k_big, v_big, do_small, (const float*)lse, (const float*)Dv,
      (bf16*)dk, (bf16*)dv, S, C, scale, sl2);
  e = cudaGetLastError();
  if (e != cudaSuccess) return (int)e;
  dq_kernel<<<grid, kThreads, q_smem, s>>>(
      q_big, k_small, v_small, do_big, (const float*)lse, (const float*)Dv,
      (bf16*)dq, S, C, scale, sl2);
  return (int)cudaGetLastError();
}
