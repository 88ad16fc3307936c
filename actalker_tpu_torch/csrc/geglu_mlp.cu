// K4: GEGLU feed-forward y = (h * gelu_erf(g)) @ W2^T + b2 with
// [h | g] = x @ W1^T + b1; x (M, C) bf16, W1 (2I, C) and W2 (Cout, I) bf16
// in torch Linear layout, b1 / b2 fp32.
//
// Replaces the TPU kernel actalker_tpu/ops/mlp.py `_mlp_kernel` (:47-58,
// launched by `_mlp_pallas` :81). Same numerics: both products accumulate
// in fp32, the gate is computed in fp32 (exact erf GELU), and h is rounded
// to bf16 before the second product, as the TPU kernel casts it to the
// weight dtype (mlp.py:54-57).
//
// What bounds it on the H100: the two products, 2*M*C*2I + 2*M*I*Cout =
// 24*M*C^2 flops (5.6e11 at M = 56*4096, C = 320: 0.57 ms at the bf16
// peak), tensor-core work. The TPU kernel keeps h in VMEM; here the fp32
// accumulator of a (rows x Cout) output tile fits a block's registers only
// at Cout = 320, so h makes one bf16 round trip through device memory
// (M*I*2 bytes each way, ~0.35 ms at C = 320).
//
// Design: one persistent GEMM kernel on wgmma and TMA, launched twice.
// A tile is 128 rows of A against 160 K-major rows of B, one m64n160k16
// wgmma per 64-row half and 16-wide K step:
//   1. [h | g] = x W1^T + b1 with the gate in the epilogue: B is two TMA
//      boxes of 80 rows, rows n0.. of W1's h half and I+n0.. of its g half
//      (two tensor maps, so W1 is not repacked), so each thread holds h and
//      g of the same columns; h * gelu(g) is written once as bf16, 80
//      columns per tile;
//   2. y = h W2^T + b2, 160 output columns per tile.
// At C = 320 a tile's products are only 5 K steps long, and the fp32 gate
// (an exact erf per output) costs about as long again, so the epilogue
// must not stall the tensor cores: the two consumer warpgroups take
// alternate tiles and hand the tensor cores to each other (an mbarrier
// pair), one running its products while the other runs its epilogue.
// One block per SM walks the output tiles, N fastest so concurrent blocks
// share the A rows in L2. Warpgroup 0 is the producer: it gives up
// registers and one thread keeps TMA loads of 128-byte-swizzled 64-wide K
// slices in flight through a 6-stage mbarrier ring, more than one tile
// ahead. Consumers keep one K slice's products in flight while issuing the
// next. Rows past M, columns past N and K past C / I arrive as zeros from
// TMA and are not stored.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kBM = 128;        // rows per tile: two m64 halves
constexpr int kBox = 80;        // B rows per TMA box (two boxes per stage)
constexpr int kBN = 2 * kBox;   // B rows per stage and per wgmma
constexpr int kBK = 64;         // K per stage: one 128-byte swizzled row
constexpr int kStages = 6;
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileA = kBM * kBK * 2;
constexpr int kBoxB = kBox * kBK * 2;

struct Smem {                   // 1024-byte aligned (128-byte swizzle atoms)
  __nv_bfloat16 a[kStages][kBM * kBK];
  __nv_bfloat16 b[kStages][kBN * kBK];
  uint64_t full[kStages], empty[kStages], turn[kConsumers];
};
constexpr int kSmemBytes = sizeof(Smem) + 1024;   // + alignment slack

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// bias, gate and bf16 store of a tile's two 64-row halves: acc[4j + e]
// holds B row 8j + 2 tq + (e & 1) of row `row` (e < 2) or row + 8 (e >= 2)
// of its half. GEGLU: j < 10 are h and j + 10 g of the same output columns
// n0 + 8j + ...
template <bool kGeglu>
__device__ __forceinline__ void epilogue(const float (&acc0)[80],
                                         const float (&acc1)[80], int row,
                                         int n0, int tq,
                                         const float* __restrict__ bias,
                                         __nv_bfloat16* __restrict__ out, int M,
                                         int N) {
  constexpr int kCols = kGeglu ? kBox : kBN;
  constexpr int kG = kBox / 8;   // GEGLU: j + kG holds the gate of column j
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int col = n0 + 8 * j + 2 * tq;   // N is even: col < N => col + 1 < N
    if (col >= N) continue;
    const float2 bh = *reinterpret_cast<const float2*>(bias + col);
    float2 bg = make_float2(0.f, 0.f);
    if (kGeglu) bg = *reinterpret_cast<const float2*>(bias + N + col);
    auto store = [&](const float (&acc)[80], int r, int e) {
      if (r >= M) return;
      float y0 = acc[e] + bh.x, y1 = acc[e + 1] + bh.y;
      if (kGeglu) {
        y0 *= gelu_erf(acc[e + 4 * kG] + bg.x);
        y1 *= gelu_erf(acc[e + 4 * kG + 1] + bg.y);
      }
      *reinterpret_cast<uint32_t*>(out + (size_t)r * N + col) =
          akt::pack_bf16x2(y0, y1);
    };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      store(acc0, row + 8 * half, 4 * j + 2 * half);
      store(acc1, row + 64 + 8 * half, 4 * j + 2 * half);
    }
  }
}

// GEGLU: out (M, N) = (A Wh[n]^T + bias[n]) * gelu(A Wg[n]^T + bias[N+n])
//   (tb0 = Wh, tb1 = Wg); else: out (M, N) = A W[n]^T + bias[n] (tb0 = W).
template <bool kGeglu>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb0,
               const __grid_constant__ CUtensorMap tb1,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int M, int N, int K) {
  constexpr int kTN = kGeglu ? kBox : kBN;   // output columns per tile
  extern __shared__ uint8_t smem_raw[];
  Smem& sm = *reinterpret_cast<Smem*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int ntn = (N + kTN - 1) / kTN;
  const int tiles = (M + kBM - 1) / kBM * ntn;
  const int nk = (K + kBK - 1) / kBK;

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hop::mbar_init(hop::smem_u32(&sm.full[i]), 1);
      hop::mbar_init(hop::smem_u32(&sm.empty[i]), 128);
    }
    for (int w = 0; w < kConsumers; ++w) hop::mbar_init(hop::smem_u32(&sm.turn[w]), 128);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    hop::regs_dealloc<40>();
    if (tid == 0) {
      int it = 0;
      for (int tile = blockIdx.x; tile < tiles; tile += gridDim.x) {
        const int m0 = tile / ntn * kBM, n0 = tile % ntn * kTN;
        for (int kb = 0; kb < nk; ++kb, ++it) {
          const int st = it % kStages;
          hop::mbar_wait(hop::smem_u32(&sm.empty[st]), ((it / kStages) & 1) ^ 1);
          const uint32_t full = hop::smem_u32(&sm.full[st]);
          const uint32_t b = hop::smem_u32(sm.b[st]);
          hop::mbar_expect_tx(full, kTileA + 2 * kBoxB);
          hop::tma_load_3d(hop::smem_u32(sm.a[st]), &ta, full, kb * kBK, m0, 0);
          hop::tma_load_3d(b, &tb0, full, kb * kBK, n0, 0);
          if (kGeglu)
            hop::tma_load_3d(b + kBoxB, &tb1, full, kb * kBK, n0, 0);
          else
            hop::tma_load_3d(b + kBoxB, &tb0, full, kb * kBK, n0 + kBox, 0);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: alternate tiles, 128 rows each ----
    hop::regs_alloc<232>();
    const int wg = tid / 128 - 1, t = tid % 128;
    const int warp = t / 32, lane = t % 32, tq = lane % 4;
    for (int i = wg, m = 0;; i += kConsumers, ++m) {
      const int tile = blockIdx.x + i * gridDim.x;
      if (tile >= tiles) break;
      const int m0 = tile / ntn * kBM, n0 = tile % ntn * kTN;
      // the tensor cores are this warpgroup's once the other one has
      // issued the products of its previous tile
      if (wg == 1) hop::mbar_wait(hop::smem_u32(&sm.turn[1]), m & 1);
      else if (m > 0) hop::mbar_wait(hop::smem_u32(&sm.turn[0]), (m - 1) & 1);
      float acc0[80], acc1[80];
      for (int kb = 0; kb < nk; ++kb) {
        const int it = i * nk + kb, st = it % kStages;
        hop::mbar_wait(hop::smem_u32(&sm.full[st]), (it / kStages) & 1);
        const uint32_t a_addr = hop::smem_u32(sm.a[st]);
        const uint32_t b_addr = hop::smem_u32(sm.b[st]);
        hop::wgmma_fence();
#pragma unroll
        for (int kk = 0; kk < kBK / 16; ++kk) {
          const uint64_t db = hop::desc_sw128(b_addr + kk * 32);
          hop::wgmma_m64n160k16_ss(acc0, hop::desc_sw128(a_addr + kk * 32), db,
                                   kb > 0 || kk > 0);
          hop::wgmma_m64n160k16_ss(acc1, hop::desc_sw128(a_addr + 64 * 128 + kk * 32),
                                   db, kb > 0 || kk > 0);
        }
        hop::wgmma_commit();
        if (kb == nk - 1) hop::mbar_arrive(hop::smem_u32(&sm.turn[1 - wg]));
        // keep this slice's products in flight; release the previous one's
        hop::wgmma_wait<1>();
        if (kb > 0) hop::mbar_arrive(hop::smem_u32(&sm.empty[(it - 1) % kStages]));
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc0);
      hop::fence_regs(acc1);
      hop::mbar_arrive(hop::smem_u32(&sm.empty[(i * nk + nk - 1) % kStages]));

      epilogue<kGeglu>(acc0, acc1, m0 + warp * 16 + lane / 4, n0, tq, bias,
                       out, M, N);
    }
  }
}

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int dev = 0;
    if (cudaGetDevice(&dev) != cudaSuccess ||
        cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev) != cudaSuccess)
      n = 132;
  }
  return n;
}

// out (M, N) from A (M, K) and B (N, K) (GEGLU: b0 the h half, b1 the g half)
template <bool kGeglu>
int launch(const void* a, const void* b0, const void* b1, const void* bias,
           void* out, int M, int N, int K, void* stream) {
  constexpr int kTN = kGeglu ? kBox : kBN;
  CUtensorMap ta, tb0, tb1;
  int err = hop::token_map(&ta, a, 1, M, K, kBM);
  if (!err) err = hop::token_map(&tb0, b0, 1, N, K, kBox);
  if (!err && kGeglu) err = hop::token_map(&tb1, b1, 1, N, K, kBox);
  if (!kGeglu) tb1 = tb0;
  if (err) return err;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tn_kernel<kGeglu>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int tiles = (M + kBM - 1) / kBM * ((N + kTN - 1) / kTN);
  const int grid = tiles < sm_count() ? tiles : sm_count();
  gemm_tn_kernel<kGeglu><<<grid, kThreads, kSmemBytes, (cudaStream_t)stream>>>(
      ta, tb0, tb1, (const float*)bias, (__nv_bfloat16*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// h (M, I) = geglu(x (M, C) @ W1^T + b1), W1 (2I, C)
extern "C" int geglu_in_bf16(const void* x, const void* w1, const void* b1,
                             void* h, int M, int C, int I, void* stream) {
  const __nv_bfloat16* wg = (const __nv_bfloat16*)w1 + (size_t)I * C;
  return launch<true>(x, w1, wg, b1, h, M, I, C, stream);
}

// y (M, Cout) = h (M, I) @ W2^T + b2, W2 (Cout, I)
extern "C" int linear_bias_bf16(const void* h, const void* w2, const void* b2,
                                void* y, int M, int I, int Cout, void* stream) {
  return launch<false>(h, w2, nullptr, b2, y, M, Cout, I, stream);
}
