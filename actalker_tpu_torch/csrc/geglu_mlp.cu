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
// 24*M*C^2 flops, tensor-core work. The TPU kernel keeps h in VMEM; here
// the fp32 accumulator of a (rows x Cout) output tile fits a block's
// registers only at Cout = 320, so h makes one bf16 round trip through
// device memory (M*I*2 bytes each way).
//
// Design: one persistent GEMM engine on wgmma and TMA, launched twice:
//   1. [h | g] = x W1^T + b1 with the gate in the epilogue: B is two TMA
//      boxes of 80 rows, rows n0.. of W1's h half and I+n0.. of its g half
//      (two tensor maps, so W1 is not repacked), so each thread holds h and
//      g of the same columns; h * gelu(g) is written once as bf16, 80
//      columns per tile;
//   2. y = h W2^T + b2, 160 output columns per tile.
// A tile is 128 rows of A against 160 K-major rows of B, one m64n160k16
// wgmma per 64-row half and 16-wide K step. Warpgroup 0 is the producer:
// it gives up registers and one thread keeps TMA loads of 128-byte-swizzled
// 64-wide K slices in flight through an mbarrier ring. Two consumer
// warpgroups take alternate tiles and hand the tensor cores to each other
// (an mbarrier pair), one running its products while the other runs its
// epilogue. Rows past M, columns past N and K past C / I arrive as zeros
// from TMA and are not stored.
//
// What the stage bisect (tools/geglu_bisect.py, the 576 px cell's shapes)
// showed of the first version of this engine (a ring stage held A and B,
// the epilogue stored 4-byte pairs from registers): at C = 320 the GEGLU
// launch's bf16 stores cost 0.65x its mainloop and the erff 0.28x, and
// every level's mainloop ran at ~60% of the bf16 peak: each 128 x 160
// tile re-read its A rows from L2 (71 flops a byte, ~8.3 TB/s of L2
// traffic). Hence the plans (host: ops/mlp.py::plans, one per launch,
// chosen from the shapes):
//   in_resident  GEGLU at C <= 320: a block owns whole 128-row blocks and
//                keeps their A (x) in shared memory across all N tiles,
//                so only B streams (128 flops per L2 byte); A's K boxes
//                are released one by one as the row block's last tile
//                finishes with them, so the next row block's A arrives
//                under that tile's products;
//   in_stream    GEGLU at C > 320 (A does not fit beside the ring): A and
//                B stream per tile, N fastest so concurrent blocks share
//                A rows in L2;
//   out_tma      the output projection when Cout % 8 == 0 (TMA's 16-byte
//                row stride);
//   out_regs     the output projection otherwise (any even Cout).
// Every plan but out_regs stores through shared memory: a consumer writes
// its bf16 tile to its own staging buffer and one thread hands it to TMA
// stores, which drain while the warpgroup goes back to its next tile's
// products; the buffer is reused once those stores have read it.
// What is left at C = 320: the gate's ALU work (~44 instructions an
// output, erff's two branches both evaluated) is about as long as a
// tile's products and is not hidden under the other consumer's (the
// bisect's full - nogate). Wider tiles do not fit: the 160 accumulators
// already hold the consumers near their 232 registers.
#include "common.cuh"
#include "hopper.cuh"

// Compile-time knock-outs for the stage bisect
// (actalker_tpu_torch/tools/geglu_bisect.py), built only by that tool:
// 0 K4 itself, 1 "nogate" (bias and bf16 stores, no erff: h * g), 2
// "mmonly" (the mainloop alone, nothing stored)
#ifndef K4_VARIANT
#define K4_VARIANT 0
#endif

namespace {

constexpr int kBM = 128;        // rows per tile: two m64 halves
constexpr int kBox = 80;        // B rows per TMA box (two boxes per stage)
constexpr int kBN = 2 * kBox;   // B rows per stage and per wgmma
constexpr int kBK = 64;         // K per stage: one 128-byte swizzled row
constexpr int kConsumers = 2;
constexpr int kThreads = 128 * (1 + kConsumers);
constexpr int kTileA = kBM * kBK * 2;
constexpr int kBoxB = kBox * kBK * 2;
constexpr int kResidentK = 320;  // in_resident: A's K kept in shared memory
// a staged output tile is kept as boxes of 40 columns (80-byte rows: a
// warp's 4-byte pairs of 8 rows x 4 columns fall in 32 distinct banks),
// each stored by its own TMA store
constexpr int kSub = 40;

// plans, as the C entries take them (ops/mlp.py::PLANS)
enum Plan { kInResident = 0, kInStream = 1, kOutTma = 2, kOutRegs = 3 };

template <bool kGeglu, bool kResident, bool kTmaStore>
struct Cfg {
  static constexpr int kTN = kGeglu ? kBox : kBN;   // output columns per tile
  // ring stages: as many as fit beside the resident A / the staging tiles
  static constexpr int kStages = kResident ? 5 : kTmaStore ? (kGeglu ? 5 : 4) : 6;
  static constexpr int kABoxes = kResident ? kResidentK / kBK : kStages;
  static constexpr int kStage = kTmaStore ? kBM * kTN : 8;   // staging elements
};

template <class P>
struct Smem {                   // 1024-byte aligned (128-byte swizzle atoms)
  __nv_bfloat16 a[P::kABoxes][kBM * kBK];   // resident K boxes, or one a stage
  __nv_bfloat16 b[P::kStages][kBN * kBK];
  __nv_bfloat16 stage[kConsumers][P::kStage];   // a consumer's output tile
  uint64_t full[P::kStages], empty[P::kStages], turn[kConsumers];
  uint64_t a_full[P::kABoxes], a_empty[P::kABoxes];   // in_resident only
};
template <class P>
constexpr int smem_bytes() { return sizeof(Smem<P>) + 1024; }   // + alignment slack

__device__ __forceinline__ float gelu_erf(float x) {
  return 0.5f * x * (1.f + erff(x * 0.70710678118654752f));
}

// h * gate(g) (GEGLU) or h alone, after the biases
template <bool kGeglu>
__device__ __forceinline__ float2 apply(float h0, float h1, float g0, float g1) {
  if (kGeglu && K4_VARIANT == 1) return make_float2(h0 * g0, h1 * g1);
  if (kGeglu) return make_float2(h0 * gelu_erf(g0), h1 * gelu_erf(g1));
  return make_float2(h0, h1);
}

// bias, gate and bf16 pairs of a tile's two 64-row halves: acc[4j + e]
// holds B row 8j + 2 tq + (e & 1) of row `row` (e < 2) or row + 8 (e >= 2)
// of its half. GEGLU: j < 10 are h and j + 10 g of the same output columns
// n0 + 8j + .... `put(r, c, pair)` takes the packed pair of tile row r and
// tile column c (columns past N carry a zero bias and are never stored).
template <bool kGeglu, class Put>
__device__ __forceinline__ void epilogue(const float (&acc0)[80],
                                         const float (&acc1)[80], int row,
                                         int n0, int tq,
                                         const float* __restrict__ bias, int N,
                                         Put&& put) {
  constexpr int kCols = kGeglu ? kBox : kBN;
  constexpr int kG = kBox / 8;   // GEGLU: j + kG holds the gate of column j
#pragma unroll
  for (int j = 0; j < kCols / 8; ++j) {
    const int c = 8 * j + 2 * tq, col = n0 + c;   // N is even: col < N => col + 1 < N
    float2 bh = make_float2(0.f, 0.f), bg = make_float2(0.f, 0.f);
    if (col < N) {
      bh = *reinterpret_cast<const float2*>(bias + col);
      if (kGeglu) bg = *reinterpret_cast<const float2*>(bias + N + col);
    }
    auto one = [&](const float (&acc)[80], int r, int e) {
      const int eg = kGeglu ? e + 4 * kG : e;   // the gate's register
      const float2 y = apply<kGeglu>(acc[e] + bh.x, acc[e + 1] + bh.y,
                                     acc[eg] + bg.x, acc[eg + 1] + bg.y);
      put(r, c, akt::pack_bf16x2(y.x, y.y));
    };
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      one(acc0, row + 8 * half, 4 * j + 2 * half);
      one(acc1, row + 64 + 8 * half, 4 * j + 2 * half);
    }
  }
}

// GEGLU: out (M, N) = (A Wh[n]^T + bias[n]) * gelu(A Wg[n]^T + bias[N+n])
//   (tb0 = Wh, tb1 = Wg); else: out (M, N) = A W[n]^T + bias[n] (tb0 = W).
// tout: out's store map (kTmaStore).
template <bool kGeglu, bool kResident, bool kTmaStore>
__global__ void __launch_bounds__(kThreads, 1)
gemm_tn_kernel(const __grid_constant__ CUtensorMap ta,
               const __grid_constant__ CUtensorMap tb0,
               const __grid_constant__ CUtensorMap tb1,
               const __grid_constant__ CUtensorMap tout,
               const float* __restrict__ bias, __nv_bfloat16* __restrict__ out,
               int M, int N, int K) {
  using P = Cfg<kGeglu, kResident, kTmaStore>;
  constexpr int kTN = P::kTN, kStages = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  Smem<P>& sm = *reinterpret_cast<Smem<P>*>(
      (reinterpret_cast<uintptr_t>(smem_raw) + 1023) & ~uintptr_t(1023));
  const int tid = threadIdx.x;
  const int ntn = (N + kTN - 1) / kTN, nrb = (M + kBM - 1) / kBM;
  const int nk = (K + kBK - 1) / kBK;
  // the block's i-th tile: in_resident walks its row blocks whole, the
  // other plans stride over all (row block, N tile) pairs, N fastest
  auto locate = [&](int i, int& m0, int& n0) {
    int rb, n;
    if (kResident) {
      rb = blockIdx.x + i / ntn * gridDim.x;
      n = i % ntn;
    } else {
      const int t = blockIdx.x + i * gridDim.x;
      rb = t / ntn;
      n = t % ntn;
    }
    m0 = rb * kBM;
    n0 = n * kTN;
    return rb < nrb;
  };

  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) {
      hop::mbar_init(hop::smem_u32(&sm.full[i]), 1);
      hop::mbar_init(hop::smem_u32(&sm.empty[i]), 128);
    }
    if (kResident)
      for (int i = 0; i < P::kABoxes; ++i) {
        hop::mbar_init(hop::smem_u32(&sm.a_full[i]), 1);
        // every tile of the row block releases each box
        hop::mbar_init(hop::smem_u32(&sm.a_empty[i]), 128 * ntn);
      }
    for (int w = 0; w < kConsumers; ++w) hop::mbar_init(hop::smem_u32(&sm.turn[w]), 128);
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid < 128) {
    // ---- producer warpgroup: one thread issues every TMA load ----
    hop::regs_dealloc<40>();
    if (tid == 0) {
      int it = 0, m0, n0;
      for (int i = 0; locate(i, m0, n0); ++i) {
        for (int kb = 0; kb < nk; ++kb, ++it) {
          if (kResident && i % ntn == 0) {
            // box kb of a new row block, once the last one's tiles are
            // done with it
            const int j = i / ntn;
            const uint32_t af = hop::smem_u32(&sm.a_full[kb]);
            if (j > 0) hop::mbar_wait(hop::smem_u32(&sm.a_empty[kb]), (j - 1) & 1);
            hop::mbar_expect_tx(af, kTileA);
            hop::tma_load_3d(hop::smem_u32(sm.a[kb]), &ta, af, kb * kBK, m0, 0);
          }
          const int st = it % kStages;
          hop::mbar_wait(hop::smem_u32(&sm.empty[st]), ((it / kStages) & 1) ^ 1);
          const uint32_t full = hop::smem_u32(&sm.full[st]);
          const uint32_t b = hop::smem_u32(sm.b[st]);
          hop::mbar_expect_tx(full, (kResident ? 0 : kTileA) + 2 * kBoxB);
          if (!kResident)
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
    int m0, n0;
    for (int i = wg, m = 0; locate(i, m0, n0); i += kConsumers, ++m) {
      // the tensor cores are this warpgroup's once the other one has
      // issued the products of its previous tile
      if (wg == 1) hop::mbar_wait(hop::smem_u32(&sm.turn[1]), m & 1);
      else if (m > 0) hop::mbar_wait(hop::smem_u32(&sm.turn[0]), (m - 1) & 1);
      float acc0[80], acc1[80];
      for (int kb = 0; kb < nk; ++kb) {
        const int it = i * nk + kb, st = it % kStages;
        if (kResident) hop::mbar_wait(hop::smem_u32(&sm.a_full[kb]), (i / ntn) & 1);
        hop::mbar_wait(hop::smem_u32(&sm.full[st]), (it / kStages) & 1);
        const uint32_t a_addr = hop::smem_u32(sm.a[kResident ? kb : st]);
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
        if (kb > 0) {
          hop::mbar_arrive(hop::smem_u32(&sm.empty[(it - 1) % kStages]));
          if (kResident) hop::mbar_arrive(hop::smem_u32(&sm.a_empty[kb - 1]));
        }
      }
      hop::wgmma_wait<0>();
      hop::fence_regs(acc0);
      hop::fence_regs(acc1);
      hop::mbar_arrive(hop::smem_u32(&sm.empty[(i * nk + nk - 1) % kStages]));
      if (kResident) hop::mbar_arrive(hop::smem_u32(&sm.a_empty[nk - 1]));

      if (K4_VARIANT == 2) {
        // the products stay live (a store no input takes), so that ptxas
        // keeps them
        if (__float_as_uint(acc0[0]) == 0x7fbadbadu && __float_as_uint(acc1[0]) == 0x7fbadbadu)
          out[t] = __float2bfloat16(acc0[1] + acc1[1]);
        continue;
      }
      const int row = warp * 16 + lane / 4;   // in the tile
      if (kTmaStore) {
        __nv_bfloat16* stage = sm.stage[wg];
        // the staging tile is free once this warpgroup's last store has
        // read it
        if (t == 0) hop::bulk_wait_read<0>();
        hop::named_sync(1 + wg, 128);
        epilogue<kGeglu>(acc0, acc1, row, n0, tq, bias, N,
                         [&](int r, int c, uint32_t v) {
                           *reinterpret_cast<uint32_t*>(
                               stage + c / kSub * (kBM * kSub) + r * kSub + c % kSub) = v;
                         });
        hop::fence_async_smem();
        hop::named_sync(1 + wg, 128);
        if (t == 0) {
#pragma unroll
          for (int b = 0; b < kTN / kSub; ++b)
            if (n0 + b * kSub < N)
              hop::tma_store_3d(&tout, hop::smem_u32(stage + b * kBM * kSub),
                                n0 + b * kSub, m0, 0);
          hop::bulk_commit();
          // the block does not exit before its last store has run (this
          // wait inside the loop: ptxas spilled the accumulators with it
          // after the loop)
          int m1, n1;
          if (!locate(i + kConsumers, m1, n1)) hop::bulk_wait<0>();
        }
      } else {
        epilogue<kGeglu>(acc0, acc1, row, n0, tq, bias, N,
                         [&](int r, int c, uint32_t v) {
                           if (m0 + r < M && n0 + c < N)
                             *reinterpret_cast<uint32_t*>(out + (size_t)(m0 + r) * N + n0 + c) = v;
                         });
      }
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
template <bool kGeglu, bool kResident, bool kTmaStore>
int launch(const void* a, const void* b0, const void* b1, const void* bias,
           void* out, int M, int N, int K, void* stream) {
  using P = Cfg<kGeglu, kResident, kTmaStore>;
  constexpr int kSmem = smem_bytes<P>();
  static_assert(kSmem <= 232448, "K4: shared memory past the H100's 227 KB");
  if (kResident && K > kResidentK) return (int)cudaErrorInvalidValue;
  CUtensorMap ta, tb0, tb1, tout;
  int err = hop::token_map(&ta, a, 1, M, K, kBM);
  if (!err) err = hop::token_map(&tb0, b0, 1, N, K, kBox);
  if (!err && kGeglu) err = hop::token_map(&tb1, b1, 1, N, K, kBox);
  if (!kGeglu) tb1 = tb0;
  tout = ta;
  if (!err && kTmaStore) {
    // out as (N, M, 1), boxes of kSub columns of the consumer's 128 rows
    if (N % 8) return (int)cudaErrorInvalidValue;
    const unsigned long long dims[3] = {(unsigned long long)N, (unsigned long long)M, 1};
    const unsigned long long strides[2] = {(unsigned long long)N * 2,
                                           (unsigned long long)N * M * 2};
    const unsigned box[3] = {(unsigned)kSub, (unsigned)kBM, 1};
    err = hop::tile_map_3d(&tout, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, out, dims,
                           strides, box);
  }
  if (err) return err;
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gemm_tn_kernel<kGeglu, kResident, kTmaStore>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  const int nrb = (M + kBM - 1) / kBM;
  const int units = kResident ? nrb : nrb * ((N + P::kTN - 1) / P::kTN);
  const int grid = units < sm_count() ? units : sm_count();
  gemm_tn_kernel<kGeglu, kResident, kTmaStore>
      <<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
          ta, tb0, tb1, tout, (const float*)bias, (__nv_bfloat16*)out, M, N, K);
  return (int)cudaGetLastError();
}

}  // namespace

// h (M, I) = geglu(x (M, C) @ W1^T + b1), W1 (2I, C); plan in_resident or
// in_stream
extern "C" int geglu_in_bf16(const void* x, const void* w1, const void* b1,
                             void* h, int M, int C, int I, int plan, void* stream) {
  const __nv_bfloat16* wg = (const __nv_bfloat16*)w1 + (size_t)I * C;
  if (plan == kInResident) return launch<true, true, true>(x, w1, wg, b1, h, M, I, C, stream);
  if (plan == kInStream) return launch<true, false, true>(x, w1, wg, b1, h, M, I, C, stream);
  return (int)cudaErrorInvalidValue;
}

// y (M, Cout) = h (M, I) @ W2^T + b2, W2 (Cout, I); plan out_tma or out_regs
extern "C" int linear_bias_bf16(const void* h, const void* w2, const void* b2,
                                void* y, int M, int I, int Cout, int plan,
                                void* stream) {
  if (plan == kOutTma) return launch<false, false, true>(h, w2, nullptr, b2, y, M, Cout, I, stream);
  if (plan == kOutRegs) return launch<false, false, false>(h, w2, nullptr, b2, y, M, Cout, I, stream);
  return (int)cudaErrorInvalidValue;
}
