// K8: y = conv3x3(silu(x * a + b)) + cb, NHWC, stride 1, SAME padding;
// x (N, H, W, C) bf16, (a, b) the per-(N, C) fp32 GroupNorm affine (from
// K7-GN's statistics), the weights re-laid out as Wt (Co, 9 * C) bf16 with
// k = (ky * 3 + kx) * C + c, cb fp32 (Co,), y (N, H, W, Co) bf16.
//
// Replaces the TPU kernel actalker_tpu/ops/resconv.py `_gnconv_kernel`
// (:43-87, launched by `_gnconv_pallas` :96). Same numerics: the affine and
// SiLU (y / (1 + exp(-y))) in fp32, the activation rounded to bf16 before
// the product, fp32 accumulation, the bias added in fp32, one rounding of
// the output. The zero padding is applied to the ACTIVATED tensor: a tap
// that falls outside the image contributes 0, not silu(b).
//
// What bounds it on the H100: tensor-core operations, 2 * N*H*W * 9*C * Co
// (4.2e11 at (56, 64, 64, 320 -> 320), 0.43 ms at 989 TFLOP/s). The TPU
// kernel activates each input element once into a VMEM im2col scratch; the
// first port here re-gathered and re-activated every element 9 * Co / 64
// times. Design: an implicit GEMM (M = N*H*W output pixels, N = Co,
// K = 9 * C) whose A operand is never gathered from device memory.
//   * A block owns kBM = 128 consecutive output pixels p = m0 .. m0 + 127
//     (2 rows of a 64-wide image, 8 rows of a 16-wide one, two whole 8 x 8
//     images, part of a 512-wide row) and a Co tile of BN in {64, 128,
//     160} columns. It walks C in chunks of 64 channels.
//   * For each chunk one producer thread brings the raw halo by TMA, in
//     boxes of kBox pixels x 64 channels of x seen as (N*H*W, C) (rows
//     outside [0, N*H*W) and channels past C arrive as zeros); pixel
//     p + dy * W + dx sits at slot (p - m0) + dx + 1 + (dy + 1) * S, with
//     S = W when W <= kBox (the three row windows overlap: one contiguous
//     run of 2W + kBM + 2 pixels) and S = kBox otherwise (three disjoint
//     windows, a box each). The producer warpgroups then apply the affine
//     and SiLU once per slot, in place. A slot's image is computed once per
//     block into a table, so no division runs per chunk or tap.
//   * Two consumer warpgroups (64 pixels each) run the nine taps as nine
//     GEMM steps of K = 64 on register-A wgmma: each lane loads its pixel's
//     row of the shifted window with ldmatrix from its own slot address, or
//     from a 16-byte zero row when the tap leaves the image (rows of
//     another image or past the edge of a row in the halo are never read):
//     that is the zero padding of the activated tensor, per output pixel.
//     The halo rows are 128-byte swizzled (TMA's pattern), so eight
//     consecutive slots' ldmatrix rows hit distinct banks.
//   * The weight tile of each (chunk, tap) is brought by TMA (128-byte
//     swizzle, K-major) into an mbarrier ring; the same producer thread
//     issues the loads, polling the ring between its activation passes.
//   * Three halo buffers rotate: while the consumers multiply chunk c, the
//     producers activate chunk c + 1 with chunk c + 2's boxes in flight.
//     Channels past C (C % 64 != 0) stay zero, so the weights of the next
//     tap that the 64-wide tile reads there multiply zeros.
//
// Stage knock-outs (template parameter V), the port of the TPU bisect tool
// tools/micro_resconv_bisect.py (`kernel` :30-65, launched at :79), each
// with its own C entry; kFull is K8:
//   kNoShift  only the dx = 0 taps are read (the others are the zero row),
//   kNoAffine SiLU of x without the GroupNorm affine (a, b not read),
//   kNoSilu   the affine without SiLU,
//   kMmOnly   the halo is written as zeros and no input is read (y = cb).
#include "common.cuh"
#include "hopper.cuh"

namespace {

enum Variant { kFull, kNoShift, kNoAffine, kNoSilu, kMmOnly };

constexpr int kBM = 128;            // output pixels per block
constexpr int kKC = 64;             // channels per chunk: one 128-byte row
constexpr int kBox = 136;           // halo pixels per TMA box (>= kBM + 2)
constexpr int kRowBytes = kKC * 2;

// The block: two producer warpgroups (the activation, which bounds a block
// more than its products do) then two consumer warpgroups, 512 threads.
// ptxas gives each thread the launch bound's share of the SM's 65,536
// registers (128); the producers hand theirs to the consumers (fp32
// accumulators), within the block's pool, or setmaxnreg.inc waits forever.
constexpr int kProducers = 256;
constexpr int kThreads = kProducers + 256;
constexpr int kProducerRegs = 80;
constexpr int kConsumerRegs = (128 * kThreads - kProducerRegs * kProducers) / 256;

// halo pixels a buffer holds: the slots, in whole boxes
__host__ __device__ constexpr int halo_rows(int S) {
  return (2 * S + kBM + 2 + kBox - 1) / kBox * kBox;
}

// dynamic shared memory of one block: the weight ring, three halo buffers
// (1024-byte aligned: kBox rows are 17 swizzle atoms), the zero row, the
// bias, the slot table and the barriers, plus 1024 bytes of alignment slack
__host__ __device__ constexpr int smem_bytes(int bn, int S, int stages) {
  return 1024 + stages * bn * kRowBytes + 3 * halo_rows(S) * kRowBytes + 16 +
         4 * bn + 4 * halo_rows(S) + 8 * (2 * stages + 9);
}

// y / (1 + exp(-y)) in fp32: exp as 2^x and the reciprocal on the SFU,
// flushing denormals (exp(-y) below 2^-126 adds nothing to 1). (The same
// on the FMA pipes alone, a polynomial 2^x and Newton steps, measured
// slower: the producers are bound by instruction issue, not by the SFU.)
__device__ __forceinline__ float silu(float y) {
  float r;
  asm("rcp.approx.ftz.f32 %0, %1;\n"
      : "=f"(r)
      : "f"(1.f + hop::exp2_fast(-1.4426950408889634f * y)));
  return y * r;
}

__device__ __forceinline__ uint4 lds128(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr));
  return v;
}
__device__ __forceinline__ void sts128(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr), "r"(v.x),
               "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

template <int BN>
__device__ __forceinline__ void wgmma_rs(float (&d)[BN / 2], const uint32_t (&a)[4],
                                         uint64_t db, int scale_d) {
  if constexpr (BN == 64) hop::wgmma_m64n64k16_rs(d, a, db, scale_d);
  else if constexpr (BN == 128) hop::wgmma_m64n128k16_rs(d, a, db, scale_d);
  else hop::wgmma_m64n160k16_rs(d, a, db, scale_d);
}

template <int V, int BN>
__global__ void __launch_bounds__(kThreads, 1)
gn_silu_conv3x3_kernel(const __grid_constant__ CUtensorMap tw,
                       const __grid_constant__ CUtensorMap tx,
                       const float* __restrict__ ga,
                       const float* __restrict__ gb,
                       const float* __restrict__ cb,
                       __nv_bfloat16* __restrict__ out, int N, int H, int W,
                       int C, int Co, int S, int stages) {
  extern __shared__ __align__(16) uint8_t smem_raw[];
  // offsets from the shared array itself, so the compiler keeps shared
  // loads and stores (not generic ones) for everything below
  uint8_t* base = smem_raw + ((1024u - (hop::smem_u32(smem_raw) & 1023u)) & 1023u);
  const int slots = 2 * S + kBM + 2, rows = halo_rows(S);
  const int b_stage = BN * kRowBytes, h_stage = rows * kRowBytes;
  uint8_t* wring = base;
  uint8_t* halo = wring + stages * b_stage;
  uint8_t* zero = halo + 3 * h_stage;
  float* bias_s = reinterpret_cast<float*>(zero + 16);
  int* slot_img = reinterpret_cast<int*>(bias_s + BN);
  uint64_t* full = reinterpret_cast<uint64_t*>(slot_img + rows);
  uint64_t* empty = full + stages;
  uint64_t* hfull = empty + stages;    // halo activated (producers -> consumers)
  uint64_t* hempty = hfull + 3;        // halo read (consumers -> producer)
  uint64_t* hload = hempty + 3;        // halo boxes landed (TMA -> producers)

  const int M = N * H * W, HW = H * W;
  const int tid = threadIdx.x;
  const int n_tiles = (Co + BN - 1) / BN;
  const int m0 = (blockIdx.x / n_tiles) * kBM, n0 = (blockIdx.x % n_tiles) * BN;
  const int nkc = (C + kKC - 1) / kKC, total = 9 * nkc;
  const uint32_t halo_u32 = hop::smem_u32(halo);

  // the source pixel of halo slot s: m0 - 1 + (j - 1) W + (s - j S)
  auto source = [&](int s) {
    const int j = min(s / S, 2);
    return m0 - 1 + (j - 1) * W + (s - j * S);
  };
  // each slot's image (-1 outside [0, M): the TMA zeros stay), once
  for (int s = tid; s < rows; s += kThreads) {
    const int q = source(s);
    slot_img[s] = q >= 0 && q < M ? q / HW : -1;
  }
  for (int i = tid; i < BN; i += kThreads) bias_s[i] = n0 + i < Co ? cb[n0 + i] : 0.f;
  if (tid < 4) reinterpret_cast<uint32_t*>(zero)[tid] = 0u;
  if (tid == 0) {
    for (int i = 0; i < stages; ++i) {
      hop::mbar_init(hop::smem_u32(&full[i]), 1);
      hop::mbar_init(hop::smem_u32(&empty[i]), 8);     // consumer warps
    }
    for (int i = 0; i < 3; ++i) {
      hop::mbar_init(hop::smem_u32(&hfull[i]), kProducers / 32);
      hop::mbar_init(hop::smem_u32(&hempty[i]), 8);
      hop::mbar_init(hop::smem_u32(&hload[i]), 1);
    }
    hop::mbar_init_fence();
  }
  __syncthreads();

  if (tid < kProducers) {
    // ---- producer warpgroups: the activated halo, and the weight ring ----
    hop::regs_dealloc<kProducerRegs>();
    const int v = tid & 7, g = tid >> 3, lane = tid & 31;   // vector, first slot
    // weight tiles issued so far by thread 0, polled between passes
    int issued = 0, pt = 0, pkc = 0, pst = 0, pph = 0;
    auto pump = [&](bool block) {
      while (issued < total) {
        const uint32_t e = hop::smem_u32(&empty[pst]);
        if (block) hop::mbar_wait(e, pph ^ 1);
        else if (!hop::mbar_test(e, pph ^ 1)) return;
        const uint32_t f = hop::smem_u32(&full[pst]);
        hop::mbar_expect_tx(f, b_stage);
        hop::tma_load_3d(hop::smem_u32(wring + pst * b_stage), &tw, f,
                         pt * C + pkc * kKC, n0, 0);
        ++issued;
        if (++pt == 9) pt = 0, ++pkc;
        if (++pst == stages) pst = 0, pph ^= 1;
      }
    };
    // thread 0: chunk kc's raw halo into buffer hb, one box per kBox slots
    auto load = [&](int kc, int hb) {
      const uint32_t bar = hop::smem_u32(&hload[hb]);
      if (V == kMmOnly) {            // no input read: the buffer is zeroed
        hop::mbar_arrive(bar);
        return;
      }
      hop::mbar_expect_tx(bar, h_stage);
      for (int s = 0; s < rows; s += kBox)
        hop::tma_load_3d(halo_u32 + hb * h_stage + s * kRowBytes, &tx, bar,
                         kc * kKC, source(s), 0);
    };
    // the affine and SiLU of this thread's vectors of buffer hb, in place.
    // They sit at slots g, g + kStep, ...: kStep is a multiple of 8, so all
    // in the same swizzle column
    constexpr int kStep = kProducers / 8;
    auto activate = [&](int kc, int hb) {
      const uint32_t buf = halo_u32 + hb * h_stage + g * kRowBytes + ((v ^ (g & 7)) << 4);
      if (V == kMmOnly) {
        for (int s = g; s < slots; s += kStep)
          sts128(buf + (s - g) * kRowBytes, make_uint4(0, 0, 0, 0));
        return;
      }
      const int c = kc * kKC + v * 8;
      if (c >= C) return;            // past C: TMA's zeros stay
      int cur = -1;                  // the image whose (a, b) fa / fb hold
      float fa[8], fb[8];
      auto affine = [&](int img) {
        cur = img;
        const float4* ap = reinterpret_cast<const float4*>(ga + (size_t)img * C + c);
        const float4* bp = reinterpret_cast<const float4*>(gb + (size_t)img * C + c);
        const float4 a0 = __ldg(ap), a1 = __ldg(ap + 1);
        const float4 b0 = __ldg(bp), b1 = __ldg(bp + 1);
        fa[0] = a0.x; fa[1] = a0.y; fa[2] = a0.z; fa[3] = a0.w;
        fa[4] = a1.x; fa[5] = a1.y; fa[6] = a1.z; fa[7] = a1.w;
        fb[0] = b0.x; fb[1] = b0.y; fb[2] = b0.z; fb[3] = b0.w;
        fb[4] = b1.x; fb[5] = b1.y; fb[6] = b1.z; fb[7] = b1.w;
      };
      auto act = [&](const uint4& raw) {
        float f[8];
        akt::unpack_vec(raw, f);
#pragma unroll
        for (int e = 0; e < 8; ++e) {
          const float y = V == kNoAffine ? f[e] : f[e] * fa[e] + fb[e];
          f[e] = V == kNoSilu ? y : silu(y);
        }
        return akt::pack_vec(f);
      };
      for (int s0 = g; s0 < slots; s0 += 4 * kStep) {
        uint4 raw[4];
        int img[4];
        bool same = true;            // every slot in [0, M) is in image cur
#pragma unroll
        for (int u = 0; u < 4; ++u) {
          const int s = s0 + kStep * u;
          img[u] = s < slots ? slot_img[s] : -1;
          raw[u] = s < slots ? lds128(buf + (s - g) * kRowBytes) : make_uint4(0, 0, 0, 0);
          same = same && (V == kNoAffine || img[u] < 0 || img[u] == cur);
        }
        if (same) {
          // the common case, without branches: 32 independent elements
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const int s = s0 + kStep * u;
            const uint4 y = act(raw[u]);
            if (s < slots)           // outside [0, M): the zeros stay
              sts128(buf + (s - g) * kRowBytes, img[u] >= 0 ? y : make_uint4(0, 0, 0, 0));
          }
        } else {
          // a chunk's first pass, or a tile that spans images
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            if (img[u] < 0) continue;
            if (img[u] != cur) affine(img[u]);
            sts128(buf + (s0 + kStep * u - g) * kRowBytes, act(raw[u]));
          }
        }
        if (tid == 0) pump(false);
      }
    };
    if (tid == 0) load(0, 0);
    int hb = 0, lph = 0;        // this chunk's buffer, its load parity
    int nb = 1, nph = 1;        // the next chunk's buffer, its release parity
    for (int kc = 0; kc < nkc; ++kc) {
      if (tid == 0 && kc + 1 < nkc) {
        const uint32_t he = hop::smem_u32(&hempty[nb]);
        for (uint32_t polls = 0; !hop::mbar_test(he, nph); ++polls) {
          pump(false);
          if (polls == (1u << 28)) __trap();   // a pipeline fault, not a hang
        }
        // the buffer's last activation (generic stores) before TMA's writes
        asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
        load(kc + 1, nb);
      }
      hop::mbar_wait(hop::smem_u32(&hload[hb]), lph);
      activate(kc, hb);
      __syncwarp();              // one arrival per warp: the warp's stores first
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&hfull[hb]));
      if (++hb == 3) hb = 0, lph ^= 1;
      if (++nb == 3) nb = 0, nph ^= 1;
    }
    if (tid == 0) pump(true);
  } else {
    // ---- consumer warpgroups: 64 output pixels each, all BN columns ----
    hop::regs_alloc<kConsumerRegs>();
    const int wg = tid / 128 - kProducers / 128, t = tid % 128;
    const int warp = t / 32, lane = t % 32;
    // this lane's ldmatrix row: pixel i of the block, 8-channel half hi
    const int i = wg * 64 + warp * 16 + (lane & 7) + ((lane >> 3) & 1) * 8;
    const int hi = lane >> 4;
    const int p = m0 + i;
    uint32_t mask = 0;      // bit ky * 3 + kx: the tap lies inside the image
    if (p < M) {
      const int r = p % HW, y = r / W, xx = r - y * W;
#pragma unroll
      for (int k = 0; k < 9; ++k) {
        const int yy = y + k / 3 - 1, xs = xx + k % 3 - 1;
        if (yy >= 0 && yy < H && xs >= 0 && xs < W && (V != kNoShift || k % 3 == 1))
          mask |= 1u << k;
      }
    }
    const uint32_t zero_u32 = hop::smem_u32(zero);
    const uint32_t wring_u32 = hop::smem_u32(wring);

    float acc[BN / 2];
    uint32_t a[4][4];
    int tap = 0, dyi = 0, dxi = 0, hs = 0, hph = 0, cst = 0, cph = 0;
    // one (chunk, tap) step of K = 64 per iteration. The A fragments are
    // register operands: loading the next step's while this step's
    // products run would redefine wgmma inputs inside a pipeline stage
    // (ptxas then serializes every product), so each step waits for its
    // own products; the other consumer warpgroup's products fill the gap.
    // (Two steps per wait need 16 more registers a thread: ptxas then
    // spills and serializes, which measured slower.)
    for (int j = 0; j < total; ++j) {
      if (tap == 0) hop::mbar_wait(hop::smem_u32(&hfull[hs]), hph);
      const int slot = i + dyi * S + dxi;
      const bool ok = (mask >> tap) & 1;
      const uint32_t row = halo_u32 + hs * h_stage + slot * kRowBytes;
      const int sw = slot & 7;
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::ldmatrix_x4(a[kk], ok ? row + ((((kk << 1) | hi) ^ sw) << 4) : zero_u32);
      hop::mbar_wait(hop::smem_u32(&full[cst]), cph);
      const uint32_t b = wring_u32 + cst * b_stage;
      hop::fence_regs(acc);
      hop::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<BN>(acc, a[kk], hop::desc_sw128(b + kk * 32), j > 0 || kk > 0);
      hop::wgmma_commit();
      hop::wgmma_wait<0>();
      hop::fence_regs(acc);
      __syncwarp();
      if (lane == 0) hop::mbar_arrive(hop::smem_u32(&empty[cst]));
      if (tap == 8) {      // the chunk's halo is read: the products used it
        if (lane == 0) hop::mbar_arrive(hop::smem_u32(&hempty[hs]));
        if (++hs == 3) hs = 0, hph ^= 1;
      }
      if (++cst == stages) cst = 0, cph ^= 1;
      if (++tap == 9) tap = 0;
      if (++dxi == 3) {
        dxi = 0;
        if (++dyi == 3) dyi = 0;
      }
    }

    // bias and bf16 store: acc[4 jn + e] holds column 8 jn + 2 (lane % 4) +
    // (e & 1) of row lane / 4 (e < 2) or lane / 4 + 8 of this warp's 16
    const int row0 = m0 + wg * 64 + warp * 16 + lane / 4, tq = lane % 4;
#pragma unroll
    for (int jn = 0; jn < BN / 8; ++jn) {
      const int col = n0 + 8 * jn + 2 * tq;   // Co % 8 == 0: col + 1 < Co too
      if (col >= Co) continue;
      const float2 bias = *reinterpret_cast<const float2*>(bias_s + 8 * jn + 2 * tq);
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int r = row0 + 8 * half;
        if (r >= M) continue;
        *reinterpret_cast<uint32_t*>(out + (size_t)r * Co + col) = akt::pack_bf16x2(
            acc[4 * jn + 2 * half] + bias.x, acc[4 * jn + 2 * half + 1] + bias.y);
      }
    }
  }
}

template <int V, int BN>
int launch_bn(const CUtensorMap& tw, const CUtensorMap& tx, const void* a,
              const void* b, const void* cb, void* y, int N, int H, int W, int C,
              int Co, int S, int stages, cudaStream_t stream) {
  const int smem = smem_bytes(BN, S, stages);
  static int attr = 0;   // the largest size set so far for this instance
  if (smem > attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        gn_silu_conv3x3_kernel<V, BN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return (int)e;
    attr = smem;
  }
  const long long m_tiles = ((long long)N * H * W + kBM - 1) / kBM;
  const long long blocks = m_tiles * ((Co + BN - 1) / BN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gn_silu_conv3x3_kernel<V, BN><<<(unsigned)blocks, kThreads, smem, stream>>>(
      tw, tx, (const float*)a, (const float*)b, (const float*)cb,
      (__nv_bfloat16*)y, N, H, W, C, Co, S, stages);
  return (int)cudaGetLastError();
}

// bn, S (the halo's row stride) and stages come from the wrapper's plan
// (ops/resconv.py `conv_plan`); anything else is refused
template <int V>
int launch(const void* x, const void* a, const void* b, const void* wt,
           const void* cb, void* y, int N, int H, int W, int C, int Co,
           int bn, int S, int stages, void* stream) {
  const long long M = (long long)N * H * W;
  if (C % 8 || Co % 8 || C <= 0 || Co <= 0 || stages < 2 || M > 0x7fffffffLL ||
      !(S == W ? W <= kBox : S == kBox && W > kBox) ||
      smem_bytes(bn, S, stages) > 232448)
    return (int)cudaErrorInvalidValue;
  if (M == 0) return 0;
  CUtensorMap tw, tx;
  int err = hop::token_map(&tw, wt, 1, Co, 9 * C, bn);
  if (!err) err = hop::token_map(&tx, x, 1, (int)M, C, kBox);
  if (err) return err;
  cudaStream_t s = (cudaStream_t)stream;
  switch (bn) {
    case 64: return launch_bn<V, 64>(tw, tx, a, b, cb, y, N, H, W, C, Co, S, stages, s);
    case 128: return launch_bn<V, 128>(tw, tx, a, b, cb, y, N, H, W, C, Co, S, stages, s);
    case 160: return launch_bn<V, 160>(tw, tx, a, b, cb, y, N, H, W, C, Co, S, stages, s);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// y (N, H, W, Co) = conv3x3(silu(x * a + b)) + cb; C % 8 == 0, Co % 8 == 0;
// bn / S / stages: the tile plan; the other entries are the stage
// knock-outs above, same arguments
#define GN_SILU_CONV3X3_ENTRY(NAME, V)                                        \
  extern "C" int NAME(const void* x, const void* a, const void* b,            \
                      const void* wt, const void* cb, void* y, int N, int H,  \
                      int W, int C, int Co, int bn, int S, int stages,        \
                      void* stream) {                                         \
    return launch<V>(x, a, b, wt, cb, y, N, H, W, C, Co, bn, S, stages,       \
                     stream);                                                 \
  }

GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_bf16, kFull)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_noshift_bf16, kNoShift)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_noaffine_bf16, kNoAffine)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_nosilu_bf16, kNoSilu)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_mmonly_bf16, kMmOnly)

// a block's dynamic shared memory for a plan (the wrapper's check)
extern "C" int gn_silu_conv3x3_smem(int bn, int S, int stages) {
  return smem_bytes(bn, S, stages);
}
