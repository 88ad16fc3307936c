// K8: y = conv3x3(silu(x * a + b)) + cb, NHWC, stride 1, SAME padding;
// x (N, H, W, C) bf16, (a, b) the per-(N, C) fp32 GroupNorm affine (from
// K7-GN's statistics), the weights re-laid out as Wt (Co, 9 * C) bf16 with
// k = (ky * 3 + kx) * C + c, cb fp32 (Co,), y (N, H, W, Co) bf16.
//
// Replaces the TPU kernel actalker_tpu/ops/resconv.py `_gnconv_kernel`
// (:43-87, launched by `_gnconv_pallas` :96). Same numerics: the affine and
// SiLU (y / (1 + exp(-y))) in fp32, the activation rounded to bf16 before
// the product, fp32 accumulation, the bias added in fp32, one rounding of
// the output. The zero padding is applied to the ACTIVATED tensor (as the
// TPU kernel zero-fills its im2col scratch after activating): a tap that
// falls outside the image contributes 0, not silu(b).
//
// What bounds it on the H100: tensor-core operations, 2 * N*H*W * 9*C * Co
// (4.2e11 at (56, 64, 64, 320 -> 320), 0.43 ms at 989 TFLOP/s). Design,
// first version: an implicit GEMM over M = N*H*W output pixels, N = Co,
// K = 9*C, with K4's tiling (128 x 64 block tile, 8 warps of 32 x 32,
// k-steps of 32, mma.sync m16n8k16 bf16 -> fp32, the next k-tile fetched
// into registers while the current one is multiplied). The A tile is
// gathered, not loaded: each 16-byte vector of a row is 8 channels of one
// tap of one output pixel, read from the shifted input pixel when that lies
// inside its image and zero otherwise; the raw vector and its (a, b) are
// prefetched, and the affine + SiLU run when the tile is staged to shared
// memory. Each row decodes its own (n, y, x), so a tile may span images
// (8 x 8 and 16 x 16 images are smaller than a tile), and a tap at x = 0 or
// x = W - 1 never reads the neighbouring row. The activation is recomputed
// per tap and per Co tile (Co / 64 times); keeping it in shared memory
// across a whole Co row, and wgmma / TMA, are later work.
//
// Stage knock-outs (template parameter V), the port of the TPU bisect tool
// tools/micro_resconv_bisect.py (`kernel` :30-65, launched at :79), each
// with its own C entry; kFull is K8:
//   kNoShift  only the dx = 0 taps are gathered (the others are zeros),
//   kNoAffine SiLU of x without the GroupNorm affine (a, b not read),
//   kNoSilu   the affine without SiLU,
//   kMmOnly   the gather writes zeros and reads no input (y = cb).
#include "common.cuh"

namespace {

enum Variant { kFull, kNoShift, kNoAffine, kNoSilu, kMmOnly };

constexpr int kBM = 128, kBN = 64, kBK = 32;
constexpr int kPad = kBK + 8;   // shared row stride in bf16 (conflict-free frags)
constexpr int kThreads = 256;

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

template <int V>
__global__ void __launch_bounds__(kThreads)
gn_silu_conv3x3_kernel(const __nv_bfloat16* __restrict__ x,
                       const float* __restrict__ ga,
                       const float* __restrict__ gb,
                       const __nv_bfloat16* __restrict__ Wt,
                       const float* __restrict__ cb,
                       __nv_bfloat16* __restrict__ out, int N, int H, int W,
                       int C, int Co) {
  __shared__ __align__(16) __nv_bfloat16 As[kBM * kPad];
  __shared__ __align__(16) __nv_bfloat16 Bs[kBN * kPad];

  const int M = N * H * W, K = 9 * C;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int wm = warp / 2, wn = warp % 2;      // 4 x 2 warps of 32 x 32
  const int n_tiles = (Co + kBN - 1) / kBN;
  const int m0 = (blockIdx.x / n_tiles) * kBM, n0 = (blockIdx.x % n_tiles) * kBN;

  // the two A rows this thread gathers (fixed over k): image, y, x
  int rimg[2], ry[2], rx[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int p = m0 + (tid + i * kThreads) / 4;
    rimg[i] = -1;
    if (p < M) {
      rimg[i] = p / (H * W);
      const int rem = p - rimg[i] * H * W;
      ry[i] = rem / W;
      rx[i] = rem - ry[i] * W;
    }
  }

  // global -> register staging: per A vector the raw x and its (a, b)
  uint4 ra[2], rb;
  float4 pa[2][2], pb[2][2];
  bool inside[2];
  auto load = [&](int k0) {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int k = k0 + ((tid + i * kThreads) % 4) * 8;
      inside[i] = false;
      if (V != kMmOnly && rimg[i] >= 0 && k < K) {
        const int tap = k / C, c = k - tap * C;
        const int yy = ry[i] + tap / 3 - 1, xx = rx[i] + tap % 3 - 1;
        if (yy >= 0 && yy < H && xx >= 0 && xx < W &&
            (V != kNoShift || tap % 3 == 1)) {
          inside[i] = true;
          ra[i] = *reinterpret_cast<const uint4*>(
              x + (((size_t)rimg[i] * H + yy) * W + xx) * C + c);
          if (V != kNoAffine) {
            const float* ap = ga + (size_t)rimg[i] * C + c;
            const float* bp = gb + (size_t)rimg[i] * C + c;
            pa[i][0] = *reinterpret_cast<const float4*>(ap);
            pa[i][1] = *reinterpret_cast<const float4*>(ap + 4);
            pb[i][0] = *reinterpret_cast<const float4*>(bp);
            pb[i][1] = *reinterpret_cast<const float4*>(bp + 4);
          }
        }
      }
    }
    const int r = tid / 4, c = (tid % 4) * 8;
    rb = make_uint4(0, 0, 0, 0);
    if (n0 + r < Co && k0 + c < K)
      rb = *reinterpret_cast<const uint4*>(Wt + (size_t)(n0 + r) * K + k0 + c);
  };
  auto store = [&]() {
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int idx = tid + i * kThreads, r = idx / 4, c = (idx % 4) * 8;
      uint4 v = make_uint4(0, 0, 0, 0);     // the zero halo, after SiLU
      if (inside[i]) {
        float f[8];
        akt::unpack_vec(ra[i], f);
        const float a[8] = {pa[i][0].x, pa[i][0].y, pa[i][0].z, pa[i][0].w,
                            pa[i][1].x, pa[i][1].y, pa[i][1].z, pa[i][1].w};
        const float b[8] = {pb[i][0].x, pb[i][0].y, pb[i][0].z, pb[i][0].w,
                            pb[i][1].x, pb[i][1].y, pb[i][1].z, pb[i][1].w};
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const float y = V == kNoAffine ? f[j] : f[j] * a[j] + b[j];
          f[j] = V == kNoSilu ? y : __fdividef(y, 1.f + __expf(-y));
        }
        v = akt::pack_vec(f);
      }
      *reinterpret_cast<uint4*>(&As[r * kPad + c]) = v;
    }
    const int r = tid / 4, c = (tid % 4) * 8;
    *reinterpret_cast<uint4*>(&Bs[r * kPad + c]) = rb;
  };

  float acc[2][4][4];
#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mi][ni][e] = 0.f;

  load(0);
  store();
  __syncthreads();
  for (int k0 = 0; k0 < K; k0 += kBK) {
    const bool more = k0 + kBK < K;
    if (more) load(k0 + kBK);
#pragma unroll
    for (int kk = 0; kk < kBK / 16; ++kk) {
      uint32_t a[2][4];
#pragma unroll
      for (int mi = 0; mi < 2; ++mi) {
        const __nv_bfloat16* p = &As[(wm * 32 + mi * 16 + gr) * kPad + kk * 16 + 2 * tq];
        a[mi][0] = ld32(p);
        a[mi][1] = ld32(p + 8 * kPad);
        a[mi][2] = ld32(p + 8);
        a[mi][3] = ld32(p + 8 * kPad + 8);
      }
#pragma unroll
      for (int ni = 0; ni < 4; ++ni) {
        const __nv_bfloat16* p = &Bs[(wn * 32 + ni * 8 + gr) * kPad + kk * 16 + 2 * tq];
        const uint32_t b0 = ld32(p), b1 = ld32(p + 8);
#pragma unroll
        for (int mi = 0; mi < 2; ++mi) akt::mma_bf16_16816(acc[mi][ni], a[mi], b0, b1);
      }
    }
    __syncthreads();
    if (more) {
      store();
      __syncthreads();
    }
  }

#pragma unroll
  for (int mi = 0; mi < 2; ++mi)
#pragma unroll
    for (int ni = 0; ni < 4; ++ni) {
      const int col = n0 + wn * 32 + ni * 8 + 2 * tq;
      if (col >= Co) continue;   // Co % 8 == 0, so col + 1 < Co as well
#pragma unroll
      for (int half = 0; half < 2; ++half) {
        const int row = m0 + wm * 32 + mi * 16 + gr + half * 8;
        if (row >= M) continue;
        const float y0 = acc[mi][ni][2 * half] + cb[col];
        const float y1 = acc[mi][ni][2 * half + 1] + cb[col + 1];
        *reinterpret_cast<uint32_t*>(out + (size_t)row * Co + col) = akt::pack_bf16x2(y0, y1);
      }
    }
}

template <int V>
int launch(const void* x, const void* a, const void* b, const void* wt,
           const void* cb, void* y, int N, int H, int W, int C, int Co,
           void* stream) {
  const long long m_tiles = ((long long)N * H * W + kBM - 1) / kBM;
  const long long blocks = m_tiles * ((Co + kBN - 1) / kBN);
  if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  gn_silu_conv3x3_kernel<V><<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)x, (const float*)a, (const float*)b,
      (const __nv_bfloat16*)wt, (const float*)cb, (__nv_bfloat16*)y, N, H, W, C,
      Co);
  return (int)cudaGetLastError();
}

}  // namespace

// y (N, H, W, Co) = conv3x3(silu(x * a + b)) + cb; C % 8 == 0, Co % 8 == 0;
// the other entries are the stage knock-outs above, same arguments
#define GN_SILU_CONV3X3_ENTRY(NAME, V)                                        \
  extern "C" int NAME(const void* x, const void* a, const void* b,            \
                      const void* wt, const void* cb, void* y, int N, int H,  \
                      int W, int C, int Co, void* stream) {                   \
    return launch<V>(x, a, b, wt, cb, y, N, H, W, C, Co, stream);             \
  }

GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_bf16, kFull)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_noshift_bf16, kNoShift)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_noaffine_bf16, kNoAffine)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_nosilu_bf16, kNoSilu)
GN_SILU_CONV3X3_ENTRY(gn_silu_conv3x3_mmonly_bf16, kMmOnly)
