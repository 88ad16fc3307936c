// K3: attention across the F frames of each spatial token, q/k/v/o
// (B*F, S, H*64) bf16 token layout.
//
// Replaces the TPU kernel actalker_tpu/ops/mha.py `_frame_kernel_v2`
// (:401-451, launched by `_frame_pallas_v2` :461; the v1 `_frame_kernel`
// computes the same function). For each (batch, token, head) the F x F
// scores q_f . k_g * scale are softmaxed over key frames g in fp32 and
// applied to v_g.
//
// What bounds it on the H100: bytes. Per (token, head) it reads 3 * F rows
// of 128 bytes and writes F, and does 4 * F^2 * 64 flops: at F = 25 that is
// 50 flops per byte, far below the tensor cores' ridge. The floor is
// 4 * B*F*S*C * 2 bytes (1.05 GB, ~0.31 ms at 3.35 TB/s, for
// (100, 4096, 320)), so the design reads every byte once and keeps the
// instructions per byte low.
//
// Design (F <= 32): one warp per (batch, token, head), four warps a block.
//   - staging: the warp copies its token's F query, key and value rows
//     (128 bytes each: one frame's 64 channels) into shared memory with
//     cp.async, keys and queries first, values in a second group that lands
//     while the scores are computed; 16-byte chunk c of frame row f sits at
//     chunk c ^ (f & 7), so the ldmatrix reads below (8 frames of one chunk)
//     hit 8 distinct bank groups;
//   - scores on the tensor cores: per 16 query frames (one m-tile; F <= 16
//     takes one, F <= 32 two) S = Q K^T by mma.sync m16n8k16 (bf16 in, fp32
//     accumulate: exact products, and the scale 1/8 is a power of two),
//     key frames padded to 16 or 32 and masked to -inf past F; rows of frame
//     index >= F read frame F-1, so every operand is finite;
//   - softmax in registers: the row max and sum over a quad of lanes (two
//     shuffles each), one exp2 per score;
//   - P V on the tensor cores with P kept fp32 in effect: P is split into
//     bf16 hi + lo (p - hi), both multiplied by V (ldmatrix.trans
//     fragments), so P carries ~16 mantissa bits, as the TPU kernel's fp32 P;
//   - the normalized output goes back through the warp's query rows in
//     shared memory and leaves as 16-byte stores, 8 lanes per 128-byte row.
// F > 32 (on no path of the model) takes a plain kernel: 8 lanes per
// (batch, token, head, query frame), an online softmax over key frames.
#include "common.cuh"
#include "hopper.cuh"

namespace {

constexpr int kD = 64;          // head dim
constexpr int kRow = kD * 2;    // bytes of one (frame, token, head) row
constexpr int kWarps = 4;       // tokens (warps) per block
constexpr int kMaxF = 32;       // frames on the tensor-core path
constexpr float kLog2e = 1.4426950408889634f;

// byte offset of 16-byte chunk c of frame row f in a warp's staged rows
__device__ __forceinline__ uint32_t chunk_at(int f, int c) {
  return (uint32_t)(f * kRow + ((c ^ (f & 7)) << 4));
}

// MT m-tiles of 16 query frames; the key frames are padded to 16 * MT
template <int MT>
__global__ void __launch_bounds__(kWarps * 32)
frame_attn_mma_kernel(const __nv_bfloat16* __restrict__ q,
                      const __nv_bfloat16* __restrict__ k,
                      const __nv_bfloat16* __restrict__ v,
                      __nv_bfloat16* __restrict__ o, int F, int S, int H,
                      float scale_log2) {
  constexpr int NT = 2 * MT;    // n-tiles of 8 key frames
  extern __shared__ __align__(128) uint8_t smem[];
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int s = blockIdx.x * kWarps + warp;
  if (s >= S) return;           // no block-wide barrier below
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t frame_stride = (size_t)S * H * kD;
  const size_t off0 = ((size_t)b * F * S + s) * H * kD + (size_t)h * kD;
  uint8_t* rows = smem + (size_t)warp * 3 * F * kRow;   // Q | K | V
  const uint32_t sq = hop::smem_u32(rows);
  const uint32_t sk = sq + F * kRow, sv = sk + F * kRow;

  auto stage = [&](const __nv_bfloat16* src, uint32_t dst) {
    for (int i = lane; i < F * 8; i += 32) {
      const int f = i >> 3, c = i & 7;
      hop::cp_async16(dst + chunk_at(f, c), src + off0 + f * frame_stride + c * 8);
    }
    hop::cp_async_commit();
  };
  stage(k, sk);
  stage(q, sq);
  stage(v, sv);
  hop::cp_async_wait<1>();   // keys and queries
  __syncwarp();

  // per-lane ldmatrix row: lanes 8j..8j+7 address matrix j
  const int r8 = lane & 7, mj = lane >> 3;
  const int g = lane >> 2, t = lane & 3;   // mma fragment row / column pair

#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // Q fragments for the 4 k-steps of 16 channels
    uint32_t qa[4][4];
    {
      const int f = min(16 * mt + r8 + 8 * (mj & 1), F - 1);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        hop::ldmatrix_x4(qa[kk], sq + chunk_at(f, 2 * kk + (mj >> 1)));
    }
    float sc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      sc[nt][0] = sc[nt][1] = sc[nt][2] = sc[nt][3] = 0.f;
      const int f = min(8 * nt + r8, F - 1);
#pragma unroll
      for (int kp = 0; kp < 2; ++kp) {   // two k-steps per ldmatrix.x4
        uint32_t kb[4];
        hop::ldmatrix_x4(kb, sk + chunk_at(f, 4 * kp + mj));
        akt::mma_bf16_16816(sc[nt], qa[2 * kp], kb[0], kb[1]);
        akt::mma_bf16_16816(sc[nt], qa[2 * kp + 1], kb[2], kb[3]);
      }
    }
    // softmax over key frames: rows g (c0, c1) and g + 8 (c2, c3)
    float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const bool live = 8 * nt + 2 * t + e < F;
        sc[nt][e] = live ? sc[nt][e] * scale_log2 : -INFINITY;
        sc[nt][2 + e] = live ? sc[nt][2 + e] * scale_log2 : -INFINITY;
        mx0 = fmaxf(mx0, sc[nt][e]);
        mx1 = fmaxf(mx1, sc[nt][2 + e]);
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, x));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, x));
    }
    float l0 = 0.f, l1 = 0.f;
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        sc[nt][e] = hop::exp2_fast(sc[nt][e] - mx0);
        sc[nt][2 + e] = hop::exp2_fast(sc[nt][2 + e] - mx1);
        l0 += sc[nt][e];
        l1 += sc[nt][2 + e];
      }
    }
#pragma unroll
    for (int x = 1; x <= 2; x <<= 1) {
      l0 += __shfl_xor_sync(0xffffffffu, l0, x);
      l1 += __shfl_xor_sync(0xffffffffu, l1, x);
    }
    // P = hi + lo in bf16, as A fragments of the MT k-steps of 16 key frames
    uint32_t ph[MT][4], pl[MT][4];
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        // a0 / a1: n-tile 2kk rows g / g+8; a2 / a3: n-tile 2kk+1
        const float* c = sc[2 * kk + (j >> 1)] + 2 * (j & 1);
        const __nv_bfloat162 hi = __floats2bfloat162_rn(c[0], c[1]);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(c[0] - hf.x, c[1] - hf.y);
        ph[kk][j] = *reinterpret_cast<const uint32_t*>(&hi);
        pl[kk][j] = *reinterpret_cast<const uint32_t*>(&lo);
      }
    }
    if (mt == 0) {
      hop::cp_async_wait<0>();   // values
      __syncwarp();
    }
    float acc[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j][0] = acc[j][1] = acc[j][2] = acc[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < MT; ++kk) {
      const int f = min(16 * kk + r8 + 8 * (mj & 1), F - 1);
#pragma unroll
      for (int p = 0; p < 4; ++p) {   // channel n-tiles 2p, 2p + 1
        uint32_t vb[4];
        hop::ldmatrix_x4_trans(vb, sv + chunk_at(f, 2 * p + (mj >> 1)));
        akt::mma_bf16_16816(acc[2 * p], ph[kk], vb[0], vb[1]);
        akt::mma_bf16_16816(acc[2 * p], pl[kk], vb[0], vb[1]);
        akt::mma_bf16_16816(acc[2 * p + 1], ph[kk], vb[2], vb[3]);
        akt::mma_bf16_16816(acc[2 * p + 1], pl[kk], vb[2], vb[3]);
      }
    }
    // normalized rows into this m-tile's (already read) query rows
    __syncwarp();
    const float inv0 = 1.f / l0, inv1 = 1.f / l1;
    const int f0 = 16 * mt + g, f1 = f0 + 8;
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      if (f0 < F)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sq + chunk_at(f0, j) + 4 * t),
                     "r"(akt::pack_bf16x2(acc[j][0] * inv0, acc[j][1] * inv0)));
      if (f1 < F)
        asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(sq + chunk_at(f1, j) + 4 * t),
                     "r"(akt::pack_bf16x2(acc[j][2] * inv1, acc[j][3] * inv1)));
    }
  }
  __syncwarp();
  for (int i = lane; i < F * 8; i += 32) {
    const int f = i >> 3, c = i & 7;
    *reinterpret_cast<uint4*>(o + off0 + f * frame_stride + c * 8) =
        *reinterpret_cast<const uint4*>(rows + chunk_at(f, c));
  }
}

// F > 32: a group of 8 lanes per (batch, token, head, query frame), 8
// channels a lane, online softmax over the key frames
constexpr int kRowsLanes = 8;
constexpr int kRowsThreads = 256;

__global__ void __launch_bounds__(kRowsThreads)
frame_attn_rows_kernel(const __nv_bfloat16* __restrict__ q,
                       const __nv_bfloat16* __restrict__ k,
                       const __nv_bfloat16* __restrict__ v,
                       __nv_bfloat16* __restrict__ o, long long groups, int F,
                       int S, int H, float scale_log2) {
  const long long gid_raw =
      ((long long)blockIdx.x * kRowsThreads + threadIdx.x) / kRowsLanes;
  const bool valid = gid_raw < groups;
  const long long gid = valid ? gid_raw : groups - 1;  // keep every lane in the shuffles
  const int lane = threadIdx.x % kRowsLanes;
  const int qf = (int)(gid % F);
  long long rest = gid / F;
  const int h = (int)(rest % H);
  rest /= H;
  const int s = (int)(rest % S);
  const long long b = rest / S;
  const size_t C = (size_t)H * kD;
  const size_t frame_stride = (size_t)S * C;
  const size_t row0 = ((size_t)b * F * S + s) * C + (size_t)h * kD + lane * 8;

  float qv[8], acc[8];
  akt::load_vec(q + row0 + qf * frame_stride, qv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qv[j] *= scale_log2;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int g = 0; g < F; ++g) {
    float kv[8], vv[8];
    akt::load_vec(k + row0 + g * frame_stride, kv);
    akt::load_vec(v + row0 + g * frame_stride, vv);
    float dot = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) dot += qv[j] * kv[j];
    dot += __shfl_xor_sync(0xffffffffu, dot, 4);
    dot += __shfl_xor_sync(0xffffffffu, dot, 2);
    dot += __shfl_xor_sync(0xffffffffu, dot, 1);
    const float mn = fmaxf(m, dot);
    const float al = exp2f(m - mn);
    const float p = exp2f(dot - mn);
    l = l * al + p;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] = acc[j] * al + p * vv[j];
    m = mn;
  }
  if (valid) {
    const float inv = 1.f / l;
#pragma unroll
    for (int j = 0; j < 8; ++j) acc[j] *= inv;
    akt::store_vec(o + row0 + qf * frame_stride, acc);
  }
}

template <int MT>
int launch_mma(const void* q, const void* k, const void* v, void* o, int B,
               int F, int S, int H, float scale_log2, int smem,
               cudaStream_t stream) {
  static bool attr = false;
  if (!attr) {
    const cudaError_t e = cudaFuncSetAttribute(
        frame_attn_mma_kernel<MT>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kWarps * 3 * kMaxF * kRow);
    if (e != cudaSuccess) return (int)e;
    attr = true;
  }
  dim3 grid((S + kWarps - 1) / kWarps, H, B);
  frame_attn_mma_kernel<MT><<<grid, kWarps * 32, smem, stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, F, S, H, scale_log2);
  return (int)cudaGetLastError();
}

}  // namespace

// m_tiles: 1 (F <= 16) or 2 (F <= 32) for the tensor-core kernel, 0 for the
// plain kernel (any F); smem: the tensor-core kernel's dynamic shared bytes,
// kWarps * 3 * F * 128. Both come from the wrapper's plan
// (ops/mha.py::frame_plan); a plan that disagrees is refused.
extern "C" int frame_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int F,
                                    int S, int H, float scale, int m_tiles,
                                    int smem, void* stream) {
  const float scale_log2 = scale * kLog2e;
  cudaStream_t st = (cudaStream_t)stream;
  const bool mma = F <= kMaxF;
  if (m_tiles != (mma ? (F + 15) / 16 : 0) ||
      smem != (mma ? kWarps * 3 * F * kRow : 0))
    return (int)cudaErrorInvalidValue;
  if (m_tiles == 1) return launch_mma<1>(q, k, v, o, B, F, S, H, scale_log2, smem, st);
  if (m_tiles == 2) return launch_mma<2>(q, k, v, o, B, F, S, H, scale_log2, smem, st);
  const long long groups = (long long)B * F * S * H;
  const unsigned blocks =
      (unsigned)((groups * kRowsLanes + kRowsThreads - 1) / kRowsThreads);
  frame_attn_rows_kernel<<<blocks, kRowsThreads, 0, st>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, groups, F, S, H, scale_log2);
  return (int)cudaGetLastError();
}
