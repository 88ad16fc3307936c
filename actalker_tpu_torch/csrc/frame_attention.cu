// K3: attention across the F frames of each spatial token, q/k/v/o
// (B*F, S, H*64) bf16 token layout.
//
// Replaces the TPU kernel actalker_tpu/ops/mha.py `_frame_kernel_v2`
// (:401-451, launched by `_frame_pallas_v2` :461; the v1 `_frame_kernel`
// computes the same function). For each (batch, token, head) the F x F
// scores q_f . k_g * scale are softmaxed over key frames g in fp32 and
// applied to v_g.
//
// What bounds it on the H100: bytes. F <= 25 gives F^2 * 64 * 4 flops per
// (token, head) against 4 * F * 64 * 2 bytes, far too little work per byte
// and far too small a product for tensor cores; the floor is
// 4 * B*F*S*C * 2 bytes (0.59 GB, ~0.18 ms at 3.35 TB/s, for
// (56, 4096, 320)). Design: a group of 8 lanes per (batch, token, head,
// query frame) with 8 channels per lane, so every row read is one 16-byte
// load per lane and 128 contiguous bytes per group; the dot product is a
// 3-step shuffle reduction inside the group and the softmax over key frames
// is online (running max and sum in fp32). Query frames are the fastest
// index, so the groups of one warp read the same key/value rows and the
// repeated reads hit L1.
#include "common.cuh"

namespace {

constexpr int kD = 64;
constexpr int kLanes = 8;       // lanes per (token, head, query frame)
constexpr int kThreads = 256;

__device__ __forceinline__ void unpack8(const uint4& raw, float* out) {
  const __nv_bfloat16* e = reinterpret_cast<const __nv_bfloat16*>(&raw);
#pragma unroll
  for (int j = 0; j < 8; ++j) out[j] = __bfloat162float(e[j]);
}

__global__ void __launch_bounds__(kThreads)
frame_attn_kernel(const __nv_bfloat16* __restrict__ q,
                  const __nv_bfloat16* __restrict__ k,
                  const __nv_bfloat16* __restrict__ v,
                  __nv_bfloat16* __restrict__ o, long long groups, int F,
                  int S, int H, float scale_log2) {
  const long long gid_raw = ((long long)blockIdx.x * kThreads + threadIdx.x) / kLanes;
  const bool valid = gid_raw < groups;
  const long long gid = valid ? gid_raw : groups - 1;  // keep every lane in the shuffles
  const int lane = threadIdx.x % kLanes;
  const int qf = (int)(gid % F);
  long long rest = gid / F;
  const int h = (int)(rest % H);
  rest /= H;
  const int s = (int)(rest % S);
  const long long b = rest / S;
  const int C = H * kD;
  const size_t col = (size_t)h * kD + lane * 8;
  // row of frame f: ((b*F + f)*S + s)*C
  const size_t frame_stride = (size_t)S * C;
  const size_t row0 = ((size_t)b * F * S + s) * C + col;

  float qv[8], acc[8];
  unpack8(*reinterpret_cast<const uint4*>(q + row0 + qf * frame_stride), qv);
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    qv[j] *= scale_log2;
    acc[j] = 0.f;
  }
  float m = -INFINITY, l = 0.f;
  for (int g = 0; g < F; ++g) {
    float kv[8], vv[8];
    unpack8(*reinterpret_cast<const uint4*>(k + row0 + g * frame_stride), kv);
    unpack8(*reinterpret_cast<const uint4*>(v + row0 + g * frame_stride), vv);
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
    uint4 out;
    uint32_t* w = reinterpret_cast<uint32_t*>(&out);
#pragma unroll
    for (int j = 0; j < 4; ++j)
      w[j] = akt::pack_bf16x2(acc[2 * j] * inv, acc[2 * j + 1] * inv);
    *reinterpret_cast<uint4*>(o + row0 + qf * frame_stride) = out;
  }
}

}  // namespace

extern "C" int frame_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int B, int F,
                                    int S, int H, float scale, void* stream) {
  const long long groups = (long long)B * F * S * H;
  const long long threads = groups * kLanes;
  const unsigned blocks = (unsigned)((threads + kThreads - 1) / kThreads);
  frame_attn_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const __nv_bfloat16*)q, (const __nv_bfloat16*)k,
      (const __nv_bfloat16*)v, (__nv_bfloat16*)o, groups, F, S, H,
      scale * 1.4426950408889634f);
  return (int)cudaGetLastError();
}
