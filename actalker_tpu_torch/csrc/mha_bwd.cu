// K2 backward: gradients of softmax self-attention in token layout,
// q/k/v/o/dO/dq/dk/dv (B, S, H*64) bf16.
//
// Replaces what the JAX package runs for `mha_tokens`' backward
// (actalker_tpu/ops/mha.py `_mha_bwd` :280-335): the stock Pallas TPU
// flash-attention backward on (B, H, S, D) transposes. Same function, in
// the token layout (a head is a 64-column slice of the token rows):
//   P = softmax(q k^T * scale), D = rowsum(dO o)
//   dV = P^T dO,  dP = dO V^T,  dS = P (dP - D),
//   dQ = scale dS K,  dK = scale dS^T Q.
// P is recomputed from the forward's row log-sum-exp (mha.cu, kLse entry,
// base-2 scaled domain), so no S x S matrix is ever stored.
//
// What bounds it on the H100: 7 products of 2 * S^2 * 64 flops per (batch,
// head) (5 in the dK/dV pass, 2 recomputed in the dQ pass): tensor-core
// work, 1.9 TFLOP at (25, 4096, 320, h5), against O(B * S * C) bytes.
// Design (FlashAttention-2's backward, first version, mma.sync m16n8k16
// bf16 -> fp32 as the forward):
//   1. `row_dot`: D = rowsum(dO o) in fp32, one thread per (token, head);
//   2. `dkdv_kernel`: one block of 4 warps per (64-key tile, head, batch),
//      each warp owning 16 keys with its K / V fragments and its fp32 dK /
//      dV accumulators in registers; it walks all query tiles, staging Q and
//      dO in both row and transposed layouts in shared memory, and forms
//      P^T, dP^T and dS^T in registers (repacked into A fragments as the
//      forward repacks P);
//   3. `dq_kernel`: one block per (64-query tile, head, batch) walks the
//      key tiles as the forward does and accumulates dQ in registers, so
//      no atomics are needed and the result is deterministic.
// Ragged S is masked in the kernels (zero-filled rows, lse = +inf for
// query rows past S). wgmma / TMA pipelining is later work.
#include "common.cuh"

namespace {

constexpr int kD = 64;        // head dim
constexpr int kT = 64;        // rows per tile (queries or keys)
constexpr int kPad = 72;      // shared row stride in bf16
constexpr int kThreads = 128;

typedef __nv_bfloat16 bf16;

__device__ __forceinline__ uint32_t ld32(const bf16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// token rows [r0, r0 + 64) x 64 columns (zero past S) into s[row][kPad]
__device__ __forceinline__ void load_rows(bf16* s, const bf16* g, int r0,
                                          int S, int C, int tid) {
#pragma unroll
  for (int i = 0; i < (kT * kD / 8) / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / 8, c = idx % 8;
    uint4 v = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) v = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * C + c * 8);
    *reinterpret_cast<uint4*>(s + r * kPad + c * 8) = v;
  }
}

// the same tile transposed: s[col][row]
__device__ __forceinline__ void load_cols(bf16* s, const bf16* g, int r0,
                                          int S, int C, int tid) {
#pragma unroll
  for (int i = 0; i < (kT * kD / 8) / kThreads; ++i) {
    const int idx = tid + i * kThreads;
    const int r = idx / 8, c = idx % 8;
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (r0 + r < S) raw = *reinterpret_cast<const uint4*>(g + (size_t)(r0 + r) * C + c * 8);
    const bf16* e = reinterpret_cast<const bf16*>(&raw);
#pragma unroll
    for (int j = 0; j < 8; ++j) s[(c * 8 + j) * kPad + r] = e[j];
  }
}

// A fragments (16 rows from `row0`, k = 64 columns) of a [row][kPad] tile
__device__ __forceinline__ void load_a(uint32_t f[4][4], const bf16* s,
                                       int row0, int gr, int tq) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    f[kk][0] = ld32(&s[(row0 + gr) * kPad + kk * 16 + 2 * tq]);
    f[kk][1] = ld32(&s[(row0 + gr + 8) * kPad + kk * 16 + 2 * tq]);
    f[kk][2] = ld32(&s[(row0 + gr) * kPad + kk * 16 + 2 * tq + 8]);
    f[kk][3] = ld32(&s[(row0 + gr + 8) * kPad + kk * 16 + 2 * tq + 8]);
  }
}

// acc[nt] (16 x 64) += X (16 x 64, fp32 accumulators x[8][4] packed to bf16
// A fragments) times B, B read as col-major from s[n][k] (n = 64 outputs)
__device__ __forceinline__ void mma_acc_pack(float acc[8][4], const float x[8][4],
                                             const bf16* s, int gr, int tq) {
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    uint32_t pa[4];
    pa[0] = akt::pack_bf16x2(x[2 * kk][0], x[2 * kk][1]);
    pa[1] = akt::pack_bf16x2(x[2 * kk][2], x[2 * kk][3]);
    pa[2] = akt::pack_bf16x2(x[2 * kk + 1][0], x[2 * kk + 1][1]);
    pa[3] = akt::pack_bf16x2(x[2 * kk + 1][2], x[2 * kk + 1][3]);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt) {
      const bf16* br = &s[(nt * 8 + gr) * kPad + kk * 16 + 2 * tq];
      akt::mma_bf16_16816(acc[nt], pa, ld32(br), ld32(br + 8));
    }
  }
}

// out[nt] (16 x 64) = A (fragments, k = 64) times B col-major from s[n][k]
__device__ __forceinline__ void mma_frag(float out[8][4], const uint32_t a[4][4],
                                         const bf16* s, int gr, int tq) {
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    out[nt][0] = out[nt][1] = out[nt][2] = out[nt][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      const bf16* br = &s[(nt * 8 + gr) * kPad + kk * 16 + 2 * tq];
      akt::mma_bf16_16816(out[nt], a[kk], ld32(br), ld32(br + 8));
    }
  }
}

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

__global__ void __launch_bounds__(kThreads)
dkdv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
            const bf16* __restrict__ v, const bf16* __restrict__ dO,
            const float* __restrict__ lse, const float* __restrict__ Dv,
            bf16* __restrict__ dk, bf16* __restrict__ dv, int S, int C,
            float scale, float scale_log2) {
  __shared__ __align__(16) bf16 Qs[kT * kPad];   // [query][d]
  __shared__ __align__(16) bf16 Qt[kD * kPad];   // [d][query]
  __shared__ __align__(16) bf16 Os[kT * kPad];   // dO [query][d]
  __shared__ __align__(16) bf16 Ot[kD * kPad];   // dO [d][query]
  __shared__ float s_lse[kT], s_D[kT];

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int k0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const size_t base = (size_t)b * S * C + (size_t)h * kD;
  const float* lse_bh = lse + ((size_t)b * H + h) * S;
  const float* D_bh = Dv + ((size_t)b * H + h) * S;

  load_rows(Qs, k + base, k0, S, C, tid);
  load_rows(Os, v + base, k0, S, C, tid);
  __syncthreads();
  uint32_t kf[4][4], vf[4][4];
  load_a(kf, Qs, warp * 16, gr, tq);
  load_a(vf, Os, warp * 16, gr, tq);

  float acc_k[8][4], acc_v[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc_k[i][e] = acc_v[i][e] = 0.f;

  for (int q0 = 0; q0 < S; q0 += kT) {
    __syncthreads();   // previous tile (and the K / V staging) consumed
    load_rows(Qs, q + base, q0, S, C, tid);
    load_cols(Qt, q + base, q0, S, C, tid);
    load_rows(Os, dO + base, q0, S, C, tid);
    load_cols(Ot, dO + base, q0, S, C, tid);
    if (tid < kT) {
      const bool ok = q0 + tid < S;
      s_lse[tid] = ok ? lse_bh[q0 + tid] : INFINITY;
      s_D[tid] = ok ? D_bh[q0 + tid] : 0.f;
    }
    __syncthreads();

    // P^T = exp2(K Q^T * scale_log2 - lse2[query]): 16 keys x 64 queries
    float p[8][4];
    mma_frag(p, kf, Qs, gr, tq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        p[nt][e] = exp2f(p[nt][e] * scale_log2 - s_lse[nt * 8 + 2 * tq + (e & 1)]);
    // dV += P^T dO
    mma_acc_pack(acc_v, p, Ot, gr, tq);
    // dP^T = V dO^T, then dS^T = P^T (dP^T - D[query])
    float ds[8][4];
    mma_frag(ds, vf, Os, gr, tq);
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e)
        ds[nt][e] = p[nt][e] * (ds[nt][e] - s_D[nt * 8 + 2 * tq + (e & 1)]);
    // dK += dS^T Q
    mma_acc_pack(acc_k, ds, Qt, gr, tq);
  }

  const int r0 = k0 + warp * 16 + gr, r1 = r0 + 8;
#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    if (r0 < S) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)r0 * C + col) =
          akt::pack_bf16x2(acc_k[nt][0] * scale, acc_k[nt][1] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)r0 * C + col) =
          akt::pack_bf16x2(acc_v[nt][0], acc_v[nt][1]);
    }
    if (r1 < S) {
      *reinterpret_cast<uint32_t*>(dk + base + (size_t)r1 * C + col) =
          akt::pack_bf16x2(acc_k[nt][2] * scale, acc_k[nt][3] * scale);
      *reinterpret_cast<uint32_t*>(dv + base + (size_t)r1 * C + col) =
          akt::pack_bf16x2(acc_v[nt][2], acc_v[nt][3]);
    }
  }
}

__global__ void __launch_bounds__(kThreads)
dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
          const bf16* __restrict__ v, const bf16* __restrict__ dO,
          const float* __restrict__ lse, const float* __restrict__ Dv,
          bf16* __restrict__ dq, int S, int C, float scale, float scale_log2) {
  __shared__ __align__(16) bf16 Ks[kT * kPad];   // [key][d]
  __shared__ __align__(16) bf16 Kt[kD * kPad];   // [d][key]
  __shared__ __align__(16) bf16 Vs[kT * kPad];   // [key][d]

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int gr = lane / 4, tq = lane % 4;
  const int q0 = blockIdx.x * kT, h = blockIdx.y, b = blockIdx.z;
  const int H = gridDim.y;
  const size_t base = (size_t)b * S * C + (size_t)h * kD;

  load_rows(Ks, q + base, q0, S, C, tid);
  load_rows(Vs, dO + base, q0, S, C, tid);
  __syncthreads();
  uint32_t qf[4][4], of[4][4];
  load_a(qf, Ks, warp * 16, gr, tq);
  load_a(of, Vs, warp * 16, gr, tq);
  const int r0 = q0 + warp * 16 + gr, r1 = r0 + 8;
  const float* lse_bh = lse + ((size_t)b * H + h) * S;
  const float* D_bh = Dv + ((size_t)b * H + h) * S;
  const float l0 = r0 < S ? lse_bh[r0] : INFINITY;
  const float l1 = r1 < S ? lse_bh[r1] : INFINITY;
  const float d0 = r0 < S ? D_bh[r0] : 0.f;
  const float d1 = r1 < S ? D_bh[r1] : 0.f;

  float acc[8][4];
#pragma unroll
  for (int i = 0; i < 8; ++i) acc[i][0] = acc[i][1] = acc[i][2] = acc[i][3] = 0.f;

  for (int k0 = 0; k0 < S; k0 += kT) {
    __syncthreads();
    load_rows(Ks, k + base, k0, S, C, tid);
    load_cols(Kt, k + base, k0, S, C, tid);
    load_rows(Vs, v + base, k0, S, C, tid);
    __syncthreads();

    float p[8][4], ds[8][4];
    mma_frag(p, qf, Ks, gr, tq);    // Q K^T: 16 queries x 64 keys
    mma_frag(ds, of, Vs, gr, tq);   // dO V^T
#pragma unroll
    for (int nt = 0; nt < 8; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int key = k0 + nt * 8 + 2 * tq + (e & 1);
        const bool lo = e < 2;
        const float pe = key < S
            ? exp2f(p[nt][e] * scale_log2 - (lo ? l0 : l1)) : 0.f;
        ds[nt][e] = pe * (ds[nt][e] - (lo ? d0 : d1));
      }
    mma_acc_pack(acc, ds, Kt, gr, tq);   // dQ += dS K
  }

#pragma unroll
  for (int nt = 0; nt < 8; ++nt) {
    const int col = nt * 8 + 2 * tq;
    if (r0 < S)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)r0 * C + col) =
          akt::pack_bf16x2(acc[nt][0] * scale, acc[nt][1] * scale);
    if (r1 < S)
      *reinterpret_cast<uint32_t*>(dq + base + (size_t)r1 * C + col) =
          akt::pack_bf16x2(acc[nt][2] * scale, acc[nt][3] * scale);
  }
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
  const size_t rows = (size_t)B * S * H;
  row_dot<<<(unsigned)((rows + 255) / 256), 256, 0, s>>>(
      (const bf16*)o, (const bf16*)dO, (float*)Dv, B, S, H);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dim3 grid((S + kT - 1) / kT, H, B);
  dkdv_kernel<<<grid, kThreads, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO,
      (const float*)lse, (const float*)Dv, (bf16*)dk, (bf16*)dv, S, C, scale,
      sl2);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  dq_kernel<<<grid, kThreads, 0, s>>>(
      (const bf16*)q, (const bf16*)k, (const bf16*)v, (const bf16*)dO,
      (const float*)lse, (const float*)Dv, (bf16*)dq, S, C, scale, sl2);
  return (int)cudaGetLastError();
}
