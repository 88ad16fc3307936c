// The SSM control block's gather path, its scatter back (models/ssm.py,
// SS2DCondV10 on the gather branch): at each active slot r of one branch,
//
//   y[tok[r], :] = round_T(y[tok[r], :] + ((s[r, :D] + s[r, D:2D]) - u[r, :]))
//
// with s the branch's two scan directions (K1's output rows, stride
// s_stride elements), u the slot's input projection (K1's input rows,
// stride u_stride) and y the block's (B * L, D) tokens, which already hold
// every branch's projection. The
// difference and the sum are fp32 (adds only, no contraction), rounded
// once to T on the store. An inactive slot writes nothing. The active
// slots of one launch name distinct tokens (a branch's slot assignment),
// so no two threads write one row and the result does not depend on the
// order of the threads; a token two branches select takes two launches.
//
// The JAX package has no such kernel: XLA scatters the scan's output over
// a copy of the branch's projections (actalker_tpu/models/ssm.py:509).
//
// What bounds it: bytes. Per active slot it reads 2 D of s, D of u and D
// of y and writes D of y, in 16-byte vectors, one vector per thread.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;

template <typename T>
__global__ void __launch_bounds__(kThreads)
gather_delta_add_kernel(T* __restrict__ y, const T* __restrict__ s,
                        const T* __restrict__ u,
                        const long long* __restrict__ tok,
                        const bool* __restrict__ act, long long total, int nv,
                        int D, long long s_stride, long long u_stride) {
  constexpr int V = akt::Vec<T>::N;
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += step) {
    const long long r = i / nv;
    if (!act[r]) continue;
    const int c = (int)(i - r * nv) * V;
    float s0[V], s1[V], uf[V], yf[V];
    const T* sp = s + r * s_stride + c;
    T* yp = y + tok[r] * D + c;
    akt::load_vec(sp, s0);
    akt::load_vec(sp + D, s1);
    akt::load_vec(u + r * u_stride + c, uf);
    akt::load_vec(yp, yf);
#pragma unroll
    for (int j = 0; j < V; ++j)
      yf[j] = __fadd_rn(yf[j], __fsub_rn(__fadd_rn(s0[j], s1[j]), uf[j]));
    akt::store_vec(yp, yf);
  }
}

template <typename T>
int launch(void* y, const void* s, const void* u, const void* tok,
           const void* act, int rows, int D, int s_stride, int u_stride,
           void* stream) {
  if (rows <= 0) return 0;
  const int nv = D / akt::Vec<T>::N;
  const long long total = (long long)rows * nv;
  const long long want = (total + kThreads - 1) / kThreads;
  const int blocks = (int)(want < 132 * 16 ? want : 132 * 16);
  gather_delta_add_kernel<T><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (T*)y, (const T*)s, (const T*)u, (const long long*)tok,
      (const bool*)act, total, nv, D, (long long)s_stride,
      (long long)u_stride);
  return (int)cudaGetLastError();
}

}  // namespace

// y (N, D) contiguous; s rows of 2 D at stride s_stride, u rows of D at
// stride u_stride; tok int64 (rows,), act bool (rows,); D and the strides
// multiples of the 16-byte vector, every pointer 16-byte aligned (checked
// by the wrapper).
#define GDA_ENTRY(NAME, T)                                                    \
  extern "C" int NAME(void* y, const void* s, const void* u, const void* tok, \
                      const void* act, int rows, int D, int s_stride,         \
                      int u_stride, void* stream) {                           \
    return launch<T>(y, s, u, tok, act, rows, D, s_stride, u_stride, stream); \
  }
GDA_ENTRY(gather_delta_add_bf16, __nv_bfloat16)
GDA_ENTRY(gather_delta_add_f32, float)
