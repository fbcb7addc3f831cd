// Fused AdamW update for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tony_tpu/ops/optim.py::_adamw_kernel
// (launched per leaf by _fused_leaf_update). Same math, per element, in
// f32, with the scalars [lr, b1, b2, eps, wd, 1/bc1, 1/bc2, clip] read
// from a device tensor (so the caller never reads the card for the clip
// scale):
//   g  = g * clip
//   m  = b1 * m + (1 - b1) * g
//   v  = b2 * v + ((1 - b2) * g) * g
//   u  = (m * 1/bc1) / (sqrt(v * 1/bc2) + eps) + wd * p
//   p  = p - lr * u          (rounded once to p's storage type)
// Moments are f32 whatever p's type. p, m and v are updated in place: the
// TPU kernel aliases them in->out under donation, and this kernel writes
// into the same tensors.
//
// Design: a grid-stride loop over the leaf, one element per thread per
// trip. Every operation is an explicitly rounded intrinsic (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn), so nvcc cannot contract a multiply
// and an add into one FMA: the result is bit for bit that of the plain
// PyTorch version, which rounds after every operation.
//
// What bounds it on the card: bytes. Each element reads p, g, m, v and
// writes p, m, v (22 bytes with bf16 p and g, 28 with f32), a handful of
// flops per element, far below the card's ratio of compute to bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 256;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(THREADS)
    adamw_kernel(T* __restrict__ p, const T* __restrict__ g,
                 float* __restrict__ m, float* __restrict__ v,
                 const float* __restrict__ sc, long n) {
  const float lr = sc[0], b1 = sc[1], b2 = sc[2], eps = sc[3];
  const float wd = sc[4], inv_bc1 = sc[5], inv_bc2 = sc[6], clip = sc[7];
  const float omb1 = __fsub_rn(1.f, b1), omb2 = __fsub_rn(1.f, b2);
  const long stride = (long)gridDim.x * THREADS;
  for (long i = (long)blockIdx.x * THREADS + threadIdx.x; i < n;
       i += stride) {
    const float pf = to_f32(p[i]);
    const float gf = __fmul_rn(to_f32(g[i]), clip);
    const float mf = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(omb1, gf));
    const float vf =
        __fadd_rn(__fmul_rn(b2, v[i]), __fmul_rn(__fmul_rn(omb2, gf), gf));
    const float denom = __fadd_rn(__fsqrt_rn(__fmul_rn(vf, inv_bc2)), eps);
    const float u = __fadd_rn(__fdiv_rn(__fmul_rn(mf, inv_bc1), denom),
                              __fmul_rn(wd, pf));
    p[i] = from_f32<T>(__fsub_rn(pf, __fmul_rn(lr, u)));
    m[i] = mf;
    v[i] = vf;
  }
}

template <typename T>
cudaError_t launch(void* p, const void* g, void* m, void* v,
                   const void* scalars, long n, cudaStream_t stream) {
  const long blocks_needed = (n + THREADS - 1) / THREADS;
  // enough blocks to fill every SM several times over; the loop strides
  const int blocks = (int)(blocks_needed < 132 * 16 ? blocks_needed
                                                    : 132 * 16);
  adamw_kernel<T><<<blocks, THREADS, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<float*>(m),
      static_cast<float*>(v), static_cast<const float*>(scalars), n);
  return cudaGetLastError();
}

}  // namespace

// dtype of p and g: 0 = float32, 1 = bfloat16; m, v and the 8 scalars are
// f32. All contiguous, n elements each. Returns a cudaError_t (0 on
// success); nothing is launched on a bad argument.
extern "C" int tony_adamw(void* p, const void* g, void* m, void* v,
                          const void* scalars, int dtype, long n,
                          void* stream) {
  if (n <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)launch<float>(p, g, m, v, scalars, n, s);
  if (dtype == 1)
    return (int)launch<__nv_bfloat16>(p, g, m, v, scalars, n, s);
  return (int)cudaErrorInvalidValue;
}
