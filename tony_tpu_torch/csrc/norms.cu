// RMSNorm (K5) and LayerNorm (K6) forwards for Hopper (sm_90a), plain C
// interface.
//
// Replace the Pallas TPU kernels tony_tpu/ops/norms.py::_rms_kernel (K5)
// and ::_ln_kernel (K6), which _row_call launches over x viewed as
// [rows, d]. Same math, per row, in f32 whatever the storage type:
//   RMSNorm:   y = (x * rsqrt(mean(x^2) + eps)) * w
//   LayerNorm: xc = x - mean(x);  y = ((xc * rsqrt(mean(xc^2) + eps)) * w) + b
// The LayerNorm variance is the two-pass one of the reference (centred
// values squared), not E[x^2] - mean^2. y rounds once, to x's type, at the
// store. w and b are [d] vectors in their own type (f32 or bf16), read as
// f32. The elementwise tail uses explicitly rounded intrinsics in the
// plain version's order, so only the row sums and rsqrt differ from it.
//
// Design: one warp owns a row; a block of 4 warps walks rows in a
// grid-stride loop. Where a row fits, it stays in registers between its
// passes (16-byte loads, up to 8 vectors a lane: d <= 2048 in bf16, 1024
// in f32), so device memory is read once and written once, and each
// lane's slice of w (and b) is loaded once for every row its warp walks.
// Any other d (not a multiple of the vector width, wider, or unaligned
// pointers) takes a scalar path that reads the row again for each pass;
// the rereads mostly hit L1/L2. The TPU kernel's 256-row blocks and its
// one-row fallback for odd row counts are VMEM choices and are not
// carried over: every row count takes the same kernel.
//
// What bounds it on the card: bytes. Each element is read once and written
// once (4 bytes in bf16, 8 in f32) for a handful of flops, far below the
// card's ratio of compute to bandwidth.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int WARPS = 4;               // rows in flight per block
constexpr int THREADS = WARPS * 32;
constexpr int MAX_NV = 8;              // 16-byte vectors a lane keeps
constexpr long MAX_BLOCKS = 132 * 16;  // the grid-stride loop covers the rest

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

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// 16 bytes of x's type as f32: 4 floats or 8 bf16
__device__ __forceinline__ void load_vec(const float* p, float* o) {
  const float4 v = *reinterpret_cast<const float4*>(p);
  o[0] = v.x;
  o[1] = v.y;
  o[2] = v.z;
  o[3] = v.w;
}
__device__ __forceinline__ void load_vec(const __nv_bfloat16* p, float* o) {
  const uint4 v = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    o[2 * i] = f.x;
    o[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void store_vec(float* p, const float* o) {
  *reinterpret_cast<float4*>(p) = make_float4(o[0], o[1], o[2], o[3]);
}
__device__ __forceinline__ void store_vec(__nv_bfloat16* p, const float* o) {
  uint4 v;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&v);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(o[2 * i], o[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = v;
}

// N (4 or 8) elements of a parameter vector from element e on, its type
// given at run time (1 = bf16, else f32); the pointer is 16-byte aligned
// and e a multiple of N
template <int N>
__device__ __forceinline__ void load_param(const void* p, int bf16, int e,
                                           float* o) {
  if (bf16) {
    const __nv_bfloat16* q = static_cast<const __nv_bfloat16*>(p) + e;
    if constexpr (N == 8) {
      load_vec(q, o);
    } else {
      const uint2 v = *reinterpret_cast<const uint2*>(q);
      const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&v);
      const float2 a = __bfloat1622float2(h[0]);
      const float2 b = __bfloat1622float2(h[1]);
      o[0] = a.x;
      o[1] = a.y;
      o[2] = b.x;
      o[3] = b.y;
    }
  } else {
    const float* q = static_cast<const float*>(p) + e;
#pragma unroll
    for (int i = 0; i < N / 4; ++i) load_vec(q + 4 * i, o + 4 * i);
  }
}

__device__ __forceinline__ float param_at(const void* p, int bf16, int i) {
  return bf16 ? __bfloat162float(static_cast<const __nv_bfloat16*>(p)[i])
              : static_cast<const float*>(p)[i];
}

// rows held in registers: NV vectors of 16 bytes per lane
template <typename T, int NV, bool LN>
__global__ void __launch_bounds__(THREADS)
    norm_vec_kernel(const T* __restrict__ x, const void* __restrict__ w,
                    const void* __restrict__ b, T* __restrict__ out,
                    int w_bf16, int b_bf16, long rows, int d, float eps) {
  constexpr int VEC = 16 / sizeof(T);
  const int lane = threadIdx.x & 31;
  const int nvec = d / VEC;
  const float fd = static_cast<float>(d);

  float wv[NV][VEC];
  float bv[LN ? NV : 1][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int v = lane + 32 * i;
    if (v < nvec) {
      load_param<VEC>(w, w_bf16, v * VEC, wv[i]);
      if constexpr (LN) load_param<VEC>(b, b_bf16, v * VEC, bv[i]);
    }
  }

  for (long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += (long)gridDim.x * WARPS) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float xv[NV][VEC];
    float s = 0.f;
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        load_vec(xr + v * VEC, xv[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          s += LN ? xv[i][j] : xv[i][j] * xv[i][j];
      }
    }
    s = warp_sum(s);
    float inv;
    if constexpr (LN) {
      const float mean = s / fd;
      float q = 0.f;
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        if (lane + 32 * i < nvec) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) {
            xv[i][j] = __fsub_rn(xv[i][j], mean);
            q += xv[i][j] * xv[i][j];
          }
        }
      }
      q = warp_sum(q);
      inv = rsqrtf(q / fd + eps);
    } else {
      inv = rsqrtf(s / fd + eps);
    }
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const int v = lane + 32 * i;
      if (v < nvec) {
        float o[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          o[j] = __fmul_rn(__fmul_rn(xv[i][j], inv), wv[i][j]);
          if constexpr (LN) o[j] = __fadd_rn(o[j], bv[i][j]);
        }
        store_vec(orow + v * VEC, o);
      }
    }
  }
}

// any d: one warp per row, the row read again for each pass
template <typename T, bool LN>
__global__ void __launch_bounds__(THREADS)
    norm_scalar_kernel(const T* __restrict__ x, const void* __restrict__ w,
                       const void* __restrict__ b, T* __restrict__ out,
                       int w_bf16, int b_bf16, long rows, int d, float eps) {
  const int lane = threadIdx.x & 31;
  const float fd = static_cast<float>(d);
  for (long row = (long)blockIdx.x * WARPS + (threadIdx.x >> 5); row < rows;
       row += (long)gridDim.x * WARPS) {
    const T* xr = x + row * d;
    T* orow = out + row * d;
    float s = 0.f;
    for (int j = lane; j < d; j += 32) {
      const float v = to_f32(xr[j]);
      s += LN ? v : v * v;
    }
    s = warp_sum(s);
    if constexpr (LN) {
      const float mean = s / fd;
      float q = 0.f;
      for (int j = lane; j < d; j += 32) {
        const float c = __fsub_rn(to_f32(xr[j]), mean);
        q += c * c;
      }
      q = warp_sum(q);
      const float inv = rsqrtf(q / fd + eps);
      for (int j = lane; j < d; j += 32) {
        const float c = __fsub_rn(to_f32(xr[j]), mean);
        const float y = __fmul_rn(__fmul_rn(c, inv), param_at(w, w_bf16, j));
        orow[j] = from_f32<T>(__fadd_rn(y, param_at(b, b_bf16, j)));
      }
    } else {
      const float inv = rsqrtf(s / fd + eps);
      for (int j = lane; j < d; j += 32)
        orow[j] = from_f32<T>(
            __fmul_rn(__fmul_rn(to_f32(xr[j]), inv), param_at(w, w_bf16, j)));
    }
  }
}

inline bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

template <typename T, bool LN>
cudaError_t launch(const void* x, const void* w, const void* b, void* out,
                   int w_bf16, int b_bf16, long rows, int d, float eps,
                   cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const long needed = (rows + WARPS - 1) / WARPS;
  const int blocks = (int)(needed < MAX_BLOCKS ? needed : MAX_BLOCKS);
  const T* xt = static_cast<const T*>(x);
  T* ot = static_cast<T*>(out);
  const int nv = (d / VEC + 31) / 32;
  const bool vec = d % VEC == 0 && nv <= MAX_NV && aligned16(x) &&
                   aligned16(out) && aligned16(w) && (!LN || aligned16(b));
  if (!vec) {
    norm_scalar_kernel<T, LN><<<blocks, THREADS, 0, stream>>>(
        xt, w, b, ot, w_bf16, b_bf16, rows, d, eps);
    return cudaGetLastError();
  }
#define TONY_NORM_CASE(N)                                          \
  case N:                                                          \
    norm_vec_kernel<T, N, LN><<<blocks, THREADS, 0, stream>>>(     \
        xt, w, b, ot, w_bf16, b_bf16, rows, d, eps);               \
    break;
  switch (nv) {
    TONY_NORM_CASE(1)
    TONY_NORM_CASE(2)
    TONY_NORM_CASE(3)
    TONY_NORM_CASE(4)
    TONY_NORM_CASE(5)
    TONY_NORM_CASE(6)
    TONY_NORM_CASE(7)
    TONY_NORM_CASE(8)
    default:
      return cudaErrorInvalidValue;
  }
#undef TONY_NORM_CASE
  return cudaGetLastError();
}

template <bool LN>
int dispatch(const void* x, const void* w, const void* b, void* out,
             int x_dtype, int w_dtype, int b_dtype, long rows, int d,
             float eps, void* stream) {
  if (rows <= 0 || d <= 0 || (w_dtype != 0 && w_dtype != 1) ||
      (b_dtype != 0 && b_dtype != 1))
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_dtype == 0)
    return (int)launch<float, LN>(x, w, b, out, w_dtype, b_dtype, rows, d,
                                  eps, s);
  if (x_dtype == 1)
    return (int)launch<__nv_bfloat16, LN>(x, w, b, out, w_dtype, b_dtype,
                                          rows, d, eps, s);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype codes: 0 = float32, 1 = bfloat16. x and out are contiguous
// [rows, d] of x's type, w (and b) contiguous [d] of their own types.
// Returns a cudaError_t (0 on success); nothing is launched on a bad
// argument.
extern "C" int tony_rms_norm(const void* x, const void* w, void* out,
                             int x_dtype, int w_dtype, long rows, int d,
                             float eps, void* stream) {
  return dispatch<false>(x, w, nullptr, out, x_dtype, w_dtype, 0, rows, d,
                         eps, stream);
}

extern "C" int tony_layer_norm(const void* x, const void* w, const void* b,
                               void* out, int x_dtype, int w_dtype,
                               int b_dtype, long rows, int d, float eps,
                               void* stream) {
  return dispatch<true>(x, w, b, out, x_dtype, w_dtype, b_dtype, rows, d,
                        eps, stream);
}
