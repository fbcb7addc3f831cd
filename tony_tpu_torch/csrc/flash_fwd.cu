// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tony_tpu/ops/attention.py::_fwd_kernel
// (launched by _flash_forward). Same math contract: q [B, Sq, H, D] and
// k, v [B, Sk, KV, D] (query head h reads kv head h / (H / KV)); causal
// rule qpos >= kpos, with a window also qpos - kpos < window; o in the
// input dtype, lse [B, H, Sq] in f32 natural log.
//
// Design: one thread block of 256 threads per (batch * head, 64-row q
// tile). The q tile is staged once in shared memory, pre-scaled by
// scale * log2(e) so the online softmax runs in base 2 (exp2f). The
// block then walks 64-row K/V tiles through shared memory, skipping
// tiles that hold no attended pair (above the diagonal, or older than
// the window), and keeps an f32 running max, sum and output accumulator
// in registers. Each thread owns a 4-row x 4-column patch of the score
// tile and the same 4 rows x D/16 columns of the output, so the row
// statistics never leave a 16-lane group (shuffles only). Ragged edges
// are masked, so any Sq and Sk work. Inputs are converted to f32 on the
// way into shared memory; f32 inputs are multiplied in full f32 (no
// TF32).
//
// What bounds it on the card: the products run on the FP32 pipes, not
// the tensor cores, and the inner loops issue one shared-memory load per
// two FMAs, so shared-memory bandwidth and FP32 issue bound it, far
// above the bf16 tensor-core bound. The register patches (4 x 4 scores,
// 4 x D/16 outputs) are what keep the load-to-FMA ratio at 1:2 instead of
// 1:1; wgmma and TMA staging are the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

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

// Reduce over the 16 lanes that share a row group (lanes differ in their
// low 4 bits).
__device__ __forceinline__ float group_max(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}
__device__ __forceinline__ float group_sum(float x) {
#pragma unroll
  for (int off = 8; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

template <int D>
constexpr size_t smem_bytes() {
  // q, k, v tiles [64][D + 1] plus the probability tile [64][65], f32
  return sizeof(float) * (3 * BQ * (D + 1) + BQ * (BK + 1));
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o,
                     float* __restrict__ lse, int Sq, int Sk, int H, int KV,
                     float scale, int causal, int window) {
  constexpr int LD = D + 1;   // padded row stride: rows land in distinct banks
  constexpr int LDP = BK + 1;
  constexpr int DJ = D / 16;  // output columns per thread
  extern __shared__ float smem[];
  float* qs = smem;            // [BQ][LD]
  float* ks = qs + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;    // [BK][LD]
  float* ps = vs + BK * LD;    // [BQ][LDP]

  const int tid = threadIdx.x;
  const int rg = tid >> 4;     // rows rg*4 .. rg*4+3 of the tile
  const int cg = tid & 15;     // score columns / output columns cg + 16*j
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;

  const long q_row = (long)H * D;    // elements between positions of q / o
  const long kv_row = (long)KV * D;  // ... of k / v
  const T* qb = q + (long)b * Sq * q_row + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_row + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_row + (long)kvh * D;

  const float qscale = scale * LOG2E;
  for (int i = tid; i < BQ * D; i += THREADS) {
    const int r = i / D, d = i - (i / D) * D;
    float x = 0.f;
    if (q0 + r < Sq) x = to_f32(qb[(long)(q0 + r) * q_row + d]) * qscale;
    qs[r * LD + d] = x;
  }

  float m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -INFINITY;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }

  // kv tiles that can hold an attended pair for this q tile
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    for (int i = tid; i < BK * D; i += THREADS) {
      const int r = i / D, d = i - (i / D) * D;
      float kx = 0.f, vx = 0.f;
      if (k0 + r < Sk) {
        kx = to_f32(kb[(long)(k0 + r) * kv_row + d]);
        vx = to_f32(vb[(long)(k0 + r) * kv_row + d]);
      }
      ks[r * LD + d] = kx;
      vs[r * LD + d] = vx;
    }
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = qs[(rg * 4 + i) * LD + d];
#pragma unroll
      for (int j = 0; j < 4; ++j) kv[j] = ks[(cg + 16 * j) * LD + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qp = q0 + rg * 4 + i;
      float mx = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int kp = k0 + cg + 16 * j;
        bool ok = kp < Sk;
        if (causal) {
          ok = ok && kp <= qp;
          if (window > 0) ok = ok && (qp - kp < window);
        }
        if (!ok) s[i][j] = -INFINITY;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = group_max(mx);
      const float m_new = fmaxf(m[i], mx);
      // a row with nothing attended so far keeps m = -inf; subtract 0
      // there so every exp2f sees -inf (-> 0), never inf - inf
      const float m_use = (m_new == -INFINITY) ? 0.f : m_new;
      const float alpha = exp2f(m[i] - m_use);
      float rs = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float p = exp2f(s[i][j] - m_use);
        rs += p;
        ps[(rg * 4 + i) * LDP + cg + 16 * j] = p;
      }
      rs = group_sum(rs);
      l[i] = l[i] * alpha + rs;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float pv[4], vv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = ps[(rg * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) vv[j] = vs[kk * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(pv[i], vv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    if (qp >= Sq) continue;
    const float inv = l[i] > 0.f ? 1.f / l[i] : 0.f;
    T* orow = o + ((long)b * Sq + qp) * q_row + (long)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) orow[cg + 16 * j] = from_f32<T>(acc[i][j] * inv);
    if (cg == 0)
      lse[((long)b * H + h) * Sq + qp] =
          l[i] > 0.f ? (m[i] + log2f(l[i])) * LN2 : -INFINITY;
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o,
                   void* lse, int B, int Sq, int Sk, int H, int KV,
                   float scale, int causal, int window, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((Sq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<T, D><<<grid, THREADS, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), static_cast<float*>(lse),
      Sq, Sk, H, KV, scale, causal, window);
  return cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns a cudaError_t (0 on success); nothing is launched on a bad
// argument.
extern "C" int tony_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int B, int Sq,
                              int Sk, int H, int KV, int D, float scale,
                              int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0 ||
      B * H > 65535)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 64)
    return (int)launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                  causal, window, s);
  if (dtype == 0 && D == 128)
    return (int)launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                   causal, window, s);
  if (dtype == 1 && D == 64)
    return (int)launch<__nv_bfloat16, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                          scale, causal, window, s);
  if (dtype == 1 && D == 128)
    return (int)launch<__nv_bfloat16, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                           scale, causal, window, s);
  return (int)cudaErrorInvalidValue;
}
