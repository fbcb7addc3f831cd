// Flash-attention backward for Hopper (sm_90a), plain C interface.
//
// Replaces three Pallas TPU kernels of tony_tpu/ops/attention.py:
//   K2  _bwd_fused_kernel (launched by _flash_backward_fused): one kv-major
//       pass giving dK, dV and dQ;
//   K3a _dq_kernel  (launched by _flash_backward): q-major pass giving dQ;
//   K3b _dkv_kernel (launched by _flash_backward): kv-major pass giving dK
//       and dV.
// Same math contract as the TPU kernels and as the forward (flash_fwd.cu):
// q, do [B, Sq, H, D], k, v [B, Sk, KV, D] (query head h reads kv head
// h / (H / KV)); causal rule qpos >= kpos, with a window also qpos - kpos
// < window; lse [B, H, Sq] f32 natural log from the forward; delta
// [B, H, Sq] f32 = rowsum(do * o) - dlse, computed by the caller. With
// p = exp(scale * q.k - lse) on attended pairs and 0 elsewhere:
//   dv = p^T do,  ds = p * (do.v - delta),  dk = scale * ds^T q,
//   dq = scale * ds k.
// dK and dV of a kv head sum over every query head of its group.
//
// Design. TPU grid steps run in order and carry dK/dV (or dQ) in VMEM
// scratch from one step to the next; Hopper blocks run in no order, so
// each block owns its output tile and loops over the tiles it needs:
//   - kv-major (K2, K3b): one block of 256 threads per (batch, kv head,
//     64-row kv tile). K and V of the tile stay in shared memory; the block
//     walks the query heads of the group and, for each, the 64-row q tiles
//     that can attend the tile (from the diagonal on, and with a window up
//     to the last q row inside it). dK and dV accumulate in f32 registers
//     and are written once.
//   - q-major (K3a): one block per (batch, head, 64-row q tile), walking
//     the kv tiles the tile can attend (as the forward does); dQ
//     accumulates in f32 registers and is written once. Deterministic.
//   - K2's dQ crosses blocks: each (q tile, kv tile) pair adds its f32
//     contribution with atomicAdd into a zeroed f32 [B, Sq, H, D] buffer
//     that the caller casts to q's dtype. Atomics make the summation order
//     change from run to run (f32 rounding only).
// Each thread owns a 4-row x 4-column patch of the 64 x 64 score tile (the
// forward's layout) and 4 rows x D/16 columns of each [64, D] accumulator.
// p and ds go through shared memory between the score step and the
// products that contract over the tile's rows. Ragged edges are masked:
// any Sq and Sk work, and a masked pair is 0 without evaluating exp.
// Inputs convert to f32 on the way into shared memory; every product is a
// full-f32 FMA (no TF32), whatever the input type.
//
// What bounds it on the card: like the forward, the products run on the
// FP32 pipes with about one shared-memory load per two FMAs, so the FP32
// instruction rate and shared-memory bandwidth bound it, far above the
// bf16 tensor-core bound of the same work. The register patches keep the
// load-to-FMA ratio at 1:2; wgmma with TMA-fed tiles is the next step.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr float LOG2E = 1.4426950408889634f;

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

// Stage a [64, D] tile of rows r0.. of a [*, row_stride] tensor into
// shared memory as f32 with row stride D + 1; rows at or past n are 0.
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int r0,
                                          int n, long row_stride) {
  for (int i = threadIdx.x; i < 64 * D; i += THREADS) {
    const int r = i / D, d = i - (i / D) * D;
    dst[r * (D + 1) + d] =
        (r0 + r < n) ? to_f32(src[(long)(r0 + r) * row_stride + d]) : 0.f;
  }
}

// The thread's 4 x 4 patches of the raw scores q.k and of do.v for a q
// tile (qs, dos) against a kv tile (ks, vs): rows rg*4+i, columns cg+16*j.
template <int D>
__device__ __forceinline__ void score_patches(const float* qs,
                                             const float* dos,
                                             const float* ks,
                                             const float* vs, int rg, int cg,
                                             float s[4][4], float dp[4][4]) {
  constexpr int LD = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      s[i][j] = 0.f;
      dp[i][j] = 0.f;
    }
#pragma unroll 4
  for (int d = 0; d < D; ++d) {
    float qv[4], ov[4], kv[4], vv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      qv[i] = qs[(rg * 4 + i) * LD + d];
      ov[i] = dos[(rg * 4 + i) * LD + d];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      kv[j] = ks[(cg + 16 * j) * LD + d];
      vv[j] = vs[(cg + 16 * j) * LD + d];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
        dp[i][j] = fmaf(ov[i], vv[j], dp[i][j]);
      }
  }
}

// Turn the patches into p (in s) and ds (in dp): p = exp(scale*s - lse) on
// attended pairs, 0 on masked or out-of-range ones; ds = p * (dp - delta).
// lse2 is the rows' lse in base 2 (lse * log2 e), delta the rows' delta.
__device__ __forceinline__ void p_and_ds(float s[4][4], float dp[4][4],
                                         const float lse2[4],
                                         const float delta[4], int q_first,
                                         int k_first, int Sq, int Sk,
                                         float scale2, int causal,
                                         int window) {
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q_first + i;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int kp = k_first + 16 * j;
      bool ok = qp < Sq && kp < Sk;
      if (causal) {
        ok = ok && kp <= qp;
        if (window > 0) ok = ok && (qp - kp < window);
      }
      const float p = ok ? exp2f(s[i][j] * scale2 - lse2[i]) : 0.f;
      s[i][j] = p;
      dp[i][j] = p * (dp[i][j] - delta[i]);
    }
  }
}

template <int D>
constexpr size_t kv_smem_bytes() {
  // k, v, q, do tiles [64][D + 1] plus the p and ds tiles [64][65], f32
  return sizeof(float) * (4 * 64 * (D + 1) + 2 * BQ * (BK + 1));
}

template <int D>
constexpr size_t dq_smem_bytes() {
  // q, do, k, v tiles [64][D + 1] plus the ds tile [64][65], f32
  return sizeof(float) * (4 * 64 * (D + 1) + BQ * (BK + 1));
}

// kv-major pass: K2 (WITH_DQ, dq_acc an f32 buffer it adds into) and K3b.
template <typename T, int D, bool WITH_DQ>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_kv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta,
                        float* __restrict__ dq_acc, T* __restrict__ dk,
                        T* __restrict__ dv, int Sq, int Sk, int H, int KV,
                        float scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* ks = smem;             // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* qs = vs + BK * LD;     // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* ps = dos + BQ * LD;    // [BQ][LDP]
  float* dss = ps + BQ * LDP;   // [BQ][LDP]

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int b = blockIdx.y / KV;
  const int kvh = blockIdx.y - b * KV;
  const int k0 = blockIdx.x * BK;
  const int rep = H / KV;
  const long q_row = (long)H * D;
  const long kv_row = (long)KV * D;
  const float scale2 = scale * LOG2E;

  load_tile<T, D>(ks, k + (long)b * Sk * kv_row + (long)kvh * D, k0, Sk,
                  kv_row);
  load_tile<T, D>(vs, v + (long)b * Sk * kv_row + (long)kvh * D, k0, Sk,
                  kv_row);

  float dk_acc[4][DJ], dv_acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk_acc[i][j] = 0.f;
      dv_acc[i][j] = 0.f;
    }

  // q tiles that can attend this kv tile: from the diagonal on and, with
  // a window, up to the last q row whose window reaches the tile's last
  // row (qpos - kpos < window for kpos <= k0 + BK - 1)
  int q_lo = 0, q_hi = Sq;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(Sq, k0 + BK - 1 + window);
  }
  q_lo = (q_lo / BQ) * BQ;

  for (int r = 0; r < rep; ++r) {
    const int h = kvh * rep + r;
    const long q_off = (long)b * Sq * q_row + (long)h * D;
    const float* lse_h = lse + ((long)b * H + h) * Sq;
    const float* delta_h = delta + ((long)b * H + h) * Sq;
    for (int q0 = q_lo; q0 < q_hi; q0 += BQ) {
      __syncthreads();  // the previous tile's readers are done
      load_tile<T, D>(qs, q + q_off, q0, Sq, q_row);
      load_tile<T, D>(dos, dout + q_off, q0, Sq, q_row);
      float lse2[4], dl[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int qp = q0 + rg * 4 + i;
        lse2[i] = qp < Sq ? lse_h[qp] * LOG2E : 0.f;
        dl[i] = qp < Sq ? delta_h[qp] : 0.f;
      }
      __syncthreads();

      float s[4][4], dp[4][4];
      score_patches<D>(qs, dos, ks, vs, rg, cg, s, dp);
      p_and_ds(s, dp, lse2, dl, q0 + rg * 4, k0 + cg, Sq, Sk, scale2, causal,
               window);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          ps[(rg * 4 + i) * LDP + cg + 16 * j] = s[i][j];
          dss[(rg * 4 + i) * LDP + cg + 16 * j] = dp[i][j];
        }
      __syncthreads();

      // dV += p^T do and dK += ds^T q over the q tile's rows; this
      // thread's kv rows are rg*4+i, its columns cg+16*j
#pragma unroll 4
      for (int qq = 0; qq < BQ; ++qq) {
        float pv[4], dsv[4], ov[DJ], qv[DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          pv[i] = ps[qq * LDP + rg * 4 + i];
          dsv[i] = dss[qq * LDP + rg * 4 + i];
        }
#pragma unroll
        for (int j = 0; j < DJ; ++j) {
          ov[j] = dos[qq * LD + cg + 16 * j];
          qv[j] = qs[qq * LD + cg + 16 * j];
        }
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) {
            dv_acc[i][j] = fmaf(pv[i], ov[j], dv_acc[i][j]);
            dk_acc[i][j] = fmaf(dsv[i], qv[j], dk_acc[i][j]);
          }
      }

      if (WITH_DQ) {
        // this tile pair's dQ contribution, ds k, added into the buffer;
        // this thread's q rows are rg*4+i, its columns cg+16*j
        float acc[4][DJ];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
#pragma unroll 4
        for (int kk = 0; kk < BK; ++kk) {
          float dsv[4], kv[DJ];
#pragma unroll
          for (int i = 0; i < 4; ++i) dsv[i] = dss[(rg * 4 + i) * LDP + kk];
#pragma unroll
          for (int j = 0; j < DJ; ++j) kv[j] = ks[kk * LD + cg + 16 * j];
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < DJ; ++j)
              acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int qp = q0 + rg * 4 + i;
          if (qp >= Sq) continue;
          float* row = dq_acc + ((long)b * Sq + qp) * q_row + (long)h * D;
#pragma unroll
          for (int j = 0; j < DJ; ++j)
            atomicAdd(row + cg + 16 * j, acc[i][j] * scale);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int kp = k0 + rg * 4 + i;
    if (kp >= Sk) continue;
    const long off = ((long)b * Sk + kp) * kv_row + (long)kvh * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) {
      dk[off + cg + 16 * j] = from_f32<T>(dk_acc[i][j] * scale);
      dv[off + cg + 16 * j] = from_f32<T>(dv_acc[i][j]);
    }
  }
}

// q-major pass: K3a.
template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
    flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const T* __restrict__ dout,
                        const float* __restrict__ lse,
                        const float* __restrict__ delta, T* __restrict__ dq,
                        int Sq, int Sk, int H, int KV, float scale,
                        int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int LDP = BK + 1;
  constexpr int DJ = D / 16;
  extern __shared__ float smem[];
  float* qs = smem;             // [BQ][LD]
  float* dos = qs + BQ * LD;    // [BQ][LD]
  float* ks = dos + BQ * LD;    // [BK][LD]
  float* vs = ks + BK * LD;     // [BK][LD]
  float* dss = vs + BK * LD;    // [BQ][LDP]

  const int tid = threadIdx.x;
  const int rg = tid >> 4;
  const int cg = tid & 15;
  const int bh = blockIdx.y;
  const int b = bh / H;
  const int h = bh - b * H;
  const int kvh = h / (H / KV);
  const int q0 = blockIdx.x * BQ;
  const long q_row = (long)H * D;
  const long kv_row = (long)KV * D;
  const long q_off = (long)b * Sq * q_row + (long)h * D;
  const T* kb = k + (long)b * Sk * kv_row + (long)kvh * D;
  const T* vb = v + (long)b * Sk * kv_row + (long)kvh * D;
  const float scale2 = scale * LOG2E;

  load_tile<T, D>(qs, q + q_off, q0, Sq, q_row);
  load_tile<T, D>(dos, dout + q_off, q0, Sq, q_row);
  float lse2[4], dl[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    lse2[i] = qp < Sq ? lse[(long)bh * Sq + qp] * LOG2E : 0.f;
    dl[i] = qp < Sq ? delta[(long)bh * Sq + qp] : 0.f;
  }

  float acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;

  // kv tiles that can hold an attended pair for this q tile
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + BQ);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;

  for (int k0 = k_lo; k0 < k_hi; k0 += BK) {
    __syncthreads();  // the previous tile's readers are done
    load_tile<T, D>(ks, kb, k0, Sk, kv_row);
    load_tile<T, D>(vs, vb, k0, Sk, kv_row);
    __syncthreads();

    float s[4][4], dp[4][4];
    score_patches<D>(qs, dos, ks, vs, rg, cg, s, dp);
    p_and_ds(s, dp, lse2, dl, q0 + rg * 4, k0 + cg, Sq, Sk, scale2, causal,
             window);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j)
        dss[(rg * 4 + i) * LDP + cg + 16 * j] = dp[i][j];
    __syncthreads();

#pragma unroll 4
    for (int kk = 0; kk < BK; ++kk) {
      float dsv[4], kv[DJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) dsv[i] = dss[(rg * 4 + i) * LDP + kk];
#pragma unroll
      for (int j = 0; j < DJ; ++j) kv[j] = ks[kk * LD + cg + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < DJ; ++j) acc[i][j] = fmaf(dsv[i], kv[j], acc[i][j]);
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int qp = q0 + rg * 4 + i;
    if (qp >= Sq) continue;
    T* row = dq + ((long)b * Sq + qp) * q_row + (long)h * D;
#pragma unroll
    for (int j = 0; j < DJ; ++j) row[cg + 16 * j] = from_f32<T>(acc[i][j] * scale);
  }
}

struct Args {
  const void *q, *k, *v, *dout, *lse, *delta;
  void *dq, *dk, *dv;  // dq: f32 accumulator for K2, dq in T for K3a
  int B, Sq, Sk, H, KV;
  float scale;
  int causal, window;
  cudaStream_t stream;
};

template <typename T, int D, bool WITH_DQ>
cudaError_t launch_kv(const Args& a) {
  constexpr size_t smem = kv_smem_bytes<D>();
  auto kernel = flash_bwd_kv_kernel<T, D, WITH_DQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sk + BK - 1) / BK, a.B * a.KV);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), static_cast<T*>(a.dk),
      static_cast<T*>(a.dv), a.Sq, a.Sk, a.H, a.KV, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_dq(const Args& a) {
  constexpr size_t smem = dq_smem_bytes<D>();
  auto kernel = flash_bwd_dq_kernel<T, D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid((a.Sq + BQ - 1) / BQ, a.B * a.H);
  kernel<<<grid, THREADS, smem, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k),
      static_cast<const T*>(a.v), static_cast<const T*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<T*>(a.dq), a.Sq, a.Sk, a.H, a.KV, a.scale, a.causal,
      a.window);
  return cudaGetLastError();
}

enum Pass { FUSED, DQ, DKV };

template <typename T, int D>
cudaError_t launch_pass(Pass pass, const Args& a) {
  if (pass == FUSED) return launch_kv<T, D, true>(a);
  if (pass == DKV) return launch_kv<T, D, false>(a);
  return launch_dq<T, D>(a);
}

int run(Pass pass, int dtype, int D, const Args& a) {
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.KV <= 0 || a.H % a.KV != 0 ||
      a.B * a.H > 65535)
    return (int)cudaErrorInvalidValue;
  if (dtype == 0 && D == 32) return (int)launch_pass<float, 32>(pass, a);
  if (dtype == 0 && D == 64) return (int)launch_pass<float, 64>(pass, a);
  if (dtype == 0 && D == 128) return (int)launch_pass<float, 128>(pass, a);
  if (dtype == 1 && D == 32)
    return (int)launch_pass<__nv_bfloat16, 32>(pass, a);
  if (dtype == 1 && D == 64)
    return (int)launch_pass<__nv_bfloat16, 64>(pass, a);
  if (dtype == 1 && D == 128)
    return (int)launch_pass<__nv_bfloat16, 128>(pass, a);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window. Each entry
// point returns a cudaError_t (0 on success); nothing is launched on a bad
// argument.

// K2: dq_acc is a zeroed f32 [B, Sq, H, D] buffer the kernel adds into;
// dk, dv [B, Sk, KV, D] in the input dtype are written in full.
extern "C" int tony_flash_bwd_fused(const void* q, const void* k,
                                    const void* v, const void* dout,
                                    const void* lse, const void* delta,
                                    void* dq_acc, void* dk, void* dv,
                                    int dtype, int B, int Sq, int Sk, int H,
                                    int KV, int D, float scale, int causal,
                                    int window, void* stream) {
  Args a{q, k, v, dout, lse, delta, dq_acc, dk, dv, B, Sq, Sk, H, KV,
         scale, causal, window, static_cast<cudaStream_t>(stream)};
  return run(FUSED, dtype, D, a);
}

// K3a: dq [B, Sq, H, D] in the input dtype, written in full.
extern "C" int tony_flash_bwd_dq(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq, int dtype,
                                 int B, int Sq, int Sk, int H, int KV, int D,
                                 float scale, int causal, int window,
                                 void* stream) {
  Args a{q, k, v, dout, lse, delta, dq, nullptr, nullptr, B, Sq, Sk, H, KV,
         scale, causal, window, static_cast<cudaStream_t>(stream)};
  return run(DQ, dtype, D, a);
}

// K3b: dk, dv [B, Sk, KV, D] in the input dtype, written in full.
extern "C" int tony_flash_bwd_dkv(const void* q, const void* k,
                                  const void* v, const void* dout,
                                  const void* lse, const void* delta,
                                  void* dk, void* dv, int dtype, int B,
                                  int Sq, int Sk, int H, int KV, int D,
                                  float scale, int causal, int window,
                                  void* stream) {
  Args a{q, k, v, dout, lse, delta, nullptr, dk, dv, B, Sq, Sk, H, KV,
         scale, causal, window, static_cast<cudaStream_t>(stream)};
  return run(DKV, dtype, D, a);
}
