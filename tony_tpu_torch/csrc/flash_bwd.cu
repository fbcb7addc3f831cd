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
//   - kv-major (K2, K3b): one block per (batch, kv head, kv tile: 64
//     rows, or 128 in the bf16 kernel at D <= 64). K and V of the tile
//     stay on chip; the block walks the query heads
//     of the group and, for each, the 64-row q tiles that can attend the
//     tile (from the diagonal on, and with a window up to the last q row
//     inside it). dK and dV accumulate in f32 registers and are written
//     once.
//   - q-major (K3a): one block per (batch * head, q tile), walking the
//     kv tiles the tile can attend (as the forward does); dQ accumulates
//     in f32 registers and is written once. No atomics: deterministic.
//   - K2's dQ crosses blocks: each (q tile, kv tile) pair adds its f32
//     contribution with atomics into a zeroed f32 [B, Sq, H, D] buffer
//     that the caller casts to q's dtype. Atomics make the summation order
//     change from run to run (f32 rounding only).
// Ragged edges are masked: any Sq and Sk work, and a masked pair is 0
// without evaluating exp.
//
// bf16 kv-major passes (K2, K3b): flash_bwd_kv_tc_kernel, the
// FlashAttention-2 backward on mma.sync (bf16 operands, f32
// accumulation). Each warp owns 16 rows of the kv tile: 8 warps and a
// 128-row tile at D <= 64, 4 warps and 64 rows at D = 128
// (tc_bwd_warps). K and V arrive once by cp.async into XOR-swizzled
// shared memory (tc_common.cuh). The Q, dO, lse and delta tiles of the
// next (head, 64-row q tile) pair stream through a 2-stage cp.async ring
// while the current pair computes, in passes of 16 q columns:
//   S^T = K Q^T (ldmatrix of K and Q), P^T = exp2(c S^T - lse2) in f32
//   with c = scale log2(e), masked only on diagonal, window and edge
//   tiles; dV += P^T dO, P^T rounded to bf16 straight from the C
//   fragments into A fragments and dO read by ldmatrix.trans;
//   dP^T = V dO^T; dS^T = P^T (dP^T - delta); dK += dS^T Q
//   (ldmatrix.trans of Q).
// A warp whose 16 kv rows hold no attended pair of the q tile (under
// the diagonal's far side, or older than the window) skips the products.
// K2 then writes dS^T once to shared memory in bf16 and each warp forms
// dQ = dS K for 16 q rows and its share of the columns (both operands by
// ldmatrix.trans), adding it to the f32 buffer with one 16-byte
// atomicAdd (float4) per 4 columns. P and dS round to bf16 before the
// products that consume them, as the reference does. dK (times scale)
// and dV leave through shared memory as 16-byte rows.
// What bounds it: 5 products of 2 D FLOP per attended pair on the bf16
// tensor cores (989 TFLOP/s dense). mma.sync reaches only part of that
// rate, and each warp's chain of ldmatrix, mma, exp2 and mma has little
// independent work, so the design holds registers to 128 a thread at
// D <= 64 to keep 16 warps per SM in flight; the dQ atomics, the
// ldmatrix traffic (every warp reads the whole Q and dO tiles, twice) and
// the softmax's exp2 (ex2.approx) are the next limits. Out of scope here:
// wgmma, TMA and warp specialisation (a later redesign), which would need
// P and dS staged in shared memory in the orientation each product reads.
//
// bf16 q-major pass (K3a): flash_bwd_dq_tc_kernel, the FlashAttention-2
// dQ pass on mma.sync; the skeleton of the forward's tensor-core kernel
// (flash_fwd.cu) without the online softmax, since lse is known. Warps
// of 16 q rows: 8 and a 128-row q tile capped at 128 registers at
// D <= 64, 4 at D = 128 (tc_dq_warps). Q and dO arrive once by cp.async
// into XOR-swizzled shared memory and their A fragments stay in
// registers; K/V tiles of 64 rows stream through a 2-stage cp.async
// ring, tiles above the diagonal or older than the window skipped, and
// under causal masking q tiles launch longest first. Per kv tile, in
// passes of 16 kv columns: S = Q K^T and dP = dO V^T (ldmatrix of K and
// V), P = exp2(c S - lse2) with c = scale log2(e), masked only on diagonal,
// window and edge tiles; dS = P (dP - delta), rounded to bf16 straight
// from its C fragments into A fragments (tc::c_to_a) as the reference
// rounds ds; dQ += dS K (ldmatrix.trans of K). A warp whose 16 rows
// attend nothing of a tile skips it. dQ (times scale) leaves through
// shared memory as 16-byte rows.
// What bounds it: 3 products of 2 D FLOP per attended pair on the bf16
// tensor cores. As in the forward, each warp re-reads the whole K and V
// tiles from shared memory (K twice: as B of S and, transposed, of dQ),
// about 250 bytes of ldmatrix per mma, and its chain of ldmatrix, mma,
// exp2 and mma has little independent work, so the design keeps 16 warps
// per SM in flight at D <= 64 (A/B runs on the card chose 8 warps, the
// 128-register cap and 16-column passes over 4 warps, uncapped or
// capped, and over passes of 32 columns). No atomics, and a fixed order
// of sums: dQ is bitwise the same from run to run.
//
// f32 (every pass): FP32-pipe kernels of 256 threads. Each
// thread owns a 4-row x 4-column patch of the 64 x 64 score tile (the
// forward's layout) and 4 rows x D/16 columns of each [64, D]
// accumulator. p and ds go through shared memory between the score step
// and the products that contract over the tile's rows. Inputs convert to
// f32 on the way into shared memory; every product is a full-f32 FMA (no
// TF32). Bound by the FP32 instruction rate and shared-memory bandwidth
// (one shared-memory load per two FMAs).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tc_common.cuh"

namespace {

constexpr int BQ = 64;        // q rows per tile
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr float LOG2E = 1.4426950408889634f;

// the FP32-pipe kernels' element conversions (they run in f32 only)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kv-major kernel (K2 with WITH_DQ, K3b without)
// ---------------------------------------------------------------------------

constexpr int TC_NC = 16;  // q columns of S^T (and dP^T) per pass

// Warps of a block, each owning 16 rows of the kv tile (so the tile has
// 16 NW rows). At D <= 64, 8 warps held to 128 registers a thread (two
// blocks, 16 warps, per SM): the 128-row kv tile halves the dQ atomics
// and the Q/dO tile loads per kv row, and the register cap doubles the
// warps an SM keeps in flight, which hides the latency of each warp's
// chain of ldmatrix, mma and exp2; K's and V's A fragments are read
// from shared memory each pass rather than held, to stay under the cap.
// At D = 128 the dK and dV accumulators alone take 128 registers a
// thread: 4 warps, one block per SM.
template <int D>
__host__ __device__ constexpr int tc_bwd_warps() {
  return D <= 64 ? 8 : 4;
}

template <int D>
constexpr size_t tc_kv_smem_bytes() {
  // K and V tiles [16 NW][D], two stages of the Q and dO tiles [64][D]
  // (bf16), the dS^T tile [16 NW][64] (bf16), two stages of lse and delta
  // [64] (f32)
  constexpr int BKT = 16 * tc_bwd_warps<D>();
  return sizeof(__nv_bfloat16) * (2 * BKT * D + 4 * 64 * D + BKT * 64) +
         sizeof(float) * 4 * 64;
}

template <int D, bool WITH_DQ>
__global__ void __launch_bounds__(32 * tc_bwd_warps<D>(), D <= 64 ? 2 : 1)
    flash_bwd_kv_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           float* __restrict__ dq_acc,
                           __nv_bfloat16* __restrict__ dk,
                           __nv_bfloat16* __restrict__ dv, int Sq, int Sk,
                           int H, int KV, float scale, int causal,
                           int window) {
  using tc::bf16;
  constexpr int NW = tc_bwd_warps<D>();
  constexpr int NTH = 32 * NW;  // threads
  constexpr int BKT = 16 * NW;  // kv rows of the block
  constexpr int KT = D / 16;    // k16 steps over the head dim
  constexpr int NT = D / 8;     // n8 tiles of dK, dV
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* ks = reinterpret_cast<bf16*>(smem_raw);  // [BKT][D]
  bf16* vs = ks + BKT * D;                        // [BKT][D]
  bf16* qs = vs + BKT * D;                        // [2][64][D]
  bf16* dos = qs + 2 * 64 * D;                    // [2][64][D]
  bf16* dst = dos + 2 * 64 * D;                   // [BKT kv][64 q]
  float* lse_s = reinterpret_cast<float*>(dst + BKT * 64);  // [2][64]
  float* del_s = lse_s + 2 * 64;                            // [2][64]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int b = blockIdx.x / KV, kvh = blockIdx.x - (blockIdx.x / KV) * KV;
  const int k0 = blockIdx.y * BKT;
  const int rep = H / KV;
  const long q_row = (long)H * D, kv_row = (long)KV * D;
  const long kv_off = (long)b * Sk * kv_row + (long)kvh * D;
  const float c = scale * LOG2E;

  // q tiles that can attend this kv tile: from the diagonal on and, with
  // a window, up to the last q row whose window reaches the tile
  int q_lo = 0, q_hi = Sq;
  if (causal) {
    q_lo = k0;
    if (window > 0) q_hi = min(Sq, k0 + BKT - 1 + window);
  }
  q_lo = (q_lo / BQ) * BQ;
  const int n_qt = q_hi > q_lo ? (q_hi - q_lo + BQ - 1) / BQ : 0;
  const int n_it = rep * n_qt;  // (query head, q tile) pairs, head-major

  // the Q, dO, lse and delta tiles of pair i into stage st
  auto issue = [&](int i, int st) {
    const int h = kvh * rep + i / n_qt;
    const int q0 = q_lo + (i % n_qt) * BQ;
    const long q_off = (long)b * Sq * q_row + (long)h * D;
    tc::load_tile_async<D, 64, NTH>(qs + st * 64 * D, q + q_off, q0, Sq,
                                    q_row);
    tc::load_tile_async<D, 64, NTH>(dos + st * 64 * D, dout + q_off, q0, Sq,
                                    q_row);
    if (threadIdx.x < 128) {
      const int r = threadIdx.x & 63;
      const bool ok = q0 + r < Sq;
      const long row = ((long)b * H + h) * Sq + (ok ? q0 + r : 0);
      if (threadIdx.x < 64)
        tc::cp_async4(lse_s + st * 64 + r, lse + row, ok);
      else
        tc::cp_async4(del_s + st * 64 + r, delta + row, ok);
    }
  };

  tc::load_tile_async<D, BKT, NTH>(ks, k + kv_off, k0, Sk, kv_row);
  tc::load_tile_async<D, BKT, NTH>(vs, v + kv_off, k0, Sk, kv_row);
  if (n_it > 0) issue(0, 0);
  tc::cp_async_commit();

  const int m0 = warp * 16;  // this warp's kv rows of the tile
  const int kr0 = k0 + m0 + g, kr1 = kr0 + 8;
  float dk_acc[NT][4], dv_acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      dk_acc[j][e] = 0.f;
      dv_acc[j][e] = 0.f;
    }

  for (int it = 0; it < n_it; ++it) {
    const int h = kvh * rep + it / n_qt;
    const int q0 = q_lo + (it % n_qt) * BQ;
    const int st = it & 1;
    __syncthreads();  // every warp is done with stage st ^ 1 and dS^T
    if (it + 1 < n_it) {
      issue(it + 1, st ^ 1);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* qt = qs + st * 64 * D;
    const bf16* dot = dos + st * 64 * D;
    const float* lse_t = lse_s + st * 64;
    const float* del_t = del_s + st * 64;
    const bool masked =
        (q0 + BQ > Sq) || (k0 + BKT > Sk) ||
        (causal && (q0 < k0 + BKT - 1 ||
                    (window > 0 && q0 + BQ - 1 - k0 >= window)));
    // this warp's 16 kv rows hold no attended pair of the q tile (all
    // after its last row, or older than its first row's window): P and
    // dS are 0, so only the zeros of dS^T are written
    const bool idle =
        causal && (k0 + m0 > q0 + BQ - 1 ||
                   (window > 0 && q0 - (k0 + m0 + 15) >= window));

#pragma unroll
    for (int cq = 0; cq < BQ / TC_NC; ++cq) {
      const int c0 = cq * TC_NC;  // first q column of this pass
      float sT[TC_NC / 8][4], dpT[TC_NC / 8][4];
#pragma unroll
      for (int j = 0; j < TC_NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          sT[j][e] = 0.f;
          dpT[j][e] = 0.f;
        }
      if (!idle) {
        // S^T = K Q^T: this warp's 16 kv rows x TC_NC q columns
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t a[4];
          tc::ldsm_a<D>(a, ks, m0, kk * 16);
#pragma unroll
          for (int np = 0; np < TC_NC / 16; ++np) {
            uint32_t bf[4];
            tc::ldsm_b<D>(bf, qt, c0 + np * 16, kk * 16);
            tc::mma(sT[2 * np], a, bf[0], bf[1]);
            tc::mma(sT[2 * np + 1], a, bf[2], bf[3]);
          }
        }
        // P^T = exp2(c S^T - lse2); 0 where a pair is masked. A thread's
        // two columns of an n8 tile share one 8-byte load of lse
#pragma unroll
        for (int j = 0; j < TC_NC / 8; ++j) {
          const float2 lj = *reinterpret_cast<const float2*>(
              lse_t + c0 + j * 8 + 2 * t);
          const float lse2[2] = {lj.x * LOG2E, lj.y * LOG2E};
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            bool ok = true;
            if (masked) {
              const int qp = q0 + c0 + j * 8 + 2 * t + (e & 1);
              const int kp = e < 2 ? kr0 : kr1;
              ok = qp < Sq && kp < Sk;
              if (causal) {
                ok = ok && kp <= qp;
                if (window > 0) ok = ok && (qp - kp < window);
              }
            }
            sT[j][e] =
                ok ? tc::fast_exp2(fmaf(sT[j][e], c, -lse2[e & 1])) : 0.f;
          }
        }
        // dV += P^T dO: P^T's C fragments are the A fragments
#pragma unroll
        for (int kk = 0; kk < TC_NC / 16; ++kk) {
          uint32_t pa[4];
          tc::c_to_a(pa, sT[2 * kk], sT[2 * kk + 1]);
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bf[4];
            tc::ldsm_b_t<D>(bf, dot, np * 16, c0 + kk * 16);
            tc::mma(dv_acc[2 * np], pa, bf[0], bf[1]);
            tc::mma(dv_acc[2 * np + 1], pa, bf[2], bf[3]);
          }
        }
        // dP^T = V dO^T
#pragma unroll
        for (int kk = 0; kk < KT; ++kk) {
          uint32_t a[4];
          tc::ldsm_a<D>(a, vs, m0, kk * 16);
#pragma unroll
          for (int np = 0; np < TC_NC / 16; ++np) {
            uint32_t bf[4];
            tc::ldsm_b<D>(bf, dot, c0 + np * 16, kk * 16);
            tc::mma(dpT[2 * np], a, bf[0], bf[1]);
            tc::mma(dpT[2 * np + 1], a, bf[2], bf[3]);
          }
        }
        // dS^T = P^T (dP^T - delta)
#pragma unroll
        for (int j = 0; j < TC_NC / 8; ++j) {
          const float2 dj = *reinterpret_cast<const float2*>(
              del_t + c0 + j * 8 + 2 * t);
#pragma unroll
          for (int e = 0; e < 4; ++e)
            dpT[j][e] = sT[j][e] * (dpT[j][e] - ((e & 1) ? dj.y : dj.x));
        }
      }
      // dK += dS^T Q, and dS^T to shared memory (bf16) for dQ
#pragma unroll
      for (int kk = 0; kk < TC_NC / 16; ++kk) {
        uint32_t da[4];
        tc::c_to_a(da, dpT[2 * kk], dpT[2 * kk + 1]);
        if (!idle) {
#pragma unroll
          for (int np = 0; np < NT / 2; ++np) {
            uint32_t bf[4];
            tc::ldsm_b_t<D>(bf, qt, np * 16, c0 + kk * 16);
            tc::mma(dk_acc[2 * np], da, bf[0], bf[1]);
            tc::mma(dk_acc[2 * np + 1], da, bf[2], bf[3]);
          }
        }
        if (WITH_DQ) {
          // da[0..3]: rows g, g + 8 of columns c0 + 16 kk + 2t (first n8
          // tile) and + 8 (second)
          const int col = c0 + kk * 16;
          *reinterpret_cast<uint32_t*>(
              dst + tc::swz<64>(m0 + g, col) + 2 * t) = da[0];
          *reinterpret_cast<uint32_t*>(
              dst + tc::swz<64>(m0 + g + 8, col) + 2 * t) = da[1];
          *reinterpret_cast<uint32_t*>(
              dst + tc::swz<64>(m0 + g, col + 8) + 2 * t) = da[2];
          *reinterpret_cast<uint32_t*>(
              dst + tc::swz<64>(m0 + g + 8, col + 8) + 2 * t) = da[3];
        }
      }
    }

    if (WITH_DQ) {
      __syncthreads();  // the whole dS^T tile is in shared memory
      // dQ = scale dS K over the block's BKT kv rows: warp w takes q rows
      // 16 (w % 4) .. and a 1 / (NW / 4) share of the columns, in passes
      // of at most 64; A = dS from dS^T (ldmatrix.trans), B = K
      // (ldmatrix.trans); added to the f32 buffer with 16-byte atomics
      constexpr int DW = D / (NW / 4);   // columns of this warp
      constexpr int DC = DW < 64 ? DW : 64;
      const int mq = 16 * (warp & 3);
      const int dw0 = (warp >> 2) * DW;
      const int qr0 = q0 + mq + g, qr1 = qr0 + 8;
      float* dq_h = dq_acc + ((long)b * Sq) * q_row + (long)h * D;
#pragma unroll
      for (int d0 = dw0; d0 < dw0 + DW; d0 += DC) {
        float acc[DC / 8][4];
#pragma unroll
        for (int j = 0; j < DC / 8; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < BKT / 16; ++kk) {
          uint32_t a[4];
          tc::ldsm_a_t<64>(a, dst, mq, kk * 16);
#pragma unroll
          for (int np = 0; np < DC / 16; ++np) {
            uint32_t bf[4];
            tc::ldsm_b_t<D>(bf, ks, d0 + np * 16, kk * 16);
            tc::mma(acc[2 * np], a, bf[0], bf[1]);
            tc::mma(acc[2 * np + 1], a, bf[2], bf[3]);
          }
        }
        // lanes t and t ^ 1 swap halves so each holds 4 adjacent columns
        // of one row: even t row g, odd t row g + 8
        const bool even = (t & 1) == 0;
        const int qr = even ? qr0 : qr1;
#pragma unroll
        for (int j = 0; j < DC / 8; ++j) {
          const float s0 = even ? acc[j][2] : acc[j][0];
          const float s1 = even ? acc[j][3] : acc[j][1];
          const float r0 = __shfl_xor_sync(0xffffffffu, s0, 1);
          const float r1 = __shfl_xor_sync(0xffffffffu, s1, 1);
          const float4 val =
              even ? make_float4(acc[j][0] * scale, acc[j][1] * scale,
                                 r0 * scale, r1 * scale)
                   : make_float4(r0 * scale, r1 * scale, acc[j][2] * scale,
                                 acc[j][3] * scale);
          const int col = d0 + j * 8 + 2 * (t & ~1);
          if (qr < Sq)
            atomicAdd(reinterpret_cast<float4*>(dq_h + (long)qr * q_row +
                                                col),
                      val);
        }
      }
    }
  }
  tc::cp_async_wait<0>();  // the K/V copies, when no q tile ran

  // dK (times scale) and dV leave through the K and V tiles' shared memory
  // as 16-byte rows; each warp stages and stores its own 16 rows
  __syncthreads();
  tc::store_c_tile<D>(ks, m0, dk_acc, scale, scale);
  tc::store_c_tile<D>(vs, m0, dv_acc, 1.f, 1.f);
  __syncwarp();
  tc::store_rows<D>(dk + kv_off, ks, m0, k0, Sk, kv_row);
  tc::store_rows<D>(dv + kv_off, vs, m0, k0, Sk, kv_row);
}

template <int D, bool WITH_DQ>
cudaError_t launch_kv_tc(const Args& a) {
  constexpr size_t smem = tc_kv_smem_bytes<D>();
  constexpr int NW = tc_bwd_warps<D>();
  auto kernel = flash_bwd_kv_tc_kernel<D, WITH_DQ>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  // (batch x kv head, kv tile): every block of kv tile 0, the longest
  // under causal masking, is issued first
  dim3 grid(a.B * a.KV, (a.Sk + 16 * NW - 1) / (16 * NW));
  kernel<<<grid, 32 * NW, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<float*>(a.dq), static_cast<__nv_bfloat16*>(a.dk),
      static_cast<__nv_bfloat16*>(a.dv), a.Sq, a.Sk, a.H, a.KV, a.scale,
      a.causal, a.window);
  return cudaGetLastError();
}

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

// ---------------------------------------------------------------------------
// bf16: the tensor-core q-major kernel (K3a)
// ---------------------------------------------------------------------------

// Warps of a K3a block, each owning 16 rows of the q tile (so the tile has
// 16 NW rows). At D <= 64, 8 warps held to 128 registers a thread (two
// blocks, 16 warps, per SM): the 128-row q tile halves the K/V tile
// loads per q row, and the cap doubles the warps an SM keeps in flight
// to hide each warp's ldmatrix -> mma -> exp2 -> mma chain. At D = 128
// the Q and dO fragments and the dQ accumulator alone take 128
// registers a thread: 4 warps.
template <int D>
__host__ __device__ constexpr int tc_dq_warps() {
  return D <= 64 ? 8 : 4;
}

constexpr int TC_DQ_NC = 16;  // kv columns of S and dP per pass

template <int D>
constexpr size_t tc_dq_smem_bytes() {
  // the Q and dO tiles [16 NW][D] and two stages of the K and V tiles
  // [64][D], bf16
  return sizeof(__nv_bfloat16) * (2 * 16 * tc_dq_warps<D>() + 4 * BK) * D;
}

template <int D>
__global__ void __launch_bounds__(32 * tc_dq_warps<D>(), D <= 64 ? 2 : 1)
    flash_bwd_dq_tc_kernel(const __nv_bfloat16* __restrict__ q,
                           const __nv_bfloat16* __restrict__ k,
                           const __nv_bfloat16* __restrict__ v,
                           const __nv_bfloat16* __restrict__ dout,
                           const float* __restrict__ lse,
                           const float* __restrict__ delta,
                           __nv_bfloat16* __restrict__ dq, int Sq, int Sk,
                           int H, int KV, float scale, int causal,
                           int window) {
  using tc::bf16;
  constexpr int NW = tc_dq_warps<D>();
  constexpr int NTH = 32 * NW;       // threads
  constexpr int BQT = 16 * NW;       // q rows of the block
  constexpr int KT = D / 16;         // k16 steps over the head dim
  constexpr int NT = D / 8;          // n8 tiles of dQ
  constexpr int NC = TC_DQ_NC;       // kv columns per pass
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQT][D]
  bf16* dos = qs + BQT * D;                       // [BQT][D]
  bf16* ks = dos + BQT * D;                       // [2][BK][D]
  bf16* vs = ks + 2 * BK * D;                     // [2][BK][D]

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t = lane & 3;
  const int bh = blockIdx.x;
  const int b = bh / H, h = bh - (bh / H) * H;
  const int kvh = h / (H / KV);
  // longest first under causal masking: the last q tile attends most
  const int qt =
      causal ? (int)(gridDim.y - 1 - blockIdx.y) : (int)blockIdx.y;
  const int q0 = qt * BQT;

  const long q_row = (long)H * D, kv_row = (long)KV * D;
  const long q_off = (long)b * Sq * q_row + (long)h * D;
  const bf16* kb = k + (long)b * Sk * kv_row + (long)kvh * D;
  const bf16* vb = v + (long)b * Sk * kv_row + (long)kvh * D;

  // kv tiles that can hold an attended pair for this q tile
  int k_lo = 0, k_hi = Sk;
  if (causal) {
    k_hi = min(Sk, q0 + BQT);
    if (window > 0) k_lo = max(0, q0 - window + 1);
  }
  k_lo = (k_lo / BK) * BK;
  const int n_tiles = k_hi > k_lo ? (k_hi - k_lo + BK - 1) / BK : 0;

  tc::load_tile_async<D, BQT, NTH>(qs, q + q_off, q0, Sq, q_row);
  tc::load_tile_async<D, BQT, NTH>(dos, dout + q_off, q0, Sq, q_row);
  if (n_tiles > 0) {
    tc::load_tile_async<D, BK, NTH>(ks, kb, k_lo, Sk, kv_row);
    tc::load_tile_async<D, BK, NTH>(vs, vb, k_lo, Sk, kv_row);
  }
  tc::cp_async_commit();

  const float c = scale * LOG2E;
  const int m0 = warp * 16;  // this warp's rows of the q tile
  const int qr0 = q0 + m0 + g, qr1 = qr0 + 8;
  // rows g and g + 8: base-2 lse and delta. A row past Sq reads 0s; its
  // dO is 0, so its dS is 0 and its dQ is never stored.
  const float* lse_h = lse + (long)bh * Sq;
  const float* del_h = delta + (long)bh * Sq;
  const float lse2[2] = {qr0 < Sq ? lse_h[qr0] * LOG2E : 0.f,
                         qr1 < Sq ? lse_h[qr1] * LOG2E : 0.f};
  const float dl[2] = {qr0 < Sq ? del_h[qr0] : 0.f,
                       qr1 < Sq ? del_h[qr1] : 0.f};

  float acc[NT][4];
#pragma unroll
  for (int j = 0; j < NT; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[j][e] = 0.f;
  uint32_t qf[KT][4], df[KT][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * BK;
    const int st = it & 1;
    __syncthreads();  // every warp is done with stage st ^ 1
    if (it + 1 < n_tiles) {
      tc::load_tile_async<D, BK, NTH>(ks + (st ^ 1) * BK * D, kb, k0 + BK,
                                      Sk, kv_row);
      tc::load_tile_async<D, BK, NTH>(vs + (st ^ 1) * BK * D, vb, k0 + BK,
                                      Sk, kv_row);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * BK * D;
    const bf16* vt = vs + st * BK * D;
    if (it == 0) {
      // the Q and dO A fragments of this warp's rows, held for every tile
#pragma unroll
      for (int kk = 0; kk < KT; ++kk) {
        tc::ldsm_a<D>(qf[kk], qs, m0, kk * 16);
        tc::ldsm_a<D>(df[kk], dos, m0, kk * 16);
      }
    }
    // this warp's 16 rows attend nothing of the tile (all before its
    // first row, or older than its last row's window): nothing to add
    if (causal && (k0 > q0 + m0 + 15 ||
                   (window > 0 && q0 + m0 - (k0 + BK - 1) >= window)))
      continue;
    // masked only where a pair of the tile can fall outside
    const bool masked =
        (k0 + BK > Sk) ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQT - 1 - k0 >= window)));

#pragma unroll
    for (int c0 = 0; c0 < BK; c0 += NC) {
      // S = Q K^T and dP = dO V^T over the pass's NC kv columns
      float s[NC / 8][4], dp[NC / 8][4];
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[j][e] = 0.f;
          dp[j][e] = 0.f;
        }
#pragma unroll
      for (int kk = 0; kk < KT; ++kk)
#pragma unroll
        for (int np = 0; np < NC / 16; ++np) {
          uint32_t bk4[4], bv4[4];
          tc::ldsm_b<D>(bk4, kt, c0 + np * 16, kk * 16);
          tc::ldsm_b<D>(bv4, vt, c0 + np * 16, kk * 16);
          tc::mma(s[2 * np], qf[kk], bk4[0], bk4[1]);
          tc::mma(s[2 * np + 1], qf[kk], bk4[2], bk4[3]);
          tc::mma(dp[2 * np], df[kk], bv4[0], bv4[1]);
          tc::mma(dp[2 * np + 1], df[kk], bv4[2], bv4[3]);
        }
      // P = exp2(c S - lse2), 0 where a pair is masked; dS = P (dP - delta)
#pragma unroll
      for (int j = 0; j < NC / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = e >> 1;
          bool ok = true;
          if (masked) {
            const int kp = k0 + c0 + j * 8 + 2 * t + (e & 1);
            const int qp = r ? qr1 : qr0;
            ok = kp < Sk;
            if (causal) {
              ok = ok && kp <= qp;
              if (window > 0) ok = ok && (qp - kp < window);
            }
          }
          const float p =
              ok ? tc::fast_exp2(fmaf(s[j][e], c, -lse2[r])) : 0.f;
          dp[j][e] = p * (dp[j][e] - dl[r]);
        }
      // dQ += dS K: dS rounds to bf16 straight from its C fragments into
      // A fragments; K as [kv][d] is read by ldmatrix.trans
#pragma unroll
      for (int kk = 0; kk < NC / 16; ++kk) {
        uint32_t da[4];
        tc::c_to_a(da, dp[2 * kk], dp[2 * kk + 1]);
#pragma unroll
        for (int np = 0; np < NT / 2; ++np) {
          uint32_t bf[4];
          tc::ldsm_b_t<D>(bf, kt, np * 16, c0 + kk * 16);
          tc::mma(acc[2 * np], da, bf[0], bf[1]);
          tc::mma(acc[2 * np + 1], da, bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();
  // every copy into the Q tile has landed (when no kv tile ran); then
  // dQ (times scale) leaves through this warp's own rows of it, which no
  // other warp reads, as 16-byte rows
  __syncthreads();
  tc::store_c_tile<D>(qs, m0, acc, scale, scale);
  __syncwarp();
  tc::store_rows<D>(dq + q_off, qs, m0, q0, Sq, q_row);
}

template <int D>
cudaError_t launch_dq_tc(const Args& a) {
  constexpr size_t smem = tc_dq_smem_bytes<D>();
  constexpr int NW = tc_dq_warps<D>();
  auto kernel = flash_bwd_dq_tc_kernel<D>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(a.B * a.H, (a.Sq + 16 * NW - 1) / (16 * NW));
  kernel<<<grid, 32 * NW, smem, a.stream>>>(
      static_cast<const __nv_bfloat16*>(a.q),
      static_cast<const __nv_bfloat16*>(a.k),
      static_cast<const __nv_bfloat16*>(a.v),
      static_cast<const __nv_bfloat16*>(a.dout),
      static_cast<const float*>(a.lse), static_cast<const float*>(a.delta),
      static_cast<__nv_bfloat16*>(a.dq), a.Sq, a.Sk, a.H, a.KV, a.scale,
      a.causal, a.window);
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
  if (a.B <= 0 || a.Sq <= 0 || a.Sk <= 0 || a.KV <= 0 || a.H % a.KV != 0)
    return (int)cudaErrorInvalidValue;
  if (dtype == 1 && pass == DQ) {
    // bf16 K3a: the tensor-core q-major kernel, grid (B * H, q tiles)
    if ((a.Sq + 15) / 16 > 65535) return (int)cudaErrorInvalidValue;
    if (D == 32) return (int)launch_dq_tc<32>(a);
    if (D == 64) return (int)launch_dq_tc<64>(a);
    if (D == 128) return (int)launch_dq_tc<128>(a);
    return (int)cudaErrorInvalidValue;
  }
  // bf16 kv-major passes (K2, K3b): the tensor-core kernel, grid
  // (B * KV, kv tiles)
  if (dtype == 1) {
    if ((a.Sk + BK - 1) / BK > 65535) return (int)cudaErrorInvalidValue;
    const bool fused = pass == FUSED;
    if (D == 32)
      return (int)(fused ? launch_kv_tc<32, true>(a)
                         : launch_kv_tc<32, false>(a));
    if (D == 64)
      return (int)(fused ? launch_kv_tc<64, true>(a)
                         : launch_kv_tc<64, false>(a));
    if (D == 128)
      return (int)(fused ? launch_kv_tc<128, true>(a)
                         : launch_kv_tc<128, false>(a));
    return (int)cudaErrorInvalidValue;
  }
  // f32, every pass: the FP32-pipe kernels, grid (tiles, B * heads)
  if (dtype != 0 || a.B * a.H > 65535) return (int)cudaErrorInvalidValue;
  if (D == 32) return (int)launch_pass<float, 32>(pass, a);
  if (D == 64) return (int)launch_pass<float, 64>(pass, a);
  if (D == 128) return (int)launch_pass<float, 128>(pass, a);
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
