// Flash-attention forward for Hopper (sm_90a), plain C interface.
//
// Replaces the Pallas TPU kernel tony_tpu/ops/attention.py::_fwd_kernel
// (launched by _flash_forward). Same math contract: q [B, Sq, H, D] and
// k, v [B, Sk, KV, D] (query head h reads kv head h / (H / KV)); causal
// rule qpos >= kpos, with a window also qpos - kpos < window; o in the
// input dtype, lse [B, H, Sq] in f32 natural log. Two kernels, picked by
// dtype in tony_flash_fwd: bf16 runs the tensor-core kernel, f32 the
// FP32-pipe kernel (f32 products in full f32, no TF32).
//
// bf16: flash_fwd_tc_kernel, the FlashAttention-2 design on mma.sync.
// One block of 4 warps per (batch * head, q tile); each warp owns MT
// 16-row m tiles (MT = 2, a 128-row q tile, for non-causal attention at
// D <= 64; MT = 1 otherwise: see tc_smem_bytes). The q tile arrives once
// by cp.async and its A fragments stay in registers. K/V tiles of 64
// rows stream through a 2-stage cp.async ring in XOR-swizzled shared
// memory (tc_common.cuh), so the next tile loads while this one
// computes; tiles above the diagonal or older than the window are
// skipped. Per tile: S = Q K^T (ldmatrix of K), scores scaled in f32 by
// scale * log2(e), masked only on diagonal, window and edge tiles, an
// online max and sum per row in the exp2 domain (each thread holds 2 rows
// of each m tile, reduced over its quad), P rounded to bf16 straight from
// the C fragments into A fragments (no shared memory), O += P V
// (ldmatrix.trans of V). A row with nothing attended yet keeps m = -inf
// and exponentiates against 0, never inf - inf. o = acc / max(l, 1e-30)
// and lse = ln2 (m + log2 l) as the reference finalizes; o leaves through
// shared memory as 16-byte rows. Under causal masking q tiles launch
// longest first, so the short tiles near the start fill the grid's tail.
//
// What bounds it: 4 D FLOP per attended pair on the bf16 tensor cores
// (989 TFLOP/s dense); at the main paths' shapes the bound is the bytes
// (q, k, v, o once), far below the kernel's time. mma.sync reaches only
// part of the tensor-core rate, and each warp's chain (ldmatrix, mma,
// max, exp2, mma) has little independent work: the K and V fragment
// reads from shared memory, repeated by every warp of the block, and
// the softmax (ex2.approx on the special-function unit, the row
// bookkeeping on the FP32 pipes) set the pace, as in FA2. Out of scope
// here: wgmma, TMA and warp specialisation (a later redesign).
//
// f32: flash_fwd_kernel, one block of 256 threads per (batch * head,
// 64-row q tile). The q tile is staged once in shared memory, pre-scaled
// by scale * log2(e) so the online softmax runs in base 2 (exp2f). The
// block then walks 64-row K/V tiles through shared memory, skipping
// tiles that hold no attended pair (above the diagonal, or older than
// the window), and keeps an f32 running max, sum and output accumulator
// in registers. Each thread owns a 4-row x 4-column patch of the score
// tile and the same 4 rows x D/16 columns of the output, so the row
// statistics never leave a 16-lane group (shuffles only). Ragged edges
// are masked, so any Sq and Sk work. Its products run on the FP32 pipes
// with one shared-memory load per two FMAs, so shared-memory bandwidth
// and FP32 issue bound it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

#include "tc_common.cuh"

namespace {

constexpr int BQ = 64;        // q rows per block
constexpr int BK = 64;        // kv rows per tile
constexpr int THREADS = 256;  // 16 row groups x 16 column lanes
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;

// the FP32-pipe kernel's conversions (it is instantiated for f32 only)
__device__ __forceinline__ float to_f32(float x) { return x; }

template <typename T>
__device__ __forceinline__ T from_f32(float x);
template <>
__device__ __forceinline__ float from_f32<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bf16: the tensor-core kernel
// ---------------------------------------------------------------------------

constexpr int TC_THREADS = 128;  // 4 warps

// Each warp owns MT 16-row m tiles of the q tile (64 MT rows). MT = 2
// halves the K and V fragment reads per product (each feeds two m
// tiles); it runs non-causal attention at D <= 64, where every tile is
// full. Causal attention (and D = 128, whose registers would not hold two
// m tiles) runs MT = 1: tiles shrink along the diagonal and the smaller
// q tiles balance the grid's tail.
template <int D, int MT>
constexpr size_t tc_smem_bytes() {
  // the q tile [64 MT][D] and two stages of K and V tiles [64][D], bf16
  return sizeof(__nv_bfloat16) * (64 * MT + 4 * 64) * D;
}

template <int D, int MT>
__global__ void __launch_bounds__(TC_THREADS)
    flash_fwd_tc_kernel(const __nv_bfloat16* __restrict__ q,
                        const __nv_bfloat16* __restrict__ k,
                        const __nv_bfloat16* __restrict__ v,
                        __nv_bfloat16* __restrict__ o,
                        float* __restrict__ lse, int Sq, int Sk, int H,
                        int KV, float scale, int causal, int window) {
  using tc::bf16;
  constexpr int BQT = 64 * MT;  // q rows of the block
  constexpr int KT = D / 16;    // k16 steps over the head dim
  constexpr int NT = D / 8;     // n8 tiles of the output
  extern __shared__ __align__(128) unsigned char smem_raw[];
  bf16* qs = reinterpret_cast<bf16*>(smem_raw);  // [BQT][D]
  bf16* ks = qs + BQT * D;                        // [2][64][D]
  bf16* vs = ks + 2 * 64 * D;                     // [2][64][D]

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
  const bf16* qb = q + (long)b * Sq * q_row + (long)h * D;
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

  tc::load_tile_async<D, BQT, TC_THREADS>(qs, qb, q0, Sq, q_row);
  if (n_tiles > 0) {
    tc::load_tile_async<D, 64, TC_THREADS>(ks, kb, k_lo, Sk, kv_row);
    tc::load_tile_async<D, 64, TC_THREADS>(vs, vb, k_lo, Sk, kv_row);
  }
  tc::cp_async_commit();

  const float c = scale * LOG2E;
  const int m0 = warp * 16 * MT;  // this warp's first row of the tile
  // running max and per-thread partial sums of rows g and g + 8 of each
  // m tile
  float m[MT][2], l[MT][2];
  float acc[MT][NT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    m[mt][0] = m[mt][1] = -INFINITY;
    l[mt][0] = l[mt][1] = 0.f;
#pragma unroll
    for (int j = 0; j < NT; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][j][e] = 0.f;
  }
  uint32_t qf[MT][KT][4];

  for (int it = 0; it < n_tiles; ++it) {
    const int k0 = k_lo + it * BK;
    const int st = it & 1;
    __syncthreads();  // every warp is done with stage st ^ 1
    if (it + 1 < n_tiles) {
      tc::load_tile_async<D, 64, TC_THREADS>(ks + (st ^ 1) * 64 * D, kb,
                                             k0 + BK, Sk, kv_row);
      tc::load_tile_async<D, 64, TC_THREADS>(vs + (st ^ 1) * 64 * D, vb,
                                             k0 + BK, Sk, kv_row);
      tc::cp_async_commit();
      tc::cp_async_wait<1>();
    } else {
      tc::cp_async_wait<0>();
    }
    __syncthreads();
    const bf16* kt = ks + st * 64 * D;
    const bf16* vt = vs + st * 64 * D;
    if (it == 0) {
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int kk = 0; kk < KT; ++kk)
          tc::ldsm_a<D>(qf[mt][kk], qs, m0 + 16 * mt, kk * 16);
    }

    // S = Q K^T: this warp's 16 MT rows x 64 columns, 8 n8 tiles each
    float s[MT][8][4];
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[mt][j][e] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KT; ++kk)
#pragma unroll
      for (int np = 0; np < 4; ++np) {
        uint32_t bf[4];
        tc::ldsm_b<D>(bf, kt, np * 16, kk * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma(s[mt][2 * np], qf[mt][kk], bf[0], bf[1]);
          tc::mma(s[mt][2 * np + 1], qf[mt][kk], bf[2], bf[3]);
        }
      }

    // masked only where a pair of the tile can fall outside; the scale
    // to base 2 folds into the exponent's FMA (c > 0 keeps the max)
    const bool masked =
        (k0 + BK > Sk) ||
        (causal && (k0 + BK - 1 > q0 ||
                    (window > 0 && q0 + BQT - 1 - k0 >= window)));
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int qr0 = q0 + m0 + 16 * mt + g;
      float mx[2] = {-INFINITY, -INFINITY};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          float x = s[mt][j][e];
          if (masked) {
            const int kp = k0 + j * 8 + 2 * t + (e & 1);
            const int qp = qr0 + (e >> 1) * 8;
            bool ok = kp < Sk;
            if (causal) {
              ok = ok && kp <= qp;
              if (window > 0) ok = ok && (qp - kp < window);
            }
            if (!ok) x = -INFINITY;
          }
          s[mt][j][e] = x;
          mx[e >> 1] = fmaxf(mx[e >> 1], x);
        }
      float alpha[2], m_use[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        const float m_new = fmaxf(m[mt][r], tc::quad_max(mx[r]) * c);
        // nothing attended so far: subtract 0, so every exp2 sees -inf
        m_use[r] = (m_new == -INFINITY) ? 0.f : m_new;
        alpha[r] = tc::fast_exp2(m[mt][r] - m_use[r]);
        m[mt][r] = m_new;
      }
      float rs[2] = {0.f, 0.f};
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p =
              tc::fast_exp2(fmaf(s[mt][j][e], c, -m_use[e >> 1]));
          s[mt][j][e] = p;
          rs[e >> 1] += p;
        }
      // per-thread partial sums: the quad's sum is taken once, at the end
      l[mt][0] = l[mt][0] * alpha[0] + rs[0];
      l[mt][1] = l[mt][1] * alpha[1] + rs[1];
#pragma unroll
      for (int j = 0; j < NT; ++j) {
        acc[mt][j][0] *= alpha[0];
        acc[mt][j][1] *= alpha[0];
        acc[mt][j][2] *= alpha[1];
        acc[mt][j][3] *= alpha[1];
      }
    }

    // O += P V: P's C fragments are the A fragments of the product
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t pa[MT][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
        tc::c_to_a(pa[mt], s[mt][2 * kk], s[mt][2 * kk + 1]);
#pragma unroll
      for (int np = 0; np < NT / 2; ++np) {
        uint32_t bf[4];
        tc::ldsm_b_t<D>(bf, vt, np * 16, kk * 16);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          tc::mma(acc[mt][2 * np], pa[mt], bf[0], bf[1]);
          tc::mma(acc[mt][2 * np + 1], pa[mt], bf[2], bf[3]);
        }
      }
    }
  }
  tc::cp_async_wait<0>();  // the q tile's copy, when no kv tile ran

  // this warp's rows of the q tile are read by this warp only, so o
  // stages in them on its way out
  __syncwarp();
  float* lrow = lse + (long)bh * Sq;
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    const int r0 = m0 + 16 * mt;
    const float l0 = tc::quad_sum(l[mt][0]), l1 = tc::quad_sum(l[mt][1]);
    tc::store_c_tile<D>(qs, r0, acc[mt], 1.f / fmaxf(l0, 1e-30f),
                        1.f / fmaxf(l1, 1e-30f));
    const int qr0 = q0 + r0 + g, qr1 = qr0 + 8;
    if (t == 0 && qr0 < Sq)
      lrow[qr0] = LN2 * (m[mt][0] + log2f(fmaxf(l0, 1e-30f)));
    if (t == 0 && qr1 < Sq)
      lrow[qr1] = LN2 * (m[mt][1] + log2f(fmaxf(l1, 1e-30f)));
  }
  __syncwarp();
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
    tc::store_rows<D>(o + (long)b * Sq * q_row + (long)h * D, qs,
                      m0 + 16 * mt, q0, Sq, q_row);
}

template <int D, int MT>
cudaError_t launch_tc_mt(const void* q, const void* k, const void* v,
                         void* o, void* lse, int B, int Sq, int Sk, int H,
                         int KV, float scale, int causal, int window,
                         cudaStream_t stream) {
  constexpr size_t smem = tc_smem_bytes<D, MT>();
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_tc_kernel<D, MT>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return err;
  dim3 grid(B * H, (Sq + 64 * MT - 1) / (64 * MT));
  flash_fwd_tc_kernel<D, MT><<<grid, TC_THREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q),
      static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), Sq, Sk, H, KV, scale, causal, window);
  return cudaGetLastError();
}

template <int D>
cudaError_t launch_tc(const void* q, const void* k, const void* v, void* o,
                      void* lse, int B, int Sq, int Sk, int H, int KV,
                      float scale, int causal, int window,
                      cudaStream_t stream) {
  if constexpr (D <= 64) {
    if (!causal)
      return launch_tc_mt<D, 2>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                causal, window, stream);
  }
  return launch_tc_mt<D, 1>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale, causal,
                            window, stream);
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. window <= 0 means no window.
// Returns a cudaError_t (0 on success); nothing is launched on a bad
// argument.
extern "C" int tony_flash_fwd(const void* q, const void* k, const void* v,
                              void* o, void* lse, int dtype, int B, int Sq,
                              int Sk, int H, int KV, int D, float scale,
                              int causal, int window, void* stream) {
  if (B <= 0 || Sq <= 0 || Sk <= 0 || KV <= 0 || H % KV != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == 0) {  // f32: the FP32-pipe kernel, grid (q tiles, B * H)
    if (B * H > 65535) return (int)cudaErrorInvalidValue;
    if (D == 32)
      return (int)launch<float, 32>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                    causal, window, s);
    if (D == 64)
      return (int)launch<float, 64>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                    causal, window, s);
    if (D == 128)
      return (int)launch<float, 128>(q, k, v, o, lse, B, Sq, Sk, H, KV,
                                     scale, causal, window, s);
  }
  if (dtype == 1) {  // bf16: the tensor-core kernel, grid (B * H, q tiles)
    if ((Sq + BQ - 1) / BQ > 65535) return (int)cudaErrorInvalidValue;
    if (D == 32)
      return (int)launch_tc<32>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                causal, window, s);
    if (D == 64)
      return (int)launch_tc<64>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                causal, window, s);
    if (D == 128)
      return (int)launch_tc<128>(q, k, v, o, lse, B, Sq, Sk, H, KV, scale,
                                 causal, window, s);
  }
  return (int)cudaErrorInvalidValue;
}
