// Tensor-core building blocks of the bf16 flash-attention kernels
// (flash_fwd.cu, flash_bwd.cu) for Hopper (sm_90a).
//
// - cp.async copies of 16 bytes (tiles) and 4 bytes (row statistics)
//   from device memory into shared memory; a source size of 0 zero-fills
//   the destination, which is how rows past the sequence's end arrive.
// - Tiles of 64 rows x D bf16 live in shared memory row-major with their
//   16-byte chunks XOR-swizzled (swz), so the 8 rows an ldmatrix 8x8
//   matrix reads fall in 8 distinct bank groups. cp.async writes and
//   ldmatrix reads both address through swz.
// - mma.sync.m16n8k16 bf16 x bf16 -> f32 with its operand fragments
//   loaded by ldmatrix (x4). The C fragment of a thread is rows g and
//   g + 8, columns 2t and 2t + 1 of the 16 x 8 tile (g = lane / 4,
//   t = lane % 4); two adjacent n8 C tiles packed to bf16x2 are exactly
//   the A fragment of one k16 step, which is how P and dS feed the next
//   product from registers.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace tc {

using bf16 = __nv_bfloat16;

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from gmem into smem; nothing is read and 16 zero bytes land
// when !pred (gmem must still be a valid address).
__device__ __forceinline__ void cp_async16(void* smem, const void* gmem,
                                           bool pred) {
  const int n = pred ? 16 : 0;
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}

// 4 bytes, zero-filled when !pred.
__device__ __forceinline__ void cp_async4(void* smem, const void* gmem,
                                          bool pred) {
  const int n = pred ? 4 : 0;
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(smem)),
               "l"(gmem), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N committed groups of this thread are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Element offset of (row, col) in a row-major [rows][D] bf16 tile whose
// 16-byte chunks are XOR-swizzled; col must be a multiple of 8. A row of
// 64 or 128 elements (128 or 256 bytes) XORs its chunk index with
// row % 8; a row of 32 (64 bytes, two rows per 128 bytes) with
// (row / 2) % 4. Either way rows r..r+7 (r % 8 == 0) at one logical
// chunk hit 8 distinct 16-byte bank groups.
template <int D>
__device__ __forceinline__ int swz(int row, int col) {
  static_assert(D == 32 || D == 64 || D == 128, "D in {32, 64, 128}");
  const int x = (D == 32) ? ((row >> 1) & 3) : (row & 7);
  return row * D + (((col >> 3) ^ x) << 3);
}

// Copy rows r0 .. r0 + ROWS - 1 of a bf16 tensor whose rows are
// row_stride elements apart into a swizzled [ROWS][D] tile, 16 bytes a
// copy; rows at or past n are zero-filled.
template <int D, int ROWS, int THREADS>
__device__ __forceinline__ void load_tile_async(bf16* dst, const bf16* src,
                                                int r0, int n,
                                                long row_stride) {
  constexpr int CPR = D / 8;  // 16-byte chunks per row
  for (int i = threadIdx.x; i < ROWS * CPR; i += THREADS) {
    const int r = i / CPR, c = i % CPR;
    const bool ok = r0 + r < n;
    const bf16* g = src + (ok ? (long)(r0 + r) * row_stride : 0L) + c * 8;
    cp_async16(dst + swz<D>(r, c * 8), g, ok);
  }
}

__device__ __forceinline__ void ldsm_x4(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_t(uint32_t r[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p))
      : "memory");
}

// A fragment (16 x 16, rows m0.., columns k0..) of a tile stored
// [m][k] (row = m).
template <int D>
__device__ __forceinline__ void ldsm_a(uint32_t a[4], const bf16* tile,
                                       int m0, int k0) {
  const int l = threadIdx.x & 31;
  ldsm_x4(a, tile + swz<D>(m0 + (l & 15), k0 + ((l >> 4) << 3)));
}

// A fragment (16 x 16, rows m0.., columns k0..) of a tile stored
// transposed, [k][m] (row = k): ldmatrix.trans.
template <int D>
__device__ __forceinline__ void ldsm_a_t(uint32_t a[4], const bf16* tile,
                                         int m0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  ldsm_x4_t(a, tile + swz<D>(k0 + (l & 7) + ((mi >> 1) << 3),
                             m0 + ((mi & 1) << 3)));
}

// B fragments of two n8 tiles (n0.. and n0 + 8..) over k0 .. k0 + 15 of a
// tile stored [n][k] (row = n, as K is for Q K^T): b[0], b[1] for the
// first n8 tile, b[2], b[3] for the second.
template <int D>
__device__ __forceinline__ void ldsm_b(uint32_t b[4], const bf16* tile,
                                       int n0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  ldsm_x4(b, tile + swz<D>(n0 + (l & 7) + ((mi >> 1) << 3),
                           k0 + ((mi & 1) << 3)));
}

// The same two B fragments of a tile stored [k][n] (row = k, as V is for
// P V): ldmatrix.trans.
template <int D>
__device__ __forceinline__ void ldsm_b_t(uint32_t b[4], const bf16* tile,
                                         int n0, int k0) {
  const int l = threadIdx.x & 31, mi = l >> 3;
  ldsm_x4_t(b, tile + swz<D>(k0 + (l & 7) + ((mi & 1) << 3),
                             n0 + ((mi >> 1) << 3)));
}

// c += a b over one 16 x 8 x 16 step, bf16 operands, f32 accumulation.
__device__ __forceinline__ void mma(float c[4], const uint32_t a[4],
                                    uint32_t b0, uint32_t b1) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two f32 values rounded to bf16 and packed, lo in the low half (the
// lower column of a fragment pair).
__device__ __forceinline__ uint32_t pack(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// The A fragment of one k16 step from the C fragments of the two n8
// tiles c0 (columns 0-7 of the step) and c1 (columns 8-15).
__device__ __forceinline__ void c_to_a(uint32_t a[4], const float c0[4],
                                       const float c1[4]) {
  a[0] = pack(c0[0], c0[1]);
  a[1] = pack(c0[2], c0[3]);
  a[2] = pack(c1[0], c1[1]);
  a[3] = pack(c1[2], c1[3]);
}

// 2^x by the SFU's ex2.approx (a few ulp; results below 2^-126 flush to
// 0, far under what a bf16 probability keeps); -inf gives 0.
__device__ __forceinline__ float fast_exp2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Reduce over the 4 threads of a quad (the threads holding one row of a
// C fragment).
__device__ __forceinline__ float quad_max(float x) {
  x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 1));
  return fmaxf(x, __shfl_xor_sync(0xffffffffu, x, 2));
}
__device__ __forceinline__ float quad_sum(float x) {
  x += __shfl_xor_sync(0xffffffffu, x, 1);
  return x + __shfl_xor_sync(0xffffffffu, x, 2);
}

// Write a warp's 16 rows (m0..) x D of f32 C fragments, times mul, into a
// swizzled bf16 tile: acc[j] is the n8 tile of columns 8j .. 8j + 7.
template <int D>
__device__ __forceinline__ void store_c_tile(bf16* tile, int m0,
                                             const float (*acc)[4],
                                             float mul0, float mul1) {
  const int l = threadIdx.x & 31, g = l >> 2, t = l & 3;
#pragma unroll
  for (int j = 0; j < D / 8; ++j) {
    *reinterpret_cast<uint32_t*>(tile + swz<D>(m0 + g, j * 8) + 2 * t) =
        pack(acc[j][0] * mul0, acc[j][1] * mul0);
    *reinterpret_cast<uint32_t*>(tile + swz<D>(m0 + g + 8, j * 8) + 2 * t) =
        pack(acc[j][2] * mul1, acc[j][3] * mul1);
  }
}

// Copy a warp's 16 rows (m0..) of a swizzled [*][D] tile to rows
// r0 + m0 .. of a bf16 tensor (rows row_stride elements apart), 16 bytes
// a store; rows at or past n are not written.
template <int D>
__device__ __forceinline__ void store_rows(bf16* dst, const bf16* tile,
                                           int m0, int r0, int n,
                                           long row_stride) {
  constexpr int CPR = D / 8;
  const int l = threadIdx.x & 31;
#pragma unroll
  for (int i = l; i < 16 * CPR; i += 32) {
    const int r = m0 + i / CPR, c = (i % CPR) * 8;
    if (r0 + r < n)
      *reinterpret_cast<uint4*>(dst + (long)(r0 + r) * row_stride + c) =
          *reinterpret_cast<const uint4*>(tile + swz<D>(r, c));
  }
}

}  // namespace tc
