// mma_bf16.cuh: bf16 tensor-core building blocks for the flash kernels'
// bf16 entries on sm_90a: B1's (flash_fwd_bf16.cu), B2's
// (flash_bwd_dkv_bf16.cu) and B3's (flash_bwd_dq_bf16.cu).
//
// - Tiles: bf16 rows in shared memory, DP values a row (the head dim
//   padded with zero columns to a multiple of 16) plus kPad values of
//   padding. A row is then a multiple of 16 bytes, and its stride in
//   32-bit words is 4 mod 8, so the 8 row addresses of an ldmatrix phase
//   (16 bytes each) fall on 8 distinct groups of 4 banks: no conflicts.
// - Copies: cp.async, 16 bytes (8 bf16 values) a thread, zero-filled
//   past the matrix (a row past its length, a column past d); where d is
//   not a multiple of 8 or a row is not 16-byte aligned, plain 2-byte
//   loads and stores instead (they land before the barrier ahead of the
//   tile's use, as a copy's wait does).
// - Fragments: ldmatrix.x4 (and .trans for an operand stored k-major)
//   into the operands of mma.sync.m16n8k16.row.col.f32.bf16.bf16.f32; a
//   product of two bf16 values is exact in float32, and the sums are
//   float32, so a product of two bf16 operands is the float32 product of
//   their values (the TPU kernel upcasts each bf16 tile and multiplies in
//   float32), up to the order of summation.
// - Split: a float32 accumulator (P, dS) feeds the next product as its A
//   operand without leaving registers. On m16n8k16 a lane's accumulator
//   columns 2t and 2t + 1 of an 8-column tile are the pair an A register
//   packs (k 2t, 2t + 1; two adjacent tiles make the k16 step), so no
//   permutation is needed (the TF32 m16n8k8 path of flash_bwd.cu needs
//   one). Each value x goes in as hi = bf16(x) and lo = bf16(x - hi),
//   both rounded to nearest even (__float2bfloat16_rn): hi + lo keeps
//   about 16 bits of x, and the product is two bf16 products, a_hi b +
//   a_lo b.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace mma16 {

using bf16 = __nv_bfloat16;

constexpr int kPad = 8;  // bf16 values of padding after a tile row

// the head dim a kernel is built for: d padded with zero columns to 32,
// 64 or 128 (multiples of 16: whole k16 steps)
__host__ __device__ constexpr int padded_dim(int d) {
  return d <= 32 ? 32 : d <= 64 ? 64 : 128;
}

__host__ __device__ constexpr int row_stride(int dp) { return dp + kPad; }

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          int src_bytes) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_addr(dst)), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [base, base + n) of a [len, d] bf16 matrix into a tile of DP
// columns (stride row_stride(DP)) by NT threads; rows past len and
// columns d..DP - 1 are zeros. vec: d % 8 == 0 and a 16-byte aligned
// matrix (cp.async, 16 bytes a thread); else plain loads.
template <int NT, int DP>
__device__ __forceinline__ void load_rows(bf16* dst, const bf16* src,
                                          int base, int n, int len, int d,
                                          bool vec) {
  constexpr int LD = row_stride(DP);
  if (vec) {
    constexpr int OCTS = DP / 8;
    for (int i = threadIdx.x; i < n * OCTS; i += NT) {
      const int r = i / OCTS, c = (i - r * OCTS) * 8;
      const int row = base + r;
      const bool ok = row < len && c < d;
      cp_async16(dst + r * LD + c, src + (ok ? (size_t)row * d + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * DP; i += NT) {
      const int r = i / DP, c = i - r * DP;
      const int row = base + r;
      dst[r * LD + c] = row < len && c < d ? src[(size_t)row * d + c]
                                           : __float2bfloat16_rn(0.f);
    }
  }
}

// The address lane `lane` gives ldmatrix.x4 for the 16 x 16 block at
// (row r0, column c0) of a tile of stride LD: its four 8 x 8 matrices
// are (r0, c0), (r0 + 8, c0), (r0, c0 + 8), (r0 + 8, c0 + 8). Without
// .trans they are an A fragment's four registers in order; for a B
// operand stored n-major ([n][k], as K in Q K^T) registers 0 and 2 are
// n-tile r0's (k c0.., c0 + 8..) and 1 and 3 n-tile r0 + 8's. With
// .trans, for a B operand stored k-major ([k][n], as V in P V, rows the
// k index), registers 0 and 1 are n-tile c0's and 2 and 3 n-tile c0 + 8's.
template <int LD>
__device__ __forceinline__ const bf16* x4_addr(const bf16* tile, int r0,
                                               int c0, int lane) {
  return tile + (r0 + (lane & 15)) * LD + c0 + (lane >> 4) * 8;
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              const bf16* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_addr(p)));
}

// c += a b: one m16n8k16 bf16 product, float32 accumulators
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ uint32_t bits(const __nv_bfloat162 h) {
  return *reinterpret_cast<const uint32_t*>(&h);
}

// x0 (lower k, the register's low half) and x1 split into bf16 hi and lo
__device__ __forceinline__ void split2(float x0, float x1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  hi = bits(h);
  lo = bits(__floats2bfloat162_rn(x0 - hf.x, x1 - hf.y));
}

// An A operand (16 rows x k16), split.
struct FragA {
  uint32_t hi[4], lo[4];
};

// The k16 step made of accumulator tiles c0 (columns 0-7) and c1
// (columns 8-15): rows g and g + 8, columns 2t and 2t + 1 of each
__device__ __forceinline__ FragA frag_acc(const float (&c0)[4],
                                          const float (&c1)[4]) {
  FragA f;
  split2(c0[0], c0[1], f.hi[0], f.lo[0]);
  split2(c0[2], c0[3], f.hi[1], f.lo[1]);
  split2(c1[0], c1[1], f.hi[2], f.lo[2]);
  split2(c1[2], c1[3], f.hi[3], f.lo[3]);
  return f;
}

// rows g and g + 8 of an accumulator tile (columns col, col + 1) rounded
// to bf16 into rows of d columns: a pair store where d is even, else one
// value at a time; columns at or past d are not written
__device__ __forceinline__ void store_pair(bf16* row, int col, int d,
                                           float x0, float x1) {
  if (col + 1 < d && d % 2 == 0) {
    *reinterpret_cast<__nv_bfloat162*>(row + col) =
        __floats2bfloat162_rn(x0, x1);
  } else {
    if (col < d) row[col] = __float2bfloat16_rn(x0);
    if (col + 1 < d) row[col + 1] = __float2bfloat16_rn(x1);
  }
}

// 2^x on the special-function unit (ex2.approx.ftz: a relative error
// near 2^-22; a result below 2^-126 flushes to 0, and -inf gives 0)
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// Does the query range [q0, q1] meet the key range [k0, k1] in a pair
// visible by position (causal, sliding window)?
__device__ __forceinline__ bool ranges_meet(int q0, int q1, int k0, int k1,
                                            int causal, int window) {
  bool run = !causal || k0 <= q1;
  if (window) {
    run = run && (q0 - k1 < window);
    if (!causal) run = run && (k0 - q1 < window);
  }
  return run;
}

// Is every pair of the query range [q0, q1] and the key range [k0, k1]
// visible by position? (Then no pair of them needs the test.)
__device__ __forceinline__ bool ranges_inside(int q0, int q1, int k0, int k1,
                                              int causal, int window) {
  bool in = !causal || k1 <= q0;
  if (window) {
    in = in && (q1 - k0 < window);
    if (!causal) in = in && (k1 - q0 < window);
  }
  return in;
}

// Is pair (query i, key j) visible by position?
__device__ __forceinline__ bool pair_visible(int i, int j, int causal,
                                             int window) {
  bool v = !causal || j <= i;
  if (window) {
    v = v && (i - j < window);
    if (!causal) v = v && (j - i < window);
  }
  return v;
}

}  // namespace mma16
