// flash_bwd: the FlashAttention-2 backward pair, fp32 in and out, for
// sm_90a, with its products on the tensor cores as split-TF32.
//
// Replaces the TPU kernels `_flash_bwd_dkv_kernel` and
// `_flash_bwd_dq_kernel` (paddle_tpu/kernels/flash_attention.py:302,376,
// driven by `_flash_backward` :437). Same contract as the forward
// (csrc/flash_fwd.cu): q and dO [B,H,T,d], k/v [B,H/g,S,d] (query head h
// reads kv head h / g), an optional [B,S] key-validity mask (1 keeps),
// causal and sliding-window visibility; lse and delta = rowsum(dO * O)
// are [B,H,T] fp32. Per pair (query i, key j):
//   s = (q_i . k_j) * sm_scale,  p = valid ? exp(s - lse_i) : 0,
//   dp = dO_i . v_j,             ds = p * (dp - delta_i) * sm_scale,
//   dV_j += p dO_i,  dK_j += ds q_i,  dQ_i += ds k_j,
// where `valid` is i < T, j < S, lse_i > -1e29 (a row that saw no key
// contributes nothing), the key mask, causal j <= i and the window
// (i - j < w, and j - i < w when not causal). So a dead row's dQ and a
// masked key's dK/dV are exactly 0.
//
// Grid. The TPU walks the reduction axes in order on one core and keeps
// the sums in VMEM scratch. GPU blocks run in no fixed order, so each
// reduction moves inside one block and its sum lives in registers:
//   dK/dV: one block per (tile of 64 keys, kv head, batch), looping
//          over the g query heads of the kv head and their 32-row Q tiles;
//   dQ:    one block per (tile of 64 queries, head, batch), looping
//          over the 32-key K/V tiles of its kv head.
// Each of the block's 4 warps owns 16 of its 64 rows. The launch plan
// (kernels/flash_attention.py `flash_bwd_plan`) states the tile and the
// wrapper passes it in; a 32-row tile measured no faster even where
// 64-row tiles leave SMs idle, so 64 is the only one. Neither kernel
// writes a partial sum to device memory, and no atomics are needed: dQ
// is deterministic.
//
// What bounds it on this card: at the training shape (T = S = 256, d = 64)
// the pair does 14 * T * S * d flops per head against about
// 4 * (T + S) * d * 4 bytes, some 450 flops per byte: bound by
// arithmetic. fp32 parity (ROADMAP) rules out plain TF32 (about three
// decimal digits), so every product runs as split-TF32 on the tensor
// cores: each operand x is split into hi = tf32(x) and lo = tf32(x - hi)
// (rounded as cvt.rna.tf32.f32 rounds), and a * b is a_lo b_hi +
// a_hi b_lo + a_hi b_hi, three `mma.sync.m16n8k8` TF32 products with fp32
// accumulators (the arithmetic of CUTLASS's OpMultiplyAddFastF32). The
// bound is then 3x the work at the 495 TFLOP/s dense TF32 rate; the
// warp-level mma.sync reaches a part of that rate only, and the splits,
// shared-memory reads and exponentials around the products have to hide
// behind them.
//
// What the design does about it:
// - All five products (S = Q K^T, dP = dO V^T, dV += P^T dO,
//   dK += dS^T Q, dQ += dS K) are warp-level m16n8k8 products. The dK/dV
//   kernel computes S^T = K Q^T and dP^T = V dO^T, so the rows a warp
//   accumulates are its own keys. An accumulator of S^T (or S) feeds the
//   next product as its A operand without leaving registers: the
//   accumulator holds columns 2t, 2t + 1 of a lane where the A operand
//   wants t, t + 4, so that product reads its B operand with the k order
//   permuted the same way (rows 2t and 2t + 1 of the 8-row step). The
//   three products of each split run pass by pass over a step's
//   independent accumulators, so no mma waits on the one before it.
// - The kernel is bound by latency more than by any one unit, so it is
//   shaped for warps per SM: a streamed tile of 32 rows is worked through
//   at once (S, P and dS, then the accumulating product), which keeps B2
//   within the 170 registers a thread of 3 blocks an SM and B3 within the
//   128 of 4 (the launch bounds ask for both), and the shared memory a
//   block takes lets 3 B2 blocks and 4 B3 blocks share an SM (12 and 16
//   warps) at d <= 64.
// - Streamed tiles (Q, dO, lse and delta in dK/dV; K, V and the key mask
//   in dQ) are copied with cp.async, 16 bytes a thread where d % 4 == 0.
//   dK/dV double-buffers them, so tile j + 1's copy overlaps tile j's
//   products; dQ keeps one buffer, and its other blocks on the SM cover
//   the copy. Resident tiles (K/V, or Q/dO) stay in shared memory. Rows
//   are padded to a stride of 4 mod 8 floats, so the fragment reads of a
//   warp (8 rows x 4 columns, or 4 row pairs x 8 columns) hit 32 distinct
//   banks.
// - Work with no visible pair is skipped: whole tiles by the causal and
//   window tests and a block vote over the key mask (an all-masked key
//   tile), and inside a tile each warp's 16 x 8 sub-products with no
//   visible pair (above the causal diagonal, outside the window, all keys
//   masked, all rows dead) by a warp vote, in all the products that
//   follow from them.
// - The head dim is padded with zero columns to 64 or 128 (a whole
//   number of mma steps), so the inner loops have no bound to test.
// - exp(x) is computed as exp2(x log2 e).
//
// The bf16 entries (the mixed-precision train step's) are kernels of
// their own on the bf16 tensor cores: csrc/flash_bwd_dkv_bf16.cu and
// csrc/flash_bwd_dq_bf16.cu.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kMaskedRowLse = -1e29f;
constexpr float kLog2e = 1.44269504f;  // exp(x) = exp2(x log2 e)
constexpr int kDkv = 0, kDq = 1;  // the two kernels, for the layout
constexpr int kTile = 32;  // rows of a streamed tile (Q, or K and V)
constexpr int kWarps = 4, kRows = 16 * kWarps;  // a block's own rows

// the row stride of every tile: DP + 4 floats, DP the head dim a kernel
// is built for (d padded with zero columns to 64 or 128, a whole number
// of mma steps); 4 mod 8 (see the bank note above), a multiple of 16
// bytes
__host__ __device__ __forceinline__ int row_stride(int d) {
  return (d <= 64 ? 64 : 128) + 4;
}

// shared bytes of a block: two resident tiles of `rows` rows, and the
// buffers of its two streamed tiles with their per-row vectors: dK/dV
// double-buffers them with lse and delta of the queries, dQ keeps one
// buffer with the key mask
__host__ __device__ __forceinline__ size_t smem_bytes(int kernel, int rows,
                                                      int d) {
  const size_t ld = row_stride(d);
  const size_t streamed = kernel == kDkv ? 2 * (2 * kTile * ld + 2 * kTile)
                                         : 2 * kTile * ld + kTile;
  return sizeof(float) * (2 * rows * ld + streamed);
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(a), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned a = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(a), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// rows [base, base + n) of a [len, d] matrix into a tile of stride
// DP + 4; rows past len and columns past d (up to DP) are zeros
template <int NT, int DP>
__device__ __forceinline__ void stage_rows(float* dst, const float* src,
                                           int base, int n, int len, int d,
                                           bool vec) {
  constexpr int dp = DP, ld = DP + 4;
  if (vec) {  // d % 4 == 0 and 16-byte aligned rows
    const int quads = dp / 4;
    for (int i = threadIdx.x; i < n * quads; i += NT) {
      const int r = i / quads, c = (i - r * quads) * 4;
      const int row = base + r;
      const bool ok = row < len && c < d;
      cp_async16(dst + r * ld + c, src + (ok ? (size_t)row * d + c : 0),
                 ok ? 16 : 0);
    }
  } else {
    for (int i = threadIdx.x; i < n * dp; i += NT) {
      const int r = i / dp, c = i - r * dp;
      const int row = base + r;
      const bool ok = row < len && c < d;
      cp_async4(dst + r * ld + c, src + (ok ? (size_t)row * d + c : 0),
                ok ? 4 : 0);
    }
  }
}

// -- split-TF32 on the tensor cores -----------------------------------------

// x rounded to TF32 as cvt.rna.tf32.f32 rounds it (to nearest, ties away
// from zero), in two integer ops: add half a TF32 ulp to the magnitude's
// bits and clear the 13 bits below the TF32 mantissa. Same bits as the
// cvt instruction, which issues at the conversion rate, a quarter of the
// integer rate.
__device__ __forceinline__ uint32_t tf32(float x) {
  return (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
}

__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = tf32(x);
  lo = tf32(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm("mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// A fragment (16 x 8) and B fragment (8 x 8) of one warp, split.
struct FragA {
  uint32_t hi[4], lo[4];
};
struct FragB {
  uint32_t hi[2], lo[2];
};

// B fragment from the lane's two values (k rows t and t + 4, or their
// permuted pair)
__device__ __forceinline__ FragB frag_b(float b0, float b1) {
  FragB f;
  split(b0, f.hi[0], f.lo[0]);
  split(b1, f.hi[1], f.lo[1]);
  return f;
}

// One of the three TF32 products of c += a * b: pass 0 a_lo b_hi, 1
// a_hi b_lo, 2 a_hi b_hi. Callers run pass 0 over all their independent
// accumulators, then pass 1, then pass 2, so no mma waits on the one
// issued just before it.
__device__ __forceinline__ void mma_pass(float (&c)[4], const FragA& a,
                                         const FragB& b, int pass) {
  if (pass == 0)
    mma_tf32(c, a.lo, b.hi[0], b.hi[1]);
  else if (pass == 1)
    mma_tf32(c, a.hi, b.lo[0], b.lo[1]);
  else
    mma_tf32(c, a.hi, b.hi[0], b.hi[1]);
}

// A fragment from an accumulator (rows g, g + 8; columns 2t, 2t + 1): its
// k order is permuted (k t <- column 2t, k t + 4 <- column 2t + 1), so the
// B operand it meets reads rows 2t and 2t + 1 of the 8-row step
__device__ __forceinline__ FragA frag_acc(const float (&acc)[4]) {
  FragA f;
  split(acc[0], f.hi[0], f.lo[0]);
  split(acc[2], f.hi[1], f.lo[1]);
  split(acc[1], f.hi[2], f.lo[2]);
  split(acc[3], f.hi[3], f.lo[3]);
  return f;
}

// s = A1 B1^T and dp = A2 B2^T over the head dim, for a warp's 16 rows
// (rows r, r + 8 of the A tiles) and the 32 rows of the B tiles, 8
// head-dim columns a step
template <int LD, int ND>
__device__ __forceinline__ void two_products(float (&s)[4][4],
                                             float (&dp)[4][4],
                                             const float* a1, const float* a2,
                                             int r, const float* b1,
                                             const float* b2, int gid,
                                             int tig) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll 1
  for (int kk = 0; kk < ND; ++kk) {
    const int c = 8 * kk + tig;
    FragA fa[2];
    FragB fb[2][4];
#pragma unroll
    for (int m = 0; m < 2; ++m) {
      const float* at = m ? a2 : a1;
      split(at[r * LD + c], fa[m].hi[0], fa[m].lo[0]);
      split(at[(r + 8) * LD + c], fa[m].hi[1], fa[m].lo[1]);
      split(at[r * LD + c + 4], fa[m].hi[2], fa[m].lo[2]);
      split(at[(r + 8) * LD + c + 4], fa[m].hi[3], fa[m].lo[3]);
      const float* bt = m ? b2 : b1;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float* row = bt + (8 * j + gid) * LD + c;
        fb[m][j] = frag_b(row[0], row[4]);
      }
    }
#pragma unroll
    for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        mma_pass(s[j], fa[0], fb[0][j], pass);
        mma_pass(dp[j], fa[1], fb[1][j], pass);
      }
    }
  }
}

// Is pair (query i, key j) visible by position (causal, window)?
__device__ __forceinline__ bool pair_visible(int i, int j, int causal,
                                             int window) {
  bool v = !causal || j <= i;
  if (window) {
    v = v && (i - j < window);
    if (!causal) v = v && (j - i < window);
  }
  return v;
}

// Does the query range [q0, q1] meet the key range [k0, k1] in any visible
// pair by position?
__device__ __forceinline__ bool ranges_meet(int q0, int q1, int k0, int k1,
                                            int causal, int window) {
  bool run = !causal || k0 <= q1;
  if (window) {
    run = run && (q0 - k1 < window);
    if (!causal) run = run && (k0 - q1 < window);
  }
  return run;
}

struct Args {
  const float *q, *k, *v, *dout;
  const float *lse, *delta, *kv_mask;
  float *dq, *dk, *dv;
  int H, Hkv, T, S, d;
  float sm_scale;
  int causal, window, vec;
};

// -- B2: dK and dV ----------------------------------------------------------

// each warp owns 16 keys; DP: the padded head dim (64 or 128): the
// dK/dV accumulators are DP / 8 tiles of 16 x 8. At DP 64, 3 blocks an
// SM (the shared memory a block takes allows it)
template <int DP>
__global__ void __launch_bounds__(kWarps * 32, DP == 64 ? 3 : 1)
flash_bwd_dkv_kernel(const Args a) {
  constexpr int NT = kWarps * 32, KR = kRows, ND = DP / 8, LD = DP + 4;
  extern __shared__ float4 smem4[];
  const int d = a.d, T = a.T, S = a.S;
  float* k_s = reinterpret_cast<float*>(smem4);  // [KR][LD]
  float* v_s = k_s + KR * LD;                    // [KR][LD]
  float* q_s = v_s + KR * LD;                    // [2][kTile][LD]
  float* do_s = q_s + 2 * kTile * LD;            // [2][kTile][LD]
  float* lse_s = do_s + 2 * kTile * LD;          // [2][kTile]
  float* dl_s = lse_s + 2 * kTile;               // [2][kTile]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k_base = blockIdx.x * KR;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int g = a.H / a.Hkv;
  const size_t bhk = (size_t)b * a.Hkv + hk;
  const float* mask_b = a.kv_mask ? a.kv_mask + (size_t)b * S : nullptr;

  // this lane's two keys (accumulator rows g and g + 8 of its warp)
  const int kw0 = k_base + warp * 16;
  const int key[2] = {kw0 + gid, kw0 + gid + 8};
  bool key_ok[2];
#pragma unroll
  for (int h = 0; h < 2; ++h)
    key_ok[h] = key[h] < S && (!mask_b || mask_b[key[h]] > 0.f);
  const bool warp_live = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
  // a tile of masked keys gets zero gradients without a pass over Q
  const bool block_live = __syncthreads_or(warp_live);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the streamed (query head, Q tile) pairs, in order: index gi * n_q + qt
  const int n_q = (T + kTile - 1) / kTile, n_i = g * n_q;
  auto next = [&](int i) {
    for (; i < n_i; ++i) {
      const int qb = (i % n_q) * kTile;
      if (ranges_meet(qb, qb + kTile - 1, k_base, k_base + KR - 1, a.causal,
                      a.window))
        return i;
    }
    return n_i;
  };
  auto stage = [&](int i, int buf) {
    const int qb = (i % n_q) * kTile;
    const size_t bh = (size_t)b * a.H + (size_t)hk * g + i / n_q;
    stage_rows<NT, DP>(q_s + buf * kTile * LD, a.q + bh * T * d, qb, kTile,
                       T, d, a.vec);
    stage_rows<NT, DP>(do_s + buf * kTile * LD, a.dout + bh * T * d, qb,
                       kTile, T, d, a.vec);
    for (int r = tid; r < kTile; r += NT) {
      const int t = qb + r;
      const size_t off = bh * T + (t < T ? t : 0);
      cp_async4(lse_s + buf * kTile + r, a.lse + off, t < T ? 4 : 0);
      cp_async4(dl_s + buf * kTile + r, a.delta + off, t < T ? 4 : 0);
    }
    cp_async_commit();
  };

  int i = block_live ? next(0) : n_i;
  if (i < n_i) {
    stage_rows<NT, DP>(k_s, a.k + bhk * S * d, k_base, KR, S, d, a.vec);
    stage_rows<NT, DP>(v_s, a.v + bhk * S * d, k_base, KR, S, d, a.vec);
    stage(i, 0);  // one commit group with K and V
  }
  int buf = 0;
  while (i < n_i) {
    // tile i + 1's copy overlaps tile i's products
    const int nxt = next(i + 1);
    if (nxt < n_i) {
      stage(nxt, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile i (and K/V) landed
    if (warp_live) {
      const int qb = (i % n_q) * kTile;
      const float* qt = q_s + buf * kTile * LD;
      const float* ot = do_s + buf * kTile * LD;
      const float* lt = lse_s + buf * kTile;
      const float* dt = dl_s + buf * kTile;
      // the 8-query column tiles with a visible pair for this warp
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int q0 = qb + 8 * j;
        const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j +
                                                           2 * tig);
        const bool rows_ok =
            (q0 + 2 * tig < T && l2.x > kMaskedRowLse) ||
            (q0 + 2 * tig + 1 < T && l2.y > kMaskedRowLse);
        live[j] = __any_sync(0xffffffffu,
                             rows_ok && ranges_meet(q0, q0 + 7, kw0, kw0 + 15,
                                                    a.causal, a.window));
      }
      // a tile with no live column tile is skipped; inside one no branch
      // splits the products
      if (live[0] || live[1] || live[2] || live[3]) {
        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x 32 queries
        float s[4][4], dp[4][4];
        two_products<LD, ND>(s, dp, k_s, v_s, warp * 16 + gid, qt, ot, gid,
                             tig);
        // P^T and dS^T in place
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!live[j]) continue;
          const float2 l2 = *reinterpret_cast<const float2*>(lt + 8 * j +
                                                             2 * tig);
          const float2 d2 = *reinterpret_cast<const float2*>(dt + 8 * j +
                                                             2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int qi = qb + 8 * j + 2 * tig + (e & 1);
            const float lse = (e & 1) ? l2.y : l2.x;
            const float delta = (e & 1) ? d2.y : d2.x;
            const bool valid = key_ok[e >> 1] && qi < T &&
                               lse > kMaskedRowLse &&
                               pair_visible(qi, key[e >> 1], a.causal,
                                            a.window);
            const float p =
                valid ? exp2f((s[j][e] * a.sm_scale - lse) * kLog2e) : 0.f;
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta) * a.sm_scale;
          }
        }
        // dV += P^T dO, dK += dS^T Q over the tile's queries, 8 a step
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!live[j]) continue;
          const FragA fp = frag_acc(s[j]);
          const FragA fs = frag_acc(dp[j]);
          const float* orow = ot + (8 * j + 2 * tig) * LD + gid;
          const float* qr = qt + (8 * j + 2 * tig) * LD + gid;
#pragma unroll
          for (int n0 = 0; n0 < ND; n0 += 4) {
            FragB bo[4], bq[4];
#pragma unroll
            for (int nn = 0; nn < 4; ++nn) {
              const int n = n0 + nn;
              bo[nn] = frag_b(orow[8 * n], orow[LD + 8 * n]);
              bq[nn] = frag_b(qr[8 * n], qr[LD + 8 * n]);
            }
#pragma unroll
            for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
              for (int nn = 0; nn < 4; ++nn) {
                mma_pass(dv[n0 + nn], fp, bo[nn], pass);
                mma_pass(dk[n0 + nn], fs, bq[nn], pass);
              }
            }
          }
        }
      }
    }
    __syncthreads();  // done with this buffer
    buf ^= 1;
    i = nxt;
  }

  // rows g, g + 8 and columns 2t, 2t + 1 of each 16 x 8 tile
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    if (key[h] >= S) continue;
    float* dk_row = a.dk + (bhk * S + key[h]) * d;
    float* dv_row = a.dv + (bhk * S + key[h]) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c < d) {
        dk_row[c] = dk[n][2 * h];
        dv_row[c] = dv[n][2 * h];
      }
      if (c + 1 < d) {
        dk_row[c + 1] = dk[n][2 * h + 1];
        dv_row[c + 1] = dv[n][2 * h + 1];
      }
    }
  }
}

// -- B3: dQ -----------------------------------------------------------------

// each warp owns 16 query rows; DP as above. At DP 64, 4 blocks an SM
template <int DP>
__global__ void __launch_bounds__(kWarps * 32, DP == 64 ? 4 : 1)
flash_bwd_dq_kernel(const Args a) {
  constexpr int NT = kWarps * 32, QR = kRows, ND = DP / 8, LD = DP + 4;
  extern __shared__ float4 smem4[];
  const int d = a.d, T = a.T, S = a.S;
  float* q_s = reinterpret_cast<float*>(smem4);  // [QR][LD]
  float* do_s = q_s + QR * LD;                   // [QR][LD]
  float* k_s = do_s + QR * LD;                   // [kTile][LD]
  float* v_s = k_s + kTile * LD;                 // [kTile][LD]
  float* m_s = v_s + kTile * LD;                 // [kTile]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_base = blockIdx.x * QR;
  const int h = blockIdx.y, b = blockIdx.z;
  const size_t bh = (size_t)b * a.H + h;
  const size_t bhk = (size_t)b * a.Hkv + h / (a.H / a.Hkv);
  const float* mask_b = a.kv_mask ? a.kv_mask + (size_t)b * S : nullptr;

  // this lane's two query rows (accumulator rows g and g + 8 of its warp)
  const int qw0 = q_base + warp * 16;
  const int row[2] = {qw0 + gid, qw0 + gid + 8};
  float lse[2], delta[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < T;
    lse[r] = in ? a.lse[bh * T + row[r]] : 0.f;
    delta[r] = in ? a.delta[bh * T + row[r]] : 0.f;
    row_ok[r] = in && lse[r] > kMaskedRowLse;
  }
  const bool warp_live = __any_sync(0xffffffffu, row_ok[0] || row_ok[1]);
  const bool block_live = __syncthreads_or(warp_live);

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  const int n_k = (S + kTile - 1) / kTile;
  // the next key tile at or after kt that any row of the block sees: the
  // causal and window tests, then a block vote over the tile's key mask
  // (uniform: every thread walks the same tiles)
  auto next = [&](int kt) {
    for (; kt < n_k; ++kt) {
      const int kb = kt * kTile;
      if (!ranges_meet(q_base, q_base + QR - 1, kb, kb + kTile - 1, a.causal,
                       a.window))
        continue;
      if (!mask_b) return kt;
      bool any = false;
      for (int r = tid; r < kTile; r += NT) {
        const int s = kb + r;
        any = any || (s < S && mask_b[s] > 0.f);
      }
      if (__syncthreads_or(any)) return kt;
    }
    return n_k;
  };
  auto stage = [&](int kt) {
    const int kb = kt * kTile;
    stage_rows<NT, DP>(k_s, a.k + bhk * S * d, kb, kTile, S, d, a.vec);
    stage_rows<NT, DP>(v_s, a.v + bhk * S * d, kb, kTile, S, d, a.vec);
    for (int r = tid; r < kTile; r += NT) {
      const int s = kb + r;
      if (mask_b)  // keys past S read as masked
        cp_async4(m_s + r, mask_b + (s < S ? s : 0), s < S ? 4 : 0);
      else
        m_s[r] = s < S ? 1.f : 0.f;
    }
    cp_async_commit();
  };

  int kt = block_live ? next(0) : n_k;
  if (kt < n_k) {
    stage_rows<NT, DP>(q_s, a.q + bh * T * d, q_base, QR, T, d, a.vec);
    stage_rows<NT, DP>(do_s, a.dout + bh * T * d, q_base, QR, T, d, a.vec);
    stage(kt);  // one commit group with Q and dO
  }
  // one buffer: the other blocks on the SM cover a tile's copy
  while (kt < n_k) {
    const int nxt = next(kt + 1);
    cp_async_wait<0>();
    __syncthreads();  // tile kt (and Q/dO) landed
    if (warp_live) {
      const int kb = kt * kTile;
      // the 8-key column tiles with a visible pair for this warp
      bool live[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k0 = kb + 8 * j;
        const float2 m2 = *reinterpret_cast<const float2*>(m_s + 8 * j +
                                                           2 * tig);
        live[j] = __any_sync(0xffffffffu,
                             (m2.x > 0.f || m2.y > 0.f) &&
                                 ranges_meet(qw0, qw0 + 15, k0, k0 + 7,
                                             a.causal, a.window));
      }
      if (live[0] || live[1] || live[2] || live[3]) {
        // S = Q K^T and dP = dO V^T: this warp's 16 rows x 32 keys
        float s[4][4], dp[4][4];
        two_products<LD, ND>(s, dp, q_s, do_s, warp * 16 + gid, k_s, v_s,
                             gid, tig);
        // dS in place (P is not needed past it)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!live[j]) continue;
          const float2 m2 = *reinterpret_cast<const float2*>(m_s + 8 * j +
                                                             2 * tig);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            const int r = e >> 1;
            const int kj = kb + 8 * j + 2 * tig + (e & 1);
            const bool valid = row_ok[r] && ((e & 1) ? m2.y : m2.x) > 0.f &&
                               pair_visible(row[r], kj, a.causal, a.window);
            const float p =
                valid ? exp2f((s[j][e] * a.sm_scale - lse[r]) * kLog2e) : 0.f;
            dp[j][e] = p * (dp[j][e] - delta[r]) * a.sm_scale;
          }
        }
        // dQ += dS K over the tile's keys, 8 at a step
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          if (!live[j]) continue;
          const FragA fs = frag_acc(dp[j]);
          const float* kr = k_s + (8 * j + 2 * tig) * LD + gid;
#pragma unroll
          for (int n0 = 0; n0 < ND; n0 += 8) {
            FragB bk[8];
#pragma unroll
            for (int nn = 0; nn < 8; ++nn)
              bk[nn] = frag_b(kr[8 * (n0 + nn)], kr[LD + 8 * (n0 + nn)]);
#pragma unroll
            for (int pass = 0; pass < 3; ++pass) {
#pragma unroll
              for (int nn = 0; nn < 8; ++nn)
                mma_pass(dq[n0 + nn], fs, bk[nn], pass);
            }
          }
        }
      }
    }
    __syncthreads();  // done with this buffer
    if (nxt < n_k) stage(nxt);
    kt = nxt;
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    float* dq_row = a.dq + (bh * T + row[r]) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      const int c = 8 * n + 2 * tig;
      if (c < d) dq_row[c] = dq[n][2 * r];
      if (c + 1 < d) dq_row[c + 1] = dq[n][2 * r + 1];
    }
  }
}

template <typename Kern>
int launch(Kern kernel, int which, const Args& a, int B, cudaStream_t st) {
  const size_t smem = smem_bytes(which, kRows, a.d);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  const int own = which == kDkv ? a.S : a.T;
  dim3 grid((own + kRows - 1) / kRows, which == kDkv ? a.Hkv : a.H, B);
  kernel<<<grid, kWarps * 32, smem, st>>>(a);
  return (int)cudaGetLastError();
}

int run(int which, const float* q, const float* k, const float* v,
        const float* dout, const float* lse, const float* delta,
        const float* kv_mask, float* dq, float* dk, float* dv, int B, int H,
        int Hkv, int T, int S, int d, float sm_scale, int causal, int window,
        int rows, void* stream) {
  if (B < 1 || T < 1 || S < 1 || d < 1 || d > 128 || Hkv < 1 ||
      H % Hkv != 0 || window < 0 || rows != kRows)
    return (int)cudaErrorInvalidValue;
  // 16 bytes (4 floats) a copy
  const int vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                 (uintptr_t)dout) % 16 == 0;
  const Args a{q,  k,   v, dout, lse, delta,    kv_mask, dq,     dk, dv,
               H,  Hkv, T, S,    d,   sm_scale, causal,  window, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const bool narrow = d <= 64;
  if (which == kDkv)
    return narrow ? launch(flash_bwd_dkv_kernel<64>, which, a, B, st)
                  : launch(flash_bwd_dkv_kernel<128>, which, a, B, st);
  return narrow ? launch(flash_bwd_dq_kernel<64>, which, a, B, st)
                : launch(flash_bwd_dq_kernel<128>, which, a, B, st);
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// kv_mask may be null (no key mask). dk/dv are [B,Hkv,S,d], dq
// [B,H,T,d]; every element is written. `rows` is the launch plan's tile
// (kernels/flash_attention.py `flash_bwd_plan`): 64, the one the kernels
// take.
extern "C" int paddle_flash_bwd_dkv_f32(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        const float* lse, const float* delta,
                                        const float* kv_mask, float* dk,
                                        float* dv, int B, int H, int Hkv,
                                        int T, int S, int d, float sm_scale,
                                        int causal, int window, int rows,
                                        void* stream) {
  return run(kDkv, q, k, v, dout, lse, delta, kv_mask, nullptr, dk, dv, B,
             H, Hkv, T, S, d, sm_scale, causal, window, rows, stream);
}

extern "C" int paddle_flash_bwd_dq_f32(const float* q, const float* k,
                                       const float* v, const float* dout,
                                       const float* lse, const float* delta,
                                       const float* kv_mask, float* dq,
                                       int B, int H, int Hkv, int T, int S,
                                       int d, float sm_scale, int causal,
                                       int window, int rows, void* stream) {
  return run(kDq, q, k, v, dout, lse, delta, kv_mask, dq, nullptr, nullptr,
             B, H, Hkv, T, S, d, sm_scale, causal, window, rows, stream);
}

// The threads and shared-memory bytes a block of `kernel` (0: dK/dV, 1:
// dQ) takes at tile `rows` and head dim d, for holding `flash_bwd_plan`'s
// figures to the kernels' (host code: no device needed);
// cudaErrorInvalidValue where the kernels refuse them.
extern "C" int paddle_flash_bwd_layout(int kernel, int rows, int d,
                                       int* threads, int* smem) {
  if ((kernel != kDkv && kernel != kDq) || rows != kRows || d < 1 || d > 128)
    return (int)cudaErrorInvalidValue;
  *threads = kWarps * 32;
  *smem = (int)smem_bytes(kernel, rows, d);
  return 0;
}
