// flash_bwd_dkv_bf16: B2's bf16 entry (dK and dV of the mixed-precision
// train step's attention) on Hopper's bf16 tensor cores, for sm_90a.
//
// Replaces the TPU kernel `_flash_bwd_dkv_kernel` on bf16 tiles
// (paddle_tpu/kernels/flash_attention.py:302, driven by
// `_flash_backward` :437), with the float32 entry's contract
// (csrc/flash_bwd.cu): q and dO [B,H,T,d], k/v [B,H/g,S,d] bf16, an
// optional [B,S] float32 key-validity mask, causal and sliding-window
// visibility, lse and delta = rowsum(dO O) [B,H,T] float32 (delta from
// the wrapper); dK, dV [B,H/g,S,d] bf16, rounded once at the store. Per
// pair (query i, key j):
//   s = (q_i . k_j) * sm_scale,  p = valid ? exp(s - lse_i) : 0,
//   dp = dO_i . v_j,             ds = p * (dp - delta_i) * sm_scale,
//   dV_j += p dO_i,  dK_j += ds q_i,
// `valid` as in flash_bwd.cu, so a masked key's dK/dV is exactly 0 and a
// row that saw no key (lse <= -1e29) contributes nothing.
//
// The TPU kernel upcasts every bf16 tile and computes in float32, P and
// dS kept in float32 (flash_attention.py:325-328,349,353). A product of
// two bf16 values is exact in float32, so S^T = K Q^T and dP^T = V dO^T
// are one bf16 tensor-core product each with float32 accumulators; P^T
// and dS^T are float32 and go into dV += P^T dO and dK += dS^T Q split
// into bf16 hi + lo (two products each, about 16 bits: mma_bf16.cuh).
//
// What bounds it on this card: at the train shapes a key tile does 12
// flops a visible pair and head-dim column (S^T 2, dP^T 2, dV and dK 4
// each with the split) over about 2 bytes a value moved: bf16 tensor-core
// work that mma.sync reaches only in part, behind the exponentials,
// splits and shared-memory fragment reads around it. The entry it
// replaces widened every tile to float32 and ran split-TF32 m16n8k8
// products (half the bf16 rate, half the depth a step), from float32
// tiles that doubled its staging bytes.
//
// What the design does about it:
// - Grid: one block per (64 keys, kv head, batch), 4 warps of 16 keys,
//   looping over the g query heads of its kv head and their 32-row Q/dO
//   tiles: every sum stays in the block, so no atomics and dK/dV are
//   deterministic. The kernel is bound by latency more than by any one
//   unit, so it is shaped for blocks an SM: at d <= 64 the launch bounds
//   hold it to the registers of 3 (no spills).
// - Tiles are bf16 in shared memory: K and V resident, Q, dO, lse and
//   delta double-buffered with cp.async, so tile j + 1's copy overlaps
//   tile j's products. Fragments come through ldmatrix: K, V (A
//   operands) and Q, dO (n-major B) for S^T and dP^T, and Q, dO through
//   ldmatrix.trans (k-major B) for dK and dV.
// - P^T and dS^T are computed in place on the S^T and dP^T accumulators
//   and feed dV and dK from registers (no shared memory, no permutation).
// - Skipping: a tile of queries no key of the block sees by position
//   (causal, window), a block whose keys are all masked (zeros without a
//   pass over Q), a warp whose 16 keys are all masked, and inside a
//   tile each warp's 16-query chunks with no visible pair (above the
//   diagonal, outside the window, all rows dead) by a warp vote, in all
//   four products.
// - The head dim is padded with zero columns to 32, 64 or 128.
// - exp(x) is computed as exp2(x log2 e) on the SFU (ex2.approx); the
//   validity of a pair enters as -inf in the exponent (a dead row's lse,
//   a masked key), with a position test only in the 16 x 16 chunks that
//   cross the causal diagonal or the window.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

using namespace mma16;

namespace {

constexpr float kMaskedRowLse = -1e29f;
constexpr float kLog2e = 1.44269504f;
constexpr int kWarps = 4, kRows = 16 * kWarps;  // a block's own keys
constexpr int kStages = 2;  // buffers of the streamed tiles

// rows of a streamed Q / dO tile: at 64 the S^T and dP^T accumulators
// take the registers (about 210 a thread at d <= 64) that let a third
// block onto an SM, and 3 blocks of 32-row tiles ran faster on an H100
constexpr int kTileQ = 32;

// shared bytes of a block: resident K and V, then each buffer's Q and dO
// tiles and their lse and delta
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)row_stride(dp) *
             (2 * kRows + kStages * 2 * kTileQ) +
         sizeof(float) * kStages * 2 * kTileQ;
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta, *kv_mask;
  bf16 *dk, *dv;
  int H, Hkv, T, S, d;
  float sm_scale;
  int causal, window, vec;
};

// DP: the padded head dim; 3 blocks an SM at DP <= 64
template <int DP>
__global__ void __launch_bounds__(kWarps * 32, DP <= 64 ? 3 : 1)
flash_bwd_dkv_bf16_kernel(const Args a) {
  constexpr int NT = kWarps * 32, QT = kTileQ, LD = row_stride(DP);
  constexpr int KS = DP / 16;   // k16 steps of S^T and dP^T
  constexpr int ND = DP / 8;    // 8-column tiles of dK and dV
  constexpr int QS = QT / 16;   // 16-query chunks of a tile
  constexpr int NQ = QT / 8;    // 8-query tiles of S^T and dP^T
  extern __shared__ uint4 smem_u4[];
  bf16* k_s = reinterpret_cast<bf16*>(smem_u4);  // [kRows][LD]
  bf16* v_s = k_s + kRows * LD;                  // [kRows][LD]
  bf16* qd_s = v_s + kRows * LD;  // [kStages][Q, dO][QT][LD]
  float* row_s = reinterpret_cast<float*>(qd_s + kStages * 2 * QT * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int k_base = blockIdx.x * kRows;
  const int hk = blockIdx.y, b = blockIdx.z;
  const int d = a.d, T = a.T, S = a.S;
  const int g = a.H / a.Hkv;
  const size_t bhk = (size_t)b * a.Hkv + hk;
  const float* mask_b = a.kv_mask ? a.kv_mask + (size_t)b * S : nullptr;

  // this lane's two keys (accumulator rows g and g + 8 of its warp)
  const int kw0 = k_base + warp * 16;
  const int key[2] = {kw0 + gid, kw0 + gid + 8};
  bool key_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r)
    key_ok[r] = key[r] < S && (!mask_b || mask_b[key[r]] > 0.f);
  const bool warp_live = __any_sync(0xffffffffu, key_ok[0] || key_ok[1]);
  const float kadd[2] = {key_ok[0] ? 0.f : -INFINITY,
                         key_ok[1] ? 0.f : -INFINITY};
  const float scale2 = a.sm_scale * kLog2e;
  // a tile of masked keys gets zero gradients without a pass over Q
  const bool block_live = __syncthreads_or(warp_live);

  float dk[ND][4], dv[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dk[n][e] = dv[n][e] = 0.f;

  // the streamed (query head, Q tile) pairs, in order: index gi * n_q + qt
  const int n_q = (T + QT - 1) / QT, n_i = g * n_q;
  auto next = [&](int i) {
    for (; i < n_i; ++i) {
      const int qb = (i % n_q) * QT;
      if (ranges_meet(qb, qb + QT - 1, k_base, k_base + kRows - 1, a.causal,
                      a.window))
        return i;
    }
    return n_i;
  };
  auto stage = [&](int i, int buf) {
    const int qb = (i % n_q) * QT;
    const size_t bh = (size_t)b * a.H + (size_t)hk * g + i / n_q;
    bf16* qt = qd_s + buf * 2 * QT * LD;
    load_rows<NT, DP>(qt, a.q + bh * T * d, qb, QT, T, d, a.vec);
    load_rows<NT, DP>(qt + QT * LD, a.dout + bh * T * d, qb, QT, T, d,
                      a.vec);
    float* rt = row_s + buf * 2 * QT;
    for (int r = tid; r < QT; r += NT) {
      const int t = qb + r;
      const size_t off = bh * T + (t < T ? t : 0);
      cp_async4(rt + r, a.lse + off, t < T ? 4 : 0);
      cp_async4(rt + QT + r, a.delta + off, t < T ? 4 : 0);
    }
    cp_async_commit();
  };

  // the ring: ring[s] is the tile in buffer s (n_i: none), `fetch` the
  // next tile to copy. Every step commits one copy group, empty or not,
  // so waiting for all but kStages - 1 groups waits for the current tile.
  int ring[kStages];
  int fetch = block_live ? next(0) : n_i;
  if (fetch < n_i) {  // K and V join the first tile's group
    load_rows<NT, DP>(k_s, a.k + bhk * S * d, k_base, kRows, S, d, a.vec);
    load_rows<NT, DP>(v_s, a.v + bhk * S * d, k_base, kRows, S, d, a.vec);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    ring[st] = fetch;
    if (fetch < n_i) {
      stage(fetch, st);
      fetch = next(fetch + 1);
    } else {
      cp_async_commit();
    }
  }
  for (int it = 0;; ++it) {
    const int buf = it % kStages;
    const int i = ring[buf];
    if (i >= n_i) break;
    const int put = (it + kStages - 1) % kStages;
    ring[put] = fetch;
    if (fetch < n_i) {
      stage(fetch, put);
      fetch = next(fetch + 1);
    } else {
      cp_async_commit();
    }
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile i (and K/V) landed
    if (warp_live) {
      const int qb = (i % n_q) * QT;
      const bf16* qt = qd_s + buf * 2 * QT * LD;
      const bf16* ot = qt + QT * LD;
      const float* lt = row_s + buf * 2 * QT;
      const float* dt = lt + QT;
      // the 16-query chunks with a visible pair for this warp: a lane
      // reads the lse of its rows 2t, 2t + 1, 2t + 8, 2t + 9 of a chunk
      bool live[QS];
      bool any = false;
#pragma unroll
      for (int c = 0; c < QS; ++c) {
        const int q0 = qb + 16 * c;
        bool rows_ok = false;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 16 * c + 2 * tig + (e & 1) + 8 * (e >> 1);
          rows_ok = rows_ok || (qb + r < T && lt[r] > kMaskedRowLse);
        }
        live[c] = __any_sync(0xffffffffu,
                             rows_ok && ranges_meet(q0, q0 + 15, kw0,
                                                    kw0 + 15, a.causal,
                                                    a.window));
        any = any || live[c];
      }
      if (any) {
        // S^T = K Q^T and dP^T = V dO^T: this warp's 16 keys x QT queries
        float s[NQ][4], dp[NQ][4];
#pragma unroll
        for (int j = 0; j < NQ; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t ka[4], va[4];
          ldsm_x4(ka, x4_addr<LD>(k_s, warp * 16, 16 * kk, lane));
          ldsm_x4(va, x4_addr<LD>(v_s, warp * 16, 16 * kk, lane));
#pragma unroll
          for (int c = 0; c < QS; ++c) {
            if (!live[c]) continue;
            uint32_t qb4[4], ob4[4];
            ldsm_x4(qb4, x4_addr<LD>(qt, 16 * c, 16 * kk, lane));
            ldsm_x4(ob4, x4_addr<LD>(ot, 16 * c, 16 * kk, lane));
            mma(s[2 * c], ka, qb4[0], qb4[2]);
            mma(s[2 * c + 1], ka, qb4[1], qb4[3]);
            mma(dp[2 * c], va, ob4[0], ob4[2]);
            mma(dp[2 * c + 1], va, ob4[1], ob4[3]);
          }
        }
        // P^T and dS^T in place: p = 2^(s sm_scale log2 e - lse log2 e),
        // the exponent -inf (p = 0) for a row past T or dead (through its
        // lse), a masked key (kadd) and, where the chunk crosses the
        // causal diagonal or the window, a pair outside them
#pragma unroll
        for (int j = 0; j < NQ; ++j) {
          if (!live[j >> 1]) continue;
          const int q0 = qb + 8 * j + 2 * tig;
          const float2 l2 =
              *reinterpret_cast<const float2*>(lt + 8 * j + 2 * tig);
          const float2 d2 =
              *reinterpret_cast<const float2*>(dt + 8 * j + 2 * tig);
          const float nl[2] = {
              q0 < T && l2.x > kMaskedRowLse ? -l2.x * kLog2e : -INFINITY,
              q0 + 1 < T && l2.y > kMaskedRowLse ? -l2.y * kLog2e
                                                 : -INFINITY};
          const float delta[2] = {d2.x, d2.y};
          const bool edge = !ranges_inside(qb + 16 * (j >> 1),
                                           qb + 16 * (j >> 1) + 15, kw0,
                                           kw0 + 15, a.causal, a.window);
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[j][e], scale2, nl[e & 1]) + kadd[e >> 1];
            if (edge && !pair_visible(q0 + (e & 1), key[e >> 1], a.causal,
                                      a.window))
              x = -INFINITY;
            const float p = ex2(x);
            s[j][e] = p;
            dp[j][e] = p * (dp[j][e] - delta[e & 1]) * a.sm_scale;
          }
        }
        // dV += P^T dO and dK += dS^T Q, 16 queries a step, P^T and dS^T
        // split hi + lo
#pragma unroll
        for (int c = 0; c < QS; ++c) {
          if (!live[c]) continue;
          const FragA pf = frag_acc(s[2 * c], s[2 * c + 1]);
          const FragA sf = frag_acc(dp[2 * c], dp[2 * c + 1]);
#pragma unroll
          for (int nn = 0; nn < ND / 2; ++nn) {
            uint32_t ob4[4], qb4[4];
            ldsm_x4_trans(ob4, x4_addr<LD>(ot, 16 * c, 16 * nn, lane));
            ldsm_x4_trans(qb4, x4_addr<LD>(qt, 16 * c, 16 * nn, lane));
            mma(dv[2 * nn], pf.hi, ob4[0], ob4[1]);
            mma(dv[2 * nn + 1], pf.hi, ob4[2], ob4[3]);
            mma(dk[2 * nn], sf.hi, qb4[0], qb4[1]);
            mma(dk[2 * nn + 1], sf.hi, qb4[2], qb4[3]);
            mma(dv[2 * nn], pf.lo, ob4[0], ob4[1]);
            mma(dv[2 * nn + 1], pf.lo, ob4[2], ob4[3]);
            mma(dk[2 * nn], sf.lo, qb4[0], qb4[1]);
            mma(dk[2 * nn + 1], sf.lo, qb4[2], qb4[3]);
          }
        }
      }
    }
    __syncthreads();  // done with this buffer
  }
  cp_async_wait<0>();

  // rows g, g + 8 and columns 2t, 2t + 1 of each 16 x 8 tile
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (key[r] >= S) continue;
    bf16* dk_row = a.dk + (bhk * S + key[r]) * d;
    bf16* dv_row = a.dv + (bhk * S + key[r]) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      store_pair(dk_row, 8 * n + 2 * tig, d, dk[n][2 * r], dk[n][2 * r + 1]);
      store_pair(dv_row, 8 * n + 2 * tig, d, dv[n][2 * r], dv[n][2 * r + 1]);
    }
  }
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t st) {
  auto kernel = flash_bwd_dkv_bf16_kernel<DP>;
  const size_t smem = smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((a.S + kRows - 1) / kRows, a.Hkv, B), kWarps * 32, smem,
           st>>>(a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout, dk and dv bf16; lse, delta and kv_mask (may be null)
// float32; the arguments of paddle_flash_bwd_dkv_f32 (csrc/flash_bwd.cu),
// launched on `stream`, returning cudaGetLastError() (0 on success).
// `rows` is the launch plan's key tile (kernels/flash_attention.py
// `flash_bwd_plan`, "dkv_bf16"): 64, the one the kernel takes. dk/dv
// are [B,Hkv,S,d]; every element is written.
extern "C" int paddle_flash_bwd_dkv_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, const float* kv_mask, bf16* dk,
    bf16* dv, int B, int H, int Hkv, int T, int S, int d, float sm_scale,
    int causal, int window, int rows, void* stream) {
  if (B < 1 || T < 1 || S < 1 || d < 1 || d > 128 || Hkv < 1 ||
      H % Hkv != 0 || window < 0 || rows != kRows || Hkv > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                 (uintptr_t)dout) % 16 == 0;
  const Args a{q, k, v, dout, lse, delta, kv_mask, dk, dv, H, Hkv, T, S, d,
               sm_scale, causal, window, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    default: return launch<128>(a, B, st);
  }
}

// The threads, shared-memory bytes and streamed Q-tile rows of a block at
// key tile `rows` and head dim d, for holding `flash_bwd_plan`'s
// "dkv_bf16" figures to the kernel's (host code: no device needed);
// cudaErrorInvalidValue where the entry refuses them.
extern "C" int paddle_flash_bwd_dkv_bf16_layout(int rows, int d, int* threads,
                                                int* smem, int* tile) {
  if (rows != kRows || d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  *threads = kWarps * 32;
  *smem = (int)smem_bytes(padded_dim(d));
  *tile = kTileQ;
  return 0;
}
