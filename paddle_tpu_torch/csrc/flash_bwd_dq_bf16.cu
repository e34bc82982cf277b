// flash_bwd_dq_bf16: B3's bf16 entry (dQ of the mixed-precision train
// step's attention) on Hopper's bf16 tensor cores, for sm_90a.
//
// Replaces the TPU kernel `_flash_bwd_dq_kernel` on bf16 tiles
// (paddle_tpu/kernels/flash_attention.py:376, driven by
// `_flash_backward` :437), with the float32 entry's contract
// (csrc/flash_bwd.cu): q and dO [B,H,T,d], k/v [B,H/g,S,d] bf16 (query
// head h reads kv head h / g), an optional [B,S] float32 key-validity
// mask, causal and sliding-window visibility, lse and delta = rowsum(dO
// O) [B,H,T] float32 (delta from the wrapper); dQ [B,H,T,d] bf16,
// rounded once at the store. Per pair (query i, key j):
//   s = (q_i . k_j) * sm_scale,  p = valid ? exp(s - lse_i) : 0,
//   dp = dO_i . v_j,             ds = p * (dp - delta_i) * sm_scale,
//   dQ_i += ds k_j,
// `valid` as in flash_bwd.cu, so a row that saw no key (lse <= -1e29)
// writes exactly 0.
//
// The TPU kernel upcasts every bf16 tile and computes in float32, dS
// kept in float32 (flash_attention.py:394-424). A product of two bf16
// values is exact in float32, so S = Q K^T and dP = dO V^T are one bf16
// tensor-core product each with float32 accumulators; dS is float32 and
// goes into dQ += dS K split into bf16 hi + lo (two products, about 16
// bits: mma_bf16.cuh).
//
// What bounds it on this card: at the train shapes a key tile does 8
// flops a visible pair and head-dim column (S 2, dP 2, dQ 4 with the
// split) over about 2 bytes a value moved: bf16 tensor-core work that
// mma.sync reaches only in part, behind the exponentials, splits and
// shared-memory fragment reads around it. The entry it replaces widened
// every tile to float32 and ran split-TF32 m16n8k8 products (half the
// bf16 rate, half the depth a step), from float32 tiles that doubled its
// staging bytes, with one buffer of K and V.
//
// What the design does about it:
// - Grid: one block per (64 query rows, head, batch), 4 warps of 16
//   rows, looping over the key tiles of its kv head: every sum stays in
//   the block, so no atomics and dQ is deterministic. The kernel is bound
//   by latency more than by any one unit, so it is shaped for blocks an
//   SM: at d <= 64 the launch bounds hold it to the registers of
//   kBlocksPerSm.
// - Tiles are bf16 in shared memory: Q and dO resident (copied once),
//   K, V and the key-mask entries of kTileK keys double-buffered with
//   cp.async, so tile j + 1's copy overlaps tile j's products. Q and dO
//   come through ldmatrix (A operands) anew for each tile rather than
//   held in registers, which leaves the registers of 4 blocks an SM
//   without spills; K and V come through ldmatrix (n-major B operands)
//   for S and dP, and K through ldmatrix.trans (k-major B) for dQ.
// - dS is computed in place on the dP accumulators (P on the S ones) and
//   feeds dQ from registers (no shared memory, no permutation).
// - Skipping: key tiles above the causal diagonal or outside the window,
//   a key tile whose key-mask entries are all 0 (a block vote, which also
//   leaves its entries in shared memory for the masking), a warp whose
//   16 rows are all dead, and inside a tile each warp's 16-key chunks
//   with no visible pair (above the diagonal, outside the window, all
//   keys masked) by a warp vote, in all three products.
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
constexpr int kWarps = 4, kRows = 16 * kWarps;  // a block's query rows
constexpr int kStages = 2;  // buffers of the streamed K/V tiles

// keys of a streamed K/V tile, and the blocks an SM the launch bounds
// aim at for d <= 64: on an H100, 32-key tiles at 4 blocks (Q and dO
// fragments read anew each tile) ran faster than at 3 blocks with the
// fragments held in registers, and than 64-key tiles at 2 or 3 blocks
constexpr int kTileK = 32;
constexpr int kBlocksPerSm = 4;

// shared bytes of a block: resident Q and dO, then each buffer's K and V
// tiles and their key-mask entries
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)row_stride(dp) *
             (2 * kRows + kStages * 2 * kTileK) +
         sizeof(float) * kStages * kTileK;
}

struct Args {
  const bf16 *q, *k, *v, *dout;
  const float *lse, *delta, *kv_mask;
  bf16* dq;
  int H, Hkv, T, S, d;
  float sm_scale;
  int causal, window, vec;
};

// DP: the padded head dim; kBlocksPerSm blocks an SM at DP <= 64
template <int DP>
__global__ void __launch_bounds__(kWarps * 32, DP <= 64 ? kBlocksPerSm : 1)
flash_bwd_dq_bf16_kernel(const Args a) {
  constexpr int NT = kWarps * 32, LD = row_stride(DP);
  constexpr int KS = DP / 16;      // k16 steps of S and dP
  constexpr int ND = DP / 8;       // 8-column tiles of dQ
  constexpr int KC = kTileK / 16;  // 16-key chunks of a tile
  constexpr int NK = kTileK / 8;   // 8-key tiles of S and dP
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);  // [kRows][LD]
  bf16* do_s = q_s + kRows * LD;                 // [kRows][LD]
  bf16* kv_s = do_s + kRows * LD;  // [kStages][K, V][kTileK][LD]
  float* ok_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTileK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_base = blockIdx.x * kRows, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, S = a.S, d = a.d;
  const size_t bh = (size_t)b * a.H + h;
  const size_t bhk = (size_t)b * a.Hkv + h / (a.H / a.Hkv);
  const bf16* k_bh = a.k + bhk * S * d;
  const bf16* v_bh = a.v + bhk * S * d;
  const float* mask_b = a.kv_mask ? a.kv_mask + (size_t)b * S : nullptr;

  // this lane's two rows (accumulator rows g and g + 8 of its warp): the
  // exponent's -lse log2 e, -inf for a row past T or dead
  const int r0 = q_base + warp * 16;
  const int row[2] = {r0 + gid, r0 + gid + 8};
  float nl[2], delta[2];
  bool row_ok[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const bool in = row[r] < T;
    const float lse = in ? a.lse[bh * T + row[r]] : 0.f;
    delta[r] = in ? a.delta[bh * T + row[r]] : 0.f;
    row_ok[r] = in && lse > kMaskedRowLse;
    nl[r] = row_ok[r] ? -lse * kLog2e : -INFINITY;
  }
  const bool warp_live = __any_sync(0xffffffffu, row_ok[0] || row_ok[1]);
  const bool block_live = __syncthreads_or(warp_live);
  const float scale2 = a.sm_scale * kLog2e;

  const int q_last = q_base + kRows - 1;
  const int n_tiles = (S + kTileK - 1) / kTileK;
  // a key-mask entry of tile t for thread tid < kTileK (keys past S: 0);
  // the entry of the tile after the last one chosen is loaded ahead
  // (`pre`), so the vote over it does not wait on device memory
  auto mask_of = [&](int t) {
    const int s = t * kTileK + tid;
    return tid < kTileK && s < S ? mask_b[s] : 0.f;
  };
  int pre_tile = -1;
  float pre = 0.f;
  // the next tile at or after `tile` that a row of the block sees: the
  // causal and window tests, then a block vote over its key-mask entries,
  // which stay in buffer `slot`'s flags. Uniform: every thread walks the
  // same tiles.
  auto next_tile = [&](int tile, int slot) {
    for (; tile < n_tiles; ++tile) {
      const int kb = tile * kTileK;
      if (a.causal && kb > q_last) return n_tiles;
      if (a.window) {
        if (kb + kTileK - 1 <= q_base - a.window) continue;
        if (!a.causal && kb - q_last >= a.window) return n_tiles;
      }
      if (!mask_b) return tile;
      const bool ok = (tile == pre_tile ? pre : mask_of(tile)) > 0.f;
      if (tid < kTileK) ok_s[slot * kTileK + tid] = ok ? 1.f : 0.f;
      if (__syncthreads_or(ok)) {
        if (tile + 1 < n_tiles) {
          pre_tile = tile + 1;
          pre = mask_of(tile + 1);
        }
        return tile;
      }
    }
    return n_tiles;
  };
  auto load_kv = [&](int tile, int slot) {
    bf16* kt = kv_s + slot * 2 * kTileK * LD;
    load_rows<NT, DP>(kt, k_bh, tile * kTileK, kTileK, S, d, a.vec);
    load_rows<NT, DP>(kt + kTileK * LD, v_bh, tile * kTileK, kTileK, S, d,
                      a.vec);
    cp_async_commit();
  };

  float dq[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) dq[n][e] = 0.f;

  // the ring: ring[s] is the tile in buffer s (n_tiles: none); `fetch`
  // the next tile to copy, whose mask flags sit in the buffer it goes to.
  // Every step commits one copy group, empty or not, so waiting for all
  // but kStages - 1 groups waits for the current tile.
  int ring[kStages];
  int fetch = block_live ? next_tile(0, 0) : n_tiles;
  if (fetch < n_tiles) {  // Q and dO join the first K/V tile's group
    load_rows<NT, DP>(q_s, a.q + bh * T * d, q_base, kRows, T, d, a.vec);
    load_rows<NT, DP>(do_s, a.dout + bh * T * d, q_base, kRows, T, d, a.vec);
  }
#pragma unroll
  for (int st = 0; st < kStages - 1; ++st) {
    ring[st] = fetch;
    if (fetch < n_tiles) {
      load_kv(fetch, st);
      fetch = next_tile(fetch + 1, st + 1);
    } else {
      cp_async_commit();
    }
  }
  for (int it = 0;; ++it) {
    const int buf = it % kStages;
    const int tile = ring[buf];
    if (tile >= n_tiles) break;
    const int put = (it + kStages - 1) % kStages;
    ring[put] = fetch;
    if (fetch < n_tiles)
      load_kv(fetch, put);
    else
      cp_async_commit();
    cp_async_wait<kStages - 1>();
    __syncthreads();  // tile `tile` (and Q, dO) landed
    const int kb = tile * kTileK;
    if (warp_live) {
      const bf16* kt = kv_s + buf * 2 * kTileK * LD;
      const bf16* vt = kt + kTileK * LD;
      const float* okt = ok_s + buf * kTileK;
      // each lane's key flags: keys 2t, 2t + 1 of each 8-key tile (a
      // masked key or one past S: -inf in the exponent)
      float kadd[NK][2];
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int key0 = kb + 8 * j + 2 * tig;
        if (mask_b) {
          const float2 f =
              *reinterpret_cast<const float2*>(okt + 8 * j + 2 * tig);
          kadd[j][0] = f.x > 0.f ? 0.f : -INFINITY;
          kadd[j][1] = f.y > 0.f ? 0.f : -INFINITY;
        } else {
          kadd[j][0] = key0 < S ? 0.f : -INFINITY;
          kadd[j][1] = key0 + 1 < S ? 0.f : -INFINITY;
        }
      }
      // the 16-key chunks with a visible pair for this warp
      bool live[KC];
      bool any = false;
#pragma unroll
      for (int c = 0; c < KC; ++c) {
        const int k0 = kb + 16 * c;
        const bool keys =
            kadd[2 * c][0] == 0.f || kadd[2 * c][1] == 0.f ||
            kadd[2 * c + 1][0] == 0.f || kadd[2 * c + 1][1] == 0.f;
        live[c] = __any_sync(0xffffffffu, keys) &&
                  ranges_meet(r0, r0 + 15, k0, k0 + 15, a.causal, a.window);
        any = any || live[c];
      }
      if (any) {
        // S = Q K^T and dP = dO V^T: this warp's 16 rows x kTileK keys
        float s[NK][4], dp[NK][4];
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e) s[j][e] = dp[j][e] = 0.f;
#pragma unroll
        for (int kk = 0; kk < KS; ++kk) {
          uint32_t qf[4], df[4];
          ldsm_x4(qf, x4_addr<LD>(q_s, warp * 16, 16 * kk, lane));
          ldsm_x4(df, x4_addr<LD>(do_s, warp * 16, 16 * kk, lane));
#pragma unroll
          for (int c = 0; c < KC; ++c) {
            if (!live[c]) continue;
            uint32_t kb4[4], vb4[4];
            ldsm_x4(kb4, x4_addr<LD>(kt, 16 * c, 16 * kk, lane));
            ldsm_x4(vb4, x4_addr<LD>(vt, 16 * c, 16 * kk, lane));
            mma(s[2 * c], qf, kb4[0], kb4[2]);
            mma(s[2 * c + 1], qf, kb4[1], kb4[3]);
            mma(dp[2 * c], df, vb4[0], vb4[2]);
            mma(dp[2 * c + 1], df, vb4[1], vb4[3]);
          }
        }
        // dS in place: p = 2^(s sm_scale log2 e - lse log2 e), the
        // exponent -inf (p = 0) for a dead row or one past T (nl), a
        // masked key (kadd) and, where the chunk crosses the causal
        // diagonal or the window, a pair outside them
#pragma unroll
        for (int j = 0; j < NK; ++j) {
          if (!live[j >> 1]) continue;
          const int k0 = kb + 16 * (j >> 1);
          const bool edge = !ranges_inside(r0, r0 + 15, k0, k0 + 15,
                                           a.causal, a.window);
          const int key0 = kb + 8 * j + 2 * tig;
#pragma unroll
          for (int e = 0; e < 4; ++e) {
            float x = fmaf(s[j][e], scale2, nl[e >> 1]) + kadd[j][e & 1];
            if (edge && !pair_visible(row[e >> 1], key0 + (e & 1), a.causal,
                                      a.window))
              x = -INFINITY;
            const float p = ex2(x);
            dp[j][e] = p * (dp[j][e] - delta[e >> 1]) * a.sm_scale;
          }
        }
        // dQ += dS K, 16 keys a step, dS split hi + lo
#pragma unroll
        for (int c = 0; c < KC; ++c) {
          if (!live[c]) continue;
          const FragA sf = frag_acc(dp[2 * c], dp[2 * c + 1]);
#pragma unroll
          for (int nn = 0; nn < ND / 2; ++nn) {
            uint32_t kb4[4];
            ldsm_x4_trans(kb4, x4_addr<LD>(kt, 16 * c, 16 * nn, lane));
            mma(dq[2 * nn], sf.hi, kb4[0], kb4[1]);
            mma(dq[2 * nn + 1], sf.hi, kb4[2], kb4[3]);
            mma(dq[2 * nn], sf.lo, kb4[0], kb4[1]);
            mma(dq[2 * nn + 1], sf.lo, kb4[2], kb4[3]);
          }
        }
      }
    }
    __syncthreads();  // done with this buffer
    // the tile after `fetch` goes where this one was: its flags too
    if (fetch < n_tiles) fetch = next_tile(fetch + 1, buf);
  }
  cp_async_wait<0>();

  // rows g, g + 8 and columns 2t, 2t + 1 of each 16 x 8 tile; a dead
  // row's accumulators took only exact zeros
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    if (row[r] >= T) continue;
    bf16* dq_row = a.dq + (bh * T + row[r]) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store_pair(dq_row, 8 * n + 2 * tig, d, dq[n][2 * r], dq[n][2 * r + 1]);
  }
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t st) {
  auto kernel = flash_bwd_dq_bf16_kernel<DP>;
  const size_t smem = smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((a.T + kRows - 1) / kRows, a.H, B), kWarps * 32, smem, st>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v, dout and dq bf16; lse, delta and kv_mask (may be null)
// float32; the arguments of paddle_flash_bwd_dq_f32 (csrc/flash_bwd.cu),
// launched on `stream`, returning cudaGetLastError() (0 on success).
// `rows` is the launch plan's query tile (kernels/flash_attention.py
// `flash_bwd_plan`, "dq_bf16"): 64, the one the kernel takes. dq is
// [B,H,T,d]; every element is written.
extern "C" int paddle_flash_bwd_dq_bf16(
    const bf16* q, const bf16* k, const bf16* v, const bf16* dout,
    const float* lse, const float* delta, const float* kv_mask, bf16* dq,
    int B, int H, int Hkv, int T, int S, int d, float sm_scale, int causal,
    int window, int rows, void* stream) {
  if (B < 1 || T < 1 || S < 1 || d < 1 || d > 128 || Hkv < 1 ||
      H % Hkv != 0 || window < 0 || rows != kRows || H > 65535 ||
      B > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                 (uintptr_t)dout) % 16 == 0;
  const Args a{q, k, v, dout, lse, delta, kv_mask, dq, H, Hkv, T, S, d,
               sm_scale, causal, window, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (padded_dim(d)) {
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    default: return launch<128>(a, B, st);
  }
}

// The threads, shared-memory bytes and streamed K/V-tile keys of a block
// at query tile `rows` and head dim d, for holding `flash_bwd_plan`'s
// "dq_bf16" figures to the kernel's (host code: no device needed);
// cudaErrorInvalidValue where the entry refuses them.
extern "C" int paddle_flash_bwd_dq_bf16_layout(int rows, int d, int* threads,
                                               int* smem, int* tile) {
  if (rows != kRows || d < 1 || d > 128) return (int)cudaErrorInvalidValue;
  *threads = kWarps * 32;
  *smem = (int)smem_bytes(padded_dim(d));
  *tile = kTileK;
  return 0;
}
