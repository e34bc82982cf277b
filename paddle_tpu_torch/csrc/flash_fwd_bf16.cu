// flash_fwd_bf16: B1's bf16 entry (the mixed-precision train step's
// attention forward, T > 4) on Hopper's bf16 tensor cores, for sm_90a.
//
// Replaces the TPU kernel `_flash_kernel` on bf16 tiles
// (paddle_tpu/kernels/flash_attention.py:91, driven by `_flash_forward`
// :189), with the float32 entry's contract (csrc/flash_fwd.cu): q
// [B,H,T,d], k/v [B,H/g,S,d] bf16 (query head h reads kv head h / g), an
// optional [B,S] float32 key-validity mask (1 keeps), causal and
// sliding-window visibility; o [B,H,T,d] bf16, rounded once at the store;
// the LSE [B,H,T] float32. A row with no visible key writes exactly 0
// with its LSE at or below -1e29.
//
// The TPU kernel upcasts every bf16 tile to float32 and takes both
// products in float32, P kept in float32 (flash_attention.py:113-118,
// 147). A product of two bf16 values is exact in float32, so Q K^T runs
// as one bf16 tensor-core product with float32 accumulators and stays
// that function up to the order of summation; P is float32 and goes into
// P V split into bf16 hi + lo (two products, about 16 bits of P:
// mma_bf16.cuh), so the result is within a small fraction of one bf16
// rounding step of the plain version's.
//
// What bounds it on this card: at the train shapes ([64,8,256,64], T =
// S = 256) a (query tile, head) does 6 flops a visible pair and head-dim
// column (Q K^T 2, P V twice 2) over about 2 bytes a value moved, below
// the bf16 ridge (989 TFLOP/s over 3.35 TB/s): bound by bytes in
// principle, by latency in practice, since a block's key loop is only 4
// tiles long. The float32-widening entry it replaces ran every product
// as SIMT FMAs at about a quarter of the 67 TFLOP/s float32 rate.
//
// What the design does about it:
// - One block per (64 query rows, head, batch), 16 rows a warp
//   (`flash_bf16_plan` in kernels/flash_attention.py; the wrapper passes
//   `block_q`). 128-row blocks of 8 warps ran slower at the train shapes:
//   at 140 to 220 registers a thread one such block fills an SM's
//   registers. The Q tile is copied once and held in registers as bf16 A
//   fragments;
//   sm_scale is applied to the float32 score, not folded into bf16 Q
//   (that would round Q).
// - K/V tiles of 64 keys, bf16, double-buffered with cp.async: tile
//   j + 1's copy overlaps tile j's products.
// - S = Q K^T: per warp 16 rows x 64 keys, K through ldmatrix (n-major B
//   operand). The online softmax runs in the exp2 domain on the
//   accumulator fragments (scores times sm_scale log2 e): the row max
//   and the sums by quad shuffles, nothing through shared memory; each
//   lane keeps its own partial sum (alpha is uniform over a row) and the
//   quad adds them at the end. O += P V from those registers (P split hi
//   + lo), V through ldmatrix.trans (k-major B operand).
// - Skipping, as the float32 entry: tiles above the causal diagonal or
//   outside the window, and a tile whose key-mask entries are all 0 (a
//   block vote, which also leaves the tile's entries in shared memory for
//   the masking); a warp whose 16 rows see none of a tile by position
//   skips its products. Inside a tile a hidden pair's score is -inf: a
//   masked key (or one past S) by an additive -inf per key, and a pair
//   outside the causal diagonal or the window by a position test, made
//   only where the warp's rows and the tile's keys cross those lines.
//   The running max starts at -1e30 (finite), so a row that sees no key
//   keeps it, weighs nothing and writes 0. exp2 is the SFU's ex2.approx.
// - The head dim is padded with zero columns to 32, 64 or 128 (whole
//   k16 steps), so the inner loops have no bound to test.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "mma_bf16.cuh"

using namespace mma16;

namespace {

constexpr int kMaxD = 128;
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowLse = -1e29f;
constexpr float kLog2e = 1.44269504f;
constexpr float kLn2 = 0.693147181f;
constexpr int kWarps = 4, kRows = 16 * kWarps;  // a block's query rows
constexpr int kTileK = 64;   // keys of a K/V tile
constexpr int kStages = 2;   // K/V buffers

// shared bytes of a block at padded head dim dp: the Q tile, the K and V
// tiles of each buffer, and each buffer's key-mask entries
__host__ __device__ constexpr size_t smem_bytes(int dp) {
  return sizeof(bf16) * (size_t)row_stride(dp) *
             (kRows + kStages * 2 * kTileK) +
         sizeof(float) * kStages * kTileK;
}

struct Args {
  const bf16 *q, *k, *v;
  const float* kv_mask;
  bf16* o;
  float* lse;
  int H, Hkv, T, S, d;
  float scale2;  // sm_scale * log2(e): scores in the exp2 domain
  int causal, window, vec;
};

template <int DP>
__global__ void __launch_bounds__(kWarps * 32)
flash_fwd_bf16_kernel(const Args a) {
  constexpr int NT = kWarps * 32, BQ = kRows, LD = row_stride(DP);
  constexpr int KS = DP / 16;      // k16 steps of Q K^T
  constexpr int ND = DP / 8;       // 8-column tiles of O
  constexpr int NK = kTileK / 8;   // 8-key tiles of S
  extern __shared__ uint4 smem_u4[];
  bf16* q_s = reinterpret_cast<bf16*>(smem_u4);  // [BQ][LD]
  bf16* kv_s = q_s + BQ * LD;  // [kStages][K, V][kTileK][LD]
  float* ok_s = reinterpret_cast<float*>(kv_s + kStages * 2 * kTileK * LD);

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int gid = lane >> 2, tig = lane & 3;
  const int q_base = blockIdx.x * BQ, h = blockIdx.y, b = blockIdx.z;
  const int T = a.T, S = a.S, d = a.d;
  const int hk = h / (a.H / a.Hkv);
  const size_t bh = (size_t)b * a.H + h;
  const bf16* k_bh = a.k + ((size_t)b * a.Hkv + hk) * S * d;
  const bf16* v_bh = a.v + ((size_t)b * a.Hkv + hk) * S * d;
  const float* mask_b = a.kv_mask ? a.kv_mask + (size_t)b * S : nullptr;

  const int q_last = q_base + BQ - 1;
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
  // causal and window tests of flash_attention.py:151-167, then a block
  // vote over its key-mask entries, which stay in buffer `slot`'s flags.
  // Uniform: every thread walks the same tiles.
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

  // this lane's two rows (accumulator rows g and g + 8 of its warp)
  const int r0 = q_base + warp * 16;
  const int row[2] = {r0 + gid, r0 + gid + 8};
  uint32_t qf[KS][4];
  float o[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int e = 0; e < 4; ++e) o[n][e] = 0.f;
  float m[2] = {kNegInf, kNegInf}, l[2] = {0.f, 0.f};

  // the ring: ring[s] is the tile in buffer s (n_tiles: none); `fetch`
  // the next tile to copy, whose mask flags sit in the buffer it goes to.
  // Every step commits one copy group, empty or not, so waiting for all
  // but kStages - 1 groups waits for the current tile.
  int ring[kStages];
  int fetch = next_tile(0, 0);
  if (fetch < n_tiles)  // the Q tile joins the first K/V tile's group
    load_rows<NT, DP>(q_s, a.q + bh * T * d, q_base, BQ, T, d, a.vec);
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
  bool first = true;
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
    __syncthreads();  // tile `tile` (and the Q tile) landed
    if (first) {
#pragma unroll
      for (int kk = 0; kk < KS; ++kk)
        ldsm_x4(qf[kk], x4_addr<LD>(q_s, warp * 16, 16 * kk, lane));
      first = false;
    }
    const int kb = tile * kTileK;
    if (ranges_meet(r0, r0 + 15, kb, kb + kTileK - 1, a.causal, a.window)) {
      const bf16* kt = kv_s + buf * 2 * kTileK * LD;
      const bf16* vt = kt + kTileK * LD;
      const float* okt = ok_s + buf * kTileK;
      // S = Q K^T: 16 rows x 64 keys
      float s[NK][4];
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) s[j][e] = 0.f;
#pragma unroll
      for (int kk = 0; kk < KS; ++kk) {
#pragma unroll
        for (int np = 0; np < NK / 2; ++np) {
          uint32_t r[4];
          ldsm_x4(r, x4_addr<LD>(kt, 16 * np, 16 * kk, lane));
          mma(s[2 * np], qf[kk], r[0], r[2]);
          mma(s[2 * np + 1], qf[kk], r[1], r[3]);
        }
      }
      // the exp2-domain scores: a masked key (or one past S) adds -inf;
      // a pair outside the causal diagonal or the window is -inf too,
      // tested only where the tile crosses them
#pragma unroll
      for (int j = 0; j < NK; ++j) {
        const int key0 = kb + 8 * j + 2 * tig;
        float add[2];
        if (mask_b) {
          const float2 f =
              *reinterpret_cast<const float2*>(okt + 8 * j + 2 * tig);
          add[0] = f.x > 0.f ? 0.f : -INFINITY;
          add[1] = f.y > 0.f ? 0.f : -INFINITY;
        } else {
          add[0] = key0 < S ? 0.f : -INFINITY;
          add[1] = key0 + 1 < S ? 0.f : -INFINITY;
        }
#pragma unroll
        for (int e = 0; e < 4; ++e)
          s[j][e] = fmaf(s[j][e], a.scale2, add[e & 1]);
      }
      if (!ranges_inside(r0, r0 + 15, kb, kb + kTileK - 1, a.causal,
                         a.window)) {
#pragma unroll
        for (int j = 0; j < NK; ++j)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            if (!pair_visible(row[e >> 1], kb + 8 * j + 2 * tig + (e & 1),
                              a.causal, a.window))
              s[j][e] = -INFINITY;
      }
      float mx[2] = {kNegInf, kNegInf};
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) mx[e >> 1] = fmaxf(mx[e >> 1], s[j][e]);
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        const float m_new = fmaxf(m[r], mx[r]);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
        l[r] *= alpha[r];
      }
#pragma unroll
      for (int j = 0; j < NK; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float p = ex2(s[j][e] - m[e >> 1]);
          s[j][e] = p;
          l[e >> 1] += p;
        }
#pragma unroll
      for (int n = 0; n < ND; ++n) {
        o[n][0] *= alpha[0];
        o[n][1] *= alpha[0];
        o[n][2] *= alpha[1];
        o[n][3] *= alpha[1];
      }
      // O += P V, 16 keys a step, P split hi + lo
#pragma unroll
      for (int kq = 0; kq < NK / 2; ++kq) {
        const FragA pf = frag_acc(s[2 * kq], s[2 * kq + 1]);
#pragma unroll
        for (int nn = 0; nn < ND / 2; ++nn) {
          uint32_t r[4];
          ldsm_x4_trans(r, x4_addr<LD>(vt, 16 * kq, 16 * nn, lane));
          mma(o[2 * nn], pf.hi, r[0], r[1]);
          mma(o[2 * nn + 1], pf.hi, r[2], r[3]);
          mma(o[2 * nn], pf.lo, r[0], r[1]);
          mma(o[2 * nn + 1], pf.lo, r[2], r[3]);
        }
      }
    }
    __syncthreads();  // done with this buffer
    // the tile after `fetch` goes where this one was: its flags too
    if (fetch < n_tiles) fetch = next_tile(fetch + 1, buf);
  }
  cp_async_wait<0>();

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
    l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
    if (row[r] >= T) continue;
    const bool dead = m[r] <= kMaskedRowLse;
    const float denom = fmaxf(l[r], 1e-30f);
    bf16* o_row = a.o + (bh * T + row[r]) * d;
#pragma unroll
    for (int n = 0; n < ND; ++n)
      store_pair(o_row, 8 * n + 2 * tig, d,
                 dead ? 0.f : o[n][2 * r] / denom,
                 dead ? 0.f : o[n][2 * r + 1] / denom);
    if (tig == 0) a.lse[bh * T + row[r]] = m[r] * kLn2 + logf(denom);
  }
}

template <int DP>
int launch(const Args& a, int B, cudaStream_t st) {
  auto kernel = flash_fwd_bf16_kernel<DP>;
  const size_t smem = smem_bytes(DP);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3((a.T + kRows - 1) / kRows, a.H, B), kWarps * 32, smem, st>>>(
      a);
  return (int)cudaGetLastError();
}

}  // namespace

// q, k, v and o bf16, kv_mask (may be null) and lse float32; the
// arguments of paddle_flash_fwd_f32 (csrc/flash_fwd.cu), launched on
// `stream`, returning cudaGetLastError() (0 on success). block_q is the
// launch plan's query tile (kernels/flash_attention.py
// `flash_bf16_plan`): 64, the one the kernel takes. part, splits and kps
// belong to the float32 entry's rows path and are ignored.
extern "C" int paddle_flash_fwd_bf16(const bf16* q, const bf16* k,
                                     const bf16* v, const float* kv_mask,
                                     bf16* o, float* lse, float* part, int B,
                                     int H, int Hkv, int T, int S, int d,
                                     float sm_scale, int causal, int window,
                                     int block_q, int splits, int kps,
                                     void* stream) {
  (void)part;
  (void)splits;
  (void)kps;
  if (B < 1 || T < 1 || S < 0 || d < 1 || d > kMaxD || Hkv < 1 ||
      H % Hkv != 0 || window < 0 || H > 65535 || B > 65535)
    return (int)cudaErrorInvalidValue;
  const int vec = d % 8 == 0 &&
                  ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v) % 16 == 0;
  const Args a{q, k, v, kv_mask, o, lse, H, Hkv, T, S, d,
               sm_scale * kLog2e, causal, window, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q != kRows) return (int)cudaErrorInvalidValue;
  switch (padded_dim(d)) {
    case 32: return launch<32>(a, B, st);
    case 64: return launch<64>(a, B, st);
    default: return launch<128>(a, B, st);
  }
}

// The threads and shared-memory bytes of a block at query tile block_q
// and head dim d, for holding `flash_bf16_plan`'s figures to the
// kernel's (host code: no device needed); cudaErrorInvalidValue where
// the entry refuses them.
extern "C" int paddle_flash_fwd_bf16_layout(int block_q, int d, int* threads,
                                            int* smem) {
  if (block_q != kRows || d < 1 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  *threads = kWarps * 32;
  *smem = (int)smem_bytes(padded_dim(d));
  return 0;
}
