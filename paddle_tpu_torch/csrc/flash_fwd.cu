// flash_fwd: blocked online-softmax attention forward, fp32, for sm_90a.
//
// Replaces the TPU kernel `_flash_kernel` (paddle_tpu/kernels/
// flash_attention.py:91, driven by `_flash_forward` :189). Same contract:
// q [B,H,T,d], k/v [B,H/g,S,d] (query head h reads kv head h / g), an
// optional [B,S] key-validity mask (1 keeps), causal and sliding-window
// visibility, a per-row log-sum-exp, and a row with no visible key
// writes exactly 0 with its LSE at or below -1e29. Tiles above the
// causal diagonal or outside the window are skipped by the same tests as
// flash_attention.py:151-167.
//
// What bounds it on this card: the decode call is memory-bound. Decode
// cross-attention reads each slot's whole [S,d] K and V for ONE query row
// (T=1): 8*S*d bytes per (slot, head) against 4*S*d flops, half a flop
// per byte, far below the fp32 ridge (67 TFLOP/s over 3.35 TB/s is 20
// flops per byte). The encoder and training calls (T=S=256, d=64) do about
// 64 flops per byte moved and are bound by fp32 FMA issue instead: this
// kernel runs on the CUDA cores (TF32 is off, so no tensor cores).
//
// What the design does about it: one block per (query tile, head, batch)
// keeps K/V tiles in shared memory and shares them across every query row
// of the tile; scores, the running max, sum and output accumulator stay
// in registers, so the [T,S] score matrix never exists in device memory.
// The tile path is chosen by `flash_plan` (kernels/flash_attention.py)
// and passed in as `block_q`:
//
// - block_q 4 (T <= 4: decode and verify cross-attention): the split-KV
//   core of decode_split.cuh, shared with tree_decode.cu (B5; B4's
//   paged_decode.cu takes its copies and merge). These calls read a slot's K and V once for 1 to
//   4 query rows, so they are bound by the bytes of the keys some row
//   sees. The grid is (split, head, batch); a split covers
//   `keys_per_split` keys (a multiple of 32) that `flash_rows_plan`
//   chooses from static shapes only: the key mask is never read on the
//   host, so a CUDA graph holds the call. A block stages 32-key chunks
//   through a three-buffer cp.async ring and scores each once for all T
//   rows (8 lanes a key, float4 slices). The key-mask entries of its
//   first 8 chunks are loaded at once, ahead of the first copy; every
//   warp takes the same ballot of a chunk's entries, and a chunk is
//   skipped where no row sees any of its keys (wholly masked, above the
//   causal diagonal or outside the window); of a chunk it computes, only
//   the rows of keys some row sees are copied. So decode copies the
//   valid keys only. Each row keeps an exp2-domain online softmax in
//   which a hidden key gives p = 0; several splits' partials go through
//   the core's merge kernel, which also writes the LSE (M ln 2 + ln L,
//   back in the natural-log domain). Where it stands (NVIDIA H100 at
//   700 W, chip_smoke.py): about 0.014 ms at decode and 0.018 at verify
//   ([32,8,1|4,64] over 256 keys, the serving mix of source lengths),
//   two to three times the byte bound; at one split a block per (slot,
//   head), the longest slots set the time, on top of the launch and
//   first-copy latency.
// - block_q 64 (T > 4), or 32 where 64-row tiles would leave SMs idle
//   (B * H * ceil(T / 64) below the SM count, as at the encoder shape):
//   the register-blocked kernel below. 16 threads share 4 query rows; a
//   thread owns a 4 rows x 4 keys micro-tile of S = Q K^T (keys 16 apart)
//   and a 4 rows x 4 (or 8) columns micro-tile of the output. Operands
//   come as float4 shared-memory loads feeding outer-product FMAs: 8 loads
//   per 64 FMAs. K and V tiles of 64 keys are double-buffered with
//   cp.async (16 bytes per thread where d % 4 == 0), so tile j+1's copy
//   overlaps tile j's arithmetic. The online-softmax max is reduced over
//   the row's 16 lanes with shuffles; each thread keeps its own partial
//   sum (alpha is uniform over a row) and the lanes add them at the end.
//   P goes through shared memory to the P V product. Tiles above the
//   causal diagonal or outside the window are skipped, and so is a tile
//   whose key-mask entries are all 0 (a block-wide vote): a row that sees
//   a valid key later wipes masked weights with alpha = exp(-1e30 - m) =
//   0, and a row that sees none writes 0 with its LSE at or below -1e29,
//   so the results equal those of computing every tile. Split-TF32
//   tensor-core products are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "decode_split.cuh"

namespace {

constexpr int kMaxD = 128;       // largest head dim the kernel takes
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowLse = -1e29f;

// -- the rows path (block_q 4: T <= 4) ----------------------------------------

constexpr int kRowsBlockQ = 4;
// chunks whose key mask a block loads first: chosen from trial timings on
// an H100 that no script in the repository repeats (not measured by
// chip_smoke.py)
constexpr int kWindow = 8;

struct RowsArgs {
  const float* q;
  const float* k;
  const float* v;
  const float* kv_mask;
  float* o;
  float* lse;
  float* part;  // the partials (decode_split.cuh), T rows a (batch, head)
  int B, H, Hkv, T, S, d, causal, window, splits, kps;
  float scale2;  // sm_scale * log2(e): scores in the exp2 domain
  int vec;
};

// R (1, 2 or 4): rows the block carries; rows T.. R - 1 see no key. NQ:
// query quads a score lane keeps (dsplit::quads_for(d)).
template <int R, int NQ>
__global__ void __launch_bounds__(dsplit::kThreads)
flash_fwd_rows_kernel(RowsArgs a) {
  using namespace dsplit;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout_of(a.d, R, kRowsStages);
  const int d = a.d, dhp = L.dhp;
  const int sp = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31;
  const int hk = h / (a.H / a.Hkv);
  const size_t unit = (size_t)b * a.H + h;
  const float* k_bh = a.k + ((size_t)b * a.Hkv + hk) * a.S * d;
  const float* v_bh = a.v + ((size_t)b * a.Hkv + hk) * a.S * d;
  const float* mask_b = a.kv_mask ? a.kv_mask + (size_t)b * a.S : nullptr;

  // the keys row r sees by position, [lo, hi) (the causal and window
  // tests of flash_attention.py:151-167), and their union over the rows
  int lo[R], hi[R];
  int klo = a.S, khi = 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    lo[r] = 0;
    hi[r] = r < a.T ? a.S : 0;
    if (a.causal) hi[r] = min(hi[r], r + 1);
    if (a.window) {
      lo[r] = max(lo[r], r - a.window + 1);
      if (!a.causal) hi[r] = min(hi[r], r + a.window);
    }
    if (hi[r] > lo[r]) {
      klo = min(klo, lo[r]);
      khi = max(khi, hi[r]);
    }
  }
  const int kb0 = sp * a.kps;
  const int ke = min(a.S, kb0 + a.kps);
  const int n_chunks = (max(ke - kb0, 0) + kChunk - 1) / kChunk;

  // the split's keys that exist and are kept, chunk c's as a ballot (the
  // same in every warp: uniform, no barrier); the first kWindow chunks'
  // loads are all issued at once, ahead of the first copy
  auto ballot = [&](int c, float mv) {
    return __ballot_sync(0xffffffffu,
                         kb0 + c * kChunk + lane < ke && mv > 0.f);
  };
  auto mask_of = [&](int c) {
    const int key = kb0 + c * kChunk + lane;
    return mask_b && c < n_chunks && key < ke ? mask_b[key] : 1.f;
  };
  float window_mask[kWindow];
#pragma unroll
  for (int i = 0; i < kWindow; ++i) window_mask[i] = mask_of(i);
  unsigned window[kWindow];
#pragma unroll
  for (int i = 0; i < kWindow; ++i) window[i] = ballot(i, window_mask[i]);
  // the first chunk at or after c that some row sees a key of
  auto next = [&](int c, unsigned& bits) {
    for (; c < n_chunks; ++c) {
      const int kb = kb0 + c * kChunk;
      if (kb + kChunk <= klo) continue;
      if (kb >= khi) return n_chunks;
      unsigned mb = 0;
      if (c < kWindow) {
#pragma unroll
        for (int i = 0; i < kWindow; ++i) mb = i == c ? window[i] : mb;
      } else {
        mb = ballot(c, mask_of(c));
      }
      unsigned seen = 0;
#pragma unroll
      for (int r = 0; r < R; ++r) seen |= range_bits(lo[r] - kb, hi[r] - kb);
      if (mb & seen) {
        bits = mb & seen;
        return c;
      }
    }
    return n_chunks;
  };
  const int per_row = a.vec ? d / 4 : d;
  const int width = a.vec ? 4 : 1;
  // the chunk's rows of keys some row sees (bits): a masked key's K and
  // V are never read
  auto issue = [&](int c, int buf, unsigned bits) {
    const int kb = kb0 + c * kChunk;
    float* ks = smem + buf * L.stage;
    float* vs = ks + kChunk * dhp;
    for (int idx = tid; idx < kChunk * per_row; idx += kThreads) {
      const int r = idx / per_row, col = (idx - r * per_row) * width;
      if ((bits >> r) & 1u) {
        const size_t off = (size_t)(kb + r) * d + col;
        cp_async(ks + r * dhp + col, k_bh + off, a.vec);
        cp_async(vs + r * dhp + col, v_bh + off, a.vec);
      }
    }
  };
  auto vis = [&](int r, int j, int c) {
    const int key = kb0 + c * kChunk + j;
    return key >= lo[r] && key < hi[r];
  };

  zero_pads(smem, L, d);
  Rows<R, NQ> st;
  walk<kRowsStages>(st, smem, L, n_chunks, a.q + unit * a.T * d, a.T, d,
                    a.scale2, next, issue, vis);
  const size_t pr = (unit * a.splits + sp) * a.T;
  finish(st, smem, L, d, a.T, a.splits == 1 ? a.o + unit * a.T * d : nullptr,
         a.lse + unit * a.T, a.part + pr * d,
         a.part + (size_t)a.B * a.H * a.splits * a.T * d + 2 * pr);
}

template <int R>
int launch_rows(const RowsArgs& a, cudaStream_t st) {
  const int smem = (int)sizeof(float) *
                   dsplit::layout_of(a.d, R, dsplit::kRowsStages).floats;
  auto kernel = dsplit::quads_for(a.d) == 2
                    ? flash_fwd_rows_kernel<R, 2>
                    : flash_fwd_rows_kernel<R, dsplit::kMaxQuads>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(a.splits, a.H, a.B), dsplit::kThreads, smem, st>>>(a);
  if (a.splits > 1)
    return (int)dsplit::launch_merge<R>(a.part, a.o, a.lse, a.B * a.H, a.T,
                                        a.splits, a.d, st);
  return (int)cudaGetLastError();
}

// -- the register-blocked multi-row path (block_q 32 or 64) -----------------

constexpr int kTileK = 64;       // keys per K/V tile
constexpr int kPStride = kTileK + 4;

__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// Row stride (floats) of Q and K tiles: the head dim rounded up to 4, with
// an odd count of float4s, so 8 lanes reading 8 rows hit distinct banks.
__host__ __device__ __forceinline__ int qk_stride(int dp) {
  const int quads = dp / 4;
  return 4 * (quads % 2 ? quads : quads + 1);
}

__host__ __device__ __forceinline__ size_t tiled_smem_floats(int bq, int d) {
  const int dp = (d + 3) / 4 * 4;
  const int ks = qk_stride(dp);
  return (size_t)bq * ks + 2 * (size_t)kTileK * ks + 2 * (size_t)kTileK * dp +
         (size_t)bq * kPStride;
}

// BQ query rows per block, BQ / 4 * 16 threads; NQ: output float4s per
// thread per row (1 for d <= 64, 2 for d <= 128); VEC: d % 4 == 0 and
// 16-byte aligned pointers (16-byte copies).
template <int BQ, int NQ, bool VEC>
__global__ void __launch_bounds__(BQ * 4)
flash_fwd_tiled_kernel(const float* __restrict__ q,
                       const float* __restrict__ k,
                       const float* __restrict__ v,
                       const float* __restrict__ kv_mask,
                       float* __restrict__ o, float* __restrict__ lse, int H,
                       int Hkv, int T, int S, int d, float sm_scale,
                       int causal, int window) {
  constexpr int kThreadsT = BQ * 4;
  extern __shared__ float4 smem_t[];
  const int dp = (d + 3) / 4 * 4;
  const int quads = dp / 4;
  const int ks = qk_stride(dp);
  float* q_s = reinterpret_cast<float*>(smem_t);  // [BQ][ks]
  float* k_s = q_s + (size_t)BQ * ks;              // [2][kTileK][ks]
  float* v_s = k_s + 2 * (size_t)kTileK * ks;      // [2][kTileK][dp]
  float* p_s = v_s + 2 * (size_t)kTileK * dp;      // [BQ][kPStride]

  const int tid = threadIdx.x;
  const int tc = tid & 15;   // key / column lane of the row group
  const int tr = tid >> 4;   // row group: rows 4 tr .. 4 tr + 3
  const int q_base = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const float* q_bh = q + (size_t)(b * H + h) * T * d;
  const float* k_bh = k + (size_t)(b * Hkv + hk) * S * d;
  const float* v_bh = v + (size_t)(b * Hkv + hk) * S * d;
  const float* mask_b = kv_mask ? kv_mask + (size_t)b * S : nullptr;

  // the query tile, pre-scaled as the TPU kernel does (q * sm_scale)
  for (int i = tid; i < BQ * dp; i += kThreadsT) {
    const int r = i / dp, c = i % dp;
    const int t = q_base + r;
    q_s[r * ks + c] = t < T && c < d ? q_bh[(size_t)t * d + c] * sm_scale
                                     : 0.f;
  }

  auto load_tile = [&](int tile, int buf) {
    const int kb = tile * kTileK;
    float* kd = k_s + (size_t)buf * kTileK * ks;
    float* vd = v_s + (size_t)buf * kTileK * dp;
    if constexpr (VEC) {
      for (int i = tid; i < kTileK * quads; i += kThreadsT) {
        const int r = i / quads, c = (i % quads) * 4;
        const int s = kb + r;
        // keys past S are zeros (src size 0)
        const size_t off = s < S ? (size_t)s * d + c : 0;
        const int n = s < S ? 16 : 0;
        cp_async16(kd + r * ks + c, k_bh + off, n);
        cp_async16(vd + r * dp + c, v_bh + off, n);
      }
    } else {
      for (int i = tid; i < kTileK * dp; i += kThreadsT) {
        const int r = i / dp, c = i % dp;
        const int s = kb + r;
        const bool ok = s < S && c < d;
        const size_t off = ok ? (size_t)s * d + c : 0;
        cp_async4(kd + r * ks + c, k_bh + off, ok ? 4 : 0);
        cp_async4(vd + r * dp + c, v_bh + off, ok ? 4 : 0);
      }
    }
    cp_async_commit();
  };

  const int q_last = q_base + BQ - 1;
  const int n_tiles = (S + kTileK - 1) / kTileK;
  // the next tile at or after `tile` that any row of the block sees:
  // the causal and window tests of flash_attention.py:151-167, then a
  // block-wide vote over the tile's key mask (uniform: every thread
  // walks the same tiles)
  auto next_tile = [&](int tile) {
    for (; tile < n_tiles; ++tile) {
      const int kb = tile * kTileK;
      if (causal && kb > q_last) return n_tiles;
      if (window) {
        if (kb + kTileK - 1 <= q_base - window) continue;
        if (!causal && kb - q_last >= window) return n_tiles;
      }
      if (!mask_b) return tile;
      const int s = kb + tid;
      const int any = tid < kTileK && s < S && mask_b[s] > 0.f;
      if (__syncthreads_or(any)) return tile;
    }
    return n_tiles;
  };

  float4 acc[4][NQ];
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.f;
#pragma unroll
    for (int n = 0; n < NQ; ++n) acc[i][n] = make_float4(0.f, 0.f, 0.f, 0.f);
  }

  int tile = next_tile(0);
  int buf = 0;
  if (tile < n_tiles) load_tile(tile, 0);
  while (tile < n_tiles) {
    const int nxt = next_tile(tile + 1);
    if (nxt < n_tiles) {
      load_tile(nxt, buf ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();  // tile `tile` (and the query tile) landed

    const float* kt = k_s + (size_t)buf * kTileK * ks;
    const float* vt = v_s + (size_t)buf * kTileK * dp;
    const int kb = tile * kTileK;
    float sc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int c = 0; c < 4; ++c) sc[i][c] = 0.f;
    for (int cq = 0; cq < dp; cq += 4) {
      float4 qv[4], kv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qv[i] = *reinterpret_cast<const float4*>(q_s + (4 * tr + i) * ks + cq);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        kv[c] = *reinterpret_cast<const float4*>(kt + (tc + 16 * c) * ks + cq);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          float a = sc[i][c];
          a = fmaf(qv[i].x, kv[c].x, a);
          a = fmaf(qv[i].y, kv[c].y, a);
          a = fmaf(qv[i].z, kv[c].z, a);
          a = fmaf(qv[i].w, kv[c].w, a);
          sc[i][c] = a;
        }
    }
    bool key_ok[4];
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      const int s = kb + tc + 16 * c;
      key_ok[c] = s < S && (!mask_b || mask_b[s] > 0.f);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qi = q_base + 4 * tr + i;
      float tile_max = kNegInf;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int s = kb + tc + 16 * c;
        bool valid = key_ok[c];
        if (causal) valid = valid && s <= qi;
        if (window) {
          valid = valid && (qi - s < window);
          if (!causal) valid = valid && (s - qi < window);
        }
        sc[i][c] = valid ? sc[i][c] : kNegInf;
        tile_max = fmaxf(tile_max, sc[i][c]);
      }
      // the row's 16 lanes are one half-warp
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        tile_max = fmaxf(tile_max,
                         __shfl_xor_sync(0xffffffffu, tile_max, off));
      const float m_new = fmaxf(m[i], tile_max);
      const float alpha = expf(m[i] - m_new);
      float psum = 0.f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const float p = expf(sc[i][c] - m_new);
        p_s[(4 * tr + i) * kPStride + tc + 16 * c] = p;
        psum += p;
      }
      l[i] = l[i] * alpha + psum;
      m[i] = m_new;
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        acc[i][n].x *= alpha; acc[i][n].y *= alpha;
        acc[i][n].z *= alpha; acc[i][n].w *= alpha;
      }
    }
    __syncwarp();  // the row group's P is written
    for (int jq = 0; jq < kTileK; jq += 4) {
      float4 pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        pv[i] = *reinterpret_cast<const float4*>(p_s + (4 * tr + i) * kPStride
                                                 + jq);
#pragma unroll
      for (int n = 0; n < NQ; ++n) {
        const int c = (tc + 16 * n) * 4;
        if (c >= dp) continue;
        float4 vv[4];
#pragma unroll
        for (int j = 0; j < 4; ++j)
          vv[j] = *reinterpret_cast<const float4*>(vt + (jq + j) * dp + c);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float pj[4] = {pv[i].x, pv[i].y, pv[i].z, pv[i].w};
          float4 a = acc[i][n];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            a.x = fmaf(pj[j], vv[j].x, a.x);
            a.y = fmaf(pj[j], vv[j].y, a.y);
            a.z = fmaf(pj[j], vv[j].z, a.z);
            a.w = fmaf(pj[j], vv[j].w, a.w);
          }
          acc[i][n] = a;
        }
      }
    }
    __syncthreads();  // done with this buffer and with P
    buf ^= 1;
    tile = nxt;
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    float lt = l[i];
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      lt += __shfl_xor_sync(0xffffffffu, lt, off);
    const int qi = q_base + 4 * tr + i;
    if (qi >= T) continue;
    const bool dead = m[i] <= kMaskedRowLse;
    const float denom = fmaxf(lt, 1e-30f);
    float* o_row = o + ((size_t)(b * H + h) * T + qi) * d;
#pragma unroll
    for (int n = 0; n < NQ; ++n) {
      const int c = (tc + 16 * n) * 4;
      if (c >= dp) continue;
      float4 r = acc[i][n];
      r = dead ? make_float4(0.f, 0.f, 0.f, 0.f)
               : make_float4(r.x / denom, r.y / denom, r.z / denom,
                             r.w / denom);
      if constexpr (VEC) {
        *reinterpret_cast<float4*>(o_row + c) = r;
      } else {
        const float e[4] = {r.x, r.y, r.z, r.w};
        for (int j = 0; j < 4 && c + j < d; ++j) o_row[c + j] = e[j];
      }
    }
    if (tc == 0) lse[(size_t)(b * H + h) * T + qi] = m[i] + logf(denom);
  }
}

template <int BQ, int NQ, bool VEC>
int launch_tiled(const float* q, const float* k, const float* v,
                 const float* kv_mask, float* o, float* lse, int B, int H,
                 int Hkv, int T, int S, int d, float sm_scale, int causal,
                 int window, cudaStream_t st) {
  auto kernel = flash_fwd_tiled_kernel<BQ, NQ, VEC>;
  const size_t smem = sizeof(float) * tiled_smem_floats(BQ, d);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + BQ - 1) / BQ, H, B);
  kernel<<<grid, BQ * 4, smem, st>>>(q, k, v, kv_mask, o, lse, H, Hkv, T, S,
                                     d, sm_scale, causal, window);
  return (int)cudaGetLastError();
}

template <int BQ>
int dispatch_tiled(const float* q, const float* k, const float* v,
                   const float* kv_mask, float* o, float* lse, int B, int H,
                   int Hkv, int T, int S, int d, float sm_scale, int causal,
                   int window, cudaStream_t st) {
  const bool vec = d % 4 == 0 && ((uintptr_t)q | (uintptr_t)k | (uintptr_t)v |
                                  (uintptr_t)o) % 16 == 0;
  const bool wide = (d + 3) / 4 > 16;
#define PADDLE_FLASH_TILED(NQ, VEC)                                          \
  launch_tiled<BQ, NQ, VEC>(q, k, v, kv_mask, o, lse, B, H, Hkv, T, S, d,   \
                            sm_scale, causal, window, st)
  if (wide)
    return vec ? PADDLE_FLASH_TILED(2, true) : PADDLE_FLASH_TILED(2, false);
  return vec ? PADDLE_FLASH_TILED(1, true) : PADDLE_FLASH_TILED(1, false);
#undef PADDLE_FLASH_TILED
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success). kv_mask
// may be null (no key mask). block_q is the query tile of the launch plan
// (kernels/flash_attention.py `flash_plan`): 4, 32 or 64. For block_q 4
// the plan's `splits` blocks a (batch, head) each cover `kps` keys (a
// multiple of 32; splits * kps >= S, every split nonempty); with
// splits > 1, `part` is scratch of B * H * splits * T * (d + 2) floats.
// The other tiles ignore splits, kps and part.
extern "C" int paddle_flash_fwd_f32(const float* q, const float* k,
                                    const float* v, const float* kv_mask,
                                    float* o, float* lse, float* part, int B,
                                    int H, int Hkv, int T, int S, int d,
                                    float sm_scale, int causal, int window,
                                    int block_q, int splits, int kps,
                                    void* stream) {
  if (B < 1 || T < 1 || d < 1 || d > kMaxD || Hkv < 1 || H % Hkv != 0 ||
      S < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == kRowsBlockQ) {
    if (T > kRowsBlockQ || splits < 1 || kps < dsplit::kChunk ||
        kps % dsplit::kChunk != 0 || (long long)splits * kps < S ||
        (long long)(splits - 1) * kps >= (S > 0 ? S : 1) || H > 65535 ||
        B > 65535 || (splits > 1 && !part))
      return (int)cudaErrorInvalidValue;
    const int vec = d % 4 == 0 && ((uintptr_t)k | (uintptr_t)v) % 16 == 0;
    const RowsArgs a{q, k, v, kv_mask, o, lse, part, B, H, Hkv, T, S, d,
                     causal, window, splits, kps,
                     sm_scale * dsplit::kLog2e, vec};
    switch (dsplit::rows_for(T)) {
      case 1: return launch_rows<1>(a, st);
      case 2: return launch_rows<2>(a, st);
      default: return launch_rows<4>(a, st);
    }
  }
  if (block_q == 32)
    return dispatch_tiled<32>(q, k, v, kv_mask, o, lse, B, H, Hkv, T, S, d,
                              sm_scale, causal, window, st);
  if (block_q == 64)
    return dispatch_tiled<64>(q, k, v, kv_mask, o, lse, B, H, Hkv, T, S, d,
                              sm_scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}

// The threads and shared-memory bytes of the rows path's block for T <= 4
// query rows at head dim d, for holding `flash_rows_plan`'s figures to the
// kernel's (host code: no device needed); cudaErrorInvalidValue outside
// T 1..4, d 1..128.
extern "C" int paddle_flash_rows_layout(int T, int d, int* threads,
                                        int* smem) {
  if (T < 1 || T > kRowsBlockQ || d < 1 || d > kMaxD)
    return (int)cudaErrorInvalidValue;
  *threads = dsplit::kThreads;
  *smem = (int)sizeof(float) *
          dsplit::layout_of(d, dsplit::rows_for(T), dsplit::kRowsStages).floats;
  return 0;
}
