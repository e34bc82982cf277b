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
// - block_q 4 (T <= 4: decode and verify): 4 query rows of 128 threads, a
//   warp per row, so the dot products of a single query row still spread
//   over 32 threads; 32-key tiles loaded synchronously.
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

namespace {

constexpr int kThreads = 128;
constexpr int kRows = 4;         // query rows per block: one warp each
constexpr int kBlockK = 32;      // keys per shared-memory tile: one a lane
constexpr int kMaxD = 128;       // largest head dim the kernel takes
constexpr int kCols = kMaxD / 32;  // output columns per lane, max
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowLse = -1e29f;

__global__ void __launch_bounds__(kThreads)
flash_fwd_rows_kernel(const float* __restrict__ q, const float* __restrict__ k,
                      const float* __restrict__ v,
                      const float* __restrict__ kv_mask, float* __restrict__ o,
                      float* __restrict__ lse, int H, int Hkv, int T, int S,
                      int d, float sm_scale, int causal, int window) {
  // +1 padding: rows of a tile sit in different banks
  __shared__ float q_s[kRows][kMaxD + 1];
  __shared__ float k_s[kBlockK][kMaxD + 1];
  __shared__ float v_s[kBlockK][kMaxD];
  __shared__ float p_s[kRows][kBlockK + 1];

  const int tid = threadIdx.x;
  const int row = tid / 32;
  const int lane = tid % 32;
  const int q_base = blockIdx.x * kRows;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int qi = q_base + row;

  const float* q_bh = q + (size_t)(b * H + h) * T * d;
  const float* k_bh = k + (size_t)(b * Hkv + hk) * S * d;
  const float* v_bh = v + (size_t)(b * Hkv + hk) * S * d;
  const float* mask_b = kv_mask ? kv_mask + (size_t)b * S : nullptr;

  // the query tile, pre-scaled as the TPU kernel does (q * sm_scale)
  for (int i = tid; i < kRows * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int t = q_base + r;
    q_s[r][c] = t < T ? q_bh[(size_t)t * d + c] * sm_scale : 0.f;
  }

  float acc[kCols];
#pragma unroll
  for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = q_base + kRows - 1;
  const int n_tiles = (S + kBlockK - 1) / kBlockK;
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int k_base = tile * kBlockK;
    // block-uniform tile skip (flash_attention.py:151-167)
    bool run = true;
    if (causal) run = k_base <= q_last;
    if (window) {
      run = run && (k_base + kBlockK - 1 > q_base - window);
      if (!causal) run = run && (k_base - q_last < window);
    }
    if (!run) continue;
    __syncthreads();  // the query tile is staged; last tile's reads done
    for (int i = tid; i < kBlockK * d; i += kThreads) {
      const int r = i / d, c = i % d;
      const int s = k_base + r;
      // keys past S are zeros: a row that has seen no visible key yet
      // weighs every masked entry 1 (as the TPU kernel does), and 0 * a
      // finite value keeps that transient sum finite
      k_s[r][c] = s < S ? k_bh[(size_t)s * d + c] : 0.f;
      v_s[r][c] = s < S ? v_bh[(size_t)s * d + c] : 0.f;
    }
    __syncthreads();

    // a warp per query row, a lane per key
    const int s = k_base + lane;
    float dot = 0.f;
    for (int c = 0; c < d; ++c) dot += q_s[row][c] * k_s[lane][c];
    bool valid = s < S;
    if (valid && mask_b) valid = mask_b[s] > 0.f;
    if (causal) valid = valid && s <= qi;
    if (window) {
      valid = valid && (qi - s < window);
      if (!causal) valid = valid && (s - qi < window);
    }
    const float sc = valid ? dot : kNegInf;
    float tile_max = fmaxf(kNegInf, sc);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    const float p = expf(sc - m_new);
    p_s[row][lane] = p;
    float psum = p;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int jc = 0; jc < kCols; ++jc) {
      const int c = lane + jc * 32;
      if (c < d) {
        float a = acc[jc] * alpha;
        for (int j = 0; j < kBlockK; ++j) a += p_s[row][j] * v_s[j][c];
        acc[jc] = a;
      }
    }
  }

  if (qi < T) {
    const bool dead = m <= kMaskedRowLse;
    const float denom = fmaxf(l, 1e-30f);
    float* o_row = o + ((size_t)(b * H + h) * T + qi) * d;
#pragma unroll
    for (int jc = 0; jc < kCols; ++jc) {
      const int c = lane + jc * 32;
      if (c < d) o_row[c] = dead ? 0.f : acc[jc] / denom;
    }
    if (lane == 0) lse[(size_t)(b * H + h) * T + qi] = m + logf(denom);
  }
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

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// kv_mask may be null (no key mask). block_q is the query tile of the
// launch plan (kernels/flash_attention.py `flash_plan`): 4, 32 or 64.
extern "C" int paddle_flash_fwd_f32(const float* q, const float* k,
                                    const float* v, const float* kv_mask,
                                    float* o, float* lse, int B, int H,
                                    int Hkv, int T, int S, int d,
                                    float sm_scale, int causal, int window,
                                    int block_q, void* stream) {
  if (B < 1 || T < 1 || d < 1 || d > kMaxD || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (block_q == kRows) {
    dim3 grid((T + kRows - 1) / kRows, H, B);
    flash_fwd_rows_kernel<<<grid, kThreads, 0, st>>>(
        q, k, v, kv_mask, o, lse, H, Hkv, T, S, d, sm_scale, causal, window);
    return (int)cudaGetLastError();
  }
  if (block_q == 32)
    return dispatch_tiled<32>(q, k, v, kv_mask, o, lse, B, H, Hkv, T, S, d,
                              sm_scale, causal, window, st);
  if (block_q == 64)
    return dispatch_tiled<64>(q, k, v, kv_mask, o, lse, B, H, Hkv, T, S, d,
                              sm_scale, causal, window, st);
  return (int)cudaErrorInvalidValue;
}
