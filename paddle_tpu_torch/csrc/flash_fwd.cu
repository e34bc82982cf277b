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
// flops per byte). The encoder and prefill calls (T=S=256, d=64) do about
// 64 flops per byte moved and are bound by fp32 FMA issue instead: this
// kernel runs on the CUDA cores (TF32 is off, so no tensor cores).
//
// What the design does about it: one block per (query tile, head, batch)
// keeps the K/V tile in shared memory, staged with coalesced loads, and
// shares it across every query row of the tile; scores, the running max,
// sum and output accumulator stay in registers, so the [T,S] score
// matrix never exists in device memory and K/V are read once per query
// tile. For T <= 4 (decode) the tile is 4 rows with a whole warp per row
// instead of 16 rows with 8 threads each, so the dot products of a
// single query row still spread over 32 threads. Making it fast (tensor
// cores via TF32/bf16, a split over S for T=1, cp.async double
// buffering) is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBlockK = 32;     // keys per shared-memory tile
constexpr int kMaxD = 128;      // largest head dim the kernel takes
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowLse = -1e29f;

template <int BQ>
__global__ void __launch_bounds__(kThreads)
flash_fwd_kernel(const float* __restrict__ q, const float* __restrict__ k,
                 const float* __restrict__ v,
                 const float* __restrict__ kv_mask, float* __restrict__ o,
                 float* __restrict__ lse, int H, int Hkv, int T, int S,
                 int d, float sm_scale, int causal, int window) {
  constexpr int TPR = kThreads / BQ;   // threads per query row (8 or 32)
  constexpr int KPT = kBlockK / TPR;   // keys scored per thread (4 or 1)
  constexpr int CPT = kMaxD / TPR;     // output columns per thread, max
  // +1 padding: rows of a tile sit in different banks
  __shared__ float q_s[BQ][kMaxD + 1];
  __shared__ float k_s[kBlockK][kMaxD + 1];
  __shared__ float v_s[kBlockK][kMaxD];
  __shared__ float p_s[BQ][kBlockK + 1];

  const int tid = threadIdx.x;
  const int row = tid / TPR;
  const int lane = tid % TPR;
  const int q_base = blockIdx.x * BQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int hk = h / (H / Hkv);
  const int qi = q_base + row;

  const float* q_bh = q + (size_t)(b * H + h) * T * d;
  const float* k_bh = k + (size_t)(b * Hkv + hk) * S * d;
  const float* v_bh = v + (size_t)(b * Hkv + hk) * S * d;
  const float* mask_b = kv_mask ? kv_mask + (size_t)b * S : nullptr;

  // the query tile, pre-scaled as the TPU kernel does (q * sm_scale)
  for (int i = tid; i < BQ * d; i += kThreads) {
    const int r = i / d, c = i % d;
    const int t = q_base + r;
    q_s[r][c] = t < T ? q_bh[(size_t)t * d + c] * sm_scale : 0.f;
  }

  float acc[CPT];
#pragma unroll
  for (int j = 0; j < CPT; ++j) acc[j] = 0.f;
  float m = kNegInf;
  float l = 0.f;

  const int q_last = q_base + BQ - 1;
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

    float sc[KPT];
    float tile_max = kNegInf;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const int j = lane + u * TPR;
      const int s = k_base + j;
      float dot = 0.f;
      for (int c = 0; c < d; ++c) dot += q_s[row][c] * k_s[j][c];
      bool valid = s < S;
      if (valid && mask_b) valid = mask_b[s] > 0.f;
      if (causal) valid = valid && s <= qi;
      if (window) {
        valid = valid && (qi - s < window);
        if (!causal) valid = valid && (s - qi < window);
      }
      sc[u] = valid ? dot : kNegInf;
      tile_max = fmaxf(tile_max, sc[u]);
    }
    // the row group is TPR consecutive lanes of one warp
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      tile_max = fmaxf(tile_max, __shfl_xor_sync(0xffffffffu, tile_max, off));
    const float m_new = fmaxf(m, tile_max);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int u = 0; u < KPT; ++u) {
      const float p = expf(sc[u] - m_new);
      p_s[row][lane + u * TPR] = p;
      psum += p;
    }
#pragma unroll
    for (int off = TPR / 2; off > 0; off >>= 1)
      psum += __shfl_xor_sync(0xffffffffu, psum, off);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();
#pragma unroll
    for (int jc = 0; jc < CPT; ++jc) {
      const int c = lane + jc * TPR;
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
    for (int jc = 0; jc < CPT; ++jc) {
      const int c = lane + jc * TPR;
      if (c < d) o_row[c] = dead ? 0.f : acc[jc] / denom;
    }
    if (lane == 0) lse[(size_t)(b * H + h) * T + qi] = m + logf(denom);
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// kv_mask may be null (no key mask).
extern "C" int paddle_flash_fwd_f32(const float* q, const float* k,
                                    const float* v, const float* kv_mask,
                                    float* o, float* lse, int B, int H,
                                    int Hkv, int T, int S, int d,
                                    float sm_scale, int causal, int window,
                                    void* stream) {
  if (B < 1 || T < 1 || d < 1 || d > kMaxD || Hkv < 1 || H % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (T <= 4) {
    dim3 grid((T + 3) / 4, H, B);
    flash_fwd_kernel<4><<<grid, kThreads, 0, st>>>(
        q, k, v, kv_mask, o, lse, H, Hkv, T, S, d, sm_scale, causal, window);
  } else {
    dim3 grid((T + 15) / 16, H, B);
    flash_fwd_kernel<16><<<grid, kThreads, 0, st>>>(
        q, k, v, kv_mask, o, lse, H, Hkv, T, S, d, sm_scale, causal, window);
  }
  return (int)cudaGetLastError();
}
