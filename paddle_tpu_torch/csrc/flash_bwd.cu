// flash_bwd: the FlashAttention-2 backward pair, fp32, for sm_90a.
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
// (i - j < w, and j - i < w when not causal). Tile pairs wholly above
// the diagonal or outside the window are skipped by the tests of
// flash_attention.py:356-368,419-430, and so is a key tile whose keys are
// all masked.
//
// Grid. The TPU walks the reduction axes in order on one core and keeps
// the sums in VMEM scratch. GPU blocks run in no fixed order, so each
// reduction moves inside one block and its sum lives in registers:
//   dK/dV: one block per (K/V tile of 32 keys, kv head, batch), looping
//          over the g query heads of the kv head and over the Q tiles;
//   dQ:    one block per (Q tile of 32 rows, head, batch), looping over
//          the K/V tiles of its kv head.
// Neither kernel writes a partial sum to device memory, and no atomics
// are needed.
//
// What bounds it on this card: at the training shape (T = S = 256,
// d = 64) the pair does 14 * T * S * d flops per head against about
// 4 * (T + S) * d * 4 bytes: some 450 flops per byte, far above the fp32
// ridge (67 TFLOP/s over 3.35 TB/s is 20), so it is bound by fp32 FMA
// issue on the CUDA cores (TF32 is off: ROADMAP's parity rule keeps fp32
// throughout). What the design does about it: each thread computes a
// 2 x 4 block of scores and of dO.v^T from shared memory (12 shared
// loads for 16 FMAs), and a 4-row block of the dK/dV or dQ accumulators
// (16 loads for 32 FMAs at d = 64); rows are padded by one float so a
// warp's reads fall in distinct banks. Tensor cores (TF32/bf16 wgmma),
// TMA staging and a larger tile are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBQ = 32;       // query rows per tile
constexpr int kBK = 32;       // keys per tile
constexpr int kLP = kBK + 1;  // padded row of the p / ds tiles
constexpr float kMaskedRowLse = -1e29f;

// Does the pair (query tile at q_base, key tile at k_base) hold any
// visible entry? Block-uniform.
__device__ __forceinline__ bool tile_runs(int q_base, int k_base,
                                          int causal, int window) {
  const int q_last = q_base + kBQ - 1;
  const int k_last = k_base + kBK - 1;
  bool run = true;
  if (causal) run = k_base <= q_last;
  if (window) {
    run = run && (q_base - k_last < window);
    if (!causal) run = run && (k_base - q_last < window);
  }
  return run;
}

// rows [base, base + n) of a [len, d] matrix into a [n][D + 1] tile;
// rows past len and columns past d are zeros
template <int D>
__device__ __forceinline__ void load_rows(float* dst, const float* src,
                                          int base, int n, int len, int d) {
  constexpr int LD = D + 1;
  for (int i = threadIdx.x; i < n * D; i += kThreads) {
    const int r = i / D, c = i % D;
    const int row = base + r;
    dst[r * LD + c] = (row < len && c < d) ? src[(size_t)row * d + c] : 0.f;
  }
}

// the [kBQ, kBK] tiles p and ds of one (query tile, key tile) pair, from
// the staged q, dO, k, v tiles; each thread owns rows r0, r0 + 1 and the
// columns c0 + 8u
template <int D>
__device__ __forceinline__ void p_and_ds(
    const float* q_s, const float* do_s, const float* k_s, const float* v_s,
    const float* lse_s, const float* delta_s, const float* kval_s,
    int q_base, int k_base, int T, float sm_scale, int causal, int window,
    float* p_s, float* ds_s) {
  constexpr int LD = D + 1;
  const int r0 = (threadIdx.x / 8) * 2;
  const int c0 = threadIdx.x % 8;
  float s[2][4], dp[2][4];
#pragma unroll
  for (int a = 0; a < 2; ++a)
#pragma unroll
    for (int u = 0; u < 4; ++u) s[a][u] = dp[a][u] = 0.f;
#pragma unroll 8
  for (int c = 0; c < D; ++c) {
    const float qa = q_s[r0 * LD + c], qb = q_s[(r0 + 1) * LD + c];
    const float oa = do_s[r0 * LD + c], ob = do_s[(r0 + 1) * LD + c];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const float kk = k_s[(c0 + 8 * u) * LD + c];
      const float vv = v_s[(c0 + 8 * u) * LD + c];
      s[0][u] += qa * kk;
      s[1][u] += qb * kk;
      dp[0][u] += oa * vv;
      dp[1][u] += ob * vv;
    }
  }
#pragma unroll
  for (int a = 0; a < 2; ++a) {
    const int i = r0 + a;
    const int qi = q_base + i;
    const float lse = lse_s[i];
    const float delta = delta_s[i];
#pragma unroll
    for (int u = 0; u < 4; ++u) {
      const int j = c0 + 8 * u;
      const int kj = k_base + j;
      bool valid = qi < T && kval_s[j] > 0.f && lse > kMaskedRowLse;
      if (causal) valid = valid && kj <= qi;
      if (window) {
        valid = valid && (qi - kj < window);
        if (!causal) valid = valid && (kj - qi < window);
      }
      const float p = valid ? expf(s[a][u] * sm_scale - lse) : 0.f;
      p_s[i * kLP + j] = p;
      ds_s[i * kLP + j] = p * (dp[a][u] - delta) * sm_scale;
    }
  }
}

// key validity of key k_base + (tid % kBK): in range and kept by the mask
__device__ __forceinline__ bool key_valid(const float* mask_b, int k_base,
                                          int S) {
  const int s = k_base + threadIdx.x % kBK;
  return s < S && (mask_b == nullptr || mask_b[s] > 0.f);
}

template <int D>
size_t smem_bytes() {
  constexpr int LD = D + 1;
  return sizeof(float) *
         ((size_t)2 * kBQ * LD + 2 * kBK * LD + 2 * kBQ * kLP + 2 * kBQ + kBK);
}

struct Tiles {
  float *q, *dout, *k, *v, *p, *ds, *lse, *delta, *kval;
};

template <int D>
__device__ __forceinline__ Tiles carve(float* smem) {
  constexpr int LD = D + 1;
  Tiles t;
  t.q = smem;
  t.dout = t.q + kBQ * LD;
  t.k = t.dout + kBQ * LD;
  t.v = t.k + kBK * LD;
  t.p = t.v + kBK * LD;
  t.ds = t.p + kBQ * kLP;
  t.lse = t.ds + kBQ * kLP;
  t.delta = t.lse + kBQ;
  t.kval = t.delta + kBQ;
  return t;
}

// stage the query-side rows of head (b, h) for the tile at q_base
template <int D>
__device__ __forceinline__ void load_query_tile(
    const Tiles& t, const float* q, const float* dout, const float* lse,
    const float* delta, size_t bh, int q_base, int T, int d) {
  load_rows<D>(t.q, q + bh * T * d, q_base, kBQ, T, d);
  load_rows<D>(t.dout, dout + bh * T * d, q_base, kBQ, T, d);
  for (int i = threadIdx.x; i < kBQ; i += kThreads) {
    const int qi = q_base + i;
    t.lse[i] = qi < T ? lse[bh * T + qi] : 0.f;
    t.delta[i] = qi < T ? delta[bh * T + qi] : 0.f;
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkv_kernel(const float* __restrict__ q, const float* __restrict__ k,
                     const float* __restrict__ v,
                     const float* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta,
                     const float* __restrict__ kv_mask,
                     float* __restrict__ dk, float* __restrict__ dv, int H,
                     int Hkv, int T, int S, int d, float sm_scale, int causal,
                     int window) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;  // accumulator columns per thread
  extern __shared__ float smem[];
  const Tiles t = carve<D>(smem);
  const int tid = threadIdx.x;
  const int k_base = blockIdx.x * kBK;
  const int hk = blockIdx.y;
  const int b = blockIdx.z;
  const int g = H / Hkv;
  const size_t bhk = (size_t)b * Hkv + hk;
  const float* mask_b = kv_mask ? kv_mask + (size_t)b * S : nullptr;

  // this thread's accumulator block: key rows jr0..jr0+3, columns
  // cc + 16w
  const int jr0 = (tid / 16) * 4;
  const int cc = tid % 16;
  float dk_acc[4][NC], dv_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int w = 0; w < NC; ++w) dk_acc[r][w] = dv_acc[r][w] = 0.f;

  load_rows<D>(t.k, k + bhk * S * d, k_base, kBK, S, d);
  load_rows<D>(t.v, v + bhk * S * d, k_base, kBK, S, d);
  const bool kv_ok = key_valid(mask_b, k_base, S);
  if (tid < kBK) t.kval[tid] = kv_ok ? 1.f : 0.f;
  // a tile of masked keys gets zero gradients without a pass over Q
  const bool any_key = __syncthreads_or(kv_ok);

  const int n_q = (T + kBQ - 1) / kBQ;
  for (int gi = 0; any_key && gi < g; ++gi) {
    const size_t bh = (size_t)b * H + (size_t)hk * g + gi;
    for (int qt = 0; qt < n_q; ++qt) {
      const int q_base = qt * kBQ;
      if (!tile_runs(q_base, k_base, causal, window)) continue;
      __syncthreads();  // the last pair's reads of the q-side tiles are done
      load_query_tile<D>(t, q, dout, lse, delta, bh, q_base, T, d);
      __syncthreads();
      p_and_ds<D>(t.q, t.dout, t.k, t.v, t.lse, t.delta, t.kval, q_base,
                  k_base, T, sm_scale, causal, window, t.p, t.ds);
      __syncthreads();
      for (int i = 0; i < kBQ; ++i) {
        float pv[4], dsv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          pv[r] = t.p[i * kLP + jr0 + r];
          dsv[r] = t.ds[i * kLP + jr0 + r];
        }
#pragma unroll
        for (int w = 0; w < NC; ++w) {
          const float o = t.dout[i * LD + cc + 16 * w];
          const float qq = t.q[i * LD + cc + 16 * w];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            dv_acc[r][w] += pv[r] * o;
            dk_acc[r][w] += dsv[r] * qq;
          }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int kj = k_base + jr0 + r;
    if (kj >= S) continue;
#pragma unroll
    for (int w = 0; w < NC; ++w) {
      const int c = cc + 16 * w;
      if (c < d) {
        dk[(bhk * S + kj) * d + c] = dk_acc[r][w];
        dv[(bhk * S + kj) * d + c] = dv_acc[r][w];
      }
    }
  }
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const float* __restrict__ q, const float* __restrict__ k,
                    const float* __restrict__ v,
                    const float* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta,
                    const float* __restrict__ kv_mask,
                    float* __restrict__ dq, int H, int Hkv, int T, int S,
                    int d, float sm_scale, int causal, int window) {
  constexpr int LD = D + 1;
  constexpr int NC = D / 16;
  extern __shared__ float smem[];
  const Tiles t = carve<D>(smem);
  const int tid = threadIdx.x;
  const int q_base = blockIdx.x * kBQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const size_t bh = (size_t)b * H + h;
  const size_t bhk = (size_t)b * Hkv + h / (H / Hkv);
  const float* mask_b = kv_mask ? kv_mask + (size_t)b * S : nullptr;

  // this thread's accumulator block: query rows ir0..ir0+3, columns
  // cc + 16w
  const int ir0 = (tid / 16) * 4;
  const int cc = tid % 16;
  float dq_acc[4][NC];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int w = 0; w < NC; ++w) dq_acc[r][w] = 0.f;

  load_query_tile<D>(t, q, dout, lse, delta, bh, q_base, T, d);

  const int n_k = (S + kBK - 1) / kBK;
  for (int kt = 0; kt < n_k; ++kt) {
    const int k_base = kt * kBK;
    if (!tile_runs(q_base, k_base, causal, window)) continue;
    __syncthreads();  // the last tile's reads of k and ds are done
    load_rows<D>(t.k, k + bhk * S * d, k_base, kBK, S, d);
    load_rows<D>(t.v, v + bhk * S * d, k_base, kBK, S, d);
    const bool kv_ok = key_valid(mask_b, k_base, S);
    if (tid < kBK) t.kval[tid] = kv_ok ? 1.f : 0.f;
    if (!__syncthreads_or(kv_ok)) continue;  // all keys masked
    p_and_ds<D>(t.q, t.dout, t.k, t.v, t.lse, t.delta, t.kval, q_base,
                k_base, T, sm_scale, causal, window, t.p, t.ds);
    __syncthreads();
    for (int j = 0; j < kBK; ++j) {
      float dsv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) dsv[r] = t.ds[(ir0 + r) * kLP + j];
#pragma unroll
      for (int w = 0; w < NC; ++w) {
        const float kk = t.k[j * LD + cc + 16 * w];
#pragma unroll
        for (int r = 0; r < 4; ++r) dq_acc[r][w] += dsv[r] * kk;
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_base + ir0 + r;
    if (qi >= T) continue;
#pragma unroll
    for (int w = 0; w < NC; ++w) {
      const int c = cc + 16 * w;
      if (c < d) dq[(bh * T + qi) * d + c] = dq_acc[r][w];
    }
  }
}

template <typename Kern>
cudaError_t allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return cudaSuccess;
  return cudaFuncSetAttribute(kernel,
                              cudaFuncAttributeMaxDynamicSharedMemorySize,
                              (int)smem);
}

bool bad_dims(int B, int H, int Hkv, int T, int S, int d) {
  return B < 1 || T < 1 || S < 1 || d < 1 || d > 128 || Hkv < 1 ||
         H % Hkv != 0;
}

template <int D>
int launch_dkv(const float* q, const float* k, const float* v,
               const float* dout, const float* lse, const float* delta,
               const float* kv_mask, float* dk, float* dv, int B, int H,
               int Hkv, int T, int S, int d, float sm_scale, int causal,
               int window, cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = allow_smem(flash_bwd_dkv_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((S + kBK - 1) / kBK, Hkv, B);
  flash_bwd_dkv_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, kv_mask, dk, dv, H, Hkv, T, S, d, sm_scale,
      causal, window);
  return (int)cudaGetLastError();
}

template <int D>
int launch_dq(const float* q, const float* k, const float* v,
              const float* dout, const float* lse, const float* delta,
              const float* kv_mask, float* dq, int B, int H, int Hkv, int T,
              int S, int d, float sm_scale, int causal, int window,
              cudaStream_t st) {
  const size_t smem = smem_bytes<D>();
  cudaError_t e = allow_smem(flash_bwd_dq_kernel<D>, smem);
  if (e != cudaSuccess) return (int)e;
  dim3 grid((T + kBQ - 1) / kBQ, H, B);
  flash_bwd_dq_kernel<D><<<grid, kThreads, smem, st>>>(
      q, k, v, dout, lse, delta, kv_mask, dq, H, Hkv, T, S, d, sm_scale,
      causal, window);
  return (int)cudaGetLastError();
}

}  // namespace

// Both launch on `stream` and return cudaGetLastError() (0 on success).
// kv_mask may be null (no key mask). dk/dv are [B,Hkv,S,d], dq
// [B,H,T,d]; every element is written.
extern "C" int paddle_flash_bwd_dkv_f32(const float* q, const float* k,
                                        const float* v, const float* dout,
                                        const float* lse, const float* delta,
                                        const float* kv_mask, float* dk,
                                        float* dv, int B, int H, int Hkv,
                                        int T, int S, int d, float sm_scale,
                                        int causal, int window,
                                        void* stream) {
  if (bad_dims(B, H, Hkv, T, S, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, H,
                          Hkv, T, S, d, sm_scale, causal, window, st);
  return launch_dkv<128>(q, k, v, dout, lse, delta, kv_mask, dk, dv, B, H,
                         Hkv, T, S, d, sm_scale, causal, window, st);
}

extern "C" int paddle_flash_bwd_dq_f32(const float* q, const float* k,
                                       const float* v, const float* dout,
                                       const float* lse, const float* delta,
                                       const float* kv_mask, float* dq,
                                       int B, int H, int Hkv, int T, int S,
                                       int d, float sm_scale, int causal,
                                       int window, void* stream) {
  if (bad_dims(B, H, Hkv, T, S, d)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (d <= 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, kv_mask, dq, B, H, Hkv,
                         T, S, d, sm_scale, causal, window, st);
  return launch_dq<128>(q, k, v, dout, lse, delta, kv_mask, dq, B, H, Hkv,
                        T, S, d, sm_scale, causal, window, st);
}
