// threefry2x32 draws for the H100: jax.random's stream, bit for bit.
//
// Replaces no TPU kernel. In the JAX package XLA fuses each threefry
// draw (jax/_src/prng.py threefry_2x32, the partitionable counters)
// into one pass; written in torch ops the hash is some 170 elementwise
// launches over int64 words per draw. This kernel is the port's own:
// one launch derives a key chain (the integers and per-row data folded
// into a base key, core/prng.py KeyChain) and draws n counters per row
// of keys, writing
//   MODE_KEY        the folded key of each row          int64 [rows, 2]
//                   (jax.random.split: a row fold of 0..n-1)
//   MODE_BITS       hi ^ lo of each counter             int64 [rows, n]
//   MODE_UNIFORM    float32 in [lo, hi)                 float [rows, n]
//   MODE_BERNOULLI  uniform(0, 1) < p                   float or uint8
//
// Counter i of a row is the pair (i >> 32, i & 0xFFFFFFFF), the flat
// row-major index as iota_2x32_shape gives it. The uniform takes the
// top 23 bits as the mantissa of a float in [1, 2), subtracts 1, and
// scales with one fused multiply-add: XLA on the CPU contracts
// u * (max - min) + min, and the CPU tests hold the port to it; then
// max(min, .) as jax does.
//
// Bound: integer operations. A hash is 2 + 20 * 3 + 5 * 2 = 72 integer
// operations (add, funnel shift, xor; a key injection is two adds, its
// constant folded per thread), less 5 where a key injection's add into
// x0 and the next round's fuse into one IADD3: 67. The draw adds the
// xor of the two words, a shift and an or on the integer pipe; the
// uniform's subtract, multiply-add and max (or the bernoulli's
// subtract and compare) run on the FP32 pipe, twice as wide, beside it.
// The output is 1, 4 or 8 bytes a counter. At 8.4 M counters (one
// dropout site of a Transformer-base train step) the integer work
// (about 0.59 G operations at 16.7 TOP/s INT32) takes about 35 us, the
// 34 MB written about 10 us.
// Design: one thread per counter, four counters a thread; each block
// derives its row's key once in shared memory (up to 4 integer folds
// and 2 row folds: 7 hashes) and its threads draw from it. Rotations are
// __funnelshift_l. Nothing is read but the base key and the row data.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kPerThread = 4;

enum Mode { kKey = 0, kBits = 1, kUniform = 2, kBernoulli = 3 };

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return __funnelshift_l(x, x, r);
}

__device__ __forceinline__ void hash(uint32_t k0, uint32_t k1, uint32_t& x0,
                                     uint32_t& x1) {
  const uint32_t k2 = k0 ^ k1 ^ 0x1BD11BDAu;
  x0 += k0;
  x1 += k1;
#define TF_ROUND(r) \
  x0 += x1;         \
  x1 = rotl(x1, r); \
  x1 ^= x0;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k1; x1 += k2 + 1u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k2; x1 += k0 + 2u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k0; x1 += k1 + 3u;
  TF_ROUND(17) TF_ROUND(29) TF_ROUND(16) TF_ROUND(24)
  x0 += k1; x1 += k2 + 4u;
  TF_ROUND(13) TF_ROUND(15) TF_ROUND(26) TF_ROUND(6)
  x0 += k2; x1 += k0 + 5u;
#undef TF_ROUND
}

__device__ __forceinline__ void fold(uint32_t& k0, uint32_t& k1,
                                     uint32_t d) {
  uint32_t x0 = 0u, x1 = d;
  hash(k0, k1, x0, x1);
  k0 = x0;
  k1 = x1;
}

struct Params {
  const long long* key;   // [key_rows, 2] or null (then k0, k1)
  int key_rows;           // 1: every row reads key[0]
  uint32_t k0, k1;
  int n_folds;
  uint32_t folds[4];
  const long long* row_data[2];  // [rows] each, or null
  long long rows, n;
  int mode;
  float lo, span, p;
  int out_u8;             // bernoulli: 1 writes uint8, 0 float32
  void* out;
};

__global__ void __launch_bounds__(kThreads)
threefry_kernel(const Params p) {
  __shared__ uint32_t skey[2];
  const long long row = blockIdx.y;
  if (threadIdx.x == 0) {
    uint32_t k0 = p.k0, k1 = p.k1;
    if (p.key != nullptr) {
      const long long kr = p.key_rows == 1 ? 0 : row;
      k0 = (uint32_t)p.key[2 * kr];
      k1 = (uint32_t)p.key[2 * kr + 1];
    }
    for (int f = 0; f < p.n_folds; ++f) fold(k0, k1, p.folds[f]);
    for (int f = 0; f < 2; ++f)
      if (p.row_data[f] != nullptr) fold(k0, k1, (uint32_t)p.row_data[f][row]);
    skey[0] = k0;
    skey[1] = k1;
  }
  __syncthreads();
  const uint32_t k0 = skey[0], k1 = skey[1];
  if (p.mode == kKey) {
    if (blockIdx.x == 0 && threadIdx.x == 0) {
      long long* out = (long long*)p.out;
      out[2 * row] = k0;
      out[2 * row + 1] = k1;
    }
    return;
  }
  const long long base =
      (long long)blockIdx.x * (kThreads * kPerThread) + threadIdx.x;
#pragma unroll
  for (int j = 0; j < kPerThread; ++j) {
    const long long i = base + (long long)j * kThreads;
    if (i >= p.n) return;
    uint32_t x0 = (uint32_t)(i >> 32), x1 = (uint32_t)i;
    hash(k0, k1, x0, x1);
    const long long o = row * p.n + i;
    const uint32_t bits = x0 ^ x1;
    if (p.mode == kBits) {
      ((long long*)p.out)[o] = bits;
      continue;
    }
    const float f = __uint_as_float((bits >> 9) | 0x3F800000u) - 1.0f;
    if (p.mode == kUniform) {
      ((float*)p.out)[o] = fmaxf(p.lo, __fmaf_rn(f, p.span, p.lo));
    } else if (p.out_u8) {
      ((uint8_t*)p.out)[o] = f < p.p ? 1 : 0;
    } else {
      ((float*)p.out)[o] = f < p.p ? 1.0f : 0.0f;
    }
  }
}

}  // namespace

extern "C" int paddle_threefry(
    const void* key, int key_rows, unsigned int k0, unsigned int k1,
    int n_folds, unsigned int f0, unsigned int f1, unsigned int f2,
    unsigned int f3, const void* row_data0, const void* row_data1,
    long long rows, long long n, int mode, float lo, float span, float prob,
    int out_u8, void* out, void* stream) {
  if (rows < 1 || rows > 65535 || n < 0 || n_folds < 0 || n_folds > 4)
    return (int)cudaErrorInvalidValue;
  Params p;
  p.key = (const long long*)key;
  p.key_rows = key_rows;
  p.k0 = k0;
  p.k1 = k1;
  p.n_folds = n_folds;
  p.folds[0] = f0;
  p.folds[1] = f1;
  p.folds[2] = f2;
  p.folds[3] = f3;
  p.row_data[0] = (const long long*)row_data0;
  p.row_data[1] = (const long long*)row_data1;
  p.rows = rows;
  p.n = n;
  p.mode = mode;
  p.lo = lo;
  p.span = span;
  p.p = prob;
  p.out_u8 = out_u8;
  p.out = out;
  const long long per_block = (long long)kThreads * kPerThread;
  long long bx = mode == kKey ? 1 : (n + per_block - 1) / per_block;
  if (bx < 1) bx = 1;
  if (bx > 2147483647LL) return (int)cudaErrorInvalidValue;
  dim3 grid((unsigned)bx, (unsigned)rows);
  threefry_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(p);
  return (int)cudaGetLastError();
}
