// The linear-chain CRF's recursions for the H100: the log-partition's
// forward and backward (K3) and the Viterbi decode (K4).
//
// Replace no TPU kernel. The JAX package runs the recursions as
// lax.scans inside its one XLA executable (paddle_tpu/ops/crf_ops.py:
// 44-55, the forward recursion, differentiated by jax.vjp over the
// scan; :107-137, the Viterbi recursion and its backtrack); the port
// interprets one eager op at a time, where the same scan in torch ops is
// T host steps of several launches each, and as many for the gradient.
// These kernels run each recursion in one launch. Wrappers and plain
// versions: kernels/crf.py.
//
// Transitions [K + 2, K]: row 0 the start weights a, row 1 the stop
// weights b, rows 2.. w[prev][cur]. Emissions x [B, T, K], lengths [B]
// (int32); a step t >= len carries its row's scores. K <= 1024: a
// thread a tag.
//
// K3 paddle_crf_logz: -> alpha [B, T, K] (the carried scores after each
// step, as the JAX op returns them), log Z [B], and the normalised
// alpha an [B, T, K] that the backward reads: alpha_0 = a + x_0;
// alpha_t[j] = logsumexp_i(alpha_{t-1}[i] + w[i][j]) + x_t[j] on a live
// step; log Z = logsumexp_j(alpha_{T-1}[j] + b[j]). The same recursion
// runs on an_t = alpha_t - logsumexp_j(alpha_t), each step renormalised,
// so its values stay near 0 where alpha's grow with t.
// paddle_crf_logz_bwd: the gradient of log Z times g [B], from an and
// a normalised beta recursion over a row's n = clamp(len, 1, T) live
// steps: bn_{n-1} = b, bn_{t-1}[i] = logsumexp_j(w[i][j] + x_t[j] +
// bn_t[j]), each renormalised. The unary marginal P_t(j) = exp(an_t[j]
// + bn_t[j]) normalised over j, the pairwise marginal P_t(i, j) =
// exp(an_{t-1}[i] + w[i][j] + x_t[j] + bn_t[j]) normalised over (i, j):
// both are ratios of terms near 1, so float32 keeps ~1e-7 of them,
// where alpha_t + beta_t - log Z over sums of hundreds keeps ~1e-5. dx
// [t][j] = g P_t(j), 0 past n; da = g P_0, db = g P_{n-1}, dw[i][j] = g
// sum_{t=1}^{n-1} P_t(i, j). Each block writes its partial dtrans [K +
// 2, K]; a second pass sums the B partials in block order
// (deterministic, no atomics).
//   Bound: operations. A step is about K^2 exponentials and adds a row
//   (the role labeller: B 32, T 80, K 59, about 1,300 live steps: 4.5 M
//   exponentials a recursion), the bytes 4 B T K an array (0.6 MB):
//   both a few microseconds of the card; the T dependent steps, each a
//   few barriers, set the time.
//   Design: one block a sequence, a thread a tag (blockDim K rounded up
//   to a warp), the transitions staged in shared memory once; the
//   normalisers are block reductions (warp shuffles, then the warps'
//   partials); in the backward a thread owns its column of the block's
//   K x K pairwise sums, so they need no atomics.
//
// K4 paddle_crf_viterbi: -> path [B, T] int64, zero past each length.
// delta_0 = a + x_0; on a live step scores[i][j] = delta[i] + w[i][j],
// bp_t[j] = the first argmax over i (jnp.argmax's tie rule), delta[j] =
// max + x_t[j]; the last tag is the first argmax of delta + b; the
// backtrack follows bp from the row's last live step (steps past it are
// 0). Every add is rounded on its own (__fadd_rn), in the plain
// version's order, so the path is the plain version's bit for bit.
//   Bound: operations, K^2 adds and compares a step (4.5 M for the role
//   labeller): a few microseconds; the T dependent steps set the time,
//   and the backtrack's T dependent loads.
//   Design: one block a sequence, a thread a tag, the transitions in
//   shared memory; the backpointers [B, T, K] int32 in a device buffer
//   (the wrapper's), read back by one thread in the backtrack.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

template <typename Kern>
int allow_smem(Kern kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

// the transitions into shared memory
__device__ __forceinline__ void stage(const float* trans, float* s_tr,
                                      int K) {
  for (int i = threadIdx.x; i < (K + 2) * K; i += blockDim.x)
    s_tr[i] = trans[i];
}

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's max of v (every thread passes one; -inf where it has
// none); s_red holds 32 floats. Every thread gets the result.
__device__ float block_max(float v, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float m = -INFINITY;
  for (int i = 0; i < nw; ++i) m = fmaxf(m, s_red[i]);
  return m;
}

// the block's sum of v, in warp order
__device__ float block_sum(float v, float* s_red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = (blockDim.x + 31) >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) s_red[warp] = v;
  __syncthreads();
  float s = 0.f;
  for (int i = 0; i < nw; ++i) s += s_red[i];
  return s;
}

// logsumexp over the block of v (-inf where a thread has no tag)
__device__ float block_lse(float v, float* s_red) {
  const float m = block_max(v, s_red);
  return m + logf(block_sum(v == -INFINITY ? 0.f : expf(v - m), s_red));
}

// logsumexp_i(a[i] + w[i * K + j]) over the K rows of column j
__device__ __forceinline__ float col_lse(const float* a, const float* w,
                                         int K, int j) {
  float m = -INFINITY;
  for (int i = 0; i < K; ++i) m = fmaxf(m, a[i] + w[i * K + j]);
  float s = 0.f;
  for (int i = 0; i < K; ++i) s += expf(a[i] + w[i * K + j] - m);
  return m + logf(s);
}

__global__ void crf_logz_kernel(const float* __restrict__ x,
                                const float* __restrict__ trans,
                                const int* __restrict__ lens, int T, int K,
                                float* __restrict__ alpha,
                                float* __restrict__ alpha_n,
                                float* __restrict__ logz) {
  extern __shared__ float smem[];
  float* s_tr = smem;                  // (K + 2) K
  float* s_a = s_tr + (K + 2) * K;     // K, the carried alpha
  float* s_n = s_a + K;                // K, the carried normalised alpha
  float* s_red = s_n + K;              // 32
  const int b = blockIdx.x, j = threadIdx.x;
  const bool tag = j < K;
  const int len = lens[b];
  const size_t base = static_cast<size_t>(b) * T * K;
  stage(trans, s_tr, K);
  __syncthreads();
  const float* w = s_tr + 2 * K;
  float v = tag ? s_tr[j] + x[base + j] : -INFINITY;
  float vn = v - block_lse(v, s_red);
  if (tag) {
    s_a[j] = v;
    s_n[j] = vn;
    alpha[base + j] = v;
    alpha_n[base + j] = vn;
  }
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const size_t o = base + static_cast<size_t>(t) * K + j;
    if (t < len) {
      const float xt = tag ? x[o] : 0.f;
      v = tag ? col_lse(s_a, w, K, j) + xt : -INFINITY;
      vn = tag ? col_lse(s_n, w, K, j) + xt : -INFINITY;
      vn -= block_lse(vn, s_red);  // its barriers order the reads above
      if (tag) {
        s_a[j] = v;
        s_n[j] = vn;
      }
      __syncthreads();
    }
    if (tag) {
      alpha[o] = v;
      alpha_n[o] = vn;
    }
  }
  const float z = block_lse(tag ? v + s_tr[K + j] : -INFINITY, s_red);
  if (j == 0) logz[b] = z;
}

__global__ void crf_logz_bwd_kernel(
    const float* __restrict__ x, const float* __restrict__ trans,
    const int* __restrict__ lens, const float* __restrict__ alpha_n,
    const float* __restrict__ gz, int T, int K, float* __restrict__ part,
    float* __restrict__ dx) {
  extern __shared__ float smem[];
  float* s_tr = smem;                  // (K + 2) K
  float* s_dw = s_tr + (K + 2) * K;    // K K, this block's pairwise sums
  float* s_u = s_dw + K * K;           // K, x_t + bn_t
  float* s_red = s_u + K;              // 32
  const int b = blockIdx.x, j = threadIdx.x;
  const bool tag = j < K;
  int n = lens[b];
  n = n < 1 ? 1 : (n > T ? T : n);
  const float g = gz[b];
  const size_t base = static_cast<size_t>(b) * T * K;
  stage(trans, s_tr, K);
  for (int i = threadIdx.x; i < K * K; i += blockDim.x) s_dw[i] = 0.f;
  // dx is 0 past the row's live steps
  for (int i = threadIdx.x; i < (T - n) * K; i += blockDim.x)
    dx[base + static_cast<size_t>(n) * K + i] = 0.f;
  __syncthreads();
  const float* w = s_tr + 2 * K;
  float bn = tag ? s_tr[K + j] : -INFINITY;
  float p0 = 0.f, pn = 0.f;
  for (int t = n - 1; t >= 0; --t) {
    const size_t o = base + static_cast<size_t>(t) * K + j;
    const float e = tag ? alpha_n[o] + bn : -INFINITY;
    const float lse = block_lse(e, s_red);  // every thread: its barriers
    const float p = tag ? g * expf(e - lse) : 0.f;
    if (tag) dx[o] = p;
    if (t == n - 1) pn = p;
    if (t == 0) {
      p0 = p;
      break;
    }
    if (tag) s_u[j] = x[o] + bn;
    __syncthreads();
    // column j of the pairwise marginals of (t - 1, t): its terms over
    // the block's normaliser
    const float* ap = alpha_n + base + static_cast<size_t>(t - 1) * K;
    float m = -INFINITY, col = 0.f;
    if (tag) {
      for (int i = 0; i < K; ++i) m = fmaxf(m, ap[i] + w[i * K + j]);
      m += s_u[j];
      for (int i = 0; i < K; ++i) col += expf(ap[i] + w[i * K + j] + s_u[j]
                                              - m);
    }
    const float mm = block_max(m, s_red);
    const float total = block_sum(tag ? col * expf(m - mm) : 0.f, s_red);
    if (tag) {
      const float scale = g / total;
      for (int i = 0; i < K; ++i)
        s_dw[i * K + j] += scale * expf(ap[i] + w[i * K + j] + s_u[j] - mm);
    }
    // bn_{t-1}[i], thread i, renormalised
    float v = -INFINITY;
    if (tag) {
      float mv = -INFINITY;
      for (int k = 0; k < K; ++k) mv = fmaxf(mv, w[j * K + k] + s_u[k]);
      float s = 0.f;
      for (int k = 0; k < K; ++k) s += expf(w[j * K + k] + s_u[k] - mv);
      v = mv + logf(s);
    }
    bn = v - block_lse(v, s_red);  // its barriers close the step
  }
  __syncthreads();
  float* pb = part + static_cast<size_t>(b) * (K + 2) * K;
  if (tag) {
    pb[j] = p0;
    pb[K + j] = pn;
  }
  for (int i = threadIdx.x; i < K * K; i += blockDim.x)
    pb[2 * K + i] = s_dw[i];
}

// dtrans = the sum of the B blocks' partials, in block order
__global__ void crf_sum_kernel(const float* __restrict__ part, int B,
                               int n, float* __restrict__ out) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  float s = 0.f;
  for (int b = 0; b < B; ++b) s += part[static_cast<size_t>(b) * n + i];
  out[i] = s;
}

__global__ void crf_viterbi_kernel(const float* __restrict__ x,
                                   const float* __restrict__ trans,
                                   const int* __restrict__ lens, int T,
                                   int K, int* __restrict__ bps,
                                   int64_t* __restrict__ path) {
  extern __shared__ float smem[];
  float* s_tr = smem;                  // (K + 2) K
  float* s_d = s_tr + (K + 2) * K;     // K, delta
  float* s_e = s_d + K;                // K, delta_{T-1} + b
  const int b = blockIdx.x, j = threadIdx.x;
  const bool tag = j < K;
  const int len = lens[b];
  const float* xb = x + static_cast<size_t>(b) * T * K;
  int* bb = bps + static_cast<size_t>(b) * T * K;
  stage(trans, s_tr, K);
  __syncthreads();
  const float* w = s_tr + 2 * K;
  if (tag) s_d[j] = __fadd_rn(s_tr[j], xb[j]);
  __syncthreads();
  for (int t = 1; t < len && t < T; ++t) {
    float v = 0.f;
    if (tag) {
      float best = __fadd_rn(s_d[0], w[j]);
      int arg = 0;
      for (int i = 1; i < K; ++i) {
        const float s = __fadd_rn(s_d[i], w[i * K + j]);
        if (s > best) {
          best = s;
          arg = i;
        }
      }
      bb[static_cast<size_t>(t) * K + j] = arg;
      v = __fadd_rn(best, xb[static_cast<size_t>(t) * K + j]);
    }
    __syncthreads();
    if (tag) s_d[j] = v;
    __syncthreads();
  }
  if (tag) s_e[j] = __fadd_rn(s_d[j], s_tr[K + j]);
  __syncthreads();
  if (j != 0) return;
  int best_tag = 0;
  float best = s_e[0];
  for (int k = 1; k < K; ++k) {
    if (s_e[k] > best) {
      best = s_e[k];
      best_tag = k;
    }
  }
  int64_t* pr = path + static_cast<size_t>(b) * T;
  const int last = (len < T ? len : T) - 1;  // -1 for a row of length 0
  for (int t = T - 1; t > last && t >= 0; --t) pr[t] = 0;
  if (last < 0) return;
  pr[last] = best_tag;
  for (int t = last - 1; t >= 0; --t) {
    best_tag = bb[static_cast<size_t>(t + 1) * K + best_tag];
    pr[t] = best_tag;
  }
}

int threads_for(int K) { return (K + 31) / 32 * 32; }

}  // namespace

extern "C" {

// x [B, T, K], trans [K + 2, K] float32; lens [B] int32 -> alpha and
// alpha_n [B, T, K], logz [B]
int paddle_crf_logz(const void* x, const void* trans, const void* lens,
                    int B, int T, int K, void* alpha, void* alpha_n,
                    void* logz, void* stream) {
  if (K > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((K + 2) * K + 2 * K + 32);
  const int err = allow_smem(crf_logz_kernel, smem);
  if (err) return err;
  crf_logz_kernel<<<B, threads_for(K), smem,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(trans),
      static_cast<const int*>(lens), T, K, static_cast<float*>(alpha),
      static_cast<float*>(alpha_n), static_cast<float*>(logz));
  return static_cast<int>(cudaGetLastError());
}

// the gradient of logz times g [B] from alpha_n: part [B, K + 2, K]
// scratch -> dx [B, T, K], dtrans [K + 2, K]
int paddle_crf_logz_bwd(const void* x, const void* trans, const void* lens,
                        const void* alpha_n, const void* g, int B, int T,
                        int K, void* part, void* dx, void* dtrans,
                        void* stream) {
  if (K > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = sizeof(float) * ((K + 2) * K + K * K + K + 32);
  const int err = allow_smem(crf_logz_bwd_kernel, smem);
  if (err) return err;
  crf_logz_bwd_kernel<<<B, threads_for(K), smem, st>>>(
      static_cast<const float*>(x), static_cast<const float*>(trans),
      static_cast<const int*>(lens), static_cast<const float*>(alpha_n),
      static_cast<const float*>(g), T, K, static_cast<float*>(part),
      static_cast<float*>(dx));
  const int e1 = static_cast<int>(cudaGetLastError());
  if (e1) return e1;
  const int n = (K + 2) * K;
  crf_sum_kernel<<<(n + 255) / 256, 256, 0, st>>>(
      static_cast<const float*>(part), B, n, static_cast<float*>(dtrans));
  return static_cast<int>(cudaGetLastError());
}

// x [B, T, K], trans [K + 2, K] float32; lens [B] int32; bps [B, T, K]
// int32 scratch -> path [B, T] int64
int paddle_crf_viterbi(const void* x, const void* trans, const void* lens,
                       int B, int T, int K, void* bps, void* path,
                       void* stream) {
  if (K > 1024) return static_cast<int>(cudaErrorInvalidValue);
  const size_t smem = sizeof(float) * ((K + 2) * K + 2 * K);
  const int err = allow_smem(crf_viterbi_kernel, smem);
  if (err) return err;
  crf_viterbi_kernel<<<B, threads_for(K), smem,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(x), static_cast<const float*>(trans),
      static_cast<const int*>(lens), T, K, static_cast<int*>(bps),
      static_cast<int64_t*>(path));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
