// The CTC loss for the H100 (K5): log-softmax, the alpha lattice, the
// loss and dLogits of a sequence in one launch, as warp-ctc does.
//
// Replaces no TPU kernel. The JAX package runs the alpha recursion as a
// lax.scan inside its one XLA executable (paddle_tpu/ops/ctc_ops.py:
// 63-94) and differentiates it with jax.vjp over the scan; the port
// interprets one eager op at a time, where the same scan in torch ops is
// T host steps of about a dozen launches each, and as many for the
// gradient. Wrapper and plain version: kernels/ctc.py.
//
// logits [B, T, V] raw activations, label [B, L], t_len and l_len [B]
// (l_len clipped to 0..L) -> loss [B] and, where dlogits is not null,
// dLogits [B, T, V] for an upstream gradient of 1. The lattice is the
// JAX op's: S = 2L + 1 states, ext = blank, l0, blank, l1, ..., blank;
// log space with NEG = -1e30 for an unreachable state; on a live frame
// (t < t_len) alpha_t[s] = lse3(alpha[s], alpha[s-1], alpha[s-2] where
// the skip is allowed) + lp_t[ext[s]], NEG past 2 l_len; lse3(a, b, c)
// = m + log(e^(a-m) + e^(b-m) + e^(c-m)), m = max(a, b, c, NEG). The
// loss is -logsumexp(alpha[2 l_len], alpha[2 l_len - 1]), divided by
// max(t_len, 1) under norm_by_times. dLogits is the adjoint of that
// recursion: a state's gradient goes to its three predecessors in the
// shares e^(x-m) / (e_a + e_b + e_c) of its lse3, and to lp_t[ext[s]];
// then dLogits = dlp - softmax * sum(dlp) through the log-softmax. For
// a feasible row that is softmax - occupancy / p (the beta recursion,
// normalised); for a row without a feasible alignment it is the JAX
// op's gradient of its huge finite loss.
//   Bound: bytes. The logits are read twice and dLogits written once,
//   4 B T V bytes each (CRNN: B 32, T 64, V 96: 0.8 MB, 0.7 us at 3.35
//   TB/s); the lattice work, a few exponentials a state and frame
//   (B T S = 100,352 states for 49 of them), is less. The T dependent
//   steps, each a barrier, set the time, forward and back.
//   Design: one block of 128 threads a sequence. A warp a frame for the
//   log-sum-exp of its V activations (shuffle reductions), kept in a
//   device buffer; a thread a lattice state for the recursion, the
//   alpha of every frame in a device buffer [B, T, S] (the wrapper's);
//   going back, a thread a state computes its predecessors' shares and
//   then gathers its own gradient from its successors (no atomics), and
//   a thread a class sums the states that emit it, in state order, so
//   the result does not depend on the schedule.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr float kNeg = -1e30f;

__device__ __forceinline__ float warp_max(float v) {
  for (int o = 16; o > 0; o >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float warp_sum(float v) {
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

// the block's max of v (every thread passes one); red holds 32 floats
__device__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float m = -INFINITY;
  for (int i = 0; i < (blockDim.x >> 5); ++i) m = fmaxf(m, red[i]);
  return m;
}

// the three predecessors of state s at alpha row a: (a, b, c), the skip
// only where allowed
__device__ __forceinline__ void preds(const float* a, const int* skip,
                                      int s, float* p) {
  p[0] = a[s];
  p[1] = s >= 1 ? a[s - 1] : kNeg;
  p[2] = (s >= 2 && skip[s]) ? a[s - 2] : kNeg;
}

__global__ void ctc_kernel(const float* __restrict__ logits,
                           const int* __restrict__ label,
                           const int* __restrict__ t_lens,
                           const int* __restrict__ l_lens, int T, int V,
                           int L, int blank, int norm,
                           float* __restrict__ lse_buf,
                           float* __restrict__ alpha_buf,
                           float* __restrict__ loss,
                           float* __restrict__ dlogits) {
  extern __shared__ int sm[];
  const int S = 2 * L + 1;
  int* ext = sm;                                      // S
  int* skip = ext + S;                                // S
  float* g = reinterpret_cast<float*>(skip + S);     // S, the gradient
  float* gn = g + S;                                  // S, this frame's
  float* w0 = gn + S;                                 // S, the shares
  float* w1 = w0 + S;
  float* w2 = w1 + S;
  const int b = blockIdx.x;
  const int tl = t_lens[b];
  int nl = l_lens[b];
  nl = nl < 0 ? 0 : (nl > L ? L : nl);
  const int n_valid = 2 * nl + 1;
  const float* xb = logits + static_cast<size_t>(b) * T * V;
  float* lse = lse_buf + static_cast<size_t>(b) * T;
  float* ab = alpha_buf + static_cast<size_t>(b) * T * S;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const int e = (s & 1) ? label[static_cast<size_t>(b) * L + (s - 1) / 2]
                          : blank;
    ext[s] = e;
  }
  __syncthreads();
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    skip[s] = (s & 1) && (s < 2 || ext[s] != ext[s - 2]);
  // each frame's log-sum-exp: a warp a frame
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int t = warp; t < T; t += blockDim.x >> 5) {
    const float* row = xb + static_cast<size_t>(t) * V;
    float m = -INFINITY;
    for (int v = lane; v < V; v += 32) m = fmaxf(m, row[v]);
    m = warp_max(m);
    float s = 0.f;
    for (int v = lane; v < V; v += 32) s += expf(row[v] - m);
    s = warp_sum(s);
    if (lane == 0) lse[t] = m + logf(s);
  }
  __syncthreads();
  // alpha_0, raw in shared memory (the loss's) and normalised in the
  // device buffer (the gradient's)
  float* raw = w2 + S;                                // 2 S, double-buffered
  float* red = raw + 2 * S;                           // 32
  int cur = 0;
  float cmax = -INFINITY;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float v = kNeg;
    if (s == 0) v = xb[blank] - lse[0];
    if (s == 1 && nl > 0) v = xb[ext[1]] - lse[0];
    raw[s] = v;
    cmax = fmaxf(cmax, v);
  }
  cmax = block_max(cmax, red);
  for (int s = threadIdx.x; s < S; s += blockDim.x) ab[s] = raw[s] - cmax;
  __syncthreads();
  for (int t = 1; t < T; ++t) {
    const float* prev = ab + static_cast<size_t>(t - 1) * S;
    float* an = ab + static_cast<size_t>(t) * S;
    if (t >= tl) {  // a carried frame
      for (int s = threadIdx.x; s < S; s += blockDim.x) an[s] = prev[s];
      __syncthreads();
      continue;
    }
    const float* rp = raw + cur * S;
    float* rn = raw + (cur ^ 1) * S;
    const float* row = xb + static_cast<size_t>(t) * V;
    cmax = -INFINITY;
    float vn[4];
    int q = 0;
    for (int s = threadIdx.x; s < S; s += blockDim.x, ++q) {
      float v = kNeg, n = kNeg;
      if (s < n_valid) {
        const float e = row[ext[s]] - lse[t];
        float p[3];
        preds(rp, skip, s, p);
        float m = fmaxf(fmaxf(fmaxf(p[0], p[1]), p[2]), kNeg);
        v = m + logf(expf(p[0] - m) + expf(p[1] - m) + expf(p[2] - m)) + e;
        preds(prev, skip, s, p);
        m = fmaxf(fmaxf(fmaxf(p[0], p[1]), p[2]), kNeg);
        n = m + logf(expf(p[0] - m) + expf(p[1] - m) + expf(p[2] - m)) + e;
      }
      rn[s] = v;
      vn[q & 3] = n;
      cmax = fmaxf(cmax, n);
    }
    cmax = block_max(cmax, red);
    q = 0;
    for (int s = threadIdx.x; s < S; s += blockDim.x, ++q)
      an[s] = s < n_valid ? vn[q & 3] - cmax : kNeg;
    cur ^= 1;
    __syncthreads();
  }
  // the loss from the raw lattice, as the JAX op computes it
  const float* rl = raw + cur * S;
  const int i1 = 2 * nl - 1 < 0 ? 0 : 2 * nl - 1;
  const float r0 = rl[2 * nl], r1 = nl > 0 ? rl[i1] : kNeg;
  const float rm = fmaxf(r0, r1);
  const float scale = norm ? 1.f / fmaxf(static_cast<float>(tl), 1.f) : 1.f;
  if (threadIdx.x == 0)
    loss[b] = -(rm + logf(expf(r0 - rm) + expf(r1 - rm))) * scale;
  // the gradient's end shares from the normalised lattice
  const float* last = ab + static_cast<size_t>(T - 1) * S;
  const float e0 = last[2 * nl];
  const float e1 = nl > 0 ? last[i1] : kNeg;
  const float m = fmaxf(e0, e1);
  const float x0 = expf(e0 - m), x1 = expf(e1 - m);
  if (dlogits == nullptr) return;
  float* db = dlogits + static_cast<size_t>(b) * T * V;
  const float gll = -scale;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    float v = 0.f;
    if (s == 2 * nl) v += gll * x0 / (x0 + x1);
    if (nl > 0 && s == i1) v += gll * x1 / (x0 + x1);
    g[s] = v;
  }
  __syncthreads();
  for (int t = T - 1; t >= 1; --t) {
    float* out = db + static_cast<size_t>(t) * V;
    if (t >= tl) {  // a carried frame: the gradient passes unchanged
      for (int v = threadIdx.x; v < V; v += blockDim.x) out[v] = 0.f;
      continue;
    }
    const float* prev = ab + static_cast<size_t>(t - 1) * S;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      gn[s] = s < n_valid ? g[s] : 0.f;
      float p[3];
      preds(prev, skip, s, p);
      const float mm = fmaxf(fmaxf(fmaxf(p[0], p[1]), p[2]), kNeg);
      const float ea = expf(p[0] - mm), eb = expf(p[1] - mm),
                  ec = expf(p[2] - mm);
      const float den = ea + eb + ec;
      w0[s] = ea / den;
      w1[s] = s >= 1 ? eb / den : 0.f;
      w2[s] = (s >= 2 && skip[s]) ? ec / den : 0.f;
    }
    __syncthreads();
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      float v = gn[s] * w0[s];
      if (s + 1 < S) v += gn[s + 1] * w1[s + 1];
      if (s + 2 < S) v += gn[s + 2] * w2[s + 2];
      g[s] = v;
    }
    float tot = 0.f;
    for (int s = 0; s < S; ++s) tot += gn[s];
    const float* row = xb + static_cast<size_t>(t) * V;
    for (int v = threadIdx.x; v < V; v += blockDim.x) {
      float gl = 0.f;
      for (int s = 0; s < S; ++s)
        if (ext[s] == v) gl += gn[s];
      out[v] = gl - expf(row[v] - lse[t]) * tot;
    }
    __syncthreads();
  }
  // frame 0: alpha_0 takes lp_0[blank] and, with a label, lp_0[ext[1]]
  const float g0 = g[0], g1 = nl > 0 ? g[1] : 0.f;
  for (int v = threadIdx.x; v < V; v += blockDim.x) {
    float gl = 0.f;
    if (v == blank) gl += g0;
    if (nl > 0 && v == ext[1]) gl += g1;
    db[v] = gl - expf(xb[v] - lse[0]) * (g0 + g1);
  }
}

}  // namespace

extern "C" {

// logits [B, T, V] float32; label [B, L], t_len, l_len [B] int32; lse
// [B, T] and alpha [B, T, 2L + 1] float32 scratch -> loss [B], dlogits
// [B, T, V] (null: the loss only)
int paddle_ctc_loss(const void* logits, const void* label, const void* t_len,
                    const void* l_len, int B, int T, int V, int L, int blank,
                    int norm, void* lse, void* alpha, void* loss,
                    void* dlogits, void* stream) {
  const int S = 2 * L + 1;
  const size_t smem = static_cast<size_t>(S) * (2 * sizeof(int)
                                                + 7 * sizeof(float))
                      + 32 * sizeof(float);
  if (S > 4 * kThreads) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        ctc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  ctc_kernel<<<B, kThreads, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(logits), static_cast<const int*>(label),
      static_cast<const int*>(t_len), static_cast<const int*>(l_len), T, V,
      L, blank, norm, static_cast<float*>(lse), static_cast<float*>(alpha),
      static_cast<float*>(loss), static_cast<float*>(dlogits));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
