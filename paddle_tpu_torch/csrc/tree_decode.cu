// tree_decode: speculative tree-verify attention over the paged pool,
// fp32, for sm_90a.
//
// Replaces the TPU kernel `_tree_decode_kernel` (paddle_tpu/kernels/
// paged_attention.py:386, driven by `_tree_pallas` :452). Each slot holds
// base[s] committed K/V rows at storage positions 0..base-1 and the N
// nodes of a speculation tree at base..base+N-1 (node 0 is the anchor
// token), all in a block-paged pool [P,H,page_size,dh] reached through a
// page table [S,npp] (int64). Query node n of slot s attends every
// committed row, and tree row j where anc[s][n][j] > 0 (the mask carries
// the diagonal) and the row's storage position lies below max_len. A slot
// with base = -1 is finished: it reads no page and writes exactly 0.
//
// What bounds it on this card: memory. The N queries of a (slot, head)
// share one pass over its resident K and V rows (8*dh bytes a row) and do
// 4*N*dh flops on each, N/2 flops per byte against the fp32 ridge of 20,
// so for the N of a draft chain (4 to 8) the floor is the resident bytes
// over 3.35 TB/s, the same bytes the one-query decode kernel reads.
//
// What the design does about it: one block per (slot, head) walks only
// the pages below ceil(min(base + N, max_len) / page_size), reading
// table[s, p] itself, and stages each chunk of about 64 keys in shared
// memory ONCE for all N nodes (coalesced loads; a page of one head is one
// contiguous page_size*dh run). One warp owns a node (with more than 4
// nodes a warp owns 2 or 4 of them; past 16 the walk repeats per group of
// 16): a lane scores whole keys against the node's query (K rows are
// padded by one float, so the 32 lanes read 32 banks), the visibility of
// key t is the direct test
//   t < base || (t - base < N && t < max_len && anc[s][n][t - base] > 0)
// on the slot's mask held in shared memory (the TPU kernel needs a one-hot
// product for it, having no gather), the online softmax keeps each node's
// max and sum in registers, uniform over the warp, and a lane keeps the
// node's output columns lane, lane+32, ... in registers. Overlapping the
// next chunk's loads with this chunk's math (cp.async or TMA), tensor-core
// products and splitting long slots across blocks are later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkKeys = 64;   // keys staged per chunk (at least a page)
constexpr int kMaxDh = 128;      // head dims up to this
constexpr int kColsPerLane = kMaxDh / 32;
constexpr int kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowM = -1e29f;

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, off));
  return x;
}

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// NPW: tree nodes one warp owns in one walk over the pages.
template <int NPW>
__global__ void __launch_bounds__(kThreads)
tree_decode_kernel(const float* __restrict__ q,
                   const float* __restrict__ k_pool,
                   const float* __restrict__ v_pool,
                   const int64_t* __restrict__ table,
                   const int64_t* __restrict__ base_lens,
                   const int64_t* __restrict__ anc,
                   float* __restrict__ out, int H, int N, int ps, int dh,
                   int npp, int max_len, int chunk_pages, float sm_scale) {
  constexpr int G = kWarps * NPW;  // nodes per walk
  extern __shared__ float smem[];
  const int keys_max = chunk_pages * ps;
  const int kstride = dh + 1;
  float* k_s = smem;                       // [keys_max][dh + 1]
  float* v_s = k_s + keys_max * kstride;   // [keys_max][dh]
  float* q_s = v_s + keys_max * dh;        // [G][dh], scaled
  float* p_s = q_s + G * dh;               // [G][keys_max] scores, then p
  unsigned char* anc_s =
      reinterpret_cast<unsigned char*>(p_s + G * keys_max);  // [G][N]

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  const long long base = base_lens[s];
  long long scan = 0;
  if (base >= 0) {
    scan = base + N;
    if (scan > max_len) scan = max_len;
    const long long cover = (long long)npp * ps;
    if (scan > cover) scan = cover;
  }
  const int n_pages = (int)((scan + ps - 1) / ps);
  const size_t page_elems = (size_t)ps * dh;
  const size_t sh = ((size_t)s * H + h) * N * dh;

  for (int n0 = 0; n0 < N; n0 += G) {
    const int gn = min(G, N - n0);
    __syncthreads();  // the previous walk is done with q_s, anc_s and p_s
    for (int i = tid; i < gn * dh; i += kThreads)
      q_s[i] = q[sh + (size_t)n0 * dh + i] * sm_scale;
    for (int i = tid; i < gn * N; i += kThreads)
      anc_s[i] = anc[((size_t)s * N + n0) * N + i] > 0 ? 1 : 0;

    float acc[NPW][kColsPerLane];
    float m[NPW], l[NPW];
#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      m[i] = kNegInf;
      l[i] = 0.f;
#pragma unroll
      for (int ci = 0; ci < kColsPerLane; ++ci) acc[i][ci] = 0.f;
    }

    for (int p0 = 0; p0 < n_pages; p0 += chunk_pages) {
      const int np = min(chunk_pages, n_pages - p0);
      const int nk = np * ps;
      __syncthreads();  // q and mask staged; previous chunk fully consumed
      for (int pi = 0; pi < np; ++pi) {
        const long long page = table[(size_t)s * npp + p0 + pi];
        const float* kp = k_pool + ((size_t)page * H + h) * page_elems;
        const float* vp = v_pool + ((size_t)page * H + h) * page_elems;
        float* kd = k_s + (size_t)pi * ps * kstride;
        float* vd = v_s + pi * page_elems;
        for (int i = tid; i < (int)page_elems; i += kThreads) {
          kd[(i / dh) * kstride + (i % dh)] = kp[i];
          vd[i] = vp[i];
        }
      }
      __syncthreads();
#pragma unroll
      for (int i = 0; i < NPW; ++i) {
        const int ln = warp + i * kWarps;  // the warp's i-th node of the walk
        if (ln >= gn) continue;            // uniform over the warp
        const float* qn = q_s + ln * dh;
        float* pn = p_s + ln * keys_max;
        const unsigned char* an = anc_s + ln * N;
        float cmax = kNegInf;
        for (int j = lane; j < nk; j += 32) {
          const float* kr = k_s + j * kstride;
          float dot = 0.f;
          for (int c = 0; c < dh; ++c) dot += qn[c] * kr[c];
          const long long t = (long long)p0 * ps + j;
          const long long tj = t - base;
          const bool vis = tj < 0 || (tj < N && t < max_len && an[tj] != 0);
          const float sc = vis ? dot : kNegInf;
          pn[j] = sc;
          cmax = fmaxf(cmax, sc);
        }
        cmax = warp_max(cmax);
        const float m_new = fmaxf(m[i], cmax);
        const float alpha = expf(m[i] - m_new);
        float psum = 0.f;
        for (int j = lane; j < nk; j += 32) {
          const float sc = pn[j];
          const float p = sc <= kMaskedRowM ? 0.f : expf(sc - m_new);
          pn[j] = p;
          psum += p;
        }
        psum = warp_sum(psum);
        __syncwarp();  // every lane's p is in shared memory
#pragma unroll
        for (int ci = 0; ci < kColsPerLane; ++ci) acc[i][ci] *= alpha;
        for (int j = 0; j < nk; ++j) {
          const float p = pn[j];
          const float* vr = v_s + j * dh;
#pragma unroll
          for (int ci = 0; ci < kColsPerLane; ++ci) {
            const int c = lane + 32 * ci;
            if (c < dh) acc[i][ci] += p * vr[c];
          }
        }
        l[i] = l[i] * alpha + psum;
        m[i] = m_new;
      }
    }

#pragma unroll
    for (int i = 0; i < NPW; ++i) {
      const int ln = warp + i * kWarps;
      if (ln >= gn) continue;
      const bool dead = m[i] <= kMaskedRowM;
      const float inv = 1.f / fmaxf(l[i], 1e-30f);
      float* o = out + sh + (size_t)(n0 + ln) * dh;
#pragma unroll
      for (int ci = 0; ci < kColsPerLane; ++ci) {
        const int c = lane + 32 * ci;
        if (c < dh) o[c] = dead ? 0.f : acc[i][ci] * inv;
      }
    }
  }
}

template <int NPW>
int launch(const float* q, const float* k_pool, const float* v_pool,
           const int64_t* table, const int64_t* base_lens,
           const int64_t* anc, float* out, int S, int H, int N, int ps,
           int dh, int npp, int max_len, float sm_scale,
           cudaStream_t stream) {
  constexpr int G = kWarps * NPW;
  const int chunk_pages = ps >= kChunkKeys ? 1 : kChunkKeys / ps;
  const int keys_max = chunk_pages * ps;
  const size_t smem =
      sizeof(float) * ((size_t)keys_max * (dh + 1) + (size_t)keys_max * dh +
                       (size_t)G * dh + (size_t)G * keys_max) +
      (size_t)G * N;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        tree_decode_kernel<NPW>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(S, H);
  tree_decode_kernel<NPW><<<grid, kThreads, smem, stream>>>(
      q, k_pool, v_pool, table, base_lens, anc, out, H, N, ps, dh, npp,
      max_len, chunk_pages, sm_scale);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). Page
// ids in `table` must lie in [0, P) for every page below
// ceil(min(base + N, max_len) / ps) of a slot with base >= 0; entries past
// that, and every entry of a slot with base < 0, are never read.
extern "C" int paddle_tree_decode_f32(const float* q, const float* k_pool,
                                      const float* v_pool,
                                      const int64_t* table,
                                      const int64_t* base_lens,
                                      const int64_t* anc, float* out, int S,
                                      int H, int N, int ps, int dh, int npp,
                                      int max_len, float sm_scale,
                                      void* stream) {
  if (S < 1 || H < 1 || N < 1 || ps < 1 || dh < 1 || dh > kMaxDh ||
      npp < 1 || max_len < 0)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (N <= kWarps)
    return launch<1>(q, k_pool, v_pool, table, base_lens, anc, out, S, H, N,
                     ps, dh, npp, max_len, sm_scale, st);
  if (N <= 2 * kWarps)
    return launch<2>(q, k_pool, v_pool, table, base_lens, anc, out, S, H, N,
                     ps, dh, npp, max_len, sm_scale, st);
  return launch<4>(q, k_pool, v_pool, table, base_lens, anc, out, S, H, N,
                   ps, dh, npp, max_len, sm_scale, st);
}
