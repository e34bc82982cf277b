// paged_decode: ragged paged-attention decode, fp32, for sm_90a.
//
// Replaces the TPU kernel `_paged_decode_kernel` (paddle_tpu/kernels/
// paged_attention.py:184, driven by `_paged_pallas` :240). One query token
// per slot attends over that slot's resident K/V rows, which live in a
// block-paged pool [P,H,page_size,dh] reached through a page table
// [S,npp] (int64). A slot's scan stops at its own length: the block reads
// table[s, p] itself for p < ceil(lengths[s] / page_size) only, so the
// aliased tail of the table is never touched, and a slot of length 0
// reads no page and writes exactly 0. Any page_size >= 1 works.
//
// What bounds it on this card: memory. Each resident token's K and V
// rows (8*dh bytes) are read once for 2*dh flops of score and 2*dh of
// output, half a flop per byte against the fp32 ridge of 20, so the floor
// is the resident bytes over 3.35 TB/s (grid_accounting in
// kernels/paged_attention.py counts them).
//
// What the design does about it: one block per (slot, head) walks only
// the slot's resident pages (bytes follow the resident length, not
// num_slots * max_length). Pages are staged into shared memory in chunks
// of about 64 keys with coalesced loads (a page of one head is one
// contiguous page_size*dh run), each warp scores whole keys with a
// shuffle reduction, and the online softmax keeps max, sum and the
// output row in registers. Overlapping the next chunk's loads with this
// chunk's math (cp.async or TMA), and splitting long slots across
// blocks, is later work.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkKeys = 64;   // keys staged per chunk (at least a page)
constexpr int kMaxDh = 128;      // head dims up to this, one column a thread
constexpr int kMaxSmem = 227 * 1024;
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowM = -1e29f;

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(const float* __restrict__ q,
                    const float* __restrict__ k_pool,
                    const float* __restrict__ v_pool,
                    const int64_t* __restrict__ table,
                    const int64_t* __restrict__ lengths,
                    float* __restrict__ out, int H, int ps, int dh, int npp,
                    int chunk_pages, float sm_scale) {
  extern __shared__ float smem[];
  const int keys_max = chunk_pages * ps;
  float* k_s = smem;                    // [keys_max][dh]
  float* v_s = k_s + keys_max * dh;     // [keys_max][dh]
  float* q_s = v_s + keys_max * dh;     // [dh]
  float* p_s = q_s + dh;                // [keys_max] scores of a chunk

  const int s = blockIdx.x;
  const int h = blockIdx.y;
  const int tid = threadIdx.x;
  const int warp = tid / 32;
  const int lane = tid % 32;

  long long len = lengths[s];
  if (len < 0) len = 0;
  const long long want = (len + ps - 1) / ps;
  const int n_pages = (int)(want < npp ? want : npp);

  for (int c = tid; c < dh; c += kThreads)
    q_s[c] = q[((size_t)s * H + h) * dh + c] * sm_scale;

  float acc = 0.f;  // output column `tid` (threads past dh idle here)
  float m = kNegInf;
  float l = 0.f;
  const size_t page_elems = (size_t)ps * dh;

  for (int p0 = 0; p0 < n_pages; p0 += chunk_pages) {
    const int np = min(chunk_pages, n_pages - p0);
    const int nk = np * ps;
    __syncthreads();  // q staged; previous chunk fully consumed
    for (int pi = 0; pi < np; ++pi) {
      const long long page = table[(size_t)s * npp + p0 + pi];
      const float* kp = k_pool + ((size_t)page * H + h) * page_elems;
      const float* vp = v_pool + ((size_t)page * H + h) * page_elems;
      float* kd = k_s + pi * page_elems;
      float* vd = v_s + pi * page_elems;
      for (int i = tid; i < (int)page_elems; i += kThreads) {
        kd[i] = kp[i];
        vd[i] = vp[i];
      }
    }
    __syncthreads();
    for (int j = warp; j < nk; j += kWarps) {
      float dot = 0.f;
      for (int c = lane; c < dh; c += 32) dot += q_s[c] * k_s[j * dh + c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane == 0) {
        const long long pos = (long long)p0 * ps + j;
        p_s[j] = pos < len ? dot : kNegInf;
      }
    }
    __syncthreads();
    float cmax = kNegInf;
    for (int j = 0; j < nk; ++j) cmax = fmaxf(cmax, p_s[j]);
    const float m_new = fmaxf(m, cmax);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
    float a = acc * alpha;
    for (int j = 0; j < nk; ++j) {
      const float p = expf(p_s[j] - m_new);
      psum += p;
      if (tid < dh) a += p * v_s[j * dh + tid];
    }
    acc = a;
    l = l * alpha + psum;
    m = m_new;
  }
  if (tid < dh)
    out[((size_t)s * H + h) * dh + tid] =
        m <= kMaskedRowM ? 0.f : acc / fmaxf(l, 1e-30f);
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success). Page
// ids in `table` must lie in [0, P) for every page a slot's length
// reaches; entries past that are never read.
extern "C" int paddle_paged_decode_f32(const float* q, const float* k_pool,
                                       const float* v_pool,
                                       const int64_t* table,
                                       const int64_t* lengths, float* out,
                                       int S, int H, int ps, int dh, int npp,
                                       float sm_scale, void* stream) {
  if (S < 1 || H < 1 || ps < 1 || dh < 1 || dh > kMaxDh || npp < 1)
    return (int)cudaErrorInvalidValue;
  const int chunk_pages = ps >= kChunkKeys ? 1 : kChunkKeys / ps;
  const int keys_max = chunk_pages * ps;
  const size_t smem = sizeof(float) * ((size_t)2 * keys_max * dh + dh +
                                       keys_max);
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  dim3 grid(S, H);
  paged_decode_kernel<<<grid, kThreads, smem,
                        static_cast<cudaStream_t>(stream)>>>(
      q, k_pool, v_pool, table, lengths, out, H, ps, dh, npp, chunk_pages,
      sm_scale);
  return (int)cudaGetLastError();
}
