// paged_decode: ragged paged-attention decode, fp32, for sm_90a.
//
// Replaces the TPU kernel `_paged_decode_kernel` (paddle_tpu/kernels/
// paged_attention.py:184, driven by `_paged_pallas` :240). One query token
// per slot attends over that slot's resident K/V rows, which live in a
// block-paged pool [P,H,page_size,dh] reached through a page table
// [S,npp] (int64). A slot's scan stops at its own length: a block reads
// table[s, p] itself for the pages below ceil(lengths[s] / page_size)
// only, so the aliased tail of the table is never touched, and a slot of
// length 0 reads no page and writes exactly 0. Any page_size >= 1 works.
//
// What bounds it on this card: memory. Each resident token's K and V
// rows (8*dh bytes) are read once for 2*dh flops of score and 2*dh of
// output, half a flop per byte against the fp32 ridge of 20, so the floor
// is the resident bytes over 3.35 TB/s (grid_accounting in
// kernels/paged_attention.py counts them). Reaching it takes enough
// bytes in flight on every SM, and little else on the way.
//
// What the design does (flash-decoding): the grid is (slot, head,
// split); each split covers a fixed range of `pps` pages of its slot, so
// a decode step has `splits` times as many blocks as (slot, head) pairs.
// The split count comes from static shapes only (`paged_plan` in
// kernels/paged_attention.py: S, H, npp, page_size, dh, the SM count),
// never from `lengths`, which only the device reads: the call needs no
// host sync and a CUDA graph can hold it. A block clips its range to the
// slot's length; a split wholly past it reads no page and writes an
// empty partial (m = -1e30, l = 0, acc = 0). Within a split, key rows go
// through shared memory in chunks of 32 keys, double-buffered with
// 16-byte cp.async (4-byte copies where dh or a pool pointer is not
// 16-byte aligned), so the next chunk's loads overlap this chunk's math.
// Scores: 8 lanes a key, each on float4 slices of dh, 4 keys a warp at
// once, three shuffles. Softmax: every warp takes the chunk's max from
// the 32 scores, and each key's exponential is computed once, by one
// thread of its key group. P.V: all 128 threads, each on one float4 of
// the output row (column quad) and one key group (keys j = group mod
// groups); a key's weight reaches its group's lanes by a shuffle. At the
// end the key groups' sums meet in shared memory. With one split the
// block writes the output; with more, each writes its partial (m, l,
// acc) to scratch from the wrapper and the merge kernel of
// decode_split.cuh, launched from the same entry point, combines them
// (exp2 weights; a merged max at or below kMaskedRowM gives exactly 0).
//
// decode_split.cuh carries this design for B5 (tree_decode.cu) and B1's
// rows path (flash_fwd.cu); this file takes its constants, block layout,
// copies, exp2 and merge from it and keeps only its own walk: one query
// row, the query pre-scaled, no key visibility test. On the core's walk
// (two stage buffers, this plan) it ran slower on an H100 on the serving
// mix of lengths (PERF.md), for a cause not found.
//
// Where it stands (NVIDIA H100 at 700 W, chip_smoke.py): about 0.017 ms
// at 32 slots x 256 tokens, some 58 % of the byte bound; the second
// launch, two barriers a 32-key chunk and one table read a copy remain.

#include "decode_split.cuh"

namespace {

using namespace dsplit;

// The block's layout for head dim dh (decode_split.cuh, one row, a double
// buffer): rows of dhp floats, column quads cq < ncq times `groups` key
// groups in the P.V sum; two stages of K and V chunks, the chunk's
// scores, the warps' l sums.
__host__ __device__ inline Layout paged_layout(int dh) {
  return layout_of(dh, 1, 2);
}

struct Args {
  const float* q;
  const float* k_pool;
  const float* v_pool;
  const int64_t* table;
  const int64_t* lengths;
  float* out;   // [S, H, dh] (splits == 1)
  float* part;  // [S, H, splits, dh] acc, then [S, H, splits, 2] (m, l)
  int S, H, ps, dh, npp, splits, pps;
  float scale2;  // sm_scale * log2(e): scores in the exp2 domain
  int vec;
};

__global__ void __launch_bounds__(kThreads)
paged_decode_kernel(Args a) {
  extern __shared__ float smem[];
  const Layout L = paged_layout(a.dh);
  const int dh = a.dh, dhp = L.dhp, ncq = L.ncq;
  const int stage = L.stage;                 // K then V of one chunk
  float* p_s = smem + L.scores;              // [kChunk] scores
  float* l_s = p_s + kChunk;                 // [kWarps]

  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const size_t sh = (size_t)s * a.H + h;

  // positions fit an int: the entry point refuses npp * ps >= 2^30
  const long long len_raw = a.lengths[s];
  const int cap = a.npp * a.ps;
  const int len = len_raw < 0 ? 0 : len_raw > cap ? cap : (int)len_raw;
  const int kb0 = sp * a.pps * a.ps;
  const int ke = min(len, min(cap, kb0 + a.pps * a.ps));
  const int nkeys = max(ke - kb0, 0);
  const int n_chunks = (nkeys + kChunk - 1) / kChunk;

  const size_t page_elems = (size_t)a.ps * dh;
  const long long* trow =
      reinterpret_cast<const long long*>(a.table) + (size_t)s * a.npp;
  const float* k_head = a.k_pool + (size_t)h * page_elems;
  const float* v_head = a.v_pool + (size_t)h * page_elems;
  const size_t page_stride = (size_t)a.H * page_elems;
  // issue the copies of chunk c into stage buffer c & 1
  auto issue = [&](int c) {
    const int kb = kb0 + c * kChunk;
    const int nk = min(kChunk, nkeys - c * kChunk);
    float* ks = smem + (c & 1) * stage;
    float* vs = ks + kChunk * dhp;
    const int per_row = a.vec ? dh / 4 : dh;
    const int width = a.vec ? 4 : 1;
    for (int idx = tid; idx < nk * per_row; idx += kThreads) {
      const int r = idx / per_row, col = (idx % per_row) * width;
      const int pos = kb + r;
      const int pg = pos / a.ps;
      const size_t off = (size_t)__ldg(trow + pg) * page_stride +
                         (size_t)(pos - pg * a.ps) * dh + col;
      cp_async(ks + r * dhp + col, k_head + off, a.vec);
      cp_async(vs + r * dhp + col, v_head + off, a.vec);
    }
    cp_async_commit();
  };

  if (dhp != dh) {
    // pad columns read as whole quads by the score loop: zeros
    for (int i = tid; i < 2 * stage; i += kThreads) smem[i] = 0.f;
    __syncthreads();
  }
  if (n_chunks > 0) issue(0);

  // the query's float4 slices of the score lanes: quads lane8 + 8 i
  const int lane8 = lane & (kLanesPerKey - 1);
  const int nq = dhp / 4;
  float4 qv[kMaxQuads];
#pragma unroll
  for (int i = 0; i < kMaxQuads; ++i) {
    float e[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int c = 4 * (lane8 + kLanesPerKey * i) + j;
      e[j] = c < dh ? a.q[sh * dh + c] * a.scale2 : 0.f;
    }
    qv[i] = make_float4(e[0], e[1], e[2], e[3]);
  }

  // P.V: column quad cq, key group kg; keys j = kg + groups * i
  const int cq = tid % ncq, kg = tid / ncq;
  const int per_group = (kChunk + L.groups - 1) / L.groups;
  const int base_lane = lane & ~(ncq - 1);
  float4 acc = make_float4(0.f, 0.f, 0.f, 0.f);
  float m = kNegInf, l_part = 0.f;

  for (int c = 0; c < n_chunks; ++c) {
    cp_async_wait<0>();
    __syncthreads();  // chunk c landed; chunk c - 1 fully consumed
    if (c + 1 < n_chunks) issue(c + 1);
    const int nk = min(kChunk, nkeys - c * kChunk);
    const float* ks = smem + (c & 1) * stage;
    const float* vs = ks + kChunk * dhp;
    // scores: 4 keys a warp, 8 lanes a key
#pragma unroll
    for (int pass = 0; pass < kChunk / (kWarps * 32 / kLanesPerKey);
         ++pass) {
      const int j = (pass * kWarps + warp) * (32 / kLanesPerKey) +
                    lane / kLanesPerKey;
      const float* kr = ks + j * dhp;
      float dot = 0.f;
#pragma unroll
      for (int i = 0; i < kMaxQuads; ++i) {
        const int quad = lane8 + kLanesPerKey * i;
        if (quad < nq) {
          const float4 k4 = *reinterpret_cast<const float4*>(kr + 4 * quad);
          dot = fmaf(qv[i].x, k4.x, dot);
          dot = fmaf(qv[i].y, k4.y, dot);
          dot = fmaf(qv[i].z, k4.z, dot);
          dot = fmaf(qv[i].w, k4.w, dot);
        }
      }
#pragma unroll
      for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
        dot += __shfl_xor_sync(0xffffffffu, dot, off);
      if (lane8 == 0 && j < nk) p_s[j] = dot;
    }
    __syncthreads();
    // the chunk's max, in every warp
    float cm = lane < nk ? p_s[lane] : kNegInf;
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
    const float m_new = fmaxf(m, cm);
    const float alpha = ex2_approx(m - m_new);
    // each key's weight once: lane cq = i of key group kg takes key
    // kg + groups * i
    const int j_own = kg + L.groups * cq;
    const float p_own =
        cq < per_group && j_own < nk ? ex2_approx(p_s[j_own] - m_new) : 0.f;
    l_part = l_part * alpha + p_own;
    acc.x *= alpha;
    acc.y *= alpha;
    acc.z *= alpha;
    acc.w *= alpha;
    for (int i = 0; i < per_group; ++i) {
      const float pj = __shfl_sync(0xffffffffu, p_own, base_lane + i);
      const int j = kg + L.groups * i;
      if (j < nk && cq < nq) {
        const float4 v4 = *reinterpret_cast<const float4*>(vs + j * dhp +
                                                           4 * cq);
        acc.x = fmaf(pj, v4.x, acc.x);
        acc.y = fmaf(pj, v4.y, acc.y);
        acc.z = fmaf(pj, v4.z, acc.z);
        acc.w = fmaf(pj, v4.w, acc.w);
      }
    }
    m = m_new;
  }

  // the key groups' sums: acc in shared memory (over the stage buffers),
  // l by warp shuffles
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    l_part += __shfl_xor_sync(0xffffffffu, l_part, off);
  __syncthreads();  // every stage buffer read
  float4* red = reinterpret_cast<float4*>(smem);  // [groups][ncq]
  red[kg * ncq + cq] = acc;
  if (lane == 0) l_s[warp] = l_part;
  __syncthreads();
  if (tid < nq) {
    float4 o = red[tid];
    for (int g = 1; g < L.groups; ++g) {
      const float4 r = red[g * ncq + tid];
      o.x += r.x;
      o.y += r.y;
      o.z += r.z;
      o.w += r.w;
    }
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += l_s[w];
    const float e[4] = {o.x, o.y, o.z, o.w};
    if (a.splits == 1) {
      const float inv = m <= kMaskedRowM ? 0.f : 1.f / fmaxf(l, 1e-30f);
      for (int j = 0; j < 4 && 4 * tid + j < dh; ++j)
        a.out[sh * dh + 4 * tid + j] = e[j] * inv;
    } else {
      const size_t part = sh * a.splits + sp;
      for (int j = 0; j < 4 && 4 * tid + j < dh; ++j)
        a.part[part * dh + 4 * tid + j] = e[j];
      if (tid == 0) {
        float* ml = a.part + (size_t)a.S * a.H * a.splits * dh + 2 * part;
        ml[0] = m;
        ml[1] = l;
      }
    }
  }
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success). Page
// ids in `table` must lie in [0, P) for every page a slot's length
// reaches; entries past that are never read. The plan (kernels/
// paged_attention.py `paged_plan`): `splits` blocks a (slot, head), each
// over `pps` pages (splits * pps >= npp, every split nonempty); with
// splits > 1, `part` is scratch of S * H * splits * (dh + 2) floats.
extern "C" int paddle_paged_decode_f32(const float* q, const float* k_pool,
                                       const float* v_pool,
                                       const int64_t* table,
                                       const int64_t* lengths, float* out,
                                       float* part, int S, int H, int ps,
                                       int dh, int npp, int splits, int pps,
                                       float sm_scale, void* stream) {
  if (S < 1 || H < 1 || ps < 1 || dh < 1 || dh > kMaxDh || npp < 1 ||
      splits < 1 || pps < 1 || (long long)splits * pps < npp ||
      (long long)(splits - 1) * pps >= npp || splits > 65535 || H > 65535 ||
      (long long)npp * ps >= (1LL << 30) ||
      (splits > 1 && !part))
    return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(float) * paged_layout(dh).floats;
  cudaError_t e = cudaFuncSetAttribute(
      paged_decode_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return (int)e;
  const int vec = dh % 4 == 0 &&
                  ((uintptr_t)k_pool | (uintptr_t)v_pool) % 16 == 0;
  Args args{q, k_pool, v_pool, table, lengths, out, part, S, H, ps, dh,
            npp, splits, pps, sm_scale * kLog2e, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  paged_decode_kernel<<<dim3(S, H, splits), kThreads, smem, st>>>(args);
  if (splits > 1)
    return (int)launch_merge<1>(part, out, nullptr, S * H, 1, splits, dh,
                                st);
  return (int)cudaGetLastError();
}

// The threads and shared-memory bytes of the decode kernel's block at
// head dim dh, for holding `paged_plan`'s figures to the kernel's (host
// code: no device needed); cudaErrorInvalidValue past kMaxDh.
extern "C" int paddle_paged_layout(int dh, int* threads, int* smem) {
  if (dh < 1 || dh > kMaxDh) return (int)cudaErrorInvalidValue;
  *threads = kThreads;
  *smem = (int)sizeof(float) * paged_layout(dh).floats;
  return 0;
}
