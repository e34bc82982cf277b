// decode_split.cuh: the split-KV decode core of tree_decode.cu (B5: the N
// nodes of a speculation tree per slot over its paged K/V) and of the
// rows path of flash_fwd.cu (B1 at T <= 4: decode and verify
// cross-attention over a [S, d] K/V with a key mask). It carries the
// design of paged_decode.cu (B4: one query row per slot), which takes
// its constants, layout, copies, exp2 and merge kernel from here and
// keeps its own walk, on which it runs faster than on this one. This
// header plays for them the part recurrence.cuh plays for the two
// recurrences.
//
// Both read each K and V row once for 1 to 8 query rows: half a flop to
// two flops a byte against the fp32 ridge of 20, so they are bound by
// the bytes they copy, and reaching that bound takes enough bytes in
// flight on every SM and little else on the way. What the core does
// (flash-decoding):
//
// - The grid has a split axis: each block covers a fixed range of keys
//   of one (row group, head) pair, chosen by the wrapper's plan from
//   static shapes only; a block clips its range on the device (a slot's
//   length, a tree's scan, the key count), so a call needs no host read
//   and a CUDA graph can hold it.
// - Key rows go through shared memory in chunks of 32 keys, in a ring of
//   NS stage buffers filled by cp.async (16-byte copies where dh % 4 == 0
//   and both pools are 16-byte aligned, else 4-byte ones): up to NS - 1
//   chunks' copies are in flight while one chunk's math runs. Only the
//   rows of keys that exist and that some row may see are copied (a key
//   mask's zeros are not read); the P.V sum never reads the others.
// - Scores: 8 lanes a key, each on float4 slices of dh, 4 keys a warp at
//   once, three shuffles; every staged chunk is scored for all R query
//   rows of the block (R <= 8), whose slices each lane keeps in
//   registers (NQ float4s a row: 2 up to dh 64, else 4; fewer registers
//   keep more blocks, and so more bytes, in flight on an SM). The
//   queries are loaded once the first copies are in flight (and not at
//   all by a block with nothing to compute), unscaled: the scale goes on
//   each score.
// - Softmax: a per-row online softmax in the exp2 domain. A masked score
//   gives p = 0 explicitly (not exp(-1e30 - m)), so a row that has seen
//   no visible key keeps m = -1e30, l = 0, acc = 0. Every warp takes each
//   row's chunk max from the 32 scores; each key's weight is computed
//   once, by one thread of its key group, and reaches the group's lanes
//   by a shuffle.
// - P.V: all 128 threads, each on one float4 of the output rows (column
//   quad) and one key group; the groups' sums meet in shared memory at
//   the end.
// - With one split a block writes its rows itself. With more, each
//   writes its partial (m, l, acc) per row to scratch from the wrapper,
//   and merge_kernel, launched from the same entry point, combines them
//   with exp2 weights; a merged max at or below kMaskedRowM gives exactly
//   0 (and an LSE at or below -1e29 where one is asked for).
//
// Scratch layout of the partials, for `units` (row group) pairs of
// `rows` rows each and `splits` splits: acc at
// ((unit * splits + split) * rows + row) * dh, then (m, l) at
// units * splits * rows * dh + ((unit * splits + split) * rows + row) * 2.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {
namespace dsplit {

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = 32;        // keys staged per chunk (one warp's max)
constexpr int kLanesPerKey = 8;   // score lanes a key
constexpr int kKeysPerWarp = 32 / kLanesPerKey;
constexpr int kMaxDh = 128;
constexpr int kMaxQuads = kMaxDh / 4 / kLanesPerKey;  // query quads a lane
constexpr int kMaxRows = 8;
// Stage buffers of the ring of B5 and B1's rows path: two chunks in
// flight. Chosen over a double buffer from trial timings on an H100 that
// no script in the repository repeats: chip_smoke.py does not measure
// the choice.
constexpr int kRowsStages = 3;
constexpr float kNegInf = -1e30f;
constexpr float kMaskedRowM = -1e29f;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// One 16-byte (vec) or 4-byte copy into shared memory.
__device__ __forceinline__ void cp_async(float* dst, const float* src,
                                         bool vec) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  if (vec)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(d), "l"(src));
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                 :: "r"(d), "l"(src));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// Waits until at most N of this thread's committed copy groups are
// pending.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N));
}

// The rows a block carries through one walk for n query rows: 1, 2, 4,
// or 8 (more than 8 rows walk again per group of 8).
__host__ __device__ constexpr int rows_for(int n) {
  return n <= 1 ? 1 : n <= 2 ? 2 : n <= 4 ? 4 : kMaxRows;
}

// The float4 slices of a query row each score lane keeps: quads lane8,
// lane8 + 8, ... below ceil(dh / 4).
__host__ __device__ constexpr int quads_for(int dh) {
  return dh <= 4 * kLanesPerKey * 2 ? 2 : kMaxQuads;
}

// The block's layout for head dim dh, R rows and NS stage buffers: rows
// of dhp floats (dh rounded up to 4), column quads cq < ncq (a power of
// two, ceil(dh / 4) rounded up) times kThreads / ncq key groups in the
// P.V sum. Shared memory: NS stages of K and V chunks (reused at the end
// for the key groups' float4 sums, R * kThreads of them), then the
// chunk's scores [R][kChunk] and the warps' l sums [R][kWarps].
struct Layout {
  int dhp, ncq, groups, stage, ring, scores, floats;
};

__host__ __device__ inline Layout layout_of(int dh, int R, int NS) {
  Layout L;
  L.dhp = (dh + 3) / 4 * 4;
  L.ncq = 1;
  while (L.ncq * 4 < dh) L.ncq *= 2;
  L.groups = kThreads / L.ncq;
  L.stage = 2 * kChunk * L.dhp;  // K then V of one chunk
  L.ring = NS * L.stage;
  const int ring = L.ring, red = R * kThreads * 4;
  L.scores = ring > red ? ring : red;
  L.floats = L.scores + R * kChunk + R * kWarps;
  return L;
}

// One thread's share of R query rows: the row slices its score lanes
// read (quads lane8 + 8 i, i < NQ, unscaled), its column quad of each
// row's output sum over its key group, each row's running max in the
// exp2 domain (uniform over the block) and its own part of each row's
// sum.
template <int R, int NQ>
struct Rows {
  float4 q[R][NQ];
  float4 acc[R];
  float m[R], l[R];
};

// Rows r < n_rows of q (dh apart) into the lanes' slices; rows past them
// are 0. Only loads: the first use of a value is a score.
template <int R, int NQ>
__device__ __forceinline__ void load_queries(Rows<R, NQ>& st, const float* q,
                                             int n_rows, int dh) {
  const int lane8 = threadIdx.x & (kLanesPerKey - 1);
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      float e[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * (lane8 + kLanesPerKey * i) + j;
        e[j] = r < n_rows && c < dh ? q[(size_t)r * dh + c] : 0.f;
      }
      st.q[r][i] = make_float4(e[0], e[1], e[2], e[3]);
    }
}

// Zeroes the stage buffers where dh is not a multiple of 4 (the score
// loop reads whole quads, and no copy writes the pad columns), then
// waits for the whole block; else does nothing.
__device__ __forceinline__ void zero_pads(float* smem, const Layout& L,
                                          int dh) {
  if (L.dhp != dh) {
    for (int i = threadIdx.x; i < L.ring; i += kThreads) smem[i] = 0.f;
    __syncthreads();
  }
}

// One staged chunk's math for all R rows: the scores of the keys in
// `bits` that row r sees (vis), each row's online softmax, P.V. ks / vs:
// the chunk's K and V rows; rows outside `bits` may hold anything (they
// were not copied) and are never read for P.V.
template <int R, int NQ, class Vis>
__device__ __forceinline__ void chunk_math(Rows<R, NQ>& st, float* p_s,
                                           const float* ks, const float* vs,
                                           const Layout& L, unsigned bits,
                                           int c, float scale2, Vis vis) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int lane8 = lane & (kLanesPerKey - 1);
  const int nq = L.dhp / 4, ncq = L.ncq, groups = L.groups;
  // P.V: column quad cq, key group kg; keys j = kg + groups * i
  const int cq = tid % ncq, kg = tid / ncq;
  const int per_group = (kChunk + groups - 1) / groups;
  const int base_lane = lane & ~(ncq - 1);
  const int j_own = kg + groups * cq;  // the key whose weight I compute
  const bool owner = cq < per_group && j_own < kChunk;
  // scores: 4 keys a warp, 8 lanes a key, all R rows
#pragma unroll
  for (int pass = 0; pass < kChunk / (kWarps * kKeysPerWarp); ++pass) {
    const int j = (pass * kWarps + warp) * kKeysPerWarp +
                  lane / kLanesPerKey;
    const float* kr = ks + j * L.dhp;
    float dot[R];
#pragma unroll
    for (int r = 0; r < R; ++r) dot[r] = 0.f;
#pragma unroll
    for (int i = 0; i < NQ; ++i) {
      const int quad = lane8 + kLanesPerKey * i;
      if (quad < nq) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + 4 * quad);
#pragma unroll
        for (int r = 0; r < R; ++r) {
          dot[r] = fmaf(st.q[r][i].x, k4.x, dot[r]);
          dot[r] = fmaf(st.q[r][i].y, k4.y, dot[r]);
          dot[r] = fmaf(st.q[r][i].z, k4.z, dot[r]);
          dot[r] = fmaf(st.q[r][i].w, k4.w, dot[r]);
        }
      }
    }
#pragma unroll
    for (int r = 0; r < R; ++r)
#pragma unroll
      for (int off = kLanesPerKey / 2; off > 0; off >>= 1)
        dot[r] += __shfl_xor_sync(0xffffffffu, dot[r], off);
    if (lane8 == 0) {
      const bool exists = (bits >> j) & 1u;
#pragma unroll
      for (int r = 0; r < R; ++r)
        p_s[r * kChunk + j] =
            exists && vis(r, j, c) ? dot[r] * scale2 : kNegInf;
    }
  }
  __syncthreads();
  // each row's chunk max in every warp, then each key's weight once
  float p_own[R];
#pragma unroll
  for (int r = 0; r < R; ++r) {
    float cm = p_s[r * kChunk + lane];
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      cm = fmaxf(cm, __shfl_xor_sync(0xffffffffu, cm, off));
    const float m_new = fmaxf(st.m[r], cm);
    const float alpha = ex2_approx(st.m[r] - m_new);
    const float sc = owner ? p_s[r * kChunk + j_own] : kNegInf;
    p_own[r] = sc <= kMaskedRowM ? 0.f : ex2_approx(sc - m_new);
    st.l[r] = st.l[r] * alpha + p_own[r];
    st.acc[r].x *= alpha;
    st.acc[r].y *= alpha;
    st.acc[r].z *= alpha;
    st.acc[r].w *= alpha;
    st.m[r] = m_new;
  }
  for (int i = 0; i < per_group; ++i) {
    const int j = kg + groups * i;
    const float4 v4 =
        j < kChunk && cq < nq && ((bits >> j) & 1u)
            ? *reinterpret_cast<const float4*>(vs + j * L.dhp + 4 * cq)
            : make_float4(0.f, 0.f, 0.f, 0.f);
#pragma unroll
    for (int r = 0; r < R; ++r) {
      const float pj = __shfl_sync(0xffffffffu, p_own[r], base_lane + i);
      st.acc[r].x = fmaf(pj, v4.x, st.acc[r].x);
      st.acc[r].y = fmaf(pj, v4.y, st.acc[r].y);
      st.acc[r].z = fmaf(pj, v4.z, st.acc[r].z);
      st.acc[r].w = fmaf(pj, v4.w, st.acc[r].w);
    }
  }
}

// The walk over one block's chunks c = 0 .. n_chunks - 1 of its range,
// through a ring of NS stage buffers: up to NS - 1 chunks' copies are in
// flight while one chunk's math runs. The caller's functors:
//   next(c, bits): the first chunk at or after c the block computes (or
//     any value >= n_chunks), with `bits` set to its keys that exist in
//     the range and that some row may see (bit j: key j of the chunk).
//     Uniform over the block.
//   issue(c, buf, bits): the cp.async copies of chunk c's K and V rows
//     in `bits` into stage buffer buf (K at smem + buf * L.stage, V
//     kChunk * dhp after); the walk commits them.
//   vis(r, j, c): does row r see key j of chunk c (asked for keys in
//     bits only)?
// The block's query rows are rows r < n_rows of q (dh apart), loaded
// once the first copies are in flight, and only where a chunk is to be
// computed; scale2 (the softmax scale times log2(e)) takes each score
// into the exp2 domain. st starts empty (m = -1e30, l = 0, acc = 0).
// Every turn commits one copy group, empty past the last chunk, so
// waiting for all but the newest NS - 2 groups always means "this chunk
// landed".
template <int NS, int R, int NQ, class Next, class Issue, class Vis>
__device__ __forceinline__ void walk(Rows<R, NQ>& st, float* smem,
                                     const Layout& L, int n_chunks,
                                     const float* q, int n_rows, int dh,
                                     float scale2, Next next, Issue issue,
                                     Vis vis) {
  float* p_s = smem + L.scores;  // [R][kChunk]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    st.acc[r] = make_float4(0.f, 0.f, 0.f, 0.f);
    st.m[r] = kNegInf;
    st.l[r] = 0.f;
  }
  int ahead[NS - 1];             // chunks in flight, in order
  unsigned ahead_bits[NS - 1];
  int c = 0;                     // where the search for the next resumes
#pragma unroll
  for (int i = 0; i < NS - 1; ++i) {
    ahead_bits[i] = 0;
    ahead[i] = c < n_chunks ? next(c, ahead_bits[i]) : n_chunks;
    if (ahead[i] < n_chunks) issue(ahead[i], i, ahead_bits[i]);
    c = ahead[i] < n_chunks ? ahead[i] + 1 : n_chunks;
    cp_async_commit();
  }
  if (ahead[0] < n_chunks) load_queries(st, q, n_rows, dh);
  int buf = 0;
  while (ahead[0] < n_chunks) {
    cp_async_wait<NS - 2>();
    __syncthreads();  // chunk ahead[0] landed; the one before it consumed
    unsigned nbits = 0;
    const int nx = c < n_chunks ? next(c, nbits) : n_chunks;
    if (nx < n_chunks) issue(nx, (buf + NS - 1) % NS, nbits);
    c = nx < n_chunks ? nx + 1 : n_chunks;
    cp_async_commit();
    const float* ks = smem + buf * L.stage;
    chunk_math(st, p_s, ks, ks + kChunk * L.dhp, L, ahead_bits[0], ahead[0],
               scale2, vis);
#pragma unroll
    for (int i = 0; i < NS - 2; ++i) {
      ahead[i] = ahead[i + 1];
      ahead_bits[i] = ahead_bits[i + 1];
    }
    ahead[NS - 2] = nx;
    ahead_bits[NS - 2] = nbits;
    buf = buf + 1 == NS ? 0 : buf + 1;
  }
}

// The key groups' sums meet (acc in shared memory over the stage
// buffers, l by shuffles and the warps' sums), and rows r < n_rows are
// written: with `out` set, out + r * dh gets acc / l (exactly 0 where
// m <= kMaskedRowM) and, with `lse` set, lse[r] = m ln 2 + ln l (natural
// log of the scaled scores' exponentials); else the partial acc goes to
// part_acc + r * dh and (m, l) to part_ml + 2 r. A warp writes rows r
// with r % kWarps == warp. The stage buffers hold the key groups' sums
// until every thread is past it.
template <int R, int NQ>
__device__ __forceinline__ void finish(Rows<R, NQ>& st, float* smem,
                                       const Layout& L, int dh, int n_rows,
                                       float* out, float* lse,
                                       float* part_acc, float* part_ml) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int nq = L.dhp / 4, ncq = L.ncq, groups = L.groups;
  const int cq = tid % ncq, kg = tid / ncq;
  float* l_s = smem + L.scores + R * kChunk;  // [R][kWarps]
#pragma unroll
  for (int r = 0; r < R; ++r)
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      st.l[r] += __shfl_xor_sync(0xffffffffu, st.l[r], off);
  __syncthreads();  // every stage buffer read
  float4* red = reinterpret_cast<float4*>(smem);  // [R][groups][ncq]
#pragma unroll
  for (int r = 0; r < R; ++r) {
    red[(r * groups + kg) * ncq + cq] = st.acc[r];
    if (lane == 0) l_s[r * kWarps + warp] = st.l[r];
  }
  __syncthreads();
#pragma unroll
  for (int r = 0; r < R; ++r) {
    if (r % kWarps != warp || r >= n_rows) continue;
    float l = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) l += l_s[r * kWarps + w];
    const float m = st.m[r];
    if (lane < nq) {
      float4 o = red[r * groups * ncq + lane];
      for (int g = 1; g < groups; ++g) {
        const float4 x = red[(r * groups + g) * ncq + lane];
        o.x += x.x;
        o.y += x.y;
        o.z += x.z;
        o.w += x.w;
      }
      const float e[4] = {o.x, o.y, o.z, o.w};
      if (out) {
        const float inv = m <= kMaskedRowM ? 0.f : 1.f / fmaxf(l, 1e-30f);
        for (int j = 0; j < 4 && 4 * lane + j < dh; ++j)
          out[(size_t)r * dh + 4 * lane + j] = e[j] * inv;
      } else {
        for (int j = 0; j < 4 && 4 * lane + j < dh; ++j)
          part_acc[(size_t)r * dh + 4 * lane + j] = e[j];
      }
    }
    if (lane == 0) {
      if (out) {
        if (lse) lse[r] = m * kLn2 + logf(fmaxf(l, 1e-30f));
      } else {
        part_ml[2 * r] = m;
        part_ml[2 * r + 1] = l;
      }
    }
  }
}

// The rows of a unit from its splits' partials (layout above): out row
// = sum_i acc_i exp2(m_i - M) / sum_i l_i exp2(m_i - M), M the largest
// m_i; a merged max at or below kMaskedRowM gives exactly 0. With `lse`
// set, lse[row] = M ln 2 + ln l. Grid (units, row blocks of R rows);
// kThreads / R threads a row, each taking the row's M and l once and
// then its columns c = t, t + kThreads / R, ... The loops step through
// the splits by 32-bit offsets from the row's first partial: 64-bit
// index products in them slowed B4 by a few percent on an H100
// (PERF.md).
template <int R>
__global__ void __launch_bounds__(kThreads)
merge_kernel(const float* __restrict__ part, float* __restrict__ out,
             float* __restrict__ lse, int units, int rows, int splits,
             int dh) {
  constexpr int kPer = kThreads / R;
  const int unit = blockIdx.x, rr = threadIdx.x / kPer,
            t = threadIdx.x % kPer;
  const int row = blockIdx.y * R + rr;
  if (row >= rows || t >= dh) return;
  const size_t p0 = (size_t)unit * splits * rows + row;
  // split i's (m, l) at ml[2 * i * rows], its acc row at acc[i * rows * dh]
  const float* ml = part + (size_t)units * splits * rows * dh + 2 * p0;
  const float* acc = part + p0 * dh;
  const int ml_step = 2 * rows, acc_step = rows * dh;
  float M = kNegInf;
  for (int i = 0; i < splits; ++i) M = fmaxf(M, ml[i * ml_step]);
  float l = 0.f;
  for (int i = 0; i < splits; ++i)
    l = fmaf(ml[i * ml_step + 1], ex2_approx(ml[i * ml_step] - M), l);
  const float inv = M <= kMaskedRowM ? 0.f : 1.f / fmaxf(l, 1e-30f);
  float* o_row = out + ((size_t)unit * rows + row) * dh;
  for (int c = t; c < dh; c += kPer) {
    float o = 0.f;
    for (int i = 0; i < splits; ++i)
      o = fmaf(acc[(size_t)i * acc_step + c], ex2_approx(ml[i * ml_step] - M),
               o);
    o_row[c] = o * inv;
  }
  if (lse && t == 0)
    lse[(size_t)unit * rows + row] = M * kLn2 + logf(fmaxf(l, 1e-30f));
}

// Launches merge_kernel<R> for `units` units of `rows` rows each.
template <int R>
cudaError_t launch_merge(const float* part, float* out, float* lse,
                         int units, int rows, int splits, int dh,
                         cudaStream_t st) {
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  merge_kernel<R><<<dim3(units, (rows + R - 1) / R), kThreads, 0, st>>>(
      part, out, lse, units, rows, splits, dh);
  return cudaGetLastError();
}

// Key bits j of a chunk with lo <= j < hi (clipped to the chunk).
__device__ __forceinline__ unsigned range_bits(int lo, int hi) {
  lo = lo < 0 ? 0 : lo;
  hi = hi > kChunk ? kChunk : hi;
  if (hi <= lo) return 0u;
  const unsigned below_hi = hi == kChunk ? 0xffffffffu : (1u << hi) - 1u;
  return below_hi & ~((1u << lo) - 1u);
}

}  // namespace dsplit
}  // namespace
