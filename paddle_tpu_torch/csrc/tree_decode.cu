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
// share one pass over its K and V rows below min(base + N, max_len)
// (8*dh bytes a row) and do 4*N*dh flops on each, N/2 flops per byte
// against the fp32 ridge of 20, so for the N of a draft chain (4 to 8)
// the floor is those rows' bytes over 3.35 TB/s, the bytes the
// one-query decode kernel reads for the same slots.
//
// What the design does about it: the split-KV core of decode_split.cuh,
// which flash_fwd.cu's rows path shares (paged_decode.cu, B4, takes its
// copies and merge and keeps its own walk). The grid
// is (slot, head, split); each split covers a fixed range of `pps` pages
// of its slot, the split count chosen by `tree_plan` (kernels/
// paged_attention.py) from static shapes only. A block reads base[s] on
// the device and clips its range to min(base + N, max_len) ROWS (not
// whole pages); a split wholly past that, or of a finished slot, reads no
// page and writes an empty partial. Within a split, 32-key chunks are
// staged through a three-buffer cp.async ring (table[s, p] read by the
// block for each copied row) and scored ONCE for all N nodes (8 lanes a key,
// float4 slices, the nodes' query slices in registers); the visibility of
// key t for node n is the direct test
//   t < base || (t - base < N && t < max_len && anc[s][n][t - base] > 0)
// on the slot's mask held in shared memory (the TPU kernel needs a
// one-hot product for it, having no gather). Each node keeps an
// exp2-domain online softmax (a hidden key gives p = 0 exactly), P.V runs
// over all 128 threads, and with more than one split the core's merge
// kernel, launched from the same entry point, combines the partials. Up
// to 8 nodes share one walk; more nodes walk the split again per group
// of 8 (right, not fast: the main path has 4).
//
// Where it stands (NVIDIA H100 at 700 W, chip_smoke.py): about 0.020 ms
// at the verify shape (32 slots, bases 0..252, 4 nodes), 3.6 times the
// byte bound; at one split a block per (slot, head), the slots with the
// longest scans set the time, on top of the launch and first-copy
// latency.

#include "decode_split.cuh"

namespace {

using namespace dsplit;

struct TreeArgs {
  const float* q;
  const float* k_pool;
  const float* v_pool;
  const int64_t* table;
  const int64_t* base_lens;
  const int64_t* anc;
  float* out;   // [S, H, N, dh] (splits == 1)
  float* part;  // the partials (decode_split.cuh), N rows a (slot, head)
  int S, H, N, ps, dh, npp, max_len, splits, pps;
  float scale2;  // sm_scale * log2(e): scores in the exp2 domain
  int vec;
};

// The node mask's bytes after the core's floats, 16-byte rounded.
__host__ __device__ inline int tree_smem(int dh, int N) {
  return (int)sizeof(float) *
             layout_of(dh, rows_for(N), kRowsStages).floats +
         (N * N + 15) / 16 * 16;
}

// R: nodes a walk carries (rows_for(N)); NQ: query quads a score lane
// keeps (quads_for(dh)).
template <int R, int NQ>
__global__ void __launch_bounds__(kThreads)
tree_decode_kernel(TreeArgs a) {
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  const Layout L = layout_of(a.dh, R, kRowsStages);
  unsigned char* anc_s =
      reinterpret_cast<unsigned char*>(smem + L.floats);  // [N][N]
  const int dh = a.dh, dhp = L.dhp, N = a.N;
  const int s = blockIdx.x, h = blockIdx.y, sp = blockIdx.z;
  const int tid = threadIdx.x;
  const size_t sh = (size_t)s * a.H + h;

  // positions fit an int: the entry point refuses npp * ps >= 2^30
  const long long base = a.base_lens[s];
  const int cap = a.npp * a.ps;
  long long scan = 0;
  if (base >= 0) {
    scan = base + N;
    if (scan > a.max_len) scan = a.max_len;
    if (scan > cap) scan = cap;
  }
  const int kb0 = sp * a.pps * a.ps;
  const int ke = min((int)scan, kb0 + a.pps * a.ps);
  const int nkeys = max(ke - kb0, 0);
  const int n_chunks = (nkeys + kChunk - 1) / kChunk;

  const size_t page_elems = (size_t)a.ps * dh;
  const long long* trow =
      reinterpret_cast<const long long*>(a.table) + (size_t)s * a.npp;
  const float* k_head = a.k_pool + (size_t)h * page_elems;
  const float* v_head = a.v_pool + (size_t)h * page_elems;
  const size_t page_stride = (size_t)a.H * page_elems;
  const int per_row = a.vec ? dh / 4 : dh;
  const int width = a.vec ? 4 : 1;

  if (n_chunks > 0)
    for (int i = tid; i < N * N; i += kThreads)
      anc_s[i] = a.anc[(size_t)s * N * N + i] > 0 ? 1 : 0;

  auto next = [&](int c, unsigned& bits) {
    const int nk = min(kChunk, nkeys - c * kChunk);
    bits = nk >= kChunk ? 0xffffffffu : (1u << max(nk, 0)) - 1u;
    return c;
  };
  // the chunk's rows below the scan (bits: a prefix)
  auto issue = [&](int c, int buf, unsigned) {
    const int kb = kb0 + c * kChunk;
    const int nk = min(kChunk, nkeys - c * kChunk);
    float* ks = smem + buf * L.stage;
    float* vs = ks + kChunk * dhp;
    for (int idx = tid; idx < nk * per_row; idx += kThreads) {
      const int r = idx / per_row, col = (idx - r * per_row) * width;
      const int pos = kb + r;
      const int pg = pos / a.ps;
      const size_t off = (size_t)__ldg(trow + pg) * page_stride +
                         (size_t)(pos - pg * a.ps) * dh + col;
      cp_async(ks + r * dhp + col, k_head + off, a.vec);
      cp_async(vs + r * dhp + col, v_head + off, a.vec);
    }
  };

  const size_t acc_floats = (size_t)a.S * a.H * a.splits * N * dh;
  for (int n0 = 0; n0 < N; n0 += R) {
    const int nr = min(R, N - n0);
    // node n0 + r sees key j of chunk c (a key below the scan)
    auto vis = [&](int r, int j, int c) {
      const long long t = kb0 + c * kChunk + j;
      const long long tj = t - base;
      return tj < 0 || (r < nr && tj < N && t < a.max_len &&
                        anc_s[(n0 + r) * N + tj] != 0);
    };
    zero_pads(smem, L, dh);
    Rows<R, NQ> st;
    walk<kRowsStages>(st, smem, L, n_chunks, a.q + (sh * N + n0) * dh, nr,
                      dh, a.scale2, next, issue, vis);
    const size_t pr = (sh * a.splits + sp) * N + n0;
    finish(st, smem, L, dh, nr,
           a.splits == 1 ? a.out + (sh * N + n0) * dh : nullptr, nullptr,
           a.part + pr * dh, a.part + acc_floats + 2 * pr);
    __syncthreads();  // the next group's copies overwrite the sums
  }
}

template <int R>
int launch(const TreeArgs& args, cudaStream_t st) {
  const int smem = tree_smem(args.dh, args.N);
  auto kernel = quads_for(args.dh) == 2
                    ? tree_decode_kernel<R, 2>
                    : tree_decode_kernel<R, kMaxQuads>;
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return (int)e;
  kernel<<<dim3(args.S, args.H, args.splits), kThreads, smem, st>>>(args);
  if (args.splits > 1)
    return (int)launch_merge<R>(args.part, args.out, nullptr,
                                args.S * args.H, args.N, args.splits,
                                args.dh, st);
  return (int)cudaGetLastError();
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success). Page
// ids in `table` must lie in [0, P) for every page below
// ceil(min(base + N, max_len) / ps) of a slot with base >= 0; entries past
// that, and every entry of a slot with base < 0, are never read. The plan
// (kernels/paged_attention.py `tree_plan`): `splits` blocks a (slot,
// head), each over `pps` pages (splits * pps >= npp, every split
// nonempty); with splits > 1, `part` is scratch of
// S * H * splits * N * (dh + 2) floats.
extern "C" int paddle_tree_decode_f32(const float* q, const float* k_pool,
                                      const float* v_pool,
                                      const int64_t* table,
                                      const int64_t* base_lens,
                                      const int64_t* anc, float* out,
                                      float* part, int S, int H, int N,
                                      int ps, int dh, int npp, int max_len,
                                      int splits, int pps, float sm_scale,
                                      void* stream) {
  if (S < 1 || H < 1 || N < 1 || ps < 1 || dh < 1 || dh > kMaxDh ||
      npp < 1 || max_len < 0 || splits < 1 || pps < 1 ||
      (long long)splits * pps < npp || (long long)(splits - 1) * pps >= npp ||
      splits > 65535 || H > 65535 || (long long)npp * ps >= (1LL << 30) ||
      (splits > 1 && !part) || (long long)N * N > 227 * 1024 ||
      tree_smem(dh, N) > 227 * 1024)
    return (int)cudaErrorInvalidValue;
  const int vec = dh % 4 == 0 &&
                  ((uintptr_t)k_pool | (uintptr_t)v_pool) % 16 == 0;
  const TreeArgs args{q, k_pool, v_pool, table, base_lens, anc, out, part,
                      S, H, N, ps, dh, npp, max_len, splits, pps,
                      sm_scale * kLog2e, vec};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (rows_for(N)) {
    case 1: return launch<1>(args, st);
    case 2: return launch<2>(args, st);
    case 4: return launch<4>(args, st);
    default: return launch<kMaxRows>(args, st);
  }
}

// The threads and shared-memory bytes of the tree kernel's block at head
// dim dh and N nodes, for holding `tree_plan`'s figures to the kernel's
// (host code: no device needed); cudaErrorInvalidValue past kMaxDh.
extern "C" int paddle_tree_layout(int dh, int N, int* threads, int* smem) {
  if (dh < 1 || dh > kMaxDh || N < 1) return (int)cudaErrorInvalidValue;
  *threads = kThreads;
  *smem = tree_smem(dh, N);
  return 0;
}
