// The detection ops' greedy loops for the H100: greedy NMS (K1) and
// detection_map's greedy match (K2).
//
// Replace no TPU kernel. The JAX package runs both loops as
// lax.fori_loops inside its one XLA executable
// (paddle_tpu/ops/detection_ops.py:343-371 and :941-955, the NMS;
// :1037-1067, the match); the port interprets one eager op at a time,
// where the same loop in torch ops is k (NMS) or D (match) host
// iterations of several launches each. These kernels run each loop in
// one launch. Wrappers and plain versions: kernels/detection.py.
//
// The IoU is _iou's (detection_ops.py:84-99) in float32, every operation
// rounded on its own (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn: no
// contraction into a fused multiply-add), in the plain version's order:
// areas (x2 - x1 + off) * (y2 - y1 + off) clamped at 0, the overlap's
// width and height likewise, union (area_a + area_b) - inter, then
// inter / max(union, 1e-10). So the keep masks and the tp / fp flags
// are those of the plain version bit for bit.
//
// K1 paddle_greedy_nms: score-sorted candidates [B, k, 4], eligibility
// [B, k] (uint8), threshold, eta, box offset (0, or 1 for unnormalized
// boxes) -> keep [B, k] (uint8). Candidate i is kept when it is
// eligible and no kept j < i has IoU(i, j) > thr; after a keep, thr *=
// eta while eta < 1 and thr > 0.5.
//   Bound: operations, and a chain of k dependent steps. The IoU tests
//   are at most k^2 / 2 a row of 16 float operations each (the overlap,
//   union, divide and compare) besides 7 a candidate for its area
//   (multiclass_nms in the SSD eval head at 300 x 300: 640 rows of 400,
//   at most 0.8 G operations, 12 us at 67 TFLOP/s; far fewer where few
//   candidates are kept), the bytes 18 a candidate. The latency of k
//   steps, each a barrier, dominates.
//   Design: one block a row, 128 threads. The row's boxes and
//   eligibility are staged in shared memory once (a step reads no
//   device memory); kept candidates go on a list whose slot m is
//   written and read by thread m % 128 only, so a step needs one block
//   OR (__syncthreads_or) and no other barrier: at step i each thread
//   tests candidate i against its slots of the list, and every thread
//   derives the same take, list length and threshold. An ineligible
//   candidate costs no barrier. A row past the shared memory (k above
//   11,068: multiclass_nms with nms_top_k -1 on SSD300's 28,276 priors,
//   generate_proposals' pre_nms_topN 12,000) runs the same loop with its
//   boxes read from device memory and its kept list in a device buffer.
//
// K2 paddle_det_match: detections [N, D, 6] (label, score, x1 y1 x2
// y2), each image's detections in global score order (local [N, D]),
// each detection's global rank (rank [N, D]), gt_label [N, G] (int32,
// -1 padding), gt_box [N, G, 4], difficult [N, G] (uint8), threshold,
// evaluate_difficult -> tp, fp [N * D] (uint8) at global ranks. Step t
// of image n takes its t-th detection, finds the gt of its class with
// the largest IoU (the first on a tie, as argmax), and marks it a true
// positive if that IoU reaches the threshold and the gt is not yet
// matched (then matches it), else a false positive; an invalid
// detection (label < 0), or with evaluate_difficult off one whose best
// gt is difficult and covered, is neither.
//   Bound: latency: D dependent steps an image, each G IoUs (N * D * G
//   = 102,400 in the SSD eval head, 2 M operations: nothing for the
//   card; the bytes 4.9 MB of detections, ranks and gts, about 1.5 us).
//   Design: one warp an image (matched is per image, so walking each
//   image's detections in global order is the JAX package's one global
//   pass). The image's detections, walk order, ranks and gts are staged
//   in shared memory once, so a step reads no device memory; a lane a
//   gt (strided past 32), the argmax a shuffle reduction, matched in
//   shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kNmsThreads = 128;

__device__ __forceinline__ float clamp0(float x) { return fmaxf(x, 0.f); }

__device__ __forceinline__ float area(float4 a, float off) {
  return __fmul_rn(clamp0(__fadd_rn(__fsub_rn(a.z, a.x), off)),
                   clamp0(__fadd_rn(__fsub_rn(a.w, a.y), off)));
}

// _iou(a, b)[0, 0]: a the row operand, b the column operand
__device__ __forceinline__ float iou(float4 a, float4 b, float off) {
  const float area_a = area(a, off);
  const float area_b = area(b, off);
  const float w = clamp0(
      __fadd_rn(__fsub_rn(fminf(a.z, b.z), fmaxf(a.x, b.x)), off));
  const float h = clamp0(
      __fadd_rn(__fsub_rn(fminf(a.w, b.w), fmaxf(a.y, b.y)), off));
  const float inter = __fmul_rn(w, h);
  const float uni = __fsub_rn(__fadd_rn(area_a, area_b), inter);
  return __fdiv_rn(inter, fmaxf(uni, 1e-10f));
}

// kStaged: the row's boxes, eligibility and kept list in shared memory
// (21 bytes a candidate). Otherwise (a row too long for a block's shared
// memory) the boxes and eligibility are read from device memory, through
// the L1, and the kept list lives in `kept_dev` [rows, k]: slot m is still
// written and read by thread m % 128 alone, so it needs no fence.
template <bool kStaged>
__global__ void __launch_bounds__(kNmsThreads)
greedy_nms_kernel(const float4* __restrict__ boxes,
                  const uint8_t* __restrict__ eligible, int k, float thr0,
                  float eta, float off, int* __restrict__ kept_dev,
                  uint8_t* __restrict__ keep) {
  extern __shared__ float4 smem[];
  const size_t row = blockIdx.x;
  const float4* box = boxes + row * k;
  const uint8_t* re = eligible + row * k;
  int* kept = kStaged ? nullptr : kept_dev + row * k;
  if (kStaged) {
    float4* sbox = smem;                                 // k boxes
    kept = reinterpret_cast<int*>(smem + k);             // kept list
    uint8_t* se = reinterpret_cast<uint8_t*>(kept + k);  // eligibility
    for (int i = threadIdx.x; i < k; i += kNmsThreads) {
      sbox[i] = box[i];
      se[i] = re[i];
    }
    __syncthreads();
    box = sbox;
    re = se;
  }
  uint8_t* rk = keep + row * k;
  float thr = thr0;
  const bool shrink = eta < 1.f;
  int nkept = 0;
  for (int i = 0; i < k; ++i) {
    int take = 0;
    if (re[i]) {  // the same for every thread of the block
      const float4 bi = box[i];
      int sup = 0;
      for (int m = threadIdx.x; m < nkept; m += kNmsThreads) {
        if (iou(bi, box[kept[m]], off) > thr) {
          sup = 1;
          break;
        }
      }
      take = !__syncthreads_or(sup);
    }
    if (take) {
      if (threadIdx.x == nkept % kNmsThreads) kept[nkept] = i;
      ++nkept;
      if (shrink && thr > 0.5f) thr = __fmul_rn(thr, eta);
    }
    if (threadIdx.x == 0) rk[i] = static_cast<uint8_t>(take);
  }
}

// kStaged: the image's detections, walk order and ranks in shared memory
// with its gts (32 bytes a detection); otherwise they are read from
// device memory and only the gts and `matched` are staged
template <bool kStaged>
__global__ void det_match_kernel(const float* __restrict__ det,
                                 const int* __restrict__ local,
                                 const int* __restrict__ rank,
                                 const int* __restrict__ gt_label,
                                 const float4* __restrict__ gt_box,
                                 const uint8_t* __restrict__ difficult,
                                 int D, int G, float thr, int eval_diff,
                                 uint8_t* __restrict__ tp,
                                 uint8_t* __restrict__ fp) {
  extern __shared__ float4 dsmem[];
  float4* gbox = dsmem;                                      // G boxes
  int* lab = reinterpret_cast<int*>(gbox + G);               // G
  uint8_t* diff = reinterpret_cast<uint8_t*>(lab + G);       // G
  uint8_t* matched = diff + G;                               // G
  const size_t n = blockIdx.x;
  const int lane = threadIdx.x;
  const float* sdet = det + n * 6 * D;
  const int* order = local + n * D;
  const int* srank = rank + n * D;
  if (kStaged) {
    // 16-byte aligned past the gts' 22 bytes each
    float* dd = reinterpret_cast<float*>(gbox + G + (6 * G + 15) / 16);
    int* od = reinterpret_cast<int*>(dd + 6 * D);
    int* rd = od + D;
    for (int i = lane; i < 6 * D; i += 32) dd[i] = sdet[i];
    for (int i = lane; i < D; i += 32) {
      od[i] = order[i];
      rd[i] = srank[i];
    }
    sdet = dd;
    order = od;
    srank = rd;
  }
  for (int g = lane; g < G; g += 32) {
    gbox[g] = gt_box[n * G + g];
    lab[g] = gt_label[n * G + g];
    diff[g] = difficult[n * G + g];
    matched[g] = 0;
  }
  __syncwarp();
  for (int t = 0; t < D; ++t) {
    const int j = order[t];
    const float* d = sdet + 6 * j;
    const float label = d[0];
    const int cls = static_cast<int>(label);
    const bool valid = label >= 0.f;
    const float4 db = make_float4(d[2], d[3], d[4], d[5]);
    float best = __int_as_float(0xff800000);  // -inf
    int best_g = 0x7fffffff;
    for (int g = lane; g < G; g += 32) {
      const int gl = lab[g];
      const float ov = (gl >= 0 && gl == cls) ? iou(db, gbox[g], 0.f) : -1.f;
      if (ov > best) {  // ascending g: the first of equal values stays
        best = ov;
        best_g = g;
      }
    }
    for (int s = 16; s > 0; s >>= 1) {
      const float ob = __shfl_xor_sync(0xffffffffu, best, s);
      const int og = __shfl_xor_sync(0xffffffffu, best_g, s);
      if (ob > best || (ob == best && og < best_g)) {
        best = ob;
        best_g = og;
      }
    }
    const bool covered = best >= thr;
    const bool hit = valid && covered && !matched[best_g];
    const bool ignore = !eval_diff && covered && diff[best_g];
    __syncwarp();
    if (lane == 0) {
      if (hit) matched[best_g] = 1;
      const bool score = valid && !ignore;
      const int r = srank[j];
      tp[r] = static_cast<uint8_t>(score && hit);
      fp[r] = static_cast<uint8_t>(score && !hit);
    }
    __syncwarp();
  }
}

// Opts a kernel into `smem` bytes of dynamic shared memory past the
// default 48 KB; the launch itself reports a size past the card's limit.
template <typename F>
int allow_smem(F* kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return static_cast<int>(cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem)));
}

}  // namespace

extern "C" {

// boxes [rows, k, 4] float32, eligible / keep [rows, k] uint8. kept_dev
// null: the row is staged in shared memory (k * 21 bytes, the wrapper
// checks it fits); else int32 [rows, k], the kept lists of the
// unstaged kernel.
int paddle_greedy_nms(const void* boxes, const void* eligible, int rows,
                      int k, float thr, float eta, float off, void* kept_dev,
                      void* keep, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float4* b = static_cast<const float4*>(boxes);
  const uint8_t* e = static_cast<const uint8_t*>(eligible);
  uint8_t* out = static_cast<uint8_t*>(keep);
  if (kept_dev != nullptr) {
    greedy_nms_kernel<false><<<rows, kNmsThreads, 0, st>>>(
        b, e, k, thr, eta, off, static_cast<int*>(kept_dev), out);
    return static_cast<int>(cudaGetLastError());
  }
  const size_t smem =
      static_cast<size_t>(k) * (sizeof(float4) + sizeof(int) + 1);
  const int err = allow_smem(greedy_nms_kernel<true>, smem);
  if (err) return err;
  greedy_nms_kernel<true><<<rows, kNmsThreads, smem, st>>>(
      b, e, k, thr, eta, off, nullptr, out);
  return static_cast<int>(cudaGetLastError());
}

// det [n, D, 6] float32; local, rank [n, D] int32; gt_label [n, G] int32;
// gt_box [n, G, 4] float32; difficult [n, G] uint8; tp, fp [n * D] uint8.
// staged: the detections in shared memory too (the wrapper checks the
// bytes fit).
int paddle_det_match(const void* det, const void* local, const void* rank,
                     const void* gt_label, const void* gt_box,
                     const void* difficult, int n, int D, int G, float thr,
                     int eval_diff, int staged, void* tp, void* fp,
                     void* stream) {
  const size_t gts = static_cast<size_t>(G) * sizeof(float4) +
                     (static_cast<size_t>(6 * G + 15) / 16) * 16;
  const size_t dets = static_cast<size_t>(D) * (6 * 4 + 4 + 4);
  auto kernel = staged ? det_match_kernel<true> : det_match_kernel<false>;
  const size_t smem = staged ? gts + dets : gts;
  const int err = allow_smem(kernel, smem);
  if (err) return err;
  kernel<<<n, 32, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(det), static_cast<const int*>(local),
      static_cast<const int*>(rank), static_cast<const int*>(gt_label),
      static_cast<const float4*>(gt_box),
      static_cast<const uint8_t*>(difficult), D, G, thr, eval_diff,
      static_cast<uint8_t*>(tp), static_cast<uint8_t*>(fp));
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
