// recurrence.cuh: what the two recurrence kernels (lstm_cell.cu, B6, and
// gru_cell.cu, B7) share: the block layout their launch plans derive, the
// branch-free activations, h's shared-memory row stride, the 16-byte
// cp.async and the cooperative launch. Both lay a block out the same
// way: a thread owns one hidden unit, RT batch rows (1 or 4) and one
// k-quad phase of 4 * kw (four lanes 8 apart in a warp, times kw warp
// groups); the groups' sums meet in shared memory, where one thread per
// (row, unit) does the gate math.

#pragma once

#include <algorithm>
#include <cuda_runtime.h>
#include <math.h>
#include <stddef.h>

namespace {

constexpr int kMaxCombos = 128;   // (unit, row group) pairs: 512 threads
constexpr int kMaxThreads = 4 * kMaxCombos;
constexpr int kMaxWarpGroups = 4;  // k-shares

// Where the weights live during the steps: shared memory, read from L2
// each step (a slice too large for shared memory), or registers (regime
// (a) at small D: a thread's unit and kRegQuads k-quads).
enum WMode { kWShared = 0, kWL2 = 1, kWRegs = 2 };
constexpr int kRegQuads = 2;

// An activation code (0 sigmoid, 1 tanh, 2 relu, 3 identity) as
// numbers, so that a step's activations run without branches and the
// independent ones overlap: ka = 1 (sigmoid) or 2 (tanh = 2 sigmoid(2x)
// - 1) for the smooth ones, else 0 with lo = 0 (relu) or -inf
// (identity); kl = -ka / ln 2 scales x for ex2.
struct Act {
  float ka, kl, lo;
};

__host__ __device__ __forceinline__ Act act_of(int code) {
  const float ka = code == 0 ? 1.f : code == 1 ? 2.f : 0.f;
  return Act{ka, -ka * 1.4426950408889634f, code == 2 ? 0.f : -INFINITY};
}

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ float rcp_approx(float x) {
  float y;
  asm("rcp.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

// sigmoid(ka x) through the special-function unit (two approximate
// instructions, within 1e-6 of torch.sigmoid / torch.tanh; an overflowing
// exponential gives 1 / inf = 0, so an infinite input gives 0 or 1), or
// the exact relu / identity branch, picked by a select (no branch): both
// are computed, and neither is multiplied by 0, which would turn inf
// into NaN
__device__ __forceinline__ float activate(Act f, float x) {
  const float s = rcp_approx(1.f + ex2_approx(f.kl * x));
  const float smooth = fmaf(f.ka, s, 1.f - f.ka);
  return f.ka != 0.f ? smooth : fmaxf(x, f.lo);
}

// Row stride (floats) of h in shared memory ([rows][k]) for `cols` k
// columns: rounded up to 4 (float4 loads) with an odd count of float4s,
// so rows of different row groups fall in different banks.
__host__ __device__ __forceinline__ int row_stride(int cols) {
  const int quads = (cols + 3) / 4;
  return 4 * (quads % 2 ? quads : quads + 1);
}

// 16 bytes global -> shared through L2 only (never the non-coherent
// path: other blocks wrote the source); src_bytes 0 fills zeros
__device__ __forceinline__ void cp_async16(float* dst, const float* src,
                                           int src_bytes) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(d), "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.commit_group;\n" ::);
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// What a plan (regime 0 = (a), 1 = (b); units and rows per block; kc k
// columns of h staged at once; w_mode) implies for a launch: the one
// statement of the block's layout, which `block_layout` in
// kernels/lstm_cell.py mirrors for choosing a plan. A kernel's weights
// take w_bytes bytes a hidden unit and k where they live in shared
// memory, and its product leaves `sums` sums a row and unit per pass.
// False where the kernels do not take the plan: regime (a) is one pass
// over all D units with the weights in shared memory or registers (a
// thread's share at most kRegQuads k-quads); regime (b) stages h in
// chunks of a multiple of 4 columns, its weight slice in shared memory
// or read from L2.
struct Layout {
  int rt;       // batch rows per thread (1 or 4)
  int groups;   // row groups of rt rows per pass
  int kw;       // warp groups that split k
  int rs;       // row stride of h in shared memory, in floats
  int threads, blocks;
  size_t smem;  // bytes per block: weights (or their slice), h, sums
};

inline bool block_layout(int B, int D, int regime, int units, int rows,
                         int kc, int w_mode, int w_bytes, int sums,
                         Layout* out) {
  if (B < 1 || D < 1 || units < 1 || units > kMaxCombos || rows < 1 ||
      rows > B || kc < 1 || kc > D)
    return false;
  if (regime == 0) {
    if (units != D || kc != D || (w_mode != kWShared && w_mode != kWRegs))
      return false;
  } else if (regime != 1 || (kc < D && kc % 4) ||
             (w_mode != kWShared && w_mode != kWL2)) {
    return false;
  }
  Layout L;
  L.rt = rows >= 4 ? 4 : 1;
  L.groups = std::min((rows + L.rt - 1) / L.rt, kMaxCombos / units);
  if (regime == 0 && L.groups * L.rt < rows) return false;
  const int warps = (units * L.groups + 7) / 8;
  L.kw = std::max(1, std::min(kMaxWarpGroups, kMaxThreads / (32 * warps)));
  if (w_mode == kWRegs &&
      ((D + 3) / 4 + 4 * L.kw - 1) / (4 * L.kw) > kRegQuads)
    return false;
  L.threads = 32 * warps * L.kw;
  L.rs = row_stride(kc);
  L.smem = (w_mode == kWShared
                ? (size_t)w_bytes * ((D + 3) / 4 * 4) * units
                : 0) +
           sizeof(float) * L.rs * (size_t)L.groups * L.rt *
               (regime == 0 ? 2 : 1) +
           sizeof(float) * (size_t)L.kw * warps * 8 * L.rt * sums;
  L.blocks = (D + units - 1) / units * ((B + rows - 1) / rows);
  *out = L;
  return true;
}

// Launches `kernel(args)`: plainly, or (coop) cooperatively, refused
// with cudaErrorCooperativeLaunchTooLarge where the grid cannot be
// co-resident (its grid barriers would hang).
template <typename Args>
int launch_kernel(void (*kernel)(Args), const Args& args, bool coop,
                  int blocks, int threads, size_t smem,
                  cudaStream_t stream) {
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  if (!coop) {
    kernel<<<blocks, threads, smem, stream>>>(args);
    return (int)cudaGetLastError();
  }
  int dev = 0, can = 0, n_sm = 0, per_sm = 0;
  if ((e = cudaGetDevice(&dev)) != cudaSuccess) return (int)e;
  cudaDeviceGetAttribute(&can, cudaDevAttrCooperativeLaunch, dev);
  if (!can) return (int)cudaErrorNotSupported;
  cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, threads,
                                                    smem);
  if (e != cudaSuccess) return (int)e;
  if (blocks > per_sm * n_sm) return (int)cudaErrorCooperativeLaunchTooLarge;
  Args copy = args;
  void* params[] = {&copy};
  e = cudaLaunchCooperativeKernel((const void*)kernel, dim3(blocks),
                                  dim3(threads), params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// The device's per-block shared-memory limit (opt-in), for refusing a
// plan whose layout exceeds it; a CUDA error code, 0 on success.
inline int smem_limit(int* limit) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      limit, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}

}  // namespace
