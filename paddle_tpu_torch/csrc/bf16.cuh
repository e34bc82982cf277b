// bf16.cuh: loading bf16 rows into float32 shared-memory tiles and
// storing float32 results as bf16, for B3's bf16 entry (flash_bwd.cu's
// dQ; B1's and B2's bf16 entries run on the bf16 tensor cores instead,
// mma_bf16.cuh).
//
// The TPU kernels upcast every bf16 tile to float32 on load and compute
// in float32 (paddle_tpu/kernels/flash_attention.py:394-416); the entry
// does the same: a bf16 value widens to float32 exactly (its 16 bits are
// the high half of the float's), the tiles in shared memory hold
// float32, and a result is rounded to bf16 once, at the store, to
// nearest even as torch's `.to(torch.bfloat16)` rounds. The loads are
// plain (not cp.async): the widening happens in registers between the
// global load and the shared store.

#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

namespace bf16io {

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// the 8 bf16 values of a 16-byte load, widened: a 32-bit word holds
// element 2i in its low half and 2i + 1 in its high half
__device__ __forceinline__ void widen8(const uint4 w, float4& lo,
                                       float4& hi) {
  lo = make_float4(__uint_as_float(w.x << 16),
                   __uint_as_float(w.x & 0xffff0000u),
                   __uint_as_float(w.y << 16),
                   __uint_as_float(w.y & 0xffff0000u));
  hi = make_float4(__uint_as_float(w.z << 16),
                   __uint_as_float(w.z & 0xffff0000u),
                   __uint_as_float(w.w << 16),
                   __uint_as_float(w.w & 0xffff0000u));
}

// 8 bf16 values at `src` (16-byte aligned) into 8 floats at `dst`
// (16-byte aligned); `ok` false writes zeros and reads nothing
__device__ __forceinline__ void load8(float* dst, const __nv_bfloat16* src,
                                      bool ok) {
  float4 lo = make_float4(0.f, 0.f, 0.f, 0.f), hi = lo;
  if (ok) widen8(*reinterpret_cast<const uint4*>(src), lo, hi);
  reinterpret_cast<float4*>(dst)[0] = lo;
  reinterpret_cast<float4*>(dst)[1] = hi;
}

}  // namespace bf16io
