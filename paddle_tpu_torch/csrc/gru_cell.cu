// gru_cell: the fused GRU recurrence over pre-projected inputs, fp32, for
// sm_90a.
//
// Replaces the TPU kernel `_gru_kernel` (paddle_tpu/kernels/
// gru_cell.py:55, driven by `_gru_pallas_forward` :87, entry `fused_gru`
// :159). The input product x @ W_x stays outside; per step this kernel
// computes, in Paddle's gru_op form (the reset gate multiplies h BEFORE
// the candidate product, which is why no library GRU computes it):
//   u, r = gate_act(xw[:, t, :2D] + h @ W_gate + bias[:2D])
//   c    = cand_act(xw[:, t, 2D:] + (r * h) @ W_cand + bias[2D:])
//   h    = u * h + (1 - u) * c
// and a masked step carries h through (h_new * m + h_prev * (1 - m)).
// Activation codes: 0 sigmoid, 1 tanh, 2 relu, 3 identity. The TPU kernel
// keeps h and the [B, 3D] gates tile in VMEM across its (batch block, T)
// grid; here T is a loop inside one block and the state stays on the SM.
//
// What bounds it on this card: operations. A step does 2 * B * D * 3D
// flops, so at the main shape (B 32, T 80, D 512) the floor is 4.03
// GFLOP over 67 TFLOP/s, 0.060 ms; its bytes (xw, h and the weights once)
// take about 0.007 ms.
//
// What the design does: one block owns kRows batch rows for all T steps,
// with h, r * h and u in shared memory, and two barriers per step, one
// for each dependent product. Phase 1: thread j sums u_j and r_j over
// k < D (W_gate[k, j] and W_gate[k, D + j], neighbouring threads on
// neighbouring addresses; h[r][k] a shared-memory broadcast), and writes
// u_j and r_j * h_j. Barrier. Phase 2: it sums the candidate over
// (r * h)[k] * W_cand[k, j], updates h_j in place (no other thread reads
// h_j in this phase), and writes hidden[b, t, j]. Barrier. W_gate and
// W_cand are read through a row stride, so both may be column slices of
// the op's [D, 3D] weight. As in lstm_cell.cu, only ceil(B / kRows) SMs
// work and each streams all weights once per step; splitting the columns
// across SMs with resident weight slices and a grid barrier per step is
// later work.

#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kRows = 4;          // batch rows per block
constexpr int kMaxThreads = 1024;
constexpr int kMaxSmem = 227 * 1024;

__device__ __forceinline__ float activate(int code, float x) {
  switch (code) {
    case 0: return 1.f / (1.f + expf(-x));
    case 1: return tanhf(x);
    case 2: return fmaxf(x, 0.f);
    default: return x;
  }
}

template <int RB>
__global__ void __launch_bounds__(kMaxThreads)
gru_cell_kernel(const float* __restrict__ xw,
                const float* __restrict__ w_gate, int ld_gate,
                const float* __restrict__ w_cand, int ld_cand,
                const float* __restrict__ bias,
                const float* __restrict__ mask,
                const float* __restrict__ h0, float* __restrict__ hidden,
                int B, int T, int D, int gate_act, int cand_act) {
  extern __shared__ float smem[];
  float* h_s = smem;               // [RB][D]
  float* rh_s = smem + RB * D;     // [RB][D] r * h
  float* u_s = smem + 2 * RB * D;  // [RB][D]
  const int b0 = blockIdx.x * RB;
  const int rows = min(RB, B - b0);
  const int D3 = 3 * D;

  for (int idx = threadIdx.x; idx < RB * D; idx += blockDim.x) {
    const int r = idx / D;
    h_s[idx] = r < rows && h0 ? h0[(size_t)(b0 + r) * D + idx % D] : 0.f;
    rh_s[idx] = 0.f;
    u_s[idx] = 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    // phase 1: update and reset gates from h @ W_gate
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float acc_u[RB], acc_r[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc_u[r] = acc_r[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const float* wk = w_gate + (size_t)k * ld_gate + j;
        const float wu = wk[0], wr = wk[D];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hk = h_s[r * D + k];
          acc_u[r] = fmaf(hk, wu, acc_u[r]);
          acc_r[r] = fmaf(hk, wr, acc_r[r]);
        }
      }
      const float bu = bias[j], br = bias[D + j];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= rows) break;
        const float* x = xw + ((size_t)(b0 + r) * T + t) * D3;
        u_s[r * D + j] = activate(gate_act, (x[j] + acc_u[r]) + bu);
        const float rv = activate(gate_act, (x[D + j] + acc_r[r]) + br);
        rh_s[r * D + j] = rv * h_s[r * D + j];
      }
    }
    __syncthreads();
    // phase 2: candidate from (r * h) @ W_cand, then the state update
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float acc_c[RB];
#pragma unroll
      for (int r = 0; r < RB; ++r) acc_c[r] = 0.f;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const float wc = w_cand[(size_t)k * ld_cand + j];
#pragma unroll
        for (int r = 0; r < RB; ++r)
          acc_c[r] = fmaf(rh_s[r * D + k], wc, acc_c[r]);
      }
      const float bc = bias[2 * D + j];
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= rows) break;
        const size_t row = (size_t)(b0 + r) * T + t;
        const float* x = xw + row * D3;
        const float c = activate(cand_act, (x[2 * D + j] + acc_c[r]) + bc);
        const float u = u_s[r * D + j];
        const float h_prev = h_s[r * D + j];
        float h_new = u * h_prev + (1.f - u) * c;
        if (mask) {
          const float m = mask[row];
          h_new = h_new * m + h_prev * (1.f - m);
        }
        h_s[r * D + j] = h_new;
        hidden[row * D + j] = h_new;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// xw [B, T, 3D], bias [3D], hidden [B, T, D], contiguous fp32; w_gate
// [D, 2D] with row stride ld_gate and w_cand [D, D] with row stride
// ld_cand (unit column stride). mask ([B, T], 1 = valid step) and h0
// ([B, D]) may be null: every step valid, zero initial state.
extern "C" int paddle_gru_cell_f32(const float* xw, const float* w_gate,
                                   int ld_gate, const float* w_cand,
                                   int ld_cand, const float* bias,
                                   const float* mask, const float* h0,
                                   float* hidden, int B, int T, int D,
                                   int gate_act, int cand_act,
                                   void* stream) {
  if (B < 1 || T < 1 || D < 1 || ld_gate < 2 * D || ld_cand < D ||
      gate_act < 0 || gate_act > 3 || cand_act < 0 || cand_act > 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * kRows * (size_t)D;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        gru_cell_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = D >= kMaxThreads ? kMaxThreads : (D + 31) / 32 * 32;
  const int blocks = (B + kRows - 1) / kRows;
  gru_cell_kernel<kRows><<<blocks, threads, smem,
                           static_cast<cudaStream_t>(stream)>>>(
      xw, w_gate, ld_gate, w_cand, ld_cand, bias, mask, h0, hidden, B, T, D,
      gate_act, cand_act);
  return (int)cudaGetLastError();
}
