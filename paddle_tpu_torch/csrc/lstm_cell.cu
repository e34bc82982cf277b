// lstm_cell: the fused LSTM recurrence over pre-projected inputs, fp32,
// for sm_90a.
//
// Replaces the TPU kernel `_lstm_kernel` (paddle_tpu/kernels/
// lstm_cell.py:94, driven by `_lstm_pallas_forward` :141, entry
// `fused_lstm` :233). The input product x @ W_x of every step stays
// outside (one large GEMM); this kernel runs the sequential part: per
// step, gates = xw[:, t] + h @ W_h + bias ([B, 4D], order i, f, c, o),
// optional peepholes (w_ic and w_fc on c_prev, w_oc on c_new), the gate,
// cell and candidate activations (codes 0 sigmoid, 1 tanh, 2 relu,
// 3 identity), and a masked step carries h and c through unchanged
// (h = h_new * m + h_prev * (1 - m), as the reference writes it). The
// TPU kernel keeps the [B, 4D] gates tile and h, c in VMEM across its
// (batch block, T) grid; here T is a loop inside one block and the same
// state never leaves the SM.
//
// What bounds it on this card: operations. A step does 2 * B * D * 4D
// flops against 4 * (4D + 2D) bytes per row of xw, h and c, so at the
// main shape (B 32, T 80, D 512) the floor is 5.37 GFLOP over the fp32
// rate of 67 TFLOP/s, 0.080 ms; its bytes (xw, h, c and W_h once) take
// 0.011 ms.
//
// What the design does: one block owns kRows batch rows for all T steps.
// h lives in shared memory, double-buffered, so one __syncthreads() per
// step suffices (a step reads one buffer and writes the other); c lives
// in shared memory too, each entry touched by one thread only. Thread j
// owns hidden unit j (and j + blockDim.x, ... when D exceeds the block):
// it sums the four gates of its unit for all kRows rows over k < D,
// reading W_h[k, g * D + j] (neighbouring threads on neighbouring
// addresses; W_h stays in L2 after the first step) and h[r][k] from
// shared memory as a broadcast, then applies the gate math and writes
// hidden[b, t, j] and cell[b, t, j]. This keeps only ceil(B / kRows)
// SMs busy and streams all of W_h through each of them once per step,
// so it runs far above its bound. A persistent design that splits the
// 4D columns across SMs, keeps each SM's W_h slice resident in shared
// memory and meets at a grid barrier per step is later work.

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
lstm_cell_kernel(const float* __restrict__ xw, const float* __restrict__ w_h,
                 const float* __restrict__ bias,
                 const float* __restrict__ peep,
                 const float* __restrict__ mask,
                 const float* __restrict__ h0, const float* __restrict__ c0,
                 float* __restrict__ hidden, float* __restrict__ cell,
                 int B, int T, int D, int gate_act, int cell_act,
                 int cand_act) {
  extern __shared__ float smem[];
  float* h_buf = smem;               // [2][RB][D]
  float* c_s = smem + 2 * RB * D;    // [RB][D]
  const int b0 = blockIdx.x * RB;
  const int rows = min(RB, B - b0);
  const int D4 = 4 * D;

  for (int idx = threadIdx.x; idx < RB * D; idx += blockDim.x) {
    const int r = idx / D;
    const size_t g = (size_t)(b0 + r) * D + idx % D;
    const bool live = r < rows;
    h_buf[idx] = live && h0 ? h0[g] : 0.f;
    h_buf[RB * D + idx] = 0.f;
    c_s[idx] = live && c0 ? c0[g] : 0.f;
  }
  __syncthreads();

  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_buf + (t & 1) * RB * D;
    float* h_nxt = h_buf + ((t + 1) & 1) * RB * D;
    for (int j = threadIdx.x; j < D; j += blockDim.x) {
      float acc[RB][4];
#pragma unroll
      for (int r = 0; r < RB; ++r)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[r][g] = 0.f;
      const float* wj = w_h + j;
#pragma unroll 4
      for (int k = 0; k < D; ++k) {
        const float* wk = wj + (size_t)k * D4;
        const float w0 = wk[0], w1 = wk[D], w2 = wk[2 * D], w3 = wk[3 * D];
#pragma unroll
        for (int r = 0; r < RB; ++r) {
          const float hk = h_cur[r * D + k];
          acc[r][0] = fmaf(hk, w0, acc[r][0]);
          acc[r][1] = fmaf(hk, w1, acc[r][1]);
          acc[r][2] = fmaf(hk, w2, acc[r][2]);
          acc[r][3] = fmaf(hk, w3, acc[r][3]);
        }
      }
      const float bi = bias[j], bf = bias[D + j], bc = bias[2 * D + j],
                  bo = bias[3 * D + j];
      const float pi = peep ? peep[j] : 0.f;
      const float pf = peep ? peep[D + j] : 0.f;
      const float po = peep ? peep[2 * D + j] : 0.f;
#pragma unroll
      for (int r = 0; r < RB; ++r) {
        if (r >= rows) break;
        const size_t row = (size_t)(b0 + r) * T + t;
        const float* x = xw + row * D4;
        float gi = (x[j] + acc[r][0]) + bi;
        float gf = (x[D + j] + acc[r][1]) + bf;
        const float gc = (x[2 * D + j] + acc[r][2]) + bc;
        float go = (x[3 * D + j] + acc[r][3]) + bo;
        const float c_prev = c_s[r * D + j];
        const float h_prev = h_cur[r * D + j];
        if (peep) {
          gi += c_prev * pi;
          gf += c_prev * pf;
        }
        const float iv = activate(gate_act, gi);
        const float fv = activate(gate_act, gf);
        float c_new = fv * c_prev + iv * activate(cand_act, gc);
        if (peep) go += c_new * po;
        const float ov = activate(gate_act, go);
        float h_new = ov * activate(cell_act, c_new);
        if (mask) {
          const float m = mask[row];
          h_new = h_new * m + h_prev * (1.f - m);
          c_new = c_new * m + c_prev * (1.f - m);
        }
        h_nxt[r * D + j] = h_new;
        c_s[r * D + j] = c_new;
        hidden[row * D + j] = h_new;
        cell[row * D + j] = c_new;
      }
    }
    __syncthreads();
  }
}

}  // namespace

// Launches on `stream`; returns cudaGetLastError() (0 on success).
// xw [B, T, 4D], w_h [D, 4D], bias [4D], hidden and cell [B, T, D], all
// contiguous fp32. peep ([3, D]: w_ic, w_fc, w_oc), mask ([B, T], 1 =
// valid step), h0 and c0 ([B, D]) may be null: no peepholes, every step
// valid, zero initial state.
extern "C" int paddle_lstm_cell_f32(const float* xw, const float* w_h,
                                    const float* bias, const float* peep,
                                    const float* mask, const float* h0,
                                    const float* c0, float* hidden,
                                    float* cell, int B, int T, int D,
                                    int gate_act, int cell_act, int cand_act,
                                    void* stream) {
  if (B < 1 || T < 1 || D < 1) return (int)cudaErrorInvalidValue;
  if (gate_act < 0 || gate_act > 3 || cell_act < 0 || cell_act > 3 ||
      cand_act < 0 || cand_act > 3)
    return (int)cudaErrorInvalidValue;
  const size_t smem = sizeof(float) * 3 * kRows * (size_t)D;
  if (smem > (size_t)kMaxSmem) return (int)cudaErrorInvalidValue;
  if (smem > 48 * 1024) {
    cudaError_t e = cudaFuncSetAttribute(
        lstm_cell_kernel<kRows>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const int threads = D >= kMaxThreads ? kMaxThreads : (D + 31) / 32 * 32;
  const int blocks = (B + kRows - 1) / kRows;
  lstm_cell_kernel<kRows><<<blocks, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      xw, w_h, bias, peep, mask, h0, c0, hidden, cell, B, T, D, gate_act,
      cell_act, cand_act);
  return (int)cudaGetLastError();
}
