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
// grid; here T is a loop inside a persistent kernel.
//
// What bounds it on this card: operations. A step does 2 * B * D * 3D
// flops, so at the main shape (B 32, T 80, D 512) the floor is 4.03
// GFLOP over 67 TFLOP/s, 0.060 ms; its bytes (xw, h and the weights once)
// take about 0.007 ms. What stands between a step and that floor: reading
// the weights (12 * D^2 bytes) again every step, the two dependent
// products a step (the candidate needs r * h over ALL hidden units), and
// the barriers between them. The design is B6's (lstm_cell.cu; the block
// layout, activations and staging are shared through recurrence.cuh),
// with two exchanges a step. Two regimes, chosen by `gru_plan` in
// kernels/gru_cell.py from (B, D, the SM count, the per-block
// shared-memory limit); the wrapper passes the plan's choices, and
// `plan_layout` below derives the block's layout from them:
//
// (a) batch split, where W_gate and W_cand (12 * D^2 bytes) plus h and
//     r * h of the block's rows fit one block (on an H100 every D up to
//     128, the most units a block takes). A block owns `rows` batch rows
//     for all T steps and loads both weights once, into registers where
//     a thread's share fits (D 64) or else into shared memory; h and
//     r * h stay in shared memory. Four __syncthreads a step: after each
//     product's sums, after r * h is written, after h is. No grid
//     barrier.
// (b) column split, above that. A block owns `units` hidden units with
//     all three of their columns (u, r, c), so the gate math stays
//     local, and `rows` batch rows; its [D, 3 * units] weight slice
//     stays in shared memory for all T steps (read from L2 where a 1/SMs
//     slice does not fit, above D 1,580 or so). At D 512, B 32: 32 units
//     x 4 rows, 192 KB, 16 x 8 = 128 blocks. Each step every block
//       1. stages h_{t-1} of its rows from hidden[:, t - 1] (h0 at t = 0)
//          with 16-byte cp.async through L2 (never the non-coherent path:
//          other blocks wrote it), in k-chunks where many rows would not
//          fit;
//       2. computes u and r for its units and writes r * h into the
//          [B, D] exchange buffer (scratch from the wrapper);
//       3. meets the others at grid barrier 1;
//       4. stages r * h of its rows the same way, computes c, updates h
//          and writes hidden[:, t, units];
//       5. meets the others at grid barrier 2.
//     The kernel is launched cooperatively with at most one block per
//     SM, so the grid is co-resident or the launch is refused and the
//     wrapper raises. Where a block's rows take several passes, u waits
//     for the candidate in a second [B, D] scratch (written and read by
//     the same thread); with one pass it stays in a register.
//
// Both products use B6's inner loop: a thread owns one unit, RT rows and
// one k-quad phase; per k-quad it reads its unit's weights as float4s
// (W_gate interleaved as {u_k, r_k, u_k+1, r_k+1}, W_cand as four k of
// c; a quarter-warp reads 8 consecutive float4s, so no bank conflict)
// and each row's four h (or r * h) as one float4. Two shuffles finish a
// warp group's sums, the groups' sums meet in shared memory, and one
// thread per (row, unit) does the gate math, consecutive threads on
// consecutive units, with the branch-free activations; with one pass it
// keeps h in a register and loads the next step's xw and mask a step
// ahead of their use.
//
// What bounds it now (NVIDIA H100 at 700 W, chip_smoke.py): not the
// flops but each step's chain of latencies, two grid barriers, two
// stagings through L2 (h, then r * h) and two block reductions: 0.59 ms
// at the main shape, about 7.4 us a step, where B6 with one barrier
// takes about 5.5.

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace cg = cooperative_groups;

namespace {

struct GruArgs {
  const float* xw;
  const float* w_gate;
  const float* w_cand;
  const float* bias;
  const float* mask;
  const float* h0;
  float* hidden;  // read back by other blocks: not __restrict__, no __ldg
  float* rh;      // [B, D] r * h, exchanged between blocks (regime b)
  float* u_buf;   // [B, D] u between the products (regime b, passes > 1)
  int ld_gate, ld_cand;
  int B, T, D;
  int gate_act, cand_act;
  int units;   // hidden units per block
  int rows;    // batch rows per block
  int groups;  // row groups of RT rows per pass
  int kc;      // k columns of h staged at once (regime b)
  int rs;      // row stride of h in shared memory, in floats
  int vec_h;   // D % 4 == 0 and aligned h sources: 16-byte cp.async
  int kw;      // warp groups that split k (k-quad phases: 4 * kw)
};

// The thread's weights of one k-quad (k = 4 kq .. 4 kq + 3) of unit u:
// g0 = {u_k, r_k, u_k+1, r_k+1}, g1 the same for k + 2, k + 3, c = the
// four candidate weights. Past D (or for u >= D) zeros.
struct QuadW {
  float4 g0, g1, c;
};

__device__ __forceinline__ QuadW quad_from_global(const GruArgs& a, int kq,
                                                  int u) {
  float w[12];
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int k = 4 * kq + j;
    const bool in = k < a.D && u < a.D;
    w[2 * j] = in ? __ldg(a.w_gate + (size_t)k * a.ld_gate + u) : 0.f;
    w[2 * j + 1] =
        in ? __ldg(a.w_gate + (size_t)k * a.ld_gate + a.D + u) : 0.f;
    w[8 + j] = in ? __ldg(a.w_cand + (size_t)k * a.ld_cand + u) : 0.f;
  }
  return QuadW{make_float4(w[0], w[1], w[2], w[3]),
               make_float4(w[4], w[5], w[6], w[7]),
               make_float4(w[8], w[9], w[10], w[11])};
}

// acc[i][0 / 1] += sum over the k-quads phase, phase + phases, ... below
// nq4 of the chunk starting at k0 of h[row i of group rg][k] * W_gate's
// u / r column of unit u. WM: where the weights live.
template <int RT, int WM>
__device__ __forceinline__ void accumulate_gates(
    float (&acc)[RT][2], const GruArgs& a, const float4* wg_s,
    const QuadW (&wr)[kRegQuads], const float* h_s, int k0, int nq4,
    int phase, int phases, int ul, int u, int U, int rg, int rs) {
  const float* hr = h_s + (size_t)rg * RT * rs;
  auto body = [&](int kq, float4 w0, float4 w1) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 h4 =
          *reinterpret_cast<const float4*>(hr + (size_t)i * rs + 4 * kq);
      acc[i][0] = fmaf(h4.x, w0.x, acc[i][0]);
      acc[i][1] = fmaf(h4.x, w0.y, acc[i][1]);
      acc[i][0] = fmaf(h4.y, w0.z, acc[i][0]);
      acc[i][1] = fmaf(h4.y, w0.w, acc[i][1]);
      acc[i][0] = fmaf(h4.z, w1.x, acc[i][0]);
      acc[i][1] = fmaf(h4.z, w1.y, acc[i][1]);
      acc[i][0] = fmaf(h4.w, w1.z, acc[i][0]);
      acc[i][1] = fmaf(h4.w, w1.w, acc[i][1]);
    }
  };
  if constexpr (WM == kWRegs) {
#pragma unroll
    for (int n = 0; n < kRegQuads; ++n) {
      const int kq = phase + n * phases;
      if (kq >= nq4) break;
      body(kq, wr[n].g0, wr[n].g1);
    }
  } else {
#pragma unroll 2
    for (int kq = phase; kq < nq4; kq += phases) {
      if constexpr (WM == kWShared) {
        const size_t row = (size_t)(k0 / 2 + 2 * kq) * U + ul;
        body(kq, wg_s[row], wg_s[row + U]);
      } else {
        const QuadW w = quad_from_global(a, k0 / 4 + kq, u);
        body(kq, w.g0, w.g1);
      }
    }
  }
}

// acc[i][0] += the same sum of (r * h)[row i][k] * W_cand[k, u]
template <int RT, int WM>
__device__ __forceinline__ void accumulate_cand(
    float (&acc)[RT][2], const GruArgs& a, const float4* wc_s,
    const QuadW (&wr)[kRegQuads], const float* h_s, int k0, int nq4,
    int phase, int phases, int ul, int u, int U, int rg, int rs) {
  const float* hr = h_s + (size_t)rg * RT * rs;
  auto body = [&](int kq, float4 w) {
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 h4 =
          *reinterpret_cast<const float4*>(hr + (size_t)i * rs + 4 * kq);
      float s = acc[i][0];
      s = fmaf(h4.x, w.x, s);
      s = fmaf(h4.y, w.y, s);
      s = fmaf(h4.z, w.z, s);
      s = fmaf(h4.w, w.w, s);
      acc[i][0] = s;
    }
  };
  if constexpr (WM == kWRegs) {
#pragma unroll
    for (int n = 0; n < kRegQuads; ++n) {
      const int kq = phase + n * phases;
      if (kq >= nq4) break;
      body(kq, wr[n].c);
    }
  } else {
#pragma unroll 2
    for (int kq = phase; kq < nq4; kq += phases) {
      if constexpr (WM == kWShared)
        body(kq, wc_s[(size_t)(k0 / 4 + kq) * U + ul]);
      else
        body(kq, quad_from_global(a, k0 / 4 + kq, u).c);
    }
  }
}

// Stage columns k0 .. k0 + kn of `pass_rows` rows into h_s ([row][rs]):
// row rr (< prows) from src + (prow0 + rr) * ld + k0, zeros elsewhere
// and where src is null, through L2 (other blocks wrote the source).
// `any` is an aligned valid address for the zero-byte copies.
__device__ __forceinline__ void stage_rows(float* h_s, const float* src,
                                           size_t ld, int prow0, int prows,
                                           int pass_rows, int k0, int kn,
                                           int rs, bool vec,
                                           const float* any) {
  const int nq4 = (kn + 3) / 4;
  if (vec) {
    for (int idx = threadIdx.x; idx < pass_rows * nq4; idx += blockDim.x) {
      const int rr = idx / nq4, c = 4 * (idx % nq4);
      const bool live = rr < prows && src;
      cp_async16(h_s + (size_t)rr * rs + c,
                 live ? src + (size_t)(prow0 + rr) * ld + k0 + c : any,
                 live ? 16 : 0);
    }
    cp_async_wait_all();
  } else {
    for (int idx = threadIdx.x; idx < pass_rows * 4 * nq4;
         idx += blockDim.x) {
      const int rr = idx / (4 * nq4), c = idx % (4 * nq4);
      float v = 0.f;
      if (rr < prows && c < kn && src)
        v = __ldcg(src + (size_t)(prow0 + rr) * ld + k0 + c);
      h_s[(size_t)rr * rs + c] = v;
    }
  }
}

// COOP: regime (b), else regime (a). WM: where the weights live (WMode;
// regime (a) takes shared memory or registers, (b) shared memory or L2).
template <int RT, bool COOP, int WM>
__global__ void __launch_bounds__(kMaxThreads, 1)
gru_cell_kernel(GruArgs a) {
  extern __shared__ float4 smem4[];
  const int D = a.D, T = a.T, B = a.B, U = a.units, rs = a.rs;
  const int D3 = 3 * D;
  const int Dp = (D + 3) / 4 * 4;
  float4* wg_s = smem4;                    // [Dp / 2][U]
  float4* wc_s = smem4 + (size_t)Dp / 2 * U;  // [Dp / 4][U]
  float* h_s = reinterpret_cast<float*>(
      smem4 + (WM == kWShared ? (size_t)Dp / 4 * 3 * U : 0));
  const int pass_rows = a.groups * RT;
  float* rh_s = h_s + (size_t)pass_rows * rs;  // regime (a) only
  // the product's sums, one block per warp group, after the h buffers
  float* red_s = h_s + (size_t)(COOP ? 1 : 2) * pass_rows * rs;

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int combos = U * a.groups;
  const int group_warps = (combos + 7) / 8;
  const int wg = (tid >> 5) / group_warps;  // warp group: a k-share
  const int q = lane >> 3;
  const int phase = wg * 4 + q;             // k-quad phase
  const int phases = 4 * a.kw;
  // (unit, row group) pair of the product
  const int slot = ((tid >> 5) % group_warps) * 8 + (lane & 7);
  const int ul = slot % U;
  const int rg = slot / U;
  // block = (unit group, row block); regime (a) has one unit group
  const int unit_groups = (D + U - 1) / U;
  const int u0 = (blockIdx.x % unit_groups) * U;
  const int u = u0 + ul;
  const int row0 = (blockIdx.x / unit_groups) * a.rows;
  const int rows_blk = min(a.rows, B - row0);
  const int passes = (rows_blk + pass_rows - 1) / pass_rows;
  const bool one_pass = passes == 1;
  const int red_stride = group_warps * 8 * RT * 2;  // floats per warp group

  QuadW wr[kRegQuads];
  if constexpr (WM == kWRegs) {
#pragma unroll
    for (int n = 0; n < kRegQuads; ++n)
      wr[n] = quad_from_global(a, phase + n * phases,
                               slot < combos ? u : D);
  }
  if (WM == kWShared) {
    // W_gate[k, u], W_gate[k, D + u] of k = 2 kk, 2 kk + 1 -> wg_s[kk][u]
    for (int idx = tid; idx < Dp / 2 * U; idx += blockDim.x) {
      const int kk = idx / U, j = u0 + idx % U;
      float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int k = 2 * kk + e;
        if (j < D && k < D) {
          w[2 * e] = a.w_gate[(size_t)k * a.ld_gate + j];
          w[2 * e + 1] = a.w_gate[(size_t)k * a.ld_gate + D + j];
        }
      }
      wg_s[idx] = make_float4(w[0], w[1], w[2], w[3]);
    }
    // W_cand[k, u] of k = 4 kq .. 4 kq + 3 -> wc_s[kq][u]
    for (int idx = tid; idx < Dp / 4 * U; idx += blockDim.x) {
      const int kq = idx / U, j = u0 + idx % U;
      float w[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int k = 4 * kq + e;
        if (j < D && k < D) w[e] = a.w_cand[(size_t)k * a.ld_cand + j];
      }
      wc_s[idx] = make_float4(w[0], w[1], w[2], w[3]);
    }
  }
  if (!COOP) {
    // h (h0 or 0) and r * h (0), pads 0: the products read whole quads
    for (int idx = tid; idx < 2 * pass_rows * rs; idx += blockDim.x) {
      const int r = idx / rs, k = idx % rs;
      float v = 0.f;
      if (r < rows_blk && k < D && a.h0)
        v = a.h0[(size_t)(row0 + r) * D + k];
      h_s[idx] = v;
    }
  }
  __syncthreads();

  // the gate math of (row e_rl, unit ue) of a pass is done by thread
  // e = e_rl * U + e_ul; the product's sums reach it through shared
  // memory
  const int e_rl = tid / U, e_ul = tid % U;
  const int ue = u0 + e_ul;
  const bool gate_live = tid < U * pass_rows && ue < D;
  const float bu = gate_live ? a.bias[ue] : 0.f;
  const float br = gate_live ? a.bias[D + ue] : 0.f;
  const float bc = gate_live ? a.bias[2 * D + ue] : 0.f;
  const Act gate_f = act_of(a.gate_act), cand_f = act_of(a.cand_act);
  const float* red_own =
      red_s + ((e_rl / RT) * U + e_ul) * RT * 2 + (e_rl % RT) * 2;

  // with one pass a thread does the gate math of the same (row, unit) at
  // every step: h and u stay in registers, and the next step's inputs
  // are loaded right after this step's update, a whole step before use
  float h_reg = 0.f, u_reg = 0.f;
  float xu = 0.f, xr = 0.f, xc = 0.f, m = 1.f;
  if (one_pass && gate_live && e_rl < rows_blk) {
    const int r = row0 + e_rl;
    h_reg = a.h0 ? a.h0[(size_t)r * D + ue] : 0.f;
    const float* x = a.xw + (size_t)r * T * D3 + ue;
    xu = x[0]; xr = x[D]; xc = x[2 * D];
    if (a.mask) m = a.mask[(size_t)r * T];
  }

  // one product's sums: two shuffles over the four k-quad phases of a
  // warp (lanes 8 apart), every warp group's sums to shared memory
  auto publish = [&](float (&acc)[RT][2]) {
#pragma unroll
    for (int i = 0; i < RT; ++i)
#pragma unroll
      for (int g = 0; g < 2; ++g) {
        acc[i][g] += __shfl_xor_sync(0xffffffffu, acc[i][g], 8);
        acc[i][g] += __shfl_xor_sync(0xffffffffu, acc[i][g], 16);
      }
    if (q == 0 && slot < combos) {
      float* dst = red_s + (size_t)wg * red_stride + slot * RT * 2;
#pragma unroll
      for (int i = 0; i < RT; ++i) {
        dst[i * 2] = acc[i][0];
        dst[i * 2 + 1] = acc[i][1];
      }
    }
    __syncthreads();
  };
  auto sums = [&](float& s0, float& s1) {
    s0 = red_own[0];
    s1 = red_own[1];
#pragma unroll
    for (int w = 1; w < kMaxWarpGroups; ++w) {
      if (w < a.kw) {
        s0 += red_own[(size_t)w * red_stride];
        s1 += red_own[(size_t)w * red_stride + 1];
      }
    }
  };

  for (int t = 0; t < T; ++t) {
    // -- phase 1: u and r from h @ W_gate; r * h out -------------------
    for (int p = 0; p < passes; ++p) {
      const int prow0 = row0 + p * pass_rows;
      const int prows = min(pass_rows, row0 + rows_blk - prow0);
      const int r = prow0 + e_rl;
      const bool owner = gate_live && e_rl < prows;
      const size_t row = (size_t)r * T + t;
      float h_prev = h_reg;
      if (owner && !one_pass) {
        const float* x = a.xw + row * D3 + ue;
        xu = x[0]; xr = x[D];
        h_prev = t == 0 ? (a.h0 ? a.h0[(size_t)r * D + ue] : 0.f)
                        : __ldcg(a.hidden + (row - 1) * D + ue);
      }
      float acc[RT][2];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = 0.f;
      if constexpr (COOP) {
        const float* src = t > 0 ? a.hidden + (size_t)(t - 1) * D : a.h0;
        const size_t ld = t > 0 ? (size_t)T * D : (size_t)D;
        for (int k0 = 0; k0 < D; k0 += a.kc) {
          const int kn = min(a.kc, D - k0);
          __syncthreads();  // the last chunk's readers are done
          stage_rows(h_s, src, ld, prow0, prows, pass_rows, k0, kn, rs,
                     a.vec_h, a.hidden);
          __syncthreads();
          if (slot < combos)
            accumulate_gates<RT, WM>(acc, a, wg_s, wr, h_s, k0,
                                     (kn + 3) / 4, phase, phases, ul, u, U,
                                     rg, rs);
        }
      } else if (slot < combos) {
        accumulate_gates<RT, WM>(acc, a, wg_s, wr, h_s, 0, Dp / 4, phase,
                                 phases, ul, u, U, rg, rs);
      }
      publish(acc);
      if (owner) {
        float su, sr;
        sums(su, sr);
        const float uv = activate(gate_f, (xu + su) + bu);
        const float rv = activate(gate_f, (xr + sr) + br);
        const float rh = rv * h_prev;
        if (COOP) {
          a.rh[(size_t)r * D + ue] = rh;
          if (one_pass)
            u_reg = uv;
          else
            a.u_buf[(size_t)r * D + ue] = uv;
        } else {
          rh_s[(size_t)e_rl * rs + ue] = rh;
          u_reg = uv;
        }
      }
    }
    if constexpr (COOP)
      cg::this_grid().sync();
    else
      __syncthreads();
    // -- phase 2: c from (r * h) @ W_cand; h update --------------------
    for (int p = 0; p < passes; ++p) {
      const int prow0 = row0 + p * pass_rows;
      const int prows = min(pass_rows, row0 + rows_blk - prow0);
      const int r = prow0 + e_rl;
      const bool owner = gate_live && e_rl < prows;
      const size_t row = (size_t)r * T + t;
      float h_prev = h_reg, uv = u_reg;
      if (owner && !one_pass) {
        const float* x = a.xw + row * D3 + ue;
        xc = x[2 * D];
        m = a.mask ? a.mask[row] : 1.f;
        h_prev = t == 0 ? (a.h0 ? a.h0[(size_t)r * D + ue] : 0.f)
                        : __ldcg(a.hidden + (row - 1) * D + ue);
        uv = a.u_buf[(size_t)r * D + ue];
      }
      float acc[RT][2];
#pragma unroll
      for (int i = 0; i < RT; ++i) acc[i][0] = acc[i][1] = 0.f;
      if constexpr (COOP) {
        for (int k0 = 0; k0 < D; k0 += a.kc) {
          const int kn = min(a.kc, D - k0);
          __syncthreads();
          stage_rows(h_s, a.rh, D, prow0, prows, pass_rows, k0, kn, rs,
                     a.vec_h, a.hidden);
          __syncthreads();
          if (slot < combos)
            accumulate_cand<RT, WM>(acc, a, wc_s, wr, h_s, k0,
                                    (kn + 3) / 4, phase, phases, ul, u, U,
                                    rg, rs);
        }
      } else if (slot < combos) {
        accumulate_cand<RT, WM>(acc, a, wc_s, wr, rh_s, 0, Dp / 4, phase,
                                phases, ul, u, U, rg, rs);
      }
      publish(acc);
      if (owner) {
        float sc, unused;
        sums(sc, unused);
        const float c = activate(cand_f, (xc + sc) + bc);
        float h_new = uv * h_prev + (1.f - uv) * c;
        if (a.mask) h_new = h_new * m + h_prev * (1.f - m);
        if (!COOP) h_s[(size_t)e_rl * rs + ue] = h_new;
        h_reg = h_new;
        a.hidden[row * D + ue] = h_new;
        if (one_pass && t + 1 < T) {
          const float* x = a.xw + (row + 1) * D3 + ue;
          xu = x[0]; xr = x[D]; xc = x[2 * D];
          if (a.mask) m = a.mask[row + 1];
        }
      }
    }
    if constexpr (COOP)
      cg::this_grid().sync();
    else
      __syncthreads();
  }
}

// B7's layout (recurrence.cuh): the weights take 12 bytes a unit and k
// (u and r of W_gate, c of W_cand), the products leave two sums a row and
// unit.
bool plan_layout(int B, int D, int regime, int units, int rows, int kc,
                 int w_mode, Layout* out) {
  return block_layout(B, D, regime, units, rows, kc, w_mode, 12, 2, out);
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// xw [B, T, 3D], bias [3D], hidden [B, T, D], contiguous fp32; w_gate
// [D, 2D] with row stride ld_gate and w_cand [D, D] with row stride
// ld_cand (unit column stride). mask ([B, T], 1 = valid step) and h0
// ([B, D]) may be null: every step valid, zero initial state. scratch is
// [2, B, D] fp32 in regime (b) (r * h, then u), unused in (a). The plan
// (kernels/gru_cell.py `gru_plan`) is regime, units, rows, kc and w_mode;
// `plan_layout` derives the rest. A plan it refuses, or one whose shared
// memory exceeds the device's per-block limit, returns
// cudaErrorInvalidValue; a grid that cannot be co-resident returns
// cudaErrorCooperativeLaunchTooLarge.
extern "C" int paddle_gru_cell_f32(const float* xw, const float* w_gate,
                                   int ld_gate, const float* w_cand,
                                   int ld_cand, const float* bias,
                                   const float* mask, const float* h0,
                                   float* hidden, float* scratch, int B,
                                   int T, int D, int gate_act, int cand_act,
                                   int regime, int units, int rows, int kc,
                                   int w_mode, void* stream) {
  Layout L;
  if (T < 1 || ld_gate < 2 * D || ld_cand < D || gate_act < 0 ||
      gate_act > 3 || cand_act < 0 || cand_act > 3 ||
      !plan_layout(B, D, regime, units, rows, kc, w_mode, &L) ||
      (regime == 1 && !scratch))
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  if (int e = smem_limit(&limit)) return e;
  if (L.smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  float* rh = scratch;
  float* u_buf = scratch ? scratch + (size_t)B * D : nullptr;
  const int vec_h =
      D % 4 == 0 &&
      ((uintptr_t)hidden | (uintptr_t)h0 | (uintptr_t)rh) % 16 == 0;
  GruArgs args{xw, w_gate, w_cand, bias, mask, h0, hidden, rh, u_buf,
               ld_gate, ld_cand, B, T, D, gate_act, cand_act, units, rows,
               L.groups, kc, L.rs, vec_h, L.kw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PADDLE_GRU_LAUNCH(COOP, WM)                                         \
  (L.rt == 4 ? launch_kernel(gru_cell_kernel<4, COOP, WM>, args, COOP,     \
                             L.blocks, L.threads, L.smem, st)              \
             : launch_kernel(gru_cell_kernel<1, COOP, WM>, args, COOP,     \
                             L.blocks, L.threads, L.smem, st))
  if (regime == 0)
    return w_mode == kWRegs ? PADDLE_GRU_LAUNCH(false, kWRegs)
                            : PADDLE_GRU_LAUNCH(false, kWShared);
  return w_mode == kWShared ? PADDLE_GRU_LAUNCH(true, kWShared)
                            : PADDLE_GRU_LAUNCH(true, kWL2);
#undef PADDLE_GRU_LAUNCH
}

// The threads, shared-memory bytes and blocks `plan_layout` derives for a
// plan, for holding `gru_plan`'s figures to the kernel's (host code: no
// device needed); cudaErrorInvalidValue where the kernel refuses it.
extern "C" int paddle_gru_layout(int B, int D, int regime, int units,
                                 int rows, int kc, int w_mode, int* threads,
                                 int* smem, int* blocks) {
  Layout L;
  if (!plan_layout(B, D, regime, units, rows, kc, w_mode, &L))
    return (int)cudaErrorInvalidValue;
  *threads = L.threads;
  *smem = (int)L.smem;
  *blocks = L.blocks;
  return 0;
}
