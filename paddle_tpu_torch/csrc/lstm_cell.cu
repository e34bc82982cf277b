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
// (batch block, T) grid; here T is a loop inside a persistent kernel.
//
// What bounds it on this card: operations. A step does 2 * B * D * 4D
// flops against 4 * (4D + 2D) bytes per row of xw, h and c, so at the
// main shape (B 32, T 80, D 512) the floor is 5.37 GFLOP over the fp32
// rate of 67 TFLOP/s, 0.080 ms (1 us per step); its bytes (xw, h, c and
// W_h once) take 0.011 ms. What stands between a step and that floor is
// reading W_h (16 * D^2 bytes) again every step and the step-to-step
// dependency, so the design keeps W_h in shared memory for all T steps
// and spreads it over the SMs. Two regimes, chosen by `lstm_plan` in
// kernels/lstm_cell.py from (B, D, the SM count, the per-block
// shared-memory limit); the wrapper passes the plan's choices, and
// `plan_layout` below derives the block's layout from them:
//
// (a) batch split, where all of W_h plus two h buffers of the block's
//     rows and the product's sums fit one block (about 16 * D^2 +
//     8 * rows * D bytes; on an H100 up to D 119 at one row per block).
//     A block owns
//     `rows` batch rows for all T steps, loads W_h once and keeps h
//     double-buffered in shared memory; no grid barrier. At B 32, one
//     row per block: 32 blocks.
// (b) column split, above that. A block owns `units` hidden units with
//     all four of their gate columns (so the gate math and the peepholes
//     stay local) and `rows` batch rows; its W_h slice [D, 4 * units]
//     stays in shared memory. The plan splits the rows as far as the
//     slice still fits (D 512, B 32: 16 units x 8 rows, 128 KB, 32 x 4 =
//     128 blocks), which cuts the h that every block stages each step.
//     Each step every block stages h_{t-1} of its rows from
//     hidden[:, t - 1] (h0 at t = 0) with 16-byte cp.async through L2
//     (never the non-coherent path: other blocks wrote it), in k-chunks
//     where many rows would not fit, computes its gates, writes
//     hidden[:, t, units] and cell[:, t, units], and meets the others at
//     a grid barrier (cooperative_groups). The kernel is launched
//     cooperatively with at most one block per SM, so the grid is
//     co-resident or the launch is refused and the wrapper raises. Where
//     even a 1/SMs slice of W_h does not fit (D above about 1,300), the
//     slice is read from L2 every step instead; every SM still works.
//
// Both regimes share the inner product: a thread owns one hidden unit,
// RT batch rows (1 or 4) and one k-quad phase of 4 * kw (four lanes 8
// apart in a warp, times kw warp groups); per k-quad it loads the unit's
// four gate weights of four k as float4s (W_h interleaved by gate in
// shared memory) and each row's four h as one float4, then does
// 16 * RT FMAs. Each quarter-warp reads consecutive float4s (no bank
// conflict). Two shuffles finish a warp group's sum; the groups' sums go
// through shared memory to the gate threads, one (row, unit) per thread,
// consecutive threads on consecutive units, so a few dense warps do the
// gate math and their loads and stores coalesce. The activations take
// no branches (sigmoid through the ex2 and rcp special functions, tanh
// as 2 sigmoid(2x) - 1, relu / identity blended in), so the independent
// ones overlap on the step's critical path. At small D (64 at B 32) a
// thread's share of W_h fits in registers (32 floats) and the product
// reads only h from shared memory. With one pass over the block's rows
// a gate thread keeps c and h in registers and loads the next step's xw
// and mask right after its gate math, a step ahead of their use. One
// step costs one barrier for the sums plus the step's own (__syncthreads
// in (a), the grid barrier in (b)).

#include <cooperative_groups.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "recurrence.cuh"

namespace cg = cooperative_groups;

namespace {

struct LstmArgs {
  const float* xw;
  const float* w_h;
  const float* bias;
  const float* peep;
  const float* mask;
  const float* h0;
  const float* c0;
  float* hidden;  // read back by other blocks: not __restrict__, no __ldg
  float* cell;
  int B, T, D;
  int gate_act, cell_act, cand_act;
  int units;   // hidden units per block
  int rows;    // batch rows per block (regime a) or B (regime b)
  int groups;  // row groups of RT rows per pass
  int kc;      // k columns of h staged at once (regime b)
  int rs;      // row stride of h in shared memory, in floats
  int vec_h;   // D % 4 == 0 and aligned h: 16-byte cp.async staging
  int kw;      // warp groups that split k (k-quad phases: 4 * kw)
};

// acc[i][g] += sum over the k-quads phase, phase + phases, ... below nq4
// of the chunk of h[row i of group rg][k] * W_h[k0 + k, g * D + u]
template <int RT, bool W_SMEM>
__device__ __forceinline__ void accumulate(
    float (&acc)[RT][4], const float4* w_s, const float* __restrict__ w_h,
    const float* h_s, int k0, int nq4, int phase, int phases, int ul, int u,
    int U, int D, int rg, int rs) {
  const float* hr = h_s + (size_t)rg * RT * rs;
#pragma unroll 2
  for (int kq = phase; kq < nq4; kq += phases) {
    const int c = 4 * kq;
    float4 w[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      if constexpr (W_SMEM) {
        w[j] = w_s[(size_t)(k0 + c + j) * U + ul];
      } else {
        const int k = k0 + c + j;
        w[j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < D && u < D) {
          const float* row = w_h + (size_t)k * 4 * D + u;
          w[j] = make_float4(__ldg(row), __ldg(row + D), __ldg(row + 2 * D),
                             __ldg(row + 3 * D));
        }
      }
    }
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 h4 =
          *reinterpret_cast<const float4*>(hr + (size_t)i * rs + c);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][0] = fmaf(hv[j], w[j].x, acc[i][0]);
        acc[i][1] = fmaf(hv[j], w[j].y, acc[i][1]);
        acc[i][2] = fmaf(hv[j], w[j].z, acc[i][2]);
        acc[i][3] = fmaf(hv[j], w[j].w, acc[i][3]);
      }
    }
  }
}

// The same sum with the thread's W_h in registers: wr[n][j] holds the
// four gates of k = 4 (phase + n * phases) + j.
template <int RT>
__device__ __forceinline__ void accumulate_regs(
    float (&acc)[RT][4], const float4 (&wr)[kRegQuads][4], const float* h_s,
    int nq4, int phase, int phases, int rg, int rs) {
  const float* hr = h_s + (size_t)rg * RT * rs;
#pragma unroll
  for (int n = 0; n < kRegQuads; ++n) {
    const int kq = phase + n * phases;
    if (kq >= nq4) break;
#pragma unroll
    for (int i = 0; i < RT; ++i) {
      const float4 h4 =
          *reinterpret_cast<const float4*>(hr + (size_t)i * rs + 4 * kq);
      const float hv[4] = {h4.x, h4.y, h4.z, h4.w};
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        acc[i][0] = fmaf(hv[j], wr[n][j].x, acc[i][0]);
        acc[i][1] = fmaf(hv[j], wr[n][j].y, acc[i][1]);
        acc[i][2] = fmaf(hv[j], wr[n][j].z, acc[i][2]);
        acc[i][3] = fmaf(hv[j], wr[n][j].w, acc[i][3]);
      }
    }
  }
}

// COOP: regime (b), else regime (a). WM: where W_h lives (WMode; regime
// (a) takes shared memory or registers, (b) shared memory or L2).
template <int RT, bool COOP, int WM>
__global__ void __launch_bounds__(kMaxThreads, 1)
lstm_cell_kernel(LstmArgs a) {
  extern __shared__ float4 smem4[];
  const int D = a.D, T = a.T, B = a.B, U = a.units, rs = a.rs;
  const int D4 = 4 * D;
  const int Dp = (D + 3) / 4 * 4;
  float4* w_s = smem4;  // [Dp][U], rows >= D zero
  float* h_s =
      reinterpret_cast<float*>(smem4 + (WM == kWShared ? (size_t)Dp * U : 0));
  // the product's sums, one block per warp group, after the h buffers
  float* red_s = h_s + (size_t)(COOP ? 1 : 2) * a.groups * RT * rs;

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
  const int pass_rows = a.groups * RT;
  const int passes = (rows_blk + pass_rows - 1) / pass_rows;
  const bool one_pass = passes == 1;
  const int red_stride = group_warps * 8 * RT * 4;  // floats per warp group

  float4 wr[kRegQuads][4];
  if constexpr (WM == kWRegs) {
#pragma unroll
    for (int n = 0; n < kRegQuads; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int k = 4 * (phase + n * phases) + j;
        wr[n][j] = make_float4(0.f, 0.f, 0.f, 0.f);
        if (k < D && u < D && slot < combos) {
          const float* row = a.w_h + (size_t)k * D4 + u;
          wr[n][j] = make_float4(row[0], row[D], row[2 * D], row[3 * D]);
        }
      }
  }
  if (WM == kWShared) {
    // W_h[k, g * D + u] -> w_s[k][u - u0].{x,y,z,w}[g]
#pragma unroll 4
    for (int idx = tid; idx < Dp * U; idx += blockDim.x) {
      const int k = idx / U, j = u0 + idx % U;
      float4 w = make_float4(0.f, 0.f, 0.f, 0.f);
      if (j < D && k < D) {
        const float* row = a.w_h + (size_t)k * D4 + j;
        w = make_float4(row[0], row[D], row[2 * D], row[3 * D]);
      }
      w_s[idx] = w;
    }
  }
  if (!COOP) {
    // both h buffers [2][pass_rows][rs]: h0 (or 0) in the first, 0 in the
    // second and in every pad
    const int buf_size = pass_rows * rs;
    for (int idx = tid; idx < 2 * buf_size; idx += blockDim.x) {
      const int r = (idx % buf_size) / rs, k = idx % rs;
      float v = 0.f;
      if (idx < buf_size && r < rows_blk && k < D && a.h0)
        v = a.h0[(size_t)(row0 + r) * D + k];
      h_s[idx] = v;
    }
  }
  __syncthreads();

  // the gate math of (row e_rl, unit ue) of a pass is done by thread
  // e = e_rl * U + e_ul: consecutive threads on consecutive units, so its
  // loads and stores coalesce and a few dense warps do it; the product's
  // sums reach it through shared memory
  const int e_rl = tid / U, e_ul = tid % U;
  const int ue = u0 + e_ul;
  const bool gate_live = tid < U * pass_rows && ue < D;
  const float bi = gate_live ? a.bias[ue] : 0.f;
  const float bf = gate_live ? a.bias[D + ue] : 0.f;
  const float bc = gate_live ? a.bias[2 * D + ue] : 0.f;
  const float bo = gate_live ? a.bias[3 * D + ue] : 0.f;
  const float pi = gate_live && a.peep ? a.peep[ue] : 0.f;
  const float pf = gate_live && a.peep ? a.peep[D + ue] : 0.f;
  const float po = gate_live && a.peep ? a.peep[2 * D + ue] : 0.f;
  const Act gate_f = act_of(a.gate_act), cell_f = act_of(a.cell_act),
            cand_f = act_of(a.cand_act);

  // with one pass a thread does the gate math of the same (row, unit) at
  // every step: c and h stay in registers, and the next step's inputs
  // are loaded right after this step's gate math (no register copies,
  // which would wait for the loads), a whole step before their use
  float c_reg = 0.f, h_reg = 0.f;
  float x0 = 0.f, x1 = 0.f, x2 = 0.f, x3 = 0.f, m = 1.f;
  if (one_pass && gate_live && e_rl < rows_blk) {
    const int r = row0 + e_rl;
    c_reg = a.c0 ? a.c0[(size_t)r * D + ue] : 0.f;
    h_reg = a.h0 ? a.h0[(size_t)r * D + ue] : 0.f;
    const float* x = a.xw + (size_t)r * T * D4 + ue;
    x0 = x[0]; x1 = x[D]; x2 = x[2 * D]; x3 = x[3 * D];
    if (a.mask) m = a.mask[(size_t)r * T];
  }

  for (int t = 0; t < T; ++t) {
    const float* h_cur = h_s + (size_t)(t & 1) * pass_rows * rs;  // (a)
    float* h_nxt = h_s + (size_t)((t + 1) & 1) * pass_rows * rs;
    for (int p = 0; p < passes; ++p) {
      const int prow0 = row0 + p * pass_rows;
      const int prows = min(pass_rows, row0 + rows_blk - prow0);
      const int r = prow0 + e_rl;
      const bool owner = gate_live && e_rl < prows;
      const size_t row = (size_t)r * T + t;
      float c_prev = c_reg, h_prev = h_reg;
      if (owner && !one_pass) {
        const float* x = a.xw + row * D4 + ue;
        x0 = x[0]; x1 = x[D]; x2 = x[2 * D]; x3 = x[3 * D];
        m = a.mask ? a.mask[row] : 1.f;
        if (t == 0) {
          c_prev = a.c0 ? a.c0[(size_t)r * D + ue] : 0.f;
          h_prev = a.h0 ? a.h0[(size_t)r * D + ue] : 0.f;
        } else {
          c_prev = __ldcg(a.cell + (row - 1) * D + ue);
          h_prev = __ldcg(a.hidden + (row - 1) * D + ue);
        }
      }
      float acc[RT][4];
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) acc[i][g] = 0.f;
      if constexpr (COOP) {
        for (int k0 = 0; k0 < D; k0 += a.kc) {
          const int kn = min(a.kc, D - k0);
          const int nq4 = (kn + 3) / 4;
          __syncthreads();  // the last chunk's readers are done
          // h_{t-1}[pass rows, k0 : k0 + kn] from hidden[:, t - 1] (h0 at
          // t = 0), through L2: other blocks wrote it before the barrier
          if (a.vec_h) {
            for (int idx = tid; idx < pass_rows * nq4; idx += blockDim.x) {
              const int rr = idx / nq4, c = 4 * (idx % nq4);
              const size_t b = prow0 + rr;
              // 0 bytes from an aligned valid address: zeros
              const float* src = a.hidden;
              int n = 0;
              if (rr < prows && (t > 0 || a.h0)) {
                src = t > 0 ? a.hidden + (b * T + t - 1) * D + k0 + c
                            : a.h0 + b * D + k0 + c;
                n = 16;
              }
              cp_async16(h_s + (size_t)rr * rs + c, src, n);
            }
            asm volatile("cp.async.commit_group;\n" ::);
            asm volatile("cp.async.wait_group 0;\n" ::);
          } else {
            for (int idx = tid; idx < pass_rows * 4 * nq4;
                 idx += blockDim.x) {
              const int rr = idx / (4 * nq4), c = idx % (4 * nq4);
              const size_t b = prow0 + rr;
              float v = 0.f;
              if (rr < prows && c < kn) {
                if (t > 0)
                  v = __ldcg(a.hidden + (b * T + t - 1) * D + k0 + c);
                else if (a.h0)
                  v = a.h0[b * D + k0 + c];
              }
              h_s[(size_t)rr * rs + c] = v;
            }
          }
          __syncthreads();
          if (slot < combos)
            accumulate<RT, WM == kWShared>(acc, w_s, a.w_h, h_s, k0, nq4,
                                           phase, phases, ul, u, U, D, rg,
                                           rs);
        }
      } else {
        if (slot < combos) {
          if constexpr (WM == kWRegs)
            accumulate_regs<RT>(acc, wr, h_cur, Dp / 4, phase, phases, rg,
                                rs);
          else
            accumulate<RT, true>(acc, w_s, a.w_h, h_cur, 0, Dp / 4, phase,
                                 phases, ul, u, U, D, rg, rs);
        }
      }
      // the four k-quad phases are lanes 8 apart
#pragma unroll
      for (int i = 0; i < RT; ++i)
#pragma unroll
        for (int g = 0; g < 4; ++g) {
          acc[i][g] += __shfl_xor_sync(0xffffffffu, acc[i][g], 8);
          acc[i][g] += __shfl_xor_sync(0xffffffffu, acc[i][g], 16);
        }
      // every warp group's sums to shared memory, for the gate threads
      if (q == 0 && slot < combos) {
        float* dst = red_s + (size_t)wg * red_stride + slot * RT * 4;
#pragma unroll
        for (int i = 0; i < RT; ++i)
#pragma unroll
          for (int g = 0; g < 4; ++g) dst[i * 4 + g] = acc[i][g];
      }
      __syncthreads();
      if (owner) {
        const float* src =
            red_s + ((e_rl / RT) * U + e_ul) * RT * 4 + (e_rl % RT) * 4;
        float s0 = src[0], s1 = src[1], s2 = src[2], s3 = src[3];
#pragma unroll
        for (int w = 1; w < kMaxWarpGroups; ++w) {
          if (w < a.kw) {
            const float* sw = src + (size_t)w * red_stride;
            s0 += sw[0]; s1 += sw[1]; s2 += sw[2]; s3 += sw[3];
          }
        }
        if (!COOP) h_prev = h_cur[(size_t)e_rl * rs + ue];
        float gi = (x0 + s0) + bi;
        float gf = (x1 + s1) + bf;
        const float gc = (x2 + s2) + bc;
        float go = (x3 + s3) + bo;
        if (a.peep) {
          gi += c_prev * pi;
          gf += c_prev * pf;
        }
        const float iv = activate(gate_f, gi);
        const float fv = activate(gate_f, gf);
        float c_new = fv * c_prev + iv * activate(cand_f, gc);
        if (a.peep) go += c_new * po;
        const float ov = activate(gate_f, go);
        float h_new = ov * activate(cell_f, c_new);
        if (a.mask) {
          h_new = h_new * m + h_prev * (1.f - m);
          c_new = c_new * m + c_prev * (1.f - m);
        }
        if (!COOP) h_nxt[(size_t)e_rl * rs + ue] = h_new;
        c_reg = c_new;
        h_reg = h_new;
        a.hidden[row * D + ue] = h_new;
        a.cell[row * D + ue] = c_new;
        if (one_pass && t + 1 < T) {
          const float* x = a.xw + (row + 1) * D4 + ue;
          x0 = x[0]; x1 = x[D]; x2 = x[2 * D]; x3 = x[3 * D];
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

template <int RT, bool COOP, int WM>
int launch(const LstmArgs& args, int blocks, int threads, size_t smem,
           cudaStream_t stream) {
  return launch_kernel(lstm_cell_kernel<RT, COOP, WM>, args, COOP, blocks,
                       threads, smem, stream);
}

// B6's layout (recurrence.cuh): W_h takes 16 bytes a unit and k (its four
// gate columns), the product leaves four sums a row and unit.
bool plan_layout(int B, int D, int regime, int units, int rows, int kc,
                 int w_mode, Layout* out) {
  return block_layout(B, D, regime, units, rows, kc, w_mode, 16, 4, out);
}

}  // namespace

// Launches on `stream`; returns a CUDA error code (0 on success).
// xw [B, T, 4D], w_h [D, 4D], bias [4D], hidden and cell [B, T, D], all
// contiguous fp32. peep ([3, D]: w_ic, w_fc, w_oc), mask ([B, T], 1 =
// valid step), h0 and c0 ([B, D]) may be null: no peepholes, every step
// valid, zero initial state. The plan (kernels/lstm_cell.py `lstm_plan`)
// is regime, units, rows, kc and w_mode; `plan_layout` derives the rest.
// A plan it refuses, or one whose shared memory exceeds the device's
// per-block limit, returns cudaErrorInvalidValue; a grid that cannot be
// co-resident returns cudaErrorCooperativeLaunchTooLarge.
extern "C" int paddle_lstm_cell_f32(const float* xw, const float* w_h,
                                    const float* bias, const float* peep,
                                    const float* mask, const float* h0,
                                    const float* c0, float* hidden,
                                    float* cell, int B, int T, int D,
                                    int gate_act, int cell_act, int cand_act,
                                    int regime, int units, int rows, int kc,
                                    int w_mode, void* stream) {
  Layout L;
  if (T < 1 || gate_act < 0 || gate_act > 3 || cell_act < 0 ||
      cell_act > 3 || cand_act < 0 || cand_act > 3 ||
      !plan_layout(B, D, regime, units, rows, kc, w_mode, &L))
    return (int)cudaErrorInvalidValue;
  int limit = 0;
  if (int e = smem_limit(&limit)) return e;
  if (L.smem > (size_t)limit) return (int)cudaErrorInvalidValue;
  const int vec_h = D % 4 == 0 && ((uintptr_t)hidden | (uintptr_t)h0) % 16 == 0;
  LstmArgs args{xw, w_h, bias, peep, mask, h0, c0, hidden, cell, B, T, D,
                gate_act, cell_act, cand_act, units, rows, L.groups, kc,
                L.rs, vec_h, L.kw};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define PADDLE_LSTM_LAUNCH(COOP, WM)                                        \
  (L.rt == 4 ? launch<4, COOP, WM>(args, L.blocks, L.threads, L.smem, st)  \
             : launch<1, COOP, WM>(args, L.blocks, L.threads, L.smem, st))
  if (regime == 0)
    return w_mode == kWRegs ? PADDLE_LSTM_LAUNCH(false, kWRegs)
                            : PADDLE_LSTM_LAUNCH(false, kWShared);
  return w_mode == kWShared ? PADDLE_LSTM_LAUNCH(true, kWShared)
                            : PADDLE_LSTM_LAUNCH(true, kWL2);
#undef PADDLE_LSTM_LAUNCH
}

// The threads, shared-memory bytes and blocks `plan_layout` derives for a
// plan, for holding `lstm_plan`'s figures to the kernel's (host code: no
// device needed); cudaErrorInvalidValue where the kernel refuses it.
extern "C" int paddle_lstm_layout(int B, int D, int regime, int units,
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

// The current device's SM count and per-block shared-memory limit (the
// opt-in maximum), for the launch plans; returns a CUDA error code.
extern "C" int paddle_device_limits(int* n_sm, int* smem_per_block) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, dev);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(
      smem_per_block, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
}
