// LSTM recurrence, backward (BPTT), for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/lstm_pallas.py `_lstm_core_bwd` (v1,
// kernel `_bwd_kernel`) and `_lstm_core_bwd_v2` (v2, kernel
// `_bwd_kernel_v2`), the backward of `_lstm_core`'s custom VJP.
//
// Computes, for t = T-1 .. 0, from the activations the forward saved
// (csrc/lstm_fwd.cu with acts), with no recompute of the gate matmul:
//   dh_t     = round(dgates_{t+1}) @ W_hh^T           (fp32 accumulate;
//                                                      0 at t = T-1)
//   tc       = tanh(f * c_{t-1} + i * g)              (c_t rebuilt)
//   dh_tot   = dhs[:, t] + dh_t
//   dc       = dc_carry + dh_tot * o * (1 - tc^2)
//   dgates_t = [dc g i(1-i), dc c_{t-1} f(1-f), dc i (1-g^2), dh_tot tc o(1-o)]
//   dc_carry = dc * f
// and finally dh0 = round(dgates_0) @ W_hh^T, dc0 = dc_carry. round() is
// the cast to the compute dtype of W_hh, as `dgates.astype(cdtype)` in the
// JAX kernel. Every row runs all T steps; the cotangents of pad steps are
// zero, as in JAX.
//
// Layout: acts (B, T, 4H) f32 (sigmoid(i), sigmoid(f), tanh(g),
// sigmoid(o)), cs_prev (B, T, H) f32 = [c0, cs[:, :-1]], dhs (B, T, H) f32
// with dh_T folded into step T-1, dcT (B, H) f32, W_hh (H, 4H) bf16 or f32
// -> dgates (B, T, 4H) f32, dh0 (B, H) f32, dc0 (B, H) f32. The caller
// also hands a zeroed exchange buffer xbuf (2, Bp, Kp) in the compute
// dtype (Bp = grid.y * RB rows, Kp = 4H rounded up to 128 columns),
// followed by the grid barrier's u32 counter.
//
// Design: one persistent cooperative launch per layer call, as the TPU
// kernels keep W_hh resident in VMEM (constant index map) and walk every
// step with the dh / dc carries in scratch. The host plan
// (ops/lstm_cuda.bwd_plan) tiles the (row, unit) pairs: block (x, y) owns
// the UB hidden units j0 = x UB .. and the RB batch rows b0 = y RB ..; its
// grid of ceil(H/UB) x ceil(B/RB) blocks is one wave, which the
// cooperative launch guarantees (it refuses a grid that is not
// co-resident). Each block loads W_hh[j0 .. j0+UB, :] into shared memory
// once and keeps it for the launch. Then for t = T-1 .. 0, and t = -1 for
// dh0:
//   (a) stage round(dgates_{t+1}) of its rows from the exchange buffer's
//       half (t+1) & 1, SR rows by KC columns a pass, with the TMA's bulk
//       copies (one per row, issued by thread 0, completing on an
//       mbarrier). Other SMs wrote the rows and L1 is not coherent across
//       SMs; the TMA reads L2, never L1. On the H100, 16-byte loads through
//       the SM's load path took 1.3 us a step for 32 KB, the bulk copies
//       0.85 us (bench_lstm_bwd.py's fetch);
//   (b) dh = stage . W_slice^T: the 8 warps split the 4H reduction, each
//       16 or 32 units (one or two mma M-tiles) by 8 rows (bf16: mma.sync
//       m16n8k16 on the tensor cores; f32: the CUDA cores in the same
//       fragment layout); each warp's partial goes to shared memory and
//       the 8 are summed in warp order by the thread of the pair;
//   (c) the gate epilogue of the thread's (row, unit) pairs: dgates_t in
//       f32 to the output, round(dgates_t) to the buffer's half t & 1;
//   (d) dc stays in a register of the pair's thread for the whole launch;
//   (e) the grid barrier (grid_barrier.cuh, shared with the forward): the
//       block arrives (publishing its exchange writes), loads the next
//       step's acts, cs_prev and dhs, which do not depend on the
//       recurrence, and waits for the others, so the loads' latency
//       overlaps the wait.
// The ping-pong buffer needs one barrier a step: the half written at step
// t was last read at step t+1, before the barrier that ended it. T
// barriers a launch. No float atomics: every output has one writer and
// every sum a fixed order, so two runs give the same bits.
//
// What bounds it on the H100: latency. A step is a grid barrier (~1.1 us),
// an L2 fetch of RB x 4H dg values (32 KB in bf16 at RB = 8, H = 512;
// ~0.85 us), a UB x RB x 4H product (~0.7 us) and the epilogue, one after
// another: ~3.4 us at B = 32, H = 512 in bf16 (bench_lstm_bwd.py). The
// bytes the layer must move (acts, cs_prev, dhs in, dgates out: 0.079 ms
// at B = 32, T = 400) are far below that.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "grid_barrier.cuh"
#include "mma_bf16.cuh"
#include "tma_bulk.cuh"

namespace {

using grid_barrier::barrier_arrive;
using grid_barrier::barrier_wait;
using tma_bulk::mbar_wait;
using tma_bulk::tma_rows;

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr int kPairs = 2;         // (row, unit) pairs a thread owns, at most
constexpr int kTileN = 8;         // batch rows of a warp tile (the mma's N)
constexpr int kKAlign = 128;      // 4H is padded to kWarps x 16 columns
constexpr int kPadBytes = 16;     // row pitch of 4 (mod 32) words

struct BwdArgs {
  const float* acts;
  const float* cs_prev;
  const float* dhs;
  const float* dcT;
  const void* w_hh;
  float* dgates;
  float* dh0;
  float* dc0;
  void* xbuf;
  unsigned int* arrived;  // the grid barrier's zeroed counter
  int B, T, H, Bp, Kp;
  int rows, stage_rows, stage_cols;  // RB, SR, KC
};

template <typename W>
__device__ __forceinline__ W from_float(float v);
template <>
__device__ __forceinline__ float from_float<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_float<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Elements of padding that give a row of W a pitch of 4 (mod 32) words.
template <typename W>
__host__ __device__ constexpr int pad_elems() {
  return kPadBytes / (int)sizeof(W);
}

// 16-unit tiles of a block's UB units (one for UB = 8).
template <int UB>
__host__ __device__ constexpr int m_tiles() {
  return UB < 16 ? 1 : UB / 16;
}

// Warp tile, bf16: d[m] += W_s[16 m .. 16 m + 16, wk0 ..] .
// dg_s[n0 .. n0 + 8, sk0 ..]^T over kw columns, d[m] in the mma's D layout
// (unit 16 m + g or 16 m + g + 8, row n0 + 2q (+1)). Even and odd k steps
// go to two accumulator chains, summed at the end: a fixed order.
template <int UB>
__device__ __forceinline__ void warp_tile(float (&d)[m_tiles<UB>()][4],
                                          const __nv_bfloat16* w_s, int wp,
                                          int wk0, const __nv_bfloat16* dg_s,
                                          int sp, int n0, int sk0, int kw,
                                          int lane) {
  static_assert(UB == 16 || UB == 32, "bf16 tiles take 16 or 32 units");
  constexpr int kM = m_tiles<UB>();
  float e[kM][4] = {};
  uint32_t a[4], b[2];
  int k = 0;
#pragma unroll 2
  for (; k + 32 <= kw; k += 32) {
    joint_mma::frag_b(b, dg_s, sp, n0, sk0 + k, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      joint_mma::frag_a(a, w_s, wp, 16 * m, wk0 + k, lane);
      joint_mma::mma_16816(d[m], a, b);
    }
    joint_mma::frag_b(b, dg_s, sp, n0, sk0 + k + 16, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      joint_mma::frag_a(a, w_s, wp, 16 * m, wk0 + k + 16, lane);
      joint_mma::mma_16816(e[m], a, b);
    }
  }
  if (k < kw) {  // kw is a multiple of 16
    joint_mma::frag_b(b, dg_s, sp, n0, sk0 + k, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      joint_mma::frag_a(a, w_s, wp, 16 * m, wk0 + k, lane);
      joint_mma::mma_16816(d[m], a, b);
    }
  }
#pragma unroll
  for (int m = 0; m < kM; ++m) {
#pragma unroll
    for (int i = 0; i < 4; ++i) d[m][i] += e[m][i];
  }
}

// Warp tile, f32, on the CUDA cores in the mma's D layout: lane (g, q)
// sums units g (and g + 8 when UB = 16) against rows n0 + 2q, n0 + 2q + 1,
// four columns a load.
template <int UB>
__device__ __forceinline__ void warp_tile(float (&dm)[m_tiles<UB>()][4],
                                          const float* w_s, int wp, int wk0,
                                          const float* dg_s, int sp, int n0,
                                          int sk0, int kw, int lane) {
  static_assert(UB == 16 || UB == 8, "f32 tiles take 8 or 16 units");
  float (&d)[4] = dm[0];
  const int g = lane >> 2;
  const int q = lane & 3;
  const float* wa = w_s + (size_t)g * wp + wk0;
  const float* wb = wa + (size_t)8 * wp;
  const float* x0 = dg_s + (size_t)(n0 + 2 * q) * sp + sk0;
  const float* x1 = x0 + sp;
#pragma unroll 4
  for (int k = 0; k < kw; k += 4) {
    const float4 a = *reinterpret_cast<const float4*>(wa + k);
    const float4 u = *reinterpret_cast<const float4*>(x0 + k);
    const float4 v = *reinterpret_cast<const float4*>(x1 + k);
    d[0] = fmaf(a.x, u.x, d[0]);
    d[0] = fmaf(a.y, u.y, d[0]);
    d[0] = fmaf(a.z, u.z, d[0]);
    d[0] = fmaf(a.w, u.w, d[0]);
    d[1] = fmaf(a.x, v.x, d[1]);
    d[1] = fmaf(a.y, v.y, d[1]);
    d[1] = fmaf(a.z, v.z, d[1]);
    d[1] = fmaf(a.w, v.w, d[1]);
    if (UB == 16) {
      const float4 b = *reinterpret_cast<const float4*>(wb + k);
      d[2] = fmaf(b.x, u.x, d[2]);
      d[2] = fmaf(b.y, u.y, d[2]);
      d[2] = fmaf(b.z, u.z, d[2]);
      d[2] = fmaf(b.w, u.w, d[2]);
      d[3] = fmaf(b.x, v.x, d[3]);
      d[3] = fmaf(b.y, v.y, d[3]);
      d[3] = fmaf(b.z, v.z, d[3]);
      d[3] = fmaf(b.w, v.w, d[3]);
    }
  }
}

// red_s[w][r][u] = warp w's share of sum_k round(dg[b0 + r][k]) W[j0 + u][k]
// for the block's RB rows, from the exchange buffer's half `src`: a pass
// stages SR rows by KC columns through the TMA, then each warp takes its
// KC / 8 columns of every 8-row tile.
template <typename W, int UB>
__device__ __forceinline__ void product(const BwdArgs& p, const W* src,
                                        const W* w_s, W* dg_s, float* red_s,
                                        int b0, unsigned int mbar,
                                        unsigned int& phase) {
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int g = lane >> 2;
  const int q = lane & 3;
  const int RB = p.rows;
  const int SR = p.stage_rows;
  const int KC = p.stage_cols;
  const int wp = p.Kp + pad_elems<W>();
  const int sp = KC + pad_elems<W>();
  const int kw = KC / kWarps;
  for (int r0 = 0; r0 < RB; r0 += SR) {
    for (int c0 = 0; c0 < p.Kp; c0 += KC) {
      // (a) stage rows b0 + r0 .., columns c0 .. c0 + KC
      if (threadIdx.x == 0) {
        tma_rows(dg_s, sp, src + (size_t)(b0 + r0) * p.Kp + c0, p.Kp, SR,
                 (unsigned int)(KC * sizeof(W)), mbar);
      }
      mbar_wait(mbar, phase);
      // (b) the warp's kw columns, every 8-row tile of the stage
      for (int n0 = 0; n0 < SR; n0 += kTileN) {
        float d[m_tiles<UB>()][4] = {};
        warp_tile<UB>(d, w_s, wp, c0 + warp * kw, dg_s, sp, n0, warp * kw,
                      kw, lane);
        float* rs = red_s + ((size_t)warp * RB + r0 + n0) * UB;
        float* r_lo = rs + (size_t)(2 * q) * UB + g;
        float* r_hi = r_lo + UB;
#pragma unroll
        for (int m = 0; m < m_tiles<UB>(); ++m) {
          const int u = 16 * m;
          if (c0 == 0) {
            r_lo[u] = d[m][0];
            r_hi[u] = d[m][1];
            if (UB >= 16) {
              r_lo[u + 8] = d[m][2];
              r_hi[u + 8] = d[m][3];
            }
          } else {
            r_lo[u] += d[m][0];
            r_hi[u] += d[m][1];
            if (UB >= 16) {
              r_lo[u + 8] += d[m][2];
              r_hi[u + 8] += d[m][3];
            }
          }
        }
      }
      __syncthreads();  // the stage is consumed; after the last, red_s is
                        // complete
    }
  }
}

template <typename W, int UB>
__global__ void __launch_bounds__(kThreads, 1)
lstm_bwd_persistent_kernel(BwdArgs p) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H;
  const int H4 = 4 * H;
  const int T = p.T;
  const int RB = p.rows;
  const int wp = p.Kp + pad_elems<W>();
  const int sp = p.stage_cols + pad_elems<W>();
  W* w_s = reinterpret_cast<W*>(smem);              // [UB][wp]
  W* dg_s = w_s + (size_t)UB * wp;                  // [SR][sp]
  float* red_s = reinterpret_cast<float*>(dg_s + (size_t)p.stage_rows * sp);
  const int tid = threadIdx.x;
  const int j0 = blockIdx.x * UB;
  const int b0 = blockIdx.y * RB;
  const W* w_hh = static_cast<const W*>(p.w_hh);
  W* xbuf = static_cast<W*>(p.xbuf);
  const size_t half = (size_t)p.Bp * p.Kp;
  const unsigned int n_blocks = gridDim.x * gridDim.y;
  __shared__ alignas(8) unsigned long long mbar_s;  // the stage's TMA
  const unsigned int mbar =
      static_cast<unsigned int>(__cvta_generic_to_shared(&mbar_s));
  unsigned int phase = 0;
  if (tid == 0) tma_bulk::mbar_init(mbar);

  // W_hh[j0 .. j0 + UB, :] for the whole launch; zero past H and past 4H.
  // 16-byte loads where every row of W_hh starts on 16 bytes.
  constexpr int kVec = 16 / (int)sizeof(W);
  if (((reinterpret_cast<uintptr_t>(w_hh) | (size_t)H4 * sizeof(W)) & 15) ==
      0) {
    const int vrow = p.Kp / kVec;
#pragma unroll 4
    for (int idx = tid; idx < UB * vrow; idx += kThreads) {
      const int u = idx / vrow;
      const int k = (idx - u * vrow) * kVec;
      const int j = j0 + u;
      *reinterpret_cast<int4*>(w_s + (size_t)u * wp + k) =
          (j < H && k < H4) ? __ldg(reinterpret_cast<const int4*>(
                                  w_hh + (size_t)j * H4 + k))
                            : make_int4(0, 0, 0, 0);
    }
  } else {
#pragma unroll 8
    for (int idx = tid; idx < UB * p.Kp; idx += kThreads) {
      const int u = idx / p.Kp;
      const int k = idx - u * p.Kp;
      const int j = j0 + u;
      w_s[(size_t)u * wp + k] = (j < H && k < H4) ? w_hh[(size_t)j * H4 + k]
                                                  : from_float<W>(0.0f);
    }
  }

  // the thread's (row, unit) pairs, its dc carry and the step's inputs
  int pb[kPairs], pj[kPairs], pr[kPairs], pu[kPairs];
  bool live[kPairs];
  float dc[kPairs], gi[kPairs], gf[kPairs], gg[kPairs], go[kPairs],
      cp[kPairs], dhv[kPairs];
#pragma unroll
  for (int s = 0; s < kPairs; ++s) {
    const int idx = tid + s * kThreads;
    pr[s] = idx / UB;
    pu[s] = idx - pr[s] * UB;
    pb[s] = b0 + pr[s];
    pj[s] = j0 + pu[s];
    live[s] = idx < RB * UB && pb[s] < p.B && pj[s] < H;
    dc[s] = live[s] ? p.dcT[(size_t)pb[s] * H + pj[s]] : 0.0f;
  }
  auto prefetch = [&](int t) {
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      if (!live[s]) continue;
      const size_t bt = (size_t)pb[s] * T + t;
      const float* a = p.acts + bt * H4 + pj[s];
      gi[s] = a[0];
      gf[s] = a[H];
      gg[s] = a[2 * H];
      go[s] = a[3 * H];
      cp[s] = p.cs_prev[bt * H + pj[s]];
      dhv[s] = p.dhs[bt * H + pj[s]];
    }
  };
  prefetch(T - 1);

  for (int t = T - 1; t >= -1; --t) {
    float dh[kPairs];
#pragma unroll
    for (int s = 0; s < kPairs; ++s) dh[s] = 0.0f;
    // dh_t from round(dgates_{t+1}); 0 at t = T-1. The grid barrier that
    // ended the last step also ordered the W_s load and the mbarrier's
    // init before this, and freed red_s.
    if (t + 1 < T) {
      product<W, UB>(p, xbuf + (size_t)((t + 1) & 1) * half, w_s, dg_s,
                     red_s, b0, mbar, phase);
#pragma unroll
      for (int s = 0; s < kPairs; ++s) {
        if (!live[s]) continue;
        float acc = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          acc += red_s[((size_t)w * RB + pr[s]) * UB + pu[s]];
        }
        dh[s] = acc;
      }
    }
    if (t < 0) {
#pragma unroll
      for (int s = 0; s < kPairs; ++s) {
        if (!live[s]) continue;
        const size_t bj = (size_t)pb[s] * H + pj[s];
        p.dh0[bj] = dh[s];
        p.dc0[bj] = dc[s];
      }
      break;
    }
    W* dst = xbuf + (size_t)(t & 1) * half;
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      if (!live[s]) continue;
      const float tc = tanhf(gf[s] * cp[s] + gi[s] * gg[s]);
      const float dh_tot = dhv[s] + dh[s];
      const float d_o = dh_tot * tc;
      const float dcv = dc[s] + dh_tot * go[s] * (1.0f - tc * tc);
      const float d0 = dcv * gg[s] * gi[s] * (1.0f - gi[s]);
      const float d1 = dcv * cp[s] * gf[s] * (1.0f - gf[s]);
      const float d2 = dcv * gi[s] * (1.0f - gg[s] * gg[s]);
      const float d3 = d_o * go[s] * (1.0f - go[s]);
      float* out = p.dgates + ((size_t)pb[s] * T + t) * H4 + pj[s];
      out[0] = d0;
      out[H] = d1;
      out[2 * H] = d2;
      out[3 * H] = d3;
      W* x = dst + (size_t)pb[s] * p.Kp + pj[s];
      x[0] = from_float<W>(d0);
      x[H] = from_float<W>(d1);
      x[2 * H] = from_float<W>(d2);
      x[3 * H] = from_float<W>(d3);
      dc[s] = dcv * gf[s];
    }
    barrier_arrive(p.arrived);
    if (t > 0) prefetch(t - 1);
    barrier_wait(p.arrived, (unsigned int)(T - t) * n_blocks);
  }
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

template <typename W, int UB>
int launch(const BwdArgs& a, int grid_x, int grid_y, int device,
           cudaStream_t stream) {
  const auto kernel = lstm_bwd_persistent_kernel<W, UB>;
  // dynamic shared bytes: the W slice, the stage, the warps' partials
  // (ops/lstm_cuda._bwd_smem adds the mbarrier's static 16)
  const size_t smem =
      ((size_t)UB * (a.Kp + pad_elems<W>()) +
       (size_t)a.stage_rows * (a.stage_cols + pad_elems<W>())) * sizeof(W) +
      (size_t)kWarps * a.rows * UB * sizeof(float);
  cudaError_t e = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (e != cudaSuccess) return (int)e;
  int per_sm = 0;
  int n_sm = 0;
  e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel,
                                                    kThreads, smem);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  if ((long long)per_sm * n_sm < (long long)grid_x * grid_y) {
    return (int)cudaErrorCooperativeLaunchTooLarge;
  }
  BwdArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid_x, grid_y), dim3(kThreads),
                                  params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// The card's limits the host plan needs: SMs, the shared memory a block
// may opt in to, and whether the card takes cooperative launches.
extern "C" int lstm_bwd_limits(int device, int* n_sm, int* smem_per_block,
                               int* cooperative) {
  cudaError_t e =
      cudaDeviceGetAttribute(n_sm, cudaDevAttrMultiProcessorCount, device);
  if (e != cudaSuccess) return (int)e;
  e = cudaDeviceGetAttribute(smem_per_block,
                             cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaDeviceGetAttribute(cooperative,
                                     cudaDevAttrCooperativeLaunch, device);
}

// One call runs one layer's backward as one cooperative launch on
// `stream`, with the tile of ops/lstm_cuda.bwd_plan: `units` (UB) hidden
// units and `rows` (RB) batch rows a block, the rows staged `stage_rows`
// (SR) by `stage_cols` (KC) at a time. `xbuf` is the zeroed exchange
// buffer (2, ceil(B / RB) RB, Kp). Returns 0, or a cudaError_t: a tile the
// kernel does not take, a card without cooperative launches, or a grid
// that is not co-resident (cudaErrorCooperativeLaunchTooLarge).
extern "C" int lstm_bwd(const void* acts, const void* cs_prev,
                        const void* dhs, const void* dcT, const void* w_hh,
                        int w_is_bf16, void* dgates, void* dh0, void* dc0,
                        void* xbuf, int B, int T, int H, int units, int rows,
                        int stage_rows, int stage_cols, int device,
                        void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int Kp = round_up(4 * H, kKAlign);
  if (B < 1 || T < 1 || H < 1 || rows < kTileN || rows % stage_rows ||
      stage_rows % kTileN || stage_cols % kKAlign || Kp % stage_cols ||
      rows * units > kPairs * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid_x = (H + units - 1) / units;
  const int grid_y = (B + rows - 1) / rows;
  const BwdArgs a{static_cast<const float*>(acts),
                  static_cast<const float*>(cs_prev),
                  static_cast<const float*>(dhs),
                  static_cast<const float*>(dcT),
                  w_hh,
                  static_cast<float*>(dgates),
                  static_cast<float*>(dh0),
                  static_cast<float*>(dc0),
                  xbuf,
                  reinterpret_cast<unsigned int*>(
                      static_cast<char*>(xbuf) +
                      2 * (size_t)grid_y * rows * Kp *
                          (w_is_bf16 ? 2 : 4)),
                  B, T, H, grid_y * rows, Kp,
                  rows, stage_rows, stage_cols};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    if (units == 32) {
      return launch<__nv_bfloat16, 32>(a, grid_x, grid_y, device, s);
    }
    if (units == 16) {
      return launch<__nv_bfloat16, 16>(a, grid_x, grid_y, device, s);
    }
    return (int)cudaErrorInvalidValue;
  }
  if (units == 16) return launch<float, 16>(a, grid_x, grid_y, device, s);
  if (units == 8) return launch<float, 8>(a, grid_x, grid_y, device, s);
  return (int)cudaErrorInvalidValue;
}
