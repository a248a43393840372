// W8A8 LSTM recurrence, forward (inference), for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/lstm_pallas.py `_lstm_core_fwd_v2_q`
// (kernel `_fwd_kernel_v2_q`), the int8 serving core that
// `lstm_layer_pallas` runs for an int8 QTensor W_hh.
//
// Computes, for t = 0 .. T-1, with gate order i, f, g, o, for each batch
// tile of BT rows (BT from the JAX package's `_tile_bt_v2`, chosen by the
// wrapper; it decides which rows share one scale and so the result):
//   amax  = max(max |h_{t-1}| over the BT x H tile, 1e-6)
//   hq    = round_half_even(h_{t-1} * (127 / amax))        int8
//   acc   = hq @ Wq                                        int32, exact
//   gates = x_proj[:, t] + float(acc) * (scale * (amax / 127))
//   c_t   = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)    (fp32)
//   h_t   = sigmoid(o) * tanh(c_t)                         (fp32)
// The float operations keep the JAX kernel's order: 127 / amax before the
// product, scale * (amax / 127) before the product with acc, and no
// contraction into fused multiply-adds (the __f*_rn intrinsics), so the
// kernel matches its plain version up to the rounding of expf / tanhf.
//
// Layout: x_proj (B, T, 4H) f32 or bf16, Wq (H, 4H) int8, scale (4H) f32,
// h0/c0 (B, H) f32 -> hs (B, T, H) f32 and c (B, H) f32, the final cell
// state (serving reads hs and c_T only). The caller also hands a zeroed
// exchange buffer: h of the last two steps, (2, Bp, Kp) f32 (Bp = grid.y
// RB rows, Kp = H rounded up to 256 columns), then the amax slots (2, Bp,
// grid.x) f32, then the grid barrier's u32 counter.
//
// Design: K4-fwd's (csrc/lstm_fwd.cu), in int8: one persistent cooperative
// launch per layer call on the tile of the host plan
// (ops/lstm_cuda.fwd_q_plan). Block (x, y) owns the UB hidden units
// j0 = x UB .. and the RB batch rows b0 = y RB ..; its grid is one wave.
// Each block loads the 4 UB int8 gate columns of its units,
// Wq[:, g H + j0 .. g H + j0 + UB], transposed into shared memory once and
// keeps them for the launch, with the scales and the c carry of its pairs
// in registers. Then for t = 0 .. T-1:
//   (a) each batch tile the block's rows meet gets its amax: at t = 0 from
//       |h0| over the tile's BT x H values; after that from the slots that
//       step t-1 wrote, one a row and block of the grid's x (the block's
//       max |h| of the row over its units), BT x grid.x values, read by
//       warps 1-7 while thread 0 issues (b)'s copy. A max is the same in
//       any order, so the scale is the step-per-launch design's; a lane
//       of each warp then takes 127 / amax and amax / 127 of each tile,
//       and every lane reads its row's by a shuffle;
//   (b) stage h_{t-1} of its rows in f32, SR rows by KC columns a pass: at
//       t = 0 from h0 itself; after that from the exchange buffer's half
//       t & 1 with the TMA's bulk copies (issued by thread 0 before (a),
//       completing on an mbarrier), since other SMs wrote the rows and L1
//       is not coherent across SMs;
//   (c) gates = hq . W_slice on the tensor cores (mma.sync m16n8k32 s8 x
//       s8 -> s32): the 8 warps split the H reduction, each 4 UB gate
//       columns by 8 rows, and quantize their B fragments as they read
//       them from the f32 stage (each value read once a step; rows past B
//       are zero); each warp's int32 partial goes to shared memory and the
//       8 are summed by the thread of the pair: an int32 sum is exact in
//       any order;
//   (d) the gate epilogue of the thread's (row, unit) pairs with the JAX
//       kernel's intrinsics: hs in f32 to the output, h_t in f32 to the
//       buffer's half (t + 1) & 1, and the block's max |h_t| of each of its
//       rows (a warp reduction over the row's UB lanes) to the slots' half
//       (t + 1) & 1;
//   (e) the grid barrier (grid_barrier.cuh): the block arrives (publishing
//       its exchange writes), loads the next step's x_proj and waits.
// The ping-pong halves need one barrier a step, for the slots as for h: a
// half written at step t was last read at step t-1, before the barrier that
// ended it. The last step needs none: T-1 barriers a launch. No float
// atomics; every slot and output has one writer, so the bits are those of
// the step-per-launch design it replaced and repeat from run to run.
//
// What bounds it on the H100: latency, as K4-fwd. A step is a grid
// barrier, an L2 fetch of RB x H f32 h values (16 KB at RB = 8, H = 512,
// twice K4-fwd's bf16) beside BT x grid.x slots (1 KB at the serving
// shape), a block barrier for the tiles' maxima, a 4 UB x RB x H int8
// product (half K4-fwd's mma instructions) and the epilogue, one after
// another. The bytes the layer must move (x_proj in, hs out: 0.012 ms at
// B = 8, T = 800 in bf16) are far below that.

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
constexpr int kPairs = 2;          // (row, unit) pairs a thread owns, at most
constexpr int kTileN = 8;          // batch rows of a warp tile (the mma's N)
constexpr int kKAlign = kWarps * 32;  // H is padded to kWarps x 32 columns
constexpr int kPad = 16;           // bytes past an int8 row: a pitch of 4
                                   // (mod 32) words
constexpr int kStagePad = 16;      // floats past a stage row: a pitch of 16
                                   // (mod 32) words
constexpr int kMinUnits = 16;
// Batch tiles a block's rows meet, at most: RB <= kPairs kThreads /
// kMinUnits = 32 rows, and a tile is B < 8 rows (then the only one) or a
// multiple of 8 that divides RB or that RB divides.
constexpr int kMaxTiles = kPairs * kThreads / kMinUnits / kTileN;

struct QArgs {
  const void* x_proj;
  const int8_t* wq;
  const float* scale;
  const float* h0;
  const float* c0;
  float* hs;
  float* c;
  float* xbuf;            // (2, Bp, Kp): h of the last two steps
  float* slots;           // (2, Bp, grid.x): a block's max |h| of a row
  unsigned int* arrived;  // the grid barrier's zeroed counter
  int B, T, H, BT, Bp, Kp;
  int rows, stage_rows, stage_cols;  // RB, SR, KC
};

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

__device__ __forceinline__ float sigmoid(float x) {
  return __frcp_rn(__fadd_rn(1.0f, expf(-x)));
}

__device__ __forceinline__ float warp_max(float m) {
#pragma unroll
  for (int off = 16; off > 0; off /= 2) {
    m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
  }
  return m;
}

// Four int8 of round_half_even(v * inv), K7's quantization, in one
// register, the first in the low byte.
__device__ __forceinline__ uint32_t quantize4(const float4& v, float inv) {
  const float f[4] = {v.x, v.y, v.z, v.w};
  uint32_t word = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    word |= ((uint32_t)__float2int_rn(__fmul_rn(f[i], inv)) & 0xffu)
            << (8 * i);
  }
  return word;
}

// B fragment of k0..k0+31 x n0..n0+7 (mma_bf16.cuh's int8 layout: rows
// 4q .. 4q+3 and 4q+16 .. 4q+19 of column g), quantized with the row's
// `inv` as it is read from the f32 stage (element (k, n) at
// f_s[n * pitch + k]; a pitch of 16 (mod 32) words puts the two rows of a
// quarter warp's 16-byte loads on distinct banks).
__device__ __forceinline__ void frag_b_quantized(uint32_t (&b)[2],
                                                 const float* f_s, int pitch,
                                                 int n0, int k0, int lane,
                                                 float inv) {
  const int g = lane >> 2;
  const int q = lane & 3;
  const float* p = f_s + (size_t)(n0 + g) * pitch + k0 + 4 * q;
  b[0] = quantize4(*reinterpret_cast<const float4*>(p), inv);
  b[1] = quantize4(*reinterpret_cast<const float4*>(p + 16), inv);
}

// Warp tile: d[m] += W_s[16 m .. 16 m + 16, wk0 ..] .
// hq[n0 .. n0 + 8, sk0 ..]^T over kw columns (a multiple of 32), hq the
// f32 stage quantized with each lane's row's `inv`; d[m] in the mma's D
// layout (gate column 16 m + g or 16 m + g + 8, row n0 + 2q (+1)).
template <int kM>
__device__ __forceinline__ void warp_tile(int (&d)[kM][4], const int8_t* w_s,
                                          int wp, int wk0, const float* f_s,
                                          int fp, int n0, int sk0, int kw,
                                          int lane, float inv) {
  uint32_t a[4], b[2];
#pragma unroll 2
  for (int k = 0; k < kw; k += 32) {
    frag_b_quantized(b, f_s, fp, n0, sk0 + k, lane, inv);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      joint_mma::frag_a(a, w_s, wp, 16 * m, wk0 + k, lane);
      joint_mma::mma_16832_s8(d[m], a, b);
    }
  }
}

template <typename X, int UB>
__global__ void __launch_bounds__(kThreads, 1)
lstm_q_persistent_kernel(QArgs p) {
  constexpr int M = 4 * UB;  // the block's gate columns, gate-major
  constexpr int kM = M / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H;
  const size_t H4 = 4 * (size_t)H;
  const int T = p.T;
  const int RB = p.rows;
  const int SR = p.stage_rows;
  const int KC = p.stage_cols;
  const int wp = p.Kp + kPad;
  const int fp = KC + kStagePad;
  int8_t* w_s = reinterpret_cast<int8_t*>(smem);                  // [M][wp]
  float* f_s = reinterpret_cast<float*>(w_s + (size_t)M * wp);    // [SR][fp]
  int* red_s = reinterpret_cast<int*>(f_s + (size_t)SR * fp);   // [8][RB][M]
  float* wmax_s = reinterpret_cast<float*>(red_s + (size_t)kWarps * RB * M);
  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int gx = gridDim.x;
  const int j0 = blockIdx.x * UB;
  const int b0 = blockIdx.y * RB;
  const int BT = p.BT;
  // the batch tiles of the block's rows b0 .. min(b0 + RB, B) - 1
  const int tile_first = b0 / BT;
  const int n_tiles = (min(b0 + RB, p.B) - 1) / BT - tile_first + 1;
  const size_t half = (size_t)p.Bp * p.Kp;
  const size_t slot_half = (size_t)p.Bp * gx;
  const unsigned int n_blocks = gridDim.x * gridDim.y;
  __shared__ alignas(8) unsigned long long mbar_s;  // the stage's TMA
  const unsigned int mbar =
      static_cast<unsigned int>(__cvta_generic_to_shared(&mbar_s));
  unsigned int phase = 0;
  if (tid == 0) tma_bulk::mbar_init(mbar);

  // w_s[g UB + u][k] = Wq[k][g H + j0 + u] for the whole launch; zero past H
  // (units and k). 16-byte loads of 16 units where every row and gate block
  // of Wq starts on 16 bytes.
  if (((reinterpret_cast<uintptr_t>(p.wq) | (size_t)H) & 15) == 0) {
    constexpr int vrow = M / 16;  // 16-byte vectors of a k row
#pragma unroll 4
    for (int idx = tid; idx < p.Kp * vrow; idx += kThreads) {
      const int k = idx / vrow;
      const int n = (idx - k * vrow) * 16;
      const int gate = n / UB;
      const int j = j0 + n - gate * UB;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < H && j < H) {
        v = __ldg(reinterpret_cast<const int4*>(p.wq + (size_t)k * H4 +
                                                (size_t)gate * H + j));
      }
      const int w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < 16; ++i) {
        w_s[(size_t)(n + i) * wp + k] =
            static_cast<int8_t>((unsigned int)w[i >> 2] >> (8 * (i & 3)));
      }
    }
  } else {
#pragma unroll 8
    for (int idx = tid; idx < p.Kp * M; idx += kThreads) {
      const int k = idx / M;
      const int n = idx - k * M;
      const int gate = n / UB;
      const int j = j0 + n - gate * UB;
      w_s[(size_t)n * wp + k] =
          (k < H && j < H) ? p.wq[(size_t)k * H4 + (size_t)gate * H + j] : 0;
    }
  }

  // the thread's (row, unit) pairs: their batch tile, gate scales, c carry
  // and the step's x_proj
  int pb[kPairs], pj[kPairs], pr[kPairs], pu[kPairs], ptile[kPairs];
  bool live[kPairs];
  float cv[kPairs], sc[kPairs][4], xv[kPairs][4];
#pragma unroll
  for (int s = 0; s < kPairs; ++s) {
    const int idx = tid + s * kThreads;
    pr[s] = idx / UB;
    pu[s] = idx - pr[s] * UB;
    pb[s] = b0 + pr[s];
    pj[s] = j0 + pu[s];
    live[s] = idx < RB * UB && pb[s] < p.B && pj[s] < H;
    ptile[s] = live[s] ? pb[s] / BT - tile_first : 0;
    cv[s] = live[s] ? p.c0[(size_t)pb[s] * H + pj[s]] : 0.0f;
#pragma unroll
    for (int g = 0; g < 4; ++g) {
      sc[s][g] = live[s] ? p.scale[(size_t)g * H + pj[s]] : 0.0f;
    }
  }
  const X* x_proj = static_cast<const X*>(p.x_proj);
  auto prefetch = [&](int t) {
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      if (!live[s]) continue;
      const X* xp = x_proj + ((size_t)pb[s] * T + t) * H4 + pj[s];
#pragma unroll
      for (int g = 0; g < 4; ++g) xv[s][g] = to_float(xp[(size_t)g * H]);
    }
  };
  prefetch(0);
  __syncthreads();  // the W slice and the mbarrier's init, before step 0

  const int kw = KC / kWarps;
  for (int t = 0; t < T; ++t) {
    const float* src = p.xbuf + (size_t)(t & 1) * half;
    if (t > 0 && tid == 0) {  // the first pass's rows, in flight during (a)
      tma_rows(f_s, fp, src + (size_t)b0 * p.Kp, p.Kp, SR,
               (unsigned int)(KC * sizeof(float)), mbar);
    }
    // (a) each tile's max |h_{t-1}|: the maxima of warps 1-7 (warp 0
    // issues the TMA at t > 0), then, after the block barrier, the block's
    for (int ti = 0; ti < n_tiles; ++ti) {
      const int tile0 = (tile_first + ti) * BT;
      float m = 0.0f;
      if (t == 0) {
        const float* h = p.h0 + (size_t)tile0 * H;
        for (int e = tid - 32; e >= 0 && e < BT * H; e += kThreads - 32) {
          m = fmaxf(m, fabsf(h[e]));
        }
      } else {
        const float* sl = p.slots + (size_t)(t & 1) * slot_half +
                          (size_t)tile0 * gx;
        for (int e = tid - 32; e >= 0 && e < BT * gx; e += kThreads - 32) {
          m = fmaxf(m, __ldcg(sl + e));
        }
      }
      m = warp_max(m);
      if (lane == 0) wmax_s[warp * kMaxTiles + ti] = m;
    }
    __syncthreads();
    // lane l of every warp takes tile l % kMaxTiles's amax, 127 / amax
    // and amax / 127 (one division of each a warp); a lane reads its
    // row's from that lane
    float tile_inv, tile_step;
    {
      const int ti = min(lane % kMaxTiles, n_tiles - 1);
      float amax = wmax_s[ti];
#pragma unroll
      for (int w = 1; w < kWarps; ++w) {
        amax = fmaxf(amax, wmax_s[w * kMaxTiles + ti]);
      }
      amax = fmaxf(amax, 1e-6f);
      tile_inv = __fdiv_rn(127.0f, amax);
      tile_step = __fdiv_rn(amax, 127.0f);
    }

    for (int r0 = 0; r0 < RB; r0 += SR) {
      for (int c0 = 0; c0 < p.Kp; c0 += KC) {
        // (b) the stage: rows b0 + r0 .., columns c0 .. c0 + KC of h_{t-1}
        if (t == 0) {
          for (int idx = tid; idx < SR * KC; idx += kThreads) {
            const int r = idx / KC;
            const int k = idx - r * KC;
            const int b = b0 + r0 + r;
            const int col = c0 + k;
            f_s[(size_t)r * fp + k] =
                (b < p.B && col < H) ? p.h0[(size_t)b * H + col] : 0.0f;
          }
          __syncthreads();
        } else {
          mbar_wait(mbar, phase);
        }
        // (c) the warp's kw columns, every 8-row tile of the stage,
        // quantized as the B fragments are read (rows past B are zero)
        for (int n0 = 0; n0 < SR; n0 += kTileN) {
          const int b = min(b0 + r0 + n0 + (lane >> 2), p.B - 1);
          const float row_inv =
              __shfl_sync(0xffffffffu, tile_inv, b / BT - tile_first);
          int d[kM][4] = {};
          warp_tile<kM>(d, w_s, wp, c0 + warp * kw, f_s, fp, n0, warp * kw,
                        kw, lane, row_inv);
          const int g = lane >> 2;
          const int q = lane & 3;
          int* r_lo = red_s + ((size_t)warp * RB + r0 + n0 + 2 * q) * M + g;
          int* r_hi = r_lo + M;
#pragma unroll
          for (int m = 0; m < kM; ++m) {
            const int n = 16 * m;
            if (c0 == 0) {
              r_lo[n] = d[m][0];
              r_hi[n] = d[m][1];
              r_lo[n + 8] = d[m][2];
              r_hi[n + 8] = d[m][3];
            } else {
              r_lo[n] += d[m][0];
              r_hi[n] += d[m][1];
              r_lo[n + 8] += d[m][2];
              r_hi[n + 8] += d[m][3];
            }
          }
        }
        __syncthreads();  // the stage is consumed; after the last, red_s is
                          // complete
        if (t > 0 && tid == 0 && (c0 + KC < p.Kp || r0 + SR < RB)) {
          const int nr0 = c0 + KC < p.Kp ? r0 : r0 + SR;  // the next pass
          const int nc0 = c0 + KC < p.Kp ? c0 + KC : 0;
          tma_rows(f_s, fp, src + (size_t)(b0 + nr0) * p.Kp + nc0, p.Kp, SR,
                   (unsigned int)(KC * sizeof(float)), mbar);
        }
      }
    }

    // (d) the epilogue: the JAX kernel's float operations in its order
    const bool last = t == T - 1;
    float* dst = p.xbuf + (size_t)((t + 1) & 1) * half;
    float hmax[kPairs], pair_step[kPairs];
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      pair_step[s] = __shfl_sync(0xffffffffu, tile_step, ptile[s]);
    }
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      hmax[s] = 0.0f;
      if (!live[s]) continue;
      float pre[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        int acc = 0;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          acc += red_s[((size_t)w * RB + pr[s]) * M + gate * UB + pu[s]];
        }
        const float sg = __fmul_rn(sc[s][gate], pair_step[s]);
        pre[gate] =
            __fadd_rn(xv[s][gate], __fmul_rn(__int2float_rn(acc), sg));
      }
      const float gi = sigmoid(pre[0]);
      const float gf = sigmoid(pre[1]);
      const float gg = tanhf(pre[2]);
      const float go = sigmoid(pre[3]);
      const float c_new = __fadd_rn(__fmul_rn(gf, cv[s]), __fmul_rn(gi, gg));
      const float h = __fmul_rn(go, tanhf(c_new));
      cv[s] = c_new;
      p.hs[((size_t)pb[s] * T + t) * H + pj[s]] = h;
      if (!last) dst[(size_t)pb[s] * p.Kp + pj[s]] = h;
      hmax[s] = fabsf(h);
    }
    if (last) break;
    // the block's max |h_t| of each row over its UB units: a row's pairs are
    // UB consecutive lanes of one warp
    float* slot_dst = p.slots + (size_t)((t + 1) & 1) * slot_half;
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      float m = hmax[s];
#pragma unroll
      for (int off = UB / 2; off > 0; off /= 2) {
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      }
      if (pu[s] == 0 && tid + s * kThreads < RB * UB && pb[s] < p.B) {
        slot_dst[(size_t)pb[s] * gx + blockIdx.x] = m;
      }
    }
    // (e) publish, load the next step's x_proj, wait for the grid
    barrier_arrive(p.arrived);
    prefetch(t + 1);
    barrier_wait(p.arrived, (unsigned int)(t + 1) * n_blocks);
  }
#pragma unroll
  for (int s = 0; s < kPairs; ++s) {
    if (live[s]) p.c[(size_t)pb[s] * H + pj[s]] = cv[s];
  }
}

__host__ __device__ constexpr int round_up(int n, int m) {
  return (n + m - 1) / m * m;
}

template <typename X, int UB>
int launch(const QArgs& a, int grid_x, int grid_y, int device,
           cudaStream_t stream) {
  const auto kernel = lstm_q_persistent_kernel<X, UB>;
  // dynamic shared bytes: the W slice, the f32 stage, the warps' partials
  // and their maxima of each tile (ops/lstm_cuda's layout adds the
  // mbarrier's static 16)
  const size_t smem =
      (size_t)4 * UB * (a.Kp + kPad) +
      (size_t)a.stage_rows * (a.stage_cols + kStagePad) * sizeof(float) +
      (size_t)kWarps * a.rows * 4 * UB * sizeof(int) +
      (size_t)kWarps * kMaxTiles * sizeof(float);
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
  QArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid_x, grid_y), dim3(kThreads),
                                  params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One call runs one layer (or one group of whole batch tiles of it) as one
// cooperative launch on `stream`, with the tile of
// ops/lstm_cuda.fwd_q_plan: `units` (UB, 16 or 32) hidden units and `rows`
// (RB) batch rows a block, the rows staged `stage_rows` (SR) by
// `stage_cols` (KC) at a time. BT, the rows that share one scale, divides
// B and is B (< 8) or a multiple of 8 that divides RB or that RB divides.
// `xbuf` is the zeroed exchange buffer: (2, ceil(B / RB) RB, Kp) f32, then
// the slots (2, ceil(B / RB) RB, ceil(H / UB)) f32, then the counter.
// Returns 0, or a cudaError_t: a tile the kernel does not take
// (cudaErrorInvalidValue), a card without cooperative launches, or a grid
// that is not co-resident (cudaErrorCooperativeLaunchTooLarge).
extern "C" int lstm_fwd_q(const void* x_proj, int x_is_bf16, const void* wq,
                          const void* scale, const void* h0, const void* c0,
                          void* hs, void* c, void* xbuf, int B, int T, int H,
                          int BT, int units, int rows, int stage_rows,
                          int stage_cols, int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int Kp = round_up(H, kKAlign);
  const bool tile_ok =
      BT >= 1 && B % BT == 0 &&
      (BT == B ? BT <= kTileN || BT % kTileN == 0 : BT % kTileN == 0) &&
      (BT < kTileN || rows % BT == 0 || BT % rows == 0);
  if (B < 1 || T < 1 || H < 1 || !tile_ok || (units != 16 && units != 32) ||
      rows < kTileN || stage_rows < kTileN || rows % stage_rows ||
      stage_rows % kTileN ||
      stage_cols < kKAlign || stage_cols % kKAlign || Kp % stage_cols ||
      rows * units > kPairs * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid_x = (H + units - 1) / units;
  const int grid_y = (B + rows - 1) / rows;
  const int Bp = grid_y * rows;
  float* xb = static_cast<float*>(xbuf);
  float* slots = xb + 2 * (size_t)Bp * Kp;
  const QArgs a{x_proj,
                static_cast<const int8_t*>(wq),
                static_cast<const float*>(scale),
                static_cast<const float*>(h0),
                static_cast<const float*>(c0),
                static_cast<float*>(hs),
                static_cast<float*>(c),
                xb,
                slots,
                reinterpret_cast<unsigned int*>(slots +
                                                2 * (size_t)Bp * grid_x),
                B, T, H, BT, Bp, Kp,
                rows, stage_rows, stage_cols};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    if (units == 32) {
      return launch<__nv_bfloat16, 32>(a, grid_x, grid_y, device, s);
    }
    return launch<__nv_bfloat16, 16>(a, grid_x, grid_y, device, s);
  }
  if (units == 32) return launch<float, 32>(a, grid_x, grid_y, device, s);
  return launch<float, 16>(a, grid_x, grid_y, device, s);
}
