// LSTM recurrence, forward, for Hopper (sm_90a).
//
// Replaces: rnn_transducer_tpu/ops/lstm_pallas.py `_lstm_core_fwd` (v1,
// batch-major, kernel `_fwd_kernel`) and `_lstm_core_fwd_v2` (v2,
// time-major, kernel `_fwd_kernel_v2`), both on the primal path of
// `_lstm_core` (with_acts=False) and on the training path of `_core_fwd`
// (with_acts=True: the gate activations and cell states are saved for the
// backward, csrc/lstm_bwd.cu).
//
// Computes, for t = 0 .. T-1, with gate order i, f, g, o:
//   gates = x_proj[:, t] + round(h_{t-1}) @ W_hh      (fp32 accumulate)
//   c_t   = sigmoid(f) * c_{t-1} + sigmoid(i) * tanh(g)  (fp32)
//   h_t   = sigmoid(o) * tanh(c_t)                       (fp32)
// where round() is the cast of h to the compute dtype of W_hh (bf16 or
// f32), as `h.astype(cdtype)` in the JAX kernel. Every row runs all T steps;
// pad rows compute values that stay in the pad region, as in JAX.
//
// Layout: x_proj (B, T, 4H) f32, W_hh (H, 4H) bf16 or f32, h0/c0 (B, H) f32
// -> hs (B, T, H) f32 and c (B, H) f32 (the final cell state). With
// activations (acts and cs not null) it also writes acts (B, T, 4H) f32 =
// sigmoid(i), sigmoid(f), tanh(g), sigmoid(o) of every step, as
// `_fwd_kernel` stores them, and cs (B, T, H) f32, every step's cell state.
// The caller also hands a zeroed exchange buffer xbuf (2, Bp, Kp) in the
// compute dtype (Bp = grid.y * RB rows, Kp = H rounded up to 128 columns),
// followed by the grid barrier's u32 counter.
//
// Design: K4-bwd's (csrc/lstm_bwd.cu), turned around: one persistent
// cooperative launch per layer call, as the TPU kernels keep W_hh resident
// in VMEM and carry h and c in scratch from one grid step to the next. The
// host plan (ops/lstm_cuda.fwd_plan) tiles the (row, unit) pairs: block
// (x, y) owns the UB hidden units j0 = x UB .. and the RB batch rows
// b0 = y RB ..; its grid of ceil(H/UB) x ceil(B/RB) blocks is one wave,
// which the cooperative launch guarantees. Each block loads the 4 UB gate
// columns of its units, W_hh[:, g H + j0 .. g H + j0 + UB] for g = i, f, g,
// o, transposed into shared memory once and keeps them for the launch; the
// c carry of its pairs stays in registers. Then for t = 0 .. T-1:
//   (a) stage round(h_{t-1}) of its rows, SR rows by KC columns a pass:
//       at t = 0 round(h0), read from h0 itself; after that from the
//       exchange buffer's half t & 1 with the TMA's bulk copies (one per
//       row, issued by thread 0, completing on an mbarrier), since other
//       SMs wrote the rows and L1 is not coherent across SMs;
//   (b) gates = stage . W_slice: the 8 warps split the H reduction, each
//       4 UB gate columns (2 to 8 mma M-tiles) by 8 rows (bf16: mma.sync
//       m16n8k16 on the tensor cores; f32: the CUDA cores in the same
//       fragment layout); each warp's partial goes to shared memory and
//       the 8 are summed in warp order by the thread of the pair;
//   (c) the gate epilogue of the thread's (row, unit) pairs, with the
//       sigmoid and tanh of the JAX kernel: hs (and acts, cs) in f32 to
//       the outputs, round(h_t) to the buffer's half (t + 1) & 1;
//   (d) the grid barrier (grid_barrier.cuh): the block arrives
//       (publishing its exchange writes), loads the next step's x_proj,
//       which does not depend on the recurrence, and waits for the others.
// The ping-pong buffer needs one barrier a step: the half written at step
// t was last read at step t-1, before the barrier that ended it. The last
// step needs none: T-1 barriers a launch. No float atomics: every output
// has one writer and every sum a fixed order, so two runs give the same
// bits.
//
// What bounds it on the H100: latency, as K4-bwd. A step is a grid
// barrier, an L2 fetch of RB x H rounded h values (8 KB in bf16 at RB = 8,
// H = 512, a quarter of K4-bwd's), a 4 UB x RB x H product and the
// epilogue, one after another: 3.14-3.16 us a step at B = 8, H = 512 in
// bf16 and 3.89-3.90 in f32, where K4-bwd takes 3.37 at B = 32 (H100 80GB
// HBM3 at 700 W; bench_band_bwd_b.py's step fit, bench_lstm_bwd.py). The
// smaller fetch saves little: the barrier and the round trips through L2
// set the step. Storing the outputs after the arrival, so that it
// publishes round(h) alone, was 2.6% slower at B = 8, T = 800, and a
// barrier per row group (blocks of other rows never exchange) no faster
// at B = 32; neither is kept. The bytes the layer must move (x_proj in,
// hs out: 0.020 ms at B = 8, T = 800) are far below all that.

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
constexpr int kKAlign = 128;      // H is padded to kWarps x 16 columns
constexpr int kPadBytes = 16;     // row pitch of 4 (mod 32) words

struct FwdArgs {
  const float* x_proj;
  const void* w_hh;
  const float* h0;
  const float* c0;
  float* hs;
  float* c;
  float* acts;  // null without activations, as cs
  float* cs;
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

__device__ __forceinline__ float sigmoid(float x) {
  return 1.0f / (1.0f + expf(-x));
}

// Element i of a 16-byte vector of W values (i a constant once unrolled).
template <typename W>
__device__ __forceinline__ W element(const int4& v, int i);
template <>
__device__ __forceinline__ float element<float>(const int4& v, int i) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  return __int_as_float(w[i]);
}
template <>
__device__ __forceinline__ __nv_bfloat16 element<__nv_bfloat16>(const int4& v,
                                                                int i) {
  const int w[4] = {v.x, v.y, v.z, v.w};
  return __ushort_as_bfloat16(
      static_cast<unsigned short>((unsigned int)w[i >> 1] >> (16 * (i & 1))));
}

// Elements of padding that give a row of W a pitch of 4 (mod 32) words.
template <typename W>
__host__ __device__ constexpr int pad_elems() {
  return kPadBytes / (int)sizeof(W);
}

// Warp tile, bf16: d[m] += W_s[16 m .. 16 m + 16, wk0 ..] .
// h_s[n0 .. n0 + 8, sk0 ..]^T over kw columns, d[m] in the mma's D layout
// (gate column 16 m + g or 16 m + g + 8, row n0 + 2q (+1)). Even and odd k
// steps go to two accumulator chains, summed at the end: a fixed order.
template <int kM>
__device__ __forceinline__ void warp_tile(float (&d)[kM][4],
                                          const __nv_bfloat16* w_s, int wp,
                                          int wk0, const __nv_bfloat16* h_s,
                                          int sp, int n0, int sk0, int kw,
                                          int lane) {
  float e[kM][4] = {};
  uint32_t a[4], b[2];
  int k = 0;
#pragma unroll 2
  for (; k + 32 <= kw; k += 32) {
    joint_mma::frag_b(b, h_s, sp, n0, sk0 + k, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      joint_mma::frag_a(a, w_s, wp, 16 * m, wk0 + k, lane);
      joint_mma::mma_16816(d[m], a, b);
    }
    joint_mma::frag_b(b, h_s, sp, n0, sk0 + k + 16, lane);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      joint_mma::frag_a(a, w_s, wp, 16 * m, wk0 + k + 16, lane);
      joint_mma::mma_16816(e[m], a, b);
    }
  }
  if (k < kw) {  // kw is a multiple of 16
    joint_mma::frag_b(b, h_s, sp, n0, sk0 + k, lane);
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
// sums gate columns 16 m + g and 16 m + g + 8 against rows n0 + 2q and
// n0 + 2q + 1, four k a load.
template <int kM>
__device__ __forceinline__ void warp_tile(float (&d)[kM][4], const float* w_s,
                                          int wp, int wk0, const float* h_s,
                                          int sp, int n0, int sk0, int kw,
                                          int lane) {
  const int g = lane >> 2;
  const int q = lane & 3;
  const float* wa = w_s + (size_t)g * wp + wk0;
  const float* x0 = h_s + (size_t)(n0 + 2 * q) * sp + sk0;
  const float* x1 = x0 + sp;
#pragma unroll 2
  for (int k = 0; k < kw; k += 4) {
    const float4 u = *reinterpret_cast<const float4*>(x0 + k);
    const float4 v = *reinterpret_cast<const float4*>(x1 + k);
#pragma unroll
    for (int m = 0; m < kM; ++m) {
      const float4 a =
          *reinterpret_cast<const float4*>(wa + (size_t)(16 * m) * wp + k);
      const float4 b = *reinterpret_cast<const float4*>(
          wa + (size_t)(16 * m + 8) * wp + k);
      d[m][0] = fmaf(a.x, u.x, d[m][0]);
      d[m][0] = fmaf(a.y, u.y, d[m][0]);
      d[m][0] = fmaf(a.z, u.z, d[m][0]);
      d[m][0] = fmaf(a.w, u.w, d[m][0]);
      d[m][1] = fmaf(a.x, v.x, d[m][1]);
      d[m][1] = fmaf(a.y, v.y, d[m][1]);
      d[m][1] = fmaf(a.z, v.z, d[m][1]);
      d[m][1] = fmaf(a.w, v.w, d[m][1]);
      d[m][2] = fmaf(b.x, u.x, d[m][2]);
      d[m][2] = fmaf(b.y, u.y, d[m][2]);
      d[m][2] = fmaf(b.z, u.z, d[m][2]);
      d[m][2] = fmaf(b.w, u.w, d[m][2]);
      d[m][3] = fmaf(b.x, v.x, d[m][3]);
      d[m][3] = fmaf(b.y, v.y, d[m][3]);
      d[m][3] = fmaf(b.z, v.z, d[m][3]);
      d[m][3] = fmaf(b.w, v.w, d[m][3]);
    }
  }
}

// red_s[w][r][n] = warp w's share of sum_k round(h[b0 + r][k]) W[k][col n]
// for the block's RB rows and its 16 kM gate columns n: a pass stages SR
// rows by KC columns (round(h0) at t = 0, else the exchange buffer's half
// `src` through the TMA), then each warp takes its KC / 8 columns of every
// 8-row tile.
template <typename W, int kM>
__device__ __forceinline__ void product(const FwdArgs& p, int t, const W* src,
                                        const W* w_s, W* h_s, float* red_s,
                                        int b0, unsigned int mbar,
                                        unsigned int& phase) {
  constexpr int M = 16 * kM;
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
      if (t == 0) {
        for (int idx = threadIdx.x; idx < SR * KC; idx += kThreads) {
          const int r = idx / KC;
          const int k = idx - r * KC;
          const int b = b0 + r0 + r;
          const int col = c0 + k;
          h_s[(size_t)r * sp + k] = from_float<W>(
              (b < p.B && col < p.H) ? p.h0[(size_t)b * p.H + col] : 0.0f);
        }
        __syncthreads();
      } else {
        if (threadIdx.x == 0) {
          tma_rows(h_s, sp, src + (size_t)(b0 + r0) * p.Kp + c0, p.Kp, SR,
                   (unsigned int)(KC * sizeof(W)), mbar);
        }
        mbar_wait(mbar, phase);
      }
      // (b) the warp's kw columns, every 8-row tile of the stage
      for (int n0 = 0; n0 < SR; n0 += kTileN) {
        float d[kM][4] = {};
        warp_tile<kM>(d, w_s, wp, c0 + warp * kw, h_s, sp, n0, warp * kw, kw,
                      lane);
        float* r_lo = red_s + ((size_t)warp * RB + r0 + n0 + 2 * q) * M + g;
        float* r_hi = r_lo + M;
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
    }
  }
}

template <typename W, int UB>
__global__ void __launch_bounds__(kThreads, 1)
lstm_fwd_persistent_kernel(FwdArgs p) {
  constexpr int M = 4 * UB;  // the block's gate columns, gate-major
  constexpr int kM = M / 16;
  extern __shared__ __align__(16) unsigned char smem[];
  const int H = p.H;
  const size_t H4 = 4 * (size_t)H;
  const int T = p.T;
  const int RB = p.rows;
  const int wp = p.Kp + pad_elems<W>();
  const int sp = p.stage_cols + pad_elems<W>();
  W* w_s = reinterpret_cast<W*>(smem);              // [M][wp]
  W* h_s = w_s + (size_t)M * wp;                    // [SR][sp]
  float* red_s = reinterpret_cast<float*>(h_s + (size_t)p.stage_rows * sp);
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

  // w_s[g UB + u][k] = W_hh[k][g H + j0 + u] for the whole launch; zero past
  // H (units and k). 16-byte loads of kVec units where every row and gate
  // block of W_hh starts on 16 bytes.
  constexpr int kVec = 16 / (int)sizeof(W);
  if (((reinterpret_cast<uintptr_t>(w_hh) | (size_t)H * sizeof(W)) & 15) ==
      0) {
    constexpr int vrow = M / kVec;  // 16-byte vectors of a k row
#pragma unroll 4
    for (int idx = tid; idx < p.Kp * vrow; idx += kThreads) {
      const int k = idx / vrow;
      const int n = (idx - k * vrow) * kVec;
      const int gate = n / UB;
      const int j = j0 + n - gate * UB;
      int4 v = make_int4(0, 0, 0, 0);
      if (k < H && j < H) {
        v = __ldg(reinterpret_cast<const int4*>(w_hh + (size_t)k * H4 +
                                                (size_t)gate * H + j));
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        w_s[(size_t)(n + i) * wp + k] = element<W>(v, i);
      }
    }
  } else {
#pragma unroll 8
    for (int idx = tid; idx < p.Kp * M; idx += kThreads) {
      const int k = idx / M;
      const int n = idx - k * M;
      const int gate = n / UB;
      const int j = j0 + n - gate * UB;
      w_s[(size_t)n * wp + k] = (k < H && j < H)
                                    ? w_hh[(size_t)k * H4 + (size_t)gate * H + j]
                                    : from_float<W>(0.0f);
    }
  }

  // the thread's (row, unit) pairs, their c carry and the step's x_proj
  int pb[kPairs], pj[kPairs], pr[kPairs], pu[kPairs];
  bool live[kPairs];
  float cv[kPairs], xi[kPairs], xf[kPairs], xg[kPairs], xo[kPairs];
#pragma unroll
  for (int s = 0; s < kPairs; ++s) {
    const int idx = tid + s * kThreads;
    pr[s] = idx / UB;
    pu[s] = idx - pr[s] * UB;
    pb[s] = b0 + pr[s];
    pj[s] = j0 + pu[s];
    live[s] = idx < RB * UB && pb[s] < p.B && pj[s] < H;
    cv[s] = live[s] ? p.c0[(size_t)pb[s] * H + pj[s]] : 0.0f;
  }
  auto prefetch = [&](int t) {
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      if (!live[s]) continue;
      const float* xp = p.x_proj + ((size_t)pb[s] * T + t) * H4 + pj[s];
      xi[s] = xp[0];
      xf[s] = xp[H];
      xg[s] = xp[2 * H];
      xo[s] = xp[3 * H];
    }
  };
  prefetch(0);
  __syncthreads();  // the W slice and the mbarrier's init, before step 0

  for (int t = 0; t < T; ++t) {
    product<W, kM>(p, t, xbuf + (size_t)(t & 1) * half, w_s, h_s, red_s, b0,
                   mbar, phase);
    const bool last = t == T - 1;
    W* dst = xbuf + (size_t)((t + 1) & 1) * half;
#pragma unroll
    for (int s = 0; s < kPairs; ++s) {
      if (!live[s]) continue;
      float sum[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        float acc = 0.0f;
        for (int w = 0; w < kWarps; ++w) {
          acc += red_s[((size_t)w * RB + pr[s]) * M + gate * UB + pu[s]];
        }
        sum[gate] = acc;
      }
      const float gi = sigmoid(xi[s] + sum[0]);
      const float gf = sigmoid(xf[s] + sum[1]);
      const float gg = tanhf(xg[s] + sum[2]);
      const float go = sigmoid(xo[s] + sum[3]);
      const float c_new = gf * cv[s] + gi * gg;
      const float h = go * tanhf(c_new);
      cv[s] = c_new;
      const size_t bt = (size_t)pb[s] * T + t;
      p.hs[bt * H + pj[s]] = h;
      if (p.acts != nullptr) {
        float* a = p.acts + bt * H4 + pj[s];
        a[0] = gi;
        a[H] = gf;
        a[2 * H] = gg;
        a[3 * H] = go;
        p.cs[bt * H + pj[s]] = c_new;
      }
      if (!last) dst[(size_t)pb[s] * p.Kp + pj[s]] = from_float<W>(h);
    }
    if (last) break;
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

template <typename W, int UB>
int launch(const FwdArgs& a, int grid_x, int grid_y, int device,
           cudaStream_t stream) {
  const auto kernel = lstm_fwd_persistent_kernel<W, UB>;
  // dynamic shared bytes: the W slice, the stage, the warps' partials
  // (ops/lstm_cuda's layout adds the mbarrier's static 16)
  const size_t smem =
      ((size_t)4 * UB * (a.Kp + pad_elems<W>()) +
       (size_t)a.stage_rows * (a.stage_cols + pad_elems<W>())) * sizeof(W) +
      (size_t)kWarps * a.rows * 4 * UB * sizeof(float);
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
  FwdArgs args = a;
  void* params[] = {&args};
  e = cudaLaunchCooperativeKernel(reinterpret_cast<const void*>(kernel),
                                  dim3(grid_x, grid_y), dim3(kThreads),
                                  params, smem, stream);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// One call runs one layer as one cooperative launch on `stream`, with the
// tile of ops/lstm_cuda.fwd_plan: `units` (UB) hidden units and `rows` (RB)
// batch rows a block, the rows staged `stage_rows` (SR) by `stage_cols`
// (KC) at a time. `xbuf` is the zeroed exchange buffer (2, ceil(B / RB) RB,
// Kp) and its counter. acts and cs are both null (serving) or both set
// (training). Returns 0, or a cudaError_t: a tile the kernel does not
// take, a card without cooperative launches, or a grid that is not
// co-resident (cudaErrorCooperativeLaunchTooLarge).
extern "C" int lstm_fwd(const void* x_proj, const void* w_hh, int w_is_bf16,
                        const void* h0, const void* c0, void* hs, void* c,
                        void* acts, void* cs, void* xbuf, int B, int T, int H,
                        int units, int rows, int stage_rows, int stage_cols,
                        int device, void* stream) {
  cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  int coop = 0;
  e = cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, device);
  if (e != cudaSuccess) return (int)e;
  if (!coop) return (int)cudaErrorNotSupported;
  const int Kp = round_up(H, kKAlign);
  if ((acts == nullptr) != (cs == nullptr) || B < 1 || T < 1 || H < 1 ||
      rows < kTileN || rows % stage_rows || stage_rows % kTileN ||
      stage_cols % kKAlign || Kp % stage_cols ||
      rows * units > kPairs * kThreads) {
    return (int)cudaErrorInvalidValue;
  }
  const int grid_x = (H + units - 1) / units;
  const int grid_y = (B + rows - 1) / rows;
  const FwdArgs a{static_cast<const float*>(x_proj),
                  w_hh,
                  static_cast<const float*>(h0),
                  static_cast<const float*>(c0),
                  static_cast<float*>(hs),
                  static_cast<float*>(c),
                  static_cast<float*>(acts),
                  static_cast<float*>(cs),
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

// The message of a cudaError_t any entry point of the library returned.
extern "C" const char* kernel_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
