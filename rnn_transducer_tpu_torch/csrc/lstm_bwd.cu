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
// -> dgates (B, T, 4H) f32, dh0 (B, H) f32, dc0 (B, H) f32. dc0 doubles as
// the dc carry between steps.
//
// Design: mirrors lstm_fwd.cu. The host entry point launches one step
// kernel per t on the caller's stream, then one more that only takes dh0.
// A block owns kUnits hidden units j and kRows batch rows. It stages the
// rows of dgates_{t+1} that the previous launch wrote in shared memory
// (rounded), computes dh for its units from the contiguous rows
// W_hh[j, :] (each warp takes kUnits / kWarps units, its lanes split the
// 4H reduction and meet by shuffles), then each thread runs the gate
// epilogue and the dc carry of one (row, unit) pair.
//
// What bounds it on the H100: as the forward, latency. Every step rereads
// all of W_hh (2 MB in bf16 at H = 512) from L2 with H/kUnits *
// ceil(B/kRows) blocks (128 at B = 32, H = 512) in flight, and T + 1
// launches run one after another.
//
// Later (ROADMAP K4): the persistent kernel shared with the forward, with
// W_hh split across the SMs' shared memory and the product on the tensor
// cores.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kUnits = 16;  // hidden units per block
constexpr int kWarps = 8;
constexpr int kRows = 8;    // batch rows per block
constexpr int kThreads = kWarps * 32;
constexpr int kUnitsPerWarp = kUnits / kWarps;
static_assert(kRows * kUnits <= kThreads,
              "the gate epilogue maps one (row, unit) pair to a thread");

__device__ __forceinline__ float to_float(float v) { return v; }
__device__ __forceinline__ float to_float(__nv_bfloat16 v) {
  return __bfloat162float(v);
}

template <typename W>
__device__ __forceinline__ float round_to(float v);
template <>
__device__ __forceinline__ float round_to<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ float round_to<__nv_bfloat16>(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// One backward step at time t (t = -1: only dh0 = round(dgates_0) W^T).
template <typename W>
__global__ void __launch_bounds__(kThreads)
lstm_bwd_step_kernel(const float* __restrict__ acts,
                     const float* __restrict__ cs_prev,
                     const float* __restrict__ dhs,
                     const float* __restrict__ dcT, const W* __restrict__ w_hh,
                     float* __restrict__ dgates, float* __restrict__ dh0,
                     float* __restrict__ dc, int B, int T, int H, int t) {
  extern __shared__ float smem[];
  const int H4 = 4 * H;
  float* dg_s = smem;                // [kRows][4H]: round(dgates_{t+1})
  float* dh_s = smem + kRows * H4;   // [kRows][kUnits]
  const int lane = threadIdx.x % 32;
  const int warp = threadIdx.x / 32;
  const int j0 = blockIdx.x * kUnits;
  const int b0 = blockIdx.y * kRows;

  if (t + 1 < T) {
    for (int idx = threadIdx.x; idx < kRows * H4; idx += kThreads) {
      const int r = idx / H4;
      const int n = idx - r * H4;
      const int b = b0 + r;
      dg_s[idx] = (b < B)
          ? round_to<W>(dgates[((size_t)b * T + (t + 1)) * H4 + n]) : 0.0f;
    }
    __syncthreads();
    for (int q = 0; q < kUnitsPerWarp; ++q) {
      const int ju = warp * kUnitsPerWarp + q;
      const int j = j0 + ju;
      float acc[kRows];
#pragma unroll
      for (int r = 0; r < kRows; ++r) acc[r] = 0.0f;
      if (j < H) {
        const W* wr = w_hh + (size_t)j * H4;
        for (int n = lane; n < H4; n += 32) {
          const float w = to_float(wr[n]);
#pragma unroll
          for (int r = 0; r < kRows; ++r) {
            acc[r] = fmaf(dg_s[r * H4 + n], w, acc[r]);
          }
        }
      }
#pragma unroll
      for (int r = 0; r < kRows; ++r) {
        float v = acc[r];
#pragma unroll
        for (int off = 16; off > 0; off /= 2) {
          v += __shfl_xor_sync(0xffffffffu, v, off);
        }
        if (lane == 0) dh_s[r * kUnits + ju] = v;
      }
    }
  } else {
    for (int idx = threadIdx.x; idx < kRows * kUnits; idx += kThreads) {
      dh_s[idx] = 0.0f;
    }
  }
  __syncthreads();

  const int r = threadIdx.x / kUnits;
  const int u = threadIdx.x % kUnits;
  const int j = j0 + u;
  const int b = b0 + r;
  if (r >= kRows || j >= H || b >= B) return;
  const size_t bj = (size_t)b * H + j;
  const float dh = dh_s[r * kUnits + u];
  if (t < 0) {
    dh0[bj] = dh;
    return;
  }
  const size_t bt = (size_t)b * T + t;
  const float* a = acts + bt * H4 + j;
  const float gi = a[0];
  const float gf = a[H];
  const float gg = a[2 * H];
  const float go = a[3 * H];
  const float cp = cs_prev[bt * H + j];
  const float tc = tanhf(gf * cp + gi * gg);
  const float dh_tot = dhs[bt * H + j] + dh;
  const float d_o = dh_tot * tc;
  const float dcv = ((t == T - 1) ? dcT[bj] : dc[bj])
                    + dh_tot * go * (1.0f - tc * tc);
  float* out = dgates + bt * H4 + j;
  out[0] = dcv * gg * gi * (1.0f - gi);
  out[H] = dcv * cp * gf * (1.0f - gf);
  out[2 * H] = dcv * gi * (1.0f - gg * gg);
  out[3 * H] = d_o * go * (1.0f - go);
  dc[bj] = dcv * gf;
}

template <typename W>
int run_bwd(const void* acts, const void* cs_prev, const void* dhs,
            const void* dcT, const void* w_hh, void* dgates, void* dh0,
            void* dc0, int B, int T, int H, cudaStream_t stream) {
  const size_t smem =
      ((size_t)kRows * 4 * H + (size_t)kRows * kUnits) * sizeof(float);
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        lstm_bwd_step_kernel<W>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (e != cudaSuccess) return (int)e;
  }
  const dim3 grid((H + kUnits - 1) / kUnits, (B + kRows - 1) / kRows);
  for (int t = T - 1; t >= -1; --t) {
    lstm_bwd_step_kernel<W><<<grid, kThreads, smem, stream>>>(
        static_cast<const float*>(acts), static_cast<const float*>(cs_prev),
        static_cast<const float*>(dhs), static_cast<const float*>(dcT),
        static_cast<const W*>(w_hh), static_cast<float*>(dgates),
        static_cast<float*>(dh0), static_cast<float*>(dc0), B, T, H, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

}  // namespace

// One call runs one layer's backward: T + 1 step launches on `stream`.
// Returns 0, or the first cudaError_t a launch reported.
extern "C" int lstm_bwd(const void* acts, const void* cs_prev,
                        const void* dhs, const void* dcT, const void* w_hh,
                        int w_is_bf16, void* dgates, void* dh0, void* dc0,
                        int B, int T, int H, int device, void* stream) {
  const cudaError_t e = cudaSetDevice(device);
  if (e != cudaSuccess) return (int)e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (w_is_bf16) {
    return run_bwd<__nv_bfloat16>(acts, cs_prev, dhs, dcT, w_hh, dgates, dh0,
                                  dc0, B, T, H, s);
  }
  return run_bwd<float>(acts, cs_prev, dhs, dcT, w_hh, dgates, dh0, dc0, B,
                        T, H, s);
}
